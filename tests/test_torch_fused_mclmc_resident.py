"""The fused MCLMC kernel's forms (``ops.fused_mclmc``), on the CPU: the
wrapper's plan (which form, by target and ``form=``), its refusals, what the
CPU path counts, and the resident form's pooled draws as a plain function.
No kernel is built or launched here.

The resident form draws the refresh noise of P steps ahead, densely across a
warp's lanes (``pool_layout``); every normal keeps the key of its step,
refresh and dim. ``tests/test_torch_cuda.py`` holds the kernel's own walk
(``pool_layout_device``) against ``pool_layout`` and the resident form
against the registers form bit for bit on the card.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from blackjax_tpu_torch.mcmc import integrators  # noqa: E402
from blackjax_tpu_torch.ops import counter_rng  # noqa: E402

fm = importlib.import_module("blackjax_tpu_torch.ops.fused_mclmc")
fl = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")

HIERARCHICAL, GAUSSIAN, LOGREG = 0, 1, 2
WIDTHS = (1, 31, 33, 100, 200, 256)


@pytest.mark.parametrize("d", [1, 32, 33, 100, 200, 256])
@pytest.mark.parametrize("target", [HIERARCHICAL, GAUSSIAN])
def test_analytic_targets_take_the_resident_form(target, d):
    """The hierarchical and Gaussian targets take the resident form at every
    width the kernel holds, and ask for it."""
    assert fm.plan(d, target) == fm.plan(d, target, form="resident") == "resident"


@pytest.mark.parametrize("d", [1, 33, 100, 256])
@pytest.mark.parametrize("target", [HIERARCHICAL, GAUSSIAN])
def test_registers_form_on_request(target, d):
    assert fm.plan(d, target, form="registers") == "registers"


@pytest.mark.parametrize("d", [1, 12, 54, 256])
def test_logistic_regression_takes_the_tiles_form(d):
    assert fm.plan(d, LOGREG) == "tiles"


@pytest.mark.parametrize("form", ["resident", "registers"])
def test_logistic_regression_refuses_the_analytic_forms(form):
    """Logistic regression runs the tiles form only; asking it for another
    raises, and nothing falls back."""
    with pytest.raises(ValueError):
        fm.plan(54, LOGREG, form=form)


@pytest.mark.parametrize("d", [0, 257, 512])
@pytest.mark.parametrize("form", [None, "resident", "registers"])
def test_widths_beyond_the_kernel_are_refused(d, form):
    with pytest.raises(ValueError):
        fm.plan(d, HIERARCHICAL, form=form)


def test_unknown_form_is_refused():
    with pytest.raises(ValueError):
        fm.plan(100, HIERARCHICAL, form="tiles")


def _cpu_run(target, d, **kw):
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.5 * rng.standard_normal((4, d))).astype(np.float32))
    m = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((4, d)).astype(np.float32)), dim=1)
    return fm.fused_mclmc(x, m, torch.ones(d), 0.3, 2.0, target=target, num_steps=3,
                          seed=1, track_dims=(0, d - 1), **kw)


@pytest.mark.parametrize("form", [None, "resident", "registers"])
def test_cpu_tensors_count_no_launch(form):
    """The CPU path runs the plain version in every form and counts no
    launch; the form changes nothing there."""
    before = dict(fm.LAUNCHES)
    out = _cpu_run(fl.make_hierarchical_gaussian_target(8), 8, form=form)
    assert fm.LAUNCHES == before
    reference = _cpu_run(fl.make_hierarchical_gaussian_target(8), 8)
    assert all(torch.equal(a, b) for a, b in zip(out, reference))


@pytest.mark.parametrize("form", ["resident", "registers"])
def test_cpu_run_refuses_an_analytic_form_on_logistic_regression(form):
    """The request is checked on every device."""
    rng = np.random.default_rng(2)
    X = rng.standard_normal((23, 12)).astype(np.float32)
    y = (rng.random(23) < 0.5).astype(np.float32)
    before = dict(fm.LAUNCHES)
    with pytest.raises(ValueError):
        _cpu_run(fl.make_logistic_regression_target(X, y), 12, form=form)
    assert fm.LAUNCHES == before


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("d", WIDTHS)
def test_pool_draws_each_normal_once(d, steps):
    """A pool of ``steps`` steps draws each (step, refresh, dim) exactly
    once, into slot 32 r + lane = q d + j, and every lane draws in every
    round but the last."""
    layout = fm.pool_layout(d, steps)
    rounds = -(-2 * steps * d // 32)
    assert layout.shape == (rounds, 32, 2)
    drawn = layout.reshape(-1, 2)
    live = drawn[:, 0] >= 0
    assert int(live.sum()) == 2 * steps * d
    assert bool(live[:-32].all())  # no lane idles before the last round
    q, j = drawn[live, 0], drawn[live, 1]
    slots = torch.arange(len(drawn))[live]
    assert torch.equal(q * d + j, slots)
    assert bool(((0 <= j) & (j < d) & (0 <= q) & (q < 2 * steps)).all())
    assert len(set((q * d + j).tolist())) == 2 * steps * d


@pytest.mark.parametrize("first, steps", [(0, 1), (0, 2), (8, 4), (12, 3), (998, 2)])
@pytest.mark.parametrize("d", WIDTHS)
def test_pooled_normals_are_the_refresh_normals(d, first, steps):
    """The normals that the pool's layout draws, each keyed by its chain,
    dim and stream ``2 (first + q // 2) + q % 2``, and gathered by dim, are
    the refreshes' normals (``counter_rng.counter_normals``) of every step
    of the pool; ``(12, 3)`` and ``(998, 2)`` are partial last pools of 15
    and 1,000 steps at P = 4."""
    seed, chains = 7, (0, 5)
    d_pad = -(-d // 128) * 128
    drawn = fm.pool_layout(d, steps).reshape(-1, 2)
    live = drawn[:, 0] >= 0
    q, j = drawn[live, 0], drawn[live, 1]
    for chain in chains:
        b1, b2 = counter_rng.threefry2x32(seed, counter_rng.KEY1, chain * d_pad + j,
                                          2 * first + q)
        pool = torch.empty(2 * steps * d, dtype=torch.float32)
        pool[q * d + j] = counter_rng.box_muller(b1, b2)
        for step in range(steps):
            for refresh in (0, 1):
                stream = 2 * (first + step) + refresh
                expected = counter_rng.counter_normals(seed, chain, stream, (1, d_pad))[0, :d]
                got = pool[(2 * step + refresh) * d:(2 * step + refresh + 1) * d]
                assert torch.equal(got, expected), (chain, step, refresh)


def test_the_port_names_the_unrolled_stage_counts():
    """The resident form unrolls the stages of the port's coefficient sets
    (3, 5, 7 and 11; csrc/fused_mclmc.cu: launch_resident_stages); each is a
    palindrome as floats, so its first kick reuses the last one."""
    sets = (integrators.velocity_verlet_coefficients, integrators.mclachlan_coefficients,
            integrators.yoshida_coefficients, integrators.omelyan_coefficients)
    assert [len(c) for c in sets] == [3, 5, 7, 11]
    for c in sets:
        f32 = np.asarray(c, dtype=np.float32)
        assert np.array_equal(f32, f32[::-1])
