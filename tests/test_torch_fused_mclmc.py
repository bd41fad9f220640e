"""The port's fused MCLMC against the Pallas kernel in interpret mode, and
its counter normals against the reference's.

The refresh noise is the reference's counter-based threefry: its words are
held bit for bit, its f32 normals to 1e-6 (``log`` and ``cos`` of torch and
XLA may differ in the last ulp). ``fused_mclmc_plain`` (which the wrapper
takes for CPU tensors) keeps the Pallas kernel's operation order, so on the
same f32 inputs the two differ only by the order of sums and those ulps: the
deterministic mode (``refresh=False``) is held at the reference test's atol
of 3e-6 (``tests/ops/test_fused_mclmc.py:43-45``), and so is the stochastic
mode, whose largest difference measured 1.2e-7 in x and m over 5 steps at
d=100. Log densities, some hundreds in size, are held at rtol 1e-5.
Logistic regression (``n = 150`` data rows, ``d = 13``: neither a multiple
of 8 nor of 128) is held at 1e-5 in x, m and the history.
"""
import importlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops import make_gaussian_target as jmake_gaussian  # noqa: E402
from blackjax_tpu.ops import make_hierarchical_gaussian_target as jmake_hierarchical  # noqa: E402
from blackjax_tpu.ops import make_logistic_regression_target as jmake_logreg  # noqa: E402
from blackjax_tpu.ops.fused_mclmc import _counter_normals, _threefry2x32  # noqa: E402
from blackjax_tpu.ops.fused_mclmc import fused_mclmc as jfused_mclmc  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import integrators  # noqa: E402
from blackjax_tpu_torch.ops import _nvcc, counter_rng  # noqa: E402

# `ops.fused_mclmc` is the function; the module comes from importlib
fm = importlib.import_module("blackjax_tpu_torch.ops.fused_mclmc")

ATOL = 3e-6
D, C, S = 100, 8, 5
TRACK = (0, 1, 57, 99)

CASES = {
    "hierarchical": lambda: jmake_hierarchical(D),
    "gaussian": lambda: jmake_gaussian(D, np.logspace(-1, 1, D)),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = (0.3 * rng.standard_normal((C, D))).astype(np.float32)
    m0 = rng.standard_normal((C, D))
    m0 = (m0 / np.linalg.norm(m0, axis=1, keepdims=True)).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, D).astype(np.float32)
    return x0, m0, imm


@pytest.mark.parametrize("chain_base, stream", [(0, 0), (3, 11), (2**25 + 5, 2**31 + 1)])
def test_counter_normals_match_reference(chain_base, stream):
    shape = (6, 128)
    b1, b2 = counter_rng.counter_normal_words(17, chain_base, stream, shape)
    rows = np.arange(shape[0], dtype=np.uint32)[:, None]
    lanes = np.arange(shape[1], dtype=np.uint32)[None, :]
    c0 = (np.uint32(chain_base) + rows) * np.uint32(shape[1]) + lanes
    r1, r2 = _threefry2x32(jnp.uint32(17), jnp.uint32(0x9E3779B9), jnp.asarray(c0),
                           jnp.full(shape, stream, jnp.uint32))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(r1).astype(np.int64))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(r2).astype(np.int64))
    ref = _counter_normals(jnp.uint32(17), jnp.uint32(chain_base), jnp.uint32(stream), shape)
    got = counter_rng.counter_normals(17, chain_base, stream, shape)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # the wrapper's check export takes the plain version on the CPU
    w1, w2, z = fm.counter_normals_device(17, chain_base, stream, shape[0], D, "cpu")
    assert torch.equal(w1, b1[:, :D]) and torch.equal(w2, b2[:, :D])
    assert torch.equal(z, got[:, :D])


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_pallas_kernel(case, refresh):
    ref_target = CASES[case]()
    target = interop.fused_target(ref_target.name, D, ref_target.params)
    x0, m0, imm = _inputs(0)
    kw = dict(num_steps=S, seed=3, track_dims=TRACK, refresh=refresh)
    ref = jfused_mclmc(jnp.asarray(x0), jnp.asarray(m0), jnp.asarray(imm), 0.05, 1.5,
                       target=ref_target, interpret=True, **kw)
    before = dict(fm.LAUNCHES)
    got = fm.fused_mclmc(torch.from_numpy(x0), torch.from_numpy(m0), torch.from_numpy(imm),
                         0.05, 1.5, target=target, **kw)
    assert fm.LAUNCHES == before, "a CPU call must not count a kernel launch"
    plain = fm.fused_mclmc_plain(torch.from_numpy(x0), torch.from_numpy(m0),
                                 torch.from_numpy(imm), 0.05, 1.5, target=target, **kw)
    for a, p in zip(got, plain):
        assert a.dtype == torch.float32 and torch.equal(a, p)
    x, m, ld, hist = got
    worst = 0.0
    for a, b in [(x, ref[0]), (m, ref[1]), (hist, ref[3])]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
        worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max()))
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref[2]), rtol=1e-5)
    assert hist.shape == (C, S, len(TRACK))
    assert torch.equal(hist[:, -1, :], x[:, list(TRACK)])
    np.testing.assert_allclose(torch.linalg.vector_norm(m, dim=1).numpy(), 1.0, rtol=1e-6)
    if refresh:  # the refresh moved the momenta away from the deterministic path
        det = fm.fused_mclmc(torch.from_numpy(x0), torch.from_numpy(m0), torch.from_numpy(imm),
                             0.05, 1.5, target=target, **{**kw, "refresh": False})
        assert float((det[1] - m).abs().max()) > 1e-2
    print(f"{case}, refresh={refresh}: largest |plain - pallas| = {worst:.3g}")


@pytest.mark.parametrize("refresh", [False, True])
def test_logistic_regression_plain_version_matches_pallas_kernel(refresh):
    rng = np.random.default_rng(11)
    n, d = 150, 13
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    ref_target = jmake_logreg(X, y)
    target = interop.fused_target(ref_target.name, d, ref_target.params)
    x0 = (0.2 * rng.standard_normal((C, d))).astype(np.float32)
    m0 = rng.standard_normal((C, d))
    m0 = (m0 / np.linalg.norm(m0, axis=1, keepdims=True)).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, d).astype(np.float32)
    kw = dict(num_steps=S, seed=3, track_dims=(0, 5, d - 1), refresh=refresh)
    ref = jfused_mclmc(jnp.asarray(x0), jnp.asarray(m0), jnp.asarray(imm), 0.05, 0.5,
                       target=ref_target, interpret=True, **kw)
    got = fm.fused_mclmc(torch.from_numpy(x0), torch.from_numpy(m0), torch.from_numpy(imm),
                         0.05, 0.5, target=target, **kw)
    worst = 0.0
    for a, b in [(got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3])]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max()))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    print(f"logistic regression, refresh={refresh}: largest |plain - pallas| = {worst:.3g}")


def test_deterministic_mode_matches_the_generic_integrator():
    """refresh=False is the port's own isokinetic McLachlan step, as the
    reference's test holds the Pallas kernel against the XLA integrator."""
    target = interop.fused_target("hierarchical_gaussian", D)
    x0, m0, _ = _inputs(1)
    step = integrators.isokinetic_mclachlan(target.logdensity_fn, 1.0)
    state = integrators.new_integrator_state(
        target.logdensity_fn, torch.from_numpy(x0).double(), torch.from_numpy(m0).double())
    for _ in range(S):
        state, _ = step(state, 0.05)
    x, m, ld, hist = fm.fused_mclmc(torch.from_numpy(x0), torch.from_numpy(m0), torch.ones(D),
                                    0.05, 1.0, target=target, num_steps=S, refresh=False)
    np.testing.assert_allclose(x.numpy(), state.position.numpy(), atol=ATOL)
    np.testing.assert_allclose(m.numpy(), state.momentum.numpy(), atol=ATOL)
    np.testing.assert_allclose(ld.numpy(), state.logdensity.numpy(), atol=2e-4)
    assert hist.shape == (C, S, 0)


def test_coefficients_and_validation():
    target = interop.fused_target("hierarchical_gaussian", D)
    x0, m0, imm = _inputs(2)
    x, m = torch.from_numpy(x0), torch.from_numpy(m0)
    # Omelyan's 11 stages against the port's generic integrator
    omelyan = fm.fused_mclmc(x, m, 1.0, 0.05, 1.0, target=target, num_steps=2, refresh=False,
                             coefficients=integrators.omelyan_coefficients)
    step = integrators.isokinetic_omelyan(target.logdensity_fn, 1.0)
    state = integrators.new_integrator_state(target.logdensity_fn, x.double(), m.double())
    for _ in range(2):
        state, _ = step(state, 0.05)
    np.testing.assert_allclose(omelyan[0].numpy(), state.position.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="odd number of stages"):
        fm.fused_mclmc(x, m, imm, 0.05, 1.0, target=target, num_steps=1, coefficients=[0.5, 0.5])
    with pytest.raises(ValueError, match="odd number of stages"):
        fm.fused_mclmc(x, m, imm, 0.05, 1.0, target=target, num_steps=1, coefficients=[0.1] * 17)
    with pytest.raises(ValueError, match="outside"):
        fm.fused_mclmc(x, m, imm, 0.05, 1.0, target=target, num_steps=1, track_dims=(D,))
    with pytest.raises(ValueError, match="registered target dim"):
        fm.fused_mclmc(x[:, :-1], m[:, :-1], imm[:-1], 0.05, 1.0, target=target, num_steps=1)


def test_build_key_follows_every_header(tmp_path, monkeypatch):
    """The library's name hashes the source and every ``csrc/*.cuh``, so an
    edited shared header rebuilds the kernels that include it."""
    src = tmp_path / "csrc"
    shutil.copytree(_nvcc._SRC_DIR, src)
    monkeypatch.setattr(_nvcc, "_SRC_DIR", src)
    before = {name: _nvcc._paths(name)[1].name for name in ("fused_mclmc", "fused_leapfrog")}
    assert before == {name: _nvcc._paths(name)[1].name for name in before}
    header = src / "analytic_targets.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: _nvcc._paths(name)[1].name for name in before}
    assert all(after[name] != before[name] for name in before)
    (src / "new_helper.cuh").write_text("// a new header\n")
    assert _nvcc._paths("fused_mclmc")[1].name != after["fused_mclmc"]
