"""The port's dc machine (its plain PyTorch version, which the wrapper takes
for CPU tensors) against the Pallas kernel in interpret mode.

Both draw the same counter-based threefry numbers, so they are held chain by
chain. Their arithmetic is the same; what differs is the summation order of
the dot products and the last ulp of exp, log and cos. Such a difference
changes a chain's path only if it flips an accept or a U-turn decision, so
the test measures the share of chains whose final position and history
agree to 1e-5, and asserts a floor under the measured share. Measured on
this configuration: 16 of 16 chains agree for every target (the analytic
ones and the matrix targets of ``ops/targets_dc.py``: logistic regression at
23 x 12, the horseshoe at N=12, M=16, eight schools), the largest difference
is 1e-6 to 4e-6, and steps and total gradient counts are identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops import fused_nuts_dc as ref  # noqa: E402
from blackjax_tpu.ops import targets_dc as ref_dc  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts_dc as port  # noqa: E402

C, S = 16, 8
COMMON = dict(num_steps=S, max_num_doublings=4, seed=7, budget=S * 16, chunk=16)
# one flip in 16 chains may pass; the measured share is 1.0
AGREE_FLOOR = 0.9
TOL = 1e-5


def reference_at_opt0(fn, *arrays, **kw):
    """``fn(*arrays, **kw)`` with ``kw`` static, compiled at XLA's
    optimization level 0 with its older CPU fusion emitters: the Pallas
    references compile in about half the time of an eager call's default
    level, and the older emitters take less again."""
    return jax.jit(lambda *a: fn(*a, **kw),
                   compiler_options={"xla_backend_optimization_level": 0,
                                     "xla_cpu_use_fusion_emitters": False})(*arrays)


def _logreg_data(n, d):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


# name: (d, reference target, step size, scale of the initial positions)
CASES = {
    "hierarchical": (8, ref.make_hierarchical_target_dc(8), 0.2, 0.5),
    "gaussian": (4, ref.make_gaussian_target_dc(4, [1.0, 4.0, 0.25, 2.0]), 0.4, 0.5),
    "logreg": (12, ref_dc.make_logreg_target_dc(*_logreg_data(23, 12)), 0.3, 0.5),
    "horseshoe": (36, ref_dc.make_finnish_horseshoe_target_dc(12, 16), 0.05, 0.1),
    "eight_schools": (10, ref_dc.make_eight_schools_target_dc(), 0.2, 0.5),
}


def _x0(d, scale=0.5):
    return (scale * np.random.default_rng(0).standard_normal((C, d))).astype(np.float32)


def agreeing_chains(ref_out, port_out, tol=TOL):
    """Per chain: final position and history within ``tol``."""
    fx_r, h_r = np.asarray(ref_out[0]), np.asarray(ref_out[1])
    fx_p, h_p = port_out[0].numpy(), port_out[1].numpy()
    close_x = np.isclose(fx_p, fx_r, rtol=tol, atol=tol).all(axis=1)
    close_h = np.isclose(h_p, h_r, rtol=tol, atol=tol).all(axis=(1, 2))
    return close_x & close_h


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    d, ref_target, step_size, scale = CASES[request.param]
    x0 = _x0(d, scale)
    out_ref = reference_at_opt0(
        ref.fused_nuts_run_dc, jnp.asarray(x0), jnp.ones(d), step_size=step_size, target=ref_target,
        num_track=d, interpret=True, **COMMON)
    target = interop.target_dc(ref_target.name, d, ref_target.params)
    before = dict(port.LAUNCHES)
    out_port = port.fused_nuts_run_dc(
        torch.from_numpy(x0), torch.ones(d), step_size, target=target,
        num_track=d, **COMMON,
    )
    assert port.LAUNCHES == before, "a CPU call must not count a kernel launch"
    return out_ref, out_port, x0, target, step_size


def test_steps_and_grads_identical(runs):
    out_ref, out_port, *_ = runs
    np.testing.assert_array_equal(out_port[3].numpy(), np.asarray(out_ref[3]))
    assert float(out_port[2]) == float(out_ref[2])
    assert out_port[3].dtype == torch.int32


def test_chains_agree_with_the_pallas_kernel(runs):
    out_ref, out_port, x0, *_ = runs
    assert out_port[0].shape == x0.shape and out_port[1].shape == (C, S, x0.shape[1])
    assert agreeing_chains(out_ref, out_port).mean() >= AGREE_FLOOR


def test_track_rows_selects_columns(runs):
    _, out_port, x0, target, step_size = runs
    rows = (2, 0, 3)
    _, hist_sub, _, _ = port.fused_nuts_run_dc(
        torch.from_numpy(x0), torch.ones(x0.shape[1]), step_size, target=target,
        num_track=len(rows), track_rows=rows, **COMMON,
    )
    np.testing.assert_array_equal(hist_sub.numpy(), out_port[1].numpy()[:, :, list(rows)])


def test_budget_exhaustion_matches_reference():
    """A budget too small for every chain: the same chains stop short, with
    the same zero history rows past their last transition."""
    d, ref_target, step_size, _ = CASES["hierarchical"]
    x0 = _x0(d)
    kw = dict(COMMON, budget=32)
    out_ref = reference_at_opt0(
        ref.fused_nuts_run_dc, jnp.asarray(x0), jnp.ones(d), step_size=step_size, target=ref_target,
        num_track=d, interpret=True, **kw)
    out_port = port.fused_nuts_run_dc_plain(
        torch.from_numpy(x0), torch.ones(d), step_size,
        target=port.make_hierarchical_target_dc(d), num_track=d, **kw,
    )
    steps = out_port[3].numpy()
    np.testing.assert_array_equal(steps, np.asarray(out_ref[3]))
    assert steps.max() < S
    for c in range(C):
        assert (out_port[1][c, steps[c]:] == 0).all()
    assert agreeing_chains(out_ref, out_port).mean() >= AGREE_FLOOR


PACKED = dict(num_steps=S, max_num_doublings=4, seed=7, chunk=16, pack=4, restart_every=2)


@pytest.fixture(scope="module")
def packed_runs():
    """512 chains, so that each of the 128 lanes of the reference's tile runs
    four real chains one after the other, under a lane budget that lets the
    first two finish, cuts the third short or never reaches it, and almost
    never reaches the fourth."""
    d, ref_target, step_size, _ = CASES["hierarchical"]
    x0 = (0.5 * np.random.default_rng(1).standard_normal((512, d))).astype(np.float32)
    kw = dict(PACKED, budget=256, num_track=d)
    out_ref = reference_at_opt0(
        ref.fused_nuts_run_dc, jnp.asarray(x0), jnp.ones(d), step_size=step_size, target=ref_target,
        interpret=True, **kw)
    out_port = port.fused_nuts_run_dc(
        torch.from_numpy(x0), torch.ones(d), step_size,
        target=port.make_hierarchical_target_dc(d), **kw,
    )
    return out_ref, out_port, x0


def test_pack_and_restart_every_budget_matches_reference(packed_runs):
    """The lane budget flags exactly the reference's chains; chains it never
    reaches keep their initial position, and unreached history rows stay 0."""
    out_ref, out_port, x0 = packed_runs
    steps = out_port[3].numpy()
    np.testing.assert_array_equal(steps, np.asarray(out_ref[3]))
    lane_block = steps.reshape(4, 128)  # chain k * 128 + j is the k-th of lane j
    assert (lane_block[:2] == S).all()
    cut = lane_block[2]
    assert ((cut > 0) & (cut < S)).any() and (cut == 0).any()  # cut short, unreached
    np.testing.assert_array_equal(out_port[0].numpy()[steps == 0], x0[steps == 0])
    for c in range(x0.shape[0]):
        assert (out_port[1][c, steps[c]:] == 0).all()
    assert agreeing_chains(out_ref, out_port).mean() >= AGREE_FLOOR
    assert float(out_port[2]) == float(out_ref[2])


def test_pack_and_restart_every_are_no_ops_within_budget(runs):
    """With a budget that binds for no chain, both knobs leave every output
    bit for bit as it was (the reference pins the same)."""
    _, out_port, x0, target, step_size = runs
    d = x0.shape[1]
    packed = port.fused_nuts_run_dc(
        torch.from_numpy(x0), torch.ones(d), step_size, target=target, num_track=d,
        **dict(PACKED, budget=4 * S * 16),
    )
    for a, b in zip(out_port, packed):
        assert torch.equal(a, b)


def _errors(module, target, x0, imm, **kw):
    try:
        module.fused_nuts_run_dc(x0, imm, 0.4, target=target, num_steps=4, **kw)
    except Exception as exc:  # noqa: BLE001 - the type and message are compared
        return type(exc), str(exc)
    return None


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_track=2, track_rows=(0, 1, 2)),
        dict(num_track=1, track_rows=(4,)),
        dict(num_track=5),
        dict(num_track=2, pack=0),
        dict(num_track=2, restart_every=3, chunk=8),
        dict(num_track=2, restart_every=0),
    ],
)
def test_validation_errors_match_reference(kw):
    x0 = np.zeros((8, 4), np.float32)
    expected = _errors(ref, ref.make_gaussian_target_dc(4), jnp.asarray(x0), jnp.ones(4),
                       interpret=True, **kw)
    got = _errors(port, port.make_gaussian_target_dc(4), torch.from_numpy(x0), torch.ones(4), **kw)
    assert expected is not None and got == expected


@pytest.mark.parametrize(
    "kw, match",
    [
        # the machine takes the diagonal, dense and low-rank metrics; a
        # position-dependent one is refused by name
        pytest.param(dict(imm=lambda x: torch.ones_like(x)), "dense and low-rank",
                     id="kw2-dense and low-rank"),
    ],
)
def test_not_ported_options_raise(kw, match):
    imm = kw.pop("imm", torch.ones(4))
    with pytest.raises(NotImplementedError, match=match):
        port.fused_nuts_run_dc(
            torch.zeros(8, 4), imm, 0.4, target=port.make_gaussian_target_dc(4),
            num_steps=4, num_track=2, **kw,
        )


def test_dim_mismatch_raises():
    with pytest.raises(ValueError, match="registered target dim"):
        port.fused_nuts_run_dc(
            torch.zeros(8, 5), torch.ones(5), 0.4,
            target=port.make_hierarchical_target_dc(4), num_steps=4, num_track=2,
        )
