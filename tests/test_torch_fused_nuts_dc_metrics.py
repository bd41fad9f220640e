"""The port's dc machine under the dense and low-rank metrics (its plain
PyTorch version, which the wrapper takes for CPU tensors) against the Pallas
kernel in interpret mode, and the consistency pins of
``tests/ops/test_fused_nuts_dc_metrics.py`` on the port.

Both machines draw the same counter-based numbers and build the same metric
operands (an f32 Cholesky and triangular solve for the dense momentum factor;
``1 / sigma``, ``lam - 1`` and ``1 / sqrt(lam) - 1`` for the low-rank one), so
they are held chain by chain at the tolerances of
``tests/test_torch_fused_nuts_dc.py``: steps and gradient totals identical,
and a floor under the share of chains whose final position and history agree
to 1e-5. Measured here: 16 of 16 chains agree for every case.

The pins: ``diag(v)`` as a dense matrix and a low-rank payload with ``lam =
1`` reduce to the diagonal metric ``v`` (``sigma^2``), and draw the same
numbers, so they give the diagonal path's samples to f32 rounding; ``pack =
4`` changes nothing, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.mcmc.metrics import LowRankInverseMassMatrix as RefLowRank  # noqa: E402
from blackjax_tpu.ops import fused_nuts_dc as ref  # noqa: E402
from blackjax_tpu.ops import targets_dc as ref_dc  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts_dc as port  # noqa: E402
from test_torch_fused_nuts_dc import reference_at_opt0  # noqa: E402

C, S = 16, 8
COMMON = dict(num_steps=S, max_num_doublings=4, seed=7, budget=S * 16, chunk=16)
AGREE_FLOOR = 0.9  # tests/test_torch_fused_nuts_dc.py
TOL = 1e-5


def _logreg_data(n, d):
    rng = np.random.default_rng(2)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


def dense_imm(d, seed):
    """A well-conditioned SPD matrix with correlations, f32."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((d, d))
    return (0.5 * a @ a.T / d + np.diag(rng.uniform(0.5, 1.5, d))).astype(np.float32)


def low_rank_imm(d, k, seed):
    """``(sigma, U, lam)`` with orthonormal ``U`` and informative ``lam``, f32."""
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((d, k)))
    lam = np.concatenate([rng.uniform(2.5, 6.0, k - k // 2), rng.uniform(0.1, 0.4, k // 2)])
    return tuple(a.astype(np.float32) for a in (rng.uniform(0.6, 1.4, d), U, lam))


# name: (d, reference target, step size, scale of the initial positions)
TARGETS = {
    "gaussian": (4, ref.make_gaussian_target_dc(4, [1.0, 4.0, 0.25, 2.0]), 0.4, 0.5),
    "hierarchical": (8, ref.make_hierarchical_target_dc(8), 0.2, 0.5),
    "logreg": (12, ref_dc.make_logreg_target_dc(*_logreg_data(23, 12)), 0.15, 0.5),
}
CASES = [(name, kind) for name in TARGETS for kind in ("dense", "low_rank")]


def _metrics(kind, d):
    """The same metric for the reference (jax arrays) and the port."""
    if kind == "dense":
        m = dense_imm(d, d)
        return jnp.asarray(m), torch.from_numpy(m)
    payload = low_rank_imm(d, min(3, d - 1), d)
    return (RefLowRank(*(jnp.asarray(a) for a in payload)),
            interop.low_rank_inverse_mass_matrix(payload))


def _x0(d, scale=0.5):
    return (scale * np.random.default_rng(0).standard_normal((C, d))).astype(np.float32)


def agreeing_chains(ref_out, port_out, tol=TOL):
    fx_r, h_r = np.asarray(ref_out[0]), np.asarray(ref_out[1])
    fx_p, h_p = port_out[0].numpy(), port_out[1].numpy()
    close_x = np.isclose(fx_p, fx_r, rtol=tol, atol=tol).all(axis=1)
    close_h = np.isclose(h_p, h_r, rtol=tol, atol=tol).all(axis=(1, 2))
    return close_x & close_h


@pytest.fixture(scope="module", params=CASES, ids=[f"{n}-{k}" for n, k in CASES])
def runs(request):
    name, kind = request.param
    d, ref_target, step_size, scale = TARGETS[name]
    x0 = _x0(d, scale)
    ref_imm, port_imm = _metrics(kind, d)
    out_ref = reference_at_opt0(
        ref.fused_nuts_run_dc, jnp.asarray(x0), ref_imm, step_size=step_size, target=ref_target,
        num_track=d, interpret=True, **COMMON)
    target = interop.target_dc(ref_target.name, d, ref_target.params)
    before = dict(port.LAUNCHES)
    out_port = port.fused_nuts_run_dc(
        torch.from_numpy(x0), port_imm, step_size, target=target, num_track=d, **COMMON,
    )
    assert port.LAUNCHES == before, "a CPU call must not count a kernel launch"
    return out_ref, out_port, x0


def test_steps_and_grads_identical(runs):
    out_ref, out_port, _ = runs
    np.testing.assert_array_equal(out_port[3].numpy(), np.asarray(out_ref[3]))
    assert float(out_port[2]) == float(out_ref[2])
    assert (out_port[3].numpy() == S).all()


def test_chains_agree_with_the_pallas_kernel(runs):
    out_ref, out_port, x0 = runs
    assert out_port[0].shape == x0.shape and out_port[1].shape == (C, S, x0.shape[1])
    assert agreeing_chains(out_ref, out_port).mean() >= AGREE_FLOOR


def test_metric_operands_match_the_reference():
    """The dense momentum factor ``C = L^{-T}`` and the low-rank operands as
    the reference builds them, in f32."""
    d = 12
    m = dense_imm(d, 1)
    metric = port._dc_metric(torch.from_numpy(m), d, torch.device("cpu"))
    assert metric.kind == "dense"
    L = np.linalg.cholesky(m.astype(np.float64))
    np.testing.assert_allclose(metric.ops[1].numpy(), np.linalg.inv(L).T, rtol=1e-5, atol=1e-6)
    chol, imm = metric.ops[1].double(), torch.from_numpy(m).double()
    np.testing.assert_allclose((chol @ chol.T @ imm).numpy(), np.eye(d), atol=1e-5)
    sigma, U, lam = low_rank_imm(d, 3, 1)
    metric = port._dc_metric(LowRankInverseMassMatrix(*map(torch.from_numpy, (sigma, U, lam))),
                             d, torch.device("cpu"))
    assert metric.kind == "low_rank"
    for got, want in zip(metric.ops, (sigma, 1.0 / sigma, U, lam - 1.0,
                                      1.0 / np.sqrt(lam) - 1.0)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))


PIN_DIM = 4
PIN_VAR = [1.0, 4.0, 0.25, 2.0]
PIN = dict(num_steps=10, max_num_doublings=5, seed=3, num_track=PIN_DIM, budget=10 * 40,
           chunk=16)


def _pin_run(imm, **kw):
    x0 = torch.from_numpy(_x0(PIN_DIM, 0.2))
    return port.fused_nuts_run_dc(
        x0, imm, kw.pop("step_size", 0.4), target=port.make_gaussian_target_dc(PIN_DIM, PIN_VAR),
        **dict(PIN, **kw),
    )


@pytest.mark.parametrize("kind", ["dense", "low_rank"])
def test_consistency_pins_against_the_diagonal_path(kind):
    """``diag(v)`` as a dense matrix and ``lam = 1`` in a low-rank payload
    give the diagonal path's samples (the reference's pins, to the same
    tolerance)."""
    if kind == "dense":
        v = torch.tensor([1.0, 2.0, 0.5, 1.5])
        imm, diag = torch.diag(v), v
    else:
        sigma = torch.tensor([1.0, 1.5, 0.7, 1.2])
        U, _ = torch.linalg.qr(torch.from_numpy(
            np.random.default_rng(5).standard_normal((PIN_DIM, 2)).astype(np.float32)))
        imm, diag = LowRankInverseMassMatrix(sigma, U, torch.ones(2)), sigma**2
    fx_m, hist_m, grads_m, steps_m = _pin_run(imm)
    fx_d, hist_d, grads_d, steps_d = _pin_run(diag)
    assert (steps_m == PIN["num_steps"]).all()
    np.testing.assert_allclose(hist_m.numpy(), hist_d.numpy(), rtol=2e-5, atol=1e-5)
    np.testing.assert_array_equal(steps_m.numpy(), steps_d.numpy())


@pytest.mark.parametrize("kind", ["dense", "low_rank"])
def test_pack_bitwise_under_rich_metrics(kind):
    """``pack = 4`` is scheduling only under the dense and low-rank metrics
    too (``tests/ops/test_fused_nuts_dc_metrics.py:162-189``)."""
    if kind == "dense":
        v = torch.tensor([1.0, 2.0, 0.5, 1.5])
        imm = torch.diag(v) + 0.05 * (torch.ones(PIN_DIM, PIN_DIM) - torch.eye(PIN_DIM))
    else:
        U, _ = torch.linalg.qr(torch.from_numpy(
            np.random.default_rng(5).standard_normal((PIN_DIM, 2)).astype(np.float32)))
        imm = LowRankInverseMassMatrix(torch.tensor([1.0, 1.5, 0.7, 1.2]), U,
                                       torch.tensor([3.0, 0.5]))
    one = _pin_run(imm, step_size=0.3, budget=10 * 40)
    four = _pin_run(imm, step_size=0.3, budget=10 * 40 * 4, pack=4)
    for a, b, name in zip(one, four, ["final_x", "hist", "grads", "steps"]):
        assert torch.equal(a, b), name


def test_low_rank_shapes_are_checked():
    with pytest.raises(ValueError, match="do not fit d=4"):
        _pin_run(LowRankInverseMassMatrix(torch.ones(4), torch.zeros(3, 2), torch.ones(2)))
