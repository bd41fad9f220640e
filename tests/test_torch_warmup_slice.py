"""The port's warmup with NUTS, and the fused-HMC slice end to end, on the CPU.

``window_adaptation(nuts)`` is held statistically, as
``tests/adaptation/test_window_adaptation.py:28-90`` holds the reference:
the inverse mass matrix within rtol 0.5 of the known variances, the step size
in (0.05, 5), the pooled run's state with its chain axis. The slice (warmup
with the generic HMC, then ``fused_hmc`` on the adapted parameters, then
ESS) recovers the target's variances, and its ESS equals the JAX package's
``effective_sample_size`` on the same history.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu import diagnostics as jdiag  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn  # noqa: E402
from blackjax_tpu_torch.mcmc import hmc, nuts  # noqa: E402
from blackjax_tpu_torch.ops.fused_leapfrog import make_gaussian_target  # noqa: E402

VARIANCES = [0.25, 1.0, 4.0, 9.0]


def _logdensity(x):
    return -0.5 * (x**2 / torch.tensor(VARIANCES, dtype=x.dtype)).sum(-1)


def test_window_adaptation_nuts_diagonal():
    warmup = blackjax_tpu_torch.window_adaptation(nuts, _logdensity)
    (state, params), _ = warmup.run(
        torch.Generator().manual_seed(0), torch.zeros(4, dtype=torch.float64), 500
    )
    imm = params["inverse_mass_matrix"].numpy()
    assert imm.ndim == 1
    np.testing.assert_allclose(imm, VARIANCES, rtol=0.5)
    assert 0.05 < params["step_size"] < 5.0


def test_window_adaptation_nuts_multichain_pooled():
    n_chains = 16
    warmup = blackjax_tpu_torch.window_adaptation(nuts, _logdensity, n_chains=n_chains)
    g = torch.Generator().manual_seed(1)
    positions = torch.randn(n_chains, 4, generator=g, dtype=torch.float64)
    (state, params), _ = warmup.run(g, positions, 400)
    np.testing.assert_allclose(params["inverse_mass_matrix"].numpy(), VARIANCES, rtol=0.5)
    assert 0.05 < params["step_size"] < 5.0
    assert state.position.shape == (n_chains, 4)


D, C, S = 8, 64, 300
SLICE_VARIANCES = np.array([0.25, 0.5, 1.0, 2.0, 4.0, 1.0, 0.5, 3.0])


@pytest.fixture(scope="module")
def slice_run():
    var = torch.from_numpy(SLICE_VARIANCES)
    warmup = blackjax_tpu_torch.window_adaptation(
        hmc, lambda x: -0.5 * (x**2 / var.to(x.dtype)).sum(-1), n_chains=C,
        num_integration_steps=8,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"acceptance_rate"}),
    )
    g = torch.Generator().manual_seed(2)
    init = torch.from_numpy(2.0 * np.random.default_rng(3).standard_normal((C, D))).float()
    (state, params), info = warmup.run(g, init, 200)
    algo = blackjax_tpu_torch.fused_hmc(
        make_gaussian_target(D, SLICE_VARIANCES), params["step_size"],
        params["inverse_mass_matrix"], 8,
    )
    _, (hist, acc) = blackjax_tpu_torch.util.run_inference_algorithm(
        g, algo, S, initial_position=state.position,
        transform=lambda s, i: (s.positions, i.acceptance_rate),
    )
    return params, info, hist.permute(1, 0, 2), acc


def test_slice_adapts_and_recovers_variances(slice_run):
    params, info, hist, acc = slice_run
    np.testing.assert_allclose(params["inverse_mass_matrix"].numpy(), SLICE_VARIANCES, rtol=0.3)
    assert info.info.acceptance_rate.shape == (200, C)
    assert hist.shape == (C, S, D) and hist.dtype == torch.float32
    assert torch.isfinite(hist).all() and 0.5 < float(acc.mean()) < 0.99
    np.testing.assert_allclose(hist[:, S // 3:].reshape(-1, D).var(0).numpy(),
                               SLICE_VARIANCES, rtol=0.2)


def test_slice_ess_equals_reference_on_the_same_history(slice_run):
    _, _, hist, _ = slice_run
    h = hist.double()
    got = blackjax_tpu_torch.ess(h)
    expected = np.asarray(jax.jit(jdiag.effective_sample_size)(jnp.asarray(h.numpy())))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-10)
    assert float(got.min()) > C
