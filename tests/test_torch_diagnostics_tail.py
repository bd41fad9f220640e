"""The port's tail ESS, nested R̂, Pareto k̂ and PSIS weights against the
JAX package's ``diagnostics`` in float64, within 1e-10 like the rest of the
module: the same numpy-seeded draws through both."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu import diagnostics as jdiag  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import diagnostics  # noqa: E402

TOL = 1e-10


def _jit(fn, **static):
    """The reference function compiled once at the lowest optimisation
    level (quicker than its ops one by one, where it traces)."""
    return jax.jit(functools.partial(fn, **static),
                   compiler_options={"xla_backend_optimization_level": 0,
                                     "xla_cpu_use_fusion_emitters": False})


def _chains(shape, seed):
    """AR(1) chains with a heavy-tailed innovation, shaped ``(chains,
    draws, ...)``."""
    rng = np.random.default_rng(seed)
    noise = rng.standard_t(4, shape)
    x = np.empty(shape)
    x[:, 0] = noise[:, 0]
    for t in range(1, shape[1]):
        x[:, t] = 0.6 * x[:, t - 1] + noise[:, t]
    return x


def _close(got, expected):
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape, prob", [((4, 200), 0.9), ((3, 301, 2), 0.8)])
def test_ess_tail_matches_reference(shape, prob):
    x = _chains(shape, sum(shape))
    _close(blackjax_tpu_torch.ess_tail(torch.from_numpy(x), prob=prob),
           _jit(jdiag.ess_tail, prob=prob)(jnp.asarray(x)))


def test_ess_tail_with_other_axes():
    x = np.moveaxis(_chains((4, 120, 2), 3), 0, 2)  # (draws, dims, chains)
    _close(diagnostics.ess_tail(torch.from_numpy(x), chain_axis=2, sample_axis=0),
           _jit(jdiag.ess_tail, chain_axis=2, sample_axis=0)(jnp.asarray(x)))


@pytest.mark.parametrize("superchain_size", [2, 4])
def test_splitR_matches_reference(superchain_size):
    x = np.random.default_rng(5).standard_normal((16, 3)) + np.repeat(
        np.random.default_rng(6).standard_normal((16 // superchain_size, 3)), superchain_size, 0)
    _close(diagnostics.splitR(torch.from_numpy(x), 16, superchain_size),
           jdiag.splitR(jnp.asarray(x), 16, superchain_size))
    _close(diagnostics.splitR(torch.from_numpy(x), 16, superchain_size, torch.abs),
           jdiag.splitR(jnp.asarray(x), 16, superchain_size, jnp.abs))


@pytest.mark.parametrize("tail", ["both", "left", "right"])
@pytest.mark.parametrize("df", [2.0, 10.0])
def test_pareto_khat_matches_reference(tail, df):
    """The reference's ``_gpdfit`` takes a static size, so it runs op by op
    here; one sample size keeps its compiled ops shared."""
    x = np.random.default_rng(int(df)).standard_t(df, 2000)
    x[:7] = [40.0, -35.0, 22.0, 1e-3, 0.0, -18.0, 60.0]
    _close(blackjax_tpu_torch.pareto_khat(torch.from_numpy(x), tail=tail),
           jdiag.pareto_khat(jnp.asarray(x), tail=tail))


def test_gpd_fit_and_quantiles_match_reference():
    exceed = np.sort(np.random.default_rng(8).pareto(2.5, 300))
    k, sigma = diagnostics._gpdfit(torch.from_numpy(exceed))
    jk, jsigma = jdiag._gpdfit(jnp.asarray(exceed))
    _close(k, jk)
    _close(sigma, jsigma)
    p = (np.arange(1, 51) - 0.5) / 50
    for kk in [0.4, 1e-14, -0.2]:
        _close(diagnostics._gpinv(torch.from_numpy(p), torch.tensor(kk, dtype=torch.float64),
                                  torch.tensor(1.3, dtype=torch.float64)),
               jdiag._gpinv(jnp.asarray(p), jnp.asarray(kk), jnp.asarray(1.3)))


@pytest.mark.parametrize("n, r_eff", [(400, 0.7), (20, 1.0)])
def test_psis_weights_match_reference(n, r_eff):
    log_ratios = np.random.default_rng(n).standard_normal(n) * 1.5
    log_ratios = log_ratios.reshape(-1, 4) if n % 4 == 0 else log_ratios
    got_w, got_k = diagnostics.psis_weights(torch.from_numpy(log_ratios), r_eff)
    exp_w, exp_k = jdiag.psis_weights(jnp.asarray(log_ratios), r_eff)
    assert got_w.shape == log_ratios.shape
    _close(got_w, exp_w)
    _close(got_k, exp_k)
