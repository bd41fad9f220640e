"""Diagnostics of the port against ``blackjax_tpu.diagnostics`` on fixed
chains, in f64.

The port computes the same formulas with PyTorch's FFT, sort and variance;
only rounding differs, so the results agree to rtol 1e-10.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu import diagnostics as jdiag  # noqa: E402
from blackjax_tpu_torch import diagnostics  # noqa: E402

RTOL = 1e-10


def _ref(name):
    # jitted: the eager reference dispatches op by op and takes seconds
    return jax.jit(getattr(jdiag, name), static_argnames=("chain_axis", "sample_axis"))


def _chains(shape, seed=0):
    """AR(1) chains with per-chain offsets: autocorrelated, not yet mixed,
    with ties (rounded draws) for the rank normalization."""
    rng = np.random.default_rng(seed)
    m, n = shape[0], shape[1]
    rest = shape[2:]
    x = np.zeros(shape)
    noise = rng.standard_normal(shape)
    for t in range(1, n):
        x[:, t] = 0.7 * x[:, t - 1] + noise[:, t]
    x += 0.3 * rng.standard_normal((m, 1) + rest)
    x[0, : n // 4] = np.round(x[0, : n // 4], 1)
    return x


@pytest.mark.parametrize("shape", [(4, 200), (6, 101, 3)])
@pytest.mark.parametrize(
    "name", ["effective_sample_size", "ess_bulk", "rhat", "potential_scale_reduction"]
)
def test_matches_reference(name, shape):
    x = _chains(shape)
    ref = np.asarray(_ref(name)(jnp.asarray(x)))
    got = getattr(diagnostics, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_axes_are_honoured():
    x = _chains((3, 64, 2), seed=1)
    xt = np.transpose(x, (1, 2, 0))  # (samples, dims, chains)
    ref = np.asarray(
        _ref("effective_sample_size")(jnp.asarray(xt), chain_axis=2, sample_axis=0)
    )
    got = diagnostics.effective_sample_size(torch.from_numpy(xt), chain_axis=2, sample_axis=0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)


def test_next_fast_len_is_five_smooth():
    scipy_fftpack = pytest.importorskip("scipy.fftpack")
    for n in range(1, 3000):
        assert diagnostics._next_fast_len(n) == scipy_fftpack.next_fast_len(n)
