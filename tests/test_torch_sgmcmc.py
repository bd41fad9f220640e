"""The port's SG-MCMC slice against the JAX package in float64 on the same
keys (``interop.prng_key``).

- ``gradients``: the log-density estimator and its gradient for one
  position and for a block of chains, and ``control_variates`` on a fixed
  center, within 1e-10 of the reference's ``jax.vmap`` over data points and
  ``jax.grad``.
- ``diffusions``, ``sgld``, ``sghmc``, ``sgnht`` and ``csgld`` (with its bin
  indices identical) over two steps on 16 chains: positions, momenta and
  thermostats within 1e-10. ``csgld`` with ``zeta = 0`` is SGLD bit for bit.
- The tracked configurations (``benchmarks/tracked.py``: ``config_sgld``
  and ``config_sgld_chains``) at their CPU sizes, through phase 18's own
  functions (``chip_smoke.sgld_single``, ``chip_smoke.sgmcmc_chains``) on the
  dataset rebuilt from the reference's key words, against
  ``tools/sgmcmc_reference.py`` on the reference's dataset: minibatch
  indices identical, positions within 1e-10.
- ``models.logistic_regression``: the key-words path against the
  reference's dataset (no label differs), and the log density on given data
  bit for bit the earlier function's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
import chip_smoke  # noqa: E402
from blackjax_tpu.models import targets as jtargets  # noqa: E402
from blackjax_tpu.sgmcmc import diffusions as jdiffusions  # noqa: E402
from blackjax_tpu.sgmcmc import gradients as jgradients  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.models import targets  # noqa: E402
from blackjax_tpu_torch.sgmcmc import diffusions, gradients  # noqa: E402
from tools import sgmcmc_reference as ref  # noqa: E402

TOL = 1e-10
N, D, C, B = 256, 5, 16, 32
JIT = dict(compiler_options={"xla_backend_optimization_level": 0})
FAST_JIT = functools.partial(jax.jit, **JIT)


@functools.lru_cache(maxsize=None)
def _data():
    return FAST_JIT(lambda key: jtargets.logistic_regression(key, num_points=N, dim=D)[1:])(
        jax.random.key(3))


@functools.lru_cache(maxsize=None)
def _tracked_data():
    """The configurations' dataset, the reference's and the port's rebuild."""
    return ref.dataset(FAST_JIT), chip_smoke.sgld_dataset(torch, prng, "cpu", torch.float64)


def _port(X, y):
    return torch.from_numpy(np.array(X)), torch.from_numpy(np.array(y))


def _keys(seed, steps):
    return jax.vmap(lambda k: jax.random.split(k, C))(
        jax.random.split(jax.random.key(seed), steps))


def _w0():
    return 0.1 * np.random.default_rng(4).standard_normal((C, D))


def _estimators(data_size=N):
    tprior, tlik = chip_smoke.sgld_model(torch)
    return ((jgradients.logdensity_estimator(ref.logprior_fn, ref.loglikelihood_fn, data_size),
             jgradients.grad_estimator(ref.logprior_fn, ref.loglikelihood_fn, data_size)),
            (gradients.logdensity_estimator(tprior, tlik, data_size),
             gradients.grad_estimator(tprior, tlik, data_size)))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


def test_estimators_and_control_variates():
    X, y = _data()
    tX, ty = _port(X, y)
    (jest, jgrad), (test, tgrad) = _estimators()
    idx = np.random.default_rng(5).integers(0, N, B)
    jmb, tmb = (X[idx], y[idx]), (tX[idx], ty[idx])
    w = _w0()
    center = np.linspace(-0.5, 0.5, D)

    @FAST_JIT
    def reference(w):
        jcv = jgradients.control_variates(jgrad, jnp.asarray(center), (X, y))
        return (jax.vmap(lambda v: jest(v, jmb))(w), jax.vmap(lambda v: jgrad(v, jmb))(w),
                jgrad(w[0], jmb), jax.vmap(lambda v: jcv(v, jmb))(w))

    value, grad, grad0, cv = reference(w)
    _close(test(torch.from_numpy(w), tmb), value)
    _close(tgrad(torch.from_numpy(w), tmb), grad)
    _close(tgrad(torch.from_numpy(w[0]), tmb), grad0)  # one position
    tcv = gradients.control_variates(tgrad, torch.from_numpy(center), (tX, ty))
    _close(tcv(torch.from_numpy(w), tmb), cv)


def test_diffusions_match_reference():
    rng = np.random.default_rng(6)
    x, p, g = (rng.standard_normal((C, D)) for _ in range(3))
    xi = rng.uniform(0.0, 0.1, C)
    keys = jax.random.split(jax.random.key(7), C)
    tkeys = interop.prng_key(jax.random.key_data(keys))
    t = [torch.from_numpy(v) for v in (x, p, g, xi)]

    @FAST_JIT
    def reference(keys, x, p, g, xi):
        return (
            jax.vmap(lambda k, a, b: jdiffusions.overdamped_langevin()(k, a, b, 1e-3, 0.5))(
                keys, x, g),
            jax.vmap(lambda k, a, b, c: jdiffusions.sghmc(0.05, 0.1)(k, a, b, c, 1e-2))(
                keys, x, p, g),
            jax.vmap(lambda k, a, b, c, e: jdiffusions.sgnht(0.05)(k, a, b, c, e, 1e-2, 0.7))(
                keys, x, p, xi, g))

    langevin, sghmc, sgnht = reference(keys, x, p, g, xi)
    _close(diffusions.overdamped_langevin()(tkeys, t[0], t[2], 1e-3, 0.5), langevin)
    for got, expected in zip(diffusions.sghmc(0.05, 0.1)(tkeys, t[0], t[1], t[2], 1e-2), sghmc):
        _close(got, expected)
    for got, expected in zip(diffusions.sgnht(0.05)(tkeys, t[0], t[1], t[3], t[2], 1e-2, 0.7),
                             sgnht):
        _close(got, expected)


def _reference_algorithm(name, data_size=N):
    (jest, jgrad), _ = _estimators(data_size)
    return {"sgld": lambda: blackjax_tpu.sgld(jgrad),
            "sghmc": lambda: blackjax_tpu.sghmc(jgrad, num_integration_steps=5),
            "sgnht": lambda: blackjax_tpu.sgnht(jgrad),
            "csgld": lambda: blackjax_tpu.csgld(jest, jgrad)}[name]()


HOLD_STEPS = 2


@functools.lru_cache(maxsize=None)
def _reference_paths():
    """Every sampler's reference run on the keys of ``chip_smoke.sgmcmc_chains``,
    vmapped over the chains, in one compiled program: per sampler, each
    step's minibatch indices and positions, and the final state."""
    X, y = _data()

    def run():
        out = {}
        run_keys = jax.random.split(jax.random.split(jax.random.key(26), 4)[0], HOLD_STEPS)
        w0 = 0.1 * jax.random.normal(jax.random.key(25), (C, D))
        for name in chip_smoke.SG_SAMPLERS:
            algo = _reference_algorithm(name)
            if name == "sgnht":
                state = jax.vmap(algo.init)(w0, jax.random.split(jax.random.key(27), C))
            else:
                state = jax.vmap(algo.init)(w0)
            step = jax.vmap(algo.step, in_axes=(0, 0, None, None))
            indices, path = [], []
            for k in run_keys:
                k_idx, k_step = jax.random.split(k)
                idx = jax.random.randint(k_idx, (B,), 0, N)
                state = step(jax.random.split(k_step, C), state, (X[idx], y[idx]),
                             chip_smoke.SG_STEP_SIZE)
                indices.append(idx)
                path.append(state if name in ("sgld", "sghmc") else state.position)
            out[name] = (indices, path, state)
        return out

    return FAST_JIT(run)()


@pytest.mark.parametrize("name", chip_smoke.SG_SAMPLERS)
def test_samplers_match_reference(name):
    """Two steps of 16 chains on the same minibatches and keys, as phase
    18's hold runs them (``chip_smoke.sgmcmc_chains``), against the
    reference vmapped over the chains."""
    tX, ty = _port(*_data())
    state, tidx, path = chip_smoke.sgmcmc_chains(torch, blackjax_tpu_torch, prng, tX, ty, name,
                                                 C, HOLD_STEPS, B, trace=True)
    indices, jpath, jstate = _reference_paths()[name]
    for i in range(HOLD_STEPS):
        np.testing.assert_array_equal(tidx[i].numpy(), np.asarray(indices[i]))
        _close(path[i], jpath[i])
    if name == "sgnht":
        _close(state.momentum, jstate.momentum)
        _close(state.xi, jstate.xi)
    if name == "csgld":
        np.testing.assert_array_equal(state.energy_idx.numpy(), np.asarray(jstate.energy_idx))
        _close(state.energy_pdf, jstate.energy_pdf)


def test_csgld_with_zeta_zero_is_sgld_bit_for_bit():
    """As the reference's ``tests/sgmcmc/test_sgmcmc.py:142`` checks: the
    drift's rescaling is exactly 1."""
    X, y = _data()
    tX, ty = _port(X, y)
    _, (test, tgrad) = _estimators()
    csgld = blackjax_tpu_torch.csgld(test, tgrad, zeta=0.0, temperature=0.01)
    sgld = blackjax_tpu_torch.sgld(tgrad)
    w = torch.from_numpy(_w0())
    keys = prng.split(prng.key(8), C)
    minibatch = (tX[:B], ty[:B])
    out_c = csgld.step(keys, csgld.init(w), minibatch, 1e-4)
    out_s = sgld.step(keys, w, minibatch, 1e-4, temperature=0.01)
    assert torch.equal(out_c.position, out_s)
    assert out_c.energy_pdf.shape == (C, 512) and out_c.energy_idx.shape == (C,)
    np.testing.assert_allclose(out_c.energy_pdf.sum(-1).numpy(), 1.0, rtol=1e-12)


def test_tracked_config_sgld_at_its_cpu_size():
    """``config_sgld``: 500 steps, batch 128, one chain."""
    (X, y), (tX, ty) = _tracked_data()
    final, _, idx = ref.sgld_single(X, y, 500, 128, jit=FAST_JIT)
    w, tidx = chip_smoke.sgld_single(torch, blackjax_tpu_torch, prng, tX, ty, 500, 128)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    _close(w, final)


def test_tracked_config_sgld_chains_at_its_cpu_size():
    """``config_sgld_chains``: 64 chains, 50 steps, batch 64."""
    (X, y), (tX, ty) = _tracked_data()
    finals, idx = ref.sgld_chains(X, y, 64, 50, 64, jit=FAST_JIT)
    w, tidx, _ = chip_smoke.sgmcmc_chains(torch, blackjax_tpu_torch, prng, tX, ty, "sgld", 64, 50,
                                          64)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    _close(w, finals)


def test_rebuilt_dataset_is_the_reference_s():
    (X, y), (tX, ty) = _tracked_data()  # models.logistic_regression(prng.key(0), 4096, 54)
    assert int((ty.numpy() != np.asarray(y)).sum()) == 0
    _close(tX, X, 1e-12)
    assert tX.dtype == torch.float64 and ty.dtype == torch.float32  # y: the reference's cast


def _logdensity_before(X, y):
    """The log density as ``models.targets.logistic_regression`` computed
    it before its data were placed once: X and y converted at every call."""

    def logdensity_fn(w):
        logits = w @ X.to(dtype=w.dtype, device=w.device).T
        yy = y.to(dtype=w.dtype, device=w.device)
        loglik = (
            yy * torch.nn.functional.logsigmoid(logits)
            + (1 - yy) * torch.nn.functional.logsigmoid(-logits)
        ).sum(-1)
        return loglik - 0.5 * (w**2).sum(-1)

    return logdensity_fn


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_logistic_regression_on_given_data_is_bit_for_bit(dtype):
    X, y = _data()
    target, tX, ty = targets.logistic_regression(X=np.asarray(X), y=np.asarray(y))
    before = _logdensity_before(tX, ty)
    w = torch.from_numpy(_w0()).to(dtype)
    for _ in range(2):  # the first call converts the data once, the second reuses them
        assert torch.equal(target.logdensity_fn(w), before(w))
