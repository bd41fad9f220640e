"""The port's MALA (``blackjax_tpu_torch.mala``), and HMC on key words,
against the JAX package in float64 on the same keys (``interop.prng_key``).

- MALA, one step and ten, with a shared step size (a number, as the SMC
  layer binds a shared parameter) and with one per chain (``(C,)``, as it
  hands per-particle parameters): positions within 1e-10, accept flags
  identical, acceptance rates within 1e-10.
- A position that is not a tensor is refused, naming ROADMAP queue 1, item 11.
- HMC on key words splits them as the reference does (momentum key, then
  accept key): one transition held draw for draw against the JAX kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.mcmc import hmc as jhmc  # noqa: E402
from blackjax_tpu.mcmc import mala as jmala  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import hmc, mala  # noqa: E402

D, C, STEPS = 5, 64, 10
OBS = np.linspace(-1.0, 1.0, D)
STEP_SIZES = np.random.default_rng(1).uniform(0.05, 0.6, C)


def _jld(x):
    return -0.5 * jnp.sum(x**2) / 9.0 - 0.5 * jnp.sum((x - OBS) ** 2) - 0.05 * jnp.sum(x**4)


def _tld(x):
    return (-0.5 * (x**2).sum(-1) / 9.0 - 0.5 * ((x - torch.from_numpy(OBS)) ** 2).sum(-1)
            - 0.05 * (x**4).sum(-1))


def _x0():
    return 2.0 * np.random.default_rng(0).standard_normal((C, D))


def _step_keys():
    """The keys of STEPS transitions of C chains: ``(STEPS, C)``."""
    return jax.vmap(lambda k: jax.random.split(k, C))(
        jax.random.split(jax.random.key(3), STEPS))


@pytest.fixture(scope="module")
def reference_chains():
    """STEPS MALA transitions of the JAX package from the same positions,
    the step size shared and per chain, compiled once: each step's state
    and info."""
    kernel = jmala.build_kernel()
    step = jax.jit(jax.vmap(lambda k, s, eps: kernel(k, s, _jld, eps)),
                   compiler_options={"xla_backend_optimization_level": 0})
    runs = {}
    for kind, eps in [("shared", np.full(C, 0.3)), ("per-chain", STEP_SIZES)]:
        state = jax.vmap(lambda x: jmala.init(x, _jld))(jnp.asarray(_x0()))
        runs[kind] = []
        for keys in _step_keys():
            state, info = step(keys, state, jnp.asarray(eps))
            runs[kind].append((state, info))
    return runs


@pytest.mark.parametrize("num_steps", [1, STEPS])
@pytest.mark.parametrize("kind", ["shared", "per-chain"])
def test_mala_matches_reference(reference_chains, kind, num_steps):
    step_size = 0.3 if kind == "shared" else torch.from_numpy(STEP_SIZES)
    kernel = mala.build_kernel()
    state = mala.init(torch.from_numpy(_x0()), _tld)
    keys = interop.prng_key(jax.random.key_data(_step_keys()))
    accepted = []
    for i in range(num_steps):
        state, info = kernel(keys[i], state, _tld, step_size)
        ref_state, ref_info = reference_chains[kind][i]
        np.testing.assert_array_equal(info.is_accepted.numpy(),
                                      np.asarray(ref_info.is_accepted))
        np.testing.assert_allclose(info.acceptance_rate.numpy(),
                                   np.asarray(ref_info.acceptance_rate), rtol=0, atol=1e-10)
        accepted.append(info.is_accepted)
    for a, b in zip(state, ref_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-10)
    if num_steps == STEPS:  # both outcomes exercised
        assert 0 < float(torch.stack(accepted).double().mean()) < 1


def test_mala_refuses_pytree_positions():
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 11"):
        mala.init({"x": torch.zeros(3)}, lambda x: -(x["x"] ** 2).sum())


@pytest.mark.parametrize("kind", ["diag", "dense"])
def test_hmc_on_key_words_matches_reference(kind):
    imm = np.random.default_rng(2).uniform(0.5, 2.0, D)
    if kind == "dense":
        a = np.random.default_rng(2).standard_normal((D, D))
        imm = a @ a.T / D + np.eye(D)
    keys = jax.random.split(jax.random.key(5), C)
    state = jax.vmap(lambda x: jhmc.init(x, _jld))(jnp.asarray(_x0()))
    kernel = jhmc.build_kernel()
    ref_state, ref_info = jax.jit(jax.vmap(
        lambda k, s: kernel(k, s, _jld, 0.45, jnp.asarray(imm), 6)),
        compiler_options={"xla_backend_optimization_level": 0})(keys, state)
    new, info = hmc.build_kernel()(interop.prng_key(jax.random.key_data(keys)),
                                   interop.hmc_state(state), _tld, 0.45,
                                   torch.from_numpy(imm), 6)
    accepted = np.asarray(ref_info.is_accepted)
    assert 0 < accepted.sum() < C
    np.testing.assert_array_equal(info.is_accepted.numpy(), accepted)
    np.testing.assert_allclose(info.momentum.numpy(), np.asarray(ref_info.momentum),
                               rtol=1e-12, atol=1e-13)
    for a, b in zip(new, ref_state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
