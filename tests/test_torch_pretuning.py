"""The port's SMC pretuning (``smc.pretuning``) against the JAX package, in
float64, on the same keys (``interop.prng_key``).

The reference random-walks the parameter population with float32 noise,
also under x64. The port's float32 normals are XLA's bit for bit as XLA
compiles them at its default level, where it contracts ``erf_inv``'s
multiply-adds (at level 0 it does not, and 4 % of float32 draws differ by an
ulp): so the references that draw noise are compiled at the default level,
and the port draws its own noise.

- ``esjd`` in a dense metric within 1e-12.
- ``update_parameter_distribution``: the population and the mixing measure
  within 1e-10, the resampled indices identical; the port's noise bit for
  bit.
- ``natural_parameters`` round to the reference's default integer: int64
  under x64 (a float64 state), int32 for a float32 state.
- ``pretuning`` over ``tempered_smc`` with per-particle MALA step sizes on
  the tracked SMC target at d = 3 (200 particles), step by step
  (``tools/particle_reference.pretune_run`` and ``chip_smoke.pretune_run``):
  the step-size population, the particles and weights within 1e-10, the
  ancestors identical.

The JAX side is compiled once per function, at XLA's optimization level 0
where it draws no noise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
import chip_smoke  # noqa: E402
from blackjax_tpu import util as jutil  # noqa: E402
from blackjax_tpu.smc import pretuning as jpretuning  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import hmc  # noqa: E402
from blackjax_tpu_torch.smc import pretuning, tempered  # noqa: E402
from blackjax_tpu_torch.smc.inner_kernel_tuning import StateWithParameterOverride  # noqa: E402
from tools import particle_reference as reference  # noqa: E402

N, D, MCMC_STEPS = 200, 3, 3
SCHEDULE = np.linspace(0.05, 1.0, 5)
TOL = 1e-10


def _key(seed):
    return interop.prng_key(jax.random.key_data(jax.random.key(seed)))


def _x0():
    return 3.0 * np.random.default_rng(1).standard_normal((N, D))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b), rtol=0, atol=tol)


_NOISE = jax.jit(jutil.generate_gaussian_noise)


def test_esjd_matches_the_reference():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((D, D))
    m = a @ a.T + D * np.eye(D)
    prev, new = rng.standard_normal((2, N, D))
    acc = rng.random((N, 1))
    expected = jpretuning.esjd(jnp.asarray(m))(jnp.asarray(prev), jnp.asarray(new),
                                               jnp.asarray(acc))
    got = pretuning.esjd(torch.from_numpy(m))(torch.from_numpy(prev), torch.from_numpy(new),
                                              torch.from_numpy(acc))
    assert got.shape == (N, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12)


def _distribution_inputs():
    rng = np.random.default_rng(5)
    prev, new = rng.standard_normal((2, N, D))
    params = {"step_size": np.linspace(0.05, 0.5, N)}
    return prev, new, params, rng.random((N, 1))


def _update(module, asarray, key, prev, new, params, acc):
    measure = module.esjd(asarray(np.eye(D)))
    sigma = {"step_size": asarray(np.asarray(0.05))}
    return module.update_parameter_distribution(
        key, {k: asarray(v) for k, v in params.items()}, asarray(prev), asarray(new), measure,
        alpha=1.0, sigma_parameters=sigma, acceptance_probability=asarray(acc))


def _reference_update(prev, new, params, acc):
    return jax.jit(lambda key: _update(jpretuning, jnp.asarray, key, prev, new, params,
                                       acc))(jax.random.key(6))


def test_update_parameter_distribution_matches_the_reference():
    prev, new, params, acc = _distribution_inputs()
    ref_params, ref_mixing = _reference_update(prev, new, params, acc)
    got_params, mixing = _update(pretuning, torch.from_numpy, _key(6), prev, new, params, acc)
    assert mixing.shape == (N, 1) and got_params["step_size"].dtype == torch.float64
    _close(mixing, ref_mixing, 1e-12)
    _close(got_params["step_size"], ref_params["step_size"])


def test_the_port_draws_the_reference_noise_to_float32_rounding():
    """The noise itself, as the population update draws it (float32 normals
    under x64, scaled by a float64 sigma), bit for bit with the reference's
    ``generate_gaussian_noise`` on the same key."""
    x = np.linspace(0.01, 1.0, N).astype(np.float32)
    sigma = np.asarray(0.05)
    expected = _NOISE(jax.random.key(6), jnp.asarray(x), 0.0, jnp.asarray(sigma))
    got = pretuning.generate_gaussian_noise(_key(6), torch.from_numpy(x),
                                            sigma=torch.from_numpy(sigma))
    np.testing.assert_array_equal(got.double().numpy(), np.asarray(expected, np.float64))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_natural_parameters_round_to_the_reference_integer(dtype):
    """The rule of ``.astype(int)``: int64 under x64 (the JAX side here,
    float64 particles), int32 without (float32 particles)."""
    x = torch.from_numpy(_x0()).to(dtype)
    pretune = pretuning.build_pretune(
        hmc.init, hmc.build_kernel(), alpha=1.0,
        sigma_parameters={"num_integration_steps": 1.0, "step_size": 0.01}, n_particles=N,
        natural_parameters=["num_integration_steps"], positive_parameters=["step_size"])
    params = {"step_size": torch.full((N,), 0.2, dtype=dtype),
              "inverse_mass_matrix": torch.eye(D, dtype=dtype)[None],
              "num_integration_steps": torch.full((N,), 3, dtype=torch.int64)}
    logprior_fn, loglikelihood_fn = chip_smoke.smc_target(torch, "cpu", dtype, D)
    updated = pretune(_key(7), StateWithParameterOverride(tempered.init(x), params),
                      lambda y: logprior_fn(y) + 0.5 * loglikelihood_fn(y))
    steps = updated["num_integration_steps"]
    assert steps.dtype == (torch.int64 if dtype == torch.float64 else torch.int32)
    assert bool((steps >= 1).all()) and bool((updated["step_size"] > 0).all())
    if dtype == torch.float64:
        ref_steps = jnp.maximum(jnp.abs(jnp.round(jnp.asarray(2.6))).astype(int), 1)
        assert str(ref_steps.dtype) == "int64"


@pytest.fixture(scope="module")
def runs():
    ref = reference.pretune_run(jnp.asarray(_x0()), jax.random.key(18), SCHEDULE, MCMC_STEPS,
                                jit=jax.jit)
    port = chip_smoke.pretune_run(torch, torch.from_numpy(_x0()), _key(18),
                                  torch.from_numpy(SCHEDULE), MCMC_STEPS)
    return ref, port


def test_pretuning_step_by_step(runs):
    ref_steps, steps = runs
    assert len(steps) == len(ref_steps) == len(SCHEDULE)
    for (state, info), (ref_state, ref_info) in zip(steps, ref_steps):
        _close(state.parameter_override["step_size"], ref_state.parameter_override["step_size"])
        _close(state.sampler_state.particles, ref_state.sampler_state.particles)
        np.testing.assert_allclose(state.sampler_state.weights.numpy(),
                                   np.asarray(ref_state.sampler_state.weights), rtol=1e-10)
        _close(state.sampler_state.tempering_param, ref_state.sampler_state.tempering_param)
        np.testing.assert_array_equal(info.ancestors.numpy(), np.asarray(ref_info.ancestors))
        _close(info.log_likelihood_increment, ref_info.log_likelihood_increment)
    assert float(steps[-1][0].sampler_state.tempering_param) == 1.0


def test_registry_builds_pretuning_as_the_reference():
    import blackjax_tpu_torch as bj

    assert bj.pretuning.init is pretuning.init
    assert bj.pretuning.build_kernel is pretuning.build_kernel
    assert bj.pretuning.differentiable is pretuning.as_top_level_api
    assert "pretuning" in blackjax_tpu.__all__ and "pretuning" in bj.__all__
    state = bj.pretuning.init(tempered.init, torch.from_numpy(_x0()), {"step_size": 0.1})
    assert isinstance(state, StateWithParameterOverride)
