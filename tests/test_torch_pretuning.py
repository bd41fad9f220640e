"""The port's SMC pretuning (``smc.pretuning``) against the JAX package, in
float64, on the same keys (``interop.prng_key``).

The reference random-walks the parameter population with float32 noise,
also under x64, and the port's float32 normals come from torch's
``erfinv``, which is not XLA's to the last bit; so the holds at 1e-10 feed
the port the reference's own noise (drawn by the reference's
``generate_gaussian_noise`` on the same key), and the port's own draw is
held to float32 rounding.

- ``esjd`` in a dense metric within 1e-12.
- ``update_parameter_distribution``: the population and the mixing measure
  within 1e-10, the resampled indices identical; the port's noise within
  float32 rounding.
- ``natural_parameters`` round to the reference's default integer: int64
  under x64 (a float64 state), int32 for a float32 state.
- ``pretuning`` over ``tempered_smc`` with per-particle MALA step sizes on
  the tracked SMC target at d = 3 (200 particles), step by step
  (``tools/particle_reference.pretune_run`` and ``chip_smoke.pretune_run``):
  the step-size population, the particles and weights within 1e-10, the
  ancestors identical.

The JAX side is compiled once per function, at XLA's optimization level 0.
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


_NOISE = reference.opt0(jutil.generate_gaussian_noise)


def reference_noise(key, position, mu=0.0, sigma=1.0):
    """The reference's ``generate_gaussian_noise`` on the port's key words,
    compiled as the reference's runs compile it (eagerly, XLA would not
    contract the float32 ``erfinv``'s multiply-adds as it does in a
    compiled step)."""
    jax_key = jax.random.wrap_key_data(jnp.asarray(key.cpu().numpy().astype(np.uint32)))
    sigma = jnp.asarray(sigma.cpu().numpy()) if torch.is_tensor(sigma) else sigma
    noise = _NOISE(jax_key, jnp.asarray(position.cpu().numpy()), mu, sigma)
    return torch.from_numpy(np.array(noise)).to(position.device)


@pytest.fixture
def the_reference_noise(monkeypatch):
    monkeypatch.setattr(pretuning, "generate_gaussian_noise", reference_noise)


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
    return reference.opt0(lambda key: _update(jpretuning, jnp.asarray, key, prev, new, params,
                                              acc))(jax.random.key(6))


def test_update_parameter_distribution_matches_the_reference(the_reference_noise):
    prev, new, params, acc = _distribution_inputs()
    ref_params, ref_mixing = _reference_update(prev, new, params, acc)
    got_params, mixing = _update(pretuning, torch.from_numpy, _key(6), prev, new, params, acc)
    assert mixing.shape == (N, 1) and got_params["step_size"].dtype == torch.float64
    _close(mixing, ref_mixing, 1e-12)
    _close(got_params["step_size"], ref_params["step_size"])


def test_the_port_draws_the_reference_noise_to_float32_rounding():
    prev, new, params, acc = _distribution_inputs()
    ref_params, _ = _reference_update(prev, new, params, acc)
    got_params, _ = _update(pretuning, torch.from_numpy, _key(6), prev, new, params, acc)
    # 0.05 times float32 normals whose erfinv may differ from XLA's by a few ulps
    _close(got_params["step_size"], ref_params["step_size"], 0.05 * 4e-6)


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
    ref = reference.pretune_run(jnp.asarray(_x0()), jax.random.key(18), SCHEDULE, MCMC_STEPS)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(pretuning, "generate_gaussian_noise", reference_noise)
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
