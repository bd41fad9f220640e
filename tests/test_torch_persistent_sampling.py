"""The port's persistent-sampling SMC (``smc.persistent_sampling``,
``smc.adaptive_persistent_sampling``) against the JAX package, in float64,
on the same keys (``interop.prng_key``).

- The weights' functions on a padded history: ``compute_log_persistent_weights``
  (with and without the current slot, normalized or not),
  ``compute_persistent_ess`` and ``compute_log_Z`` within 1e-12.
- ``persistent_sampling_smc`` along a fixed schedule and
  ``adaptive_persistent_sampling_smc`` to lambda = 1, with MALA moves on the
  tracked SMC target at d = 3 (200 particles), step by step from the same
  particles (``tools/particle_reference.ps_run`` and ``chip_smoke.ps_run``):
  lambda, ``log_Z``, the persistent weights and the history within 1e-10,
  the ancestors identical; ``remove_padding`` gives the reference's shapes.
- ``batch_size`` gives the unbatched run's numbers; ``interop`` carries the
  reference's mid-run state into the port, which continues it as the
  reference does.

The JAX side is compiled once per function, at XLA's optimization level 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
import blackjax_tpu_torch as bj  # noqa: E402
import chip_smoke  # noqa: E402
from blackjax_tpu.mcmc import mala as jmala  # noqa: E402
from blackjax_tpu.smc import persistent_sampling as jps  # noqa: E402
from blackjax_tpu.smc import resampling as jresampling  # noqa: E402
from blackjax_tpu.smc.base import extend_params  # noqa: E402
from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.mcmc import mala  # noqa: E402
from blackjax_tpu_torch.smc import persistent_sampling as ps  # noqa: E402
from blackjax_tpu_torch.smc import resampling  # noqa: E402
from tools import particle_reference as reference  # noqa: E402

N, D, N_SCHEDULE, MCMC_STEPS = 200, 3, 6, 3
SCHEDULE = np.linspace(0.25, 1.0, 4)
TOL = 1e-10


def _key(seed):
    return interop.prng_key(jax.random.key_data(jax.random.key(seed)))


def _x0():
    return 3.0 * np.random.default_rng(1).standard_normal((N, D))


def _history(slots=7, n=40, filled=4):
    """A padded history: ``filled`` slots of log likelihoods, log Z and an
    increasing schedule, zeros after."""
    rng = np.random.default_rng(2)
    logliks = np.zeros((slots, n))
    logliks[:filled] = -0.5 * rng.standard_normal((filled, n)) ** 2 * 8.0
    log_z = np.zeros(slots)
    log_z[1:filled] = -np.cumsum(rng.random(filled - 1))
    schedule = np.zeros(slots)
    schedule[:filled + 1] = np.linspace(0.0, 0.8, filled + 1)
    return logliks, log_z, schedule


@pytest.mark.parametrize("include_current, normalize", [
    (False, False), (False, True), (True, False), (True, True)])
def test_persistent_weights_match_the_reference(include_current, normalize):
    logliks, log_z, schedule = _history()
    iteration = 3 if include_current else 4
    ref_w, ref_z = jps.compute_log_persistent_weights(
        jnp.asarray(logliks), jnp.asarray(log_z), jnp.asarray(schedule), iteration,
        include_current=include_current, normalize_to_one=normalize)
    w, z = ps.compute_log_persistent_weights(
        torch.from_numpy(logliks), torch.from_numpy(log_z), torch.from_numpy(schedule), iteration,
        include_current=include_current, normalize_to_one=normalize)
    assert w.shape == logliks.shape
    assert bool(torch.isinf(w[4:]).all()) and bool(torch.isfinite(w[:4]).all())
    np.testing.assert_allclose(w[:4].numpy(), np.asarray(ref_w)[:4], rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(z), float(ref_z), rtol=0, atol=1e-12)
    for normalize_weights in (False, True):
        np.testing.assert_allclose(
            float(ps.compute_persistent_ess(w, normalize_weights)),
            float(jps.compute_persistent_ess(ref_w, normalize_weights)), rtol=1e-12)
    np.testing.assert_allclose(float(ps.compute_log_Z(w[:4], 4)),
                               float(jps.compute_log_Z(ref_w[:4], 4)), rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def runs():
    """Both samplers by the JAX package and by the port, from the same
    particles and key."""
    out = {}
    for adaptive in (False, True):
        kw = dict(adaptive=adaptive, n_schedule=N_SCHEDULE, max_steps=N_SCHEDULE,
                  mcmc_steps=MCMC_STEPS)
        ref = reference.ps_run(jnp.asarray(_x0()), jax.random.key(18), schedule=SCHEDULE, **kw)
        port = chip_smoke.ps_run(torch, torch.from_numpy(_x0()), _key(18),
                                 schedule=torch.from_numpy(SCHEDULE), **kw)
        out[adaptive] = ref, port
    return out


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b), rtol=0, atol=tol)


def assert_states_match(state, ref_state):
    assert state.iteration == int(ref_state.iteration)
    _close(state.persistent_particles, ref_state.persistent_particles)
    _close(state.persistent_log_likelihoods, ref_state.persistent_log_likelihoods)
    _close(state.persistent_log_Z, ref_state.persistent_log_Z)
    _close(state.tempering_schedule, ref_state.tempering_schedule)
    _close(state.log_Z, ref_state.log_Z)
    _close(state.particles, ref_state.particles)
    weights, ref_weights = state.persistent_weights.numpy(), np.asarray(ref_state.persistent_weights)
    np.testing.assert_allclose(weights, ref_weights, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed schedule", "adaptive"])
def test_persistent_sampling_step_by_step(runs, adaptive):
    ref_steps, steps = runs[adaptive]
    assert len(steps) == len(ref_steps)
    if adaptive:
        assert 2 <= len(steps) < N_SCHEDULE and float(steps[-1][0].tempering_param) == 1.0
    for (state, info), (ref_state, ref_info) in zip(steps, ref_steps):
        assert_states_match(state, ref_state)
        np.testing.assert_array_equal(info.ancestors.numpy(), np.asarray(ref_info.ancestors))
        np.testing.assert_array_equal(info.update_info.is_accepted.numpy(),
                                      np.asarray(ref_info.update_info.is_accepted))
        assert info.update_info.acceptance_rate.shape == (N, MCMC_STEPS)
    trimmed, ref_trimmed = ps.remove_padding(steps[-1][0]), jps.remove_padding(ref_steps[-1][0])
    for got, expected in zip(trimmed[:4], ref_trimmed[:4]):
        assert tuple(got.shape) == tuple(expected.shape)
    assert trimmed.persistent_log_Z.shape[0] == len(steps) + 1


def test_batch_size_gives_the_unbatched_numbers(runs):
    _, steps = runs[False]
    logprior_fn, loglikelihood_fn = chip_smoke.smc_target(torch, "cpu", torch.float64, D)
    algo = bj.persistent_sampling_smc(
        logprior_fn, loglikelihood_fn, N_SCHEDULE, mala.build_kernel(), mala.init,
        {"step_size": torch.full((1,), chip_smoke.SMC_STEP_SIZE, dtype=torch.float64)},
        resampling.systematic, num_mcmc_steps=MCMC_STEPS, batch_size=64)
    state = algo.init(torch.from_numpy(_x0()))
    key = _key(18)
    for lam in SCHEDULE:
        key, step_key = prng.split(key)
        state, _ = algo.step(step_key, state, torch.tensor(lam))
    _close(state.persistent_particles, steps[-1][0].persistent_particles, 1e-12)
    _close(state.log_Z, steps[-1][0].log_Z, 1e-12)


def test_a_mid_run_state_continues_as_the_reference(runs):
    ref_steps, _ = runs[True]
    ref_state = ref_steps[0][0]
    state = interop.persistent_smc_state(ref_state)
    assert isinstance(state.iteration, int) and state.iteration == 1
    assert_states_match(state, ref_state)
    step_key = jax.random.key(40)
    logprior_fn, loglikelihood_fn = reference.target(D)
    ref_algo = blackjax_tpu.adaptive_persistent_sampling_smc(
        logprior_fn, loglikelihood_fn, N_SCHEDULE, jmala.build_kernel(), jmala.init,
        extend_params({"step_size": jnp.asarray(chip_smoke.SMC_STEP_SIZE)}),
        jresampling.systematic, target_ess=chip_smoke.SMC_TARGET_ESS,
        num_mcmc_steps=MCMC_STEPS)
    ref_next, _ = reference.opt0(ref_algo.step)(step_key, ref_state)
    p_logprior, p_loglik = chip_smoke.smc_target(torch, "cpu", torch.float64, D)
    algo = bj.adaptive_persistent_sampling_smc(
        p_logprior, p_loglik, N_SCHEDULE, mala.build_kernel(), mala.init,
        {"step_size": torch.full((1,), chip_smoke.SMC_STEP_SIZE, dtype=torch.float64)},
        resampling.systematic, target_ess=chip_smoke.SMC_TARGET_ESS,
        num_mcmc_steps=MCMC_STEPS)
    nxt, _ = algo.step(interop.prng_key(jax.random.key_data(step_key)), state)
    assert_states_match(nxt, ref_next)
