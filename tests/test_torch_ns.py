"""The port's nested sampling (``blackjax_tpu_torch.ns``, the registry's
``nss`` and ``nsswig``) against the JAX package, in float64, on the same
keys (``interop.prng_key``).

- ``delete_fn`` breaks ties as ``lax.top_k`` does, the lower index first.
- ``compute_num_live`` on NaN births and ties, ``log1mexp`` on both of its
  branches and at its clamp.
- ``nss`` and ``nsswig`` on the tracked SMC target at d = 3 (300 live
  points, 32 deletions a step, 4 inner steps), step by step from the same
  live points (``tools/particle_reference.ns_run`` and
  ``chip_smoke.ns_run``): the dead indices, the start indices drawn by
  ``choice`` (each package's, read where its inner update draws them) and
  ``num_shrink`` identical; positions, log-likelihoods,
  births and the integrator within 1e-10.
- ``ns.utils`` on the finalised run: ``logX``, ``log_weights``, ``ess`` and
  ``sample`` (identical indices), and ``uniform_prior``.
- ``interop.ns_state`` carries the reference's mid-run state into the port,
  which continues it as the reference does.

The JAX side is compiled once per function, at XLA's optimization level 0.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu_torch as bj  # noqa: E402
import chip_smoke  # noqa: E402
from blackjax_tpu.ns import base as jbase  # noqa: E402
from blackjax_tpu.ns import from_mcmc as jfrom_mcmc  # noqa: E402
from blackjax_tpu.ns import integrator as jintegrator  # noqa: E402
from blackjax_tpu.ns import utils as jutils  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.ns import base, integrator, utils  # noqa: E402
from tools import particle_reference as reference  # noqa: E402

N, D, DELETE, INNER, STEPS = 300, 3, 32, 4, 4
TOL = 1e-10


def _key(seed):
    return interop.prng_key(jax.random.key_data(jax.random.key(seed)))


def _x0():
    return 3.0 * np.random.default_rng(1).standard_normal((N, D))


def _ns_state(loglikelihood):
    loglikelihood = torch.as_tensor(loglikelihood)
    return base.NSState(base.StateWithLogLikelihood(
        torch.zeros(loglikelihood.shape + (1,)), torch.zeros_like(loglikelihood),
        loglikelihood, torch.full_like(loglikelihood, math.nan)))


def test_delete_fn_breaks_ties_as_top_k():
    loglik = np.array([1.0, 0.0, 0.0, 2.0, 0.0, -1.0, 0.0, -1.0, 3.0, 0.0])
    for k in (1, 2, 3, 4, 6):
        _, expected = jax.lax.top_k(-jnp.asarray(loglik), k)
        dead, target = base.delete_fn(_ns_state(loglik), k)
        np.testing.assert_array_equal(dead.numpy(), np.asarray(expected))
        assert torch.equal(dead, target)


def test_compute_num_live_on_nan_births_and_ties():
    rng = np.random.default_rng(3)
    death = np.round(rng.standard_normal(40), 1)  # rounded: ties among the deaths
    birth = np.where(rng.random(40) < 0.3, np.nan, death - np.abs(np.round(
        rng.standard_normal(40), 1)))
    birth[5] = death[9]  # a birth tied with a death
    particles = jbase.StateWithLogLikelihood(
        jnp.zeros((40, 1)), jnp.zeros(40), jnp.asarray(death), jnp.asarray(birth))
    expected = jutils.compute_num_live(jbase.NSInfo(particles, None))
    got = utils.compute_num_live(base.NSInfo(base.StateWithLogLikelihood(
        torch.zeros(40, 1), torch.zeros(40), torch.from_numpy(death), torch.from_numpy(birth)),
        None))
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_log1mexp_follows_the_reference(dtype):
    x = np.concatenate([-np.logspace(-9, 2, 60), [0.0, -0.6931472, -0.69314718]]).astype(dtype)
    expected = np.asarray(jintegrator.log1mexp(jnp.asarray(x)))
    got = integrator.log1mexp(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    # XLA's CPU backend flushes float32 subnormals to zero (log1mexp(-100))
    rtol, atol = (1e-6, np.finfo(np.float32).tiny) if dtype == "float32" else (1e-13, 0)
    np.testing.assert_allclose(got.numpy(), expected, rtol=rtol, atol=atol)


class _RecordedChoice:
    """``jax.random`` for the reference's ``ns.from_mcmc``, whose ``choice``
    draws also go to ``drawn`` (by ``jax.debug.callback``, so under ``jit``
    too): the start indices where the reference's inner update draws them."""

    def __init__(self, drawn):
        self.drawn = drawn

    def __getattr__(self, name):
        return getattr(jax.random, name)

    def choice(self, *args, **kwargs):
        out = jax.random.choice(*args, **kwargs)
        jax.debug.callback(lambda idx: self.drawn.append(np.asarray(idx)), out)
        return out


@pytest.fixture(scope="module")
def runs():
    """``nss`` and ``nsswig`` by the JAX package and by the port from the
    same live points and key; under ``"starts"``, each variant's start
    indices as each package drew them."""
    out = {"starts": {}}
    for variant in ("nss", "nsswig"):
        ref_starts = []
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jfrom_mcmc, "random", _RecordedChoice(ref_starts))
            ref = reference.ns_run(jnp.asarray(_x0()), jax.random.key(18), variant, DELETE,
                                   INNER, STEPS, stop=None)
            jax.effects_barrier()
        with chip_smoke.recorded_choices() as starts:
            port = chip_smoke.ns_run(torch, torch.from_numpy(_x0()), _key(18), variant, DELETE,
                                     INNER, STEPS, stop=None)
        out[variant] = ref, port
        out["starts"][variant] = ref_starts, starts
    return out


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, dtype=np.float64), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize("variant", ["nss", "nsswig"])
def test_ns_steps_match_the_reference(runs, variant):
    (_, ref_steps), (_, steps) = runs[variant]
    ref_starts, starts = runs["starts"][variant]
    assert len(steps) == len(ref_steps) == len(starts) == len(ref_starts) == STEPS
    ref_prev = reference.ns_algorithm(D, variant, DELETE, INNER).init(jnp.asarray(_x0()))
    prev = chip_smoke.ns_run(torch, torch.from_numpy(_x0()), _key(18), variant, DELETE, INNER,
                             0, stop=None)[0]
    for (ref_state, ref_info), (state, info), ref_start, start in zip(
            ref_steps, steps, ref_starts, starts):
        ref_dead, _ = jbase.delete_fn(ref_prev, DELETE)
        dead, _ = base.delete_fn(prev, DELETE)
        np.testing.assert_array_equal(dead.numpy(), np.asarray(ref_dead))
        assert start.shape == (DELETE,)
        np.testing.assert_array_equal(start.numpy(), ref_start)
        np.testing.assert_array_equal(info.update_info.num_shrink.numpy(),
                                      np.asarray(ref_info.update_info.num_shrink))
        np.testing.assert_array_equal(info.update_info.num_expansions.numpy(),
                                      np.asarray(ref_info.update_info.num_expansions))
        assert info.update_info.num_shrink.shape == (DELETE, INNER)
        for field in ("position", "logdensity", "loglikelihood", "loglikelihood_birth"):
            _close(getattr(info.particles, field), getattr(ref_info.particles, field))
            _close(getattr(state.particles, field), getattr(ref_state.particles, field))
        for field in ("logX", "logZ", "logZ_live"):
            _close(getattr(state.integrator, field), getattr(ref_state.integrator, field))
        for name, value in state.inner_kernel_params.items():
            _close(value, ref_state.inner_kernel_params[name])
        ref_prev, prev = ref_state, state


def _finalised(runs, variant):
    (ref_state, ref_steps), (state, steps) = runs[variant]
    return (jutils.finalise(ref_state, [i for _, i in ref_steps]),
            utils.finalise(state, [i for _, i in steps]))


def test_utils_on_the_finalised_run(runs):
    ref_dead, dead = _finalised(runs, "nss")
    assert dead.particles.position.shape == (N + STEPS * DELETE, D)
    assert dead.update_info.num_shrink.shape == (STEPS * DELETE, INNER)
    np.testing.assert_array_equal(utils.compute_num_live(dead).numpy(),
                                  np.asarray(jutils.compute_num_live(ref_dead)))

    def reference_utils(key, ref_dead):
        order = jnp.argsort(ref_dead.particles.loglikelihood)
        sorted_info = jbase.NSInfo(jax.tree.map(lambda x: x[order], ref_dead.particles), None)
        return (jutils.logX(key, sorted_info, 16), jutils.log_weights(key, ref_dead, 16),
                jutils.ess(key, ref_dead), jutils.sample(key, ref_dead, 500))

    # eager: compute_num_live's boolean mask has no static shape
    ref_logx, ref_logw, ref_ess, ref_draws = reference_utils(
        jax.random.key(7), jbase.NSInfo(ref_dead.particles, None))
    order = torch.argsort(dead.particles.loglikelihood, stable=True)
    sorted_port = base.NSInfo(base.StateWithLogLikelihood(
        *(x[order] for x in dead.particles)), None)
    for ref_out, out in zip(ref_logx, utils.logX(_key(7), sorted_port, 16)):
        _close(out, ref_out)
    _close(utils.log_weights(_key(7), dead, 16), ref_logw)
    np.testing.assert_allclose(float(utils.ess(_key(7), dead)), float(ref_ess), rtol=1e-10)
    draws = utils.sample(_key(7), dead, 500)
    _close(draws.position, ref_draws.position)
    _close(draws.loglikelihood, ref_draws.loglikelihood)
    row = utils.get_first_row(dead.particles)
    _close(row.position, jutils.get_first_row(ref_dead.particles).position)


def test_summary_of_a_run(runs):
    (ref_state, ref_steps), (state, steps) = runs["nss"]
    s = chip_smoke.ns_summary(torch, state, steps, _key(9), 400)
    ref_s = reference.ns_summary(ref_state, ref_steps, jax.random.key(9), 400)
    np.testing.assert_allclose(s["log_z"], ref_s["log_z"], rtol=0, atol=TOL)
    _close(s["mean"], ref_s["mean"])
    _close(s["var"], ref_s["var"])
    np.testing.assert_allclose(s["ess"], ref_s["ess"], rtol=1e-10)


def test_uniform_prior_matches_the_reference():
    bounds = {"a": (-1.0, 2.0), "b": (np.zeros(2), np.array([1.0, 3.0]))}
    ref_particles, ref_logprior = jutils.uniform_prior(jax.random.key(4), 50, bounds)
    particles, logprior = utils.uniform_prior(_key(4), 50, bounds, torch.float64)
    for name in bounds:
        np.testing.assert_array_equal(particles[name].numpy(), np.asarray(ref_particles[name]))
    inside = {"a": torch.tensor([0.5, 3.0]), "b": torch.tensor([[0.5, 1.0], [0.5, 1.0]])}
    expected = [float(ref_logprior({k: jnp.asarray(v[i].numpy()) for k, v in inside.items()}))
                for i in range(2)]
    np.testing.assert_array_equal(logprior(inside).numpy(), np.array(expected))


def test_a_mid_run_state_continues_as_the_reference(runs):
    """The reference's state after two steps, carried into the port by
    ``interop.ns_state``, takes the reference's third step."""
    (_, ref_steps), _ = runs["nss"]
    ref_state, ref_info = ref_steps[1]
    state = interop.ns_state(ref_state)
    info = interop.ns_info(ref_info)
    assert type(state).__name__ == "AdaptiveNSState"
    assert type(info.update_info).__name__ == "SliceInfo"
    _close(info.particles.position, ref_info.particles.position, 0)
    algo = reference.ns_algorithm(D, "nss", DELETE, INNER)
    step_key = jax.random.key(30)
    ref_next, _ = reference.opt0(algo.step)(step_key, ref_state)
    logprior_fn, loglikelihood_fn = chip_smoke.smc_target(torch, "cpu", torch.float64, D)
    port = bj.nss(logprior_fn, loglikelihood_fn, num_inner_steps=INNER, num_delete=DELETE)
    nxt, _ = port.step(interop.prng_key(jax.random.key_data(step_key)), state)
    _close(nxt.particles.position, ref_next.particles.position)
    _close(nxt.integrator.logZ, ref_next.integrator.logZ)
