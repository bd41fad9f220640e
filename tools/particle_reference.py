"""The JAX package's own runs of ``chip_smoke.py``'s phase 19 on the CPU.

Phase 19 drives the port's persistent-sampling SMC, pretuning and nested
slice sampling on the tracked SMC target (``benchmarks/tracked.py:566-624``,
phase 16's: d = 10, prior N(0, 9 I), likelihood N(obs, I), obs =
linspace(-1, 1, 10), the starting particles or live points 3 N(0, I) of
numpy seed 1) and gates each sampler's log Z against the exact value and
its posterior means against 0.9 obs. Each gate is about three times the
worst error of the JAX package's own runs of the same configuration; this
script makes those runs, in f32 as phase 19 runs, on keys 18 to 22 (three
keys for the nested samplers), and prints one JSON object with each run's
errors and step counts, from which ``chip_smoke.PARTICLE_REFERENCE`` and
the gates are written.

The run functions here are also the reference side of
``tests/test_torch_persistent_sampling.py``, ``tests/test_torch_pretuning.py``
and ``tests/test_torch_ns.py``, which run them at small sizes in f64 and
hold the port's runs (``chip_smoke.ps_run``, ``pretune_run``, ``ns_run``)
against them step by step on the same keys.

Usage, from the root of the repository (about ten minutes on a few CPU
cores)::

    python tools/particle_reference.py [--samplers NAME ...] [--keys K]
"""
import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import blackjax_tpu  # noqa: E402
from blackjax_tpu.mcmc import mala  # noqa: E402
from blackjax_tpu.ns import utils as ns_utils  # noqa: E402
from blackjax_tpu.smc import resampling  # noqa: E402
from blackjax_tpu.smc.base import extend_params  # noqa: E402
from blackjax_tpu.smc.pretuning import build_pretune, esjd  # noqa: E402

# phase 19's settings (chip_smoke.py holds the same numbers)
D, N = 10, 16384
OBS = np.linspace(-1.0, 1.0, D)
LOG_Z = -0.5 * D * np.log(10.0) - float((OBS**2).sum()) / 20.0
STEP_SIZE, TARGET_ESS, MCMC_STEPS, N_SCHEDULE = 0.1, 0.5, 5, 50
PRETUNE_SCHEDULE = (0.05, 1.0, 20)  # linspace(0.05, 1, 20)
PRETUNE_SIGMA, PRETUNE_ALPHA = 0.05, 1.0
NS_DELETE, NS_INNER, NS_MAX_STEPS, NS_STOP = 2048, 20, 400, -3.0
SWIG_INNER = 1  # nsswig: cut from 20 inner steps (chip_smoke.SWIG_INNER)
NS_SAMPLES = 16384


def opt0(fn, **kwargs):
    """``jax.jit`` at XLA's optimization level 0 (half the compile time)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0}, **kwargs)


def initial(n, dtype=np.float32):
    """The starting particles: 3 N(0, I) of numpy seed 1, the first ``n``
    of N rows (``chip_smoke.smc_init``)."""
    return jnp.asarray((3.0 * np.random.default_rng(1).standard_normal((N, D))[:n]).astype(dtype))


def target(d=D):
    obs = jnp.asarray(OBS[:d]) if d == D else jnp.asarray(np.linspace(-1.0, 1.0, d))

    def logprior_fn(x):
        return -0.5 * jnp.sum(x**2) / 9.0

    def loglikelihood_fn(x):
        return -0.5 * jnp.sum((x - obs) ** 2)

    return logprior_fn, loglikelihood_fn


def ps_run(x0, key, adaptive=True, schedule=None, n_schedule=N_SCHEDULE,
           mcmc_steps=MCMC_STEPS, max_steps=N_SCHEDULE, jit=opt0):
    """Persistent-sampling SMC with MALA moves from ``x0``: adaptive to
    lambda = 1 (``target_ess`` 0.5) or along ``schedule``, the loop splitting
    its key into the next key and the step's key. Each step's ``(state,
    info)``."""
    logprior_fn, loglikelihood_fn = target(x0.shape[1])
    params = extend_params({"step_size": jnp.asarray(STEP_SIZE, x0.dtype)})
    common = (logprior_fn, loglikelihood_fn, n_schedule, mala.build_kernel(), mala.init,
              params, resampling.systematic)
    if adaptive:
        algo = blackjax_tpu.adaptive_persistent_sampling_smc(
            *common, target_ess=TARGET_ESS, num_mcmc_steps=mcmc_steps)
    else:
        algo = blackjax_tpu.persistent_sampling_smc(*common, num_mcmc_steps=mcmc_steps)
    step = jit(algo.step)
    state, steps = algo.init(x0), []
    for i in range(max_steps if adaptive else len(schedule)):
        if adaptive and float(state.tempering_param) >= 1.0:
            break
        key, step_key = jax.random.split(key)
        state, info = step(step_key, state) if adaptive else step(step_key, state, schedule[i])
        steps.append((state, info))
    return steps


def pretune_run(x0, key, schedule, mcmc_steps=MCMC_STEPS, jit=opt0):
    """``pretuning`` over ``tempered_smc`` with MALA moves whose step size is
    a per-particle parameter (initially STEP_SIZE), along ``schedule``: the
    ESJD in the identity metric, ``sigma_parameters={"step_size":
    PRETUNE_SIGMA}``, ``alpha=PRETUNE_ALPHA``, the step size kept positive.
    Each step's ``(state, info)``."""
    n, d = x0.shape
    logprior_fn, loglikelihood_fn = target(d)
    eye = jnp.eye(d, dtype=x0.dtype)
    pretune = build_pretune(
        mala.init, mala.build_kernel(), alpha=PRETUNE_ALPHA,
        sigma_parameters={"step_size": jnp.asarray(PRETUNE_SIGMA, x0.dtype)}, n_particles=n,
        performance_of_chain_measure_factory=lambda state: esjd(eye),
        positive_parameters=["step_size"])
    algo = blackjax_tpu.pretuning(
        blackjax_tpu.tempered_smc, logprior_fn, loglikelihood_fn, mala.build_kernel(),
        mala.init, resampling.systematic, num_mcmc_steps=mcmc_steps,
        initial_parameter_value={"step_size": jnp.full((n,), STEP_SIZE, x0.dtype)},
        pretune_fn=pretune)
    step = jit(algo.step)
    state, steps = algo.init(x0), []
    for lam in schedule:
        key, step_key = jax.random.split(key)
        state, info = step(step_key, state, tempering_param=lam)
        steps.append((state, info))
    return steps


def ns_algorithm(d, variant, num_delete, num_inner_steps):
    logprior_fn, loglikelihood_fn = target(d)
    build = blackjax_tpu.nss if variant == "nss" else blackjax_tpu.nsswig
    return build(logprior_fn, loglikelihood_fn, num_inner_steps=num_inner_steps,
                 num_delete=num_delete)


def ns_run(x0, key, variant="nss", num_delete=NS_DELETE, num_inner_steps=NS_INNER,
           max_steps=NS_MAX_STEPS, stop=NS_STOP, jit=opt0):
    """Nested slice sampling (``nss`` or ``nsswig``) from the live points
    ``x0`` until ``logZ_live - logZ < stop`` or ``max_steps`` steps (``stop``
    None: all of them), the loop splitting its key as the SMC loops do.
    Returns the final state and each step's ``(state, info)``."""
    algo = ns_algorithm(x0.shape[1], variant, num_delete, num_inner_steps)
    step = jit(algo.step)
    state, steps = algo.init(x0), []
    while len(steps) < max_steps:
        integ = state.integrator
        if stop is not None and float(integ.logZ_live - integ.logZ) < stop:
            break
        key, step_key = jax.random.split(key)
        state, info = step(step_key, state)
        steps.append((state, info))
    return state, steps


def ns_summary(state, steps, key, samples=NS_SAMPLES):
    """log Z (the dead points' evidence with the live points' remainder),
    the posterior mean and variance of ``samples`` draws of
    ``ns.utils.sample`` on ``key``, and the Kish ESS."""
    dead = ns_utils.finalise(state, [info for _, info in steps], update_info=False)
    draws = np.asarray(ns_utils.sample(key, dead, samples).position, dtype=np.float64)
    integ = state.integrator
    return {"log_z": float(jnp.logaddexp(integ.logZ, integ.logZ_live)),
            "mean": draws.mean(0), "var": draws.var(0),
            "ess": float(ns_utils.ess(key, dead))}


def _errors(log_z, mean, var, steps):
    return {"log_z_err": float(log_z - LOG_Z),
            "mean_err": float(np.abs(np.asarray(mean) - 0.9 * OBS).max()),
            "var_min": float(np.min(var)), "var_max": float(np.max(var)), "steps": steps}


def reference(sampler, seed):
    """One run of ``sampler`` at phase 19's settings on key ``seed``."""
    key = jax.random.key(seed)
    if sampler in ("adaptive_persistent_sampling_smc", "persistent_sampling_smc"):
        steps = ps_run(initial(N), key)
        state = steps[-1][0]
        x = np.asarray(state.particles, dtype=np.float64)
        return _errors(float(state.log_Z), x.mean(0), x.var(0), len(steps))
    if sampler == "pretuning":
        steps = pretune_run(initial(N), key, np.linspace(*PRETUNE_SCHEDULE).astype(np.float32))
        state = steps[-1][0].sampler_state
        w = np.asarray(state.weights, dtype=np.float64)
        x = np.asarray(state.particles, dtype=np.float64)
        mean = (w[:, None] * x).sum(0)
        var = (w[:, None] * (x - mean) ** 2).sum(0)
        log_z = float(sum(float(info.log_likelihood_increment) for _, info in steps))
        out = _errors(log_z, mean, var, len(steps))
        out["step_size_mean"] = float(jnp.mean(steps[-1][0].parameter_override["step_size"]))
        return out
    state, steps = ns_run(initial(N), key, sampler,
                          num_inner_steps=SWIG_INNER if sampler == "nsswig" else NS_INNER)
    s = ns_summary(state, steps, jax.random.key(seed + 100))
    out = _errors(s["log_z"], s["mean"], s["var"], len(steps))
    out["ess"] = s["ess"]
    return out


SAMPLERS = ("adaptive_persistent_sampling_smc", "pretuning", "nss", "nsswig")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--samplers", nargs="*", default=list(SAMPLERS))
    parser.add_argument("--keys", type=int, default=5)
    args = parser.parse_args()
    out = {}
    for sampler in args.samplers:
        keys = args.keys if sampler.startswith(("adaptive", "pretuning")) else min(args.keys, 3)
        runs = []
        for seed in range(18, 18 + keys):
            t0 = time.perf_counter()
            runs.append(reference(sampler, seed))
            print(f"{sampler} key {seed}: {runs[-1]} ({time.perf_counter() - t0:.1f} s)",
                  file=sys.stderr, flush=True)
        out[sampler] = {
            "runs": runs,
            "worst_log_z_err": max(abs(r["log_z_err"]) for r in runs),
            "worst_mean_err": max(r["mean_err"] for r in runs),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
