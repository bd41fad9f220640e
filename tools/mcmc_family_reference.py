"""The JAX package's own run of ``chip_smoke.py``'s phase 17 on the CPU.

Phase 17 drives the port's MCMC family on the tracked static-HMC
configuration (``benchmarks/tracked.py:112-163``) and gates each sampler's
mean acceptance (elliptical slice: mean ``subiter``; the slice samplers:
mean ``num_shrink``) on a band around the JAX package's value at the same
settings, keys and transitions. This script computes those values: it builds
the same samplers through ``chip_smoke.family_algorithms`` with
``blackjax_tpu`` (in f32, as the configuration runs), draws each transition's keys as phase 17 does, runs the
transitions jitted and vmapped over the chains, and prints one JSON object,
name -> mean, that ``chip_smoke.FAM_REFERENCE`` holds (``orbital_hmc``
has no such statistic and is left out).

Usage, from the root of the repository::

    python tools/mcmc_family_reference.py [name ...]
"""
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # f32, JAX's default, as the configuration runs

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import blackjax_tpu  # noqa: E402
import chip_smoke as cs  # noqa: E402


def run(name, dtype):
    algorithms = cs.family_algorithms(
        blackjax_tpu, lambda v: jnp.asarray(np.asarray(v), dtype),
        lambda key, shape: jax.random.normal(key, shape, dtype), cs.FAM_D)
    algo, keyed_init = algorithms[name]
    x0 = jnp.asarray(0.5 * np.random.default_rng(cs.FAM_X0_SEED).standard_normal(
        (cs.FAM_CHAINS, cs.FAM_D)), dtype)
    init_keys = jax.random.split(jax.random.key(9), cs.FAM_CHAINS)
    state = jax.vmap(algo.init)(x0, init_keys) if keyed_init else jax.vmap(algo.init)(x0)
    n = cs.FAM_TRANSITIONS[name]
    run_key = jax.random.split(jax.random.key(8), 4)[0]
    step_keys = jax.random.split(run_key, cs.FAM_TRACKED_TRANSITIONS)[:n]

    @jax.jit
    def sweep(state, step_keys):
        def one(state, k):
            state, info = jax.vmap(algo.step)(jax.random.split(k, cs.FAM_CHAINS), state)
            stat, _ = cs.family_statistic(name, info)
            return state, jnp.mean(jnp.asarray(stat, jnp.float32))

        return jax.lax.scan(one, state, step_keys)

    _, stats = sweep(state, step_keys)
    return float(jnp.mean(stats))


def main(names) -> int:
    out = {}
    for name in names:
        t0 = time.perf_counter()
        out[name] = run(name, jnp.float32)
        print(f"{name}: {out[name]:.6f} ({time.perf_counter() - t0:.1f} s)", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [n for n in cs.FAM_TRANSITIONS if n != "orbital_hmc"]))
