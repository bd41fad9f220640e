"""The JAX package's own run of ``chip_smoke.py``'s phase 20 on the CPU.

Phase 20 drives the port's ChEES warmup on the tracked cross-chain
configuration (``benchmarks/tracked.py:744-788``, ``config_cross_chain``):
``ill_conditioned_gaussian(100)``, 4,096 chains from ``normal(key(19),
(4096, 100))``, step size 0.05, ``adam(0.25)``, 1,000 steps and the
defaults, in float32. It gates the final ``step_size`` and
``integration_steps_params`` on bands around the JAX package's values over
the four keys of ``split(key(19), 4)``, the configuration's timed variants.
This script computes them, in float32 (JAX without x64, as the
configuration runs) and prints one JSON object: for each parameter, its
value at each key, their mean, and the band's half width, three times the
values' spread (largest minus smallest) or 5 % of the mean, whichever is
wider. ``RECORDED`` below is its output, which ``chip_smoke.CHEES_REFERENCE``
holds (``tests/test_torch_chees.py`` checks that the two agree); rerun it
whenever a phase-20 setting changes.

Usage, from the root of the repository (a few minutes on a few CPU
cores)::

    python tools/chees_reference.py [--chains C] [--steps S]
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

NUM_CHAINS, NUM_STEPS, DIM = 4096, 1000, 100
STEP_SIZE, LEARNING_RATE, SEED = 0.05, 0.25, 19
BAND_SPREADS, BAND_FLOOR = 3.0, 0.05

# this script's output at the configuration's size
RECORDED = {
    "step_size": [0.2998984456062317, 0.30003035068511963, 0.2993123233318329, 0.29932332038879395],
    "integration_steps_params": [18.968795776367188, 19.112064361572266, 19.26085090637207, 19.164976119995117],
    "leapfrog_grads": [40542208, 40689664, 40816640, 40620032],
    "step_size_band": (0.29964111000299454, 0.014982055500149728),
    "integration_steps_params_band": (19.12667179107666, 0.9563335895538331),
}


def band(values):
    """``(mean, half width)``: three times the spread or 5 % of the mean,
    whichever is wider."""
    mean = sum(values) / len(values)
    return mean, max(BAND_SPREADS * (max(values) - min(values)), BAND_FLOOR * abs(mean))


def run(key, num_chains=NUM_CHAINS, num_steps=NUM_STEPS):
    """One warmup at ``key`` from the configuration's positions: the final
    step size, the integration-steps parameter and the leapfrog count."""
    import jax
    import jax.numpy as jnp
    import optax

    from blackjax_tpu.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu.adaptation.chees_adaptation import chees_adaptation
    from blackjax_tpu.models.targets import ill_conditioned_gaussian

    target = ill_conditioned_gaussian(DIM)
    positions = jax.random.normal(jax.random.key(SEED), (num_chains, DIM))
    # only the leapfrog counts are kept (the parameters do not depend on it)
    warmup = chees_adaptation(
        target.logdensity_fn, num_chains,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}))

    @jax.jit
    def one(key):
        (_, params), info = warmup.run(key, positions, STEP_SIZE, optax.adam(LEARNING_RATE),
                                       num_steps)
        return (params["step_size"], params["integration_steps_params"][0],
                jnp.sum(info.info.num_integration_steps))

    step_size, steps_param, grads = one(key)
    return float(step_size), float(steps_param), int(grads)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chains", type=int, default=NUM_CHAINS)
    parser.add_argument("--steps", type=int, default=NUM_STEPS)
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {"step_size": [], "integration_steps_params": [], "leapfrog_grads": []}
    for key in jax.random.split(jax.random.key(SEED), 4):
        step_size, steps_param, grads = run(key, args.chains, args.steps)
        out["step_size"].append(step_size)
        out["integration_steps_params"].append(steps_param)
        out["leapfrog_grads"].append(grads)
    for name in ("step_size", "integration_steps_params"):
        out[f"{name}_band"] = band(out[name])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
