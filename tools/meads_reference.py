"""The JAX package's own run of ``chip_smoke.py``'s phase 21 on the CPU.

Phase 21 drives the port's MEADS warmup on the tracked MEADS configuration
(``benchmarks/tracked.py:859-893``, ``config_meads``):
``ill_conditioned_gaussian(100)``, 4,096 chains from ``normal(key(29),
(4096, 100))``, ``meads_adaptation`` with its defaults (4 folds, step-size
multiplier 0.5, damping slowdown 1.0), 1,000 steps, in float32, on the three
keys of ``split(key(29), 3)``, the configuration's timed variants. It gates
its results on bands around the JAX package's values at those keys, which
this script computes, in float32 (JAX without x64, as the configuration
runs), and prints as one JSON object:

- the final ``step_size``, ``alpha`` and ``delta``;
- the smallest and the largest ratio of the final positions' variances
  (over the chains, ``ddof = 1``) to the target's, and of the returned
  ``momentum_inverse_scale`` to the target's standard deviations.

For each, the value at each key and the band ``(mean, half width)``, the
half width three times the values' spread (largest minus smallest) or 5 % of
the mean, whichever is wider. ``RECORDED`` below is its output, which
``chip_smoke.MEADS_REFERENCE`` holds (``tests/test_torch_meads.py`` checks
that the two agree); rerun it whenever a phase-21 setting changes.

Usage, from the root of the repository (about 70 s on 8 CPU cores;
``--chains`` and ``--steps`` cut it)::

    python tools/meads_reference.py [--chains C] [--steps S]
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

NUM_CHAINS, NUM_STEPS, DIM, SEED, NUM_KEYS = 4096, 1000, 100, 29, 3
BAND_SPREADS, BAND_FLOOR = 3.0, 0.05
NAMES = ("step_size", "alpha", "delta", "var_ratio_min", "var_ratio_max",
         "scale_ratio_min", "scale_ratio_max")

# this script's output at the configuration's size
RECORDED = {
    "step_size": [0.4987325370311737, 0.49911758303642273, 0.4990108013153076],
    "alpha": [0.6317616701126099, 0.6315629482269287, 0.6314523220062256],
    "delta": [0.31588083505630493, 0.31578147411346436, 0.3157261610031128],
    "var_ratio_min": [0.9341207551406765, 0.9388755118670533, 0.934205740380608],
    "var_ratio_max": [1.066119892815443, 1.0702652094013043, 1.0536788376433717],
    "scale_ratio_min": [0.9722920728234428, 0.9719137781385062, 0.9741106664499595],
    "scale_ratio_max": [1.0224200858151125, 1.0311541354981222, 1.0265048686518121],
    "step_size_band": (0.498953640460968, 0.024947682023048402),
    "alpha_band": (0.631592313448588, 0.0315796156724294),
    "delta_band": (0.315796156724294, 0.0157898078362147),
    "var_ratio_min_band": (0.9357340024627793, 0.046786700123138965),
    "var_ratio_max_band": (1.0633546466200396, 0.053167732331001985),
    "scale_ratio_min_band": (0.9727721724706361, 0.04863860862353181),
    "scale_ratio_max_band": (1.0266930299883488, 0.05133465149941744),
}


def band(values):
    """``(mean, half width)``: three times the spread or 5 % of the mean,
    whichever is wider."""
    mean = sum(values) / len(values)
    return mean, max(BAND_SPREADS * (max(values) - min(values)), BAND_FLOOR * abs(mean))


def summary(step_size, alpha, delta, positions, scale, std):
    """The gated statistics of one run from its final parameters, its final
    ``(C, d)`` positions and its momentum scale, all numpy, against the
    target's standard deviations ``std``."""
    var_ratio = positions.var(axis=0, ddof=1) / std**2
    scale_ratio = scale / std
    return {"step_size": float(step_size), "alpha": float(alpha), "delta": float(delta),
            "var_ratio_min": float(var_ratio.min()), "var_ratio_max": float(var_ratio.max()),
            "scale_ratio_min": float(scale_ratio.min()),
            "scale_ratio_max": float(scale_ratio.max())}


def run(key, num_chains=NUM_CHAINS, num_steps=NUM_STEPS):
    """One warmup at ``key`` from the configuration's positions: its
    summary."""
    import jax
    import numpy as np

    from blackjax_tpu.adaptation.meads_adaptation import meads_adaptation
    from blackjax_tpu.models.targets import ill_conditioned_gaussian

    target = ill_conditioned_gaussian(DIM)
    positions = jax.random.normal(jax.random.key(SEED), (num_chains, DIM))
    warmup = meads_adaptation(target.logdensity_fn, num_chains)

    @jax.jit
    def one(key, positions):
        (states, params), _ = warmup.run(key, positions, num_steps)
        return (params["step_size"], params["alpha"], params["delta"], states.position,
                params["momentum_inverse_scale"])

    step_size, alpha, delta, x, scale = one(key, positions)
    return summary(step_size, alpha, delta, np.asarray(x, np.float64),
                   np.asarray(scale, np.float64), np.asarray(target.std, np.float64))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chains", type=int, default=NUM_CHAINS)
    parser.add_argument("--steps", type=int, default=NUM_STEPS)
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    out = {name: [] for name in NAMES}
    for key in jax.random.split(jax.random.key(SEED), NUM_KEYS):
        for name, value in run(key, args.chains, args.steps).items():
            out[name].append(value)
    for name in NAMES:
        out[f"{name}_band"] = band(out[name])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
