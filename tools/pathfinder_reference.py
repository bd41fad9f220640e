"""The JAX package's own run of ``chip_smoke.py``'s phase 22 on the CPU.

Phase 22 drives the port's Pathfinder warmup on config #5's target and
start (``benchmarks/tracked.py:744-788``): ``pathfinder_adaptation(hmc,
ill_conditioned_gaussian(100).logdensity_fn, num_chains=4096,
num_integration_steps=20)`` from row 0 of ``normal(key(19), (4096, 100))``,
400 steps, float32, on the three keys of ``split(key(23), 3)``. It gates its
results on bands around the JAX package's values at those keys, which this
script computes in float32 (JAX without x64) and prints as one JSON object:

- the smallest and the largest ratio of the adapted inverse mass matrix's
  diagonal to the target's variances, and its off-diagonal mass
  ``||M - diag(M)||_F / ||M||_F``;
- the median, the smallest and the largest per-chain step size;
- the smallest and the largest ratio of the final positions' variances
  (over the chains, ``ddof = 1``) to the target's;
- Pareto k-hat of the pooled draws (reported, not gated).

The JAX package's Pathfinder materialises every iterate's draws of every
path at once (``(paths, 31, 200, 100)`` floats: 10 GB at 4,096 paths), so
the script runs at 1,024 chains (and paths), the bands' size, and at 256,
which shows how each quantity drifts with the number of chains. For each
quantity, the value at each key and the band ``(mean, half width)`` at
1,024: the half width three times the values' spread (largest minus
smallest), 5 % of the mean, or the drift of the mean from 256 to 1,024
chains, whichever is widest. A quantity of the form ``a + b / sqrt(C)``
drifts from 1,024 to 4,096 chains half as far as from 256 to 1,024, so the
drift covers the step to 4,096. The final variances' ratios are the
exception: their distance from 1 is sampling noise of ``C`` chains,
``sqrt(2 / (C - 1))`` a coordinate, so their band is scaled to 4,096
chains about 1, centre and half width halved (``scaled_to``).
``RECORDED`` below is its output, which ``chip_smoke.PATHFINDER_REFERENCE``
holds, and ``RECORDED_100`` its output with ``--steps 100``, the bands of
phase 22's keys 1 and 2, which run 100 steps
(``chip_smoke.PATHFINDER_REFERENCE_CHEAP``); rerun it whenever a phase-22
setting changes.

Usage, from the root of the repository (about ten minutes on 8 CPU cores a
number of steps)::

    python tools/pathfinder_reference.py [--chains C ...] [--steps S]
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

NUM_CHAINS, NUM_STEPS, DIM, START_SEED, KEY_SEED, NUM_KEYS = 1024, 400, 100, 19, 23, 3
CONFIG_CHAINS = 4096  # the configuration's chains, which phase 22 runs
DRIFT_CHAINS = 256
NUM_INTEGRATION_STEPS = 20
BAND_SPREADS, BAND_FLOOR = 3.0, 0.05
GATED = ("imm_ratio_min", "imm_ratio_max", "offdiag_mass", "step_size_median",
         "step_size_min", "step_size_max", "var_ratio_min", "var_ratio_max")
NAMES = GATED + ("pareto_k",)
SCALED = ("var_ratio_min", "var_ratio_max")  # noise of C chains about 1

# this script's output (f32, three keys), at 1,024 chains with the bands
RECORDED = {
    "imm_ratio_min": [0.1422142681160535, 0.1103156822955584, 0.14607430643554636],
    "imm_ratio_max": [4.190281060925501, 4.345386741051188, 3.8379917976851643],
    "offdiag_mass": [0.18667934080397258, 0.2200223499421915, 0.22471128647560348],
    "step_size_median": [0.37402744591236115, 0.3697316348552704, 0.37755200266838074],
    "step_size_min": [0.34017425775527954, 0.33721083402633667, 0.34447014331817627],
    "step_size_max": [0.4231870472431183, 0.40475690364837646, 0.4164704978466034],
    "var_ratio_min": [0.8800927426185713, 0.8913948512672397, 0.8843510720166211],
    "var_ratio_max": [1.0864363654512683, 1.1225163390200772, 1.1109072281813883],
    "pareto_k": [1.7486844062805176, 1.8301305770874023, 1.832975149154663],
    "imm_ratio_min_band": (0.13286808561571942, 0.1072758724199639),
    "imm_ratio_max_band": (4.124553199887284, 1.522184830098071),
    "offdiag_mass_band": (0.21047099240725586, 0.1140958370148927),
    "step_size_median_band": (0.3737703611453374, 0.023461103439331055),
    "step_size_min_band": (0.34061841169993085, 0.0217779278755188),
    "step_size_max_band": (0.4148048162460327, 0.055290430784225464),
    "var_ratio_min_band": (0.9426397776504054, 0.02213198888252027),
    "var_ratio_max_band": (1.0533099887754558, 0.054119960353213314),
}
# and at 256 chains, the drift's other end
RECORDED_256 = {
    "imm_ratio_min": [0.10363473796990193, 0.10426546913856959, 0.11480309347924825],
    "imm_ratio_max": [4.316057159248307, 4.929010616291696, 4.097638344587889],
    "offdiag_mass": [0.25702208730623155, 0.27492280507230626, 0.18706387089979173],
    "step_size_median": [0.37403935194015503, 0.3693474382162094, 0.3712337464094162],
    "step_size_min": [0.34534749388694763, 0.3355953097343445, 0.34348034858703613],
    "step_size_max": [0.4147949516773224, 0.40149345993995667, 0.4027664065361023],
    "var_ratio_min": [0.798101070037008, 0.8178925926414629, 0.8012819286447789],
    "var_ratio_max": [1.2124208165470618, 1.2697397449800285, 1.198663603252132],
    "pareto_k": [1.8059566020965576, 2.0355165004730225, 1.8171666860580444],
}
# and with --steps 100, the bands of phase 22's keys 1 and 2 (cut to 100 steps)
RECORDED_100 = {
    "imm_ratio_min": [0.1422142681160535, 0.1103156822955584, 0.14607430643554636],
    "imm_ratio_max": [4.190281060925501, 4.345386741051188, 3.8379917976851643],
    "offdiag_mass": [0.18667934080397258, 0.2200223499421915, 0.22471128647560348],
    "step_size_median": [0.33365167677402496, 0.3278966099023819, 0.3346928209066391],
    "step_size_min": [0.282900333404541, 0.2765522003173828, 0.2773033082485199],
    "step_size_max": [0.39202266931533813, 0.38806644082069397, 0.40577077865600586],
    "var_ratio_min": [0.8872903988678315, 0.9046202784168698, 0.927512607343142],
    "var_ratio_max": [1.126965891742939, 1.1013937606676267, 1.1314496997135597],
    "pareto_k": [1.7486844062805176, 1.8301305770874023, 1.832975149154663],
    "imm_ratio_min_band": (0.13286808561571942, 0.1072758724199639),
    "imm_ratio_max_band": (4.124553199887284, 1.522184830098071),
    "offdiag_mass_band": (0.21047099240725586, 0.1140958370148927),
    "step_size_median_band": (0.33208036919434863, 0.020388633012771606),
    "step_size_min_band": (0.2789186139901479, 0.01904439926147461),
    "step_size_max_band": (0.395286629597346, 0.05311301350593567),
    "var_ratio_min_band": (0.9532372141046406, 0.060333312712965825),
    "var_ratio_max_band": (1.0599682253540208, 0.04508390856889943),
}


def band(values, drift=0.0):
    """``(mean, half width)``: three times the spread, 5 % of the mean or
    ``drift``, whichever is widest."""
    mean = sum(values) / len(values)
    return mean, max(BAND_SPREADS * (max(values) - min(values)), BAND_FLOOR * abs(mean),
                     abs(drift))


def scaled_to(mean_half, chains, to_chains=CONFIG_CHAINS):
    """A band about 1 of a ratio whose distance from 1 shrinks as
    ``1 / sqrt(C)``, from ``chains`` to ``to_chains``."""
    mean, half = mean_half
    factor = (chains / to_chains) ** 0.5
    return 1.0 + (mean - 1.0) * factor, half * factor


def summary(imm, step_sizes, positions, variances, pareto_k):
    """The gated statistics of one run, numpy in float64."""
    import numpy as np

    diag = np.diag(imm)
    ratio = diag / variances
    off = imm - np.diag(diag)
    var_ratio = positions.var(axis=0, ddof=1) / variances
    return {"imm_ratio_min": float(ratio.min()), "imm_ratio_max": float(ratio.max()),
            "offdiag_mass": float(np.linalg.norm(off) / np.linalg.norm(imm)),
            "step_size_median": float(np.median(step_sizes)),
            "step_size_min": float(step_sizes.min()), "step_size_max": float(step_sizes.max()),
            "var_ratio_min": float(var_ratio.min()), "var_ratio_max": float(var_ratio.max()),
            "pareto_k": float(pareto_k)}


def run(key, num_chains=NUM_CHAINS, num_steps=NUM_STEPS):
    """One warmup at ``key`` from the configuration's start: its summary."""
    import jax
    import numpy as np

    from blackjax_tpu.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu.adaptation.pathfinder_adaptation import pathfinder_adaptation
    from blackjax_tpu.mcmc import hmc
    from blackjax_tpu.models.targets import ill_conditioned_gaussian

    target = ill_conditioned_gaussian(DIM)
    position = jax.random.normal(jax.random.key(START_SEED), (CONFIG_CHAINS, DIM))[0]
    warmup = pathfinder_adaptation(
        hmc, target.logdensity_fn, num_chains=num_chains,
        num_integration_steps=NUM_INTEGRATION_STEPS,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"acceptance_rate"},
                                                    adapt_state_keys={"step_size"}))

    # eagerly: the JAX package's PSIS fit sizes its grid with a host
    # ``int`` (``diagnostics.py:219``), so the warmup cannot be traced whole
    results, _ = warmup.run(key, position, num_steps)
    params = results.parameters
    imm, step_sizes, x = (params["inverse_mass_matrix"], params["step_size"],
                          results.state.position)
    k = params["_pathfinder_psis_pareto_k"]
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    return summary(f64(imm), f64(step_sizes), f64(x), f64(target.std) ** 2, k)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--chains", type=int, nargs="+", default=[DRIFT_CHAINS, NUM_CHAINS])
    parser.add_argument("--steps", type=int, default=NUM_STEPS)
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    keys = jax.random.split(jax.random.key(KEY_SEED), NUM_KEYS)
    by_chains = {}
    for chains in args.chains:
        out = {name: [] for name in NAMES}
        for key in keys:
            for name, value in run(key, chains, args.steps).items():
                out[name].append(value)
        by_chains[chains] = out
        print(json.dumps({"chains": chains, **out}), file=sys.stderr)
    top = max(by_chains)
    out = dict(by_chains[top])
    low = min(by_chains)
    for name in GATED:
        mean = lambda c: sum(by_chains[c][name]) / NUM_KEYS  # noqa: E731
        if name in SCALED:
            out[f"{name}_band"] = scaled_to(band(out[name]), top)
        else:
            out[f"{name}_band"] = band(out[name], mean(top) - mean(low))
    out["chains"] = top
    out["drift_chains"] = low
    out[f"at_{low}"] = by_chains[low]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
