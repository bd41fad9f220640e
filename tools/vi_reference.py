"""The JAX package's own run of ``chip_smoke.py``'s phase 23 on the CPU.

Phase 23 drives the port's variational families on config #5's target
(``benchmarks/tracked.py:744-788``: ``ill_conditioned_gaussian(100)``) in
float32 and gates each run's statistics on bands around the JAX package's
values, which this script computes in float32 (JAX without x64) and prints
as one JSON object:

- ``meanfield_vi`` with ``adam(0.05)`` and ``fullrank_vi`` with
  ``adam(0.02)``, ``num_samples=100``, 500 steps from zeros (and 250, the
  ``*_cut`` bands of phase 23's keys 1 and 2), step ``i`` on
  ``fold_in(key, i)`` for the three keys of ``split(key(24), 3)`` (the
  ELBO has settled by step 500 at these rates; at 0.05 the full-rank run
  leaves its optimum again after step 750, float32 Adam on vanishing
  gradients): the smallest and largest ratio of the fitted standard
  deviations to the target's, the means' largest ``|mu| / sd``, the
  full-rank fit's off-diagonal mass ``||S - diag S||_F / ||S||_F`` of ``S = L
  L^T``, and the last step's ``info.elbo`` (the loss ``E[log q - log p]``);
- ``svgd`` with ``sgd(0.02 n)`` under the median heuristic from config #5's
  start ``normal(key(19), (4096, 100))``, 500 steps, with the statistics
  at step 200 too (``svgd_cut``): a particle's step is the mean over the
  ``n`` sources, so
  the learning rate scales with ``n`` to keep the time scale. SVGD takes no
  key: its three runs here are three disjoint ``n``-row blocks of that
  start. Statistics: the smallest and largest ratio of the particles'
  variances (``ddof = 1``) to the target's, and their means' largest ``|mean|
  / sd``;
- ``schrodinger_follmer`` with ``n_steps=100`` and ``n_inner_samples=200``
  (``tests/vi/test_vi.py``'s settings), ``n`` bridges on each key: the same
  statistics of the bridges' ends.

SVGD and the bridges run at 1,024 particles (the bands' size) and at 256,
which shows how each statistic drifts with ``n``. Each band is ``(mean,
half width)`` at 1,024 (or over the three keys of the Gaussian families):
the half width three times the values' spread, 5 % of the mean, the drift
of the mean from 256 to 1,024 (the bridges are independent, so their
statistics are of the form ``a + b / sqrt(n)`` and drift from 1,024 to
phase 23's 4,096 half as far), or, for a statistic whose value is about 0
(the means, the off-diagonal mass, a collapsed variance), 0.01, whichever
is widest. SVGD's statistics move with ``log n`` instead, since the median
heuristic's length scale is ``median^2 / log n`` (the 256-particle runs
sit as far below the 1,024 ones as those below phase 23's 4,096): their
band (but of a statistic about 0) is centred at the mean extrapolated to
4,096 linearly in ``log n``. ``RECORDED`` below is its
output, which ``chip_smoke.VI_REFERENCE`` holds; rerun it whenever a
phase-23 setting changes.

Usage, from the root of the repository (about 15 minutes on 8 CPU cores,
most of it SVGD's 1,024-particle runs)::

    python tools/vi_reference.py
"""
import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

DIM, NUM_SAMPLES, KEY_SEED, START_SEED, NUM_KEYS = 100, 100, 24, 19, 3
GAUSSIAN = {"meanfield_vi": (0.05, 500), "fullrank_vi": (0.02, 500)}  # adam's rate, steps
GAUSSIAN_CUT_STEPS = 250  # phase 23's keys 1 and 2
SVGD_RATE, SVGD_STEPS, SVGD_CHEAP_STEPS = 0.02, 500, 200  # the rate over n
SF_STEPS, SF_INNER = 100, 200
NUM_PARTICLES, DRIFT_PARTICLES, CONFIG_PARTICLES = 1024, 256, 4096
BAND_SPREADS, BAND_FLOOR, BAND_ZERO = 3.0, 0.05, 0.01
ZERO = ("mean_abs_sd", "offdiag_mass")  # statistics about 0
PARTICLE_NAMES = ("var_ratio_min", "var_ratio_max", "mean_abs_sd")

# this script's output (f32, three keys or blocks; SVGD and the bridges at
# 1,024 particles, with the drift from 256)
RECORDED = {
    "meanfield_vi": {
        "sd_ratio_min": [0.9999997985608781, 0.9999998531008787, 0.9999998837404234],
        "sd_ratio_max": [1.0000000863427116, 1.0000001016908349, 1.0000000921573153],
        "mean_abs_sd": [3.695680411797205e-08, 4.970143022023119e-08, 4.26268528085767e-08],
        "elbo": [-91.89382934570312, -91.89382934570312, -91.89382934570312],
        "sd_ratio_min_band": (0.99999984513406, 0.049999992256703006),
        "sd_ratio_max_band": (1.000000093396954, 0.0500000046698477),
        "mean_abs_sd_band": (4.3095029048926644e-08, 0.01),
        "elbo_band": (-91.89382934570312, 4.594691467285156),
    },
    "meanfield_vi_cut": {
        "sd_ratio_min": [0.9999794852473649, 0.9999800017576536, 0.9999800714229493],
        "sd_ratio_max": [1.0000127974307413, 1.0000103070978064, 1.0000115873694668],
        "mean_abs_sd": [1.625288933355188e-05, 4.248911229438205e-05, 1.4696135658029633e-05],
        "elbo": [-91.89382934570312, -91.89386749267578, -91.89384460449219],
        "sd_ratio_min_band": (0.9999798528093226, 0.04999899264046613),
        "sd_ratio_max_band": (1.000011563966005, 0.050000578198300255),
        "mean_abs_sd_band": (2.4479379095321185e-05, 0.01),
        "elbo_band": (-91.8938471476237, 4.594692357381185),
    },
    "fullrank_vi": {
        "sd_ratio_min": [0.9999989344168285, 0.9999989093425246, 0.9999990983526721],
        "sd_ratio_max": [1.0000005654593136, 1.0000005654593136, 1.0000005654593136],
        "mean_abs_sd": [3.3344859156731507e-07, 3.0859395273424953e-07, 6.174728437412302e-07],
        "elbo": [-91.89382934570312, -91.89382934570312, -91.89382934570312],
        "offdiag_mass": [1.2499575165571696e-07, 9.584796173001257e-08, 1.408780207522902e-07],
        "sd_ratio_min_band": (0.9999989807040084, 0.04999994903520042),
        "sd_ratio_max_band": (1.0000005654593136, 0.05000002827296568),
        "mean_abs_sd_band": (4.1983846268093165e-07, 0.01),
        "elbo_band": (-91.89382934570312, 4.594691467285156),
        "offdiag_mass_band": (1.205739113793399e-07, 0.01),
    },
    "fullrank_vi_cut": {
        "sd_ratio_min": [0.9999785409365907, 0.9999745595284457, 0.9999751566546793],
        "sd_ratio_max": [1.0048211061081576, 1.004971047069493, 1.0044169911853376],
        "mean_abs_sd": [0.0007136426021358529, 0.0012528134877278366, 0.0010592839332193022],
        "elbo": [-91.89350128173828, -91.8939437866211, -91.89476013183594],
        "offdiag_mass": [2.3522979754243335e-05, 2.151292248700614e-05, 2.543349775793903e-05],
        "sd_ratio_min_band": (0.9999760857065718, 0.049998804285328595),
        "sd_ratio_max_band": (1.0047363814543295, 0.05023681907271648),
        "mean_abs_sd_band": (0.0010085800076943307, 0.01),
        "elbo_band": (-91.89406840006511, 4.594703420003255),
        "offdiag_mass_band": (2.34897999997295e-05, 0.01),
    },
    "svgd": {
        "var_ratio_min": [0.0, 0.0, 0.0],
        "var_ratio_max": [0.3627662442110747, 0.3620255487200155, 0.3624881898853119],
        "mean_abs_sd": [0.0007478721918584444, 0.0011177638839628087, 0.0005508117423570417],
        "var_ratio_min_band": (0.0, 0.01),
        "var_ratio_max_band": (0.4339431176094523, 0.0715164566706516),
        "mean_abs_sd_band": (0.0008054826060594315, 0.01),
        "at_256": {
            "var_ratio_min": [0.0, 0.0, 0.0],
            "var_ratio_max": [0.2911447200518326, 0.2925157429060055, 0.2890701498466093],
            "mean_abs_sd": [0.0020858158467295545, 0.0030381546460731316, 0.002182542365791469],
        },
    },
    "svgd_cut": {
        "var_ratio_min": [1.5038868245026107e-34, 1.3767082344113317e-34, 1.4535743543155459e-34],
        "var_ratio_max": [0.24758531121510569, 0.24539807879203818, 0.24536264218472947],
        "mean_abs_sd": [0.0037437879868654107, 0.004960264171770399, 0.004211291550918334],
        "var_ratio_min_band": (1.444723137743163e-34, 0.01),
        "var_ratio_max_band": (0.29516160915131057, 0.0490462650873528),
        "mean_abs_sd_band": (0.004305114569851381, 0.010330023436910848),
        "at_256": {
            "var_ratio_min": [6.911738128744207e-34, 4.855334855477832e-34, 6.190353688079041e-34],
            "var_ratio_max": [0.19451448585074513, 0.2041073257274069, 0.19258542535166284],
            "mean_abs_sd": [0.011950191501114822, 0.015346375330870854, 0.01660884718830102],
        },
    },
    "schrodinger_follmer": {
        "var_ratio_min": [0.15569477583568245, 0.1499552268144871, 0.14333612372886367],
        "var_ratio_max": [1.7738938291634851, 1.8040870433915972, 1.7863083013518521],
        "mean_abs_sd": [0.08411568179195053, 0.08146929941501888, 0.1049702710757489],
        "var_ratio_min_band": (0.1496620421263444, 0.03707595632045632),
        "var_ratio_max_band": (1.7880963913023116, 0.2188185345294078),
        "mean_abs_sd_band": (0.09018508409423943, 0.13063121336204464),
        "at_256": {
            "var_ratio_min": [0.14891867252371702, 0.138107299035861, 0.1327712286612526],
            "var_ratio_max": [1.9906483450472043, 2.0328402412779876, 1.9972561911699664],
            "mean_abs_sd": [0.23363942146854605, 0.20036715367016808, 0.22844231723013816],
        },
    },
}


def band(values, drift=0.0, zero=False):
    """``(mean, half width)``: three times the spread, 5 % of the mean, the
    drift or, for a statistic about 0, ``BAND_ZERO``, whichever is widest."""
    mean = sum(values) / len(values)
    return mean, max(BAND_SPREADS * (max(values) - min(values)), BAND_FLOOR * abs(mean),
                     abs(drift), BAND_ZERO if zero else 0.0)


def gaussian_summary(mu, cov, std, elbo):
    """The gated statistics of a Gaussian fit (numpy, float64): ``mu`` and
    the covariance ``cov`` (a diagonal, or a full matrix)."""
    import numpy as np

    diag = cov if cov.ndim == 1 else np.diag(cov)
    ratio = np.sqrt(diag) / std
    out = {"sd_ratio_min": float(ratio.min()), "sd_ratio_max": float(ratio.max()),
           "mean_abs_sd": float(np.abs(mu / std).max()), "elbo": float(elbo)}
    if cov.ndim == 2:
        out["offdiag_mass"] = float(np.linalg.norm(cov - np.diag(diag)) / np.linalg.norm(cov))
    return out


def particle_summary(x, std):
    """The gated statistics of particles or bridges' ends ``x`` (numpy,
    float64): the variances' ratios (``ddof = 1``) and the means."""
    import numpy as np

    ratio = x.var(axis=0, ddof=1) / std**2
    return {"var_ratio_min": float(ratio.min()), "var_ratio_max": float(ratio.max()),
            "mean_abs_sd": float(np.abs(x.mean(axis=0) / std).max())}


def gaussian_run(name, key, steps):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    import blackjax_tpu
    from blackjax_tpu.models.targets import ill_conditioned_gaussian
    from blackjax_tpu.vi.fullrank_vi import _unflatten_cholesky

    target = ill_conditioned_gaussian(DIM)
    rate = GAUSSIAN[name][0]
    algo = getattr(blackjax_tpu, name)(target.logdensity_fn, optax.adam(rate),
                                       num_samples=NUM_SAMPLES)

    def body(state, i):
        state, info = algo.step(jax.random.fold_in(key, i), state)
        return state, info.elbo

    state, elbo = jax.jit(lambda s: jax.lax.scan(body, s, jnp.arange(steps)))(
        algo.init(jnp.zeros(DIM)))
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    if name == "meanfield_vi":
        cov = np.exp(2.0 * f64(state.rho))
    else:
        L = f64(_unflatten_cholesky(state.chol_params, DIM))
        cov = L @ L.T
    return gaussian_summary(f64(state.mu), cov, f64(target.std), f64(elbo[-1]))


def svgd_run(block, n):
    """SVGD on rows ``[block n, (block + 1) n)`` of config #5's start: the
    summaries at the cut and the full step count."""
    import jax
    import numpy as np
    import optax

    import blackjax_tpu
    from blackjax_tpu.models.targets import ill_conditioned_gaussian

    target = ill_conditioned_gaussian(DIM)
    start = jax.random.normal(jax.random.key(START_SEED), (CONFIG_PARTICLES, DIM))
    algo = blackjax_tpu.svgd(jax.grad(target.logdensity_fn), optax.sgd(SVGD_RATE * n))
    state = algo.init(start[block * n:(block + 1) * n])
    out = {}
    done = 0
    for steps in (SVGD_CHEAP_STEPS, SVGD_STEPS):
        state = jax.jit(lambda s, k=steps - done: jax.lax.scan(
            lambda c, _: (algo.step(c), None), s, None, length=k)[0])(state)
        done = steps
        out[steps] = particle_summary(np.asarray(state.particles, np.float64),
                                      np.asarray(target.std, np.float64))
    return out


def sf_run(key, n):
    import jax
    import jax.numpy as jnp
    import numpy as np

    import blackjax_tpu
    from blackjax_tpu.models.targets import ill_conditioned_gaussian

    target = ill_conditioned_gaussian(DIM)
    algo = blackjax_tpu.schrodinger_follmer(target.logdensity_fn, n_steps=SF_STEPS,
                                            n_inner_samples=SF_INNER)
    final = jax.jit(lambda k: algo.sample(k, algo.init(jnp.zeros(DIM)), n))(key)
    return particle_summary(np.asarray(final.position, np.float64),
                            np.asarray(target.std, np.float64))


def _collect(summaries):
    out = {}
    for summary in summaries:
        for name, value in summary.items():
            out.setdefault(name, []).append(value)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--particles", type=int, nargs="+",
                        default=[DRIFT_PARTICLES, NUM_PARTICLES])
    parser.add_argument("--gaussian-only", action="store_true",
                        help="the Gaussian families alone (about a minute)")
    args = parser.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    keys = jax.random.split(jax.random.key(KEY_SEED), NUM_KEYS)
    out = {}
    for name, (_, steps) in GAUSSIAN.items():
        for label, n in ((name, steps), (f"{name}_cut", GAUSSIAN_CUT_STEPS)):
            values = _collect(gaussian_run(name, key, n) for key in keys)
            out[label] = {**values, **{f"{s}_band": band(v, zero=s in ZERO)
                                       for s, v in values.items()}}
            print(json.dumps({label: out[label]}), file=sys.stderr)
    if args.gaussian_only:
        print(json.dumps(out))
        return
    runs = {}
    for n in args.particles:
        svgd = [svgd_run(block, n) for block in range(NUM_KEYS)]
        runs[n] = {"svgd": _collect(r[SVGD_STEPS] for r in svgd),
                   "svgd_cut": _collect(r[SVGD_CHEAP_STEPS] for r in svgd),
                   "schrodinger_follmer": _collect(sf_run(key, n) for key in keys)}
        print(json.dumps({"particles": n, **runs[n]}), file=sys.stderr)
    out.update(particle_bands(runs))
    print(json.dumps(out))


def particle_bands(runs):
    """The particle families' entries from their runs ``{n: {family:
    {statistic: [values]}}}``: the values at the larger ``n``, each
    statistic's band and the runs at the smaller ``n``. SVGD's statistics
    move with ``log n`` (the median heuristic's length scale is ``median^2
    / log n``): the band of each that is not about 0 is centred at the mean
    extrapolated to 4,096 particles linearly in ``log n``."""
    import math

    top, low = max(runs), min(runs)
    out = {}
    for name in runs[top]:
        values = runs[top][name]
        out[name] = dict(values)
        for s in PARTICLE_NAMES:
            mean = lambda n: sum(runs[n][name][s]) / NUM_KEYS  # noqa: E731
            drift = mean(top) - mean(low)
            zero = s in ZERO or (s == "var_ratio_min" and mean(top) < BAND_ZERO)
            centre, half = band(values[s], drift, zero)
            if name.startswith("svgd") and not zero:
                centre += drift * math.log(CONFIG_PARTICLES / top) / math.log(top / low)
                half = max(half, BAND_FLOOR * abs(centre))
            out[name][f"{s}_band"] = (centre, half)
        out[name][f"at_{low}"] = runs[low][name]
    return out


if __name__ == "__main__":
    main()
