"""The dense and low-rank path end to end on the CPU, on a small logistic
regression: the port's ``window_adaptation(nuts, is_mass_matrix_diagonal=
False)`` and ``window_adaptation_low_rank(nuts)``, then the dc machine (its
plain version, which ``fused_nuts_run_dc`` takes for CPU tensors) with the
adapted ``(d, d)`` or ``LowRankInverseMassMatrix`` metric, then ESS.

The machine's draws are held against the JAX package's generic NUTS on the
same posterior: each coordinate's pooled mean within 0.25 posterior sd and
its variance within [0.6, 1.6] of the reference's (few chains and
transitions here; ``chip_smoke.py`` holds the full-width run to 0.15 sd and
[0.8, 1.25]).

:func:`reference_moments` computes the posterior that ``chip_smoke.py``
phase 11 holds its 4,096 x 54 run against.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
from blackjax_tpu import diagnostics as jdiag  # noqa: E402
from blackjax_tpu.ops import targets_dc as ref_dc  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn  # noqa: E402
from blackjax_tpu_torch.mcmc import nuts  # noqa: E402
from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix  # noqa: E402
from blackjax_tpu_torch.ops import targets_dc as port_dc  # noqa: E402
from blackjax_tpu_torch.ops.fused_nuts_dc import fused_nuts_run_dc  # noqa: E402


# the JAX side at XLA's optimization level 0 with its older CPU fusion
# emitters: a quicker compile
OPT0 = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}

def logreg_data(n, d, seed):
    """``chip_smoke.py``'s logistic-regression data (phase 9): ``X ~ N(0, 1)``
    in f32, true weights ``N(0, 1)``, ``y ~ Bernoulli(sigmoid(X w))``, all
    from ``np.random.default_rng(seed)`` in this order."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(d)))).astype(np.float32)
    return X, y


N_DATA, DIM = 100, 5
C, S = 16, 60
WARMUP = 150


def _reference_slice_moments():
    """The JAX package's posterior moments of the small regression: its
    dense window adaptation, then generic NUTS on 16 chains."""
    mean, sd, _ = reference_moments(n=N_DATA, d=DIM, seed=4, num_warmup=WARMUP,
                                    num_chains=C, num_samples=120, key=5)
    return mean, sd


@pytest.fixture(scope="module")
def reference():
    return _reference_slice_moments()


@pytest.fixture(scope="module", params=["dense", "low_rank"])
def slice_run(request):
    X, y = logreg_data(N_DATA, DIM, 4)
    target = port_dc.make_logreg_target_dc(X, y)
    generator = torch.Generator().manual_seed(0)
    x0 = torch.zeros(DIM, dtype=torch.float64)
    if request.param == "dense":
        warmup = blackjax_tpu_torch.window_adaptation(
            nuts, target.logdensity_fn, is_mass_matrix_diagonal=False, max_num_doublings=6,
            adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}))
    else:
        warmup = blackjax_tpu_torch.window_adaptation_low_rank(
            nuts, target.logdensity_fn, max_rank=3, max_num_doublings=6)
    (state, params), _ = warmup.run(generator, x0, WARMUP)
    imm = params["inverse_mass_matrix"]
    start = state.position.reshape(-1, DIM).float()
    jitter = 0.01 * np.random.default_rng(1).standard_normal((C, DIM)).astype(np.float32)
    fx, hist, grads, steps = fused_nuts_run_dc(
        start + torch.from_numpy(jitter), imm, params["step_size"], target=target, num_steps=S,
        max_num_doublings=6, seed=3, num_track=DIM, budget=S * 64, chunk=16)
    return dict(kind=request.param, imm=imm, step=params["step_size"], fx=fx, hist=hist,
                grads=grads, steps=steps, ess=blackjax_tpu_torch.ess(hist.double()))


def test_warmup_gives_the_metric_of_its_kind(slice_run):
    imm = slice_run["imm"]
    if slice_run["kind"] == "dense":
        assert isinstance(imm, torch.Tensor) and imm.shape == (DIM, DIM)
        assert bool((torch.linalg.eigvalsh(imm) > 0).all())
    else:
        assert isinstance(imm, LowRankInverseMassMatrix) and imm.U.shape == (DIM, 3)
        assert bool((imm.sigma > 0).all() and (imm.lam > 0).all())
    assert 0.0 < slice_run["step"] < 3.0


def test_every_chain_completes_and_is_finite(slice_run):
    assert bool((slice_run["steps"] == S).all()), "leaf budget exhausted"
    assert slice_run["hist"].shape == (C, S, DIM)
    for name in ("fx", "hist", "ess"):
        assert bool(torch.isfinite(slice_run[name]).all()), name


def test_moments_match_the_reference_nuts(slice_run, reference):
    mean, sd = reference
    second = slice_run["hist"][:, S // 2:].reshape(-1, DIM).double().numpy()
    z = (second.mean(0) - mean) / sd
    ratio = second.var(0) / sd**2
    print(f"{slice_run['kind']}: mean offsets in sd {np.round(z, 3)}, variance ratios "
          f"{np.round(ratio, 3)}, leaves per transition {float(slice_run['grads']) / (C * S):.2f}")
    assert np.abs(z).max() < 0.25
    assert 0.6 < ratio.min() and ratio.max() < 1.6


def test_sample_init_follows_the_generator():
    target = blackjax_tpu_torch.models.hierarchical_gaussian(6)
    x = target.sample_init(torch.Generator().manual_seed(0), 3, dtype=torch.float64)
    assert x.device.type == "cpu" and x.shape == (3, 6) and x.dtype == torch.float64
    same = target.sample_init(torch.Generator().manual_seed(0), 3, dtype=torch.float64)
    assert torch.equal(x, same)


def reference_moments(n=4096, d=54, seed=9, num_warmup=1000, num_chains=64,
                      num_samples=512, key=51):
    """The JAX package's posterior of the logistic regression of
    ``logreg_data(n, d, seed)`` (prior scale 10, ``make_logreg_target_dc``'s
    ``logdensity_fn``): its dense ``window_adaptation(nuts)`` from zeros
    (``num_warmup`` steps), then its generic NUTS on ``num_chains`` chains
    from the adapted position plus ``0.01 N(0, I)`` for ``num_samples``
    transitions; mean, sd and ESS per coordinate over the second half.
    Run with ``PYTHONPATH=. python tests/test_torch_metric_slice.py`` (on
    the CPU, minutes)."""
    from blackjax_tpu.adaptation.window_adaptation import window_adaptation
    from blackjax_tpu.mcmc import nuts as jnuts

    X, y = logreg_data(n, d, seed)
    target = ref_dc.make_logreg_target_dc(X, y)
    warm_key, pos_key, sample_key = jax.random.split(jax.random.key(key), 3)
    # each stage is one compiled call: run eagerly, the warmup, the chains'
    # init and the ESS compile each of their small steps on their own
    results = jax.jit(lambda k: window_adaptation(
        jnuts, target.logdensity_fn, is_mass_matrix_diagonal=False
    ).run(k, jnp.zeros(d), num_warmup)[0], compiler_options=OPT0)(warm_key)
    params = results.parameters
    algo = blackjax_tpu.nuts(target.logdensity_fn, **params)
    start = results.state.position + 0.01 * jax.random.normal(pos_key, (num_chains, d))

    @functools.partial(jax.jit, compiler_options=OPT0)
    def run(start, keys):
        def one(states, ks):
            states, infos = jax.vmap(algo.step)(ks, states)
            return states, (states.position, infos.num_integration_steps)

        return jax.lax.scan(one, jax.vmap(algo.init)(start), keys)

    _, (hist, leaves) = run(start, jax.random.split(sample_key, (num_samples, num_chains)))
    half = np.asarray(hist[num_samples // 2:])  # (samples, chains, d)
    ess = np.asarray(jax.jit(jdiag.effective_sample_size)(jnp.asarray(half.swapaxes(0, 1))))
    mean, sd = half.mean(axis=(0, 1)), half.std(axis=(0, 1))
    fmt = dict(separator=", ", precision=6, floatmode="fixed", max_line_width=100)
    print(f"MEAN = {np.array2string(mean, **fmt)}")
    print(f"SD = {np.array2string(sd, **fmt)}")
    print(f"min ESS {ess.min():.1f}, max MCSE / sd {float((1 / np.sqrt(ess)).max()):.4f}")
    print(f"warmup: step size {float(params['step_size']):.5f}; mean leaves per transition "
          f"{float(np.asarray(leaves).mean()):.2f}; settings: n={n}, d={d}, seed={seed}, "
          f"num_warmup={num_warmup}, num_chains={num_chains}, num_samples={num_samples}, "
          f"key={key}")
    return mean, sd, ess


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    reference_moments()
