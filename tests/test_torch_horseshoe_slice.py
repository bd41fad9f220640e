"""The horseshoe path end to end on the CPU, at N=12, M=16 (d=36):
``window_adaptation(nuts)`` on the model-layout posterior, then the dc
machine (its plain version, which ``fused_nuts_run_dc`` takes for CPU
tensors) on the adapted step size and permuted metric, then ESS.

The machine is held as ``tests/ops/test_targets_dc.py:143-207`` holds the
Pallas machine: every chain completes within the budget, everything is
finite, and the mean number of leaves per transition lies within rel 0.5 of
the reference's XLA NUTS at the same step size and metric (measured: 26.65
against 25.67 leaves per transition after a 60-step warmup; 28.9 against
29.2 after 150 steps).
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
from blackjax_tpu.models.targets import finnish_horseshoe as jfinnish_horseshoe  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn  # noqa: E402
from blackjax_tpu_torch.mcmc import nuts  # noqa: E402
from blackjax_tpu_torch.models import finnish_horseshoe  # noqa: E402
from blackjax_tpu_torch.ops.fused_nuts_dc import fused_nuts_run_dc  # noqa: E402
from blackjax_tpu_torch.ops.targets_dc import (  # noqa: E402
    horseshoe_dc_perm,
    make_finnish_horseshoe_target_dc,
)

N, M = 12, 16
C, S = 16, 12
MAX_DOUBLINGS = 5
# the warmup's steps: its tests are structural (a usable step size and a
# positive metric; the machine and the reference NUTS are compared at
# whatever parameters it gives)
WARMUP = 60


@pytest.fixture(scope="module")
def slice_run():
    model = finnish_horseshoe(N, M)
    d = model.dim
    warmup = blackjax_tpu_torch.window_adaptation(
        nuts, model.logdensity_fn, max_num_doublings=MAX_DOUBLINGS,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}),
    )
    (_, params), _ = warmup.run(torch.Generator().manual_seed(0), torch.zeros(d), WARMUP)
    step, imm = params["step_size"], params["inverse_mass_matrix"]
    to_dc, _ = horseshoe_dc_perm(M)
    imm_dc = imm[torch.from_numpy(to_dc)]
    x0_model = 0.05 * np.random.default_rng(1).standard_normal((C, d))
    x0 = torch.from_numpy(x0_model[:, to_dc]).float()
    fx, hist, grads, steps = fused_nuts_run_dc(
        x0, imm_dc, step, target=make_finnish_horseshoe_target_dc(N, M), num_steps=S,
        max_num_doublings=MAX_DOUBLINGS, seed=3, num_track=d, budget=S * 40, chunk=16,
    )
    ess = blackjax_tpu_torch.ess(hist.double())
    return dict(step=step, imm=imm, imm_dc=imm_dc, x0_model=x0_model, fx=fx, hist=hist,
                grads=grads, steps=steps, ess=ess)


def test_warmup_gives_a_usable_step_and_metric(slice_run):
    assert 0.0 < slice_run["step"] < 2.0
    imm = slice_run["imm"]
    assert imm.shape == (2 * M + 4,) and bool(torch.isfinite(imm).all() and (imm > 0).all())


def test_every_chain_completes_and_is_finite(slice_run):
    assert bool((slice_run["steps"] == S).all()), "leaf budget exhausted"
    assert slice_run["hist"].shape == (C, S, 2 * M + 4)
    for name in ("fx", "hist", "ess"):
        assert bool(torch.isfinite(slice_run[name]).all()), name
    # min-ESS over all coordinates equals the JAX package's on this history
    expected = np.asarray(jax.jit(jdiag.effective_sample_size)(
        jnp.asarray(slice_run["hist"].double().numpy())))
    np.testing.assert_allclose(slice_run["ess"].numpy(), expected, rtol=1e-10)


def test_trajectory_length_matches_reference_nuts(slice_run):
    """Mean leaves per transition of the machine against the reference's
    generic NUTS on the model layout, same step size and metric."""
    d = 2 * M + 4
    machine_len = float(slice_run["grads"]) / (C * S)
    target = jfinnish_horseshoe(N, M)
    algo = blackjax_tpu.nuts(
        target.logdensity_fn, step_size=slice_run["step"],
        inverse_mass_matrix=jnp.asarray(slice_run["imm"].numpy()),
        max_num_doublings=MAX_DOUBLINGS,
    )

    # one compile, at XLA's optimization level 0 with its older fusion
    # emitters; run eagerly, the init and the scan compile apart
    @functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                                                  "xla_cpu_use_fusion_emitters": False})
    def total_leaves(x0, key):
        states = jax.vmap(algo.init)(x0)

        def one(states, key):
            states, infos = jax.vmap(algo.step)(jax.random.split(key, C), states)
            return states, jnp.sum(infos.num_integration_steps)

        _, leaves = jax.lax.scan(one, states, jax.random.split(key, S))
        return jnp.sum(leaves)

    leaves = total_leaves(jnp.asarray(slice_run["x0_model"], jnp.float32), jax.random.key(7))
    reference_len = float(leaves) / (C * S)
    print(f"leaves per transition: machine {machine_len:.2f}, reference NUTS {reference_len:.2f}")
    assert machine_len == pytest.approx(reference_len, rel=0.5)
    assert d == target.dim


def reference_bands(num_warmup=600, num_chains=64, num_samples=256, seed=31):
    """The reference's posterior of ``alpha`` and ``log_sigma`` on the full
    horseshoe (N=100, M=200, d=404), for ``chip_smoke.py``'s bands: the
    JAX package's ``window_adaptation(nuts)`` from zeros (``num_warmup``
    steps, ``max_num_doublings=10``), then its generic NUTS on
    ``num_chains`` chains from ``0.05 N(0, I)`` for ``num_samples``
    transitions; the moments are taken over the second half. Run with
    ``PYTHONPATH=. python tests/test_torch_horseshoe_slice.py`` (on the CPU:
    minutes)."""
    from blackjax_tpu.adaptation.window_adaptation import window_adaptation
    from blackjax_tpu.mcmc import nuts as jnuts

    target = jfinnish_horseshoe()
    warm_key, pos_key, sample_key = jax.random.split(jax.random.key(seed), 3)
    results, _ = window_adaptation(jnuts, target.logdensity_fn).run(
        warm_key, jnp.zeros(target.dim), num_warmup)
    params = results.parameters
    algo = blackjax_tpu.nuts(target.logdensity_fn, **params)
    states = jax.vmap(algo.init)(0.05 * jax.random.normal(pos_key, (num_chains, target.dim)))

    @jax.jit
    def run(states, keys):
        def one(states, ks):
            states, infos = jax.vmap(algo.step)(ks, states)
            return states, (states.position[:, :2], infos.num_integration_steps)

        return jax.lax.scan(one, states, keys)

    _, (hist, leaves) = run(states, jax.random.split(sample_key, (num_samples, num_chains)))
    half = np.asarray(hist[num_samples // 2:])  # (samples, chains, [alpha, log_sigma])
    ess = np.asarray(jdiag.effective_sample_size(jnp.asarray(half.swapaxes(0, 1))))
    for i, name in enumerate(("alpha", "log_sigma")):
        v = half[..., i]
        print(f"{name}: second-half mean {v.mean():.5f}, sd {v.std():.5f}, ESS {ess[i]:.1f}, "
              f"MCSE {v.std() / np.sqrt(ess[i]):.5f}")
    print(f"warmup: step size {float(params['step_size']):.5f}; mean leaves per transition "
          f"{float(np.asarray(leaves).mean()):.1f}; settings: num_warmup={num_warmup}, "
          f"num_chains={num_chains}, num_samples={num_samples}, seed={seed}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    reference_bands()
