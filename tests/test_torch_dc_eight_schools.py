"""Eight schools on the dc machine, on the CPU: the wrapper's plan for its
two forms (one chain a warp, and the thread form, one chain a thread,
``csrc/fused_nuts_dc.cuh:nuts_dc_thread``, which runs where
``_EIGHT_SCHOOLS_THREAD`` is set),
the port's plain machine chain by chain against the Pallas kernel in
interpret mode at the tracked configuration's ``pack`` and
``restart_every``, and the tracked path (warmup, the machine, ESS) against
the JAX package's NUTS posterior. No kernel is built or launched here;
``tests/test_torch_cuda.py`` holds the thread form bit for bit against the
registers form on the card.

The moments that ``chip_smoke.py`` phase 15 gates on come from
:func:`reference_bands` (the JAX package's own NUTS on the CPU, minutes):
``PYTHONPATH=. python tests/test_torch_dc_eight_schools.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
from blackjax_tpu import diagnostics as jdiag  # noqa: E402
from blackjax_tpu.models.targets import eight_schools_noncentered as jeight_schools  # noqa: E402
from blackjax_tpu.ops import fused_nuts_dc as ref  # noqa: E402
from blackjax_tpu.ops import targets_dc as ref_dc  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn  # noqa: E402
from blackjax_tpu_torch.mcmc import nuts  # noqa: E402
from blackjax_tpu_torch.models import eight_schools_noncentered  # noqa: E402
from blackjax_tpu_torch.ops import fused_nuts_dc as dc  # noqa: E402
from blackjax_tpu_torch.ops.targets_dc import (  # noqa: E402
    eight_schools_dc_perm,
    make_eight_schools_target_dc,
)

ES = dc._CUDA_EIGHT_SCHOOLS

# The posterior of mu and log_tau by the JAX package's own NUTS on the CPU
# (reference_bands below: window_adaptation 1,000 steps from zeros, then 128
# chains from 0.1 N(0, I) x 2,000 transitions, key 15, second half): each
# one's mean, variance and the mean's Monte Carlo standard error.
# chip_smoke.py's phase 15 holds its constants to these.
REFERENCE = {"mu": (4.56320, 10.24402, 0.01208), "log_tau": (-2.77182, 11.80050, 0.01602)}


# ---- the plan ----


@pytest.mark.parametrize("max_depth, nbytes", [(6, 25_600), (8, 30_720), (10, 35_840)])
def test_thread_form_bytes(monkeypatch, max_depth, nbytes):
    """With the thread form on, a block of one warp: 32 chains' checkpoint
    slots (m and msum, ten floats each, at every level) and their proposal
    and ends (eight vectors of ten floats) in shared memory,
    [.][dim][lane]; nothing in device memory."""
    monkeypatch.setattr(dc, "_EIGHT_SCHOOLS_THREAD", True)
    assert nbytes == 4 * 32 * 10 * (2 * max_depth + 8)
    plan = dc.shared_memory_plan(1, ES, "diag", max_depth)
    assert plan == dc.SharedMemoryPlan(None, nbytes, thread=True)
    assert plan.form == 2 and not plan.resident
    assert dc.scratch_floats(plan, 1, "diag", max_depth) == (0, 0)


def test_eight_schools_keeps_the_registers_form_by_default():
    """The thread form measured slower at the tracked shape (PERF.md §6), so
    it is off and the plan keeps four warps a block, one chain a warp, with
    its slots and the target's scratch in shared memory."""
    assert dc._EIGHT_SCHOOLS_THREAD is False
    plan = dc.shared_memory_plan(1, ES, "diag", 10)
    assert plan == dc.SharedMemoryPlan(None, 4 * 4 * (2 * 10 * 32 + 3 * 32 + 32))
    assert plan.form == 0 and not plan.thread


def test_the_switch_gives_eight_schools_the_thread_form(monkeypatch):
    monkeypatch.setattr(dc, "_EIGHT_SCHOOLS_THREAD", True)
    assert dc.shared_memory_plan(1, ES, "diag", 10).thread


@pytest.mark.parametrize("metric", ["dense", "low_rank"])
@pytest.mark.parametrize("max_depth", [6, 10])
def test_rich_metrics_keep_the_registers_form(monkeypatch, metric, max_depth):
    """Eight schools under the dense and low-rank metrics, with the thread
    form on for the diagonal one: four warps a block, each with its slots
    (m, msum and w), a staging vector and the target's scratch, as before
    the thread form."""
    monkeypatch.setattr(dc, "_EIGHT_SCHOOLS_THREAD", True)
    plan = dc.shared_memory_plan(1, ES, metric, max_depth)
    assert plan == dc.SharedMemoryPlan(None, 4 * 4 * ((3 * max_depth + 1) * 32 + 3 * 32 + 32))
    assert plan.form == 0 and not plan.thread


OTHERS = [
    (dc._CUDA_HIERARCHICAL, 100, "diag", 8, 0, 0, 0), (dc._CUDA_GAUSSIAN, 10, "diag", 10, 0, 0, 0),
    (dc._CUDA_HIERARCHICAL, 404, "diag", 10, 0, 0, 0), (dc._CUDA_GAUSSIAN, 54, "dense", 8, 0, 0, 0),
    (dc._CUDA_GAUSSIAN, 100, "low_rank", 8, 0, 0, 10),
    (dc._CUDA_HORSESHOE, 404, "diag", 10, 100, 200, 0), (dc._CUDA_HORSESHOE, 36, "dense", 6, 12, 16, 0),
    (dc._CUDA_LOGREG, 54, "diag", 8, 4096, 54, 0), (dc._CUDA_LOGREG, 54, "low_rank", 8, 4096, 54, 10),
]


@pytest.mark.parametrize("family, d, metric, max_depth, rows, cols, rank", OTHERS)
def test_other_targets_keep_their_form_and_bytes(monkeypatch, family, d, metric, max_depth,
                                                 rows, cols, rank):
    """The switch changes eight schools' plan only: with the thread form
    on, every other target's plan is the one it has without it."""
    n = dc._register_width(d)
    args = (n, family, metric, max_depth, rows, cols, rank)
    plan = dc.shared_memory_plan(*args)
    monkeypatch.setattr(dc, "_EIGHT_SCHOOLS_THREAD", True)
    assert plan == dc.shared_memory_plan(*args) and not plan.thread
    assert dc.scratch_floats(plan, n, metric, max_depth) == dc.scratch_floats(
        dc.shared_memory_plan(*args), n, metric, max_depth)


@pytest.mark.parametrize("metric", ["diag", "dense", "low_rank"])
def test_cpu_tensors_run_the_plain_version_and_count_nothing(monkeypatch, metric):
    """With the thread form on, eight schools under every metric runs on
    CPU tensors through the plain version and launches nothing."""
    monkeypatch.setattr(dc, "_EIGHT_SCHOOLS_THREAD", True)
    imm = {"diag": torch.ones(10), "dense": torch.eye(10),
           "low_rank": blackjax_tpu_torch.mcmc.metrics.LowRankInverseMassMatrix(
               torch.ones(10), torch.eye(10)[:, :2], torch.ones(2))}[metric]
    before = dict(dc.LAUNCHES)
    out = dc.fused_nuts_run_dc(torch.zeros(4, 10), imm, 0.2,
                               target=make_eight_schools_target_dc(), num_steps=2, num_track=10)
    assert dc.LAUNCHES == before
    assert bool((out[3] == 2).all()) and out[1].shape == (4, 2, 10)


def test_form_argument_and_counters():
    assert dc.SharedMemoryPlan(None, 0, thread=True).form == 2
    assert {"fused_nuts_dc:thread", "fused_nuts_dc:registers"} <= set(dc.LAUNCHES)


# ---- the slice against the JAX package ----

C, S = 13, 16
# the tracked configuration's pack and restart_every; a budget that cuts
# some chains short (measured: 5 of 13 fall short, at 10 to 15 transitions)
PACKED = dict(num_steps=S, max_num_doublings=6, seed=7, chunk=16, pack=4, restart_every=16,
              budget=512)
TOL = 1e-5
AGREE_FLOOR = 0.9  # tests/test_torch_fused_nuts_dc.py::AGREE_FLOOR


@pytest.fixture(scope="module")
def packed_runs():
    x0 = (0.5 * np.random.default_rng(15).standard_normal((C, 10))).astype(np.float32)
    ref_target = ref_dc.make_eight_schools_target_dc()
    # one compiled program, at XLA's optimization level 0 and with its older
    # fusion emitters (a quicker compile and run of the unrolled leaves)
    run_ref = jax.jit(lambda x, imm: ref.fused_nuts_run_dc(
        x, imm, 0.2, target=ref_target, num_track=10, interpret=True, **PACKED),
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_cpu_use_fusion_emitters": False})
    out_ref = run_ref(jnp.asarray(x0), jnp.ones(10))
    out_port = dc.fused_nuts_run_dc(torch.from_numpy(x0), torch.ones(10), 0.2,
                                    target=make_eight_schools_target_dc(), num_track=10,
                                    **PACKED)
    return out_ref, out_port


def test_packed_budget_flags_the_reference_chains(packed_runs):
    """Same steps per chain (so the same chains flagged short), and the
    same gradient total."""
    out_ref, out_port = packed_runs
    steps = out_port[3].numpy()
    np.testing.assert_array_equal(steps, np.asarray(out_ref[3]))
    assert 0 < (steps < S).sum() < C, "the budget should bind for some chains"
    assert float(out_port[2]) == float(out_ref[2])
    for c in range(C):
        assert (out_port[1][c, steps[c]:] == 0).all()


def test_packed_chains_agree_with_the_pallas_kernel(packed_runs):
    from test_torch_fused_nuts_dc import agreeing_chains

    out_ref, out_port = packed_runs
    assert agreeing_chains(out_ref, out_port, TOL).mean() >= AGREE_FLOOR


# ---- the tracked path, small: warmup, the machine, ESS ----

# 256 chains x 60 transitions (the second half's 7,680 draws, more than 64 x
# 100 gave): the plain machine's lockstep loop costs by transitions, not by
# chains, so this is 2.1 times quicker on the CPU
WARMUP, CHAINS, TRANSITIONS = 200, 256, 60


@pytest.fixture(scope="module")
def path_run():
    model = eight_schools_noncentered()
    warmup = blackjax_tpu_torch.window_adaptation(
        nuts, model.logdensity_fn,
        adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}))
    (_, params), _ = warmup.run(torch.Generator().manual_seed(15), torch.zeros(10), WARMUP)
    to_dc, _ = eight_schools_dc_perm()
    x0 = 0.1 * np.random.default_rng(15).standard_normal((CHAINS, 10))
    step, imm = params["step_size"], params["inverse_mass_matrix"]
    fx, hist, grads, steps = dc.fused_nuts_run_dc(
        torch.from_numpy(x0[:, to_dc]).float(), imm[torch.from_numpy(to_dc)], step,
        target=make_eight_schools_target_dc(), num_steps=TRANSITIONS, max_num_doublings=10,
        seed=7, num_track=10, pack=4, restart_every=16, chunk=256,
        budget=160 * TRANSITIONS * 4)
    return dict(step=step, imm=imm, fx=fx, hist=hist, grads=grads, steps=steps,
                ess=blackjax_tpu_torch.ess(hist.double()))


def test_path_completes_and_is_finite(path_run):
    assert 0.0 < path_run["step"] < 2.0
    assert bool((path_run["imm"] > 0).all())
    assert bool((path_run["steps"] == TRANSITIONS).all())
    assert path_run["hist"].shape == (CHAINS, TRANSITIONS, 10)
    for name in ("fx", "hist", "ess"):
        assert bool(torch.isfinite(path_run[name]).all()), name
    expected = np.asarray(jax.jit(jdiag.effective_sample_size)(
        jnp.asarray(path_run["hist"].double().numpy())))
    np.testing.assert_allclose(path_run["ess"].numpy(), expected, rtol=1e-10)


@pytest.mark.parametrize("name, column", [("mu", 8), ("log_tau", 9)])
def test_path_moments_match_the_reference_nuts(path_run, name, column):
    """The second half's mean within 0.15 posterior sd of the JAX package's
    NUTS, and its variance within [0.7, 1.4] of it: 256 chains x 30 draws
    carry a Monte Carlo error of under 0.05 sd in the mean."""
    mean, var, _ = REFERENCE[name]
    v = path_run["hist"][:, TRANSITIONS // 2:, column].double()
    assert abs(float(v.mean()) - mean) <= 0.15 * var**0.5
    assert 0.7 <= float(v.var()) / var <= 1.4


def test_chip_smoke_bands_are_the_reference():
    """chip_smoke.py phase 15's constants are reference_bands' numbers."""
    import chip_smoke

    assert chip_smoke.ES_REFERENCE == REFERENCE


def reference_bands(num_warmup=1000, num_chains=128, num_samples=2000, seed=15):
    """The JAX package's NUTS posterior of mu and log_tau on non-centered
    eight schools: ``window_adaptation(nuts)`` from zeros (``num_warmup``
    steps), then its generic NUTS on ``num_chains`` chains from ``0.1 N(0,
    I)`` for ``num_samples`` transitions; mean, variance and the mean's MCSE
    over the second half."""
    from blackjax_tpu.adaptation.window_adaptation import window_adaptation
    from blackjax_tpu.mcmc import nuts as jnuts

    target = jeight_schools()
    warm_key, pos_key, sample_key = jax.random.split(jax.random.key(seed), 3)
    results, _ = window_adaptation(jnuts, target.logdensity_fn).run(
        warm_key, jnp.zeros(10), num_warmup)
    algo = blackjax_tpu.nuts(target.logdensity_fn, **results.parameters)
    states = jax.vmap(algo.init)(0.1 * jax.random.normal(pos_key, (num_chains, 10)))

    @jax.jit
    def run(states, keys):
        def one(states, ks):
            states, infos = jax.vmap(algo.step)(ks, states)
            return states, (states.position[:, :2], infos.num_integration_steps)

        return jax.lax.scan(one, states, keys)

    _, (hist, leaves) = run(states, jax.random.split(sample_key, (num_samples, num_chains)))
    half = np.asarray(hist[num_samples // 2:])  # (samples, chains, [mu, log_tau])
    ess = np.asarray(jdiag.effective_sample_size(jnp.asarray(half.swapaxes(0, 1))))
    for i, name in enumerate(("mu", "log_tau")):
        v = half[..., i]
        print(f'"{name}": ({v.mean():.5f}, {v.var():.5f}, {v.std() / np.sqrt(ess[i]):.5f}), '
              f"ESS {ess[i]:.1f}")
    print(f"warmup: step size {float(results.parameters['step_size']):.5f}; mean leaves per "
          f"transition {float(np.asarray(leaves).mean()):.2f}; settings: num_warmup={num_warmup}, "
          f"num_chains={num_chains}, num_samples={num_samples}, seed={seed}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    reference_bands()
