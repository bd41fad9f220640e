"""The port's low-rank warmup against the JAX package's, in f64.

- The low-rank metric cores (``fisher_low_rank``, its accumulating
  partial-forget variant, ``sample_cov_low_rank``) on the same stream of
  draws and gradients, and on the reference's own buffers carried over by
  ``interop.low_rank_core_state``: buffers, counters and ``mu*`` to rtol
  1e-12, payloads through the inverse mass matrix they reconstruct
  (``tests/test_torch_metric_estimators.py``).
- The schedule and the buffer capacity exactly.
- ``window_adaptation_low_rank`` statistically: on a correlated 4-dim
  Gaussian, under both buffer policies, the adapted ``M^{-1}`` is near the
  covariance in the directions the payload keeps, and the chain restarts at
  ``mu*``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.adaptation import low_rank_adaptation as jlra  # noqa: E402
from blackjax_tpu.adaptation import metric_recipes as jrecipes  # noqa: E402
from blackjax_tpu.adaptation.staged_adaptation import build_schedule as jbuild_schedule  # noqa: E402,E501
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.adaptation import low_rank_adaptation as lra  # noqa: E402
from blackjax_tpu_torch.adaptation import metric_recipes as recipes  # noqa: E402
from blackjax_tpu_torch.adaptation.staged_adaptation import build_schedule  # noqa: E402
from blackjax_tpu_torch.mcmc import nuts  # noqa: E402
from test_torch_metric_estimators import (  # noqa: E402
    assert_same_payload,
    correlated_draws,
    reconstruct,
)

D = 9
RTOL = 1e-12

CORES = {
    "fisher_low_rank": dict(buffer_size=50, max_rank=3),
    "fisher_low_rank_accumulating": dict(buffer_size=50, max_rank=3, recompute_every=12),
    "sample_cov_low_rank": dict(buffer_size=50, max_rank=3),
}


# the JAX side at XLA's optimization level 0 with its older CPU fusion
# emitters: a quicker compile
OPT0 = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}

def _ref_core(name):
    """The reference's core, its update and final jitted once (each of its
    eager calls would trace both branches of a ``lax.cond`` again)."""
    core = jrecipes.lookup_recipe(name).build_core(**CORES[name])
    return core._replace(update=jax.jit(core.update, compiler_options=OPT0),
                         final=jax.jit(core.final, compiler_options=OPT0))


def _assert_same_state(port_state, ref_state):
    """Buffers, counters and mu* exactly; the payload through M^{-1}."""
    assert_same_payload(port_state.inverse_mass_matrix, ref_state.inverse_mass_matrix)
    np.testing.assert_allclose(port_state.mu_star.numpy(), np.asarray(ref_state.mu_star),
                               rtol=1e-9, atol=1e-12)
    for name in ("draws_buffer", "grads_buffer"):
        np.testing.assert_allclose(getattr(port_state, name).numpy(),
                                   np.asarray(getattr(ref_state, name)), rtol=RTOL)
    for name in ("buffer_idx", "background_split", "recompute_counter"):
        assert getattr(port_state, name) == int(getattr(ref_state, name)), name


@pytest.mark.parametrize("name", sorted(CORES))
def test_core_on_the_same_stream(name):
    """Two windows (34 and 40 draws, the second past the capacity for the
    reset cores' modular writes), with the boundary recompute after each."""
    ref_core = _ref_core(name)
    core = recipes.lookup_recipe(name).build_core(**CORES[name])
    x, g = correlated_draws(74, seed=1)
    rs = ref_core.init(D)
    ps = core.init(D, dtype=torch.float64)
    for window in (slice(0, 34), slice(34, 74)):
        for xi, gi in zip(x[window], g[window]):
            rs = ref_core.update(rs, jnp.asarray(xi), jnp.asarray(gi))
            ps = core.update(ps, torch.from_numpy(xi), torch.from_numpy(gi))
        _assert_same_state(ps, rs)
        rs, ps = ref_core.final(rs), core.final(ps)
        _assert_same_state(ps, rs)


@pytest.mark.parametrize("name", sorted(CORES))
def test_core_final_on_the_reference_buffers(name):
    """The reference's state after a window, carried into the port, gives
    the reference's boundary recompute; a block of chains writes as one."""
    ref_core = _ref_core(name)
    core = recipes.lookup_recipe(name).build_core(**CORES[name])
    x, g = correlated_draws(45, seed=2)
    rs = ref_core.init(D)
    for xi, gi in zip(x[:40], g[:40]):
        rs = ref_core.update(rs, jnp.asarray(xi), jnp.asarray(gi))
    ps = interop.low_rank_core_state(rs)
    _assert_same_state(ps, rs)
    # a (5, d) block overruns the 50-row capacity and is written flush with it
    rs_b = ref_core.update(rs, jnp.asarray(x[40:]), jnp.asarray(g[40:]))
    ps_b = core.update(ps, torch.from_numpy(x[40:]), torch.from_numpy(g[40:]))
    _assert_same_state(ps_b, rs_b)
    _assert_same_state(core.final(ps), ref_core.final(rs))


def test_too_few_draws_keep_the_payload():
    core = recipes.lookup_recipe("fisher_low_rank").build_core(buffer_size=10, max_rank=2)
    state = core.init(3, dtype=torch.float64)
    state = core.update(state, torch.ones(3, dtype=torch.float64),
                        torch.ones(3, dtype=torch.float64))
    out = core.final(state)
    assert torch.equal(out.inverse_mass_matrix.sigma, torch.ones(3, dtype=torch.float64))
    assert out.buffer_idx == 0 and not out.draws_buffer.any()


def test_seed_sigma_and_shift():
    ref_state = jrecipes._low_rank_init(D, 6, 2)
    grad = np.random.default_rng(3).standard_normal(D) * np.logspace(-3, 3, D)
    want = jrecipes.seed_low_rank_sigma_from_grad(ref_state, jnp.asarray(grad))
    got = recipes.seed_low_rank_sigma_from_grad(recipes._low_rank_init(D, 6, 2, dtype=torch.float64),
                                                torch.from_numpy(grad)[None])
    np.testing.assert_allclose(got.inverse_mass_matrix.sigma.numpy(),
                               np.asarray(want.inverse_mass_matrix.sigma), rtol=RTOL)
    buf = np.arange(24.0).reshape(6, 4)
    for shift in (-1, 0, 2, 6, 9):
        np.testing.assert_array_equal(
            recipes._shift_buffer_left(torch.from_numpy(buf), shift).numpy(),
            np.asarray(jrecipes._shift_buffer_left(jnp.asarray(buf), shift)))


@pytest.mark.parametrize("num_steps", [0, 7, 19, 20, 57, 100, 400, 1000, 2500])
def test_growing_window_schedule(num_steps):
    got = lra.build_growing_window_schedule(num_steps)
    want = jlra.build_growing_window_schedule(num_steps)
    assert got.dtype == torch.int64 and got.shape == (num_steps, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(-1, 2))
    kw = dict(early_window=0.2, step_size_window=0.1, early_window_size=7, window_size=40,
              window_growth=2.0)
    np.testing.assert_array_equal(
        lra.build_growing_window_schedule(num_steps, **kw).numpy(),
        np.asarray(jlra.build_growing_window_schedule(num_steps, **kw)).reshape(-1, 2))


@pytest.mark.parametrize("num_steps", [10, 60, 400, 1000, 3000])
def test_accumulating_buffer_capacity(num_steps):
    for port_schedule, ref_schedule in [
        (lra.build_growing_window_schedule(num_steps),
         jlra.build_growing_window_schedule(num_steps)),
        (build_schedule(num_steps), np.asarray(jbuild_schedule(num_steps))),
    ]:
        assert lra._accumulating_buffer_capacity(port_schedule) == \
            jlra._accumulating_buffer_capacity(ref_schedule)


def test_registry_and_argument_checks():
    for name in CORES:
        assert recipes.lookup_recipe(name).emits == "low_rank"
    for kw, match in [(dict(buffer_policy="forget"), "buffer_policy"),
                      (dict(recompute_every=0), "recompute_every")]:
        with pytest.raises(ValueError, match=match):
            jlra.window_adaptation_low_rank(None, None, **kw)
        with pytest.raises(ValueError, match=match):
            lra.window_adaptation_low_rank(None, None, **kw)


COV = np.array([
    [1.0, 0.9, 0.85, 0.0],
    [0.9, 1.0, 0.9, 0.0],
    [0.85, 0.9, 1.0, 0.0],
    [0.0, 0.0, 0.0, 2.0],
])
MEAN = np.array([0.5, -0.5, 1.0, 0.0])


@pytest.mark.parametrize("policy", ["reset", "accumulating"])
def test_window_adaptation_low_rank_recovers_a_correlated_gaussian(policy):
    """The correlated block's eigenvalues (2.75, 0.15, 0.1 of its
    correlation) are informative, so a rank-3 payload holds the whole
    covariance: the adapted M^{-1} is within 35% of it (Frobenius), the step
    size is usable, and the chain restarts at mu*, near the mean."""
    prec = torch.from_numpy(np.linalg.inv(COV))
    mean = torch.from_numpy(MEAN)

    def logdensity(x):
        z = x - mean
        return -0.5 * ((z @ prec) * z).sum(-1)

    kw = {} if policy == "reset" else dict(schedule_fn=lra.build_growing_window_schedule)
    warmup = blackjax_tpu_torch.window_adaptation_low_rank(
        nuts, logdensity, max_rank=3, buffer_policy=policy, max_num_doublings=6, **kw)
    (state, params), info = warmup.run(
        torch.Generator().manual_seed(1), torch.zeros(4, dtype=torch.float64), 400)
    payload = params["inverse_mass_matrix"]
    assert isinstance(payload, blackjax_tpu_torch.mcmc.metrics.LowRankInverseMassMatrix)
    err = np.linalg.norm(reconstruct(payload) - COV) / np.linalg.norm(COV)
    assert err < 0.35, err
    assert 0.2 < params["step_size"] < 2.0
    mu_star = info.adaptation_state.imm_state.mu_star[-1]
    assert state.position.shape == (4,) and torch.equal(state.position, mu_star)
    np.testing.assert_allclose(mu_star.numpy(), MEAN, atol=0.5)
    # the per-step info holds no buffers, and stacks the counters
    assert info.adaptation_state.imm_state.draws_buffer is None
    assert info.adaptation_state.imm_state.buffer_idx.shape == (400,)


def test_gradient_based_init_seeds_sigma():
    scales = torch.tensor([100.0, 1.0, 0.01], dtype=torch.float64)
    logdensity = lambda x: -0.5 * (x**2 * scales).sum(-1)  # noqa: E731
    warmup = blackjax_tpu_torch.window_adaptation_low_rank(
        nuts, logdensity, max_rank=2, gradient_based_init=True, max_num_doublings=4)
    x0 = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float64)
    (_, params), info = warmup.run(torch.Generator().manual_seed(2), x0, 25)
    # the first steps are fast (no recompute yet): the seeded sigma is 1/sqrt(|grad|)
    first = info.adaptation_state.imm_state.inverse_mass_matrix.sigma[0]
    np.testing.assert_allclose(first.numpy(), [0.1, 1.0, 10.0], rtol=1e-12)
    assert torch.isfinite(params["inverse_mass_matrix"].sigma).all()
