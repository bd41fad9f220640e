"""The port's warmup pieces against the JAX package, exactly, in f64.

Dual averaging, the step-size controllers, Welford's estimator, the
mass-matrix windows, Stan's schedule and the staged engine are
deterministic: the same inputs, made with numpy, go through both packages
and agree to rtol 1e-12 (the port keeps the step-size state in Python
doubles, the reference in f64 arrays; the sums are taken in another order).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.adaptation import mass_matrix as jmm  # noqa: E402
from blackjax_tpu.adaptation import metric_recipes as jrecipes  # noqa: E402
from blackjax_tpu.adaptation import staged_adaptation as jstaged  # noqa: E402
from blackjax_tpu.adaptation import step_size as jstep  # noqa: E402
from blackjax_tpu.optimizers import dual_averaging as jda  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch.adaptation import mass_matrix, metric_recipes, staged_adaptation, step_size  # noqa: E402
from blackjax_tpu_torch.mcmc import nuts  # noqa: E402
from blackjax_tpu_torch.optimizers import dual_averaging  # noqa: E402

RTOL = 1e-12
D = 5


def _close(got, expected):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(expected),
                               rtol=RTOL, atol=1e-14)


def test_dual_averaging_sequence():
    grads = np.random.default_rng(0).normal(0.0, 0.3, 60)
    j_init, j_update, j_final = jda.dual_averaging(t0=7, gamma=0.1, kappa=0.6)
    t_init, t_update, t_final = dual_averaging.dual_averaging(t0=7, gamma=0.1, kappa=0.6)
    js, ts = j_init(0.3), t_init(0.3)
    for g in grads:
        js, ts = j_update(js, g), t_update(ts, g)
        for a, b in zip(ts, js):
            _close(a, b)
    _close(t_final(ts), j_final(js))


def test_dual_averaging_adaptation_sequence():
    rates = np.random.default_rng(1).uniform(0.2, 1.0, 80)
    j_init, j_update, j_final = jstep.dual_averaging_adaptation(0.8)
    t_init, t_update, t_final = step_size.dual_averaging_adaptation(0.8)
    js, ts = j_init(1.0), t_init(1.0)
    for r in rates:
        js, ts = j_update(js, r), t_update(ts, r)
        for a, b in zip(ts, js):
            _close(a, b)
    _close(t_final(ts), j_final(js))


class _Info:
    def __init__(self, acceptance_rate):
        self.acceptance_rate = acceptance_rate


@pytest.mark.parametrize("initial", [1e-3, 1.0, 40.0])
def test_find_reasonable_step_size(initial):
    """A kernel whose acceptance falls with the step size: both searches
    double or halve to the same crossing."""

    def j_generator(eps):
        return lambda key, state: (state, _Info(jnp.exp(-eps / 2.0)))

    def t_generator(eps):
        return lambda generator, state: (state, _Info(torch.tensor([math.exp(-eps / 2.0)])))

    expected = jstep.find_reasonable_step_size(jax.random.key(0), j_generator, None, initial)
    got = step_size.find_reasonable_step_size(torch.Generator(), t_generator, None, initial)
    _close(got, expected)


def test_bisection_monotonic_fn():
    rng = np.random.default_rng(2)
    j_update = jstep.bisection_monotonic_fn(0.7)
    t_update = step_size.bisection_monotonic_fn(0.7)
    js = (jnp.array([-jnp.inf, jnp.inf]), False)
    ts = ((-math.inf, math.inf), False)
    eps_j = eps_t = 1.0
    for _ in range(12):
        rate = 0.7 + rng.normal(0.0, 0.2) * math.exp(-abs(math.log(eps_t)))
        js, eps_j = j_update(js, eps_j, rate)
        ts, eps_t = t_update(ts, eps_t, rate)
        _close(ts[0], js[0])
        assert ts[1] == bool(js[1])
        _close(eps_t, eps_j)


@pytest.mark.parametrize("diagonal", [True, False])
def test_welford_matches_reference(diagonal):
    rng = np.random.default_rng(3)
    j_init, j_update, j_final = jmm.welford_algorithm(diagonal)
    t_init, t_update, t_final = mass_matrix.welford_algorithm(diagonal)
    js, ts = j_init(D), t_init(D, dtype=torch.float64)
    for batch in [None, 4, 1, 7, None, 3]:  # None: one (d,) draw
        value = rng.normal(1.0, 2.0, (D,) if batch is None else (batch, D))
        js, ts = j_update(js, jnp.asarray(value)), t_update(ts, torch.from_numpy(value))
        _close(ts.mean, js.mean)
        _close(ts.m2, js.m2)
        assert ts.sample_size == int(js.sample_size)
    for a, b in zip(t_final(ts), j_final(js)):
        _close(a, b)


@pytest.mark.parametrize("diagonal", [True, False])
@pytest.mark.parametrize("shrinkage", [0.0, 3.0])
def test_mass_matrix_windows_match_reference(diagonal, shrinkage):
    rng = np.random.default_rng(4)
    j_init, j_update, j_final = jmm.mass_matrix_adaptation(diagonal, shrinkage)
    t_init, t_update, t_final = mass_matrix.mass_matrix_adaptation(diagonal, shrinkage)
    scale = rng.uniform(0.5, 3.0, D)
    js, ts = j_init(D), t_init(D, dtype=torch.float64)
    for window in range(2):
        for _ in range(6):
            value = rng.normal(0.0, 1.0, (3, D)) * scale
            js = j_update(js, jnp.asarray(value))
            ts = t_update(ts, torch.from_numpy(value))
        js, ts = j_final(js), t_final(ts)
        _close(ts.inverse_mass_matrix, js.inverse_mass_matrix)
        assert ts.wc_state.sample_size == 0
    assert ts.inverse_mass_matrix.dim() == (1 if diagonal else 2)


@pytest.mark.parametrize("num_steps", [10, 19, 20, 150, 400, 1000])
def test_build_schedule_matches_reference(num_steps):
    got = staged_adaptation.build_schedule(num_steps)
    expected = np.asarray(jstaged.build_schedule(num_steps)).astype(np.int64)
    assert got.shape == (num_steps, 2)
    np.testing.assert_array_equal(got.numpy(), expected.reshape(num_steps, 2))


@pytest.mark.parametrize("n_chains", [1, 6])
def test_staged_engine_on_a_fixed_sequence(n_chains):
    """``update`` and ``final`` fed one fixed sequence of positions,
    gradients, acceptance rates and stages: the step size, the dual-averaging
    state and the inverse mass matrix agree at every step."""
    num_steps = 150
    pooled = n_chains > 1
    rng = np.random.default_rng(5)
    scale = rng.uniform(0.3, 2.0, D)
    j_core = jrecipes.lookup_recipe("welford_diag").build_core()
    t_core = metric_recipes.lookup_recipe("welford_diag").build_core()
    j_init, j_update, j_final = jstaged._make_engine(
        j_core, target_acceptance_rate=0.8, pool_acceptance=pooled
    )
    t_init, t_update, t_final = staged_adaptation._make_engine(
        t_core, target_acceptance_rate=0.8, pool_acceptance=pooled
    )
    j_update = jax.jit(j_update)
    x0 = np.zeros(D)
    js, ts = j_init(jnp.asarray(x0), 1.0), t_init(torch.from_numpy(x0)[None], 1.0)
    schedule = np.asarray(jstaged.build_schedule(num_steps))
    for stage in schedule:
        x = rng.normal(0.0, 1.0, (n_chains, D)) * scale
        g = rng.normal(0.0, 1.0, (n_chains, D))
        rate = rng.uniform(0.3, 1.0, n_chains)
        if pooled:
            jx, jg, jr = jnp.asarray(x), jnp.asarray(g), jnp.asarray(rate)
        else:
            jx, jg, jr = jnp.asarray(x[0]), jnp.asarray(g[0]), jnp.asarray(rate[0])
        js = j_update(js, (jnp.asarray(stage[0]), jnp.asarray(stage[1])), jx, jg, jr)
        ts = t_update(ts, tuple(int(v) for v in stage), torch.from_numpy(x),
                      torch.from_numpy(g), torch.from_numpy(rate))
        for a, b in zip(ts.ss_state, js.ss_state):
            _close(a, b)
        _close(ts.step_size, js.step_size)
        _close(ts.inverse_mass_matrix, js.inverse_mass_matrix)
    for a, b in zip(t_final(ts), j_final(js)):
        _close(a, b)


def test_recipe_registry():
    assert set(metric_recipes.REGISTRY) == {
        "welford_diag", "welford_dense", "fisher_low_rank", "fisher_low_rank_accumulating",
        "sample_cov_low_rank", "draws_svd_low_rank",
    }
    assert metric_recipes.lookup_recipe("welford_dense").provides_dense
    with pytest.raises(ValueError, match="'fisher_diag' is not yet ported"):
        metric_recipes.lookup_recipe("fisher_diag")
    with pytest.raises(ValueError, match="Unknown metric recipe 'bogus'"):
        metric_recipes.lookup_recipe("bogus")
    with pytest.raises(ValueError, match="outside"):
        metric_recipes.MetricRecipe("x", None, needs=frozenset({"hessians"}))


def _logdensity(x):
    return -0.5 * (x**2).sum(-1)


@pytest.mark.parametrize(
    "kw, error, match",
    [
        (dict(initial_inverse_mass_matrix=np.eye(4)), ValueError, "wrong number of dimensions"),
        (dict(is_mass_matrix_diagonal=False, initial_inverse_mass_matrix=np.ones(4)),
         ValueError, "wrong number of dimensions"),
        (dict(imm_shrinkage_to_previous=-1.0), ValueError, "imm_shrinkage"),
    ],
)
def test_window_adaptation_argument_checks(kw, error, match):
    import blackjax_tpu
    from blackjax_tpu.adaptation.window_adaptation import window_adaptation as jwindow

    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    with pytest.raises(error, match=match):
        jwindow(blackjax_tpu.nuts, lambda x: -0.5 * jnp.sum(x**2), **jkw)
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    with pytest.raises(error, match=match):
        blackjax_tpu_torch.window_adaptation(nuts, _logdensity, **tkw)


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(metric="auto", max_grad_budget=1000), "queue 1, item 6"),
        (dict(n_chains=4, axis_name="chains"), "queue 1, item 12"),
        (dict(metric="fisher_diag"), "not yet ported"),
    ],
)
def test_staged_options_not_ported(kw, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        blackjax_tpu_torch.staged_adaptation(nuts, _logdensity, **kw)


def test_single_chain_run_is_a_block_and_checks_its_shape():
    warmup = blackjax_tpu_torch.window_adaptation(
        nuts, _logdensity, max_num_doublings=3,
        adaptation_info_fn=blackjax_tpu_torch.adaptation.base.get_filter_adapt_info_fn(
            info_keys={"acceptance_rate"}
        ),
    )
    g = torch.Generator().manual_seed(0)
    (state, params), info = warmup.run(g, torch.zeros(3, dtype=torch.float64), 12)
    assert state.position.shape == (1, 3)
    assert isinstance(params["step_size"], float) and params["max_num_doublings"] == 3
    assert params["inverse_mass_matrix"].dtype == torch.float64
    assert info.info.acceptance_rate.shape == (12, 1) and info.state.position is None
    with pytest.raises(ValueError, match=r"\(d,\) or \(1, d\)"):
        warmup.run(g, torch.zeros(2, 3, dtype=torch.float64), 4)


def test_interop_carries_warmup_parameters():
    from blackjax_tpu_torch import interop

    ref = {"step_size": jnp.asarray(0.3125), "inverse_mass_matrix": jnp.asarray([1.0, 2.5]),
           "num_integration_steps": 10}
    got = interop.adaptation_parameters(ref, dtype=torch.float32)
    assert got["step_size"] == 0.3125 and got["num_integration_steps"] == 10
    assert got["inverse_mass_matrix"].dtype == torch.float32
    np.testing.assert_array_equal(got["inverse_mass_matrix"].numpy(), [1.0, 2.5])
