"""The port's MEADS warmup (``adaptation.meads_adaptation``) and GHMC's
per-chain parameters against the JAX package, in float64 on the same keys
(``interop.prng_key``) and numpy-seeded inputs:

- ``maximum_eigenvalue`` in its Gram form (``n <= d``) and its covariance
  form (``n > d``), and four folds at once as one batched product, within
  1e-12;
- ``base``'s ``init`` and ``update``: only the neighbour fold's slot is
  written, and the last fold wraps to the first;
- one GHMC transition per chain with its own step size, momentum scale
  ``(d,)``, ``alpha`` and ``delta`` (the port's ``_per_chain_diagonal``)
  against ``jax.vmap(ghmc_kernel)``, at C = d, where a ``(C,)`` parameter
  broadcast over the last axis would go unnoticed;
- ``meads_adaptation(...).run`` on ``ill_conditioned_gaussian(8)``, 64
  chains, 40 steps, for 4 folds (the covariance form, ten reshuffles, every
  frozen fold), one fold, and MEADS-LRD at ``k = 3`` with the window opening
  at step 20: every step's per-fold parameters and every chain's position,
  and the final states and parameters, within 1e-10 (the LRD payload as its
  operator ``U diag(lam) U^T``: ``eigh``'s columns carry arbitrary signs);
  the LRD run's ``eigh`` is called on the window's steps and at the end
  only, and the rank's clamp outlives the call, as the reference's does;
- the validation errors, and phase 21's bands are
  ``tools/meads_reference.py``'s numbers.

The JAX side is compiled once for the module, as one program, at XLA's
optimization level 0 with the older CPU fusion emitters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from blackjax_tpu.adaptation import meads_adaptation as jmeads  # noqa: E402
from blackjax_tpu.mcmc import ghmc as jghmc  # noqa: E402
from blackjax_tpu.models.targets import ill_conditioned_gaussian as jtarget  # noqa: E402
from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.adaptation import meads_adaptation as meads  # noqa: E402
from blackjax_tpu_torch.mcmc import ghmc  # noqa: E402
from blackjax_tpu_torch.models.targets import ill_conditioned_gaussian  # noqa: E402
from tools import meads_reference  # noqa: E402

C, D, STEPS = 64, 8, 40
TOL = 1e-10
SETTINGS = {
    "folds4": {},
    "folds1": {"num_folds": 1},
    "lrd": {"low_rank_rank": 3},
}
PER_FOLD = ("step_size", "position_sigma", "alpha", "delta")


def jit(fn, **kwargs):
    """``jax.jit`` at XLA's optimization level 0, with XLA's older CPU fusion
    emitters (a third less compile time here)."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_cpu_use_fusion_emitters": False}, **kwargs)


def _close(got, expected, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(np.asarray(got.cpu() if torch.is_tensor(got) else got,
                                          dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), rtol=rtol, atol=atol)


def _x0(c=C, d=D):
    return 2.0 * np.random.default_rng(3).standard_normal((c, d))


def _key(seed):
    return interop.prng_key(jax.random.key_data(jax.random.key(seed)))


# ---------------------------------------------------------------------------
# the estimator and the controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 6, 10), (4, 16, 8)])  # the Gram form, the covariance form
def test_maximum_eigenvalue_matches_both_forms(shape):
    x = np.random.default_rng(1).standard_normal(shape) * np.linspace(0.5, 2.0, shape[-1])
    if shape[0] == 1:  # one (n, d) batch
        x = x[0]
        got = meads.maximum_eigenvalue(torch.from_numpy(x))
        expected = jit(jmeads.maximum_eigenvalue)(jnp.asarray(x))
    else:  # four folds as one batched product, the reference's vmap over them
        got = meads.maximum_eigenvalue(torch.from_numpy(x))
        expected = jit(jax.vmap(jmeads.maximum_eigenvalue))(jnp.asarray(x))
    assert got.shape == x.shape[:-2]
    _close(got, expected, 1e-12, 0)
    # both forms estimate the same number
    flat = torch.from_numpy(x.reshape(-1, shape[-1]))
    gram = flat @ flat.T
    cov_form = meads.maximum_eigenvalue(flat)
    n = flat.shape[0]
    gram_form = ((gram**2).sum() - (gram.diagonal() ** 2).sum()) / (n * (n - 1)) / (
        gram.diagonal().sum() / n)
    _close(cov_form, gram_form, 1e-12, 0)


def _ensemble(scale=1.0):
    x = scale * _x0()
    grads = -x / ill_conditioned_gaussian(D).std**2
    return x, grads


def _base_reference():
    """The reference's ``init`` on the ensemble, then ``update`` at step 5
    from fold 1 and from fold 3 on the ensemble times 3: at step 5 the
    damping's floor does not bind, so alpha moves with the step size (at
    step 0 it is 1 - exp(-2) whatever the ensemble)."""
    ref_init, ref_update = jmeads.base(num_folds=4)

    def fn(x, g, x3, g3):
        state = ref_init(x, g)
        state5 = state._replace(current_iteration=5)
        return state, [ref_update(state5, x3, g3, source) for source in (1, 3)]

    return fn, tuple(jnp.asarray(a) for a in (*_ensemble(), *_ensemble(3.0)))


def test_base_init_and_update_match_the_reference(reference):
    init, update = meads.base(num_folds=4)
    x, g = _ensemble()
    state = init(torch.from_numpy(x), torch.from_numpy(g))
    ref_state, ref_updates = reference["base"]
    assert state.current_iteration == 0 and state.position_sigma.shape == (4, D)
    for field in PER_FOLD:
        _close(getattr(state, field), getattr(ref_state, field), 1e-12, 0)
    state = state._replace(current_iteration=5)
    x3, g3 = _ensemble(3.0)
    # the neighbour, and the last fold wraps to the first
    for (source, written), ref_new in zip(((1, 2), (3, 0)), ref_updates):
        new = update(state, torch.from_numpy(x3), torch.from_numpy(g3), source)
        assert new.current_iteration == 6
        for field in PER_FOLD:
            got = getattr(new, field)
            _close(got, getattr(ref_new, field), 1e-12, 0)
            changed = (got != getattr(state, field)).reshape(4, -1).any(1)
            assert changed.tolist() == [fold == written for fold in range(4)], field


# ---------------------------------------------------------------------------
# GHMC with per-chain parameters
# ---------------------------------------------------------------------------


def _ghmc_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((D, D))
    step_sizes, alphas = rng.uniform(0.1, 0.5, D), rng.uniform(0.1, 0.9, D)
    scales, deltas = rng.uniform(0.5, 2.0, (D, D)), rng.uniform(0.05, 0.5, D)
    return x, step_sizes, scales, alphas, deltas


GHMC_INIT_KEY, GHMC_KEY, GHMC_STEPS = 2, 4, 3


def _ghmc_reference():
    """Three transitions of ``jax.vmap(ghmc_kernel)`` over per-chain
    parameters (``meads_adaptation.py:387`` of the reference), from
    ``vmap(ghmc.init)``."""
    logdensity = jtarget(D).logdensity_fn
    kernel = jghmc.build_kernel()

    def fn(keys, init_keys, x, step_sizes, scales, alphas, deltas):
        def step(states, key):
            states, info = jax.vmap(kernel, in_axes=(0, 0, None, 0, 0, 0, 0))(
                jax.random.split(key, D), states, logdensity, step_sizes, scales, alphas,
                deltas)
            return states, (states, info.acceptance_rate)

        states = jax.vmap(lambda p, k: jghmc.init(p, logdensity, k))(x, init_keys)
        return jax.lax.scan(step, states, keys)[1]

    return fn, (jax.random.split(jax.random.key(GHMC_KEY), GHMC_STEPS),
                jax.random.split(jax.random.key(GHMC_INIT_KEY), D),
                *(jnp.asarray(a) for a in _ghmc_inputs()))


def test_per_chain_ghmc_matches_the_reference_s_vmap(reference):
    """C = d = 8: a (C,) alpha broadcast over the last axis instead of the
    chains would have the right shape and the wrong values."""
    x, step_sizes, scales, alphas, deltas = (torch.from_numpy(a) for a in _ghmc_inputs())
    ref_states, ref_accepts = reference["ghmc"]
    keys = interop.prng_key(jax.random.key_data(
        jax.random.split(jax.random.key(GHMC_KEY), GHMC_STEPS)))
    init_keys = prng.split(interop.prng_key(jax.random.key_data(jax.random.key(GHMC_INIT_KEY))), D)
    logdensity = ill_conditioned_gaussian(D).logdensity_fn
    states = ghmc.init(x, logdensity, init_keys)
    step = ghmc.build_kernel()
    metric = ghmc._per_chain_diagonal(scales)
    for i, key in enumerate(prng.split(keys, D)):
        states, info = step(key, states, logdensity, step_sizes, metric, alphas, deltas)
        for field in ("position", "momentum", "logdensity", "slice"):
            _close(getattr(states, field), getattr(ref_states, field)[i], 1e-12, 1e-12)
        _close(info.acceptance_rate, ref_accepts[i], 1e-12, 1e-12)


# ---------------------------------------------------------------------------
# the warmup, step by step
# ---------------------------------------------------------------------------


def _reference_run(name):
    """The reference's run of setting ``name``."""
    def fn(key, x):
        warmup = jmeads.meads_adaptation(jtarget(D).logdensity_fn, C, **SETTINGS[name])
        return warmup.run(key, x, STEPS)

    return fn, (jax.random.key(5), jnp.asarray(_x0()))


@pytest.fixture(scope="module")
def reference():
    """The module's reference results, compiled as one program (a fifth
    less compile time here than one program each)."""
    tasks = {"base": _base_reference(), "ghmc": _ghmc_reference(),
             **{name: _reference_run(name) for name in SETTINGS}}
    return jit(lambda args: {name: fn(*args[name]) for name, (fn, _) in tasks.items()})(
        {name: args for name, (_, args) in tasks.items()})


@pytest.fixture(scope="module")
def runs(reference):
    out = {}
    calls = []
    eigh = meads.sample_covariance_eigh_low_rank
    for name in SETTINGS:
        meads.sample_covariance_eigh_low_rank = lambda *a: calls.append(a[1]) or eigh(*a)
        try:
            warmup = meads.meads_adaptation(ill_conditioned_gaussian(D).logdensity_fn, C,
                                            **SETTINGS[name])
            port = warmup.run(_key(5), torch.from_numpy(_x0()), STEPS)
        finally:
            meads.sample_covariance_eigh_low_rank = eigh
        out[name] = (reference[name], port, [float(n) for n in calls])
        calls.clear()
    return out


def _operator(payload):
    U, lam = (np.asarray(a.numpy() if torch.is_tensor(a) else a) for a in payload[1:])
    return (U * lam) @ U.T


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_run_follows_the_reference_step_by_step(runs, name):
    ((ref_states, ref_params), ref_info), ((states, params), info), eigh_counts = runs[name]
    assert info.state.position.shape == (STEPS, C, D)
    for field in PER_FOLD:
        _close(getattr(info.adaptation_state, field), getattr(ref_info.adaptation_state, field))
    np.testing.assert_array_equal(info.adaptation_state.current_iteration.numpy(),
                                  np.arange(1, STEPS + 1))
    # every chain at every step, the reshuffles and frozen folds among them
    _close(info.state.position, ref_info.state.position)
    _close(info.info.acceptance_rate, ref_info.info.acceptance_rate)
    np.testing.assert_array_equal(info.info.is_accepted.numpy(),
                                  np.asarray(ref_info.info.is_accepted))
    for field in states._fields:
        _close(getattr(states, field), getattr(ref_states, field))
    for key in ("step_size", "alpha", "delta"):
        assert params[key].shape == ()
        _close(params[key], ref_params[key])
    scale, ref_scale = params["momentum_inverse_scale"], ref_params["momentum_inverse_scale"]
    if name == "lrd":
        _close(scale.sigma, ref_scale.sigma)
        _close(scale.lam, ref_scale.lam)
        _close(_operator(scale), _operator(ref_scale))
        # the window opens at step 20: eigh on its 20 steps (the pooled count
        # C, 2C, ..., past the 2d gate from the first) and once at the end
        assert eigh_counts == [C * (i + 1) for i in range(STEPS // 2)] + [C * STEPS // 2]
        assert not bool((scale.lam == 1.0).all())
    else:
        assert eigh_counts == []
        _close(scale, ref_scale)
    if name == "folds4":  # a frozen fold keeps its chains: fold 0 at step 0
        unmoved = (info.state.position[0] == torch.from_numpy(_x0())).all(1)
        assert unmoved.tolist() == [c < C // 4 for c in range(C)]


def test_the_rank_clamp_outlives_the_call():
    """``run`` clamps the rank to d through ``nonlocal``
    (``meads_adaptation.py:589-595`` of the reference), so a later run at a
    larger d keeps the smaller rank."""
    warmup = meads.meads_adaptation(lambda x: -0.5 * (x**2).sum(-1), 16, low_rank_rank=6)
    (_, small), _ = warmup.run(_key(1), torch.zeros(16, 4, dtype=torch.float64), 2)
    (_, large), _ = warmup.run(_key(1), torch.ones(16, 10, dtype=torch.float64), 2)
    assert small["momentum_inverse_scale"].U.shape == (4, 4)
    assert large["momentum_inverse_scale"].U.shape == (10, 4)


def test_a_generator_seeds_the_run_and_float32_stays_float32():
    warmup = meads.meads_adaptation(lambda x: -0.5 * (x**2).sum(-1), 8, num_folds=2)
    (states, params), info = warmup.run(torch.Generator().manual_seed(0),
                                        torch.zeros(8, 3, dtype=torch.float32), 4)
    assert states.position.dtype == torch.float32 and params["alpha"].dtype == torch.float32
    assert bool(torch.isfinite(states.position).all())


# ---------------------------------------------------------------------------
# guards and phase 21's bands
# ---------------------------------------------------------------------------


def _logdensity(x):
    return -0.5 * (x**2).sum(-1)


@pytest.mark.parametrize("num_chains, kwargs, match", [
    (10, {"num_folds": 4}, "divisible by num_folds"),
    (8, {"num_folds": 0}, "num_folds must be >= 1"),
    (1, {"num_folds": 1, "low_rank_rank": 3}, "num_chains - 1 >= 1"),
    (8, {"low_rank_rank": 3, "low_rank_window_fraction": 1.5}, "window_fraction"),
])
def test_validation_errors_are_the_reference_s(num_chains, kwargs, match):
    with pytest.raises(ValueError, match=match):
        meads.meads_adaptation(_logdensity, num_chains, **kwargs)
    with pytest.raises(ValueError, match=match):
        jmeads.meads_adaptation(_logdensity, num_chains, **kwargs)


def test_what_is_not_ported_raises():
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        meads.meads_adaptation(_logdensity, 8, axis_name="chains")
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        meads.base(axis_name="chains")
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        meads.maximum_eigenvalue(torch.zeros(4, 2), axis_name="chains")
    warmup = meads.meads_adaptation(_logdensity, 4)
    with pytest.raises(ValueError, match="queue 1, item 11"):
        warmup.run(_key(0), torch.zeros(4), 2)
    with pytest.raises(AssertionError, match="chain count"):
        warmup.run(_key(0), torch.zeros(8, 2), 2)


def test_chip_smoke_bands_are_the_reference():
    """chip_smoke.py phase 21's bands are tools/meads_reference.py's output,
    each three times the three keys' spread or 5 % of their mean."""
    recorded = meads_reference.RECORDED
    assert recorded is not None
    assert set(chip_smoke.MEADS_REFERENCE) == set(meads_reference.NAMES)
    for name in meads_reference.NAMES:
        assert len(recorded[name]) == meads_reference.NUM_KEYS
        assert tuple(recorded[f"{name}_band"]) == meads_reference.band(recorded[name])
        assert chip_smoke.MEADS_REFERENCE[name] == tuple(recorded[f"{name}_band"])
