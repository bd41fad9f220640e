"""The port's ChEES warmup (``adaptation.chees_adaptation``) and its optax
twin (``optimizers.optax_twins``) against the JAX package and optax, in
float64 on the same keys (``interop.prng_key``), and float32 where said.

- ``optax_twins.adam(0.25)`` with ``apply_updates`` and ChEES's +-1 clip,
  over 200 fixed gradients of a scalar and a vector, bit for bit with
  ``optax.adam(0.25)`` compiled in a ``scan``, as the warmup runs it:
  ``count``, ``mu``, ``nu``, the updates and the parameters, in float64
  (x64) and float32 (JAX without x64).
- ``optax_twins.sgd(0.3)`` without momentum, with momentum 0.9 and with
  Nesterov's, over 200 fixed gradients, bit for bit with ``optax.sgd``
  compiled in a ``scan``: the updates, the trace and the parameters, in
  float64 and float32. The reference applies the updates through a clip
  that never binds (+-1e30): where the update and its application fuse,
  XLA contracts ``p + (-lr) t`` into a fused multiply-add on some lanes of
  a vector and not on others (SVGD's steps hold it to 1e-10 instead).
- ``base``'s ``update`` on fixed inputs within 1e-12: divergent chains, NaN
  and +-inf initial positions, the identity and a diagonal metric, and a
  non-finite candidate that takes each fallback (the step size and
  dual-averaging state; the log length and the Adam state).
- ``chees_adaptation.run`` on ``ill_conditioned_gaussian(10)``, 32 chains, 40
  steps from a step size of 0.01, window fraction 0.5 (the metric engages
  at step 22, the floor refreshes at step 32), for the default,
  ``diagonal`` and ``diagonal`` with ``_length_floor``: every step's
  controller state, every chain's leapfrog counts and final position within
  1e-10 (the positions relative or, near zero, absolute), the parameters.
- A drawn jitter (``jitter_generator``, ``jitter_amount``) on the
  reference's keys: ``fold_in(split(key)[1], i)``, scaled and shifted.
- A restart from the reference's state in the middle of the default run
  (``interop.chees_adaptation_state``), and sampling on from its tuned
  parameters (``interop.chees_parameters``).
- The power iteration, the eigen refresh and ``_apply_length_floor``, as
  ``tests/adaptation/test_chees_internals.py`` holds the reference's.
- Every guard that raises, and phase 20's bands are
  ``tools/chees_reference.py``'s numbers.

The JAX side is compiled once per function, at XLA's optimization level 0
(the optax comparison at the default level, whose fused multiply-adds the
twin reproduces).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import chip_smoke  # noqa: E402
from blackjax_tpu.adaptation import chees_adaptation as jchees  # noqa: E402
from blackjax_tpu.mcmc import dynamic_hmc as jdynamic_hmc  # noqa: E402
from blackjax_tpu.models.targets import ill_conditioned_gaussian as jtarget  # noqa: E402
from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.adaptation import chees_adaptation as chees  # noqa: E402
from blackjax_tpu_torch.mcmc import dynamic_hmc  # noqa: E402
from blackjax_tpu_torch.models.targets import ill_conditioned_gaussian  # noqa: E402
from blackjax_tpu_torch.optimizers import optax_twins  # noqa: E402
from tools import chees_reference  # noqa: E402

# 40 steps from a step size of 0.01: the window opens at 20, the metric
# engages at 22 (64 draws), the floor refreshes at 32. Rounding differences
# (sums in another order: 1e-14 of an acceptance rate at step 0) stay below
# 1e-11 there; from 0.05 the dual averaging's first step sizes overshoot the
# leapfrog's stability limit (2 sd_min = 0.63), and the same differences grow
# about tenfold in eight steps, to 1e-10 by steps 26-36 (the reference
# against itself at two XLA levels drifts likewise).
C, D, STEPS = 32, 10, 40
STEP_SIZE, LR = 0.01, 0.25
TOL = 1e-10
MAX_BITS = 11  # ceil(log2(40 + 1000))
SETTINGS = {
    "default": {},
    "diagonal": {"mass_matrix_estimation": "diagonal"},
    "floor": {"mass_matrix_estimation": "diagonal", "_length_floor": True},
}
CONTROLLER = ("step_size", "log_step_size_moving_average", "trajectory_length",
              "log_trajectory_length_moving_average")


def jit(fn, **kwargs):
    """``jax.jit`` at XLA's optimization level 0."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_cpu_use_fusion_emitters": False}, **kwargs)


def _close(got, expected, rtol=TOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got.cpu() if torch.is_tensor(got) else got,
                                          dtype=np.float64),
                               np.asarray(expected, dtype=np.float64), rtol=rtol, atol=atol)


def _x0(c=C, d=D):
    return 2.0 * np.random.default_rng(3).standard_normal((c, d))


# ---------------------------------------------------------------------------
# the optax twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_adam_is_optax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    npdt, tdt = np.dtype(dtype), getattr(torch, dtype)
    scalar = (rng.standard_normal(200) * 10.0 ** rng.uniform(-3, 3, 200)).astype(npdt)
    vector = (rng.standard_normal((200, 7)) * 10.0 ** rng.uniform(-3, 3, (200, 7))).astype(npdt)

    def reference():
        opt = optax.adam(LR)
        params = (jnp.asarray(0.3, npdt), jnp.zeros(7, npdt))

        def step(carry, g):
            params, state = carry
            updates, state = opt.update(g, state, params)
            updates = jax.tree.map(lambda u: jnp.clip(u, -1.0, 1.0), updates)
            params = optax.apply_updates(params, updates)
            return (params, state), (params, updates, state[0])

        return jax.jit(lambda gs: jax.lax.scan(step, (params, opt.init(params)), gs)[1])(
            (jnp.asarray(scalar), jnp.asarray(vector)))

    if dtype == "float32":
        with jax.enable_x64(False):
            ref_params, ref_updates, ref_state = reference()
    else:
        ref_params, ref_updates, ref_state = reference()
    opt = optax_twins.adam(LR)
    params = (torch.tensor(0.3, dtype=tdt), torch.zeros(7, dtype=tdt))
    state = opt.init(params)
    assert state[0].count.dtype == torch.int32 and isinstance(state[1], optax_twins.EmptyState)
    for i in range(200):
        updates, state = opt.update((torch.tensor(scalar[i]), torch.from_numpy(vector[i])),
                                    state, params)
        updates = tuple(torch.clamp(u, -1.0, 1.0) for u in updates)
        params = optax_twins.apply_updates(params, updates)
        adam = state[0]
        assert int(adam.count) == int(ref_state.count[i])
        for got, expected in ((params, ref_params), (updates, ref_updates), (adam.mu, ref_state.mu),
                              (adam.nu, ref_state.nu)):
            for g, e in zip(got, expected):
                assert g.dtype == tdt
                np.testing.assert_array_equal(g.numpy(), np.asarray(e[i]))


SGD_LR = 0.3
SGD_SETTINGS = [(None, False), (0.9, False), (0.9, True)]


def _sgd_gradients(dtype):
    rng = np.random.default_rng(1)
    npdt = np.dtype(dtype)
    scalar = (rng.standard_normal(200) * 10.0 ** rng.uniform(-3, 3, 200)).astype(npdt)
    vector = (rng.standard_normal((200, 7)) * 10.0 ** rng.uniform(-3, 3, (200, 7))).astype(npdt)
    return scalar, vector


@pytest.fixture(scope="module")
def sgd_reference():
    """``optax.sgd`` in each setting over the same gradients, in a ``scan``:
    one program a dtype."""

    def reference(dtype):
        npdt = np.dtype(dtype)

        def settings(gs):
            out = []
            for momentum, nesterov in SGD_SETTINGS:
                opt = optax.sgd(SGD_LR, momentum=momentum, nesterov=nesterov)
                params = (jnp.asarray(0.3, npdt), jnp.zeros(7, npdt))

                def step(carry, g, opt=opt):
                    params, state = carry
                    updates, state = opt.update(g, state, params)
                    applied = jax.tree.map(lambda u: jnp.clip(u, -1e30, 1e30), updates)
                    params = optax.apply_updates(params, applied)
                    return (params, state), (params, updates, state[0])

                out.append(jax.lax.scan(step, (params, opt.init(params)), gs)[1])
            return out

        scalar, vector = _sgd_gradients(dtype)
        return jax.jit(settings)((jnp.asarray(scalar), jnp.asarray(vector)))

    out = {"float64": reference("float64")}
    with jax.enable_x64(False):
        out["float32"] = reference("float32")
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("setting", range(len(SGD_SETTINGS)),
                         ids=["plain", "momentum", "nesterov"])
def test_sgd_is_optax_bit_for_bit(sgd_reference, dtype, setting):
    momentum, nesterov = SGD_SETTINGS[setting]
    ref_params, ref_updates, ref_state = sgd_reference[dtype][setting]
    tdt = getattr(torch, dtype)
    scalar, vector = _sgd_gradients(dtype)
    opt = optax_twins.sgd(SGD_LR, momentum=momentum, nesterov=nesterov)
    params = (torch.tensor(0.3, dtype=tdt), torch.zeros(7, dtype=tdt))
    state = opt.init(params)
    assert isinstance(state[1], optax_twins.EmptyState)
    assert isinstance(state[0], optax_twins.EmptyState if momentum is None
                      else optax_twins.TraceState)
    for i in range(200):
        updates, state = opt.update((torch.tensor(scalar[i]), torch.from_numpy(vector[i])),
                                    state, params)
        params = optax_twins.apply_updates(params, updates)
        pairs = [(params, ref_params), (updates, ref_updates)]
        if momentum is not None:
            pairs.append((state[0].trace, ref_state.trace))
        for got, expected in pairs:
            for g, e in zip(got, expected):
                assert g.dtype == tdt
                np.testing.assert_array_equal(g.numpy(), np.asarray(e[i]))


# ---------------------------------------------------------------------------
# the controller's update on fixed inputs
# ---------------------------------------------------------------------------


def _base(port):
    if port:
        def jitter(i):
            return dynamic_hmc.halton_sequence(torch.tensor(i), MAX_BITS).double()

        optim = optax_twins.adam(LR)
        module = chees
    else:
        def jitter(i):
            return jdynamic_hmc.halton_sequence(i, MAX_BITS)

        optim = optax.adam(LR)
        module = jchees
    return module.base(jitter, lambda i: i + 1, optim, chees.OPTIMAL_TARGET_ACCEPTANCE_RATE,
                       0.5, 1000)


@pytest.fixture(scope="module")
def reference_update():
    _, update = _base(False)
    return jit(update)


def _update_inputs(case):
    rng = np.random.default_rng(11)
    proposals, momenta, initials = rng.standard_normal((3, C, D))
    acceptance = rng.uniform(0.05, 1.0, C)
    divergent = np.zeros(C, bool)
    divergent[[3, 17]] = True
    proposals[3] = 1e3  # a divergent chain's proposal: masked everywhere
    initials[17, 2] = np.nan  # masked by the nanmean, its chain by the divergence
    imm = rng.uniform(0.2, 3.0, D) if case == "diagonal" else np.ones(D)
    if case == "non-finite":
        # +-inf initial positions count in the nanmean: the criterion's
        # gradient is NaN, and the log length and the Adam state fall back
        initials[6, 0], initials[7, 4] = np.inf, -np.inf
    return proposals, momenta, initials, acceptance, divergent, imm


@pytest.mark.parametrize("case", ["identity", "diagonal", "non-finite"])
def test_base_update_matches_the_reference(reference_update, case):
    init, _ = _base(False)
    port_init, port_update = _base(True)
    state = init(0, STEP_SIZE)
    # a few ordinary updates first, so the Adam and dual-averaging states are
    # not at their starts
    warm = _update_inputs("identity")
    for _ in range(3):
        state = reference_update(state, *(jnp.asarray(v) for v in warm))
    if case == "non-finite":
        # the dual averaging's next log step size is +inf: the step size and
        # its state keep their old values
        state = state._replace(da_state=state.da_state._replace(mu=jnp.asarray(np.inf)))
    inputs = _update_inputs(case)
    expected = reference_update(state, *(jnp.asarray(v) for v in inputs))
    got = port_update(interop.chees_adaptation_state(state),
                      *(torch.from_numpy(v) for v in inputs))
    assert port_init(0, torch.tensor(STEP_SIZE, dtype=torch.float64)).step == 1
    for field in CONTROLLER:
        _close(getattr(got, field), getattr(expected, field), 1e-12, 0)
    for g, e in zip(got.da_state, expected.da_state):
        _close(g, e, 1e-12, 0)
    adam, ref_adam = got.optim_state[0], expected.optim_state[0]
    assert int(adam.count) == int(ref_adam.count)
    _close(adam.mu, ref_adam.mu, 1e-12, 0)
    _close(adam.nu, ref_adam.nu, 1e-12, 0)
    assert got.step == int(expected.step) and got.random_generator_arg == int(
        expected.random_generator_arg)
    if case == "non-finite":
        assert int(adam.count) == int(state.optim_state[0].count)  # the Adam state kept
        _close(got.log_trajectory_length_moving_average,
               0.5 * np.log(np.asarray(state.trajectory_length))
               + 0.5 * np.asarray(state.log_trajectory_length_moving_average), 1e-12, 0)
        _close(got.da_state.log_x, state.da_state.log_x, 0, 0)
        _close(got.step_size, state.step_size, 0, 0)


# ---------------------------------------------------------------------------
# the warmup, step by step
# ---------------------------------------------------------------------------


def _reference_run(name):
    def run(key, x):
        warmup = jchees.chees_adaptation(jtarget(D).logdensity_fn, C, **SETTINGS[name])
        (states, params), info = warmup.run(key, x, STEP_SIZE, optax.adam(LR), STEPS)
        arrays = {k: v for k, v in params.items() if not callable(v)}
        return states, arrays, info

    return jit(run)(jax.random.key(5), jnp.asarray(_x0()))


def _port_run(name):
    warmup = chees.chees_adaptation(ill_conditioned_gaussian(D).logdensity_fn, C,
                                    **SETTINGS[name])
    return warmup.run(interop.prng_key(jax.random.key_data(jax.random.key(5))),
                      torch.from_numpy(_x0()), STEP_SIZE, optax_twins.adam(LR), STEPS)


@pytest.fixture(scope="module")
def runs():
    return {name: (_reference_run(name), _port_run(name)) for name in SETTINGS}


@pytest.mark.parametrize("name", sorted(SETTINGS))
def test_run_follows_the_reference_step_by_step(runs, name):
    (ref_states, ref_params, ref_info), ((states, params), info) = runs[name]
    for field in CONTROLLER:
        _close(getattr(info.adaptation_state, field), getattr(ref_info.adaptation_state, field))
    _close(info.adaptation_state.da_state.log_x, ref_info.adaptation_state.da_state.log_x)
    _close(info.adaptation_state.optim_state[0].mu, ref_info.adaptation_state.optim_state[0].mu)
    np.testing.assert_array_equal(info.info.num_integration_steps.numpy(),
                                  np.asarray(ref_info.info.num_integration_steps))
    np.testing.assert_array_equal(info.info.is_accepted.numpy(),
                                  np.asarray(ref_info.info.is_accepted))
    assert info.state.position.shape == (STEPS, C, D)
    # positions within 1e-10, relative or (near zero, against their O(1)
    # scale) absolute
    _close(states.position, ref_states.position, TOL, TOL)
    _close(info.state.position[STEPS // 2], ref_info.state.position[STEPS // 2], TOL, TOL)
    np.testing.assert_array_equal(states.random_generator_arg.numpy(),
                                  np.asarray(ref_states.random_generator_arg))
    for key in ("step_size", "inverse_mass_matrix"):
        _close(params[key], ref_params[key])
    _close(params["integration_steps_params"][0], ref_params["integration_steps_params"][0])
    engaged = not np.allclose(np.asarray(ref_params["inverse_mass_matrix"]), 1.0)
    assert engaged == (name in ("diagonal", "floor"))


def test_restart_from_the_reference_state(runs):
    """The reference's controller state after step 19 carried into the
    port, which then takes step 20 on the reference's own step-20 inputs;
    and sampling goes on from the reference's tuned parameters."""
    (ref_states, ref_params, ref_info), ((states, params), _) = runs["default"]
    k = 19
    state_k = jax.tree.map(lambda a: a[k], ref_info.adaptation_state)
    _, update = _base(True)
    info = ref_info.info
    got = update(interop.chees_adaptation_state(state_k),
                 *(interop.to_tensor(v) for v in (
                     info.proposal.position[k + 1], info.proposal.momentum[k + 1],
                     ref_info.state.position[k], info.acceptance_rate[k + 1],
                     info.is_divergent[k + 1])), torch.ones(D, dtype=torch.float64))
    expected = jax.tree.map(lambda a: a[k + 1], ref_info.adaptation_state)
    for field in CONTROLLER:
        _close(getattr(got, field), getattr(expected, field), 1e-12, 0)

    converted = interop.chees_parameters(ref_params, params)
    assert set(converted) == set(params)
    key = jax.random.key(9)
    ref_kernel = jdynamic_hmc.build_kernel(
        next_random_arg_fn=lambda i: i + 1,
        integration_steps_fn=lambda i, n: jnp.asarray(
            jnp.ceil(jdynamic_hmc.halton_sequence(i, MAX_BITS) * n), dtype=int))
    ref_next, _ = jit(jax.vmap(lambda k, s: ref_kernel(
        k, s, jtarget(D).logdensity_fn, ref_params["step_size"],
        ref_params["inverse_mass_matrix"], ref_params["integration_steps_params"])))(
        jax.random.split(key, C), ref_states)
    kernel = dynamic_hmc.build_kernel(next_random_arg_fn=converted["next_random_arg_fn"],
                                      integration_steps_fn=converted["integration_steps_fn"])
    port_next, _ = kernel(interop.prng_key(jax.random.key_data(jax.random.split(key, C))),
                          interop.dynamic_hmc_state(ref_states),
                          ill_conditioned_gaussian(D).logdensity_fn, converted["step_size"],
                          converted["inverse_mass_matrix"],
                          converted["integration_steps_params"])
    _close(port_next.position, ref_next.position, TOL, TOL)


def test_halton_jitter_matches_at_the_tracked_bits():
    i = np.arange(2000)
    expected = np.asarray(jax.vmap(lambda j: jdynamic_hmc.halton_sequence(j, MAX_BITS))(
        jnp.asarray(i)))
    got = dynamic_hmc.halton_sequence(torch.from_numpy(i), MAX_BITS)
    np.testing.assert_array_equal(got.double().numpy(), expected)
    assert MAX_BITS == math.ceil(math.log2(1000 + 1000))
    kernel = dynamic_hmc.build_kernel(integration_unroll=4)  # accepted, without effect
    assert callable(kernel)


def test_a_drawn_jitter_follows_the_reference_s_keys():
    """``jitter_generator`` draws from ``fold_in(carry, i)``, ``carry`` the
    second half of ``split(key)`` (``chees_adaptation.py:393-397``): the
    step counts of three steps are ``ceil((u 0.5 + 0.5) n)`` of those draws,
    ``n`` each step's ``integration_steps_params``."""
    key = prng.key(8)
    drawn = chees.chees_adaptation(
        ill_conditioned_gaussian(D).logdensity_fn, 4, jitter_amount=0.5,
        jitter_generator=lambda k: prng.uniform(k, (), torch.float64))
    (_, _), info = drawn.run(key, torch.from_numpy(_x0(4)), STEP_SIZE, optax_twins.adam(LR), 3)
    carry = prng.split(key)[1]
    state = info.adaptation_state
    for i in range(3):
        u = prng.uniform(prng.fold_in(carry, torch.tensor(i)), (), torch.float64)
        length = STEP_SIZE if i == 0 else float(state.trajectory_length[i - 1])
        step_size = STEP_SIZE if i == 0 else float(state.step_size[i - 1])
        expected = math.ceil(float(torch.addcmul(torch.tensor(0.5, dtype=torch.float64), u,
                                                 torch.tensor(0.5, dtype=torch.float64)))
                             * (length / step_size))
        assert (info.info.num_integration_steps[i] == expected).all()


# ---------------------------------------------------------------------------
# the internals
# ---------------------------------------------------------------------------


def test_power_iteration_recovers_the_planted_eigenpair():
    d = 6
    v = np.ones(d) / np.sqrt(d)
    matrix = np.eye(d) + 30.0 * np.outer(v, v)
    lam, vec = chees._power_iteration_lambda_max(
        torch.from_numpy(matrix), chees._eig_state_init(d, dtype=torch.float64).eigenvector, 30)
    ref_lam, ref_vec = jchees._power_iteration_lambda_max(
        jnp.asarray(matrix), jchees._eig_state_init(d).eigenvector, 30)
    _close(lam, 31.0, 1e-6, 0)
    _close(lam, ref_lam, 1e-12, 0)
    _close(vec, ref_vec, 1e-12, 1e-15)
    assert abs(float(vec @ torch.from_numpy(v))) > 0.999


def test_eig_refresh_warm_start_and_whitening():
    d = 8
    rng = np.random.default_rng(2)
    v = rng.standard_normal(d)
    v /= np.linalg.norm(v)
    n = 1000.0
    m2 = (np.eye(d) + 20.0 * np.outer(v, v)) * (n - 1.0)
    cold = chees._recompute_eig_state(n, None, torch.from_numpy(m2),
                                      torch.ones(d, dtype=torch.float64),
                                      chees._eig_state_init(d, dtype=torch.float64), 2)
    warm = chees._recompute_eig_state(n, None, torch.from_numpy(m2),
                                      torch.ones(d, dtype=torch.float64), cold, 2)
    ref_cold = jchees._recompute_eig_state(n, jnp.zeros(d), jnp.asarray(m2), jnp.ones(d),
                                           jchees._eig_state_init(d), 2)
    _close(cold.lambda_max, ref_cold.lambda_max, 1e-12, 0)
    assert abs(float(warm.lambda_max) - 21.0) <= abs(float(cold.lambda_max) - 21.0)
    _close(warm.lambda_max, 21.0, 0.05, 0)
    # whitened by the covariance's own diagonal: a correlation matrix
    diag = np.array([9.0, 4.0, 1.0, 0.25, 16.0])
    state = chees._recompute_eig_state(500.0, None, torch.from_numpy(np.diag(diag) * 499.0),
                                       torch.from_numpy(diag),
                                       chees._eig_state_init(5, dtype=torch.float64), 20)
    _close(state.lambda_max, 1.0, 1e-6, 0)


@pytest.mark.parametrize("length, lam, engaged, enable", [
    (0.5, 4.0, True, True),     # floored: (pi/2) * 2
    (5.0, 4.0, True, True),     # above the floor
    (0.5, 4.0, False, True),    # not engaged: no floor
    (0.5, 1e8, True, True),     # the floor above the cap: capped, flagged
    (0.5, 4.0, True, False),    # disabled
])
def test_apply_length_floor(length, lam, engaged, enable):
    got = chees._apply_length_floor(torch.tensor(length, dtype=torch.float64),
                                    torch.tensor(lam, dtype=torch.float64), engaged, enable, 100,
                                    torch.tensor(0.05, dtype=torch.float64))
    expected = jchees._apply_length_floor(jnp.asarray(length), jnp.asarray(lam),
                                          jnp.asarray(engaged), enable, 100, jnp.asarray(0.05))
    _close(got[0], expected[0], 1e-15, 0)
    assert bool(got[1]) == bool(expected[1])
    if (length, engaged, enable) == (0.5, True, True) and lam == 4.0:
        _close(got[0], chees.CHEES_LENGTH_FLOOR_FACTOR * 2.0, 1e-15, 0)


def test_nanmean_counts_inf_and_masks_nan():
    x = np.array([[1.0, np.nan], [np.inf, 2.0], [3.0, 4.0]])
    got = chees._axis_nanmean(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jchees._axis_nanmean(jnp.asarray(x))))
    assert got[0] == np.inf and got[1] == 3.0


# ---------------------------------------------------------------------------
# guards and phase 20's bands
# ---------------------------------------------------------------------------


def _logdensity(x):
    return -0.5 * (x**2).sum(-1)


@pytest.mark.parametrize("kwargs, error, match", [
    ({"mass_matrix_estimation": "dense"}, ValueError, "mass_matrix_estimation"),
    ({"mass_matrix_estimation": "diagonal", "mass_matrix_window_fraction": 1.5}, ValueError,
     "window_fraction"),
    ({"_length_floor": True}, ValueError, "diagonal"),
    ({"axis_name": "chains"}, NotImplementedError, "queue 1, item 12"),
])
def test_guards_raise(kwargs, error, match):
    with pytest.raises(error, match=match):
        chees.chees_adaptation(_logdensity, 8, **kwargs)
    if error is ValueError:
        with pytest.raises(error, match=match):
            jchees.chees_adaptation(_logdensity, 8, **kwargs)


def test_base_and_run_refuse_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1, item 12"):
        chees.base(None, None, optax_twins.adam(LR), 0.651, 0.5, 10, axis_name="chains")
    warmup = chees.chees_adaptation(_logdensity, 4)
    with pytest.raises(ValueError, match="queue 1, item 11"):
        warmup.run(prng.key(0), torch.zeros(4), 0.1, optax_twins.adam(LR), 2)
    with pytest.raises(AssertionError, match="chain count"):
        warmup.run(prng.key(0), torch.zeros(3, 2), 0.1, optax_twins.adam(LR), 2)


def test_a_generator_seeds_the_run_and_it_stays_on_the_positions_device():
    warmup = chees.chees_adaptation(_logdensity, 8)
    (states, params), info = warmup.run(torch.Generator().manual_seed(0),
                                        torch.zeros(8, 3, dtype=torch.float32), 0.1,
                                        optax_twins.adam(LR), 3)
    assert states.position.dtype == torch.float32 and params["step_size"].dtype == torch.float32
    assert info.info.num_integration_steps.dtype == torch.int32
    assert bool(torch.isfinite(states.position).all())


def test_chip_smoke_bands_are_the_reference():
    """chip_smoke.py phase 20's bands are tools/chees_reference.py's output,
    each three times the four keys' spread or 5 % of their mean."""
    recorded = chees_reference.RECORDED
    assert recorded is not None
    for name in ("step_size", "integration_steps_params"):
        assert tuple(recorded[f"{name}_band"]) == chees_reference.band(recorded[name])
        assert chip_smoke.CHEES_REFERENCE[name] == tuple(recorded[f"{name}_band"])
