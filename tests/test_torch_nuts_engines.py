"""The port's two NUTS engines against the reference's, on the reference's
keys (carried across by ``interop.prng_key``), in f64.

- The proposal from a given integrator state (the reference's momentum) and
  integrator key: identical step counts, turning and divergence flags;
  positions and acceptance within 1e-12 (the arithmetic is the same; sums
  may round apart in the last bit).
- The full kernel over 25 transitions, one chain and 6 chains: identical
  step counts, positions within 1e-8 (the momentum's normals differ from
  XLA's in their last bits).
- Inside the port the nested and flattened engines agree bit for bit.

The reference side runs its flattened engine once per configuration: its
nested engine is pinned bit for bit to it by ``tests/mcmc/test_nuts.py``.
- The recursive oracle agrees with the reference's oracle on the same key,
  and with both iterative engines on a fixed tree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.mcmc import integrators as jintegrators  # noqa: E402
from blackjax_tpu.mcmc import metrics as jmetrics  # noqa: E402
from blackjax_tpu.mcmc import nuts as jnuts  # noqa: E402
from blackjax_tpu.mcmc import trajectory as jtrajectory  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import integrators, metrics, nuts, termination, trajectory  # noqa: E402

DIM = 4
VAR = np.array([1.0, 4.0, 0.25, 2.0])
IMM = np.array([1.0, 2.0, 0.5, 1.5])
ENGINES = ["flattened", "nested"]


# the JAX side at XLA's optimization level 0 with its older CPU fusion
# emitters: a quicker compile
OPT0 = {"xla_backend_optimization_level": 0, "xla_cpu_use_fusion_emitters": False}

def jlogdensity(x):
    return -0.5 * jnp.sum(x**2 / jnp.asarray(VAR))


def logdensity(x):
    return -0.5 * (x**2 / torch.from_numpy(VAR)).sum(-1)


def _words(keys):
    return interop.prng_key(jax.random.key_data(keys))


def _parts(engine, max_doublings, threshold):
    """The reference's and the port's proposal on the same metric."""
    jmetric = jmetrics.default_metric(jnp.asarray(IMM))
    jpropose = jnuts.iterative_nuts_proposal(
        jintegrators.velocity_verlet(jlogdensity, jmetric.kinetic_energy),
        jmetric.kinetic_energy, jmetric.check_turning, max_doublings, threshold, engine=engine,
    )
    metric = metrics.default_metric(torch.from_numpy(IMM))
    propose = nuts.iterative_nuts_proposal(
        integrators.velocity_verlet(logdensity, metric.kinetic_energy),
        metric.kinetic_energy, metric.check_turning, max_doublings, threshold, engine=engine,
    )
    return jpropose, propose


PROPOSAL_CASES = {"healthy": (0.3, 1000.0), "diverging": (1.4, 1.0)}


@pytest.fixture(scope="module", params=sorted(PROPOSAL_CASES))
def reference_proposal(request):
    """The reference's proposal (its flattened engine; its nested one is pinned
    bit for bit to it by tests/mcmc/test_nuts.py) from 12 chains' states,
    momenta and integrator keys."""
    step_size, threshold = PROPOSAL_CASES[request.param]
    C = 12
    x, m = np.random.default_rng(3).standard_normal((2, C, DIM))
    keys = jax.random.split(jax.random.key(8), C)
    jstate = jax.vmap(lambda x: jnuts.init(x, jlogdensity))(jnp.asarray(x))
    jpropose, _ = _parts("flattened", 6, threshold)
    jis = jintegrators.IntegratorState(jstate.position, jnp.asarray(m), *jstate[1:])
    # one compiled call: run eagerly, each step of the proposal's loop
    # compiles on its own
    jout, jinfo = jax.jit(jax.vmap(jpropose, (0, 0, None)),
                          compiler_options=OPT0)(keys, jis, step_size)
    return x, m, keys, step_size, threshold, jout, jinfo


@pytest.mark.parametrize("engine", ENGINES)
def test_proposal_with_the_reference_momentum(engine, reference_proposal):
    x, m, keys, step_size, threshold, jout, jinfo = reference_proposal
    _, propose = _parts(engine, 6, threshold)
    state = nuts.init(torch.from_numpy(x), logdensity)
    istate = integrators.IntegratorState(state.position, torch.from_numpy(m), *state[1:])
    out, info = propose(_words(keys), istate, step_size)

    for name in ("num_integration_steps", "num_trajectory_expansions", "is_turning",
                 "is_divergent"):
        np.testing.assert_array_equal(
            getattr(info, name).numpy(), np.asarray(getattr(jinfo, name)), err_msg=name)
    np.testing.assert_allclose(out.position.numpy(), np.asarray(jout.position), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(info.acceptance_rate.numpy(), np.asarray(jinfo.acceptance_rate),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(info.energy.numpy(), np.asarray(jinfo.energy), rtol=1e-12)
    if threshold < 10:
        assert bool(info.is_divergent.any()), "the case must reach the divergence path"


@pytest.fixture(scope="module")
def reference_chains():
    """25 transitions of the reference's kernel (flattened engine), vmapped
    over 6 chains, with one key per (transition, chain)."""
    chains = 6
    x0 = np.random.default_rng(4).standard_normal((chains, DIM))
    jkernel = jnuts.build_kernel()
    jstate = jax.vmap(lambda x: jnuts.init(x, jlogdensity))(jnp.asarray(x0))
    jstep = jax.jit(jax.vmap(jkernel, (0, 0, None, None, None)), static_argnums=(2,),
                    compiler_options=OPT0)
    base = jax.random.key(21)
    keys, steps, positions = [], [], []
    for i in range(25):
        key = jax.random.split(jax.random.fold_in(base, i), chains)
        jstate, jinfo = jstep(key, jstate, jlogdensity, 0.25, jnp.asarray(IMM))
        keys.append(key)
        steps.append(np.asarray(jinfo.num_integration_steps))
        positions.append(np.asarray(jstate.position))
    return x0, keys, steps, positions


@pytest.fixture(scope="module", params=[1, 6])
def reference_transitions(request, reference_chains):
    """The reference's 25 transitions from 6 chains ``(C, d)``, or from one
    chain ``(d,)`` with one key ``(2,)`` per transition: chain 0 of the
    vmapped run, whose draws depend on its own keys only."""
    x0, keys, steps, positions = reference_chains
    if request.param == 1:
        return 1, x0[0], [k[0] for k in keys], [s[0] for s in steps], [p[0] for p in positions]
    return 6, x0, keys, steps, positions


@pytest.mark.parametrize("engine", ENGINES)
def test_kernel_follows_the_reference_for_25_transitions(engine, reference_transitions):
    chains, x0, keys, steps, positions = reference_transitions
    kernel = nuts.build_kernel(engine=engine)
    state = nuts.init(torch.from_numpy(x0), logdensity)
    assert state.position.shape == ((DIM,) if chains == 1 else (chains, DIM))
    for i in range(25):
        state, info = kernel(_words(keys[i]), state, logdensity, 0.25, torch.from_numpy(IMM))
        np.testing.assert_array_equal(info.num_integration_steps.numpy(), steps[i],
                                      err_msg=f"transition {i}")
        np.testing.assert_allclose(state.position.numpy(), positions[i], rtol=1e-8, atol=1e-8,
                                   err_msg=f"transition {i}")


def test_nested_equals_flattened_bit_for_bit():
    C = 6
    x0 = np.random.default_rng(5).standard_normal((C, DIM))
    flat, nested = nuts.build_kernel(engine="flattened"), nuts.build_kernel(engine="nested")
    s_flat = s_nested = nuts.init(torch.from_numpy(x0), logdensity)
    base = jax.random.key(22)
    imm = torch.from_numpy(IMM)
    for i in range(8):
        words = _words(jax.random.split(jax.random.fold_in(base, i), C))
        s_flat, i_flat = flat(words, s_flat, logdensity, 0.25, imm)
        s_nested, i_nested = nested(words, s_nested, logdensity, 0.25, imm)
        for a, b in zip(s_flat, s_nested):
            assert torch.equal(a, b)
        for name in ("num_integration_steps", "is_turning", "is_divergent", "acceptance_rate",
                     "energy"):
            assert torch.equal(getattr(i_flat, name), getattr(i_nested, name)), name
        for a, b in zip(i_flat.trajectory_leftmost_state, i_nested.trajectory_leftmost_state):
            assert torch.equal(a, b)


def _single_state(x, m):
    state = nuts.init(torch.from_numpy(x), logdensity)
    return integrators.IntegratorState(state.position, torch.from_numpy(m), *state[1:])


@pytest.mark.parametrize("depth, step_size, direction", [(3, 0.1, 1), (3, 0.1, -1), (4, 0.6, 1)])
def test_recursive_oracle(depth, step_size, direction):
    rng = np.random.default_rng(6)
    x, m = rng.standard_normal((2, DIM))
    metric = metrics.default_metric(torch.from_numpy(IMM))
    integrator = integrators.velocity_verlet(logdensity, metric.kinetic_energy)
    energy = trajectory.hmc_energy(metric.kinetic_energy)
    state = _single_state(x, m)
    initial_energy = energy(state)
    key = jax.random.key(30)
    buildtree = trajectory.dynamic_recursive_integration(
        integrator, metric.kinetic_energy, metric.check_turning, 1000.0)
    left, right, msum, proposal, diverging, turning = buildtree(
        _words(key), state, direction, depth, step_size, initial_energy)

    # the reference's oracle on the same key
    jmetric = jmetrics.default_metric(jnp.asarray(IMM))
    jintegrator = jintegrators.velocity_verlet(jlogdensity, jmetric.kinetic_energy)
    jstate = jnuts.init(jnp.asarray(x), jlogdensity)
    jis = jintegrators.IntegratorState(jstate.position, jnp.asarray(m), *jstate[1:])
    jbuild = jtrajectory.dynamic_recursive_integration(
        jintegrator, jmetric.kinetic_energy, jmetric.check_turning, 1000.0)
    jleft, jright, jmsum, jproposal, jdiverging, jturning = jbuild(
        key, jis, direction, depth, step_size,
        jtrajectory.hmc_energy(jmetric.kinetic_energy)(jis))
    assert (bool(diverging), bool(turning)) == (bool(jdiverging), bool(jturning))
    for a, b in [(left.position, jleft.position), (right.position, jright.position),
                 (msum, jmsum), (proposal.state.position, jproposal.state.position)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)

    # both iterative engines integrate the same subtree: the ends, the
    # momentum sum and the turning verdict agree (the proposal is drawn from
    # other keys)
    _, update, is_met = termination.iterative_uturn(metric.check_turning)
    new_term, _, _ = termination.iterative_uturn(metric.check_turning)
    integrate = trajectory.dynamic_progressive_integration(
        integrator, metric.kinetic_energy, update, is_met, 1000.0)
    sub_proposal, sub_traj, _, sub_div, sub_turn = integrate(
        _words(key), state, torch.tensor(float(direction), dtype=torch.float64),
        new_term(state, depth + 1), torch.tensor(2**depth), step_size, initial_energy)
    assert bool(sub_div) == bool(diverging)
    assert bool(sub_turn) == bool(turning)
    if not turning:
        assert int(sub_traj.num_states) == 2**depth
        for a, b in [(sub_traj.leftmost_state.position, left.position),
                     (sub_traj.rightmost_state.position, right.position),
                     (sub_traj.momentum_sum, msum)]:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)

    machine_init, machine_leaf = trajectory.flattened_nuts_machine(
        integrator, metric.kinetic_energy, metric.check_turning, depth + 1, 1000.0)
    # force the flattened machine onto the same subtree: its last doubling
    # (depth `depth`, 2**depth leaves) in `direction`, no proposal taken
    s = machine_init(_words(key), state)._replace(depth=torch.tensor(depth))
    u_dir = torch.tensor(0.0 if direction > 0 else 0.9, dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    for _ in range(2**depth):
        s = machine_leaf(s, step_size, (u_dir, one, one))
        if bool(s.done):
            break
    if turning:
        assert bool(s.is_turning)
    else:
        end, oracle_end = (s.right, right) if direction > 0 else (s.left, left)
        np.testing.assert_allclose(end.position.numpy(), oracle_end.position.numpy(),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(s.sub_momentum_sum.numpy(), msum.numpy(), rtol=1e-12,
                                   atol=1e-12)
