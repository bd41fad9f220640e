"""The port's NUTS against ``blackjax_tpu.nuts`` on the same configuration.

The two draw from different generators (a ``torch.Generator`` against JAX
keys), so the samplers are held statistically, in the protocol of
``tests/ops/test_fused_nuts_dc.py``: the mean trajectory length within
rtol 0.15 and the pooled variance within rtol 0.35 at 24 chains x 40
transitions. What is deterministic is held exactly: ``init`` computes the
same logdensity and gradient, to 1e-12 in f64.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.util import run_inference_algorithm  # noqa: E402

DIM = 4
VAR = np.array([1.0, 4.0, 0.25, 2.0])
C, S = 24, 40
STEP_SIZE, MAX_DOUBLINGS = 0.4, 6


def _x0():
    return 0.2 * np.random.default_rng(0).standard_normal((C, DIM))


@pytest.fixture(scope="module")
def reference_run():
    logdensity = lambda x: -0.5 * jnp.sum(x**2 / jnp.asarray(VAR))  # noqa: E731
    algo = blackjax_tpu.nuts(
        logdensity,
        step_size=STEP_SIZE,
        inverse_mass_matrix=jnp.ones(DIM),
        max_num_doublings=MAX_DOUBLINGS,
    )

    # one compile, at XLA's optimization level 0 with its older CPU fusion
    # emitters; run eagerly, the init and the scan compile apart
    @functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0,
                                                  "xla_cpu_use_fusion_emitters": False})
    def run(x0, key):
        def one(states, key):
            states, infos = jax.vmap(algo.step)(jax.random.split(key, C), states)
            return states, (states.position, infos)

        return jax.lax.scan(one, jax.vmap(algo.init)(x0), jax.random.split(key, S))

    _, (xs, infos) = run(jnp.asarray(_x0()), jax.random.key(6))
    last_info = jax.tree.map(lambda a: np.asarray(a[-1]), infos)
    return np.asarray(xs), np.asarray(infos.num_integration_steps), last_info


@pytest.fixture(scope="module")
def port_run():
    var = torch.from_numpy(VAR)
    algo = blackjax_tpu_torch.nuts(
        lambda x: -0.5 * (x**2 / var).sum(-1),
        step_size=STEP_SIZE,
        inverse_mass_matrix=torch.ones(DIM, dtype=torch.float64),
        max_num_doublings=MAX_DOUBLINGS,
    )
    generator = torch.Generator().manual_seed(0)
    _, (xs, nsteps) = run_inference_algorithm(
        generator,
        algo,
        S,
        initial_position=torch.from_numpy(_x0()),
        transform=lambda state, info: (state.position, info.num_integration_steps),
    )
    return xs.numpy(), nsteps.numpy()


def test_init_logdensity_and_gradient_exact():
    logdensity = lambda x: -0.5 * jnp.sum(x**2 / jnp.asarray(VAR))  # noqa: E731
    ref = jax.vmap(lambda x: blackjax_tpu.nuts.init(x, logdensity))(jnp.asarray(_x0()))
    var = torch.from_numpy(VAR)
    got = blackjax_tpu_torch.nuts.init(
        torch.from_numpy(_x0()), lambda x: -0.5 * (x**2 / var).sum(-1)
    )
    expect = interop.hmc_state(ref)
    for a, b in zip(got, expect):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)


def test_trajectory_lengths_match_reference(reference_run, port_run):
    _, ref_n, _ = reference_run
    _, port_n = port_run
    assert port_n.shape == (S, C)
    np.testing.assert_allclose(port_n.mean(), ref_n.mean(), rtol=0.15)


def test_pooled_variance_matches_reference(reference_run, port_run):
    ref_x, _, _ = reference_run
    port_x, _ = port_run
    assert port_x.shape == (S, C, DIM) and np.isfinite(port_x).all()
    ref_var = ref_x[S // 4 :].reshape(-1, DIM).var(0)
    port_var = port_x[S // 4 :].reshape(-1, DIM).var(0)
    np.testing.assert_allclose(port_var, ref_var, rtol=0.35)
    np.testing.assert_allclose(port_var, VAR, rtol=0.35)


def test_info_fields_are_per_chain():
    var = torch.from_numpy(VAR)
    algo = blackjax_tpu_torch.nuts(
        lambda x: -0.5 * (x**2 / var).sum(-1),
        step_size=STEP_SIZE,
        inverse_mass_matrix=torch.ones(DIM, dtype=torch.float64),
        max_num_doublings=3,
    )
    initial = algo.init(torch.from_numpy(_x0()))
    state, info = algo.step(torch.Generator().manual_seed(1), initial)
    assert state.position.shape == (C, DIM)
    assert info.num_integration_steps.shape == (C,)
    assert int(info.num_integration_steps.max()) <= 2**3 - 1
    assert ((info.acceptance_rate >= 0) & (info.acceptance_rate <= 1)).all()
    # the nested engine takes the same transition from the same generator
    nested = blackjax_tpu_torch.nuts(
        lambda x: -0.5 * (x**2 / var).sum(-1),
        step_size=STEP_SIZE,
        inverse_mass_matrix=torch.ones(DIM, dtype=torch.float64),
        max_num_doublings=3,
        engine="nested",
    )
    nested_state, nested_info = nested.step(torch.Generator().manual_seed(1), initial)
    assert torch.equal(nested_state.position, state.position)
    assert torch.equal(nested_info.num_integration_steps, info.num_integration_steps)


def test_interop_carries_the_reference_info(reference_run):
    *_, info = reference_run
    ported = interop.nuts_info(info)
    assert type(ported).__name__ == "NUTSInfo"
    assert ported.num_integration_steps.shape == (C,)
    assert ported.trajectory_leftmost_state.position.shape == (C, DIM)
    assert ported.is_divergent.dtype == torch.bool
    np.testing.assert_array_equal(
        ported.acceptance_rate.numpy(), np.asarray(info.acceptance_rate)
    )
