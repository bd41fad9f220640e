"""The port's continuous NUTS runner (``mcmc.nuts.build_fused_many_steps``).

The reference's four runner tests (``tests/mcmc/test_nuts.py:210-352``),
ported at 6 chains x 4 steps (the reference: 12 x 12): the runner is bit for bit
a loop over the port's kernel with the same per-(step, chain) keys, under
oversubscription, unrolling with gated restarts, and a sliding history
window (all in f64). The runner is also held against the reference's runner
on the same keys, 6 chains x 12 steps: equal gradient totals, history and
final positions within 1e-8. And the reference's parameter errors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.mcmc import nuts as jnuts  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import nuts  # noqa: E402

C, S, DIM = 6, 4, 4
S_REFERENCE = 12
STEP_SIZE = 0.25
VAR = np.array([1.0, 4.0, 0.25, 2.0])


def jlogdensity(x):
    return -0.5 * jnp.sum(x**2 / jnp.asarray(VAR))


def logdensity(x):
    return -0.5 * (x**2 / torch.from_numpy(VAR)).sum(-1)


def _keys(num_steps):
    """The (num_steps, C) keys of the reference's runner tests."""
    step_keys = jax.random.split(jax.random.key(11), num_steps)
    return jax.vmap(lambda k: jax.random.split(k, C))(step_keys)


@pytest.fixture(scope="module")
def setup():
    """Initial states, the (S, C) keys, and the loop over the port's kernel
    with those keys."""
    x0 = np.random.default_rng(0).standard_normal((C, DIM))
    rng_keys = _keys(S)
    words = interop.prng_key(jax.random.key_data(rng_keys))
    states = nuts.init(torch.from_numpy(x0), logdensity)
    kernel = nuts.build_kernel()
    state, hist, grads = states, [], 0
    for t in range(S):
        state, info = kernel(words[t], state, logdensity, STEP_SIZE,
                             torch.ones(DIM, dtype=torch.float64))
        hist.append(state.position)
        grads += int(info.num_integration_steps.sum())
    scan = (state.position, torch.stack(hist, 1), grads)
    return x0, rng_keys, words, states, scan


def _run(setup, num_steps=S, words=None, **kw):
    _, _, setup_words, states, _ = setup
    run = nuts.build_fused_many_steps(
        logdensity, STEP_SIZE, torch.ones(DIM, dtype=torch.float64), num_steps=num_steps, **kw)
    return run(setup_words if words is None else words, states)


def _assert_equals_scan(setup, out):
    final, hist, grads = out
    scan_final, scan_hist, scan_grads = setup[4]
    assert torch.equal(hist, scan_hist)
    assert int(grads) == scan_grads
    assert torch.equal(final.position, scan_final)


def test_fused_many_steps_bit_identical_to_scan(setup):
    _assert_equals_scan(setup, _run(setup))


@pytest.mark.parametrize("m", [2, 3, 6])
def test_fused_many_steps_oversubscribed_bit_identical(setup, m):
    _assert_equals_scan(setup, _run(setup, oversubscription=m))


@pytest.mark.parametrize("m, unroll, restart_every", [(1, 4, 1), (3, 2, 1), (1, 4, 4), (3, 4, 2)])
def test_fused_many_steps_unrolled_bit_identical(setup, m, unroll, restart_every):
    _assert_equals_scan(
        setup, _run(setup, oversubscription=m, unroll=unroll, restart_every=restart_every))


def test_fused_many_steps_tiny_window_still_exact(setup):
    _assert_equals_scan(setup, _run(setup, window_size=2))


def test_runner_matches_the_reference_runner(setup):
    x0 = setup[0]
    rng_keys = _keys(S_REFERENCE)
    jstates = jax.vmap(lambda x: jnuts.init(x, jlogdensity))(jnp.asarray(x0))
    # one compile at XLA's optimization level 0 with its older fusion
    # emitters: a quicker compile of the unrolled runner
    jrun = jax.jit(jnuts.build_fused_many_steps(jlogdensity, STEP_SIZE, jnp.ones(DIM),
                                                num_steps=S_REFERENCE),
                   compiler_options={"xla_backend_optimization_level": 0,
                                     "xla_cpu_use_fusion_emitters": False})
    jfinal, jhist, jgrads = jrun(rng_keys, jstates)
    final, hist, grads = _run(setup, S_REFERENCE,
                              interop.prng_key(jax.random.key_data(rng_keys)))
    assert int(grads) == int(jgrads)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(final.position.numpy(), np.asarray(jfinal.position), rtol=1e-8,
                               atol=1e-8)


def test_track_fn_shapes_the_history(setup):
    final, hist, _ = _run(setup, track_fn=lambda state: state.position[:, :2] ** 2)
    assert hist.shape == (C, S, 2)
    np.testing.assert_array_equal(hist[:, -1].numpy(), final.position[:, :2].numpy() ** 2)


@pytest.mark.parametrize("kw, match", [
    (dict(oversubscription=0), "oversubscription must be >= 1"),
    (dict(unroll=0), "unroll must be >= 1"),
    (dict(unroll=2, restart_every=3), "restart_every must be in"),
    (dict(restart_every=0), "restart_every must be in"),
])
def test_parameter_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        nuts.build_fused_many_steps(logdensity, STEP_SIZE, torch.ones(DIM), num_steps=S, **kw)


def test_oversubscription_must_divide_the_chains(setup):
    with pytest.raises(ValueError, match="must divide num_chains"):
        _run(setup, oversubscription=4)
