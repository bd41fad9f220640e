"""The port's GIST samplers against the JAX package in float64 on the same
keys (``interop.prng_key``), 16 chains at d = 5.

- ``gist_step_size`` under both criteria and with a search budget that runs
  out: accept flags, ``step_index``, ``reverse_step_index`` and
  ``search_exhausted`` identical, the thresholds ``(a, b)`` and positions
  within 1e-10, the float32 step size identical.
- ``gist_trajectory_length``: accept flags, the drawn step counts, both
  U-turn counts and the no-return flags identical, positions within 1e-10,
  the acceptance rate within two float32 ulps (its width log-ratio is a
  float32 ``log``);
  ``num_steps_to_uturn`` alone, capped and not; a float32 state draws its
  step counts by JAX's int32 ``randint``, its default integer without x64.
- Refusals and the generator path.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
from blackjax_tpu.mcmc import gist_trajectory_length as jgtl  # noqa: E402
from blackjax_tpu.mcmc import integrators as jintegrators  # noqa: E402
from blackjax_tpu.mcmc import metrics as jmetrics  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import gist_step_size, gist_trajectory_length  # noqa: E402
from blackjax_tpu_torch.mcmc import integrators, metrics  # noqa: E402

TOL = 1e-10
D, C = 5, 16
VAR = np.array([0.25, 1.0, 4.0, 9.0, 0.5])
IMM = np.random.default_rng(1).uniform(0.5, 2.0, D)
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_cpu_use_fusion_emitters": False})


def _jld(x):
    return -0.5 * jnp.sum(x**2 / jnp.asarray(VAR) + 0.05 * x**4)


def _tld(x):
    return -0.5 * (x**2 / torch.from_numpy(VAR) + 0.05 * x**4).sum(-1)


def _x0():
    return np.random.default_rng(0).standard_normal((C, D))


def _keys(seed, steps):
    """``(steps, chains)`` keys: a key a step, then a key a chain."""
    return jax.vmap(lambda k: jax.random.split(k, C))(
        jax.random.split(jax.random.key(seed), steps))


def _hold(jalgo, talgo, steps, key_seed, flags, accept_tol=TOL):
    ref_step = jax.jit(jax.vmap(jalgo.step), **JIT)
    jstate = jax.vmap(jalgo.init)(jnp.asarray(_x0()))
    tstate = talgo.init(torch.from_numpy(_x0()))
    seen = {f: [] for f in flags}
    for k in _keys(key_seed, steps):
        jstate, jinfo = ref_step(k, jstate)
        tstate, tinfo = talgo.step(interop.prng_key(jax.random.key_data(k)), tstate)
        for f in flags:
            expected = np.asarray(getattr(jinfo, f))
            np.testing.assert_array_equal(np.asarray(getattr(tinfo, f)), expected, err_msg=f)
            seen[f].append(expected)
        for field, a, b in zip(tstate._fields, tstate, jstate):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL, err_msg=field)
        np.testing.assert_allclose(tinfo.acceptance_rate.numpy(), np.asarray(jinfo.acceptance_rate),
                                   rtol=accept_tol, atol=TOL)
    return tinfo, jinfo, {f: np.stack(v) for f, v in seen.items()}


@pytest.mark.parametrize("criterion,max_search_steps,steps", [
    ("symmetric", 10, 3), ("asymmetric", 10, 2), ("symmetric", 1, 2)])
def test_gist_step_size_matches_reference(criterion, max_search_steps, steps):
    args = (0.7, 3)
    kwargs = dict(criterion=criterion, max_search_steps=max_search_steps)
    jalgo = blackjax_tpu.gist_step_size(_jld, jnp.asarray(IMM), *args, **kwargs)
    talgo = blackjax_tpu_torch.gist_step_size(_tld, torch.from_numpy(IMM), *args, **kwargs)
    flags = ("is_accepted", "step_index", "reverse_step_index", "search_exhausted",
             "num_integration_steps", "is_divergent")
    tinfo, jinfo, seen = _hold(jalgo, talgo, steps, 21, flags)
    for name in ("a", "b"):
        np.testing.assert_allclose(getattr(tinfo.tuning_parameter, name).numpy(),
                                   np.asarray(getattr(jinfo.tuning_parameter, name)),
                                   rtol=TOL, atol=TOL)
    assert tinfo.step_size.dtype == torch.float32
    np.testing.assert_array_equal(tinfo.step_size.numpy(), np.asarray(jinfo.step_size))
    assert len(np.unique(seen["step_index"])) > 1  # chains search to other indices
    if max_search_steps == 1:
        assert seen["search_exhausted"].any()
    else:
        assert 0 < seen["is_accepted"].mean() < 1


def test_gist_trajectory_length_matches_reference():
    jalgo = blackjax_tpu.gist_trajectory_length(_jld, jnp.asarray(IMM), 0.3, max_num_steps=40)
    talgo = blackjax_tpu_torch.gist_trajectory_length(_tld, torch.from_numpy(IMM), 0.3,
                                                      max_num_steps=40)
    flags = ("is_accepted", "num_integration_steps", "num_steps_to_uturn_forward",
             "num_steps_to_uturn_reverse", "is_no_return_rejected", "tuning_parameter")
    # the width log-ratio is float32 in both: XLA's logf is not correctly
    # rounded (34 of the widths 1..1,999 differ from torch's by an ulp)
    _, _, seen = _hold(jalgo, talgo, 3, 22, flags, accept_tol=4e-7)
    assert len(np.unique(seen["num_steps_to_uturn_forward"])) > 2  # chains turn apart
    assert 0 < seen["is_accepted"].mean() < 1


def test_gist_trajectory_length_float32_draws_int32():
    """A float32 state draws its step counts as JAX does without x64: an
    int32 ``randint`` of the chain's draw key, which gives other numbers
    than the int64 one from the same keys."""
    talgo = blackjax_tpu_torch.gist_trajectory_length(
        lambda x: _tld(x.double()).float(), torch.from_numpy(IMM).float(), 0.3, max_num_steps=40)
    (k,) = _keys(23, 1)
    _, info = talgo.step(interop.prng_key(jax.random.key_data(k)),
                         talgo.init(torch.from_numpy(_x0()).float()))
    forward = jnp.asarray(info.num_steps_to_uturn_forward.numpy())
    lo = jnp.maximum(1, jnp.floor(0.5 * forward).astype(jnp.int32))
    draw_keys = jax.vmap(lambda key: jax.random.split(key, 3)[1])(k)

    def draws(dtype):
        return np.asarray(jax.vmap(lambda key, a, b: jax.random.randint(key, (), a, b, dtype))(
            draw_keys, lo, forward + 1))

    assert info.num_integration_steps.dtype == torch.int32
    np.testing.assert_array_equal(info.num_integration_steps.numpy(), draws(jnp.int32))
    assert (draws(jnp.int32) != draws(jnp.int64)).any()


@pytest.mark.parametrize("cap", [3, 1024])
def test_num_steps_to_uturn_matches_reference(cap):
    jm = jmetrics.gaussian_euclidean(jnp.asarray(IMM))
    tm = metrics.gaussian_euclidean(torch.from_numpy(IMM))
    m0 = np.random.default_rng(2).standard_normal((C, D))
    uturn = jgtl.num_steps_to_uturn(jintegrators.velocity_verlet, 0.2, jm, cap)
    expected = jax.jit(jax.vmap(lambda x, m: uturn(
        jintegrators.new_integrator_state(_jld, x, m), _jld)), **JIT)(
        jnp.asarray(_x0()), jnp.asarray(m0))
    got = gist_trajectory_length.num_steps_to_uturn(integrators.velocity_verlet, 0.2, tm, cap)(
        integrators.new_integrator_state(_tld, torch.from_numpy(_x0()), torch.from_numpy(m0)),
        _tld)
    np.testing.assert_array_equal(got.numpy(), np.asarray(expected))
    assert got.max() <= cap


def test_generator_path_and_refusals():
    algo = blackjax_tpu_torch.gist_step_size(_tld, torch.from_numpy(IMM), 0.5, 2)
    state = algo.init(torch.from_numpy(_x0()))
    new, info = algo.step(torch.Generator().manual_seed(0), state)
    assert new.position.shape == (C, D) and info.step_index.shape == (C,)
    talgo = blackjax_tpu_torch.gist_trajectory_length(_tld, torch.from_numpy(IMM), 0.3)
    new, info = talgo.step(torch.Generator().manual_seed(1), talgo.init(torch.from_numpy(_x0())))
    lo = torch.clamp(torch.floor(0.5 * info.num_steps_to_uturn_forward.double()), min=1)
    assert bool((info.num_integration_steps >= lo).all())
    assert bool((info.num_integration_steps <= info.num_steps_to_uturn_forward).all())
    with pytest.raises(ValueError, match="criterion"):
        gist_step_size.build_kernel(criterion="signed")
    with pytest.raises(ValueError, match="criterion"):
        gist_step_size.step_size_selector(integrators.velocity_verlet, 1, 0.1,
                                          criterion="signed")
