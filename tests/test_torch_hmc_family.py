"""The port's static-HMC remainder, multinomial HMC, dynamic HMC and GHMC
against the JAX package in float64 on the same keys (``interop.prng_key``).

- ``trajectory.static_integration`` with a step count per chain (the masked
  loop, with and without ``max_num_integration_steps``) and
  ``static_progressive_integration`` (reservoir sampling on ``fold_in(key,
  i)``): states within 1e-12.
- ``dhmc`` in float32 draws its step counts in int32, as the JAX package
  without x64 does.
- ``hmc`` with per-chain step counts, ``mhmc``, ``dhmc``, ``dmhmc`` and
  ``ghmc`` over several transitions: positions within 1e-12, accept flags,
  drawn step counts and the carried keys identical.
- The tracked static-HMC configuration (``benchmarks/tracked.py:112-163``)
  at 16 chains x d = 10 through ``hmc``, ``mhmc`` and ``dhmc``, its keys
  split as the configuration splits them.
- The Halton helpers; the ``DynamicHMCState`` converter; the refusal of a
  position that is not a tensor.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
from blackjax_tpu.mcmc import dynamic_hmc as jdynamic  # noqa: E402
from blackjax_tpu.mcmc import integrators as jintegrators  # noqa: E402
from blackjax_tpu.mcmc import metrics as jmetrics  # noqa: E402
from blackjax_tpu.mcmc import trajectory as jtrajectory  # noqa: E402
from blackjax_tpu.models import targets as jtargets  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import dynamic_hmc, ghmc, hmc, integrators, metrics  # noqa: E402
from blackjax_tpu_torch.mcmc import trajectory  # noqa: E402
from blackjax_tpu_torch.models import targets  # noqa: E402

TOL = 1e-12
D, C, STEPS = 6, 16, 6
VAR = np.array([0.25, 1.0, 4.0, 9.0, 0.5, 2.0])
IMM = np.random.default_rng(1).uniform(0.5, 2.0, D)
JIT = dict(compiler_options={"xla_backend_optimization_level": 0,
                             "xla_cpu_use_fusion_emitters": False})


def _jld(x):
    return -0.5 * jnp.sum(x**2 / jnp.asarray(VAR) + 0.1 * x**4)


def _tld(x):
    return -0.5 * (x**2 / torch.from_numpy(VAR) + 0.1 * x**4).sum(-1)


def _x0():
    return np.random.default_rng(0).standard_normal((C, D))


def _keys(seed, steps=STEPS, chains=C):
    """``(steps, chains)`` keys, split as the tracked configuration splits
    them: a key a step, then a key a chain."""
    return jax.vmap(lambda k: jax.random.split(k, chains))(
        jax.random.split(jax.random.key(seed), steps))


def _close(got, expected, tol=TOL):
    for a, b in zip(got, expected):
        if isinstance(a, tuple):
            _close(a, b, tol)
        else:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("bounded", [False, True])
def test_static_integration_with_a_step_count_per_chain(bounded):
    jm = jmetrics.gaussian_euclidean(jnp.asarray(IMM))
    tm = metrics.gaussian_euclidean(torch.from_numpy(IMM))
    counts = np.random.default_rng(3).integers(0, 9, C)
    m0 = np.random.default_rng(2).standard_normal((C, D))
    j_roll = jtrajectory.static_integration(jintegrators.velocity_verlet(_jld, jm.kinetic_energy))
    t_roll = trajectory.static_integration(integrators.velocity_verlet(_tld, tm.kinetic_energy))
    maximum = 12 if bounded else None
    js = jax.jit(jax.vmap(lambda x, m, n: j_roll(
        jintegrators.new_integrator_state(_jld, x, m), 0.1, n, 12)), **JIT)(
        jnp.asarray(_x0()), jnp.asarray(m0), jnp.asarray(counts))
    ts = t_roll(integrators.new_integrator_state(_tld, torch.from_numpy(_x0()),
                                                 torch.from_numpy(m0)),
                0.1, torch.from_numpy(counts), maximum)
    _close(ts, js)


@pytest.mark.parametrize("per_chain", [False, True])
def test_static_progressive_integration(per_chain):
    jm = jmetrics.gaussian_euclidean(jnp.asarray(IMM))
    tm = metrics.gaussian_euclidean(torch.from_numpy(IMM))
    counts = np.random.default_rng(4).integers(1, 9, C) if per_chain else np.full(C, 7)
    m0 = np.random.default_rng(2).standard_normal((C, D))
    keys = jax.random.split(jax.random.key(5), C)

    def ref(k, x, m, n):
        integrate = jtrajectory.static_progressive_integration(
            jintegrators.velocity_verlet(_jld, jm.kinetic_energy), jm.kinetic_energy, n, 1000)
        return integrate(k, jintegrators.new_integrator_state(_jld, x, m), 0.3)

    (jprop, jdiv) = jax.jit(jax.vmap(ref), **JIT)(keys, jnp.asarray(_x0()), jnp.asarray(m0),
                                                  jnp.asarray(counts))
    n = torch.from_numpy(counts) if per_chain else 7
    integrate = trajectory.static_progressive_integration(
        integrators.velocity_verlet(_tld, tm.kinetic_energy), tm.kinetic_energy, n, 1000)
    tprop, tdiv = integrate(interop.prng_key(jax.random.key_data(keys)),
                            integrators.new_integrator_state(_tld, torch.from_numpy(_x0()),
                                                             torch.from_numpy(m0)), 0.3)
    _close(tprop, jprop)
    np.testing.assert_array_equal(tdiv.numpy(), np.asarray(jdiv))


def _hold(name, build_ref, build_port, init_ref, init_port, key_seed=7, steps=STEPS,
          flags=("is_accepted",)):
    """``steps`` transitions of the reference (jitted, vmapped over chains)
    and of the port on the same keys; every state and info field within
    1e-12, the named flags identical."""
    keys = _keys(key_seed, steps)
    ref_step = jax.jit(jax.vmap(build_ref), **JIT)
    jstate, tstate = init_ref(), init_port()
    seen = {f: [] for f in flags}
    for k in keys:
        jstate, jinfo = ref_step(k, jstate)
        tstate, tinfo = build_port(interop.prng_key(jax.random.key_data(k)), tstate)
        for f in flags:
            got, expected = getattr(tinfo, f), np.asarray(getattr(jinfo, f))
            np.testing.assert_array_equal(np.asarray(got), expected, err_msg=f"{name} {f}")
            seen[f].append(expected)
        for field, a, b in zip(tstate._fields, tstate, jstate):
            b = np.asarray(jax.random.key_data(b)) if jnp.issubdtype(
                b.dtype, jax.dtypes.prng_key) else np.asarray(b)
            np.testing.assert_allclose(np.asarray(a), b, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {field}")
    return {f: np.stack(v) for f, v in seen.items()}


def test_hmc_with_a_step_count_per_chain():
    """The reference's count rides per chain through ``vmap``; the port's is
    a ``(C,)`` tensor through the masked loop."""
    counts = np.random.default_rng(6).integers(1, 12, C)
    jkernel = blackjax_tpu.hmc.build_kernel(max_num_integration_steps=12)
    tkernel = hmc.build_kernel(max_num_integration_steps=12)
    ref = jax.jit(jax.vmap(lambda k, s, n: jkernel(k, s, _jld, 0.3, jnp.asarray(IMM), n)), **JIT)
    jstate = jax.vmap(lambda x: blackjax_tpu.hmc.init(x, _jld))(jnp.asarray(_x0()))
    tstate = hmc.init(torch.from_numpy(_x0()), _tld)
    accepted = []
    for k in _keys(8):
        jstate, jinfo = ref(k, jstate, jnp.asarray(counts))
        tstate, tinfo = tkernel(interop.prng_key(jax.random.key_data(k)), tstate, _tld, 0.3,
                                torch.from_numpy(IMM), torch.from_numpy(counts))
        np.testing.assert_array_equal(tinfo.is_accepted.numpy(), np.asarray(jinfo.is_accepted))
        np.testing.assert_array_equal(tinfo.num_integration_steps.numpy(),
                                      np.asarray(jinfo.num_integration_steps))
        accepted.append(np.asarray(jinfo.is_accepted))
        _close(tstate, jstate)
    assert 0 < np.mean(accepted) < 1


def test_multinomial_hmc_matches_reference():
    jalgo = blackjax_tpu.mhmc(_jld, 0.4, jnp.asarray(IMM), 8)
    talgo = blackjax_tpu_torch.mhmc(_tld, 0.4, torch.from_numpy(IMM), 8)
    _hold("mhmc", jalgo.step, talgo.step,
          lambda: jax.vmap(jalgo.init)(jnp.asarray(_x0())),
          lambda: talgo.init(torch.from_numpy(_x0())), flags=("is_accepted", "is_divergent"))


@pytest.mark.parametrize("name", ["dhmc", "dmhmc"])
def test_dynamic_hmc_matches_reference(name):
    jalgo = getattr(blackjax_tpu, name)(_jld, 0.3, jnp.asarray(IMM))
    talgo = getattr(blackjax_tpu_torch, name)(_tld, 0.3, torch.from_numpy(IMM))
    init_keys = jax.random.split(jax.random.key(11), C)
    seen = _hold(
        name, jalgo.step, talgo.step,
        lambda: jax.vmap(jalgo.init)(jnp.asarray(_x0()), init_keys),
        lambda: talgo.init(torch.from_numpy(_x0()),
                           interop.prng_key(jax.random.key_data(init_keys))),
        flags=("is_accepted", "num_integration_steps"),
    )
    assert len(np.unique(seen["num_integration_steps"])) > 3  # counts differ by chain


def test_dynamic_hmc_float32_draws_the_int32_step_counts():
    """A float32 state draws its step counts as the JAX package does
    without x64: ``randint(key, (), 1, 10)`` in int32 on each chain's key,
    other counts than the int64 draw of the same keys."""
    talgo = blackjax_tpu_torch.dhmc(lambda x: _tld(x.double()).float(), 0.3,
                                    torch.from_numpy(IMM).float())
    init_keys = jax.random.split(jax.random.key(11), 64)
    words = interop.prng_key(jax.random.key_data(init_keys))
    state = talgo.init(torch.from_numpy(
        np.random.default_rng(0).standard_normal((64, D))).float(), words)
    _, info = talgo.step(interop.prng_key(jax.random.key_data(jax.random.key(3))), state)
    expected = jax.vmap(lambda k: jax.random.randint(k, (), 1, 10, dtype=jnp.int32))(init_keys)
    assert info.num_integration_steps.dtype == torch.int32
    np.testing.assert_array_equal(info.num_integration_steps.numpy(), np.asarray(expected))
    int64 = jax.vmap(lambda k: jax.random.randint(k, (), 1, 10, dtype=jnp.int64))(init_keys)
    assert not np.array_equal(np.asarray(int64), np.asarray(expected))


def test_ghmc_matches_reference():
    jalgo = blackjax_tpu.ghmc(_jld, 0.3, jnp.asarray(np.sqrt(IMM)), 0.3, 0.2)
    talgo = blackjax_tpu_torch.ghmc(_tld, 0.3, torch.from_numpy(np.sqrt(IMM)), 0.3, 0.2)
    init_keys = jax.random.split(jax.random.key(12), C)
    seen = _hold(
        "ghmc", jalgo.step, talgo.step,
        lambda: jax.vmap(jalgo.init)(jnp.asarray(_x0()), init_keys),
        lambda: talgo.init(torch.from_numpy(_x0()),
                           interop.prng_key(jax.random.key_data(init_keys))),
        steps=10,
    )
    assert 0 < seen["is_accepted"].mean() < 1


@pytest.mark.parametrize("name", ["hmc", "mhmc", "dhmc"])
def test_tracked_static_hmc_config_small(name):
    """``benchmarks/tracked.py:112-163`` at 16 chains x d = 10: the
    ill-conditioned Gaussian, 0.5 N(0, I) from numpy seed 7, step size 0.08,
    10 integration steps, unit inverse mass."""
    d, chains, steps = 10, 16, 12
    jtarget, ttarget = jtargets.ill_conditioned_gaussian(d), targets.ill_conditioned_gaussian(d)
    x0 = 0.5 * np.random.default_rng(7).standard_normal((chains, d))
    args = dict(step_size=0.08, inverse_mass_matrix=np.ones(d))
    if name != "dhmc":
        args["num_integration_steps"] = 10
    jalgo = getattr(blackjax_tpu, name)(jtarget.logdensity_fn, **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in args.items()})
    talgo = getattr(blackjax_tpu_torch, name)(ttarget.logdensity_fn, **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in args.items()})
    if name == "dhmc":
        init_keys = jax.random.split(jax.random.key(9), chains)
        init_ref = lambda: jax.vmap(jalgo.init)(jnp.asarray(x0), init_keys)  # noqa: E731
        init_port = lambda: talgo.init(  # noqa: E731
            torch.from_numpy(x0), interop.prng_key(jax.random.key_data(init_keys)))
    else:
        init_ref = lambda: jax.vmap(jalgo.init)(jnp.asarray(x0))  # noqa: E731
        init_port = lambda: talgo.init(torch.from_numpy(x0))  # noqa: E731
    keys = jax.vmap(lambda k: jax.random.split(k, chains))(
        jax.random.split(jax.random.key(8), steps))
    ref_step = jax.jit(jax.vmap(jalgo.step), **JIT)
    jstate, tstate = init_ref(), init_port()
    for k in keys:
        jstate, jinfo = ref_step(k, jstate)
        tstate, tinfo = talgo.step(interop.prng_key(jax.random.key_data(k)), tstate)
        np.testing.assert_array_equal(tinfo.is_accepted.numpy(), np.asarray(jinfo.is_accepted))
        np.testing.assert_array_equal(np.asarray(tinfo.num_integration_steps),
                                      np.asarray(jinfo.num_integration_steps))
        np.testing.assert_allclose(tinfo.acceptance_rate.numpy(),
                                   np.asarray(jinfo.acceptance_rate), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tstate.position.numpy(), np.asarray(jstate.position),
                                   rtol=TOL, atol=TOL)


def test_halton_helpers_match_reference():
    i = np.arange(0, 300)
    np.testing.assert_array_equal(
        dynamic_hmc.halton_sequence(torch.from_numpy(i)).double().numpy(),
        np.asarray(jax.vmap(jdynamic.halton_sequence)(jnp.asarray(i))))
    for mu in [1.5, 3.2, 7.0]:
        assert dynamic_hmc.rescale(mu) == float(jdynamic.rescale(mu))
        np.testing.assert_array_equal(
            dynamic_hmc.halton_trajectory_length(torch.from_numpy(i), mu).numpy(),
            np.asarray(jax.vmap(lambda j: jdynamic.halton_trajectory_length(j, mu))(
                jnp.asarray(i))))
    with pytest.raises(ValueError, match="max_bits"):
        dynamic_hmc.halton_sequence(torch.zeros(2, dtype=torch.int32), 40)


def test_dynamic_hmc_state_converter():
    keys = jax.random.split(jax.random.key(1), C)
    state = jax.vmap(lambda x, k: jdynamic.init(x, _jld, k))(jnp.asarray(_x0()), keys)
    words = jax.random.key_data(state.random_generator_arg)
    port = interop.dynamic_hmc_state(state._replace(random_generator_arg=words))
    assert isinstance(port, dynamic_hmc.DynamicHMCState)
    np.testing.assert_array_equal(port.random_generator_arg.numpy(), np.asarray(words))
    np.testing.assert_allclose(port.logdensity_grad.numpy(), np.asarray(state.logdensity_grad),
                               rtol=TOL)
    halton = interop.dynamic_hmc_state(state._replace(random_generator_arg=np.arange(C)))
    assert halton.random_generator_arg.dtype == torch.int64


@pytest.mark.parametrize("name", ["hmc", "dhmc", "ghmc"])
def test_pytree_positions_are_refused(name):
    module = {"hmc": hmc, "dhmc": dynamic_hmc, "ghmc": ghmc}[name]
    extra = () if name == "hmc" else (torch.Generator().manual_seed(0),)
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 11"):
        module.init({"x": torch.zeros(3)}, lambda x: -(x["x"] ** 2).sum(), *extra)
