"""The port's MCLMC pieces against the JAX package.

The isokinetic integrators, the ESH kick, the O-U refresh and one MCLMC
transition (reverts included) are deterministic given their draws: the same
f64 inputs, made with numpy, and the reference's own normals and unit
vectors go through both packages, chain by chain, and agree to rtol 1e-12
(sums are taken in another order). The tuner's controller and variance
stream are held exactly too; the whole tuner, whose draws differ between
the packages, is held statistically.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.adaptation import mclmc_adaptation as jada  # noqa: E402
from blackjax_tpu.mcmc import integrators as jint  # noqa: E402
from blackjax_tpu.mcmc import mclmc as jmclmc  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.adaptation import mclmc_adaptation as ada  # noqa: E402
from blackjax_tpu_torch.mcmc import integrators, mclmc  # noqa: E402
from blackjax_tpu_torch.util import generate_unit_vector  # noqa: E402

RTOL = 1e-12
D, C = 6, 5
INV_VAR = np.array([1.0, 0.5, 2.0, 4.0, 0.25, 1.5])


def _close(got, expected, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(expected), rtol=rtol, atol=1e-13
    )


def jlogdensity(x):
    """A non-Gaussian test target on one (d,) position."""
    return -0.5 * jnp.sum(x**2 * INV_VAR) - 0.05 * jnp.sum(x**4)


def tlogdensity(x):
    """The same target on (..., d) positions."""
    return -0.5 * (x**2 * torch.from_numpy(INV_VAR)).sum(-1) - 0.05 * (x**4).sum(-1)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, D))
    m = rng.standard_normal((C, D))
    return x, m / np.linalg.norm(m, axis=1, keepdims=True)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


INTEGRATORS = ["isokinetic_velocity_verlet", "isokinetic_mclachlan",
               "isokinetic_yoshida", "isokinetic_omelyan"]


@pytest.mark.parametrize("name", INTEGRATORS)
def test_isokinetic_integrators_match_reference(name):
    x, m = _inputs(0)
    imm = np.random.default_rng(1).uniform(0.5, 2.0, D)
    ref_step = getattr(jint, name)(jlogdensity, jnp.asarray(imm))

    def ref_chain(xc, mc):
        state = jint.new_integrator_state(jlogdensity, xc, mc)
        for _ in range(3):
            state, dK = ref_step(state, 0.3)
        return state, dK

    ref_state, ref_dK = jax.vmap(ref_chain)(jnp.asarray(x), jnp.asarray(m))
    step = getattr(integrators, name)(tlogdensity, _t(imm))
    state = integrators.new_integrator_state(tlogdensity, _t(x), _t(m))
    for _ in range(3):
        state, dK = step(state, 0.3)
    for got, expected in zip(state, ref_state):
        _close(got, expected)
    _close(dK, ref_dK)
    _close(torch.linalg.vector_norm(state.momentum, dim=-1), np.ones(C))


@pytest.mark.parametrize("imm", [1.0, "diagonal"])
def test_esh_kick_matches_reference(imm):
    x, m = _inputs(2)
    if imm == "diagonal":
        imm = np.random.default_rng(3).uniform(0.5, 2.0, D)
    g = jax.vmap(jax.grad(jlogdensity))(jnp.asarray(x))
    ref_kick, ref_velocity = jint.esh_momentum_kick(jnp.asarray(imm))
    kick, velocity = integrators.esh_momentum_kick(_t(imm))
    for dt in (0.01, 0.4, 3.0):
        ref_m, ref_dK = jax.vmap(lambda mc, gc: ref_kick(mc, gc, dt))(jnp.asarray(m), g)
        got_m, got_dK = kick(_t(m), _t(g), dt)
        _close(got_m, ref_m)
        _close(got_dK, ref_dK)
    _close(velocity(_t(m)), jax.vmap(ref_velocity)(jnp.asarray(m)))
    # one (d,) chain works as well as a (C, d) block
    one_m, one_dK = kick(_t(m[0]), _t(g[0]), 0.4)
    _close(one_m, ref_kick(jnp.asarray(m[0]), g[0], 0.4)[0])
    assert one_dK.shape == ()


def test_low_rank_inverse_mass_matrix_is_refused():
    with pytest.raises(NotImplementedError, match="queue 1, item 6"):
        integrators.esh_momentum_kick((torch.ones(D), torch.zeros(D, 1), torch.ones(1)))


def test_partially_refresh_momentum_on_the_reference_normals():
    _, m = _inputs(4)
    keys = jax.random.split(jax.random.key(5), C)
    for L in (0.7, 3.0):
        ref = jax.vmap(lambda mc, k: jint.partially_refresh_momentum(mc, k, 0.2, L))(
            jnp.asarray(m), keys)
        z = jax.vmap(lambda k: jax.random.normal(k, (D,), jnp.float64))(keys)
        _close(integrators.partially_refresh_momentum(_t(m), _t(z), 0.2, L), ref)
    # L = inf is the identity, and a generator draws shaped like the momentum
    same = integrators.partially_refresh_momentum(_t(m), torch.Generator().manual_seed(0),
                                                  0.2, math.inf)
    assert torch.equal(same, _t(m))


def _reference_draws(key, d):
    """The draws of the reference's ``mclmc`` kernel at ``key`` for one
    chain, in the port's order (``MCLMCDraws``)."""
    kernel_key, energy_key, nan_key = jax.random.split(key, 3)
    key_pre, key_post = jax.random.split(kernel_key)
    return (
        jax.random.normal(key_pre, (d,), jnp.float64),
        jax.random.normal(key_post, (d,), jnp.float64),
        jint_unit(energy_key, d),
        jint_unit(nan_key, d),
    )


def jint_unit(key, d):
    from blackjax_tpu.util import generate_unit_vector as junit

    return junit(key, jnp.zeros(d))


def _kink_logdensity(jax_side):
    """A target that turns NaN for x[0] < -1: chains started near the edge
    cross it within one step."""
    if jax_side:
        return lambda x: jlogdensity(x) + jnp.log(x[0] + 1.0)
    return lambda x: tlogdensity(x) + torch.log(x[..., 0] + 1.0)


@pytest.mark.parametrize("case", ["plain", "nan", "high_energy"])
def test_mclmc_transition_on_the_reference_draws(case):
    x, _ = _inputs(6)
    jld, tld, ratio, eps = jlogdensity, tlogdensity, math.inf, 0.4
    if case == "nan":
        jld, tld = _kink_logdensity(True), _kink_logdensity(False)
        x[:, 0] = np.array([-0.999, -0.95, 0.5, -0.9999, 1.0])
    if case == "high_energy":
        ratio, eps = 1.0, 1.2
        x *= np.array([0.1, 2.0, 0.3, 2.5, 1.0])[:, None]
    imm = np.random.default_rng(7).uniform(0.5, 2.0, D)
    keys = jax.random.split(jax.random.key(8), C)
    ref_kernel = jmclmc.build_kernel(desired_energy_var_max_ratio=ratio)
    init_keys = jax.random.split(jax.random.key(9), C)
    ref_state = jax.vmap(lambda xc, k: jmclmc.init(xc, jld, k))(jnp.asarray(x), init_keys)
    ref_new, ref_info = jax.vmap(
        lambda k, s: ref_kernel(k, s, jld, jnp.asarray(imm), 1.3, eps))(keys, ref_state)
    draws = mclmc.MCLMCDraws(*(_t(v) for v in jax.vmap(lambda k: _reference_draws(k, D))(keys)))

    kernel = mclmc.build_kernel(desired_energy_var_max_ratio=ratio)
    state = interop.mclmc_state(ref_state)
    new, info = kernel(draws, state, tld, _t(imm), 1.3, eps)
    for got, expected in zip(new, ref_new):
        _close(got, expected)
    for got, expected in zip(info, ref_info):
        _close(got, expected)
    # a NaN log density makes a NaN energy change, which the high-energy
    # guard reverts before the NaN guard looks (as in the reference)
    reverted = np.asarray(ref_info.energy_change) == 0.0
    if case == "plain":
        assert not reverted.any()
    else:  # both outcomes exercised
        assert 0 < reverted.sum() < C


def test_handle_nans_and_high_energy_match_reference():
    """The two guards on hand-made states with non-finite rows."""
    x, m = _inputs(13)
    ld = np.arange(C, dtype=np.float64)
    prev = (x, m, ld, -x)
    nxt = [v.copy() for v in (x + 0.1, m[::-1], ld + 0.5, -x - 0.1)]
    nxt[0][1, 2] = np.nan
    nxt[1][3, 0] = np.inf
    nxt[2][4] = np.nan
    energy = np.array([3.0, -0.5, 0.0, 0.5, np.nan])
    info = (ld + 0.5, energy - 0.3, energy, np.ones(C, bool))
    units = jax.vmap(lambda k: jint_unit(k, D))(jax.random.split(jax.random.key(14), C))

    def ref_guards(p, n, i, k):
        p, n = jint.IntegratorState(*p), jint.IntegratorState(*n)
        s, i = jmclmc.handle_high_energy(p, n, jmclmc.MCLMCInfo(*i), k, 1.0)
        return jmclmc.handle_nans(p, s, i, k)

    keys = jax.random.split(jax.random.key(14), C)
    ref_state, ref_info = jax.vmap(ref_guards)(prev, tuple(nxt), info, keys)
    # the reference draws both reverts' unit vectors from the same key here
    tprev = integrators.IntegratorState(*(_t(v) for v in prev))
    tnext = integrators.IntegratorState(*(_t(v) for v in nxt))
    tinfo = mclmc.MCLMCInfo(*(torch.from_numpy(np.array(v)) for v in info))
    state, tinfo = mclmc.handle_high_energy(tprev, tnext, tinfo, _t(units), 1.0)
    state, tinfo = mclmc.handle_nans(tprev, state, tinfo, _t(units))
    for got, expected in zip(state, ref_state):
        _close(got, expected)
    for got, expected in zip(tinfo, ref_info):
        _close(got, expected)
    np.testing.assert_array_equal(tinfo.nonans.numpy(), [True, False, True, False, True])


def test_generator_draws_and_top_level_api():
    """A generator gives the documented draws in order; the registered
    ``mclmc`` inits unit momenta and keeps them unit; a 1-d target is
    refused."""
    x = torch.from_numpy(_inputs(10)[0])
    draws = mclmc.draw(torch.Generator().manual_seed(3), x)
    g = torch.Generator().manual_seed(3)
    first, second = torch.randn(x.shape, generator=g, dtype=x.dtype), torch.randn(
        x.shape, generator=g, dtype=x.dtype)
    assert torch.equal(draws.refresh_before, first) and torch.equal(draws.refresh_after, second)
    assert torch.equal(draws.revert_energy, generate_unit_vector(g, x))
    algo = blackjax_tpu_torch.mclmc(tlogdensity, L=2.0, step_size=0.5, inverse_mass_matrix=1.0)
    gen = torch.Generator().manual_seed(0)
    state = algo.init(x, gen)
    for _ in range(5):
        state, info = algo.step(gen, state)
    _close(torch.linalg.vector_norm(state.momentum, dim=-1), np.ones(C), rtol=1e-12)
    assert info.energy_change.shape == (C,) and bool(info.nonans.all())
    with pytest.raises(ValueError, match="more than 1 dimension"):
        mclmc.init(torch.zeros(C, 1, dtype=torch.float64), tlogdensity, gen)


def test_controller_and_variance_stream_exact():
    rng = np.random.default_rng(11)
    energies = rng.normal(0.0, 0.05, 40)
    energies[[5, 17]] = [3.0, 0.0]  # a far-off ratio and an exact zero
    jctrl = jada._EpsController(0.0, 0.0, jnp.inf)
    ctrl = ada._EpsController(*(torch.tensor(v, dtype=torch.float64) for v in (0.0, 0.0, math.inf)))
    eps = jeps = 0.7
    eps = torch.tensor(eps, dtype=torch.float64)
    for i, de in enumerate(energies):
        ceiling = 0.5 if i == 20 else None
        if ceiling is not None:
            jctrl, ctrl = jctrl._replace(ceiling=ceiling), ctrl._replace(
                ceiling=torch.tensor(ceiling, dtype=torch.float64))
        jctrl, jeps = jada._controller_propose(jctrl, jeps, de**2, D, 5e-4, 1.5, 0.98)
        ctrl, eps = ada._controller_propose(
            ctrl, eps, torch.tensor(de**2, dtype=torch.float64), D, 5e-4, 1.5, 0.98)
        _close(eps, jeps)
        for got, expected in zip(ctrl, jctrl):
            _close(got, expected)

    jstream = jada._var_stream_init(D)
    stream = ada._var_stream_init(D, dtype=torch.float64)
    for i, xs in enumerate(rng.standard_normal((30, D))):
        weight = 0.0 if i < 3 else rng.uniform(0.1, 1.0)
        jstream = jada._var_stream_push(jstream, jnp.asarray(xs), weight)
        stream = ada._var_stream_push(stream, _t(xs), torch.tensor(weight, dtype=torch.float64))
        for got, expected in zip(stream, jstream):
            _close(got, expected)
    _close(ada._var_stream_read(stream), jada._var_stream_read(jstream))


# a small ill-conditioned Gaussian for the tuner
TUNE_VAR = np.array([0.1, 0.5, 1.0, 3.0, 10.0])


def test_find_L_and_step_size_statistically():
    """The port's tuner and the reference's, on the same target from the
    same start, land within a factor of each other. Their draws differ, and
    one chain's 267 streamed variances are noisy: over seeds 0-3 the two
    packages' L differed by up to 1.5x, the step size by up to 1.15x and a
    variance by up to 3.4x. So: L within 2x, the step size within 1.25x,
    each variance within 4x of the reference's and 3x of the truth, and
    their geometric mean within 1.5x of the reference's."""
    d = TUNE_VAR.size
    inv_var = 1.0 / TUNE_VAR

    def jld(x):
        return -0.5 * jnp.sum(x**2 * inv_var)

    def tld(x):
        return -0.5 * (x**2 * torch.from_numpy(inv_var)).sum(-1)

    x0 = np.full(d, 0.5)
    num_steps = 1500
    key_init, key_tune = jax.random.split(jax.random.key(12))
    ref_state = jmclmc.init(jnp.asarray(x0), jld, key_init)
    # one compiled call of the reference's tuner: run eagerly, it compiles
    # each of its ~150 small steps on its own (same results, measured)
    ref_params, ref_total = jax.jit(lambda s, k: jada.mclmc_find_L_and_step_size(
        jmclmc.build_kernel(), num_steps, s, k, logdensity_fn=jld)[1:],
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_cpu_use_fusion_emitters": False})(ref_state, key_tune)
    ref_total = int(ref_total)
    gen = torch.Generator().manual_seed(12)
    state = mclmc.init(_t(x0), tld, gen)
    tuned_state, params, total = blackjax_tpu_torch.mclmc_find_L_and_step_size(
        mclmc.build_kernel(), num_steps, state, gen, logdensity_fn=tld)
    ref = interop.mclmc_parameters(ref_params)
    assert total == ref_total == 150 + 200 + 150
    assert params.L.dim() == 0 and params.step_size.dim() == 0
    assert params.inverse_mass_matrix.shape == (d,)
    assert 0.5 < float(params.L) / ref.L < 2.0
    assert 0.8 < float(params.step_size) / ref.step_size < 1.25
    imm = params.inverse_mass_matrix.numpy()
    ratio = imm / ref.inverse_mass_matrix.numpy()
    assert np.all((ratio > 1 / 4) & (ratio < 4)), ratio
    assert 1 / 1.5 < np.exp(np.log(ratio).mean()) < 1.5, ratio
    assert np.all((imm / TUNE_VAR > 1 / 3) & (imm / TUNE_VAR < 3)), imm
    assert torch.isfinite(tuned_state.position).all()
    with pytest.raises(ValueError, match="one chain"):
        blackjax_tpu_torch.mclmc_find_L_and_step_size(
            mclmc.build_kernel(), 10, mclmc.init(torch.zeros(2, d, dtype=torch.float64), tld,
                                                 gen), gen, logdensity_fn=tld)


def test_interop_carries_state_and_parameters():
    ref_state = jmclmc.init(jnp.ones(D), jlogdensity, jax.random.key(0))
    state = interop.mclmc_state(ref_state, dtype=torch.float32)
    assert isinstance(state, type(mclmc.init(torch.ones(D), tlogdensity,
                                             torch.Generator().manual_seed(0))))
    assert state.position.dtype == torch.float32
    _close(state.momentum, ref_state.momentum, rtol=1e-6)
    params = interop.mclmc_parameters(
        jada.MCLMCAdaptationState(jnp.asarray(2.5), jnp.asarray(0.3), jnp.ones(D)))
    assert params.L == 2.5 and params.step_size == 0.3
    assert params.inverse_mass_matrix.shape == (D,)
