"""The port's variational families (``vi._gaussian_vi``, ``vi.meanfield_vi``,
``vi.fullrank_vi``, ``vi.svgd``, ``vi.schrodinger_follmer``) against the JAX
package, in float64 on the same keys (``interop.prng_key``), on a
correlated Gaussian of ``D = 5`` dimensions made with numpy:

- ``elbo_step``, one step of the mean-field family from one key, for KL and
  the Rényi bound at alpha 0.5 and 1.0, the sticking-the-landing estimator
  on and off: the parameters, Adam's state and the loss within 1e-12; at
  alpha = 1 the step is the KL step bit for bit; STL with alpha != 1
  raises;
- ``meanfield_vi`` and ``fullrank_vi`` through the top-level API with
  ``optax_twins.adam(0.05)``, 50 steps on ``fold_in(key, i)``: every step's
  parameters and ELBO within 1e-10, the final state (Adam's among it,
  through ``interop.sampler_state``), and ``sample`` draw for draw; the
  triangle's order, the factor and both log densities;
- ``svgd``: the functional gradient for ``rbf_kernel`` (the closed form)
  and for an inverse multiquadric kernel (the generic path) within 1e-12,
  the closed form against the generic path on the same RBF kernel,
  ``median_heuristic`` at 80 particles (3,160 pairs: an even count, where
  the lower of the two middle values would fail), 20 steps of 40 particles
  with ``optax_twins.sgd(0.3)`` within 1e-10;
- ``schrodinger_follmer``: ``step`` on one bridge and on 16, and ``sample``
  of 16 bridges x 10 steps x 32 inner draws, within 1e-10;
- phase 23's bands are ``tools/vi_reference.py``'s numbers.

The JAX side is three programs (the Gaussian families, SVGD, the
Schrödinger-Föllmer sampler), each compiled once for the module at XLA's
optimization level 0 with its older CPU fusion emitters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import blackjax_tpu  # noqa: E402
from blackjax_tpu.vi import _gaussian_vi as jgvi  # noqa: E402
from blackjax_tpu.vi import fullrank_vi as jfr  # noqa: E402
from blackjax_tpu.vi import meanfield_vi as jmf  # noqa: E402
from blackjax_tpu.vi import schrodinger_follmer as jsf  # noqa: E402
from blackjax_tpu.vi import svgd as jsvgd  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
import chip_smoke  # noqa: E402
from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.optimizers import optax_twins  # noqa: E402
from blackjax_tpu_torch.vi import _gaussian_vi as gvi  # noqa: E402
from blackjax_tpu_torch.vi import fullrank_vi, meanfield_vi, schrodinger_follmer, svgd  # noqa: E402
from tools import vi_reference  # noqa: E402

D, LR, STEPS, NUM_SAMPLES, DRAWS = 5, 0.05, 50, 20, 7
SVGD_N, SVGD_STEPS, SVGD_LR, MEDIAN_N = 40, 20, 0.3, 80
SF_BRIDGES, SF_STEPS, SF_INNER = 16, 10, 32
_rng = np.random.default_rng(24)
MEAN = _rng.standard_normal(D)
_A = _rng.standard_normal((D, D))
PRECISION = _A @ _A.T / D + np.eye(D)
MU0, RHO0 = 0.3 * _rng.standard_normal(D), -1.0 + 0.2 * _rng.standard_normal(D)
PARTICLES = 1.5 * _rng.standard_normal((SVGD_N, D)) + 1.0
MEDIAN_PARTICLES = _rng.standard_normal((MEDIAN_N, D))
SF_POSITION, SF_TIME = 0.5 * _rng.standard_normal(D), 0.3
CASES = {
    "KL, STL": (jgvi.KL(), gvi.KL(), True),
    "KL": (jgvi.KL(), gvi.KL(), False),
    "Renyi 0.5": (jgvi.RenyiAlpha(0.5), gvi.RenyiAlpha(0.5), False),
    "Renyi 1.0, STL": (jgvi.RenyiAlpha(1.0), gvi.RenyiAlpha(1.0), True),
    "Renyi 1.0": (jgvi.RenyiAlpha(1.0), gvi.RenyiAlpha(1.0), False),
}
FAMILIES = {"meanfield_vi": meanfield_vi, "fullrank_vi": fullrank_vi}


def jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_cpu_use_fusion_emitters": False})


def _close(got, expected, tol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(expected, np.float64), rtol=tol, atol=tol)


def _keys(seed):
    key = jax.random.key(seed)
    return key, interop.prng_key(jax.random.key_data(key))


def jlogdensity(x):
    centred = x - MEAN
    return -0.5 * centred @ PRECISION @ centred


def logdensity(x):
    centred = x - torch.from_numpy(MEAN)
    return -0.5 * ((centred @ torch.from_numpy(PRECISION)) * centred).sum(-1)


def grad_logdensity(x):
    return -(x - torch.from_numpy(MEAN)) @ torch.from_numpy(PRECISION)


def jimq_kernel(x, y, length_scale=1.0):
    return (1.0 + jnp.sum((x - y) ** 2) / length_scale) ** -0.5


def imq_kernel(x, y, length_scale=1.0):
    return (1.0 + torch.square(x - y).sum(-1) / length_scale) ** -0.5


def _capture(port):
    """An optimizer that leaves the particles where they are and keeps the
    functional gradient as its state."""
    if port:
        return optax_twins.GradientTransformation(
            torch.zeros_like, lambda u, s, p=None: (torch.zeros_like(u), u))
    return optax.GradientTransformation(jnp.zeros_like, lambda u, s, p=None: (u * 0.0, u))


# ---------------------------------------------------------------------------
# the JAX package's runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gaussian_reference():
    key = jax.random.key(5)

    def program():
        out = {}
        opt = optax.adam(LR)
        params = (jnp.asarray(MU0), jnp.asarray(RHO0))
        for name, (objective, _, stl) in CASES.items():
            out[name] = jgvi.elbo_step(
                key, params, opt.init(params), jlogdensity, opt,
                lambda k, p, n: jmf._sample(k, p[0], p[1], n),
                lambda p: jmf.generate_meanfield_logdensity(p[0], p[1]),
                NUM_SAMPLES, objective=objective, stl_estimator=stl)
        for name in FAMILIES:
            algo = getattr(blackjax_tpu, name)(jlogdensity, opt, num_samples=NUM_SAMPLES)
            state = algo.init(jnp.zeros(D))

            def body(s, i):
                s, info = algo.step(jax.random.fold_in(key, i), s)
                return s, (s[0], s[1], info.elbo)

            final, history = jax.lax.scan(body, state, jnp.arange(STEPS))
            out[name] = (final, history, algo.sample(jax.random.key(6), final, DRAWS))
        chol = 0.3 * jnp.asarray(np.random.default_rng(1).standard_normal(D * (D + 1) // 2))
        draws = jnp.asarray(np.random.default_rng(2).standard_normal((DRAWS, D)))
        out["factor"] = jfr._unflatten_cholesky(chol, D)
        out["logq"] = (jax.vmap(jfr.generate_fullrank_logdensity(jnp.asarray(MU0), chol))(draws),
                       jax.vmap(jmf.generate_meanfield_logdensity(jnp.asarray(MU0),
                                                                 jnp.asarray(RHO0)))(draws))
        return out

    return jit(program)()


@pytest.fixture(scope="module")
def svgd_reference():
    def program():
        x = jnp.asarray(PARTICLES)
        params = {"length_scale": jnp.asarray(2.5)}
        out = {}
        for name, kern in (("rbf", jsvgd.rbf_kernel), ("imq", jimq_kernel)):
            state = jsvgd.init(x, params, _capture(False))
            out[name] = jsvgd.build_kernel(_capture(False))(state, jax.grad(jlogdensity),
                                                            kern).opt_state
        out["median"] = jsvgd.median_heuristic({"length_scale": 1.0},
                                               jnp.asarray(MEDIAN_PARTICLES))["length_scale"]
        algo = jsvgd.as_top_level_api(jax.grad(jlogdensity), optax.sgd(SVGD_LR))
        state = algo.init(x)

        def body(s, _):
            s = algo.step(s)
            return s, (s.particles, s.kernel_parameters["length_scale"])

        out["run"] = jax.lax.scan(body, state, None, length=SVGD_STEPS)
        return out

    return jit(program)()


@pytest.fixture(scope="module")
def sf_reference():
    key = jax.random.key(8)

    def program():
        state = jsf.SchrodingerFollmerState(jnp.asarray(SF_POSITION), jnp.asarray(SF_TIME))
        one = jsf.step(key, state, jlogdensity, 1.0 / SF_STEPS, SF_INNER)
        keys = jax.random.split(key, SF_BRIDGES)
        states = jsf.SchrodingerFollmerState(jnp.tile(state.position, (SF_BRIDGES, 1)),
                                             jnp.full((SF_BRIDGES,), SF_TIME))
        many = jax.vmap(jsf.step, [0, 0, None, None, None])(keys, states, jlogdensity,
                                                             1.0 / SF_STEPS, SF_INNER)
        final = jsf.sample(key, jsf.init(jnp.zeros(D)), jlogdensity, SF_STEPS, SF_INNER,
                           SF_BRIDGES)
        return one, many, final

    return jit(program)()


# ---------------------------------------------------------------------------
# elbo_step
# ---------------------------------------------------------------------------


def _port_elbo_step(case, key):
    _, objective, stl = CASES[case]
    opt = optax_twins.adam(LR)
    params = (torch.from_numpy(MU0), torch.from_numpy(RHO0))
    return gvi.elbo_step(
        key, params, opt.init(params), logdensity, opt,
        lambda k, p, n: meanfield_vi._sample(k, p[0], p[1], n),
        lambda p: meanfield_vi.generate_meanfield_logdensity(p[0], p[1]),
        NUM_SAMPLES, objective=objective, stl_estimator=stl)


@pytest.mark.parametrize("case", sorted(CASES))
def test_elbo_step_is_the_reference_s(gaussian_reference, case):
    params, (adam, _), loss = _port_elbo_step(case, _keys(5)[1])
    ref_params, (ref_adam, _), ref_loss = gaussian_reference[case]
    for got, expected in zip(params + adam.mu + adam.nu, ref_params + ref_adam.mu + ref_adam.nu):
        _close(got, expected, 1e-12)
    _close(loss, ref_loss, 1e-12)
    assert int(adam.count) == int(ref_adam.count) == 1


@pytest.mark.parametrize("stl", [True, False])
def test_renyi_alpha_one_is_the_kl_step(stl):
    key = _keys(5)[1]
    kl = _port_elbo_step("KL, STL" if stl else "KL", key)
    renyi = _port_elbo_step("Renyi 1.0, STL" if stl else "Renyi 1.0", key)
    for a, b in zip(kl[0] + (kl[2],), renyi[0] + (renyi[2],)):
        assert torch.equal(a, b)


def test_stl_with_alpha_not_one_raises():
    opt = optax_twins.adam(LR)
    state = meanfield_vi.init(torch.zeros(D, dtype=torch.float64), opt)
    with pytest.raises(ValueError, match="stl_estimator"):
        meanfield_vi.step(_keys(5)[1], state, logdensity, opt, objective=gvi.RenyiAlpha(0.5))


# ---------------------------------------------------------------------------
# the Gaussian families
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_fifty_steps_and_sample_are_the_reference_s(gaussian_reference, name):
    module = FAMILIES[name]
    final, history, draws = gaussian_reference[name]
    algo = getattr(blackjax_tpu_torch, name)(logdensity, optax_twins.adam(LR),
                                             num_samples=NUM_SAMPLES)
    state = algo.init(torch.zeros(D, dtype=torch.float64))
    key = _keys(5)[1]
    for i in range(STEPS):
        state, info = algo.step(prng.fold_in(key, i), state)
        _close(state[0], history[0][i], 1e-10)
        _close(state[1], history[1][i], 1e-10)
        _close(info.elbo, history[2][i], 1e-10)
    restarted = interop.sampler_state(jax.tree.map(np.asarray, final))
    assert type(restarted) is type(state)
    (adam, _), (ref_adam, _) = state.opt_state, restarted.opt_state
    assert int(adam.count) == int(ref_adam.count) == STEPS
    for got, expected in zip(state[:2] + adam.mu + adam.nu,
                             restarted[:2] + ref_adam.mu + ref_adam.nu):
        _close(got, expected, 1e-10)
    # draw for draw, from the reference's own final state
    _close(module.sample(_keys(6)[1], restarted, DRAWS), draws, 1e-12)
    assert algo.sample(_keys(6)[1], state, DRAWS).shape == (DRAWS, D)


def test_triangle_order_factor_and_log_densities(gaussian_reference):
    rows, cols = torch.tril_indices(D, D, -1)
    expected = np.stack(np.tril_indices(D, k=-1))
    np.testing.assert_array_equal(torch.stack((rows, cols)).numpy(), expected)
    chol = 0.3 * torch.from_numpy(np.random.default_rng(1).standard_normal(D * (D + 1) // 2))
    draws = torch.from_numpy(np.random.default_rng(2).standard_normal((DRAWS, D)))
    _close(fullrank_vi._unflatten_cholesky(chol, D), gaussian_reference["factor"], 0)
    mu = torch.from_numpy(MU0)
    fr_logq, mf_logq = gaussian_reference["logq"]
    _close(fullrank_vi.generate_fullrank_logdensity(mu, chol)(draws), fr_logq, 1e-12)
    _close(meanfield_vi.generate_meanfield_logdensity(mu, torch.from_numpy(RHO0))(draws),
           mf_logq, 1e-12)
    # a batch of batches, and one draw
    batched = fullrank_vi.generate_fullrank_logdensity(mu, chol)(draws.reshape(1, DRAWS, D))
    assert batched.shape == (1, DRAWS)
    _close(fullrank_vi.generate_fullrank_logdensity(mu, chol)(draws[3]), fr_logq[3], 1e-12)


@pytest.mark.parametrize("name", ["meanfield_vi", "fullrank_vi", "schrodinger_follmer"])
def test_a_pytree_position_names_the_queue_item(name):
    api = getattr(blackjax_tpu_torch, name)
    algo = api(logdensity, 10, 4) if name == "schrodinger_follmer" else api(
        logdensity, optax_twins.adam(LR))
    with pytest.raises(ValueError, match="item 11"):
        algo.init({"w": torch.zeros(D)})


# ---------------------------------------------------------------------------
# SVGD
# ---------------------------------------------------------------------------


def _port_functional_gradient(kern):
    state = svgd.init(torch.from_numpy(PARTICLES), {"length_scale": torch.tensor(2.5,
                                                    dtype=torch.float64)}, _capture(True))
    return svgd.build_kernel(_capture(True))(state, grad_logdensity, kern).opt_state


@pytest.mark.parametrize("name", ["rbf", "imq"])
def test_functional_gradient_is_the_reference_s(svgd_reference, name):
    kern = svgd.rbf_kernel if name == "rbf" else imq_kernel
    _close(_port_functional_gradient(kern), svgd_reference[name], 1e-12)


def test_the_rbf_closed_form_is_the_generic_path():
    closed = _port_functional_gradient(svgd.rbf_kernel)
    generic = _port_functional_gradient(lambda x, y, length_scale: svgd.rbf_kernel(x, y,
                                                                                  length_scale))
    _close(closed, generic.numpy(), 1e-12)


def test_median_heuristic_at_an_even_pair_count(svgd_reference):
    x = torch.from_numpy(MEDIAN_PARTICLES)
    params = svgd.median_heuristic({"length_scale": 1.0, "other": 3}, x)
    assert params["other"] == 3
    expected = float(svgd_reference["median"])
    _close(params["length_scale"], expected, 1e-13)
    # 3,160 pairs: the lower of the two middle values gives another length scale
    below = torch.sort(svgd._below_diagonal_distances(x)).values
    assert below.numel() == MEDIAN_N * (MEDIAN_N - 1) // 2 == 3160
    lower = float(below[below.numel() // 2 - 1] ** 2 / np.log(MEDIAN_N))
    assert abs(lower - expected) > 1e-6 * expected
    # the distances are explicit differences, in jnp.tril_indices' order
    rows, cols = np.tril_indices(MEDIAN_N, k=-1)
    explicit = np.linalg.norm(MEDIAN_PARTICLES[rows] - MEDIAN_PARTICLES[cols], axis=-1)
    _close(svgd._below_diagonal_distances(x), explicit, 1e-15)


def test_twenty_steps_are_the_reference_s(svgd_reference):
    (final, (particles, length_scales)) = svgd_reference["run"]
    algo = blackjax_tpu_torch.svgd(grad_logdensity, optax_twins.sgd(SVGD_LR))
    state = algo.init(torch.from_numpy(PARTICLES))
    for i in range(SVGD_STEPS):
        state = algo.step(state)
        _close(state.particles, particles[i], 1e-10)
        _close(state.kernel_parameters["length_scale"], length_scales[i], 1e-10)
    restarted = interop.sampler_state(jax.tree.map(np.asarray, final))
    assert isinstance(restarted, svgd.SVGDState)
    _close(state.particles, restarted.particles, 1e-10)
    assert restarted.opt_state == (optax_twins.EmptyState(), optax_twins.EmptyState())


# ---------------------------------------------------------------------------
# the Schrödinger-Föllmer sampler
# ---------------------------------------------------------------------------


def test_step_is_the_reference_s_on_one_bridge_and_many(sf_reference):
    one, many, _ = sf_reference
    key = _keys(8)[1]
    state = schrodinger_follmer.SchrodingerFollmerState(
        torch.from_numpy(SF_POSITION), torch.tensor(SF_TIME, dtype=torch.float64))
    got, info = schrodinger_follmer.step(key, state, logdensity, 1.0 / SF_STEPS, SF_INNER)
    for a, b in zip(got + info, one[0] + one[1]):
        _close(a, b, 1e-10)
    states = schrodinger_follmer.SchrodingerFollmerState(
        state.position.expand(SF_BRIDGES, D), state.time.expand(SF_BRIDGES))
    got, info = schrodinger_follmer.step(prng.split(key, SF_BRIDGES), states, logdensity,
                                         1.0 / SF_STEPS, SF_INNER)
    for a, b in zip(got + info, many[0] + many[1]):
        _close(a, b, 1e-10)


def test_sample_is_the_reference_s(sf_reference):
    final = sf_reference[2]
    algo = blackjax_tpu_torch.schrodinger_follmer(logdensity, SF_STEPS, SF_INNER)
    state = algo.init(torch.zeros(D, dtype=torch.float64))
    assert state.time.dtype == torch.float64 and state.time.shape == ()
    out = algo.sample(_keys(8)[1], state, SF_BRIDGES)
    _close(out.position, final.position, 1e-10)
    _close(out.time, final.time, 1e-12)
    restarted = interop.sampler_state(jax.tree.map(np.asarray, final))
    assert isinstance(restarted, schrodinger_follmer.SchrodingerFollmerState)
    _close(out.position, restarted.position, 1e-10)


def test_chip_smoke_bands_are_the_reference():
    """chip_smoke.py phase 23's bands are tools/vi_reference.py's output: the
    Gaussian families' three times the keys' spread, 5 % of the mean or, about
    0, 0.01; the particle families' with the drift from 256 particles (SVGD's
    centred at 4,096)."""
    recorded = vi_reference.RECORDED
    assert set(chip_smoke.VI_REFERENCE) == set(recorded)
    runs = {1024: {}, 256: {}}
    for family, entries in recorded.items():
        bands = {k[:-5]: tuple(v) for k, v in entries.items() if k.endswith("_band")}
        assert chip_smoke.VI_REFERENCE[family] == bands
        if "at_256" in entries:
            runs[1024][family] = {s: entries[s] for s in vi_reference.PARTICLE_NAMES}
            runs[256][family] = entries["at_256"]
        else:
            for stat, values in entries.items():
                if not stat.endswith("_band"):
                    zero = stat in vi_reference.ZERO
                    assert vi_reference.band(values, zero=zero) == bands[stat]
    for family, entries in vi_reference.particle_bands(runs).items():
        assert {k[:-5]: tuple(v) for k, v in entries.items() if k.endswith("_band")} == \
            chip_smoke.VI_REFERENCE[family]
