"""The port's Barker, random walks, adjusted MCLMC (static and dynamic),
elliptical slice, slice samplers, periodic orbital HMC and mGrad against the
JAX package in float64 on the same keys (``interop.prng_key``).

Each sampler runs a few transitions of 8-16 chains from the same start in
both packages; the reference is jitted and vmapped over chains. Positions
and every other state field agree within 1e-12; accept flags, drawn step
counts, elliptical slice's ``subiter`` and the slice samplers'
``num_expansions`` and ``num_shrink`` are identical. mGrad runs on the
reference's own ``CovarianceSVD`` (``interop.covariance_svd``), and
``svd_from_covariance`` is held on ``U Gamma U^T``. The converters carry
the reference's states into the port, a ``torch.Generator`` draws one key a
chain, and a position that is not a tensor is refused.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
from blackjax_tpu.mcmc import adjusted_mclmc_dynamic as jamd  # noqa: E402
from blackjax_tpu.mcmc import marginal_latent_gaussian as jmgrad  # noqa: E402
from blackjax_tpu.mcmc import random_walk as jrw  # noqa: E402
from blackjax_tpu.mcmc import slice as jslice  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import adjusted_mclmc_dynamic as amd  # noqa: E402
from blackjax_tpu_torch.mcmc import (  # noqa: E402
    barker,
    elliptical_slice,
    marginal_latent_gaussian,
    periodic_orbital,
    random_walk,
)
from blackjax_tpu_torch.mcmc import slice as tslice  # noqa: E402

TOL = 1e-12
D, C, STEPS = 4, 12, 5
VAR = np.array([0.25, 1.0, 4.0, 2.0])
JIT = dict(compiler_options={"xla_backend_optimization_level": 0})


def _jld(x):
    return -0.5 * jnp.sum(x**2 / jnp.asarray(VAR) + 0.1 * x**4)


def _tld(x):
    return -0.5 * (x**2 / torch.from_numpy(VAR) + 0.1 * x**4).sum(-1)


def _jlik(x):
    return -0.5 * jnp.sum((x - 1.0) ** 2)


def _tlik(x):
    return -0.5 * ((x - 1.0) ** 2).sum(-1)


def _x0(chains=C):
    return np.random.default_rng(0).standard_normal((chains, D))


def _words(keys):
    return interop.prng_key(jax.random.key_data(keys))


def _hold(name, jalgo, talgo, *, init_key=None, steps=STEPS, chains=C, exact=(), seed=7,
          x0=None):
    """``steps`` transitions of both packages from the same start on the
    same keys: state fields within 1e-12 (the carried keys identical), the
    ``exact`` info fields identical. Returns the reference's infos."""
    x0 = _x0(chains) if x0 is None else x0
    if init_key is None:
        jstate = jax.vmap(jalgo.init)(jnp.asarray(x0))
        tstate = talgo.init(torch.from_numpy(x0))
    else:
        init_keys = jax.random.split(jax.random.key(init_key), chains)
        jstate = jax.vmap(jalgo.init)(jnp.asarray(x0), init_keys)
        tstate = talgo.init(torch.from_numpy(x0), _words(init_keys))
    step = jax.jit(jax.vmap(jalgo.step), **JIT)
    keys = jax.vmap(lambda k: jax.random.split(k, chains))(
        jax.random.split(jax.random.key(seed), steps))
    infos = []
    for k in keys:
        jstate, jinfo = step(k, jstate)
        tstate, tinfo = talgo.step(_words(k), tstate)
        for field in exact:
            np.testing.assert_array_equal(np.asarray(getattr(tinfo, field)),
                                          np.asarray(getattr(jinfo, field)),
                                          err_msg=f"{name} {field}")
        for field, a, b in zip(tstate._fields, tstate, jstate):
            if jnp.issubdtype(b.dtype, jax.dtypes.prng_key):
                b = jax.random.key_data(b)
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {field}")
        infos.append(jinfo)
    return infos


def _accept_share(infos):
    return float(np.mean([np.asarray(i.is_accepted) for i in infos]))


@pytest.mark.parametrize("metric", ["default", "dense"])
def test_barker_matches_reference(metric):
    imm = None
    if metric == "dense":
        a = np.random.default_rng(2).standard_normal((D, D))
        imm = a @ a.T / D + np.eye(D)
    jalgo = blackjax_tpu.barker(_jld, 0.9, None if imm is None else jnp.asarray(imm))
    talgo = blackjax_tpu_torch.barker(_tld, 0.9, None if imm is None else torch.from_numpy(imm))
    infos = _hold("barker", jalgo, talgo, exact=("is_accepted",))
    assert 0 < _accept_share(infos) < 1


@pytest.mark.parametrize("kind", ["normal_random_walk", "rmh", "irmh"])
def test_random_walks_match_reference(kind):
    sigma = np.array([0.9, 1.5, 2.5, 1.2])
    if kind == "normal_random_walk":
        jalgo = blackjax_tpu.normal_random_walk(_jld, jnp.asarray(sigma))
        talgo = blackjax_tpu_torch.normal_random_walk(_tld, torch.from_numpy(sigma))
    elif kind == "rmh":
        # an asymmetric proposal: a drift toward the origin, with its correction
        def jgen(key, x):
            return 0.8 * x + jax.random.normal(key, x.shape)

        def tgen(key, x):
            return 0.8 * x + blackjax_tpu_torch.prng.normal(key, x.shape[1:], x.dtype)

        jalgo = blackjax_tpu.rmh(_jld, jgen, lambda new, old: -0.5 * jnp.sum(
            (old.position - 0.8 * new.position) ** 2))
        talgo = blackjax_tpu_torch.rmh(_tld, tgen, lambda new, old: -0.5 * (
            (old.position - 0.8 * new.position) ** 2).sum(-1))
    else:
        def jdraw(key):
            return 1.5 * jax.random.normal(key, (D,))

        def tdraw(key):
            return 1.5 * blackjax_tpu_torch.prng.normal(key, (D,), torch.float64)

        # log q(new -> old): the independent proposal's density at old
        jalgo = blackjax_tpu.irmh(_jld, jdraw, lambda new, old: -jnp.sum(old.position**2) / 4.5)
        talgo = blackjax_tpu_torch.irmh(_tld, tdraw,
                                        lambda new, old: -(old.position**2).sum(-1) / 4.5)
    infos = _hold(kind, jalgo, talgo, exact=("is_accepted",))
    assert 0 < _accept_share(infos) < 1


@pytest.mark.parametrize("L_factor", [np.inf, 1.5])
def test_adjusted_mclmc_matches_reference(L_factor):
    jalgo = blackjax_tpu.adjusted_mclmc(_jld, 0.4, L_factor, num_integration_steps=5)
    talgo = blackjax_tpu_torch.adjusted_mclmc(_tld, 0.4, L_factor, num_integration_steps=5)
    infos = _hold("adjusted_mclmc", jalgo, talgo, exact=("is_accepted",))
    assert 0 < _accept_share(infos) < 1


@pytest.mark.parametrize("lengths", ["uniform", "jittered"])
def test_adjusted_mclmc_dynamic_matches_reference(lengths):
    kw = {}
    if lengths == "jittered":
        kw = dict(integration_steps_fn=None, integration_steps_params=(4.0,))
    jkw = dict(kw, integration_steps_fn=jamd.make_random_trajectory_length_fn(True)) if kw else {}
    tkw = dict(kw, integration_steps_fn=amd.make_random_trajectory_length_fn(True)) if kw else {}
    jalgo = blackjax_tpu.adjusted_mclmc_dynamic(_jld, 2.5, 2.0, **jkw)
    talgo = blackjax_tpu_torch.adjusted_mclmc_dynamic(_tld, 2.5, 2.0, **tkw)
    infos = _hold("adjusted_mclmc_dynamic", jalgo, talgo, init_key=13,
                  exact=("is_accepted", "num_integration_steps"))
    steps = np.stack([np.asarray(i.num_integration_steps) for i in infos])
    assert len(np.unique(steps)) > 2 and 0 < _accept_share(infos) < 1


@pytest.mark.parametrize("cov", ["diag", "dense"])
def test_elliptical_slice_matches_reference(cov):
    """The prior N(0, diag(VAR)) (or a dense covariance), a likelihood of
    N(1, 1) per coordinate (as ``tests/mcmc/test_more_samplers.py`` sets it
    up); ``subiter`` identical per chain."""
    prior = np.asarray(VAR)
    if cov == "dense":
        a = np.random.default_rng(3).standard_normal((D, D))
        prior = a @ a.T / D + np.diag(VAR)
    mean = np.linspace(-0.5, 0.5, D)
    jalgo = blackjax_tpu.elliptical_slice(_jlik, mean=jnp.asarray(mean), cov=jnp.asarray(prior))
    talgo = blackjax_tpu_torch.elliptical_slice(_tlik, mean=torch.from_numpy(mean),
                                                cov=torch.from_numpy(prior))
    infos = _hold("elliptical_slice", jalgo, talgo, exact=("subiter",))
    assert np.max([np.asarray(i.subiter) for i in infos]) > 1  # the shrink loop ran


@pytest.mark.parametrize("interval", ["doubling", "stepping_out"])
def test_slice_sampling_matches_reference(interval):
    jalgo = blackjax_tpu.slice_sampling(_jld, interval=getattr(jslice, interval), width=0.7,
                                        max_expansions=6)
    talgo = blackjax_tpu_torch.slice_sampling(_tld, interval=getattr(tslice, interval),
                                              width=0.7, max_expansions=6)
    infos = _hold("slice_sampling", jalgo, talgo,
                  exact=("is_accepted", "num_expansions", "num_shrink"))
    for field in ("num_expansions", "num_shrink"):
        assert np.unique(np.stack([np.asarray(getattr(i, field)) for i in infos])).size > 1


def test_coordinate_slice_matches_reference():
    widths = np.array([0.5, 1.0, 2.0, 1.5])
    jalgo = blackjax_tpu.coordinate_slice(_jld, initial_widths=jnp.asarray(widths),
                                          max_expansions=5)
    talgo = blackjax_tpu_torch.coordinate_slice(_tld, initial_widths=torch.from_numpy(widths),
                                                max_expansions=5)
    _hold("coordinate_slice", jalgo, talgo, chains=8, steps=3,
          exact=("is_accepted", "num_expansions", "num_shrink"))


def test_orbital_hmc_matches_reference():
    jalgo = blackjax_tpu.orbital_hmc(_jld, 0.4, jnp.asarray(VAR), 6)
    talgo = blackjax_tpu_torch.orbital_hmc(_tld, 0.4, torch.from_numpy(VAR), 6)
    _hold("orbital_hmc", jalgo, talgo, chains=8)


def test_mgrad_matches_reference_on_its_svd():
    a = np.random.default_rng(4).standard_normal((D, D))
    cov = a @ a.T / D + np.eye(D)
    cov_svd = jmgrad.svd_from_covariance(jnp.asarray(cov))
    jalgo = blackjax_tpu.mgrad_gaussian(_jlik, cov_svd=cov_svd, step_size=0.8)
    talgo = blackjax_tpu_torch.mgrad_gaussian(
        _tlik, cov_svd=interop.covariance_svd(tuple(np.asarray(v) for v in cov_svd)),
        step_size=0.8)
    infos = _hold("mgrad_gaussian", jalgo, talgo, exact=("is_accepted",))
    assert 0 < _accept_share(infos) < 1


def test_svd_from_covariance_reconstructs_the_covariance():
    a = np.random.default_rng(5).standard_normal((D, D))
    cov = a @ a.T / D + np.eye(D)
    U, Gamma, U_t = marginal_latent_gaussian.svd_from_covariance(torch.from_numpy(cov))
    jU, jGamma, _ = jmgrad.svd_from_covariance(jnp.asarray(cov))
    np.testing.assert_allclose(Gamma.numpy(), np.asarray(jGamma), rtol=TOL)
    np.testing.assert_allclose((U * Gamma @ U_t).numpy(), cov, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(np.abs(U.numpy()), np.abs(np.asarray(jU)), rtol=1e-10, atol=1e-10)


def test_mgrad_mean_shift_matches_reference():
    cov = np.diag(VAR)
    mean = np.linspace(-1.0, 1.0, D)
    jfn = jmgrad.generate_mean_shifted_logprob(_jlik, jnp.asarray(mean), jnp.asarray(cov))
    tfn = marginal_latent_gaussian.generate_mean_shifted_logprob(
        _tlik, torch.from_numpy(mean), torch.from_numpy(cov))
    x = _x0()
    np.testing.assert_allclose(tfn(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.vmap(jfn)(jnp.asarray(x))), rtol=TOL)


def test_converters_carry_the_reference_states():
    x = jnp.asarray(_x0())
    keys = jax.random.split(jax.random.key(2), C)
    cases = [
        (jax.vmap(lambda p: jrw.init(p, _jld))(x), random_walk.RWState),
        (jax.vmap(blackjax_tpu.barker(_jld, 0.5).init)(x), barker.BarkerState),
        (jax.vmap(blackjax_tpu.elliptical_slice(_jlik, mean=jnp.zeros(D), cov=jnp.ones(D)).init)(
            x), elliptical_slice.EllipSliceState),
        (jax.vmap(blackjax_tpu.slice_sampling(_jld).init)(x), tslice.SliceState),
        (jax.vmap(blackjax_tpu.orbital_hmc(_jld, 0.4, jnp.ones(D), 3).init)(x),
         periodic_orbital.PeriodicOrbitalState),
        (jax.vmap(blackjax_tpu.ghmc(_jld, 0.3, jnp.ones(D), 0.3, 0.2).init)(x, keys),
         blackjax_tpu_torch.mcmc.ghmc.GHMCState),
        (jax.vmap(blackjax_tpu.mgrad_gaussian(_jlik, covariance=jnp.eye(D)).init)(x),
         marginal_latent_gaussian.MarginalState),
    ]
    for state, cls in cases:
        port = interop.sampler_state(jax.tree.map(np.asarray, state))
        assert type(port) is cls
        for a, b in zip(port, state):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL)
    talgo = blackjax_tpu_torch.orbital_hmc(_tld, 0.4, torch.ones(D, dtype=torch.float64), 3)
    fresh = talgo.init(torch.from_numpy(_x0()))
    for a, b in zip(fresh, cases[4][0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL)


@pytest.mark.parametrize("name", ["barker", "random_walk", "elliptical_slice", "slice",
                                  "periodic_orbital", "marginal_latent_gaussian",
                                  "adjusted_mclmc"])
def test_pytree_positions_are_refused(name):
    module = getattr(blackjax_tpu_torch.mcmc, name)
    extra = {"periodic_orbital": (3,), "marginal_latent_gaussian": (torch.eye(3),)}.get(name, ())
    with pytest.raises(ValueError, match="ROADMAP queue 1, item 11"):
        module.init({"x": torch.zeros(3)}, lambda x: -(x["x"] ** 2).sum(), *extra)


@pytest.mark.parametrize("name", ["barker", "elliptical_slice", "slice_sampling", "ghmc"])
def test_a_generator_draws_one_key_a_chain(name):
    """A ``torch.Generator`` in place of key words draws one key a chain
    (``prng.from_generator``) and moves the chains as those keys do."""
    algo = {
        "barker": lambda: blackjax_tpu_torch.barker(_tld, 0.9),
        "elliptical_slice": lambda: blackjax_tpu_torch.elliptical_slice(
            _tlik, mean=torch.zeros(D, dtype=torch.float64), cov=torch.from_numpy(VAR)),
        "slice_sampling": lambda: blackjax_tpu_torch.slice_sampling(_tld),
        "ghmc": lambda: blackjax_tpu_torch.ghmc(_tld, 0.3, torch.ones(D, dtype=torch.float64),
                                                0.3, 0.2),
    }[name]()
    x0 = torch.from_numpy(_x0())
    init_args = (torch.Generator().manual_seed(1),) if name == "ghmc" else ()
    state = algo.init(x0, *init_args)
    again = algo.init(x0, *(blackjax_tpu_torch.prng.from_generator(
        torch.Generator().manual_seed(1), (C,)),) if name == "ghmc" else ())
    for a, b in zip(state, again):
        assert torch.equal(a, b)
    moved, _ = algo.step(torch.Generator().manual_seed(2), state)
    keyed, _ = algo.step(blackjax_tpu_torch.prng.from_generator(
        torch.Generator().manual_seed(2), (C,)), state)
    for a, b in zip(moved, keyed):
        assert torch.equal(a, b)
