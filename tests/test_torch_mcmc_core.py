"""HMC mechanics of the port against the JAX package, in f64.

Same inputs, made with numpy, go through both. The arithmetic is the same
up to summation order and autograd's spelling of the gradients, so f64
results agree to rtol 1e-12; boolean decisions (U-turn checks, slot
ranges, accepts on given uniforms) agree exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.mcmc import integrators as jintegrators  # noqa: E402
from blackjax_tpu.mcmc import metrics as jmetrics  # noqa: E402
from blackjax_tpu.mcmc import proposal as jproposal  # noqa: E402
from blackjax_tpu.mcmc import termination as jtermination  # noqa: E402
from blackjax_tpu.models import targets as jtargets  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import integrators, metrics, proposal, termination  # noqa: E402
from blackjax_tpu_torch.models import targets  # noqa: E402

RTOL = 1e-12
D = 5


def _imm(kind):
    rng = np.random.default_rng(11)
    if kind == "diag":
        return rng.uniform(0.5, 2.0, D)
    a = rng.standard_normal((D, D))
    return a @ a.T / D + np.eye(D)


@pytest.fixture(scope="module", params=["diag", "dense"])
def metric_pair(request):
    imm = _imm(request.param)
    return imm, jmetrics.gaussian_euclidean(jnp.asarray(imm)), metrics.gaussian_euclidean(
        interop.inverse_mass_matrix(imm)
    )


def test_velocity_verlet_several_steps(metric_pair):
    imm, jm, tm = metric_pair
    jt, tt = jtargets.hierarchical_gaussian(D), targets.hierarchical_gaussian(D)
    rng = np.random.default_rng(0)
    C = 6
    x0 = 0.5 * rng.standard_normal((C, D))
    m0 = rng.standard_normal((C, D))
    step = jax.jit(jax.vmap(
        lambda s: jintegrators.velocity_verlet(jt.logdensity_fn, jm.kinetic_energy)(s, 0.1)
    ))
    js = jax.vmap(
        lambda x, m: jintegrators.new_integrator_state(jt.logdensity_fn, x, m)
    )(jnp.asarray(x0), jnp.asarray(m0))
    ts = integrators.new_integrator_state(
        tt.logdensity_fn, torch.from_numpy(x0), torch.from_numpy(m0)
    )
    one_step = integrators.velocity_verlet(tt.logdensity_fn, tm.kinetic_energy)
    for _ in range(5):
        js = step(js)
        ts = one_step(ts, 0.1)
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-13)


def test_kinetic_energy_and_scale(metric_pair):
    imm, jm, tm = metric_pair
    p = np.random.default_rng(1).standard_normal((7, D))
    np.testing.assert_allclose(
        tm.kinetic_energy(torch.from_numpy(p)).numpy(),
        np.asarray(jax.vmap(jm.kinetic_energy)(jnp.asarray(p))),
        rtol=RTOL,
    )
    for inv in (False, True):
        for trans in (False, True):
            ref = jax.vmap(lambda e: jm.scale(None, e, inv=inv, trans=trans))(jnp.asarray(p))
            got = tm.scale(None, torch.from_numpy(p), inv=inv, trans=trans)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-13)


def test_momentum_factor_and_noise_map(metric_pair):
    """``sample_momentum`` draws eps from the generator and maps it by
    ``M^{1/2}``: the factor and the map agree with the reference's."""
    imm, _, _ = metric_pair
    ref_sqrt, ref_inv = jmetrics._sqrt_factors(jnp.asarray(imm))
    sqrt, inv = metrics._sqrt_factors(torch.from_numpy(imm))
    np.testing.assert_allclose(sqrt.numpy(), np.asarray(ref_sqrt), rtol=RTOL, atol=1e-13)
    np.testing.assert_allclose(inv.numpy(), np.asarray(ref_inv), rtol=RTOL, atol=1e-13)
    eps = np.random.default_rng(2).standard_normal((4, D))
    from blackjax_tpu.util import linear_map as jlinear_map
    from blackjax_tpu_torch.util import linear_map

    ref = jax.vmap(lambda e: jlinear_map(ref_sqrt, e))(jnp.asarray(eps))
    np.testing.assert_allclose(
        linear_map(sqrt, torch.from_numpy(eps)).numpy(), np.asarray(ref), rtol=RTOL, atol=1e-13
    )
    g = torch.Generator().manual_seed(0)
    draw = metrics.gaussian_euclidean(torch.from_numpy(imm)).sample_momentum(
        g, torch.zeros(3, D, dtype=torch.float64)
    )
    assert draw.shape == (3, D) and draw.dtype == torch.float64


def test_check_turning_and_batched(metric_pair):
    imm, jm, tm = metric_pair
    rng = np.random.default_rng(3)
    C, K = 64, 6
    ml, mr, ms = (rng.standard_normal((C, D)) for _ in range(3))
    ref = jax.vmap(jm.check_turning)(jnp.asarray(ml), jnp.asarray(mr), jnp.asarray(ms))
    got = tm.check_turning(*(torch.from_numpy(a) for a in (ml, mr, ms)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < np.asarray(ref).sum() < C  # both outcomes exercised

    ck_m, ck_s = rng.standard_normal((C, K, D)), rng.standard_normal((C, K, D))
    active = rng.random((C, K)) < 0.4
    ref = jax.vmap(jm.check_turning_batched)(
        *(jnp.asarray(a) for a in (ck_m, ck_s, mr, ms, active))
    )
    got = tm.check_turning_batched(*(torch.from_numpy(a) for a in (ck_m, ck_s, mr, ms, active)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < np.asarray(ref).sum() < C


def test_checkpoint_slots_all_leaves():
    leaves = np.arange(1024, dtype=np.int32)
    ref_min, ref_max = jtermination._checkpoint_slots(jnp.asarray(leaves))
    got_min, got_max = termination._checkpoint_slots(torch.from_numpy(leaves))
    np.testing.assert_array_equal(got_min.numpy(), np.asarray(ref_min))
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(ref_max))


def test_iterative_uturn_on_fixed_momenta():
    imm = _imm("diag")
    jm = jmetrics.gaussian_euclidean(jnp.asarray(imm))
    tm = metrics.gaussian_euclidean(torch.from_numpy(imm))
    j_new, j_update, j_met = jtermination.iterative_uturn(jm.check_turning)
    t_new, t_update, t_met = termination.iterative_uturn(tm.check_turning)
    rng = np.random.default_rng(5)
    C, K, L = 8, 5, 16
    momenta = rng.standard_normal((L, C, D)) + 0.3  # a drift makes some trees turn late

    class _S:
        position = None

    s = _S()
    s.position = jnp.zeros(D)
    js = jax.vmap(lambda _: j_new(s, K))(jnp.arange(C))
    s.position = torch.zeros(C, D, dtype=torch.float64)
    ts = t_new(s, K)
    jsum = np.zeros((C, D))
    met_any = []
    for leaf in range(L):
        m = momenta[leaf]
        jsum = m if leaf == 0 else jsum + m
        js = jax.vmap(j_update, in_axes=(0, 0, 0, None))(
            js, jnp.asarray(jsum), jnp.asarray(m), leaf
        )
        ts = t_update(ts, torch.from_numpy(jsum), torch.from_numpy(m), torch.full((C,), leaf))
        for a, b in zip(ts, js):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
        ref = jax.vmap(j_met)(js, jnp.asarray(jsum), jnp.asarray(m))
        got = t_met(ts, torch.from_numpy(jsum), torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        met_any.append(np.asarray(ref).any())
    assert any(met_any)


def _proposals(rng, C):
    from blackjax_tpu.mcmc.integrators import IntegratorState as JState
    from blackjax_tpu_torch.mcmc.integrators import IntegratorState as TState

    fields = [rng.standard_normal((C, D)), rng.standard_normal((C, D)),
              rng.standard_normal(C), rng.standard_normal((C, D))]
    energy = rng.standard_normal(C)
    weight = rng.standard_normal(C) * 2.0
    weight[0] = -np.inf
    slpa = np.minimum(rng.standard_normal(C), 0.0)
    slpa[1] = -np.inf
    jp = jproposal.Proposal(JState(*map(jnp.asarray, fields)), jnp.asarray(energy),
                            jnp.asarray(weight), jnp.asarray(slpa))
    tp = proposal.Proposal(TState(*map(torch.from_numpy, fields)), torch.from_numpy(energy),
                           torch.from_numpy(weight), torch.from_numpy(slpa))
    return jp, tp


@pytest.mark.parametrize("which", ["progressive_uniform_sampling", "progressive_biased_sampling"])
def test_progressive_merges_on_given_uniforms(which):
    """``bernoulli(key, p)`` is ``uniform(key) < p``: handing the port the
    reference's uniforms must reproduce its accepts and merged statistics."""
    rng = np.random.default_rng(6)
    C = 256
    jold, told = _proposals(rng, C)
    jnew, tnew = _proposals(rng, C)
    keys = jax.random.split(jax.random.key(0), C)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64))(keys)
    ref = jax.vmap(getattr(jproposal, which))(keys, jold, jnew)
    got = getattr(proposal, which)(interop.to_tensor(u), told, tnew)
    for a, b in zip(jax.tree.leaves(ref), [*got.state, got.energy, got.weight, got.sum_log_p_accept]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)
    taken = np.asarray(ref.energy) == np.asarray(jnew.energy)
    assert 0 < taken.sum() < C


@pytest.mark.parametrize(
    "name", ["std_normal_5", "ill_cond_gaussian_5", "hierarchical_gaussian_5", "eight_schools"]
)
def test_targets_logdensity_and_gradient(name):
    factories = {
        "std_normal_5": lambda: jtargets.standard_normal(5),
        "ill_cond_gaussian_5": lambda: jtargets.ill_conditioned_gaussian(5),
        "hierarchical_gaussian_5": lambda: jtargets.hierarchical_gaussian(5),
        "eight_schools": jtargets.eight_schools_noncentered,
    }
    jt = factories[name]()
    tt = interop.target(jt.name)
    assert (tt.name, tt.dim) == (jt.name, jt.dim)
    x = np.random.default_rng(7).standard_normal((9, jt.dim))
    ref_ld, ref_g = jax.vmap(jax.value_and_grad(jt.logdensity_fn))(jnp.asarray(x))
    from blackjax_tpu_torch.util import value_and_grad

    ld, g = value_and_grad(tt.logdensity_fn, torch.from_numpy(x))
    np.testing.assert_allclose(ld.numpy(), np.asarray(ref_ld), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=RTOL, atol=1e-13)
