"""The SMC layer's other paths against the JAX package, a step or two each,
in float64 on the same keys, at the tolerances of ``test_torch_smc.py``
(lambda and log-increments within 1e-10, particles within 1e-8,
ancestors and accept flags identical):

- tempered SMC on a fixed schedule, its particles moved by HMC on key
  words (a dense metric and the step count as shared parameters);
- ``inner_kernel_tuning`` around tempered SMC with MALA, the step size
  re-tuned per particle by ``update_scale_from_acceptance_rate``: shared in
  the first step, ``(n,)`` in the second;
- ``partial_posteriors_smc`` with MALA on a growing data mask;
- the ``tuning.from_particles`` estimators on a dict of particles, and
  ``util.tree_leaves``'s order against ``jax.tree_util.tree_leaves``.

The JAX side is compiled once per function, at XLA's optimization level 0.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu.mcmc import mala as jmala  # noqa: E402
from blackjax_tpu.smc import resampling as jresampling  # noqa: E402
from blackjax_tpu.smc import tempered as jtempered  # noqa: E402
from blackjax_tpu.smc.base import extend_params as jextend_params  # noqa: E402
from blackjax_tpu.smc.tuning import from_particles as jfrom_particles  # noqa: E402
from blackjax_tpu.smc.tuning.from_kernel_info import (  # noqa: E402
    update_scale_from_acceptance_rate as jupdate_scale,
)
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import mala  # noqa: E402
from blackjax_tpu_torch.smc import resampling, tempered  # noqa: E402
from blackjax_tpu_torch.smc.base import extend_params  # noqa: E402
from blackjax_tpu_torch.smc.tuning import from_particles  # noqa: E402
from blackjax_tpu_torch.smc.tuning.from_kernel_info import (  # noqa: E402
    update_scale_from_acceptance_rate,
)

N, D = 128, 3
OBS = np.array([0.5, -1.0, 2.0])


def jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _jax_pair():
    return (lambda x: -0.5 * jnp.sum(x**2) / 4.0,
            lambda x: -0.5 * jnp.sum((x - jnp.asarray(OBS)) ** 2))


def _port_pair():
    obs = torch.from_numpy(OBS)
    return (lambda x: -0.5 * (x**2).sum(-1) / 4.0,
            lambda x: -0.5 * ((x - obs) ** 2).sum(-1))


def _x0():
    return 2.0 * np.random.default_rng(11).standard_normal((N, D))


def _keys(num):
    keys = jax.random.split(jax.random.key(21), num)
    return keys, interop.prng_key(jax.random.key_data(keys))


def _hold(state, info, ref_state, ref_info, lam_field="tempering_param"):
    if lam_field is not None:
        np.testing.assert_allclose(float(getattr(state, lam_field)),
                                   float(getattr(ref_state, lam_field)), rtol=0, atol=1e-10)
    np.testing.assert_allclose(state.particles.numpy(), np.asarray(ref_state.particles),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(state.weights.numpy(), np.asarray(ref_state.weights),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(info.ancestors.numpy(), np.asarray(ref_info.ancestors))
    np.testing.assert_allclose(float(info.log_likelihood_increment),
                               float(ref_info.log_likelihood_increment), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(info.update_info.is_accepted.numpy(),
                                  np.asarray(ref_info.update_info.is_accepted))


def test_tempered_fixed_schedule_with_hmc_on_key_words():
    imm = np.diag([1.0, 0.5, 2.0])
    params = {"step_size": 0.3, "inverse_mass_matrix": imm, "num_integration_steps": 4}
    ref = blackjax_tpu.tempered_smc(
        *_jax_pair(), blackjax_tpu.hmc.build_kernel(), blackjax_tpu.hmc.init,
        jextend_params({k: jnp.asarray(v) for k, v in params.items()}),
        jresampling.systematic, num_mcmc_steps=3)
    port = blackjax_tpu_torch.tempered_smc(
        *_port_pair(), blackjax_tpu_torch.hmc.build_kernel(), blackjax_tpu_torch.hmc.init,
        extend_params({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}),
        resampling.systematic, num_mcmc_steps=3)
    ref_step = jit(ref.step)
    ref_state, state = ref.init(jnp.asarray(_x0())), port.init(torch.from_numpy(_x0()))
    jkeys, tkeys = _keys(2)
    for i, lam in enumerate([0.2, 0.55]):
        ref_state, ref_info = ref_step(jkeys[i], ref_state, lam)
        state, info = port.step(tkeys[i], state, lam)
        _hold(state, info, ref_state, ref_info)
        assert info.update_info.num_integration_steps.shape == (N, 3)


def test_inner_kernel_tuning_retunes_per_particle_step_sizes():
    def ref_update(key, state, info):
        rates = info.update_info.acceptance_rate.mean(axis=1)
        return {"step_size": jupdate_scale(jnp.full(N, 0.2), rates)}

    def port_update(key, state, info):
        rates = info.update_info.acceptance_rate.mean(1)
        return {"step_size": update_scale_from_acceptance_rate(
            torch.full((N,), 0.2, dtype=torch.float64), rates)}

    ref = blackjax_tpu.inner_kernel_tuning(
        jtempered.as_top_level_api, *_jax_pair(), jmala.build_kernel(), jmala.init,
        jresampling.residual, mcmc_parameter_update_fn=ref_update,
        initial_parameter_value=jextend_params({"step_size": jnp.asarray(0.2)}),
        num_mcmc_steps=2)
    port = blackjax_tpu_torch.inner_kernel_tuning(
        tempered.as_top_level_api, *_port_pair(), mala.build_kernel(), mala.init,
        resampling.residual, mcmc_parameter_update_fn=port_update,
        initial_parameter_value=extend_params({"step_size": torch.tensor(0.2,
                                                                          dtype=torch.float64)}),
        num_mcmc_steps=2)
    ref_step = jit(ref.step)
    ref_state, state = ref.init(jnp.asarray(_x0())), port.init(torch.from_numpy(_x0()))
    jkeys, tkeys = _keys(2)
    for i, lam in enumerate([0.3, 1.0]):
        ref_state, ref_info = ref_step(jkeys[i], ref_state, tempering_param=lam)
        state, info = port.step(tkeys[i], state, tempering_param=lam)
        _hold(state.sampler_state, info, ref_state.sampler_state, ref_info)
        np.testing.assert_allclose(state.parameter_override["step_size"].numpy(),
                                   np.asarray(ref_state.parameter_override["step_size"]),
                                   rtol=1e-12)
        assert state.parameter_override["step_size"].shape == (N,)


def test_partial_posteriors_grow_the_data():
    t = np.linspace(0.0, 1.0, 8)
    y = 1.0 + 2.0 * t + 0.3 * np.random.default_rng(12).standard_normal(8)

    def ref_factory(mask):
        def logpost(x):
            resid = y - x[0] - x[1] * t
            return -0.5 * jnp.sum(x**2) / 9.0 - 0.5 * jnp.sum(mask * resid**2)
        return logpost

    tt, ty = torch.from_numpy(t), torch.from_numpy(y)

    def port_factory(mask):
        def logpost(x):
            resid = ty - x[:, :1] - x[:, 1:2] * tt
            return -0.5 * (x**2).sum(-1) / 9.0 - 0.5 * (mask * resid**2).sum(-1)
        return logpost

    ref = blackjax_tpu.partial_posteriors_smc(
        jmala.build_kernel(), jmala.init, jextend_params({"step_size": jnp.asarray(0.05)}),
        jresampling.stratified, 3, ref_factory)
    port = blackjax_tpu_torch.partial_posteriors_smc(
        mala.build_kernel(), mala.init,
        extend_params({"step_size": torch.tensor(0.05, dtype=torch.float64)}),
        resampling.stratified, 3, port_factory)
    x0 = _x0()[:, :2]
    ref_step = jit(ref.step)
    ref_state, state = ref.init(jnp.asarray(x0), 8), port.init(torch.from_numpy(x0), 8)
    assert state.data_mask.shape == (8,) and not bool(state.data_mask.any())
    jkeys, tkeys = _keys(2)
    for i, active in enumerate([4, 8]):
        mask = (np.arange(8) < active).astype(np.float64)
        ref_state, ref_info = ref_step(jkeys[i], ref_state, jnp.asarray(mask))
        state, info = port.step(tkeys[i], state, torch.from_numpy(mask))
        _hold(state, info, ref_state, ref_info, lam_field=None)
        np.testing.assert_array_equal(state.data_mask.numpy(), mask)


def test_from_particles_estimators_on_a_dict_of_particles():
    rng = np.random.default_rng(13)
    particles = {"b": rng.standard_normal((N,)), "a": rng.standard_normal((N, 2)) * [1.0, 3.0]}
    ref = {k: jnp.asarray(v) for k, v in particles.items()}
    port = {k: torch.from_numpy(v) for k, v in particles.items()}
    for name in ["particles_as_rows", "particles_means", "particles_stds",
                 "particles_covariance_matrix", "inverse_mass_matrix_from_particles"]:
        np.testing.assert_allclose(getattr(from_particles, name)(port).numpy(),
                                   np.asarray(getattr(jfrom_particles, name)(ref)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)


def test_tree_leaves_follow_the_reference_order():
    from blackjax_tpu.smc.base import SMCState as JSMCState

    from blackjax_tpu_torch.smc.base import SMCState
    from blackjax_tpu_torch.util import tree_leaves

    def tree(SMCState, leaf):
        particles = {"z": [leaf(0), (leaf(1), None)], "a": leaf(2),
                     "m": {"y": leaf(3), "b": leaf(4)}}
        return SMCState(particles, leaf(5), {"step_size": leaf(6)})

    ref = [int(x) for x in jax.tree_util.tree_leaves(tree(JSMCState, jnp.asarray))]
    assert [int(x) for x in tree_leaves(tree(SMCState, torch.tensor))] == ref
    assert tree_leaves(None) == [] and tree_leaves((None, ())) == []
