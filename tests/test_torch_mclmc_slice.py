"""The port's MCLMC path end to end on the CPU, at d=8 and 16 chains: the
tuner on one chain, generic MCLMC transitions over the block, the fused
trajectory from there, then min-ESS; the fused stage and the ESS are held
against the JAX package from the same state.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu import diagnostics as jdiag  # noqa: E402
from blackjax_tpu.ops import make_hierarchical_gaussian_target as jmake_hierarchical  # noqa: E402
from blackjax_tpu.ops.fused_mclmc import fused_mclmc as jfused_mclmc  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.mcmc import mclmc  # noqa: E402
from blackjax_tpu_torch.util import run_inference_algorithm  # noqa: E402

fm = importlib.import_module("blackjax_tpu_torch.ops.fused_mclmc")

D, C, S = 8, 16, 32
TRACK = tuple(range(4))


@pytest.fixture(scope="module")
def slice_run():
    posterior = interop.target("hierarchical_gaussian", D)
    gen = torch.Generator().manual_seed(0)
    state = mclmc.init(torch.zeros(D), posterior.logdensity_fn, gen)
    _, params, total = blackjax_tpu_torch.mclmc_find_L_and_step_size(
        mclmc.build_kernel(), 400, state, gen, logdensity_fn=posterior.logdensity_fn)
    L, step, imm = float(params.L), float(params.step_size), params.inverse_mass_matrix
    algo = blackjax_tpu_torch.mclmc(posterior.logdensity_fn, L=L, step_size=step,
                                    inverse_mass_matrix=imm)
    x0 = torch.from_numpy(0.5 * np.random.default_rng(1).standard_normal((C, D))).float()
    state, _ = run_inference_algorithm(gen, algo, 4, initial_position=x0)
    target = interop.fused_target("hierarchical_gaussian", D)
    kw = dict(num_steps=S, seed=7, track_dims=TRACK)
    out = fm.fused_mclmc(state.position, state.momentum, imm, step, L, target=target, **kw)
    out_ref = jfused_mclmc(
        jnp.asarray(state.position.numpy()), jnp.asarray(state.momentum.numpy()),
        jnp.asarray(imm.numpy()), step, L, target=jmake_hierarchical(D), interpret=True, **kw)
    return total, (L, step, imm), state, out, out_ref


def test_tuner_and_transition_stages(slice_run):
    total, (L, step, imm), state, *_ = slice_run
    assert total == 40 + 53 + 40
    assert np.isfinite([L, step]).all() and L > 0 and step > 0
    assert imm.shape == (D,) and bool((imm > 0).all())
    assert state.position.shape == (C, D) and state.position.dtype == torch.float32
    assert torch.isfinite(state.position).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(state.momentum, dim=1).numpy(), 1.0,
                               rtol=1e-5)


def test_fused_stage_agrees_with_pallas(slice_run):
    """32 refreshed steps from the tuned parameters: positions, momenta and
    history within 1e-5 (measured 1.8e-6), log densities within rtol 1e-5."""
    *_, out, out_ref = slice_run
    for a, b in zip(out[:2] + out[3:], out_ref[:2] + tuple(out_ref[3:])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[2].numpy(), np.asarray(out_ref[2]), rtol=1e-5)
    assert out[3].shape == (C, S, len(TRACK))


def test_ess_stage_equals_reference_on_the_same_history(slice_run):
    *_, out, _ = slice_run
    hist = out[3].double()
    got = blackjax_tpu_torch.ess(hist)
    expected = np.asarray(jax.jit(jdiag.effective_sample_size)(jnp.asarray(hist.numpy())))
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-10)
    assert float(got.min()) > 0
