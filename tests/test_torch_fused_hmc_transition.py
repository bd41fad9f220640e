"""The fused HMC transition's plain version against the JAX package's
``fused_hmc.step`` (the Pallas leapfrog in interpret mode), and the form that
``ops.fused_hmc.plan`` picks.

On the card a transition on an analytic target is one launch of
``hmc_transition`` (``csrc/fused_leapfrog.cu``); its plain version,
``ops.fused_leapfrog._hmc_transition_plain``, is the reference's step term by
term over the plain leapfrog, and is what a CPU tensor takes. Fed the
reference's own draws it takes the same accept decisions, and its positions
and acceptance probabilities agree to 1e-5 (the sums inside the targets run
in another order). An accepted log density is ``-(energy1 - kinetic)``, the
difference of two energies of order d, so it agrees to 1e-5 of the larger of
itself and the proposal's energy (at d = 33 a log density of 0.033 from an
energy near 10 parts by 1.05e-5). A proposal's energy agrees to rtol 1e-4 (a
rejected proposal's energy can be large, and rounds in f32). The kernel is
held against this plain version on the card (``tests/test_torch_cuda.py``).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops import fused_hmc as jfused_hmc  # noqa: E402  (the class)
from blackjax_tpu.ops import make_gaussian_target as jmake_gaussian  # noqa: E402
from blackjax_tpu.ops import make_hierarchical_gaussian_target as jmake_hierarchical  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.ops.fused_hmc import fused_hmc  # noqa: E402

# `ops.fused_leapfrog` and `ops.fused_hmc` are a function and a class; the
# modules come from importlib
fl = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
fh = importlib.import_module("blackjax_tpu_torch.ops.fused_hmc")

TOL = 1e-5
ENERGY_RTOL = 1e-4
C, STEPS, TRANSITIONS = 16, 6, 3


def _reference_target(case, d):
    if case == "hierarchical":
        return jmake_hierarchical(d)
    return jmake_gaussian(d, np.linspace(0.5, 2.0, d).astype(np.float32))


def _setup(case, d, step_size):
    """The reference's sampler and state, the port's target and state, and
    the metric, from numpy seed d."""
    ref_target = _reference_target(case, d)
    target = interop.fused_target(ref_target.name, d, ref_target.params)
    rng = np.random.default_rng(d)
    imm = rng.uniform(0.5, 1.5, d).astype(np.float32)
    x0 = (0.5 * rng.standard_normal((C, d))).astype(np.float32)
    ref = jfused_hmc(ref_target, step_size, jnp.asarray(imm), STEPS, tile_chains=8,
                     interpret=True)
    ref_state = ref.init(jnp.asarray(x0))
    return ref, ref_state, target, interop.fused_hmc_state(ref_state), torch.from_numpy(imm)


def _reference_draws(key, d):
    """The draws of the reference's step (``fused_hmc.py:78-101``)."""
    key_momentum, key_accept = jax.random.split(key)
    z = jax.random.normal(key_momentum, (C, d), jnp.float32)
    u = jax.random.uniform(key_accept, (C,))
    return interop.to_tensor(z), interop.to_tensor(u)


# step sizes at which both outcomes occur in three transitions
STEP_SIZES = {("hierarchical", 1): 1.6, ("hierarchical", 33): 0.3,
              ("hierarchical", 100): 0.15, ("gaussian", 1): 1.2, ("gaussian", 33): 0.8,
              ("gaussian", 100): 0.45}


@pytest.mark.parametrize("d", [1, 33, 100])
@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_plain_transition_matches_reference_step(case, d):
    ref, ref_state, target, state, imm = _setup(case, d, STEP_SIZES[case, d])
    before = dict(fl.LAUNCHES)
    outcomes, worst = set(), 0.0
    # one compile of the reference's step, at XLA's optimization level 0 with
    # its older fusion emitters (a quicker compile of the interpreted kernel)
    ref_step = jax.jit(ref.step, compiler_options={"xla_backend_optimization_level": 0,
                                                   "xla_cpu_use_fusion_emitters": False})
    for key in jax.random.split(jax.random.key(d), TRANSITIONS):
        z, u = _reference_draws(key, d)
        ref_state, ref_info = ref_step(key, ref_state)
        x, ld, p_accept, accept, energy = fl._hmc_transition_plain(
            state.positions, state.logdensities, z, u, imm, STEP_SIZES[case, d],
            target=target, num_steps=STEPS)
        assert accept.dtype == torch.bool and x.dtype == ld.dtype == torch.float32
        np.testing.assert_array_equal(accept.numpy(), np.asarray(ref_info.is_accepted))
        for a, b in [(x, ref_state.positions), (p_accept, ref_info.acceptance_rate)]:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
            worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max()))
        scale = np.maximum(np.abs(ld.numpy()), np.abs(energy.numpy()))
        assert (np.abs(ld.numpy() - np.asarray(ref_state.logdensities))
                <= TOL * np.maximum(scale, 1.0)).all()
        np.testing.assert_allclose(energy.numpy(), np.asarray(ref_info.energy),
                                   rtol=ENERGY_RTOL)
        outcomes |= set(accept.tolist())
        state = fh.FusedHMCState(x, ld)
    assert fl.LAUNCHES == before, "the plain transition must not count a kernel launch"
    assert outcomes == {False, True}, "both outcomes exercised"
    print(f"{case} d={d}: largest |plain - reference| over {TRANSITIONS} transitions "
          f"= {worst:.3g}")


@pytest.mark.parametrize("case", ["hierarchical", "gaussian"])
def test_divergent_trajectory_is_rejected(case):
    """A step size at which every trajectory diverges: the proposal's energy
    is not finite, delta's NaN maps to -inf, p_accept is 0 and every chain
    keeps its position and log density, as in the reference."""
    d, step_size = 33, 1e4
    ref, ref_state, target, state, imm = _setup(case, d, step_size)
    key = jax.random.key(5)
    z, u = _reference_draws(key, d)
    ref_state1, ref_info = ref.step(key, ref_state)
    x, ld, p_accept, accept, energy = fl._hmc_transition_plain(
        state.positions, state.logdensities, z, u, imm, step_size, target=target,
        num_steps=STEPS)
    assert not bool(torch.isfinite(energy).any())
    assert bool((p_accept == 0).all()) and not bool(accept.any())
    assert torch.equal(x, state.positions) and torch.equal(ld, state.logdensities)
    np.testing.assert_array_equal(np.asarray(ref_info.acceptance_rate), 0.0)
    np.testing.assert_array_equal(np.asarray(ref_info.is_accepted), False)
    np.testing.assert_array_equal(x.numpy(), np.asarray(ref_state1.positions))


def _logreg_target():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((40, 5)).astype(np.float32)
    y = (rng.random(40) < 0.5).astype(np.float32)
    return fl.make_logistic_regression_target(X, y)


@pytest.mark.parametrize("case, device, form", [
    ("hierarchical", "cuda", "transition"),
    ("gaussian", "cuda", "transition"),
    ("logistic_regression", "cuda", "leapfrog"),
    ("hierarchical", "cpu", "leapfrog"),
    ("gaussian", "cpu", "leapfrog"),
    ("logistic_regression", "cpu", "leapfrog"),
])
def test_plan_picks_the_form(case, device, form):
    target = {"hierarchical": lambda: fl.make_hierarchical_gaussian_target(12),
              "gaussian": lambda: fl.make_gaussian_target(12),
              "logistic_regression": _logreg_target}[case]()
    assert fh.plan(target, torch.device(device)) == form
    assert fh.plan(target, device) == form


def test_plan_refusals():
    """The plan reads only the device type and the target's kind; what a form
    cannot run, its own function refuses: the transition kernel's wrapper
    d > 256 (``test_transition_kernel_refuses_what_it_does_not_run``),
    ``fused_leapfrog`` a device type other than CPU and CUDA."""
    wide = fl.make_hierarchical_gaussian_target(257)
    assert fh.plan(wide, "cuda") == "transition"
    assert fh.plan(wide, "cpu") == "leapfrog"
    assert fh.plan(wide, "meta") == "leapfrog"
    sampler = fused_hmc(fl.make_gaussian_target(4), 0.1, torch.ones(4), 2)
    x, v = torch.zeros(3, 4, device="meta"), torch.zeros(3, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        sampler.step_from_draws(fh.FusedHMCState(x, v), x, v)


def test_transition_kernel_refuses_what_it_does_not_run():
    """The kernel's wrapper takes the analytic targets up to d = 256 and
    raises on the rest before it builds anything."""
    lr = _logreg_target()
    x = torch.zeros(4, lr.dim)
    with pytest.raises(ValueError, match="analytic targets only"):
        fl._hmc_transition_cuda(x, torch.zeros(4), x, torch.zeros(4), torch.ones(lr.dim), 0.1,
                                target=lr, num_steps=2)
    wide = fl.make_hierarchical_gaussian_target(257)
    x = torch.zeros(4, 257)
    with pytest.raises(ValueError, match="d <= 256"):
        fl._hmc_transition_cuda(x, torch.zeros(4), x, torch.zeros(4), torch.ones(257), 0.1,
                                target=wide, num_steps=2)


def test_a_failed_build_raises_and_falls_back_to_nothing(monkeypatch):
    """Where the plan picks the transition kernel, a failure to build it
    raises: the step does not take the plain ops instead."""
    def no_library():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(fh, "plan", lambda target, device: "transition")
    monkeypatch.setattr(fl, "_library", no_library)
    target = fl.make_hierarchical_gaussian_target(12)
    sampler = fused_hmc(target, 0.1, torch.ones(12), 4)
    state = sampler.init(torch.zeros(3, 12))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        sampler.step_from_draws(state, torch.zeros(3, 12), torch.zeros(3))


def test_cpu_step_is_the_plain_transition():
    """On the CPU ``step_from_draws`` (the plan's ``"leapfrog"`` form, whose
    ``fused_leapfrog`` runs the plain leapfrog there) is the plain
    transition, bit for bit, on an analytic target and on logistic
    regression, and counts no launch."""
    rng = np.random.default_rng(3)
    for target, step_size in [(fl.make_hierarchical_gaussian_target(9), 0.3),
                              (_logreg_target(), 0.05)]:
        d = target.dim
        imm = torch.from_numpy(rng.uniform(0.5, 1.5, d).astype(np.float32))
        sampler = fused_hmc(target, step_size, imm, 5)
        state = sampler.init(torch.from_numpy((0.3 * rng.standard_normal((7, d)))
                                              .astype(np.float32)))
        z = torch.from_numpy(rng.standard_normal((7, d)).astype(np.float32))
        u = torch.from_numpy(rng.random(7).astype(np.float32))
        before = dict(fl.LAUNCHES)
        new_state, info = sampler.step_from_draws(state, z, u)
        assert fl.LAUNCHES == before
        plain = fl._hmc_transition_plain(state.positions, state.logdensities, z, u, imm,
                                         step_size, target=target, num_steps=5)
        for a, b in zip((*new_state, *info), plain):
            assert torch.equal(a, b)


@pytest.mark.parametrize("by_name", [False, True])
def test_top_level_fused_hmc_is_the_sampler_s_step(by_name):
    """Three steps of ``blackjax_tpu_torch.fused_hmc`` (its sampler built
    once) from one generator equal three of ``fused_hmc(...).step`` from a
    generator of the same seed."""
    d = 10
    target = fl.make_gaussian_target(d, np.linspace(0.5, 2.0, d))
    imm = torch.linspace(0.6, 1.4, d)
    algo = blackjax_tpu_torch.fused_hmc("gaussian" if by_name else target, 0.4, imm, 6)
    sampler = fused_hmc(target, 0.4, imm, 6)
    x0 = torch.randn(8, d, generator=torch.Generator().manual_seed(0))
    state, expected = algo.init(x0), sampler.init(x0)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    for _ in range(3):
        state, info = algo.step(g1, state)
        expected, expected_info = sampler.step(g2, expected)
        for a, b in zip((*state, *info), (*expected, *expected_info)):
            assert torch.equal(a, b)
