"""The port's fused leapfrog and fused HMC against the Pallas kernel in
interpret mode.

``fused_leapfrog_plain`` (which the wrapper takes for CPU tensors) keeps the
Pallas kernel's operation order, so on the same f32 inputs the two differ
only by the order of the sums inside the targets: the test asks for
agreement to rtol = atol = 1e-5, tighter than the 2e-4 at which
``tests/ops/test_fused_leapfrog.py`` holds the Pallas kernel against the
XLA integrator, and prints the largest difference seen. ``fused_hmc``'s
draw-free step, fed the reference's own draws, takes the same accept
decisions and agrees to 1e-5. Logistic regression (``n = 150`` data rows,
``d = 13``: neither a multiple of 8 nor of 128) is held the same way, at
1e-5 in its value and gradient and in its trajectories.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from blackjax_tpu.ops import fused_hmc as jfused_hmc  # noqa: E402  (the class)
from blackjax_tpu.ops.fused_leapfrog import fused_leapfrog as jfused_leapfrog  # noqa: E402
from blackjax_tpu.ops import make_gaussian_target as jmake_gaussian  # noqa: E402
from blackjax_tpu.ops import make_hierarchical_gaussian_target as jmake_hierarchical  # noqa: E402
from blackjax_tpu.ops import make_logistic_regression_target as jmake_logreg  # noqa: E402
import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.ops.fused_hmc import fused_hmc  # noqa: E402

# `ops.fused_leapfrog` is the function; the module comes from importlib
fl = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")

TOL = 1e-5
D, C = 12, 20
VARIANCES = np.array([0.5, 1.0, 2.0, 4.0] * 3, np.float32)

CASES = {
    "hierarchical": lambda: jmake_hierarchical(D),
    "gaussian": lambda: jmake_gaussian(D, VARIANCES),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x0 = (0.5 * rng.standard_normal((C, D))).astype(np.float32)
    m0 = rng.standard_normal((C, D)).astype(np.float32)
    return x0, m0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("num_steps", [1, 7])
def test_plain_version_matches_pallas_kernel(case, num_steps):
    ref_target = CASES[case]()
    target = interop.fused_target(ref_target.name, D, ref_target.params)
    x0, m0 = _inputs(0)
    imm = np.full(D, 1.3, np.float32)
    ref = jfused_leapfrog(
        jnp.asarray(x0), jnp.asarray(m0), jnp.asarray(imm), 0.05, target=ref_target,
        num_steps=num_steps, tile_chains=8, interpret=True,
    )
    before = dict(fl.LAUNCHES)
    got = fl.fused_leapfrog(
        torch.from_numpy(x0), torch.from_numpy(m0), torch.from_numpy(imm), 0.05,
        target=target, num_steps=num_steps,
    )
    assert fl.LAUNCHES == before, "a CPU call must not count a kernel launch"
    plain = fl.fused_leapfrog_plain(
        torch.from_numpy(x0), torch.from_numpy(m0), torch.from_numpy(imm), 0.05,
        target=target, num_steps=num_steps,
    )
    worst = 0.0
    for a, p, b in zip(got, plain, ref):
        assert a.dtype == torch.float32 and torch.equal(a, p)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
        worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max()))
    print(f"{case}, {num_steps} steps: largest |plain - pallas| = {worst:.3g}")


def test_targets_match_reference_tiles():
    """Value and gradient of each target against the reference's plain
    logdensity and its autodiff gradient."""
    x = np.random.default_rng(1).standard_normal((9, D)).astype(np.float32)
    for case in sorted(CASES):
        ref_target = CASES[case]()
        target = interop.fused_target(ref_target.name, D, ref_target.params)
        ld = jax.vmap(ref_target.logdensity_fn)(jnp.asarray(x))
        g = jax.vmap(jax.grad(ref_target.logdensity_fn))(jnp.asarray(x))
        t = torch.from_numpy(x)
        for got in (target.logdensity_tile(t), target.logdensity_fn(t)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ld), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(target.grad_tile(t).numpy(), np.asarray(g), rtol=TOL, atol=TOL)
        assert target.params == tuple(tuple(float(v) for v in p) for p in ref_target.params)


def test_registry_and_validation():
    target = fl.make_hierarchical_gaussian_target(D)
    assert fl.get_registered_target("hierarchical_gaussian", D) is target
    with pytest.raises(ValueError, match="No registered target"):
        fl.get_registered_target("hierarchical_gaussian", D + 999)
    with pytest.raises(ValueError, match="registered target dim"):
        fl.fused_leapfrog(torch.zeros(4, D + 1), torch.zeros(4, D + 1), torch.ones(D + 1),
                          0.1, target=target, num_steps=2)
    with pytest.raises(ValueError, match="inverse variances"):
        fl.gaussian_target_from_params(D, (1.0,) * (D - 1))
    with pytest.raises(NotImplementedError, match="not ported"):
        interop.fused_target("banana", D)


LR_N, LR_D = 150, 13


def _logreg_data():
    rng = np.random.default_rng(11)
    X = rng.standard_normal((LR_N, LR_D)).astype(np.float32)
    w = rng.standard_normal(LR_D)
    y = (rng.random(LR_N) < 1.0 / (1.0 + np.exp(-X @ w))).astype(np.float32)
    return X, y


def test_logistic_regression_target_matches_reference():
    """Tiles, plain log density and params against the reference's, and the
    gradient against autodiff of its plain log density."""
    ref_target = jmake_logreg(*_logreg_data())
    target = interop.fused_target(ref_target.name, LR_D, ref_target.params)
    assert target.cuda_target == fl._CUDA_LOGISTIC_REGRESSION
    for a, b in zip(target.params, ref_target.params):
        np.testing.assert_array_equal(a, b)
    x = (0.3 * np.random.default_rng(1).standard_normal((9, LR_D))).astype(np.float32)
    t = torch.from_numpy(x)
    ld = jax.vmap(ref_target.logdensity_fn)(jnp.asarray(x))
    g = jax.vmap(jax.grad(ref_target.logdensity_fn))(jnp.asarray(x))
    for got in (target.logdensity_tile(t), target.logdensity_fn(t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ld), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(target.grad_tile(t).numpy(), np.asarray(g), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("num_steps", [1, 7])
def test_logistic_regression_plain_version_matches_pallas_kernel(num_steps):
    ref_target = jmake_logreg(*_logreg_data())
    target = interop.fused_target(ref_target.name, LR_D, ref_target.params)
    rng = np.random.default_rng(3)
    x0 = (0.2 * rng.standard_normal((C, LR_D))).astype(np.float32)
    m0 = rng.standard_normal((C, LR_D)).astype(np.float32)
    imm = rng.uniform(0.5, 1.5, LR_D).astype(np.float32)
    ref = jfused_leapfrog(
        jnp.asarray(x0), jnp.asarray(m0), jnp.asarray(imm), 0.02, target=ref_target,
        num_steps=num_steps, tile_chains=8, interpret=True,
    )
    before = dict(fl.LAUNCHES)
    got = fl.fused_leapfrog(torch.from_numpy(x0), torch.from_numpy(m0), torch.from_numpy(imm),
                            0.02, target=target, num_steps=num_steps)
    assert fl.LAUNCHES == before, "a CPU call must not count a kernel launch"
    worst = 0.0
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
        worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max()))
    print(f"logistic regression, {num_steps} steps: largest |plain - pallas| = {worst:.3g}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_hmc_step_on_the_reference_draws(case):
    """``step_from_draws`` fed the draws of the reference's step
    (``fused_hmc.py:78-101``): same accepts, and positions, log densities and
    acceptance probabilities within 1e-5."""
    ref_target = CASES[case]()
    target = interop.fused_target(ref_target.name, D, ref_target.params)
    imm, step_size = (VARIANCES, 0.6) if case == "gaussian" else (np.ones(D, np.float32), 0.3)
    ref = jfused_hmc(ref_target, step_size, jnp.asarray(imm), 6, tile_chains=8, interpret=True)
    port = fused_hmc(target, step_size, torch.from_numpy(imm), 6)
    x0, _ = _inputs(2)
    ref_state = ref.init(jnp.asarray(x0))
    state = interop.fused_hmc_state(ref_state)
    np.testing.assert_allclose(
        port.init(torch.from_numpy(x0)).logdensities.numpy(),
        np.asarray(ref_state.logdensities), rtol=TOL, atol=TOL,
    )
    accepted, worst = 0, 0.0
    # one compile of the reference's step, at XLA's optimization level 0 with
    # its older fusion emitters (a quicker compile of the interpreted kernel)
    ref_step = jax.jit(ref.step, compiler_options={"xla_backend_optimization_level": 0,
                                                   "xla_cpu_use_fusion_emitters": False})
    for key in jax.random.split(jax.random.key(4), 3):
        key_momentum, key_accept = jax.random.split(key)
        z = jax.random.normal(key_momentum, (C, D), jnp.float32)
        u = jax.random.uniform(key_accept, (C,))
        ref_state, ref_info = ref_step(key, ref_state)
        state, info = port.step_from_draws(state, interop.to_tensor(z), interop.to_tensor(u))
        np.testing.assert_array_equal(info.is_accepted.numpy(), np.asarray(ref_info.is_accepted))
        for a, b in [(state.positions, ref_state.positions),
                     (state.logdensities, ref_state.logdensities),
                     (info.acceptance_rate, ref_info.acceptance_rate)]:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)
            worst = max(worst, float(np.abs(a.numpy() - np.asarray(b)).max()))
        # a rejected proposal's energy can be large; it rounds in f32
        np.testing.assert_allclose(info.energy.numpy(), np.asarray(ref_info.energy), rtol=1e-4)
        accepted += int(info.is_accepted.sum())
    assert 0 < accepted < 3 * C  # both outcomes exercised
    print(f"{case}: largest |port - reference| over 3 steps = {worst:.3g}")


def test_top_level_fused_hmc_recovers_variances():
    target = fl.make_gaussian_target(D, VARIANCES)
    algo = blackjax_tpu_torch.fused_hmc(target, 0.35, torch.from_numpy(VARIANCES), 8)
    state = algo.init(2.0 * torch.randn(64, D, generator=torch.Generator().manual_seed(0)))
    assert state.positions.dtype == torch.float32
    _, (hist, acc) = blackjax_tpu_torch.util.run_inference_algorithm(
        torch.Generator().manual_seed(1), algo, 300, initial_state=state,
        transform=lambda s, i: (s.positions, i.acceptance_rate),
    )
    assert 0.6 < float(acc.mean()) <= 1.0
    samples = hist[100:].reshape(-1, D).numpy()
    np.testing.assert_allclose(samples.var(0), VARIANCES, rtol=0.25)
    np.testing.assert_allclose(samples.mean(0), 0.0, atol=0.2)
    # a registered name resolves against the positions' width
    by_name = blackjax_tpu_torch.fused_hmc("gaussian", 0.35, torch.from_numpy(VARIANCES), 8)
    assert torch.equal(by_name.init(state.positions).logdensities, state.logdensities)
