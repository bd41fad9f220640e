"""The port's L-BFGS (``optimizers.optax_twins``' twins of optax 0.2.6's
``lbfgs`` and zoom line search, and ``optimizers.lbfgs``) against optax and
the JAX package, in float64, on numpy-made inputs:

- the twins against ``optax.lbfgs`` compiled in a ``scan``, step by step,
  on a quadratic (d = 6), on ``ill_conditioned_gaussian(12)`` and on
  Rosenbrock in 6 dimensions, with the zoom line search as Pathfinder
  configures it (``max_linesearch_steps=1000``, the previous step as the
  guess) and, on Rosenbrock, optax's default (20 steps from a guess of 1):
  iterates, values, gradients and the final memories within 1e-10
  relative, the L-BFGS counter and every line search's trip count equal;
- ``minimize_lbfgs``'s history and state (Rosenbrock, which spends its 30
  iterations), ``lbfgs_recover_alpha`` (a pair that
  passes the curvature test and one that fails it), the factors, both
  formulas and ``bfgs_sample`` (5 draws and one) within 1e-10;
- a batch of 5 paths whose trip counts differ equals, path by path, five
  single-path runs, bit for bit.

The JAX side is compiled once for the module, as one program, at XLA's
optimization level 0 with its older CPU fusion emitters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from blackjax_tpu.models.targets import ill_conditioned_gaussian as jtarget  # noqa: E402
from blackjax_tpu.optimizers import lbfgs as jlbfgs  # noqa: E402
from blackjax_tpu_torch import interop  # noqa: E402
from blackjax_tpu_torch.models.targets import ill_conditioned_gaussian  # noqa: E402
from blackjax_tpu_torch.optimizers import lbfgs, optax_twins  # noqa: E402

TOL = 1e-10
MAXCOR, MAXLS = 10, 1000
QUAD_D, GAUSS_D, ROSEN_D, M = 6, 12, 6, 4
_rng = np.random.default_rng(11)
_A = _rng.standard_normal((QUAD_D, QUAD_D))
QUAD_A = _A @ _A.T + QUAD_D * np.eye(QUAD_D)
QUAD_B = _rng.standard_normal(QUAD_D)
X0 = {"quadratic": 3.0 * _rng.standard_normal(QUAD_D),
      "gaussian": 3.0 * _rng.standard_normal(GAUSS_D),
      "rosenbrock": _rng.uniform(-2.0, 2.0, ROSEN_D)}
# Rosenbrock's gradient in its valley cancels: under optax's default line
# search the two packages' rounding grows to 6e-10 of it by step 30, so that
# setting is held over its first 20 steps
STEPS = {"quadratic": 5, "gaussian": 12, "rosenbrock": 30, "rosenbrock/default": 20}
# the algebra's inputs: m pairs with s.z > 0 (z = H s, H positive definite)
_H = _rng.standard_normal((GAUSS_D, GAUSS_D))
_H = _H @ _H.T + np.eye(GAUSS_D)
S = _rng.standard_normal((GAUSS_D, M))
Z = _H @ S
ALPHA = _rng.uniform(0.5, 2.0, GAUSS_D)
POSITION, GRAD = _rng.standard_normal(GAUSS_D), _rng.standard_normal(GAUSS_D)


def jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_cpu_use_fusion_emitters": False})


def _objectives(xp):
    """The three objectives on ``(..., d)``, in ``xp`` (jnp or torch)."""
    if xp is jnp:
        a, b = jnp.asarray(QUAD_A), jnp.asarray(QUAD_B)
        gauss = jtarget(GAUSS_D).logdensity_fn
        matvec = lambda x: x @ a  # noqa: E731
    else:
        a, b = torch.tensor(QUAD_A), torch.tensor(QUAD_B)
        gauss = ill_conditioned_gaussian(GAUSS_D).logdensity_fn
        matvec = lambda x: x @ a  # noqa: E731

    def quadratic(x):
        return 0.5 * (x * matvec(x)).sum(-1) - (x * b).sum(-1)

    def rosenbrock(x):
        return (100.0 * (x[..., 1:] - x[..., :-1] ** 2) ** 2 + (1.0 - x[..., :-1]) ** 2).sum(-1)

    return {"quadratic": quadratic, "gaussian": lambda x: -gauss(x), "rosenbrock": rosenbrock}


CASES = [("quadratic", "pathfinder"), ("gaussian", "pathfinder"), ("rosenbrock", "pathfinder"),
         ("rosenbrock", "default")]


def _steps(name, setting):
    return STEPS.get(f"{name}/{setting}", STEPS[name])


def _optax_solver(setting):
    if setting == "default":
        return optax.lbfgs(memory_size=MAXCOR)
    return optax.lbfgs(memory_size=MAXCOR,
                       linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps=MAXLS))


def _twin_solver(setting):
    if setting == "default":
        return optax_twins.lbfgs(memory_size=MAXCOR)
    return optax_twins.lbfgs(memory_size=MAXCOR, linesearch=optax_twins.scale_by_zoom_linesearch(
        max_linesearch_steps=MAXLS))


def _optax_trace(fun, x0, steps, setting):
    solver = _optax_solver(setting)
    value_and_grad = optax.value_and_grad_from_state(fun)

    def body(carry, _):
        params, state = carry
        value, grad = value_and_grad(params, state=state)
        updates, state = solver.update(grad, state, params, value=value, grad=grad,
                                       value_fn=fun)
        params = optax.apply_updates(params, updates)
        return (params, state), (params, value, grad, state[0].count,
                                 state[2].info.num_linesearch_steps)

    (_, state), trace = jax.lax.scan(body, (x0, solver.init(x0)), None, length=steps)
    return trace, (state[0].diff_params_memory, state[0].diff_updates_memory,
                   state[0].weights_memory)


def _twin_trace(fun, x0, steps, setting):
    solver = _twin_solver(setting)
    value_and_grad = optax_twins.value_and_grad_from_state(fun)
    params = torch.tensor(x0)[None]
    state = solver.init(params)
    records = []
    for _ in range(steps):
        value, grad = value_and_grad(params, state=state)
        updates, state = solver.update(grad, state, params, value=value, grad=grad,
                                       value_fn=fun)
        params = optax_twins.apply_updates(params, updates)
        records.append((params[0], value[0], grad[0], state[0].count[0],
                        state[2].info.num_linesearch_steps[0]))
    trace = tuple(torch.stack(leaves) for leaves in zip(*records))
    memories = (state[0].diff_params_memory[0], state[0].diff_updates_memory[0],
                state[0].weights_memory[0])
    return trace, memories


@pytest.fixture(scope="module")
def reference():
    """Every JAX-side result of the module, from one compiled program."""
    funs = _objectives(jnp)

    def program(key):
        out = {}
        for name, setting in CASES:
            out[f"{name}/{setting}"] = _optax_trace(funs[name], jnp.asarray(X0[name]),
                                                    _steps(name, setting), setting)
        out["minimize"] = jlbfgs.minimize_lbfgs(funs["rosenbrock"], jnp.asarray(X0["rosenbrock"]))
        s, z, alpha = jnp.asarray(S), jnp.asarray(Z), jnp.asarray(ALPHA)
        out["alpha"] = [jlbfgs.lbfgs_recover_alpha(alpha, s[:, 0], z[:, 0]),
                        jlbfgs.lbfgs_recover_alpha(alpha, s[:, 0], -z[:, 0])]
        beta, gamma = jlbfgs.lbfgs_inverse_hessian_factors(s, z, alpha)
        out["factors"] = (beta, gamma)
        out["formulas"] = (jlbfgs.lbfgs_inverse_hessian_formula_1(alpha, beta, gamma),
                           jlbfgs.lbfgs_inverse_hessian_formula_2(alpha, beta, gamma))
        position, grad = jnp.asarray(POSITION), jnp.asarray(GRAD)
        out["sample"] = [jlbfgs.bfgs_sample(key, n, position, grad, alpha, beta, gamma)
                         for n in (5, ())]
        return out

    return jax.tree.map(np.asarray, jit(program)(jax.random.key(5)))


def _key():
    return interop.prng_key(jax.random.key_data(jax.random.key(5)))


def _close(got, expected, tol=TOL):
    got = got.cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got.astype(np.float64), np.asarray(expected, np.float64),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("name, setting", CASES)
def test_the_twins_are_optax_step_by_step(reference, name, setting):
    expected, expected_memories = reference[f"{name}/{setting}"]
    trace, memories = _twin_trace(_objectives(torch)[name], X0[name], _steps(name, setting),
                                  setting)
    params, value, grad, count, trips = trace
    np.testing.assert_array_equal(count.numpy(), expected[3])
    np.testing.assert_array_equal(trips.numpy(), expected[4])
    if name == "rosenbrock":
        assert expected[4].max() >= 3, "no line search zoomed into an interval"
    for got, want in zip((params, value, grad), expected[:3]):
        _close(got, want)
    for got, want in zip(memories, expected_memories):
        _close(got, want)


def test_minimize_lbfgs_history_and_state(reference):
    """On Rosenbrock, where the budget binds (Pathfinder's tests hold the
    history of the Gaussian, through ``approximate``'s path)."""
    (expected_params, expected_state), expected_history = reference["minimize"]
    step, history = lbfgs.minimize_lbfgs(_objectives(torch)["rosenbrock"],
                                         torch.tensor(X0["rosenbrock"]))
    for field in history._fields:
        _close(getattr(history, field), getattr(expected_history, field))
    assert history.update_mask.dtype == torch.bool
    assert torch.equal(interop.lbfgs_history(expected_history).update_mask, history.update_mask)
    _close(step.params, expected_params)
    assert int(step.state.iter_num) == int(expected_state.iter_num)
    for field in ("value", "grad", "error", "s_history", "y_history", "rho_history", "gamma",
                  "stepsize"):
        _close(getattr(step.state, field), getattr(expected_state, field))
    assert int(step.state.iter_num) == 30, "the budget should bind on Rosenbrock"


def test_recover_alpha_factors_formulas_and_sample(reference):
    s, z, alpha = torch.tensor(S), torch.tensor(Z), torch.tensor(ALPHA)
    for sign, (want_alpha, want_mask) in zip((1.0, -1.0), reference["alpha"]):
        got_alpha, got_mask = lbfgs.lbfgs_recover_alpha(alpha, s[:, 0], sign * z[:, 0])
        _close(got_alpha, want_alpha)
        np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    beta, gamma = lbfgs.lbfgs_inverse_hessian_factors(s, z, alpha)
    _close(beta, reference["factors"][0])
    _close(gamma, reference["factors"][1])
    _close(lbfgs.lbfgs_inverse_hessian_formula_1(alpha, beta, gamma), reference["formulas"][0])
    _close(lbfgs.lbfgs_inverse_hessian_formula_2(alpha, beta, gamma), reference["formulas"][1])
    for n, (want_phi, want_logq) in zip((5, ()), reference["sample"]):
        phi, logq = lbfgs.bfgs_sample(_key(), n, torch.tensor(POSITION), torch.tensor(GRAD),
                                      alpha, beta, gamma)
        assert phi.shape == want_phi.shape and logq.shape == want_logq.shape
        _close(phi, want_phi)
        _close(logq, want_logq)


def test_a_batch_of_paths_is_its_single_path_runs():
    fun = _objectives(torch)["gaussian"]
    starts = np.random.default_rng(2).standard_normal((5, GAUSS_D)) * np.array(
        [[0.01], [0.3], [1.0], [3.0], [30.0]])
    step, history = lbfgs.minimize_lbfgs(fun, torch.tensor(starts))
    counts = []
    for p in range(5):
        one_step, one = lbfgs.minimize_lbfgs(fun, torch.tensor(starts[p]))
        for field in history._fields:
            assert torch.equal(getattr(history, field)[p], getattr(one, field)), field
        for field in ("iter_num", "value", "grad", "s_history", "y_history", "rho_history",
                      "gamma"):
            assert torch.equal(getattr(step.state, field)[p], getattr(one_step.state, field))
        counts.append(int(one_step.state.iter_num))
    assert len(set(counts)) > 1, f"the paths' trip counts are all {counts}"


def test_a_pytree_start_names_the_queue_item():
    with pytest.raises(ValueError, match="queue 1, item 11"):
        lbfgs.minimize_lbfgs(lambda x: (x**2).sum(-1), {"x": torch.zeros(3)})
