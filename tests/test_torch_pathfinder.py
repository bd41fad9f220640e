"""The port's Pathfinder (``vi.pathfinder``, ``vi.multipathfinder``,
``adaptation.pathfinder_adaptation`` and
``mcmc.metrics.lbfgs_inverse_hessian_to_low_rank_metric``) against the JAX
package, in float64 on the same keys (``interop.prng_key``), on
``ill_conditioned_gaussian(7)`` from a numpy-made start:

- ``approximate``: the chosen state (ELBO, position, gradient, ``alpha``,
  ``beta``, ``gamma``) and every iterate's within 1e-9, the argmax the
  same; ``sample`` (one draw and a batch);
- ``multi_approximate`` on 4 paths of 200 draws, ``psis_weights`` and the
  PSIS resampling of the top-level ``sample`` (the indices equal);
- ``pathfinder_adaptation`` on both of its paths (1 chain; 5 chains x 4
  paths, so that a ``(C,)`` step size broadcast over the last axis would
  fail), with ``hmc`` at 5 integration steps, 30 steps: the inverse mass
  matrix, Pareto k-hat and the first 3 steps' states and step sizes of the
  free run within 1e-9; then every one of the 30 steps, taken by the port
  from the JAX package's state before it, within 1e-9 (the final states
  and per-chain step sizes among them). A free run cannot be held further:
  the dual averaging drives the step size past the leapfrog's stability
  limit in its first steps, where the packages' rounding (1e-14 after the
  first step) grows about tenfold a step;
- ``lbfgs_inverse_hessian_to_low_rank_metric`` as its operator ``U
  diag(lam) U^T``, and the validation errors of
  ``tests/adaptation/test_pathfinder_multichain.py:28-38``.

The JAX side is one program, compiled once for the module at XLA's
optimization level 0 with its older CPU fusion emitters: the JAX package's
own ``pathfinder_adaptation(...).run`` on both of its paths, which gives the
warmups' results and every step's record. What ``run`` computes but does not
return (the chosen state and every iterate of ``approximate``, the
``multi_approximate`` state with its starts, the PSIS weights) is tapped
from the calls that ``run`` makes of the Pathfinder modules
(``pathfinder_adaptation.py:136, 163-166``), in the same program. The PSIS
fit sizes a grid with a host ``int``, so the tapped ``psis_weights`` runs
under ``jax.ensure_compile_time_eval``.
"""
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import blackjax_tpu_torch  # noqa: E402
from blackjax_tpu.adaptation import pathfinder_adaptation as jpa  # noqa: E402
from blackjax_tpu.mcmc import hmc as jhmc  # noqa: E402
from blackjax_tpu.mcmc import metrics as jmetrics  # noqa: E402
from blackjax_tpu.models.targets import ill_conditioned_gaussian as jtarget  # noqa: E402
from blackjax_tpu.vi import multipathfinder as jmpf  # noqa: E402
from blackjax_tpu.vi import pathfinder as jpf  # noqa: E402
from blackjax_tpu_torch import interop, prng  # noqa: E402
from blackjax_tpu_torch.adaptation import pathfinder_adaptation as pa  # noqa: E402
from blackjax_tpu_torch.adaptation.base import return_all_adapt_info  # noqa: E402
from blackjax_tpu_torch.mcmc import hmc, metrics  # noqa: E402
from blackjax_tpu_torch.models.targets import ill_conditioned_gaussian  # noqa: E402
from blackjax_tpu_torch.vi import multipathfinder, pathfinder  # noqa: E402

TOL = 1e-9
D, C, P, S, STEPS, L = 7, 5, 4, 200, 30, 5
FREE_STEPS = 3  # the free run's steps held
X0 = 2.0 * np.random.default_rng(4).standard_normal(D)
SEED = 3
RESAMPLE = 10  # the top-level multipathfinder's draws


def jit(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0,
                                         "xla_cpu_use_fusion_emitters": False})


def _keys(seed):
    key = jax.random.key(seed)
    return key, interop.prng_key(jax.random.key_data(key))


def _close(got, expected, tol=TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    expected = np.asarray(expected, np.float64)
    finite = np.isfinite(expected)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_allclose(got[finite].astype(np.float64), expected[finite], rtol=tol,
                               atol=tol)


def _tapped(taps):
    """Stand-ins for the Pathfinder modules as ``pathfinder_adaptation``
    sees them: the same functions, their arguments and results kept in
    ``taps``."""

    def approximate(*args, **kwargs):
        taps["approximate"] = jpf.approximate(*args, **kwargs)
        return taps["approximate"]

    def multi_approximate(rng_key, logdensity_fn, initial_positions, *args, **kwargs):
        taps["initial_positions"] = initial_positions
        taps["multi_approximate"] = jmpf.multi_approximate(rng_key, logdensity_fn,
                                                          initial_positions, *args, **kwargs)
        return taps["multi_approximate"]

    def psis_weights(state):
        with jax.ensure_compile_time_eval():
            taps["psis_weights"] = jmpf.psis_weights(state)
        return taps["psis_weights"]

    return (types.SimpleNamespace(approximate=approximate, sample=jpf.sample),
            types.SimpleNamespace(multi_approximate=multi_approximate,
                                  psis_weights=psis_weights))


def _reference_runs(key, x0):
    """The JAX package's ``pathfinder_adaptation(...).run`` itself on both
    of its paths (1 chain; ``C`` chains over ``P`` paths) from ``key``,
    every step's record kept, with what its Pathfinder stage computed; and
    the draws that the same stage would give the top-level samplers on
    ``split(key, 3)[1]``."""
    logdensity_fn = jtarget(D).logdensity_fn
    second_key = jax.random.split(key, 3)[1]
    runs = {}
    for label, options in (("single", {}), ("multi", {"num_chains": C, "n_paths": P})):
        taps = {}
        pathfinder_module, mpf_module = _tapped(taps)
        with mock.patch.object(jpa, "pathfinder", pathfinder_module), \
                mock.patch.object(jpa, "mpf", mpf_module):
            (state, parameters), info = jpa.pathfinder_adaptation(
                jhmc, logdensity_fn, num_integration_steps=L, **options).run(key, x0, STEPS)
        runs[label] = {"state": state, "step_size": parameters["step_size"],
                       "imm": parameters["inverse_mass_matrix"], "info": info}
        if label == "single":
            pf_state, pf_info = taps["approximate"]
            runs[label].update(
                pf_state=pf_state, pf_info=pf_info, draws=jpf.sample(second_key, pf_state, 6),
                low_rank=jmetrics.lbfgs_inverse_hessian_to_low_rank_metric(
                    pf_state.alpha, pf_state.beta, pf_state.gamma))
        else:
            mpf_state, _ = taps["multi_approximate"]
            log_w, pareto_k = taps["psis_weights"]
            pool = mpf_state.samples.reshape(-1, D)
            # the top-level multipathfinder's sample (multipathfinder.py:94-100)
            resampled = pool[jax.random.choice(second_key, log_w.shape[0], shape=(RESAMPLE,),
                                               replace=True, p=jnp.exp(log_w))]
            runs[label].update(mpf_state=mpf_state, initial_positions=taps["initial_positions"],
                               log_w=log_w, pareto_k=pareto_k, resampled=resampled)
            assert parameters["_pathfinder_psis_pareto_k"] is pareto_k
    return runs


@pytest.fixture(scope="module")
def reference():
    key, _ = _keys(SEED)
    return jax.tree.map(np.asarray, jit(_reference_runs)(key, jnp.asarray(X0)))


def _target():
    return ill_conditioned_gaussian(D)


@pytest.fixture(scope="module")
def port_runs():
    """The port's ``pathfinder_adaptation`` runs, every step's record kept."""
    _, key = _keys(SEED)
    runs = {}
    for label, options in (("single", {}), ("multi", {"num_chains": C, "n_paths": P})):
        warmup = blackjax_tpu_torch.pathfinder_adaptation(
            hmc, _target().logdensity_fn, num_integration_steps=L, **options)
        runs[label] = warmup.run(key, torch.tensor(X0), STEPS)
    return runs


def test_approximate_is_the_reference_s(reference):
    ref = reference["single"]
    _, key = _keys(SEED)
    init_key = prng.split(key, 3)[0]
    state, info = blackjax_tpu_torch.pathfinder.approximate(init_key, _target().logdensity_fn,
                                                            torch.tensor(X0))
    for field in state._fields:
        _close(getattr(state, field), getattr(ref["pf_state"], field))
        _close(getattr(info.path, field), getattr(ref["pf_info"].path, field))
    elbo = ref["pf_info"].path.elbo
    assert int(torch.argmax(info.path.elbo)) == int(np.argmax(elbo))
    assert np.isneginf(elbo).any() and np.isfinite(elbo).sum() > 3
    draws, logq = pathfinder.sample(prng.split(key, 3)[1], state, 6)
    _close(draws, ref["draws"][0])
    _close(logq, ref["draws"][1])


def test_top_level_pathfinder_is_approximate():
    _, key = _keys(SEED)
    algorithm = blackjax_tpu_torch.pathfinder(_target().logdensity_fn)
    assert blackjax_tpu_torch.pathfinder.approximate is pathfinder.approximate
    assert blackjax_tpu_torch.pathfinder.sample is pathfinder.sample
    state, _ = algorithm.init(key, torch.tensor(X0), 20, maxiter=8)
    expected, _ = pathfinder.approximate(key, _target().logdensity_fn, torch.tensor(X0), 20,
                                         maxiter=8)
    for a, b in zip(state, expected):
        assert torch.equal(a, b)
    draw, logq = algorithm.sample(key, state, ())
    assert draw.shape == (D,) and logq.shape == ()


def test_multi_approximate_and_psis_are_the_reference_s(reference):
    ref = reference["multi"]
    _, key = _keys(SEED)
    pf_key = prng.split(key, 3)[0]
    initial_positions = torch.tensor(X0)[None] + 2.0 * prng.normal(pf_key, (P, D),
                                                                   torch.float64)
    _close(initial_positions, ref["initial_positions"])
    state, info = multipathfinder.multi_approximate(pf_key, _target().logdensity_fn,
                                                    initial_positions, S)
    for field in ("samples", "logp", "logq"):
        _close(getattr(state, field), getattr(ref["mpf_state"], field))
    for field in state.path_states._fields:
        _close(getattr(state.path_states, field), getattr(ref["mpf_state"].path_states, field))
    assert info.path is state.path_states
    log_w, pareto_k = multipathfinder.psis_weights(state)
    _close(log_w, ref["log_w"])
    _close(pareto_k, ref["pareto_k"])
    # the JAX package's state carried into the port weighs its draws alike
    _close(multipathfinder.psis_weights(interop.multipathfinder_state(ref["mpf_state"]))[0],
           ref["log_w"])
    resample_key = prng.split(key, 3)[1]
    resampled = blackjax_tpu_torch.multipathfinder(_target().logdensity_fn).sample(
        resample_key, state, RESAMPLE)
    _close(resampled, ref["resampled"])


def test_mixture_covariance_and_starts_are_the_reference_s(reference, port_runs):
    ref = reference["multi"]
    (_, parameters), info = port_runs["multi"]
    _close(parameters["inverse_mass_matrix"], ref["imm"])
    _close(parameters["_pathfinder_psis_pareto_k"], ref["pareto_k"])
    assert parameters["num_integration_steps"] == L


@pytest.mark.parametrize("label", ["single", "multi"])
def test_the_free_run_s_first_steps_are_the_reference_s(reference, port_runs, label):
    ref = reference[label]
    (state, parameters), info = port_runs[label]
    chains = C if label == "multi" else None
    shape = (C, STEPS) if chains else (STEPS,)
    assert tuple(info.info.acceptance_rate.shape) == shape
    assert tuple(info.adaptation_state.step_size.shape) == shape
    assert tuple(info.adaptation_state.inverse_mass_matrix.shape) == shape + (D, D)
    assert tuple(parameters["step_size"].shape) == ((C,) if chains else ())
    steps = (slice(None), slice(0, FREE_STEPS)) if chains else slice(0, FREE_STEPS)
    _close(info.state.position[steps], ref["info"].state.position[steps])
    _close(info.adaptation_state.step_size[steps], ref["info"].adaptation_state.step_size[steps])
    _close(info.info.acceptance_rate[steps], ref["info"].info.acceptance_rate[steps])
    _close(parameters["inverse_mass_matrix"], ref["imm"])


def _at(tree, index):
    return jax.tree.map(lambda a: a[index], tree)


@pytest.mark.parametrize("label", ["single", "multi"])
def test_every_step_from_the_reference_s_state_is_the_reference_s(reference, label):
    ref = reference[label]
    multi = label == "multi"
    _, key = _keys(SEED)
    loop_key = prng.split(key, 3)[2]
    step_keys = (prng.split(prng.split(loop_key, C), STEPS) if multi
                 else prng.split(loop_key, STEPS))
    adapt_update = pa.base(0.80)[2]
    kernel = hmc.build_kernel()
    axis = 1 if multi else 0
    for t in range(1, STEPS):
        before = (slice(None), t - 1) if multi else t - 1
        here = (slice(None), t) if multi else t
        state = interop.hmc_state(_at(ref["info"].state, before))
        adaptation_state = interop.pathfinder_adaptation_state(
            _at(ref["info"].adaptation_state, before))
        keys = step_keys[:, t:t + 1] if multi else step_keys[t:t + 1]
        new_state, new_adaptation, _ = pa._step_size_loop(
            kernel, _target().logdensity_fn, adapt_update, return_all_adapt_info,
            {"num_integration_steps": L}, keys, state, adaptation_state, axis)
        for got, want in zip(new_state, _at(ref["info"].state, here)):
            _close(got, want)
        for got, want in zip(new_adaptation.ss_state, _at(ref["info"].adaptation_state,
                                                          here).ss_state):
            _close(got, want)
    _close(new_state.position, ref["state"].position)
    _close(torch.exp(new_adaptation.ss_state.log_step_size_avg), ref["step_size"])


def test_low_rank_metric_of_the_chosen_state(reference):
    ref = reference["single"]
    state = interop.pathfinder_state(ref["pf_state"])
    payload = metrics.lbfgs_inverse_hessian_to_low_rank_metric(state.alpha, state.beta,
                                                              state.gamma)
    want = ref["low_rank"]
    _close(payload.sigma, want.sigma)
    _close(payload.lam, want.lam)
    _close((payload.U * payload.lam) @ payload.U.T, (want.U * want.lam) @ want.U.T)


@pytest.mark.parametrize("num_chains", [0, -2])
def test_num_chains_nonpositive_raises(num_chains):
    with pytest.raises(ValueError, match="num_chains"):
        blackjax_tpu_torch.pathfinder_adaptation(hmc, _target().logdensity_fn,
                                                 num_chains=num_chains)


@pytest.mark.parametrize("n_paths", [0, -1])
def test_n_paths_nonpositive_raises(n_paths):
    with pytest.raises(ValueError, match="n_paths"):
        blackjax_tpu_torch.pathfinder_adaptation(hmc, _target().logdensity_fn, n_paths=n_paths)


def test_a_pytree_position_names_the_queue_item():
    warmup = blackjax_tpu_torch.pathfinder_adaptation(hmc, _target().logdensity_fn)
    with pytest.raises(ValueError, match="queue 1, item 11"):
        warmup.run(prng.key(0), {"x": torch.zeros(D)}, 2)
