"""Carries state from the JAX package into the port.

Each function takes the reference's values as numpy arrays (``np.asarray``
of a JAX array) and returns the port's tensors on a chosen device and dtype,
so both packages can compute from the same state: HMC states and NUTS infos,
inverse mass matrices (diagonal, dense or low-rank payloads) and step sizes
(alone or as a warmup's parameters), low-rank metric cores' states,
MCLMC states and tuned parameters, fused-HMC states, the fused kernels'
targets, the test posteriors by name, and PRNG keys (as key words, with
which the port draws what the reference draws), and the SMC layer's states
and infos (tempered SMC states, ``SMCInfo`` with its update's info, MALA
states, persistent-sampling states), nested sampling's states and infos
(``NSState``, ``AdaptiveNSState`` with its integrator and inner-kernel
parameters, ``NSInfo``), and the states of the MCMC family beyond NUTS (dynamic HMC with
its carried key, GHMC, Barker, the random walks, elliptical slice, slice,
periodic orbital and mGrad, with mGrad's ``CovarianceSVD``), and the ChEES
warmup's controller state (with its dual-averaging and optax Adam states)
and tuned parameters, and Pathfinder's records (``PathfinderState``,
``LBFGSHistory``, ``MultipathfinderState`` and the Pathfinder warmup's
``PathfinderAdaptationState``), and the variational families' states
(``MFVIState``, ``FRVIState``, ``SVGDState``, ``SchrodingerFollmerState``)
with the optax states inside them (Adam's ``ScaleByAdamState``, sgd's
``TraceState`` and the stateless ``EmptyState``) as the port's twins.
"""
import numpy as np
import torch

from blackjax_tpu_torch.adaptation.chees_adaptation import ChEESAdaptationState
from blackjax_tpu_torch.adaptation.mclmc_adaptation import MCLMCAdaptationState
from blackjax_tpu_torch.adaptation.pathfinder_adaptation import PathfinderAdaptationState
from blackjax_tpu_torch.adaptation.step_size import DualAveragingAdaptationState
from blackjax_tpu_torch.adaptation.metric_recipes import LowRankMetricCoreState
from blackjax_tpu_torch.mcmc.barker import BarkerInfo, BarkerState
from blackjax_tpu_torch.mcmc.dynamic_hmc import DynamicHMCState
from blackjax_tpu_torch.mcmc.elliptical_slice import EllipSliceInfo, EllipSliceState
from blackjax_tpu_torch.mcmc.ghmc import GHMCState
from blackjax_tpu_torch.mcmc.hmc import HMCInfo, HMCState
from blackjax_tpu_torch.mcmc.integrators import IntegratorState
from blackjax_tpu_torch.mcmc.mala import MALAInfo, MALAState
from blackjax_tpu_torch.mcmc.marginal_latent_gaussian import (
    CovarianceSVD,
    MarginalInfo,
    MarginalState,
)
from blackjax_tpu_torch.mcmc.periodic_orbital import PeriodicOrbitalInfo, PeriodicOrbitalState
from blackjax_tpu_torch.mcmc.random_walk import RWInfo, RWState
from blackjax_tpu_torch.mcmc.slice import SliceInfo, SliceState
from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix
from blackjax_tpu_torch.mcmc.nuts import NUTSInfo
from blackjax_tpu_torch.models import targets
from blackjax_tpu_torch.ns.adaptive import AdaptiveNSState
from blackjax_tpu_torch.ns.base import NSInfo, NSState, StateWithLogLikelihood
from blackjax_tpu_torch.ns.from_mcmc import ConstrainedMCMCInfo
from blackjax_tpu_torch.ns.integrator import NSIntegrator
from blackjax_tpu_torch.smc.base import SMCInfo
from blackjax_tpu_torch.smc.persistent_sampling import PersistentSMCState
from blackjax_tpu_torch.smc.tempered import TemperedSMCState
from blackjax_tpu_torch.ops import fused_nuts_dc, targets_dc
from blackjax_tpu_torch.ops.fused_hmc import FusedHMCState
from blackjax_tpu_torch.optimizers.dual_averaging import DualAveragingState
from blackjax_tpu_torch.optimizers.lbfgs import LBFGSHistory
from blackjax_tpu_torch.optimizers.optax_twins import EmptyState, ScaleByAdamState, TraceState
from blackjax_tpu_torch.ops.fused_nuts import make_mxu_safe_hierarchical_target
from blackjax_tpu_torch.ops.fused_leapfrog import (
    TargetKernel,
    gaussian_target_from_params,
    make_gaussian_target,
    make_hierarchical_gaussian_target,
    make_logistic_regression_target,
)
from blackjax_tpu_torch.vi.fullrank_vi import FRVIState
from blackjax_tpu_torch.vi.meanfield_vi import MFVIState
from blackjax_tpu_torch.vi.multipathfinder import MultipathfinderState
from blackjax_tpu_torch.vi.pathfinder import PathfinderState
from blackjax_tpu_torch.vi.schrodinger_follmer import SchrodingerFollmerState
from blackjax_tpu_torch.vi.svgd import SVGDState

__all__ = [
    "to_tensor",
    "prng_key",
    "hmc_state",
    "nuts_info",
    "inverse_mass_matrix",
    "low_rank_inverse_mass_matrix",
    "low_rank_core_state",
    "step_size",
    "adaptation_parameters",
    "mclmc_state",
    "mala_state",
    "dynamic_hmc_state",
    "sampler_state",
    "covariance_svd",
    "tempered_smc_state",
    "smc_info",
    "persistent_smc_state",
    "ns_state",
    "ns_info",
    "mclmc_parameters",
    "fused_hmc_state",
    "pathfinder_state",
    "lbfgs_history",
    "multipathfinder_state",
    "pathfinder_adaptation_state",
    "target_dc",
    "fused_target",
    "target",
]


def to_tensor(value, *, device=None, dtype=None) -> torch.Tensor:
    """A numpy array (or scalar) as a tensor; integer and bool arrays keep
    their kind, floating arrays take ``dtype`` (their own if None)."""
    array = np.asarray(value)
    t = torch.from_numpy(array.copy())
    if t.is_floating_point() and dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def prng_key(key_data, *, device=None) -> torch.Tensor:
    """The reference's keys as the port's key words: ``key_data`` is
    ``jax.random.key_data(keys)`` (or a raw ``uint32`` key array), words
    ``(..., 2)``; returns them as an int64 tensor in ``[0, 2**32)``."""
    words = np.asarray(key_data)
    if words.shape[-1:] != (2,) or words.dtype != np.uint32:
        raise ValueError(
            f"expected uint32 key words (..., 2), got {words.dtype} {words.shape}"
        )
    return torch.from_numpy(words.astype(np.int64)).to(device)


def hmc_state(state, *, device=None, dtype=None) -> HMCState:
    """An ``HMCState`` of the reference (fields as arrays) as the port's."""
    return HMCState(*(to_tensor(v, device=device, dtype=dtype) for v in state))


def nuts_info(info, *, device=None, dtype=None) -> NUTSInfo:
    """A ``NUTSInfo`` of the reference as the port's; its trajectory end
    states become the port's ``IntegratorState``."""

    def convert(value):
        if isinstance(value, tuple):
            return IntegratorState(*(to_tensor(v, device=device, dtype=dtype) for v in value))
        return to_tensor(value, device=device, dtype=dtype)

    return NUTSInfo(*(convert(v) for v in info))


def inverse_mass_matrix(value, *, device=None, dtype=None):
    """A diagonal ``(d,)`` or dense ``(d, d)`` inverse mass matrix as a
    tensor, or a low-rank payload (any ``(sigma, U, lam)`` tuple) as the
    port's :class:`LowRankInverseMassMatrix`."""
    if isinstance(value, tuple):
        return low_rank_inverse_mass_matrix(value, device=device, dtype=dtype)
    t = to_tensor(value, device=device, dtype=dtype)
    if t.dim() not in (1, 2):
        raise ValueError(f"inverse mass matrix must be 1-d or 2-d, got {t.dim()}-d")
    return t


def low_rank_inverse_mass_matrix(payload, *, device=None, dtype=None) -> LowRankInverseMassMatrix:
    """The reference's ``LowRankInverseMassMatrix(sigma, U, lam)`` as the
    port's."""
    sigma, U, lam = (to_tensor(v, device=device, dtype=dtype) for v in payload)
    if sigma.dim() != 1 or U.shape != (sigma.shape[0], lam.shape[0]) or lam.dim() != 1:
        raise ValueError(
            f"low-rank payload shapes sigma {tuple(sigma.shape)}, U {tuple(U.shape)}, "
            f"lam {tuple(lam.shape)} do not fit (d,), (d, k), (k,)"
        )
    return LowRankInverseMassMatrix(sigma, U, lam)


def low_rank_core_state(state, *, device=None, dtype=None) -> LowRankMetricCoreState:
    """A low-rank metric core's state of the reference (payload, ``mu*``,
    buffers and counters) as the port's: tensors, with the counters as
    Python integers."""
    return LowRankMetricCoreState(
        low_rank_inverse_mass_matrix(state.inverse_mass_matrix, device=device, dtype=dtype),
        to_tensor(state.mu_star, device=device, dtype=dtype),
        to_tensor(state.draws_buffer, device=device, dtype=dtype),
        to_tensor(state.grads_buffer, device=device, dtype=dtype),
        int(np.asarray(state.buffer_idx)),
        int(np.asarray(state.background_split)),
        int(np.asarray(state.recompute_counter)),
    )


def step_size(value) -> float:
    """A step size (array scalar) as a Python float."""
    return float(np.asarray(value))


def adaptation_parameters(parameters: dict, *, device=None, dtype=None) -> dict:
    """A warmup's ``results.parameters`` (reference ``window_adaptation`` or
    ``window_adaptation_low_rank``) as the port's: the step size a number,
    the inverse mass matrix a tensor or a low-rank payload; any other entry
    passes through."""
    out = dict(parameters)
    out["step_size"] = step_size(parameters["step_size"])
    out["inverse_mass_matrix"] = inverse_mass_matrix(
        parameters["inverse_mass_matrix"], device=device, dtype=dtype
    )
    return out


def mclmc_state(state, *, device=None, dtype=None) -> IntegratorState:
    """An MCLMC state of the reference (an ``IntegratorState``, fields as
    arrays) as the port's."""
    return IntegratorState(*(to_tensor(v, device=device, dtype=dtype) for v in state))


def mclmc_parameters(params, *, device=None, dtype=None) -> MCLMCAdaptationState:
    """The reference's ``MCLMCAdaptationState`` as the port's: ``L`` and the
    step size as numbers, the inverse mass matrix as a tensor."""
    return MCLMCAdaptationState(
        step_size(params.L),
        step_size(params.step_size),
        to_tensor(params.inverse_mass_matrix, device=device, dtype=dtype),
    )


def mala_state(state, *, device=None, dtype=None) -> MALAState:
    """A ``MALAState`` of the reference (fields as arrays) as the port's."""
    return MALAState(*(to_tensor(v, device=device, dtype=dtype) for v in state))


# the reference's state and info records by name, and the port's counterparts
_RECORDS = {cls.__name__: cls for cls in (
    MALAInfo, MALAState, HMCInfo, HMCState, IntegratorState, SMCInfo, TemperedSMCState,
    GHMCState, BarkerState, BarkerInfo, RWState, RWInfo, EllipSliceState, EllipSliceInfo,
    SliceState, SliceInfo, PeriodicOrbitalState, PeriodicOrbitalInfo, MarginalState,
    MarginalInfo, CovarianceSVD, StateWithLogLikelihood, NSState, NSInfo, AdaptiveNSState,
    NSIntegrator, ConstrainedMCMCInfo, ScaleByAdamState, TraceState, EmptyState, MFVIState,
    FRVIState, SVGDState, SchrodingerFollmerState)}


def _tree(value, device, dtype):
    """A tree of the reference's values as the port's: its records by name,
    tuples, lists and dicts walked, every leaf a tensor, ``None`` kept."""
    if value is None:
        return None
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        cls = _RECORDS.get(type(value).__name__)
        if cls is None:
            raise NotImplementedError(f"record {type(value).__name__} is not ported yet")
        return cls(*(_tree(v, device, dtype) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_tree(v, device, dtype) for v in value)
    if isinstance(value, dict):
        return {k: _tree(v, device, dtype) for k, v in value.items()}
    return to_tensor(value, device=device, dtype=dtype)


def dynamic_hmc_state(state, *, device=None, dtype=None) -> DynamicHMCState:
    """A ``DynamicHMCState`` of the reference as the port's; its
    ``random_generator_arg`` given as key words (``jax.random.key_data`` of
    the keys, uint32 ``(..., 2)``) becomes the port's keys, any other
    integer array (a Halton index) a tensor."""
    *fields, arg = state
    arg = np.asarray(arg)
    if arg.dtype == np.uint32 and arg.shape[-1:] == (2,):
        arg = prng_key(arg, device=device)
    else:
        arg = to_tensor(arg, device=device)
    return DynamicHMCState(*(to_tensor(v, device=device, dtype=dtype) for v in fields), arg)


def chees_adaptation_state(state, *, device=None, dtype=None) -> ChEESAdaptationState:
    """The reference's ``ChEESAdaptationState`` (one step's, fields as
    arrays) as the port's: the scalars 0-d tensors, the dual-averaging state
    with its integer ``step``, optax's Adam state ``(ScaleByAdamState(count,
    mu, nu), EmptyState())`` as the port's twin, and the Halton index and
    the step counter as Python ints."""
    def scalar(v):
        return to_tensor(v, device=device, dtype=dtype)

    adam, _ = state.optim_state
    return ChEESAdaptationState(
        scalar(state.step_size),
        scalar(state.log_step_size_moving_average),
        scalar(state.trajectory_length),
        scalar(state.log_trajectory_length_moving_average),
        DualAveragingState(*(scalar(v) for v in state.da_state)),
        (ScaleByAdamState(to_tensor(adam.count, device=device), scalar(adam.mu), scalar(adam.nu)),
         EmptyState()),
        int(np.asarray(state.random_generator_arg)),
        int(np.asarray(state.step)),
    )


def chees_parameters(parameters: dict, like: dict, *, device=None, dtype=None) -> dict:
    """The reference ChEES warmup's ``results.parameters`` as the port's: the
    step size, the inverse mass matrix and the integration-steps parameters
    as tensors; the two functions (JAX code, which the port cannot call)
    taken from ``like``, the port's parameters of a warmup of the same
    configuration."""
    return {
        "step_size": to_tensor(parameters["step_size"], device=device, dtype=dtype),
        "inverse_mass_matrix": to_tensor(parameters["inverse_mass_matrix"], device=device,
                                         dtype=dtype),
        "next_random_arg_fn": like["next_random_arg_fn"],
        "integration_steps_fn": like["integration_steps_fn"],
        "integration_steps_params": tuple(
            to_tensor(v, device=device, dtype=dtype)
            for v in parameters["integration_steps_params"]),
    }


def pathfinder_state(state, *, device=None, dtype=None) -> PathfinderState:
    """A ``PathfinderState`` of the reference (one path's, a batch's or a
    whole path's, fields as arrays) as the port's."""
    return PathfinderState(*(to_tensor(v, device=device, dtype=dtype) for v in state))


def lbfgs_history(history, *, device=None, dtype=None) -> LBFGSHistory:
    """The reference's ``LBFGSHistory`` as the port's; ``update_mask``
    stays boolean."""
    return LBFGSHistory(*(to_tensor(v, device=device, dtype=dtype) for v in history))


def multipathfinder_state(state, *, device=None, dtype=None) -> MultipathfinderState:
    """The reference's ``MultipathfinderState`` (the paths' states, their
    draws and the draws' log-densities) as the port's."""
    return MultipathfinderState(
        pathfinder_state(state.path_states, device=device, dtype=dtype),
        *(to_tensor(v, device=device, dtype=dtype) for v in state[1:]))


def pathfinder_adaptation_state(state, *, device=None, dtype=None) -> PathfinderAdaptationState:
    """The reference Pathfinder warmup's ``PathfinderAdaptationState`` (one
    step's, a chain's or ``(C, ...)`` chains', fields as arrays) as the
    port's: the dual-averaging state's fields tensors, its ``step``
    integer."""
    return PathfinderAdaptationState(
        DualAveragingAdaptationState(*(to_tensor(v, device=device, dtype=dtype)
                                       for v in state.ss_state)),
        to_tensor(state.step_size, device=device, dtype=dtype),
        to_tensor(state.inverse_mass_matrix, device=device, dtype=dtype))


def sampler_state(state, *, device=None, dtype=None):
    """A state or info record of the reference's samplers (GHMC, Barker,
    the random walks, elliptical slice, slice, periodic orbital, mGrad, or
    an HMC record) or variational families (``MFVIState``, ``FRVIState``,
    ``SVGDState`` with its kernel parameters, ``SchrodingerFollmerState``,
    with the optax states inside: Adam's ``(ScaleByAdamState(count, mu,
    nu), EmptyState())``, sgd's ``(TraceState(trace) or EmptyState(),
    EmptyState())``, the int32 ``count`` kept), fields as arrays, as the
    port's record of the same name."""
    return _tree(state, device, dtype)


def covariance_svd(cov_svd, *, device=None, dtype=None) -> CovarianceSVD:
    """mGrad's ``CovarianceSVD`` of the reference (``U``, ``Gamma``,
    ``U_t``) as the port's, so that both draw along the same eigenvectors."""
    return CovarianceSVD(*(to_tensor(v, device=device, dtype=dtype) for v in cov_svd))


def tempered_smc_state(state, *, device=None, dtype=None) -> TemperedSMCState:
    """A ``TemperedSMCState`` of the reference (particles a tensor or a
    pytree) as the port's, its tempering parameter a 0-d tensor."""
    return _tree(TemperedSMCState(*state), device, dtype)


def smc_info(info, *, device=None, dtype=None) -> SMCInfo:
    """An ``SMCInfo`` of the reference as the port's: ancestors an integer
    tensor, the increment a tensor, the update's info (MALA's or HMC's
    record) the port's record."""
    return _tree(SMCInfo(*info), device, dtype)


def persistent_smc_state(state, *, device=None, dtype=None) -> PersistentSMCState:
    """A ``PersistentSMCState`` of the reference (the padded history, its
    particles a tensor or a pytree) as the port's, its iteration an int."""
    *fields, iteration = state
    return PersistentSMCState(*(_tree(v, device, dtype) for v in fields),
                              int(np.asarray(iteration)))


def ns_state(state, *, device=None, dtype=None):
    """An ``NSState`` or ``AdaptiveNSState`` of the reference (the live
    set's ``StateWithLogLikelihood``; the integrator and the inner kernel's
    parameters) as the port's."""
    return _tree(state, device, dtype)


def ns_info(info, *, device=None, dtype=None) -> NSInfo:
    """An ``NSInfo`` of the reference (the dead particles and the inner
    update's info: slice or constrained-MCMC records) as the port's."""
    return _tree(NSInfo(*info), device, dtype)


def fused_hmc_state(state, *, device=None) -> FusedHMCState:
    """A ``FusedHMCState`` of the reference (f32 positions and log
    densities) as the port's."""
    return FusedHMCState(*(to_tensor(v, device=device, dtype=torch.float32) for v in state))


def fused_target(name: str, dim: int, params=()) -> TargetKernel:
    """The fused kernels' target of the reference's ``TargetKernel.name``;
    ``params`` are the reference target's ``params`` (the Gaussian's
    inverse variances; logistic regression's ``(X_full, y_row, row_mask)``,
    which do not hold the prior scale: the reference's default, 10, is
    taken)."""
    if name == "logistic_regression":
        X_full, y_row, row_mask = (np.asarray(p, np.float32) for p in params)
        n = int(row_mask.sum())
        return make_logistic_regression_target(X_full[:n, :dim], y_row[0, :n])
    if name == "hierarchical_gaussian":
        return make_hierarchical_gaussian_target(dim)
    if name == "hierarchical_gaussian_mxu_safe":
        return make_mxu_safe_hierarchical_target(dim)
    if name == "gaussian":
        if not params:
            return make_gaussian_target(dim)
        inv_var = tuple(float(v) for v in np.asarray(params[0], np.float32))
        return gaussian_target_from_params(dim, inv_var)
    raise NotImplementedError(f"fused target {name!r} is not ported yet")


def _trailing_zero_rows(X_pad) -> int:
    nonzero = np.flatnonzero(np.abs(X_pad).sum(axis=1))
    return X_pad.shape[0] - (int(nonzero[-1]) + 1 if nonzero.size else 0)


def target_dc(name: str, dim: int, params=()) -> fused_nuts_dc.TargetKernelDC:
    """The dc machine's target of the reference's ``TargetKernelDC.name``;
    ``params`` are the reference target's ``params``.

    - ``gaussian_dc``: the inverse variances.
    - ``logreg_dc``: ``(v, X_pad)``. The real data rows are those before
      ``X_pad``'s trailing zero rows of sublane padding (at most 7); the
      prior scale is not among the params: the reference's default, 10, is
      taken.
    - ``finnish_horseshoe_dc_{N}x{M}``: ``(u, s, X_pad)``. They fold the
      data but not ``y . y`` and ``sum y``, so the target is rebuilt from the
      default dataset at ``N``, ``M``, and refused if its params differ.
    - ``eight_schools_dc``: constants.
    """
    if name == "logreg_dc":
        v, X_pad = (np.asarray(p, np.float32) for p in params)
        num_points = X_pad.shape[0] - min(_trailing_zero_rows(X_pad), 7)
        return targets_dc.logreg_target_dc_from_params(dim, v, X_pad, num_points)
    if name.startswith("finnish_horseshoe_dc_"):
        N, M = (int(v) for v in name.rpartition("_")[2].split("x"))
        target = targets_dc.make_finnish_horseshoe_target_dc(num_points=N, num_predictors=M)
        if target.dim != dim or (params and not all(
                np.array_equal(np.asarray(a, np.float32), b)
                for a, b in zip(params, target.params))):
            raise NotImplementedError(
                f"{name}: only the default dataset is rebuilt from params; build the "
                "target with make_finnish_horseshoe_target_dc(X=..., y=...)"
            )
        return target
    if name == "eight_schools_dc":
        return targets_dc.make_eight_schools_target_dc()
    if name == "hierarchical_gaussian_dc":
        return fused_nuts_dc.make_hierarchical_target_dc(dim)
    if name == "gaussian_dc":
        if not params:
            return fused_nuts_dc.make_gaussian_target_dc(dim)
        inv_var = tuple(float(v) for v in np.asarray(params[0], np.float32))
        return fused_nuts_dc.gaussian_target_dc_from_params(dim, inv_var)
    raise NotImplementedError(f"dc target {name!r} is not ported yet")


_TARGETS = {
    "std_normal": targets.standard_normal,
    "ill_cond_gaussian": targets.ill_conditioned_gaussian,
    "hierarchical_gaussian": targets.hierarchical_gaussian,
}


def target(name: str, dim: int | None = None) -> targets.Target:
    """A test posterior by the reference's ``Target.name`` (such as
    ``"hierarchical_gaussian_100"`` or ``"finnish_horseshoe_100x200"``) or
    by its family and ``dim``. The reference's ``logreg_*`` data come from
    ``jax.random``: hand them to ``targets.logistic_regression(X=, y=)``."""
    if name == "eight_schools":
        return targets.eight_schools_noncentered()
    if name.startswith("finnish_horseshoe_"):
        N, M = (int(v) for v in name.rpartition("_")[2].split("x"))
        return targets.finnish_horseshoe(N, M)
    family, _, suffix = name.rpartition("_")
    if suffix.isdigit() and family in _TARGETS:
        return _TARGETS[family](int(suffix))
    if name in _TARGETS and dim is not None:
        return _TARGETS[name](dim)
    raise NotImplementedError(f"target {name!r} is not ported yet")
