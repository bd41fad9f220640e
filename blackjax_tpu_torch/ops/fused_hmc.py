"""Chain-blocked HMC on the fused leapfrog (reference
``blackjax_tpu/ops/fused_hmc.py``).

The state is a ``(C, d)`` block. A step is split in two: :meth:`fused_hmc.step`
draws ``z ~ N(0, I)`` and then the accept uniforms from the caller's
generator, and :meth:`fused_hmc.step_from_draws` is the rest, term by term as
the reference's step, so that tests can feed it the reference's draws.
:func:`plan` picks how the rest runs:

- ``"transition"``: a CUDA tensor on an analytic target: the whole rest in
  one launch of the transition kernel (``hmc_transition`` in
  ``csrc/fused_leapfrog.cu``), so a transition is three launches (the two
  draws and the kernel);
- ``"leapfrog"``: everything else: the momentum, energies and accept in
  PyTorch around one call of
  :func:`blackjax_tpu_torch.ops.fused_leapfrog.fused_leapfrog`, which
  launches its tiles form on a CUDA tensor (logistic regression) and runs the
  plain leapfrog on a CPU tensor, so that on the CPU this is the plain
  transition.

A failure to build or launch a kernel raises; nothing falls back to another
form. This is the registered-target fast path; arbitrary logdensities take
the generic :mod:`blackjax_tpu_torch.mcmc.hmc`.
"""
import functools
from typing import NamedTuple, Union

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.ops.fused_leapfrog import (
    TargetKernel,
    _hmc_transition_cuda,
    _hmc_transition_ops,
    fused_leapfrog,
    get_registered_target,
)
from blackjax_tpu_torch.types import Array, PRNGKey

__all__ = [
    "FusedHMCState",
    "FusedHMCInfo",
    "fused_hmc",
    "init",
    "build_kernel",
    "as_top_level_api",
]


class FusedHMCState(NamedTuple):
    positions: Array  # (C, d)
    logdensities: Array  # (C,)


class FusedHMCInfo(NamedTuple):
    acceptance_rate: Array  # (C,)
    is_accepted: Array  # (C,)
    energy: Array  # (C,) proposal energies


def plan(target: TargetKernel, device) -> str:
    """How a transition of ``target`` runs on ``device``: ``"transition"``
    (CUDA, an analytic target) or ``"leapfrog"`` (the rest). What a form
    cannot run, its function refuses: the transition kernel ``d > 256``,
    ``fused_leapfrog`` that and a device type other than CPU and CUDA."""
    analytic = target.matrix is None
    return "transition" if torch.device(device).type == "cuda" and analytic else "leapfrog"


# what runs a transition in each form, with the signature of
# ops.fused_leapfrog._hmc_transition_plain
_RUN = {
    "transition": _hmc_transition_cuda,
    "leapfrog": functools.partial(_hmc_transition_ops, fused_leapfrog),
}


class fused_hmc:
    """Batched-chain HMC bound to a registered analytic target.

    ``init(positions)`` takes a ``(C, d)`` block; ``step(generator, state)``
    advances every chain one Metropolis-adjusted trajectory. Positions and
    log densities are f32, as in the reference.
    """

    def __init__(
        self,
        target: TargetKernel,
        step_size: float,
        inverse_mass_matrix: Array,
        num_integration_steps: int,
        *,
        tile_chains: int = 256,
    ):
        self.target = target
        self.step_size = step_size
        self.inverse_mass_matrix = torch.broadcast_to(
            torch.as_tensor(inverse_mass_matrix).to(torch.float32), (target.dim,)
        ).contiguous()
        self.num_integration_steps = num_integration_steps
        self.tile_chains = tile_chains

    def init(self, positions: Array) -> FusedHMCState:
        positions = torch.as_tensor(positions).to(torch.float32)
        return FusedHMCState(positions, self.target.logdensity_fn(positions))

    def step(self, rng_key: PRNGKey, state: FusedHMCState):
        positions = state.positions
        z = torch.randn(
            positions.shape, generator=rng_key, dtype=torch.float32, device=positions.device
        )
        u = torch.rand(
            positions.shape[:1], generator=rng_key, dtype=torch.float32,
            device=positions.device,
        )
        return self.step_from_draws(state, z, u)

    def step_from_draws(self, state: FusedHMCState, z: Array, u: Array):
        """One transition from given draws: ``z`` ``(C, d)`` standard normal
        momenta in the ``M^{1/2}`` basis, ``u`` ``(C,)`` accept uniforms."""
        dev = state.positions.device
        run = _RUN[plan(self.target, dev)]
        x, logdensities, p_accept, accept, energy = run(
            *(t.to(dtype=torch.float32, device=dev).contiguous()
              for t in (state.positions, state.logdensities, z, u)),
            self.inverse_mass_matrix.to(dev), self.step_size,
            target=self.target, num_steps=self.num_integration_steps,
        )
        return FusedHMCState(x, logdensities), FusedHMCInfo(p_accept, accept, energy)


# ---------------------------------------------------------------------------
# SamplingAlgorithm adapters (init / build_kernel / as_top_level_api)
# ---------------------------------------------------------------------------


def _resolve_target(target, dim=None) -> TargetKernel:
    if isinstance(target, TargetKernel):
        return target
    return get_registered_target(target, dim)


def init(position: Array, target: Union[TargetKernel, str], dim=None) -> FusedHMCState:
    """``position``: a ``(C, d)`` chain block (a single chain is a ``(1, d)``
    block)."""
    position = torch.as_tensor(position)
    target = _resolve_target(target, dim if dim is not None else position.shape[-1])
    positions = torch.atleast_2d(position.to(torch.float32))
    return FusedHMCState(positions, target.logdensity_fn(positions))


def build_kernel(tile_chains: int = 256):
    def kernel(
        rng_key: PRNGKey,
        state: FusedHMCState,
        target: Union[TargetKernel, str],
        step_size: float,
        inverse_mass_matrix: Array,
        num_integration_steps: int,
    ):
        target = _resolve_target(target, state.positions.shape[-1])
        sampler = fused_hmc(
            target, step_size, inverse_mass_matrix, num_integration_steps,
            tile_chains=tile_chains,
        )
        return sampler.step(rng_key, state)

    return kernel


def as_top_level_api(
    target: Union[TargetKernel, str],
    step_size: float,
    inverse_mass_matrix: Array,
    num_integration_steps: int,
    *,
    dim=None,
    tile_chains: int = 256,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.fused_hmc(...)``: the registered-target HMC fast
    path as a :class:`SamplingAlgorithm`. ``target`` is a
    :class:`TargetKernel` or a registered name, resolved against ``dim`` at
    ``init`` (by default the positions' trailing dimension) and against the
    state's width at ``step``, as ``build_kernel``'s kernel resolves it. The
    sampler is built once for each width, at its first step."""
    samplers = {}

    def init_fn(position, rng_key=None):
        del rng_key
        return init(position, target, dim)

    def step_fn(rng_key: PRNGKey, state):
        width = state.positions.shape[-1]
        sampler = samplers.get(width)
        if sampler is None:
            sampler = samplers[width] = fused_hmc(
                _resolve_target(target, width), step_size, inverse_mass_matrix,
                num_integration_steps, tile_chains=tile_chains,
            )
        return sampler.step(rng_key, state)

    return SamplingAlgorithm(init_fn, step_fn)
