"""Trajectory construction: the fixed-length integration of static HMC and
the flattened NUTS engine (reference ``blackjax_tpu/mcmc/trajectory.py``,
``static_integration`` and ``flattened_nuts``).

:func:`flattened_nuts` runs ONE loop over leapfrog leaves with select-based
bookkeeping for subtree boundaries, progressive sampling, checkpointed
U-turn tests and the doubling merge. Every chain of the ``(C, d)`` batch
advances one leaf per iteration; a chain whose transition is done is frozen
(its state passes through unchanged), as the reference's ``while_loop``
under ``vmap`` leaves finished lanes untouched. The loop ends when every
chain is done: one host sync per leaf.

Randomness: each leaf draws three uniforms per chain from the generator: the
direction (used at a subtree's first leaf), the progressive merge (used at
every leaf) and the biased merge (used at a subtree's close). Each is used
at most once, so the draws have the distribution of the reference's
``fold_in``-derived keys; the streams differ. The nested engine and the
per-leaf ``flattened_nuts_machine`` come with later slices.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.mcmc.integrators import IntegratorState
from blackjax_tpu_torch.mcmc.proposal import (
    Proposal,
    progressive_biased_sampling,
    progressive_uniform_sampling,
    proposal_generator,
    tree_select,
)
from blackjax_tpu_torch.mcmc.termination import _checkpoint_slots

__all__ = ["static_integration", "flattened_nuts", "hmc_energy"]


def static_integration(integrator: Callable, direction: int = 1) -> Callable:
    """``integrate(state, step_size, num_integration_steps)``: apply the
    integrator a fixed number of times in one direction (reference
    ``trajectory.py:152``). The step size is a number or one per chain
    ``(C,)``; the step count is one Python int for the whole block. Traced
    per-chain step counts (the reference's ``max_num_integration_steps``)
    come with a later slice."""

    def integrate(initial_state: IntegratorState, step_size, num_integration_steps):
        directed = direction * step_size
        state = initial_state
        for _ in range(int(num_integration_steps)):
            state = integrator(state, directed)
        return state

    return integrate


def hmc_energy(kinetic_energy):
    """Total energy ``-logdensity + K(momentum; position)``."""

    def energy(state):
        return -state.logdensity + kinetic_energy(state.momentum, position=state.position)

    return energy


class _FlatNUTSState(NamedTuple):
    """Per-chain registers of the flattened NUTS loop (all select-updated).
    The reference also carries the transition's PRNG key; here the
    generator is an argument of each leaf."""

    current: IntegratorState
    left: IntegratorState
    right: IntegratorState
    momentum_sum: torch.Tensor  # (C, d), includes the initial momentum
    proposal: Proposal
    num_states: torch.Tensor
    direction: torch.Tensor  # +-1.0
    depth: torch.Tensor
    leaf: torch.Tensor
    sub_momentum_sum: torch.Tensor
    sub_proposal: Proposal
    ckpt_momentum: torch.Tensor  # (C, max_depth, d)
    ckpt_momentum_sum: torch.Tensor
    is_diverging: torch.Tensor
    is_turning: torch.Tensor
    done: torch.Tensor
    initial_energy: torch.Tensor


def flattened_nuts(
    integrator: Callable,
    kinetic_energy: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    batched_uturn_check_fn: Callable = None,
) -> Callable:
    """Build the flattened single-loop NUTS proposal engine (reference
    ``trajectory.py:571``).

    Returns ``propose(generator, initial_state, step_size) -> (state,
    info_tuple)`` with ``info_tuple = (proposal, left, right, momentum_sum,
    num_states, depth_reached, is_diverging, is_turning)``.
    """
    machine_init, leaf_body = _flat_nuts_parts(
        integrator,
        kinetic_energy,
        uturn_check_fn,
        max_num_expansions,
        divergence_threshold,
        batched_uturn_check_fn,
    )

    def propose(rng_key: torch.Generator, initial_state: IntegratorState, step_size):
        s = machine_init(initial_state)
        while True:
            s = leaf_body(s, step_size, rng_key)
            if bool(s.done.all()):
                break
        info = (
            s.proposal,
            s.left,
            s.right,
            s.momentum_sum,
            s.num_states,
            s.depth,
            s.is_diverging,
            s.is_turning,
        )
        return s.proposal.state, info

    return propose


def _flat_nuts_parts(
    integrator: Callable,
    kinetic_energy: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int,
    divergence_threshold: float,
    batched_uturn_check_fn: Callable = None,
):
    """``machine_init`` and the per-leaf body of the flattened engine."""
    energy_fn = hmc_energy(kinetic_energy)
    _, generate_proposal = proposal_generator(energy_fn)
    max_depth = max_num_expansions

    def machine_init(initial_state: IntegratorState) -> _FlatNUTSState:
        m0 = initial_state.momentum
        batch = m0.shape[:-1]
        initial_energy = energy_fn(initial_state)
        initial_proposal = Proposal(
            initial_state,
            initial_energy,
            torch.zeros_like(initial_energy),
            torch.full_like(initial_energy, -torch.inf),
        )
        zeros_ckpt = m0.new_zeros(batch + (max_depth, m0.shape[-1]))
        izero = torch.zeros(batch, dtype=torch.int64, device=m0.device)
        bfalse = torch.zeros(batch, dtype=torch.bool, device=m0.device)
        return _FlatNUTSState(
            current=initial_state,
            left=initial_state,
            right=initial_state,
            momentum_sum=m0,
            proposal=initial_proposal,
            num_states=izero,
            direction=m0.new_ones(batch),
            depth=izero,
            leaf=izero,
            sub_momentum_sum=torch.zeros_like(m0),
            sub_proposal=initial_proposal,
            ckpt_momentum=zeros_ckpt,
            ckpt_momentum_sum=zeros_ckpt,
            is_diverging=bfalse,
            is_turning=bfalse,
            done=bfalse,
            initial_energy=initial_energy,
        )

    def leaf_body(s: _FlatNUTSState, step_size, rng_key) -> _FlatNUTSState:
        m_cur = s.current.momentum
        u_dir, u_leaf, u_prop = torch.rand(
            (3,) + s.done.shape, generator=rng_key, dtype=m_cur.dtype, device=m_cur.device
        )

        # -------- subtree start: pick direction, reset registers -----
        at_start = s.leaf == 0
        new_dir = torch.where(u_dir < 0.5, 1.0, -1.0).to(m_cur.dtype)
        direction = torch.where(at_start, new_dir, s.direction)
        start_state = tree_select(direction > 0, s.right, s.left)
        current = tree_select(at_start, start_state, s.current)

        # -------- one leapfrog step ----------------------------------
        new_state = integrator(current, direction * step_size)
        m_new = new_state.momentum
        new_proposal = generate_proposal(s.initial_energy, new_state)
        leaf_diverging = -new_proposal.weight > divergence_threshold

        # -------- subtree progressive sampling -----------------------
        merged_sub = progressive_uniform_sampling(u_leaf, s.sub_proposal, new_proposal)
        sub_momentum_sum = torch.where(
            at_start[..., None], m_new, s.sub_momentum_sum + m_new
        )
        sub_proposal = tree_select(at_start, new_proposal, merged_sub)

        # -------- checkpointed subtree U-turn test -------------------
        idx_min, idx_max = _checkpoint_slots(s.leaf)
        row = torch.arange(max_depth, device=m_new.device)
        write = (((s.leaf % 2) == 0)[..., None] & (row == idx_max[..., None]))[..., None]
        ckpt_momentum = torch.where(write, m_new[..., None, :], s.ckpt_momentum)
        ckpt_momentum_sum = torch.where(
            write, sub_momentum_sum[..., None, :], s.ckpt_momentum_sum
        )
        if batched_uturn_check_fn is not None:
            active = (row >= idx_min[..., None]) & (row <= idx_max[..., None])
            subtree_turning = batched_uturn_check_fn(
                ckpt_momentum, ckpt_momentum_sum, m_new, sub_momentum_sum, active
            )
        else:
            subtree_turning = torch.zeros_like(s.done)
            for i in range(max_depth):
                active = (i >= idx_min) & (i <= idx_max)
                subtree_sum = (
                    sub_momentum_sum - ckpt_momentum_sum[..., i, :] + ckpt_momentum[..., i, :]
                )
                subtree_turning = subtree_turning | (
                    active & uturn_check_fn(ckpt_momentum[..., i, :], m_new, subtree_sum)
                )

        # -------- subtree boundary bookkeeping -----------------------
        leaf = s.leaf + 1
        subtree_complete = leaf >= (torch.ones_like(s.depth) << s.depth)
        subtree_aborted = leaf_diverging | subtree_turning
        closing = subtree_complete | subtree_aborted

        momentum_sum = torch.where(
            closing[..., None], s.momentum_sum + sub_momentum_sum, s.momentum_sum
        )
        forward = direction > 0
        left = tree_select(closing, tree_select(forward, s.left, new_state), s.left)
        right = tree_select(closing, tree_select(forward, new_state, s.right), s.right)

        # proposal at subtree close: biased merge if healthy, acceptance
        # statistics only if the subtree diverged or turned
        slpa_only = Proposal(
            s.proposal.state,
            s.proposal.energy,
            s.proposal.weight,
            torch.logaddexp(s.proposal.sum_log_p_accept, sub_proposal.sum_log_p_accept),
        )
        biased = progressive_biased_sampling(u_prop, s.proposal, sub_proposal)
        closed_proposal = tree_select(subtree_aborted, slpa_only, biased)
        proposal = tree_select(closing, closed_proposal, s.proposal)

        full_turning = closing & uturn_check_fn(left.momentum, right.momentum, momentum_sum)

        depth = torch.where(closing, s.depth + 1, s.depth)
        leaf = torch.where(closing, torch.zeros_like(leaf), leaf)
        is_diverging = s.is_diverging | leaf_diverging
        is_turning = s.is_turning | (closing & (subtree_turning | full_turning))
        done = is_diverging | is_turning | (closing & (depth >= max_depth))

        new = _FlatNUTSState(
            current=new_state,
            left=left,
            right=right,
            momentum_sum=momentum_sum,
            proposal=proposal,
            num_states=s.num_states + 1,
            direction=direction,
            depth=depth,
            leaf=leaf,
            sub_momentum_sum=sub_momentum_sum,
            sub_proposal=sub_proposal,
            ckpt_momentum=ckpt_momentum,
            ckpt_momentum_sum=ckpt_momentum_sum,
            is_diverging=is_diverging,
            is_turning=is_turning,
            done=done,
            initial_energy=s.initial_energy,
        )
        # chains that finished before this leaf keep their state
        return tree_select(s.done, s, new)

    return machine_init, leaf_body
