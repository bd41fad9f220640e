"""Trajectory construction: the fixed-length integration of static HMC and
the two NUTS engines (reference ``blackjax_tpu/mcmc/trajectory.py``).

- :func:`dynamic_progressive_integration` and
  :func:`dynamic_multiplicative_expansion` keep the reference's nested loop
  structure: the semantic specification and the parity path. Here they run
  a ``(C, d)`` batch, each loop going on while any chain goes on, with the
  chains that stopped held by masks (as the reference's ``while_loop``
  under ``vmap`` holds finished lanes).
- :func:`flattened_nuts` runs ONE loop over leapfrog leaves with
  select-based bookkeeping for subtree boundaries, progressive sampling,
  checkpointed U-turn tests and the doubling merge. Every chain advances one
  leaf per iteration; a chain whose transition is done is frozen. The loop
  ends when every chain is done: one host sync per leaf.
  :func:`flattened_nuts_machine` exposes the same leaf as a resumable
  per-leaf machine for the continuous runner.

Randomness follows the reference key for key: a chain's transition key
``(2,)`` (a batch carries one per chain, :mod:`blackjax_tpu_torch.prng`)
gives each subtree ``fold_in(key, depth)``, split into the direction,
trajectory and proposal keys, and each leaf ``fold_in(trajectory_key,
leaf)``. So both engines draw what the reference draws from the same keys,
and the nested and flattened engines agree bit for bit. The reference's
even/odd leaf pairing of the flattened loop is a TPU elision with identical
results; here every leaf takes the one dynamic body.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.mcmc.integrators import IntegratorState
from blackjax_tpu_torch.mcmc.proposal import (
    Proposal,
    progressive_biased_sampling,
    progressive_uniform_sampling,
    proposal_generator,
    tree_select,
)
from blackjax_tpu_torch.mcmc.termination import _checkpoint_slots, _slot_turning

__all__ = [
    "Trajectory",
    "append_to_trajectory",
    "reorder_trajectories",
    "merge_trajectories",
    "static_integration",
    "static_progressive_integration",
    "dynamic_progressive_integration",
    "dynamic_multiplicative_expansion",
    "dynamic_recursive_integration",
    "flattened_nuts",
    "flattened_nuts_machine",
    "hmc_energy",
]


class Trajectory(NamedTuple):
    leftmost_state: IntegratorState
    rightmost_state: IntegratorState
    momentum_sum: torch.Tensor  # (..., d)
    num_states: torch.Tensor  # (...) int


def append_to_trajectory(trajectory: Trajectory, state: IntegratorState) -> Trajectory:
    """Extend the trajectory to the right by one state."""
    return Trajectory(
        trajectory.leftmost_state,
        state,
        trajectory.momentum_sum + state.momentum,
        trajectory.num_states + 1,
    )


def reorder_trajectories(direction, trajectory: Trajectory, new_trajectory: Trajectory):
    """Order (existing, new) as (left, right) by the integration direction,
    per chain."""
    forward = direction > 0
    left = tree_select(forward, trajectory, new_trajectory)
    right = tree_select(forward, new_trajectory, trajectory)
    return left, right


def merge_trajectories(left: Trajectory, right: Trajectory) -> Trajectory:
    return Trajectory(
        left.leftmost_state,
        right.rightmost_state,
        left.momentum_sum + right.momentum_sum,
        left.num_states + right.num_states,
    )


def hmc_energy(kinetic_energy):
    """Total energy ``-logdensity + K(momentum; position)``."""

    def energy(state):
        return -state.logdensity + kinetic_energy(state.momentum, position=state.position)

    return energy


# ------------------------------------------------------------------------
# Static trajectories
# ------------------------------------------------------------------------


def static_integration(integrator: Callable, direction: int = 1) -> Callable:
    """``integrate(state, step_size, num_integration_steps,
    max_num_integration_steps=None)``: apply the integrator a fixed number
    of times in one direction (reference ``trajectory.py:152``). The step
    size is a number or one per chain ``(C,)``.

    An int step count runs that many steps. A step count per chain, a
    ``(C,)`` integer tensor, runs the reference's masked fixed-trip loop:
    ``max_num_integration_steps`` steps (by default the largest count, read
    once to the host), a chain's state frozen once ``i >= num[c]``. Frozen
    steps change nothing, so each chain ends where its own count takes it.
    (The reference's ``unroll`` only schedules its loop; the port has
    none.)"""

    def integrate(
        initial_state: IntegratorState,
        step_size,
        num_integration_steps,
        max_num_integration_steps=None,
    ):
        directed = direction * step_size
        state = initial_state
        if max_num_integration_steps is None and not torch.is_tensor(num_integration_steps):
            for _ in range(int(num_integration_steps)):
                state = integrator(state, directed)
            return state
        if max_num_integration_steps is None:
            max_num_integration_steps = int(num_integration_steps.max())
        num = torch.as_tensor(num_integration_steps, device=initial_state.position.device)
        for i in range(int(max_num_integration_steps)):
            state = tree_select(num > i, integrator(state, directed), state)
        return state

    return integrate


def static_progressive_integration(
    integrator: Callable,
    kinetic_energy: Callable,
    num_integration_steps,
    divergence_threshold: float,
) -> Callable:
    """``integrate(rng_key, initial_state, step_size) -> (proposal,
    is_diverging)``: integrate a fixed-length trajectory while
    reservoir-sampling one state in proportion to ``exp(-H)`` (reference
    ``trajectory.py:268``). Step ``i`` accepts with a uniform of
    ``fold_in(key, i)``, per chain, as the reference draws it; ``rng_key``
    may also be a ``torch.Generator``, which draws one uniform a chain a
    step. The step count is an int or one per chain ``(C,)``; a chain past
    its count is frozen, as the reference's loop under ``vmap`` leaves it."""
    energy_fn = hmc_energy(kinetic_energy)
    _, generate_proposal = proposal_generator(energy_fn)

    def integrate(rng_key, initial_state: IntegratorState, step_size):
        initial_energy = energy_fn(initial_state)
        held = Proposal(
            initial_state, initial_energy, torch.zeros_like(initial_energy),
            torch.full_like(initial_energy, -torch.inf),
        )
        state = initial_state
        any_divergent = torch.zeros_like(initial_energy, dtype=torch.bool)
        per_chain = torch.is_tensor(num_integration_steps)
        trips = int(num_integration_steps.max()) if per_chain else int(num_integration_steps)
        for i in range(trips):
            new_state = integrator(state, step_size)
            new_proposal = generate_proposal(initial_energy, new_state)
            diverged = any_divergent | (-new_proposal.weight > divergence_threshold)
            if isinstance(rng_key, torch.Generator):
                uniform = torch.rand(
                    initial_energy.shape, generator=rng_key, dtype=initial_energy.dtype,
                    device=initial_energy.device,
                )
            else:
                uniform = prng.uniform(prng.fold_in(rng_key, i), (), initial_energy.dtype)
            sampled = progressive_uniform_sampling(uniform, held, new_proposal)
            if per_chain:
                going = num_integration_steps.to(initial_energy.device) > i
                state, held, any_divergent = tree_select(
                    going, (new_state, sampled, diverged), (state, held, any_divergent))
            else:
                state, held, any_divergent = new_state, sampled, diverged
        return held, any_divergent

    return integrate


# ------------------------------------------------------------------------
# Dynamic (NUTS) trajectories: the reference-structured nested engine
# ------------------------------------------------------------------------


class DynamicIntegrationState(NamedTuple):
    step: torch.Tensor
    proposal: Proposal
    trajectory: Trajectory
    termination_state: NamedTuple


class DynamicExpansionState(NamedTuple):
    step: torch.Tensor
    proposal: Proposal
    trajectory: Trajectory
    termination_state: NamedTuple


def _batch_flags(like: torch.Tensor):
    """``(False, False)`` per chain of ``like``'s batch."""
    flag = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
    return flag, flag


def dynamic_progressive_integration(
    integrator: Callable,
    kinetic_energy: Callable,
    update_termination_state: Callable,
    is_criterion_met: Callable,
    divergence_threshold: float,
):
    """Integrate in one direction, progressively sampling a proposal, until
    the subtree's termination criterion fires, a leaf diverges or
    ``max_num_steps`` leaves are done (reference ``trajectory.py:320``).

    ``integrate(rng_key, initial_state, direction, termination_state,
    max_num_steps, step_size, initial_energy)`` takes per-chain keys
    ``(..., 2)``, directions and step limits; a chain with ``max_num_steps
    = 0`` is left as it is."""
    energy_fn = hmc_energy(kinetic_energy)
    _, generate_proposal = proposal_generator(energy_fn)

    def integrate(
        rng_key,
        initial_state: IntegratorState,
        direction,
        termination_state,
        max_num_steps,
        step_size,
        initial_energy,
    ):
        dtype = initial_energy.dtype
        proposal = generate_proposal(initial_energy, initial_state)
        zero = torch.zeros_like(initial_energy, dtype=torch.int64)
        state = DynamicIntegrationState(
            zero, proposal, Trajectory(initial_state, initial_state, initial_state.momentum, zero),
            termination_state,
        )
        is_diverging, has_terminated = _batch_flags(initial_energy)
        while True:
            going = (state.step < max_num_steps) & ~has_terminated & ~is_diverging
            if not bool(going.any()):
                break
            step, held, traj, term = state
            u_leaf = prng.uniform(prng.fold_in(rng_key, step), dtype=dtype)

            new_state = integrator(traj.rightmost_state, direction * step_size)
            new_proposal = generate_proposal(initial_energy, new_state)
            leaf_diverging = -new_proposal.weight > divergence_threshold

            is_first = step == 0
            fresh = Trajectory(new_state, new_state, new_state.momentum, torch.ones_like(step))
            new_traj = tree_select(is_first, fresh, append_to_trajectory(traj, new_state))
            sampled = tree_select(
                is_first, new_proposal, progressive_uniform_sampling(u_leaf, held, new_proposal)
            )
            term = update_termination_state(term, new_traj.momentum_sum, new_state.momentum, step)
            terminated = is_criterion_met(term, new_traj.momentum_sum, new_state.momentum)

            new = DynamicIntegrationState(step + 1, sampled, new_traj, term)
            state = tree_select(going, new, state)
            is_diverging = torch.where(going, leaf_diverging, is_diverging)
            has_terminated = torch.where(going, terminated, has_terminated)

        _, proposal, traj, termination_state = state
        # the loop always extends "rightwards"; flip the ends where the
        # chain integrated backwards in time
        flipped = Trajectory(
            traj.rightmost_state, traj.leftmost_state, traj.momentum_sum, traj.num_states
        )
        new_trajectory = tree_select(direction > 0, traj, flipped)
        return proposal, new_trajectory, termination_state, is_diverging, has_terminated

    return integrate


def dynamic_multiplicative_expansion(
    trajectory_integrator: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int = 10,
    rate: int = 2,
) -> Callable:
    """NUTS outer loop: double the trajectory in a random direction,
    biased-merge the new subtree's proposal, and stop on divergence or
    (sub)trajectory U-turn (reference ``trajectory.py:404``).

    ``expand(rng_key, initial_expansion_state, initial_energy, step_size)
    -> (expansion_state, (is_diverging, is_turning))``, per chain."""

    def expand(
        rng_key,
        initial_expansion_state: DynamicExpansionState,
        initial_energy,
        step_size,
    ):
        dtype = initial_energy.dtype
        state = initial_expansion_state
        is_diverging, is_turning = _batch_flags(initial_energy)
        while True:
            going = (state.step < max_num_expansions) & ~is_diverging & ~is_turning
            if not bool(going.any()):
                break
            step, proposal, trajectory, termination_state = state

            direction_key, trajectory_key, proposal_key = prng.split(
                prng.fold_in(rng_key, step), 3
            ).unbind(-2)
            u_dir, u_prop = prng.uniform(torch.stack((direction_key, proposal_key)), dtype=dtype)
            one = torch.ones_like(u_dir)
            direction = torch.where(u_dir < 0.5, one, -one)  # bernoulli(direction_key)
            start_state = tree_select(
                direction > 0, trajectory.rightmost_state, trajectory.leftmost_state
            )
            max_steps = torch.where(going, rate**step, torch.zeros_like(step))
            (
                new_proposal,
                new_trajectory,
                new_termination_state,
                sub_diverging,
                sub_turning,
            ) = trajectory_integrator(
                trajectory_key,
                start_state,
                direction,
                termination_state,
                max_steps,
                step_size,
                initial_energy,
            )

            # a diverging or turning subtree cannot contribute its proposal,
            # but its acceptance statistics still count toward the sum
            rejected_subtree = sub_diverging | sub_turning
            slpa_only = Proposal(
                proposal.state,
                proposal.energy,
                proposal.weight,
                torch.logaddexp(proposal.sum_log_p_accept, new_proposal.sum_log_p_accept),
            )
            sampled = progressive_biased_sampling(u_prop, proposal, new_proposal)
            updated_proposal = tree_select(rejected_subtree, slpa_only, sampled)

            left, right = reorder_trajectories(direction, trajectory, new_trajectory)
            merged = merge_trajectories(left, right)
            turning = uturn_check_fn(
                merged.leftmost_state.momentum,
                merged.rightmost_state.momentum,
                merged.momentum_sum,
            )
            new = DynamicExpansionState(step + 1, updated_proposal, merged, new_termination_state)
            state = tree_select(going, new, state)
            is_diverging = torch.where(going, sub_diverging, is_diverging)
            is_turning = torch.where(going, sub_turning | turning, is_turning)
        return state, (is_diverging, is_turning)

    return expand


def dynamic_recursive_integration(
    integrator: Callable,
    kinetic_energy: Callable,
    uturn_check_fn: Callable,
    divergence_threshold: float,
):
    """Textbook recursive NUTS tree building with multinomial sampling, on
    one chain ``(d,)`` and one key ``(2,)``: Python recursion, the
    validation oracle of the iterative engines (reference
    ``trajectory.py:491``).

    ``buildtree(rng_key, state, direction, depth, step_size,
    initial_energy) -> (left, right, momentum_sum, proposal, diverging,
    turning)``, the flags as Python bools."""
    energy_fn = hmc_energy(kinetic_energy)
    _, generate_proposal = proposal_generator(energy_fn)

    def buildtree(rng_key, state, direction, depth, step_size, initial_energy):
        if depth == 0:
            new_state = integrator(state, direction * step_size)
            new_proposal = generate_proposal(initial_energy, new_state)
            is_diverging = bool(-new_proposal.weight > divergence_threshold)
            return new_state, new_state, new_state.momentum, new_proposal, is_diverging, False

        key_first, key_second, key_choice = prng.split(rng_key, 3).unbind(-2)
        left, right, msum, prop, diverging, turning = buildtree(
            key_first, state, direction, depth - 1, step_size, initial_energy
        )
        if diverging or turning:
            return left, right, msum, prop, diverging, turning
        start = right if direction > 0 else left
        left2, right2, msum2, prop2, diverging2, turning2 = buildtree(
            key_second, start, direction, depth - 1, step_size, initial_energy
        )
        if direction > 0:
            left_all, right_all = left, right2
        else:
            left_all, right_all = left2, right
        total_sum = msum + msum2
        u = prng.uniform(key_choice, dtype=initial_energy.dtype)
        merged = progressive_uniform_sampling(u, prop, prop2)
        turning_all = bool(uturn_check_fn(left_all.momentum, right_all.momentum, total_sum))
        return left_all, right_all, total_sum, merged, diverging2, turning2 | turning_all

    return buildtree


# ------------------------------------------------------------------------
# Flattened NUTS: one loop over leaves
# ------------------------------------------------------------------------


class _FlatNUTSState(NamedTuple):
    """Per-chain registers of the flattened NUTS loop (all select-updated),
    with the transition's key ``(..., 2)`` and initial energy, which the
    continuous runner swaps at transition boundaries."""

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
    rng_key: torch.Tensor
    initial_energy: torch.Tensor


def leaf_draws(rng_key, depth, leaf, dtype):
    """The three uniforms of a leaf, per chain: ``(u_dir, u_leaf, u_prop)``
    from the direction key, ``fold_in(trajectory_key, leaf)`` and the
    proposal key of ``split(fold_in(rng_key, depth), 3)``, each
    ``uniform(key) < p`` being the reference's ``bernoulli(key, p)``. Four
    threefry calls for the whole batch."""
    direction_key, trajectory_key, proposal_key = prng.split(
        prng.fold_in(rng_key, depth), 3
    ).unbind(-2)
    leaf_key = prng.fold_in(trajectory_key, leaf)
    return prng.uniform(torch.stack((direction_key, leaf_key, proposal_key)), dtype=dtype).unbind(0)


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

    Returns ``propose(rng_key, initial_state, step_size) -> (state,
    info_tuple)`` with per-chain keys ``(..., 2)`` and ``info_tuple =
    (proposal, left, right, momentum_sum, num_states, depth_reached,
    is_diverging, is_turning)``.
    """
    machine_init, leaf_body = _flat_nuts_parts(
        integrator,
        kinetic_energy,
        uturn_check_fn,
        max_num_expansions,
        divergence_threshold,
        batched_uturn_check_fn,
    )

    def propose(rng_key, initial_state: IntegratorState, step_size):
        s = machine_init(rng_key, initial_state)
        any_done = False
        while True:
            new = leaf_body(s, step_size)
            # chains that finished before this leaf keep their state
            s = tree_select(s.done, s, new) if any_done else new
            # one host read a leaf: whether all chains are done, and any
            all_done, any_done = torch.stack((s.done.all(), s.done.any())).tolist()
            if all_done:
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


def flattened_nuts_machine(
    integrator: Callable,
    kinetic_energy: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    batched_uturn_check_fn: Callable = None,
) -> tuple:
    """The flattened engine as a resumable per-leaf machine (reference
    ``trajectory.py:651``): ``(machine_init, machine_leaf)``.

    - ``machine_init(rng_key, integrator_state)`` starts a transition (the
      momentum already drawn);
    - ``machine_leaf(state, step_size, draws=None)`` advances every chain
      one leaf, done or not (the caller masks what it reads on ``done``);
      ``draws`` are the leaf's uniforms, :func:`leaf_draws` of the state's
      keys when None.

    ``state.done`` flags the transition's end; ``state.proposal.state`` is
    then the next chain state.
    """
    return _flat_nuts_parts(
        integrator,
        kinetic_energy,
        uturn_check_fn,
        max_num_expansions,
        divergence_threshold,
        batched_uturn_check_fn,
    )


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

    def machine_init(rng_key, initial_state: IntegratorState) -> _FlatNUTSState:
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
            rng_key=rng_key.to(m0.device),
            initial_energy=initial_energy,
        )

    def leaf_body(s: _FlatNUTSState, step_size, draws=None) -> _FlatNUTSState:
        if draws is None:
            draws = leaf_draws(s.rng_key, s.depth, s.leaf, s.initial_energy.dtype)
        u_dir, u_leaf, u_prop = draws

        # -------- subtree start: pick direction, reset registers -----
        at_start = s.leaf == 0
        one = torch.ones_like(s.direction)
        new_dir = torch.where(u_dir < 0.5, one, -one)  # bernoulli(direction_key)
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
            subtree_turning = _slot_turning(
                uturn_check_fn, ckpt_momentum, ckpt_momentum_sum, sub_momentum_sum, m_new,
                idx_min, idx_max,
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
        left = tree_select(closing & ~forward, new_state, s.left)
        right = tree_select(closing & forward, new_state, s.right)

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

        return _FlatNUTSState(
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
            rng_key=s.rng_key,
            initial_energy=s.initial_energy,
        )

    return machine_init, leaf_body
