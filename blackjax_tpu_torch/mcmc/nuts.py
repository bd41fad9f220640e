"""No-U-Turn Sampler, iterative and multinomial (reference
``blackjax_tpu/mcmc/nuts.py``).

The kernel moves every chain of a ``(C, d)`` batch one transition on the
flattened engine (:func:`blackjax_tpu_torch.mcmc.trajectory.flattened_nuts`)
or, with ``engine="nested"``, on the reference-structured nested engine;
the two agree bit for bit. Its randomness is a key per chain
(:mod:`blackjax_tpu_torch.prng`), split into the momentum and integrator
keys as the reference splits it, so the port draws what the reference draws
from the same keys. A ``torch.Generator`` is taken too: the kernel then
draws the chains' key words from it, once per transition.

:func:`build_fused_many_steps` is the continuous runner: chains flow through
their transitions without a per-step barrier, bit for bit the samples of a
loop over the kernel with the same keys. The in-kernel machines are
:func:`blackjax_tpu_torch.ops.fused_nuts_dc.fused_nuts_run_dc` and
:func:`blackjax_tpu_torch.ops.fused_nuts.fused_nuts_run`.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc import hmc, integrators, metrics, termination, trajectory
from blackjax_tpu_torch.mcmc.proposal import Proposal, tree_select
from blackjax_tpu_torch.types import ArrayTree, PRNGKey
from blackjax_tpu_torch.util import tree_map

__all__ = [
    "NUTSInfo",
    "init",
    "build_kernel",
    "as_top_level_api",
    "build_fused_many_steps",
]


init = hmc.init


class NUTSInfo(NamedTuple):
    """Per-transition diagnostics, one entry per chain."""

    momentum: ArrayTree
    is_divergent: ArrayTree
    is_turning: ArrayTree
    energy: ArrayTree
    trajectory_leftmost_state: integrators.IntegratorState
    trajectory_rightmost_state: integrators.IntegratorState
    num_trajectory_expansions: ArrayTree
    num_integration_steps: ArrayTree
    acceptance_rate: ArrayTree


def _acceptance_rate(proposal, num_states):
    return torch.exp(proposal.sum_log_p_accept) / num_states.clamp(min=1)


def iterative_nuts_proposal(
    integrator: Callable,
    kinetic_energy: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000,
    *,
    engine: str = "flattened",
    batched_uturn_check_fn: Callable = None,
) -> Callable:
    """The NUTS proposal: trajectory doubling with multinomial progressive
    sampling and checkpointed U-turn termination (reference ``nuts.py:50``).
    ``propose(rng_key, initial_state, step_size)`` takes per-chain keys
    ``(..., 2)``."""
    if engine == "flattened":
        flat_propose = trajectory.flattened_nuts(
            integrator,
            kinetic_energy,
            uturn_check_fn,
            max_num_expansions,
            divergence_threshold,
            batched_uturn_check_fn=batched_uturn_check_fn,
        )

        def propose(rng_key, initial_state: integrators.IntegratorState, step_size):
            state, info = flat_propose(rng_key, initial_state, step_size)
            proposal, left, right, _, num_states, depth, is_diverging, is_turning = info
            return state, NUTSInfo(
                initial_state.momentum,
                is_diverging,
                is_turning,
                proposal.energy,
                left,
                right,
                depth,
                num_states,
                _acceptance_rate(proposal, num_states),
            )

        return propose

    if engine != "nested":
        raise ValueError(f"Unknown NUTS engine {engine!r}; use 'flattened' or 'nested'.")

    new_termination_state, update_termination_state, is_criterion_met = (
        termination.iterative_uturn(uturn_check_fn)
    )
    trajectory_integrator = trajectory.dynamic_progressive_integration(
        integrator,
        kinetic_energy,
        update_termination_state,
        is_criterion_met,
        divergence_threshold,
    )
    expand = trajectory.dynamic_multiplicative_expansion(
        trajectory_integrator, uturn_check_fn, max_num_expansions
    )
    energy_fn = trajectory.hmc_energy(kinetic_energy)

    def propose(rng_key, initial_state: integrators.IntegratorState, step_size):
        initial_termination_state = new_termination_state(initial_state, max_num_expansions)
        initial_energy = energy_fn(initial_state)
        zero = torch.zeros_like(initial_energy, dtype=torch.int64)
        initial_proposal = Proposal(
            initial_state,
            initial_energy,
            torch.zeros_like(initial_energy),
            torch.full_like(initial_energy, -torch.inf),
        )
        initial_trajectory = trajectory.Trajectory(
            initial_state, initial_state, initial_state.momentum, zero
        )
        initial_expansion_state = trajectory.DynamicExpansionState(
            zero, initial_proposal, initial_trajectory, initial_termination_state
        )
        expansion_state, (is_diverging, is_turning) = expand(
            rng_key.to(initial_energy.device), initial_expansion_state, initial_energy,
            step_size,
        )
        num_doublings, sampled_proposal, new_trajectory, _ = expansion_state
        info = NUTSInfo(
            initial_state.momentum,
            is_diverging,
            is_turning,
            sampled_proposal.energy,
            new_trajectory.leftmost_state,
            new_trajectory.rightmost_state,
            num_doublings,
            new_trajectory.num_states,
            _acceptance_rate(sampled_proposal, new_trajectory.num_states),
        )
        return sampled_proposal.state, info

    return propose


def _chain_keys(rng_key: PRNGKey, position) -> torch.Tensor:
    """Key words ``(..., 2)`` for the chains of ``position``: the caller's,
    or drawn from a generator (one key per chain, once per transition)."""
    if isinstance(rng_key, torch.Generator):
        return prng.from_generator(rng_key, position.shape[:-1], position.device)
    return rng_key.to(position.device)


def build_kernel(
    integrator: Callable = integrators.velocity_verlet,
    divergence_threshold: int = 1000,
    *,
    engine: str = "flattened",
    batched_uturn: bool = False,
):
    """Build the NUTS kernel (reference ``nuts.py:164``). ``engine`` picks
    the flattened loop (default) or the nested reference-structured loop;
    ``batched_uturn=True`` takes the metric's distributive-matvec slot check
    instead of the per-slot loop (flattened engine only)."""

    def kernel(
        rng_key: PRNGKey,
        state: hmc.HMCState,
        logdensity_fn: Callable,
        step_size: float,
        inverse_mass_matrix,
        max_num_doublings: int = 10,
    ) -> tuple[hmc.HMCState, NUTSInfo]:
        metric = metrics.default_metric(inverse_mass_matrix)
        symplectic_integrator = integrator(logdensity_fn, metric.kinetic_energy)
        proposal_generator = iterative_nuts_proposal(
            symplectic_integrator,
            metric.kinetic_energy,
            metric.check_turning,
            max_num_doublings,
            divergence_threshold,
            engine=engine,
            batched_uturn_check_fn=(
                metric.check_turning_batched if batched_uturn else None
            ),
        )
        position, logdensity, logdensity_grad = state
        key_momentum, key_integrator = prng.split(_chain_keys(rng_key, position)).unbind(-2)
        momentum = metric.sample_momentum(key_momentum, position)
        integrator_state = integrators.IntegratorState(
            position, momentum, logdensity, logdensity_grad
        )
        proposal, info = proposal_generator(key_integrator, integrator_state, step_size)
        return (
            hmc.HMCState(proposal.position, proposal.logdensity, proposal.logdensity_grad),
            info,
        )

    return kernel


def as_top_level_api(
    logdensity_fn: Callable,
    step_size: float,
    inverse_mass_matrix,
    *,
    max_num_doublings: int = 10,
    divergence_threshold: int = 1000,
    integrator: Callable = integrators.velocity_verlet,
    engine: str = "flattened",
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.nuts(...)`` (reference ``nuts.py:216``)."""
    kernel = build_kernel(integrator, divergence_threshold, engine=engine)
    metric = metrics.default_metric(inverse_mass_matrix)
    return build_sampling_algorithm(
        kernel,
        init,
        logdensity_fn,
        kernel_args=(step_size, metric, max_num_doublings),
    )


def _rows(pred, x):
    """``pred (C,)`` shaped to select the rows of ``x``."""
    return pred.reshape(pred.shape + (1,) * (x.dim() - 1))


def _select_machine(pred, fresh, machines):
    """Per-chain select of two machine states, passing the machine's
    checkpoint buffers through: a slot is never read before the same
    subtree wrote it, so stale slots from the previous transition are
    harmless (reference ``nuts.py:669-679``)."""
    slim_fresh = fresh._replace(ckpt_momentum=(), ckpt_momentum_sum=())
    slim_mach = machines._replace(ckpt_momentum=(), ckpt_momentum_sum=())
    merged = tree_select(pred, slim_fresh, slim_mach)
    return merged._replace(
        ckpt_momentum=machines.ckpt_momentum,
        ckpt_momentum_sum=machines.ckpt_momentum_sum,
    )


def build_fused_many_steps(
    logdensity_fn: Callable,
    step_size: float,
    inverse_mass_matrix,
    *,
    num_steps: int,
    max_num_doublings: int = 10,
    divergence_threshold: int = 1000,
    integrator: Callable = integrators.velocity_verlet,
    track_fn: Callable = None,
    window_size: int = None,
    oversubscription: int = 1,
    unroll: int = 1,
    restart_every: int = 1,
):
    """Continuous many-transition NUTS runner (reference ``nuts.py:237``):
    chains flow through their transitions without a per-step barrier.

    A loop over the kernel makes every chain wait for the slowest chain's
    trajectory at every step. Here one loop advances every unfinished chain
    one leaf per iteration through
    :func:`trajectory.flattened_nuts_machine`; a chain that completes a
    transition starts its next one at once. The samples are bit for bit
    those of a loop over :func:`build_kernel` with the same keys:
    ``rng_keys`` is ``(num_steps, num_chains, 2)``, the key of each (step,
    chain), derived per transition as the kernel derives it.

    Parameters
    ----------
    track_fn
        ``IntegratorState batch -> (C, k)`` values recorded per transition
        (default: the position). History is ``(num_chains, num_steps, k)``.
    window_size
        Chains pause before starting a transition more than ``window_size``
        steps ahead of the slowest chain (default: no pausing).
    oversubscription
        ``m > 1`` runs the chains through ``num_chains / m`` slots, each
        draining ``m`` chains one after the other (slot ``s`` owns chains
        ``s, s + P, ...``). Requires ``num_chains % m == 0``.
    unroll
        Leaves per block: the loop's exit (any chain unfinished) is read on
        the host once per block, at most ``unroll - 1`` masked leaves past
        the end.
    restart_every
        Restarts run only on the leaves of a block whose index in it is a
        multiple of this (``1 <= restart_every <= unroll``); a closed chain
        parks until then. The oversubscribed runner restarts on every leaf,
        as the reference's does.

    Returns
    -------
    ``run(rng_keys, init_states) -> (final_states, history, total_grads)``:
    ``init_states`` an :class:`hmc.HMCState` batch, ``final_states`` the
    ``IntegratorState`` batch after each chain's last transition,
    ``total_grads`` the integration steps over all chains (an int64 tensor).
    The loop condition is the only host sync, once per block.
    """
    metric = metrics.default_metric(inverse_mass_matrix)
    symplectic_integrator = integrator(logdensity_fn, metric.kinetic_energy)
    machine_init, machine_leaf = trajectory.flattened_nuts_machine(
        symplectic_integrator,
        metric.kinetic_energy,
        metric.check_turning,
        max_num_doublings,
        divergence_threshold,
    )
    if track_fn is None:
        track_fn = lambda state: state.position  # noqa: E731
    if oversubscription < 1:
        raise ValueError(f"oversubscription must be >= 1, got {oversubscription}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    if restart_every < 1 or restart_every > unroll:
        raise ValueError(
            f"restart_every must be in [1, unroll={unroll}], got {restart_every}"
        )

    def start_transition_from(step_keys, position, logdensity, logdensity_grad):
        key_momentum, key_integrator = prng.split(step_keys).unbind(-2)
        momentum = metric.sample_momentum(key_momentum, position)
        return machine_init(
            key_integrator,
            integrators.IntegratorState(position, momentum, logdensity, logdensity_grad),
        )

    def run_blocks(body, carry, unfinished):
        """Blocks of ``unroll`` leaves while ``unfinished(carry)``, read on
        the host once per block."""
        while bool(unfinished(carry)):
            for i in range(unroll):
                carry = body(carry, i % restart_every == 0)
        return carry

    def run(rng_keys, init_states):
        num_chains = init_states.position.shape[0]
        S = num_steps
        dev = init_states.position.device
        rng_keys = rng_keys.to(dev)
        chains = torch.arange(num_chains, device=dev)
        machines = start_transition_from(rng_keys[0], *init_states)
        last0 = machines.proposal.state
        k = track_fn(last0).shape[-1]
        hist0 = torch.zeros(num_chains, S, k, dtype=last0.position.dtype, device=dev)
        steps0 = torch.zeros(num_chains, dtype=torch.int64, device=dev)
        grads0 = torch.zeros((), dtype=torch.int64, device=dev)
        running0 = torch.ones(num_chains, dtype=torch.bool, device=dev)
        offset0 = torch.zeros((), dtype=torch.int64, device=dev)
        W = S if window_size is None else min(window_size, S)

        def body(carry, do_restart):
            machines, steps, running, offset, last_state, hist, grads = carry
            active = steps < S

            # every machine advances one leaf; paused and finished chains
            # evolve garbage, and every consumer below is masked on
            # `closed`, the chain state coming from `last_state`
            machines = machine_leaf(machines, step_size)
            closed = machines.done & running
            out_state = machines.proposal.state
            vals = track_fn(out_state).to(hist.dtype)
            # the closing transition's row, inside the sliding window
            row = steps.clamp(max=S - 1)
            write = closed & (steps - offset >= 0) & (steps - offset < W)
            hist[chains, row] = torch.where(write[:, None], vals, hist[chains, row])
            grads = grads + torch.where(closed, machines.num_states, 0).sum()
            last_state = tree_select(closed, out_state, last_state)

            next_steps = steps + closed.to(steps.dtype)
            running = running & ~closed
            # the window only moves forward; keep it inside the buffer
            new_offset = torch.where(next_steps < S, next_steps, S).min().clamp(max=S - W)
            offset = torch.maximum(offset, new_offset)

            if do_restart:
                # restart any parked chain whose next transition still
                # writes inside the window, from the state captured at close
                restart = active & ~running & (next_steps < S) & (next_steps - offset < W)
                next_keys = rng_keys[next_steps.clamp(max=S - 1), chains]
                fresh = start_transition_from(
                    next_keys, last_state.position, last_state.logdensity,
                    last_state.logdensity_grad,
                )
                machines = _select_machine(restart, fresh, machines)
                running = running | restart
            return machines, next_steps, running, offset, last_state, hist, grads

        carry = (machines, steps0, running0, offset0, last0, hist0, grads0)
        carry = run_blocks(body, carry, lambda c: (c[1] < S).any())
        _, _, _, _, last_state, hist, grads = carry
        return last_state, hist, grads

    def run_oversubscribed(rng_keys, init_states):
        """Slot-major: P = C / m slots, slot s drains chains s, s + P, ...
        with a cursor g in [0, m S): chain s + (g // S) P at step g % S.
        History and finals live slot-major and are unpermuted at the end."""
        m = oversubscription
        num_chains = init_states.position.shape[0]
        if num_chains % m:
            raise ValueError(f"oversubscription={m} must divide num_chains ({num_chains})")
        P = num_chains // m
        S = num_steps
        T = m * S
        W = S if window_size is None else min(window_size, S)
        dev = init_states.position.device
        rng_keys = rng_keys.to(dev)
        slots = torch.arange(P, device=dev)

        slot_init = tree_map(lambda x: x[:P], init_states)
        machines = start_transition_from(rng_keys[0, :P], *slot_init)
        last0 = machines.proposal.state
        k = track_fn(last0).shape[-1]
        hist0 = torch.zeros(T, P, k, dtype=last0.position.dtype, device=dev)
        finals0 = tree_map(lambda x: x.new_zeros((m,) + x.shape), last0)
        cursor0 = torch.zeros(P, dtype=torch.int64, device=dev)
        grads0 = torch.zeros((), dtype=torch.int64, device=dev)
        running0 = torch.ones(P, dtype=torch.bool, device=dev)
        offset0 = torch.zeros((), dtype=torch.int64, device=dev)

        def body(carry, do_restart):
            del do_restart  # every leaf restarts, as in the reference
            machines, cursor, running, offset, last_state, hist, finals, grads = carry
            active = cursor < T

            machines = machine_leaf(machines, step_size)
            closed = machines.done & running
            out_state = machines.proposal.state
            vals = track_fn(out_state).to(hist.dtype)

            # history: row `cursor` of each closing slot, inside the window
            row = cursor.clamp(max=T - 1)
            write = closed & (cursor - offset >= 0) & (cursor - offset < W)
            hist[row, slots] = torch.where(write[:, None], vals, hist[row, slots])

            # finals: a chain completes when its last transition closes
            finishing = closed & (cursor % S == S - 1)
            j = (cursor // S).clamp(max=m - 1)

            def write_final(buf, val):
                buf[j, slots] = torch.where(_rows(finishing, val), val, buf[j, slots])
                return buf

            finals = tree_map(write_final, finals, out_state)
            grads = grads + torch.where(closed, machines.num_states, 0).sum()
            last_state = tree_select(closed, out_state, last_state)

            next_cursor = cursor + closed.to(cursor.dtype)
            running = running & ~closed
            new_offset = torch.where(next_cursor < T, next_cursor, T).min().clamp(max=T - W)
            offset = torch.maximum(offset, new_offset)

            restart = active & ~running & (next_cursor < T) & (next_cursor - offset < W)
            t_next = (next_cursor % S).clamp(max=S - 1)
            chain_next = (slots + (next_cursor // S) * P).clamp(0, num_chains - 1)
            next_keys = rng_keys[t_next, chain_next]
            # a cursor crossing a chain boundary restarts from that chain's
            # initial state; otherwise from the state captured at close
            new_chain = next_cursor % S == 0
            base = [
                tree_select(new_chain, init[chain_next], last)
                for init, last in zip(init_states, (last_state.position, last_state.logdensity,
                                                    last_state.logdensity_grad))
            ]
            fresh = start_transition_from(next_keys, *base)
            machines = _select_machine(restart, fresh, machines)
            running = running | restart
            return machines, next_cursor, running, offset, last_state, hist, finals, grads

        carry = (machines, cursor0, running0, offset0, last0, hist0, finals0, grads0)
        carry = run_blocks(body, carry, lambda c: (c[1] < T).any())
        hist, finals, grads = carry[5], carry[6], carry[7]
        # cursor-major (T, P, k) -> chain-major (C, S, k): cursor j S + t of
        # slot s belongs to chain j P + s at step t
        hist_chains = (
            hist.reshape(m, S, P, k).permute(0, 2, 1, 3).reshape(num_chains, S, k)
        )
        final_states = tree_map(lambda x: x.reshape((num_chains,) + x.shape[2:]), finals)
        return final_states, hist_chains, grads

    return run_oversubscribed if oversubscription > 1 else run
