"""Proposal bookkeeping for trajectory-building samplers (reference
``blackjax_tpu/mcmc/proposal.py``).

Accept/reject is a select over the state tuple, per chain. The random draw
of each accept is an explicit tensor of uniforms ``U[0, 1)`` shaped like
the acceptance probability: ``bernoulli(p)`` is ``uniform < p``, as
``jax.random.bernoulli`` computes it, so a caller that hands in the same
uniforms takes the same decisions as the reference.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.types import Array
from blackjax_tpu_torch.util import tree_map

__all__ = [
    "Proposal",
    "safe_energy_diff",
    "proposal_generator",
    "progressive_uniform_sampling",
    "progressive_biased_sampling",
    "compute_asymmetric_acceptance_ratio",
    "static_binomial_sampling",
    "nonreversible_slice_sampling",
    "tree_select",
]


def _where(pred, on_true, on_false):
    if not torch.is_tensor(pred):
        pred = torch.as_tensor(pred, device=on_true.device)
    if 0 < pred.dim() < on_true.dim():
        pred = pred.reshape(pred.shape + (1,) * (on_true.dim() - pred.dim()))
    return torch.where(pred, on_true, on_false)


def tree_select(pred, on_true, on_false):
    """Select per chain over a state tuple; ``pred`` is a bool or ``(C,)``
    and broadcasts over each leaf's trailing axes."""
    return tree_map(lambda a, b: _where(pred, a, b), on_true, on_false)


class Proposal(NamedTuple):
    """A candidate state plus the trajectory statistics of progressive
    sampling: the log total weight seen so far and the summed log MH
    acceptance statistic."""

    state: NamedTuple
    energy: Array
    weight: Array
    sum_log_p_accept: Array


def safe_energy_diff(initial_energy, new_energy):
    """``H0 - H1`` with NaN mapped to ``-inf``: a diverged state is never
    accepted."""
    delta = initial_energy - new_energy
    return torch.where(torch.isnan(delta), -torch.inf, delta)


def proposal_generator(energy_fn: Callable) -> tuple[Callable, Callable]:
    """``(new, update)``: seed a proposal at the trajectory start, and build
    the proposal of a freshly integrated state with weight ``H0 - H(z)``."""

    def new(state) -> Proposal:
        energy = energy_fn(state)
        return Proposal(
            state, energy, torch.zeros_like(energy), torch.full_like(energy, -torch.inf)
        )

    def update(initial_energy, new_state) -> Proposal:
        new_energy = energy_fn(new_state)
        delta = safe_energy_diff(initial_energy, new_energy)
        return Proposal(
            new_state, new_energy, delta, torch.minimum(delta, torch.zeros_like(delta))
        )

    return new, update


def _merged_stats(proposal: Proposal, new_proposal: Proposal):
    weight = torch.logaddexp(proposal.weight, new_proposal.weight)
    slpa = torch.logaddexp(proposal.sum_log_p_accept, new_proposal.sum_log_p_accept)
    return weight, slpa


def _accept(uniform, p_accept, proposal: Proposal, new_proposal: Proposal) -> Proposal:
    do_accept = uniform < p_accept
    weight, slpa = _merged_stats(proposal, new_proposal)
    chosen = tree_select(do_accept, new_proposal.state, proposal.state)
    energy = torch.where(do_accept, new_proposal.energy, proposal.energy)
    return Proposal(chosen, energy, weight, slpa)


def progressive_uniform_sampling(
    uniform: Array, proposal: Proposal, new_proposal: Proposal
) -> Proposal:
    """Reservoir-style multinomial sampling: the new state replaces the held
    one with probability ``w_new / (w_old + w_new)``."""
    p_accept = torch.sigmoid(new_proposal.weight - proposal.weight)
    return _accept(uniform, p_accept, proposal, new_proposal)


def progressive_biased_sampling(
    uniform: Array, proposal: Proposal, new_proposal: Proposal
) -> Proposal:
    """Betancourt's biased variant: accept with probability
    ``min(1, w_new / w_old)``, favouring the newer subtree."""
    p_accept = torch.clamp(torch.exp(new_proposal.weight - proposal.weight), max=1.0)
    return _accept(uniform, p_accept, proposal, new_proposal)


def compute_asymmetric_acceptance_ratio(transition_energy_fn: Callable) -> Callable:
    """Log acceptance ratio of an asymmetric proposal: forward minus
    reverse transition energies."""

    def log_acceptance_ratio(initial_state, state, **energy_params):
        forward = transition_energy_fn(initial_state, state, **energy_params)
        reverse = transition_energy_fn(state, initial_state, **energy_params)
        return safe_energy_diff(reverse, forward)

    return log_acceptance_ratio


def static_binomial_sampling(uniform: Array, log_p_accept, proposal, new_proposal):
    """Metropolis-Hastings accept/reject; returns
    ``(chosen, (do_accept, p_accept, None))``."""
    p_accept = torch.clamp(torch.exp(log_p_accept), max=1.0)
    do_accept = uniform < p_accept
    chosen = tree_select(do_accept, new_proposal, proposal)
    return chosen, (do_accept, p_accept, None)


def nonreversible_slice_sampling(slice_var: Array, delta_energy, proposal, new_proposal):
    """Neal's persistent-slice accept for non-reversible MH: accept when
    ``log|u| <= delta_energy`` and move the slice variable deterministically."""
    p_accept = torch.clamp(torch.exp(delta_energy), max=1.0)
    do_accept = torch.log(torch.abs(slice_var)) <= delta_energy
    next_slice = slice_var * torch.where(
        do_accept, torch.exp(-delta_energy), torch.ones_like(delta_energy)
    )
    chosen = tree_select(do_accept, new_proposal, proposal)
    return chosen, (do_accept, p_accept, next_slice)
