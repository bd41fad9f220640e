"""Slice sampling (Neal 2003): univariate slices along random directions
(hit-and-run) or coordinate sweeps (slice within Gibbs), with the
stepping-out or the doubling interval and shrinkage (reference
``blackjax_tpu/mcmc/slice.py``).

One transition moves every chain of a ``(C, d)`` block. The reference's
``while_loop`` s (stepping out, the doubling's acceptance test, shrinkage)
run per chain under ``vmap``; here each runs until every chain is done, a
finished chain frozen by masks, and reads whether any chain goes on to the
host once an iteration. A chain's draws come from its own keys and depend
on no other chain's trip count, so ``num_expansions`` and ``num_shrink``
are each chain's own. The doubling's whole ladder of brackets is evaluated
in one batched call, as in the reference. Randomness is a key per chain (a
``torch.Generator`` draws one key a chain first); uniforms are drawn in
the state's dtype, the counterpart of JAX's default float.

``slice_fn(t) -> (state, is_valid)`` takes ``t`` with one value a chain,
or ``(C, L)`` values (the doubling's ladder), and returns the states at
those points with their log densities shaped like ``t``.
"""
from typing import Callable, NamedTuple, Union

import torch

from blackjax_tpu_torch import prng
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.types import Array, ArrayLikeTree, ArrayTree, PRNGKey
from blackjax_tpu_torch.util import chain_keys, generate_gaussian_noise, require_tensor_position

__all__ = [
    "SliceState",
    "SliceInfo",
    "init",
    "stepping_out",
    "doubling",
    "build_kernel",
    "build_coordinate_kernel",
    "as_top_level_api",
    "coordinate_slice",
    "direction_proposal",
    "sample_direction",
    "random_order",
    "fixed_order",
]


class SliceState(NamedTuple):
    position: ArrayTree
    logdensity: ArrayTree


class SliceInfo(NamedTuple):
    """Transition diagnostics; brackets are in the slice coordinate ``t``,
    the current point at ``t = 0``."""

    is_accepted: Array
    num_expansions: Array
    num_shrink: Array
    bracket_left: ArrayTree
    bracket_right: ArrayTree


def init(position: ArrayLikeTree, logdensity_fn: Callable) -> SliceState:
    require_tensor_position(position, "slice sampling")
    return SliceState(position, logdensity_fn(position))


def _expand(x: Array, like: Array) -> Array:
    """``x`` with trailing unit axes up to ``like``'s rank."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def stepping_out(rng_key: PRNGKey, in_slice: Callable, width: Array, max_expansions: int):
    """Neal's Fig. 3: a bracket of ``width`` placed uniformly around ``t =
    0``, each end pushed out while it stays in the slice, the expansion
    budget split at random between the sides. ``width`` is a tensor in the
    state's dtype (one a chain, or shared). Returns ``(left, right,
    num_expansions, accept_fn)``."""
    u_key, budget_key = prng.split(rng_key).unbind(-2)
    left = -width * prng.uniform(u_key, (), width.dtype)
    right = left + width
    j = torch.floor(max_expansions * prng.uniform(budget_key, (), width.dtype)).to(torch.int64)
    k = (max_expansions - 1) - j

    def expand(end, budget, direction):
        going = in_slice(end) & (budget > 0)
        while bool(going.any()):
            end = torch.where(going, end + direction * width, end)
            budget = torch.where(going, budget - 1, budget)
            going = in_slice(end) & (budget > 0)
        return end, budget

    left, j_left = expand(left, j, -1.0)
    right, k_right = expand(right, k, 1.0)
    num_expansions = (j - j_left) + (k - k_right)
    return left, right, num_expansions, lambda t: torch.ones_like(t, dtype=torch.bool)


def _best_interval(both_out: Array) -> Array:
    """Index of the first level at which both ends left the slice (else the
    last level), over the last axis."""
    k = both_out.shape[-1]
    priority = torch.arange(2 * k, k, -1, dtype=both_out.dtype, device=both_out.device)
    tiebreak = torch.arange(k, dtype=both_out.dtype, device=both_out.device)
    return torch.argmax(priority * both_out + tiebreak, dim=-1)


def doubling(rng_key: PRNGKey, in_slice: Callable, width: Array, max_expansions: int):
    """Neal's Fig. 4 doubling on the whole ladder at once: every doubled
    bracket (a random side each level) tested in one batched call, the
    first level with both ends outside the slice chosen. Returns Neal's Fig.
    6 test as the acceptance function (reversibility needs it)."""
    dtype = width.dtype
    place_key, side_key = prng.split(rng_key).unbind(-2)
    initial_left = -width * prng.uniform(place_key, (), dtype)
    initial_right = initial_left + width
    levels = max_expansions + 1
    grow_left = prng.uniform(side_key, (levels,), dtype) < 0.5  # bernoulli(side_key, 0.5)
    grow_right = 1 - grow_left.to(torch.int64)
    powers = 2.0 ** torch.arange(levels, dtype=dtype, device=width.device)
    step_widths = width[..., None] * powers
    zero = torch.zeros(grow_left.shape[:-1] + (1,), dtype=dtype, device=width.device)
    # exclusive cumulative growth: level j holds doublings 0..j-1
    left_growth = torch.cat((zero, prng.xla_cumsum(step_widths * grow_left)[..., :-1]), -1)
    right_growth = torch.cat((zero, prng.xla_cumsum(step_widths * grow_right)[..., :-1]), -1)
    lefts = initial_left[..., None] - left_growth
    rights = initial_right[..., None] + right_growth
    both_out = ~in_slice(lefts) & ~in_slice(rights)
    idx = _best_interval(both_out.to(torch.int64))
    left = torch.gather(lefts, -1, idx[..., None])[..., 0]
    right = torch.gather(rights, -1, idx[..., None])[..., 0]

    def accept_fn(t):
        return _doubling_accept(in_slice, t, left, right, width)

    return left, right, idx, accept_fn


def _doubling_accept(in_slice: Callable, t, left, right, width):
    """Neal's Fig. 6: bisect the bracket toward ``t``; reject where a
    doubling from ``t`` would have stopped earlier. Per chain, the
    bisection loop masked as it ends."""
    lo, hi = left, right
    crossed = torch.zeros_like(t, dtype=torch.bool)
    ok = torch.ones_like(t, dtype=torch.bool)
    going = (hi - lo > 1.1 * width) & ok
    while bool(going.any()):
        mid = 0.5 * (lo + hi)
        # t and the origin in different halves: the two sequences part
        crossed_new = crossed | torch.logical_xor(t < mid, 0.0 < mid)
        lo_new = torch.where(t < mid, lo, mid)
        hi_new = torch.where(t < mid, mid, hi)
        dead_bracket = ~in_slice(lo_new) & ~in_slice(hi_new)
        lo, hi, crossed, ok = tree_select(
            going, (lo_new, hi_new, crossed_new, ~(crossed_new & dead_bracket)),
            (lo, hi, crossed, ok))
        going = (hi - lo > 1.1 * width) & ok
    return ok


def _shrink(rng_key, slice_fn, level, accept_fn, left, right, current_state, max_shrinkage):
    """Neal's Fig. 5 shrinkage within ``max_shrinkage`` tries; a chain that
    exhausts them stays put. The accepted candidate's state is threaded
    out."""
    lo, hi, key = left, right, rng_key
    tries = torch.zeros(left.shape, dtype=torch.int64, device=left.device)
    state = current_state
    found = torch.zeros_like(left, dtype=torch.bool)
    going = ~found & (tries < max_shrinkage)
    while bool(going.any()):
        key_new, draw_key = prng.split(key).unbind(-2)
        t = lo + prng.uniform(draw_key, (), lo.dtype) * (hi - lo)
        candidate, is_valid = slice_fn(t)
        found_new = (candidate.logdensity >= level) & is_valid & accept_fn(t)
        # a failed draw pulls its side of the bracket in toward t = 0
        below = t < 0.0
        lo, hi, key, found = tree_select(
            going, (torch.where(below, t, lo), torch.where(below, hi, t), key_new, found_new),
            (lo, hi, key, found))
        state = tree_select(going & found_new, candidate, state)
        tries = tries + going
        going = ~found & (tries < max_shrinkage)
    return state, tries, found


def _univariate_slice(
    rng_key, slice_fn, current_state, width, interval, max_expansions, max_shrinkage
):
    logdensity = current_state.logdensity
    dtype, device = logdensity.dtype, logdensity.device
    width = torch.as_tensor(width, dtype=dtype, device=device)
    level_key, interval_key, shrink_key = prng.split(rng_key, 3).unbind(-2)
    level = logdensity + torch.log(prng.uniform(level_key, (), dtype))

    def in_slice(t):
        candidate, is_valid = slice_fn(t)
        return (candidate.logdensity >= _expand(level, t)) & is_valid

    left, right, num_expansions, accept_fn = interval(
        interval_key, in_slice, width, max_expansions
    )
    new_state, num_shrink, is_accepted = _shrink(
        shrink_key, slice_fn, level, accept_fn, left, right, current_state, max_shrinkage
    )
    return new_state, SliceInfo(is_accepted, num_expansions, num_shrink, left, right)


def build_kernel(
    interval: Callable = doubling,
    max_expansions: int = 10,
    max_shrinkage: int = 100,
) -> Callable:
    """The hyperplane slice kernel: one univariate slice through the
    proposal generator's ``slice_fn``."""

    def kernel(
        rng_key: PRNGKey,
        state: SliceState,
        logdensity_fn: Callable,
        proposal_generator: Callable,
        width: float = 1.0,
    ) -> tuple[SliceState, SliceInfo]:
        keys = chain_keys(rng_key, state.position)
        prop_key, slice_key = prng.split(keys).unbind(-2)
        slice_fn = proposal_generator(prop_key, state.position, logdensity_fn)
        return _univariate_slice(
            slice_key, slice_fn, state, width, interval, max_expansions, max_shrinkage
        )

    return kernel


def random_order(rng_key: PRNGKey, d: int) -> Array:
    """A random permutation of the ``d`` coordinates per key."""
    return prng.permutation_indices(rng_key, d)


def fixed_order(rng_key: PRNGKey, d: int) -> Array:
    return torch.arange(d, device=rng_key.device)


def _along(position: Array, t: Array, direction: Array) -> Array:
    """``position + t direction`` per chain, for ``t`` of one value a chain or
    ``(C, L)``: the points ``(C, d)`` or ``(C, L, d)``."""
    extra = t.dim() - (position.dim() - 1)
    p = position.reshape(position.shape[:-1] + (1,) * extra + position.shape[-1:])
    u = direction.reshape(direction.shape[:-1] + (1,) * extra + direction.shape[-1:])
    return p + t[..., None] * u


def coordinate_proposal(
    rng_key: PRNGKey, position: ArrayLikeTree, logdensity_fn: Callable, i
) -> Callable:
    """A unit step along axis ``i`` (one a chain): ``x[i] + t``, every other
    coordinate as it is."""
    del rng_key
    i = torch.as_tensor(i, device=position.device)
    axis = (torch.arange(position.shape[-1], device=position.device) == i[..., None])
    axis = axis.to(position.dtype)

    def slice_fn(t):
        x = _along(position, t, axis)
        return SliceState(x, logdensity_fn(x)), True

    return slice_fn


def build_coordinate_kernel(
    interval: Callable = doubling,
    axis_proposal: Callable = coordinate_proposal,
    coordinate_order: Callable = random_order,
    initial_widths: Union[float, Array] = 1.0,
    max_expansions: int = 10,
    max_shrinkage: int = 100,
) -> Callable:
    """Slice within Gibbs: one univariate slice a coordinate, in the order
    ``coordinate_order`` gives (each chain its own)."""

    def kernel(rng_key: PRNGKey, state: SliceState, logdensity_fn: Callable):
        position = state.position
        d = position.shape[-1]
        widths = torch.broadcast_to(
            torch.as_tensor(initial_widths, dtype=position.dtype, device=position.device)
            .reshape(-1), (d,))
        keys = chain_keys(rng_key, position)
        order_key, scan_key = prng.split(keys).unbind(-2)
        order = coordinate_order(order_key, d).expand(position.shape[:-1] + (d,))
        sweep_keys = prng.split(scan_key, d)
        ordered_widths = widths[order]
        logdensity = state.logdensity
        swept = []
        for n in range(d):
            prop_key, slice_key = prng.split(sweep_keys[..., n, :]).unbind(-2)
            slice_fn = axis_proposal(prop_key, position, logdensity_fn, order[..., n])
            new_state, info = _univariate_slice(
                slice_key, slice_fn, SliceState(position, logdensity), ordered_widths[..., n],
                interval, max_expansions, max_shrinkage,
            )
            position, logdensity = new_state
            swept.append(info)

        def stitch(values):
            stacked = torch.stack(values, -1)
            return torch.zeros_like(stacked).scatter(-1, order, stacked)

        info = SliceInfo(
            is_accepted=torch.stack([s.is_accepted for s in swept], -1).all(-1),
            num_expansions=torch.stack([s.num_expansions for s in swept], -1).sum(-1),
            num_shrink=torch.stack([s.num_shrink for s in swept], -1).sum(-1),
            bracket_left=stitch([s.bracket_left for s in swept]),
            bracket_right=stitch([s.bracket_right for s in swept]),
        )
        return SliceState(position, logdensity), info

    return kernel


def sample_direction(rng_key: PRNGKey, position: ArrayLikeTree, scale=1.0) -> ArrayTree:
    """A unit direction per chain with covariance shape ``scale scale^T``."""
    noise = generate_gaussian_noise(rng_key, position, sigma=scale)
    return noise / torch.linalg.vector_norm(noise, dim=-1, keepdim=True)


def direction_proposal(scale=1.0) -> Callable:
    """Hit and run: slice along a random unit direction shaped by
    ``scale``."""

    def proposal_generator(rng_key, position, logdensity_fn):
        direction = sample_direction(rng_key, position, scale)

        def slice_fn(t):
            x = _along(position, t, direction)
            return SliceState(x, logdensity_fn(x)), True

        return slice_fn

    return proposal_generator


def as_top_level_api(
    logdensity_fn: Callable,
    *,
    proposal_generator: Callable = direction_proposal(),
    width: float = 1.0,
    interval: Callable = doubling,
    max_expansions: int = 10,
    max_shrinkage: int = 100,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.slice_sampling(...)``: hit-and-run slice."""
    kernel = build_kernel(interval, max_expansions, max_shrinkage)
    return build_sampling_algorithm(
        kernel, init, logdensity_fn, kernel_args=(proposal_generator, width)
    )


def coordinate_slice(
    logdensity_fn: Callable,
    *,
    max_expansions: int = 10,
    initial_widths: Union[float, Array] = 1.0,
    interval: Callable = doubling,
    coordinate_order: Callable = random_order,
    axis_proposal: Callable = coordinate_proposal,
    max_shrinkage: int = 100,
) -> SamplingAlgorithm:
    """``blackjax_tpu_torch.coordinate_slice(...)``: slice within Gibbs."""
    kernel = build_coordinate_kernel(
        interval=interval,
        axis_proposal=axis_proposal,
        coordinate_order=coordinate_order,
        initial_widths=initial_widths,
        max_expansions=max_expansions,
        max_shrinkage=max_shrinkage,
    )
    return build_sampling_algorithm(kernel, init, logdensity_fn)
