"""Stein Variational Gradient Descent (Liu & Wang 2016); reference
``blackjax_tpu/vi/svgd.py``.

The particles are a ``(n, d)`` tensor, and ``grad_logdensity_fn`` maps them
to their ``(n, d)`` gradients (the port's batch convention); a kernel takes
two ``(d,)`` points and returns a scalar. The functional gradient at a target
``x`` is the mean over the sources ``p`` of ``-(k(p, x) grad logpi(p)) -
grad_p k(p, x)``, the ascent direction negated for the optimizer (one of
:mod:`blackjax_tpu_torch.optimizers.optax_twins`).

- :func:`rbf_kernel` takes its closed form: ``K`` from the pairwise squared
  distances (``|x_i|^2 + |x_j|^2 - 2 x_i . x_j``, clamped at 0, which moves
  ``K`` by about ``eps |x|^2 / l``), then ``(-(K^T G) + (2 / l) (K^T X - X *
  colsum K)) / n``, two ``(n, n) x (n, d)`` products.
- Any other kernel: per-pair gradients by ``torch.func.vmap`` of ``grad``
  over the sources and the targets, the targets in chunks so that a chunk's
  ``(targets, n, d)`` stays bounded, the mean over the sources.
- :func:`median_heuristic` takes the distances below the diagonal from
  explicit differences (rows in chunks, ``jnp.tril_indices``'s order) and
  ``jnp.median``'s midpoint of the two middle values of their sort.
"""
import math
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.base import SamplingAlgorithm
from blackjax_tpu_torch.optimizers.optax_twins import apply_updates
from blackjax_tpu_torch.types import ArrayTree
from blackjax_tpu_torch.util import require_tensor_position

__all__ = [
    "SVGDState",
    "init",
    "build_kernel",
    "as_top_level_api",
    "rbf_kernel",
    "update_median_heuristic",
    "median_heuristic",
]

# the elements of one chunk of explicit differences: (rows, columns, d) for the
# median, (targets, sources, d) for a kernel's per-pair gradients
_DISTANCE_CHUNK = 1 << 27
_PAIR_CHUNK = 1 << 24


class SVGDState(NamedTuple):
    particles: ArrayTree
    kernel_parameters: dict
    opt_state: object


def init(initial_particles: ArrayTree, kernel_parameters: dict, optimizer) -> SVGDState:
    require_tensor_position(initial_particles, "svgd")
    return SVGDState(initial_particles, kernel_parameters, optimizer.init(initial_particles))


def _rbf_functional_gradient(particles, gradient, length_scale):
    """The RBF kernel's functional gradient in closed form, with ``K_ij =
    exp(-|x_i - x_j|^2 / l)`` and ``grad_{x_i} K_ij = -(2 / l) K_ij (x_i -
    x_j)``."""
    n = particles.shape[0]
    norms = torch.square(particles).sum(-1)
    squared = (norms[:, None] + norms[None, :] - 2.0 * particles @ particles.T).clamp_min(0.0)
    K = torch.exp(-squared / length_scale)
    kernel_weighted = K.T @ gradient
    repulsion = K.T @ particles - particles * K.sum(0)[:, None]
    return (-kernel_weighted + (2.0 / length_scale) * repulsion) / n


def _pairwise_functional_gradient(particles, gradient, kernel, kernel_parameters):
    """Any kernel's functional gradient from its per-pair values and
    gradients with respect to the source."""

    def value_and_grad(source, target):
        return torch.func.grad_and_value(lambda s: kernel(s, target, **kernel_parameters))(source)

    per_target = torch.func.vmap(torch.func.vmap(value_and_grad, in_dims=(0, None)),
                                 in_dims=(None, 0))
    n, d = particles.shape
    chunk = max(1, _PAIR_CHUNK // (n * d))
    out = []
    for a in range(0, n, chunk):
        k_grad, k_val = per_target(particles, particles[a:a + chunk])  # (c, n, d), (c, n)
        out.append((-(k_val[..., None] * gradient) - k_grad).mean(1))
    return torch.cat(out)


def build_kernel(optimizer):
    """One SVGD step: the particles move along the kernelised Stein
    functional gradient ``phi*(x) = E_p[k(p, x) grad logpi(p) + grad_p k(p,
    x)]``."""

    def kernel(state: SVGDState, grad_logdensity_fn: Callable, kernel: Callable,
               **grad_params) -> SVGDState:
        particles, kernel_params, opt_state = state
        gradient = grad_logdensity_fn(particles, **grad_params)
        if kernel is rbf_kernel:
            functional_gradient = _rbf_functional_gradient(
                particles, gradient, kernel_params.get("length_scale", 1))
        else:
            functional_gradient = _pairwise_functional_gradient(particles, gradient, kernel,
                                                                kernel_params)
        updates, opt_state = optimizer.update(functional_gradient, opt_state, particles)
        return SVGDState(apply_updates(particles, updates), kernel_params, opt_state)

    return kernel


def rbf_kernel(x, y, length_scale=1):
    return torch.exp(-torch.square(x - y).sum(-1) / length_scale)


def _below_diagonal_distances(particles):
    """The distances ``|x_i - x_j|`` for ``i > j``, row by row, from explicit
    differences."""
    n, d = particles.shape
    rows, cols = torch.tril_indices(n, n, -1, device=particles.device)
    per_chunk = max(1, _DISTANCE_CHUNK // (n * d))
    out = []
    for a in range(1, n, per_chunk):
        b = min(n, a + per_chunk)
        distances = torch.linalg.vector_norm(particles[a:b, None, :] - particles[None, :b, :],
                                             dim=-1)
        first, last = a * (a - 1) // 2, b * (b - 1) // 2
        out.append(distances[rows[first:last] - a, cols[first:last]])
    return torch.cat(out)


def median_heuristic(kernel_parameters, particles):
    """``length_scale = median(pairwise distance)^2 / log n``."""
    n = particles.shape[0]
    below = torch.sort(_below_diagonal_distances(particles)).values
    m = below.numel()
    median = (below[(m - 1) // 2] + below[m // 2]) * 0.5
    return {**kernel_parameters, "length_scale": median**2 / math.log(n)}


update_median_heuristic = median_heuristic


def as_top_level_api(
    grad_logdensity_fn: Callable,
    optimizer,
    kernel: Callable = rbf_kernel,
    update_kernel_parameters: Callable = median_heuristic,
):
    """``blackjax_tpu_torch.svgd(...)``: a ``SamplingAlgorithm`` whose step
    also refreshes the kernel parameters (the median heuristic by
    default)."""
    kernel_fn = build_kernel(optimizer)

    def init_fn(initial_particles: ArrayTree, kernel_parameters: dict = {"length_scale": 1.0}):
        return init(initial_particles, kernel_parameters, optimizer)

    def step_fn(state: SVGDState, **grad_params) -> SVGDState:
        state = SVGDState(
            state.particles,
            update_kernel_parameters(state.kernel_parameters, state.particles),
            state.opt_state,
        )
        return kernel_fn(state, grad_logdensity_fn, kernel, **grad_params)

    return SamplingAlgorithm(init_fn, step_fn)
