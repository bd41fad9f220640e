"""Static inner-kernel tuning from the particle cloud (reference
``blackjax_tpu/smc/tuning/from_particles.py``)."""
import torch

from blackjax_tpu_torch.types import Array
from blackjax_tpu_torch.util import tree_leaves

__all__ = [
    "particles_means",
    "particles_stds",
    "particles_covariance_matrix",
    "inverse_mass_matrix_from_particles",
    "particles_as_rows",
]


def particles_as_rows(particles) -> Array:
    """Ravel each particle: (n_particles, total_dim) matrix."""
    leaves = tree_leaves(particles)
    return torch.cat([leaf.reshape(leaf.shape[0], -1) for leaf in leaves], dim=1)


def particles_means(particles) -> Array:
    return particles_as_rows(particles).mean(0)


def particles_stds(particles) -> Array:
    return particles_as_rows(particles).std(0, correction=0)


def particles_covariance_matrix(particles) -> Array:
    return torch.cov(particles_as_rows(particles).T, correction=0)


def inverse_mass_matrix_from_particles(particles) -> Array:
    """Diagonal IMM from the particle variances (Buchholz et al. 2018 §3.1)."""
    return torch.diag(particles_as_rows(particles).var(0, correction=0))
