"""Stochastic-gradient MCMC (reference ``blackjax_tpu/sgmcmc``): minibatch
gradient estimators, the Euler solvers of the diffusions, and SGLD, SGHMC,
SGNHT and contour SGLD."""
from blackjax_tpu_torch.sgmcmc import csgld, diffusions, gradients, sghmc, sgld, sgnht

__all__ = ["csgld", "diffusions", "gradients", "sghmc", "sgld", "sgnht"]
