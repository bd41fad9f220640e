"""Optimizers ported so far."""
from blackjax_tpu_torch.optimizers import dual_averaging, lbfgs, optax_twins

__all__ = ["dual_averaging", "lbfgs", "optax_twins"]
