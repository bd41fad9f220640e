"""Optimizers ported so far."""
from blackjax_tpu_torch.optimizers import dual_averaging, optax_twins

__all__ = ["dual_averaging", "optax_twins"]
