"""Optimizers ported so far."""
from blackjax_tpu_torch.optimizers import dual_averaging

__all__ = ["dual_averaging"]
