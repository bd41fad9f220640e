"""Static inner-kernel tuning from MCMC transition info (reference
``blackjax_tpu/smc/tuning/from_kernel_info.py``)."""
import torch

__all__ = ["update_scale_from_acceptance_rate"]


def update_scale_from_acceptance_rate(
    scales: torch.Tensor,
    acceptance_rates: torch.Tensor,
    target_acceptance_rate: float = 0.234,
) -> torch.Tensor:
    """Per-chain multiplicative scale update toward the target acceptance
    rate, shrunk halfway to the population mean to share information across
    chains."""
    updated = torch.exp(torch.log(scales) + acceptance_rates - target_acceptance_rate)
    return 0.5 * (updated + updated.mean())
