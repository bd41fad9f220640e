from blackjax_tpu_torch.smc.tuning import from_kernel_info, from_particles

__all__ = ["from_kernel_info", "from_particles"]
