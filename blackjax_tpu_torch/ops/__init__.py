"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources are in ``blackjax_tpu_torch/csrc`` and are built with
``nvcc`` at first use (see :mod:`blackjax_tpu_torch.ops._nvcc`)."""
from blackjax_tpu_torch.ops.fused_nuts_dc import (
    LAUNCHES,
    TargetKernelDC,
    fused_nuts_run_dc,
    make_gaussian_target_dc,
    make_hierarchical_target_dc,
)

__all__ = [
    "LAUNCHES",
    "TargetKernelDC",
    "fused_nuts_run_dc",
    "make_gaussian_target_dc",
    "make_hierarchical_target_dc",
]
