"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the registered-target registry. Sources are in
``blackjax_tpu_torch/csrc`` and are built with ``nvcc`` at first use (see
:mod:`blackjax_tpu_torch.ops._nvcc`); each kernel module counts its launches
in its own ``LAUNCHES``."""
from blackjax_tpu_torch.ops.fused_hmc import FusedHMCInfo, FusedHMCState, fused_hmc
from blackjax_tpu_torch.ops.fused_leapfrog import (
    TargetKernel,
    fused_leapfrog,
    get_registered_target,
    make_gaussian_target,
    make_hierarchical_gaussian_target,
    make_logistic_regression_target,
    register_target,
)
from blackjax_tpu_torch.ops.fused_mclmc import fused_mclmc
from blackjax_tpu_torch.ops.fused_nuts_dc import (
    TargetKernelDC,
    fused_nuts_run_dc,
    make_gaussian_target_dc,
    make_hierarchical_target_dc,
)

__all__ = [
    "TargetKernel",
    "TargetKernelDC",
    "FusedHMCInfo",
    "FusedHMCState",
    "fused_hmc",
    "fused_leapfrog",
    "fused_mclmc",
    "fused_nuts_run_dc",
    "get_registered_target",
    "make_gaussian_target",
    "make_gaussian_target_dc",
    "make_hierarchical_gaussian_target",
    "make_hierarchical_target_dc",
    "make_logistic_regression_target",
    "register_target",
]
