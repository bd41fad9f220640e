"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version, and the registered-target registry. Sources are in
``blackjax_tpu_torch/csrc`` and are built with ``nvcc`` at first use (see
:mod:`blackjax_tpu_torch.ops._nvcc`); each kernel module counts its launches
in its own ``LAUNCHES``.

The names here are the reference's (``blackjax_tpu/ops/__init__.py``). The
other kernels' entry points stay in their modules, as in the reference:
``ops.fused_mclmc.fused_mclmc``, ``ops.fused_nuts.fused_nuts_run`` and
``ops.fused_nuts_dc.fused_nuts_run_dc``. ``ops.fused_hmc`` and
``ops.fused_leapfrog`` name a class and a function here, so their modules
are reached with ``importlib.import_module``.
"""
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

__all__ = [
    "TargetKernel",
    "FusedHMCInfo",
    "FusedHMCState",
    "fused_hmc",
    "fused_leapfrog",
    "get_registered_target",
    "make_gaussian_target",
    "make_hierarchical_gaussian_target",
    "make_logistic_regression_target",
    "register_target",
]
