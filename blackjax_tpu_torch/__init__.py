"""blackjax_tpu_torch: the PyTorch and CUDA port of blackjax_tpu.

The port mirrors the reference's module paths and public names. Every
module here imports ``torch`` and never JAX; the in-kernel NUTS machine is a
hand-written CUDA kernel for Hopper (``csrc/fused_nuts_dc.cu``). Kernels
follow ``(generator, state) -> (state, info)`` with a leading chain axis
on every state tensor.

Registry subset of this slice: ``nuts``, ``fused_nuts_run_dc``,
``diagnostics`` (with ``ess`` and ``rhat``) and ``util``.
"""
import dataclasses
from typing import Callable

from blackjax_tpu_torch import diagnostics, util
from blackjax_tpu_torch.base import SamplingAlgorithm, build_sampling_algorithm
from blackjax_tpu_torch.diagnostics import effective_sample_size as ess
from blackjax_tpu_torch.diagnostics import ess_bulk, rhat
from blackjax_tpu_torch.mcmc import nuts as _nuts
from blackjax_tpu_torch.ops.fused_nuts_dc import fused_nuts_run_dc

__version__ = "0.1.0"


@dataclasses.dataclass
class GenerateSamplingAPI:
    """Callable wrapper exposing an algorithm module's full surface
    (reference ``blackjax_tpu/__init__.py:101``)."""

    differentiable: Callable
    init: Callable
    build_kernel: Callable

    def __call__(self, *args, **kwargs) -> SamplingAlgorithm:
        return self.differentiable(*args, **kwargs)

    def register_factory(self, name, callable):
        setattr(self, name, callable)


def generate_top_level_api_from(module) -> GenerateSamplingAPI:
    return GenerateSamplingAPI(module.as_top_level_api, module.init, module.build_kernel)


nuts = generate_top_level_api_from(_nuts)

__all__ = [
    "__version__",
    "nuts",
    "fused_nuts_run_dc",
    "diagnostics",
    "util",
    "ess",
    "ess_bulk",
    "rhat",
    "SamplingAlgorithm",
    "build_sampling_algorithm",
]
