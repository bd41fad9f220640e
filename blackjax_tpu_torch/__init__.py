"""blackjax_tpu_torch: the PyTorch and CUDA port of blackjax_tpu.

The port mirrors the reference's module paths and public names. Every
module here imports ``torch`` and never JAX; the kernels that were Pallas
kernels for the TPU are hand-written CUDA kernels for Hopper
(``csrc/fused_nuts_dc.cu``, the in-kernel NUTS machine of
``ops.fused_nuts_dc.fused_nuts_run_dc``, with the threefry export that
:mod:`blackjax_tpu_torch.prng` draws through; ``csrc/fused_nuts.cu``, the
older machine of ``ops.fused_nuts.fused_nuts_run``;
``csrc/fused_leapfrog.cu``, the trajectory of ``fused_hmc`` and, on the
analytic targets, its whole transition;
``csrc/fused_mclmc.cu``, the trajectory of ``ops.fused_mclmc.fused_mclmc``;
``csrc/vpu_peak.cu``, the FP32 roofline of ``ops.vpu_peak``;
the matrix targets' device functions they share are in
``csrc/matrix_targets.cuh``). Kernels follow ``(key, state) -> (state,
info)`` with a leading chain axis on every state tensor; the key is key
words (one ``jax.random`` key per chain) or a ``torch.Generator``.

Registry subset so far (every name is the reference's): the MCMC samplers
``hmc``, ``mhmc`` (``multinomial_hmc``), ``dhmc`` (``dynamic_hmc``),
``dmhmc``, ``nuts``, ``ghmc``, ``mala``, ``barker`` (``barker_proposal``),
``rmh``, ``irmh``, ``additive_step_random_walk``, ``normal_random_walk``,
``mclmc``, ``adjusted_mclmc``, ``adjusted_mclmc_dynamic``,
``elliptical_slice``, ``slice_sampling``, ``coordinate_slice``,
``orbital_hmc``, ``mgrad_gaussian``, ``gist_step_size``,
``gist_trajectory_length``, ``fused_hmc`` and ``hmc_family``; the
stochastic-gradient samplers ``sgld``, ``sghmc``, ``sgnht`` and ``csgld``;
``tempered_smc``, ``adaptive_tempered_smc``, ``inner_kernel_tuning``,
``partial_posteriors_smc``, ``window_adaptation``,
``window_adaptation_low_rank``, ``staged_adaptation``,
``mclmc_find_L_and_step_size``, ``dual_averaging_adaptation``,
``dual_averaging``, ``diagnostics`` (with ``ess``, ``ess_bulk``,
``ess_tail``, ``pareto_khat`` and ``rhat``) and ``util``.
"""
import dataclasses
import functools
import importlib
from typing import Callable

from blackjax_tpu_torch import diagnostics, util
from blackjax_tpu_torch.adaptation.low_rank_adaptation import window_adaptation_low_rank
from blackjax_tpu_torch.adaptation.mclmc_adaptation import mclmc_find_L_and_step_size
from blackjax_tpu_torch.adaptation.staged_adaptation import staged_adaptation
from blackjax_tpu_torch.adaptation.step_size import dual_averaging_adaptation
from blackjax_tpu_torch.adaptation.window_adaptation import window_adaptation
from blackjax_tpu_torch.base import (
    AdaptationAlgorithm,
    SamplingAlgorithm,
    build_sampling_algorithm,
)
from blackjax_tpu_torch.diagnostics import effective_sample_size as ess
from blackjax_tpu_torch.diagnostics import ess_bulk, ess_tail, pareto_khat, rhat
from blackjax_tpu_torch.mcmc import adjusted_mclmc as _adjusted_mclmc
from blackjax_tpu_torch.mcmc import adjusted_mclmc_dynamic as _adjusted_mclmc_dynamic
from blackjax_tpu_torch.mcmc import barker as _barker
from blackjax_tpu_torch.mcmc import dynamic_hmc as _dynamic_hmc
from blackjax_tpu_torch.mcmc import elliptical_slice as _elliptical_slice
from blackjax_tpu_torch.mcmc import ghmc as _ghmc
from blackjax_tpu_torch.mcmc import gist_step_size as _gist_step_size
from blackjax_tpu_torch.mcmc import gist_trajectory_length as _gist_trajectory_length
from blackjax_tpu_torch.mcmc import hmc as _hmc
from blackjax_tpu_torch.mcmc import mala as _mala
from blackjax_tpu_torch.mcmc import marginal_latent_gaussian as _marginal_latent_gaussian
from blackjax_tpu_torch.mcmc import mclmc as _mclmc
from blackjax_tpu_torch.mcmc import nuts as _nuts
from blackjax_tpu_torch.mcmc import periodic_orbital as _periodic_orbital
from blackjax_tpu_torch.mcmc import random_walk
from blackjax_tpu_torch.mcmc import slice as _slice
from blackjax_tpu_torch.optimizers import dual_averaging
from blackjax_tpu_torch.sgmcmc import csgld as _csgld
from blackjax_tpu_torch.sgmcmc import sghmc as _sghmc
from blackjax_tpu_torch.sgmcmc import sgld as _sgld
from blackjax_tpu_torch.sgmcmc import sgnht as _sgnht
from blackjax_tpu_torch.smc import adaptive_tempered as _adaptive_tempered
from blackjax_tpu_torch.smc import inner_kernel_tuning as _inner_kernel_tuning
from blackjax_tpu_torch.smc import partial_posteriors_path as _partial_posteriors_smc
from blackjax_tpu_torch.smc import tempered as _tempered

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


hmc = generate_top_level_api_from(_hmc)
nuts = generate_top_level_api_from(_nuts)
mala = generate_top_level_api_from(_mala)
ghmc = generate_top_level_api_from(_ghmc)
mclmc = generate_top_level_api_from(_mclmc)
adjusted_mclmc = generate_top_level_api_from(_adjusted_mclmc)
adjusted_mclmc_dynamic = generate_top_level_api_from(_adjusted_mclmc_dynamic)
dhmc = generate_top_level_api_from(_dynamic_hmc)
dynamic_hmc = dhmc

rmh = GenerateSamplingAPI(random_walk.rmh_as_top_level_api, random_walk.init, random_walk.build_rmh)
irmh = GenerateSamplingAPI(
    random_walk.irmh_as_top_level_api, random_walk.init, random_walk.build_irmh
)
additive_step_random_walk = GenerateSamplingAPI(
    random_walk.additive_step_random_walk, random_walk.init, random_walk.build_additive_step
)
additive_step_random_walk.register_factory("normal_random_walk", random_walk.normal_random_walk)
normal_random_walk = random_walk.normal_random_walk

mhmc = GenerateSamplingAPI(
    functools.partial(_hmc.as_top_level_api, build_proposal=_hmc.multinomial_hmc_proposal),
    _hmc.init,
    functools.partial(_hmc.build_kernel, build_proposal=_hmc.multinomial_hmc_proposal),
)
multinomial_hmc = mhmc
dmhmc = GenerateSamplingAPI(
    functools.partial(
        _dynamic_hmc.as_top_level_api, build_proposal=_hmc.multinomial_hmc_proposal
    ),
    _dynamic_hmc.init,
    functools.partial(_dynamic_hmc.build_kernel, build_proposal=_hmc.multinomial_hmc_proposal),
)

hmc_family = [hmc, nuts, mhmc]

barker = generate_top_level_api_from(_barker)
barker_proposal = barker
elliptical_slice = generate_top_level_api_from(_elliptical_slice)
slice_sampling = generate_top_level_api_from(_slice)
coordinate_slice = GenerateSamplingAPI(
    _slice.coordinate_slice, _slice.init, _slice.build_coordinate_kernel
)
orbital_hmc = generate_top_level_api_from(_periodic_orbital)
mgrad_gaussian = generate_top_level_api_from(_marginal_latent_gaussian)
gist_step_size = generate_top_level_api_from(_gist_step_size)
gist_trajectory_length = generate_top_level_api_from(_gist_trajectory_length)

sgld = generate_top_level_api_from(_sgld)
sghmc = generate_top_level_api_from(_sghmc)
sgnht = generate_top_level_api_from(_sgnht)
csgld = generate_top_level_api_from(_csgld)

tempered_smc = generate_top_level_api_from(_tempered)
adaptive_tempered_smc = generate_top_level_api_from(_adaptive_tempered)
inner_kernel_tuning = generate_top_level_api_from(_inner_kernel_tuning)
partial_posteriors_smc = generate_top_level_api_from(_partial_posteriors_smc)

# the class `ops.fused_hmc` shadows its module's name in `ops`, so the
# module is resolved through importlib (as in the reference)
fused_hmc = generate_top_level_api_from(
    importlib.import_module("blackjax_tpu_torch.ops.fused_hmc")
)

__all__ = [
    "__version__",
    "hmc",
    "mhmc",
    "multinomial_hmc",
    "dhmc",
    "dynamic_hmc",
    "dmhmc",
    "nuts",
    "ghmc",
    "mclmc",
    "adjusted_mclmc",
    "adjusted_mclmc_dynamic",
    "mala",
    "barker",
    "barker_proposal",
    "rmh",
    "irmh",
    "additive_step_random_walk",
    "normal_random_walk",
    "elliptical_slice",
    "slice_sampling",
    "coordinate_slice",
    "orbital_hmc",
    "mgrad_gaussian",
    "gist_step_size",
    "gist_trajectory_length",
    "hmc_family",
    "fused_hmc",
    "sgld",
    "sghmc",
    "sgnht",
    "csgld",
    "tempered_smc",
    "adaptive_tempered_smc",
    "inner_kernel_tuning",
    "partial_posteriors_smc",
    "window_adaptation",
    "window_adaptation_low_rank",
    "staged_adaptation",
    "mclmc_find_L_and_step_size",
    "dual_averaging_adaptation",
    "dual_averaging",
    "diagnostics",
    "util",
    "ess",
    "ess_bulk",
    "ess_tail",
    "pareto_khat",
    "rhat",
    "AdaptationAlgorithm",
    "SamplingAlgorithm",
    "build_sampling_algorithm",
]
