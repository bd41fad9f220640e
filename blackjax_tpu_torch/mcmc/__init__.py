"""MCMC mechanics and samplers ported so far."""
from blackjax_tpu_torch.mcmc import adjusted_mclmc as adjusted_mclmc
from blackjax_tpu_torch.mcmc import adjusted_mclmc_dynamic as adjusted_mclmc_dynamic
from blackjax_tpu_torch.mcmc import barker as barker
from blackjax_tpu_torch.mcmc import diffusions as diffusions
from blackjax_tpu_torch.mcmc import dynamic_hmc as dynamic_hmc
from blackjax_tpu_torch.mcmc import elliptical_slice as elliptical_slice
from blackjax_tpu_torch.mcmc import ghmc as ghmc
from blackjax_tpu_torch.mcmc import gist as gist
from blackjax_tpu_torch.mcmc import gist_step_size as gist_step_size
from blackjax_tpu_torch.mcmc import gist_trajectory_length as gist_trajectory_length
from blackjax_tpu_torch.mcmc import hmc as hmc
from blackjax_tpu_torch.mcmc import integrators as integrators
from blackjax_tpu_torch.mcmc import mala as mala
from blackjax_tpu_torch.mcmc import marginal_latent_gaussian as marginal_latent_gaussian
from blackjax_tpu_torch.mcmc import mclmc as mclmc
from blackjax_tpu_torch.mcmc import metrics as metrics
from blackjax_tpu_torch.mcmc import nuts as nuts
from blackjax_tpu_torch.mcmc import periodic_orbital as periodic_orbital
from blackjax_tpu_torch.mcmc import proposal as proposal
from blackjax_tpu_torch.mcmc import random_walk as random_walk
from blackjax_tpu_torch.mcmc import slice as slice  # noqa: A004
from blackjax_tpu_torch.mcmc import termination as termination
from blackjax_tpu_torch.mcmc import trajectory as trajectory

__all__ = [name for name in dir() if not name.startswith("_")]
