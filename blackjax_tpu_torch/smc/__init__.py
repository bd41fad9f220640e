"""Sequential Monte Carlo family, grouped by role (reference
``blackjax_tpu/smc/__init__.py``)."""
# The core step and its ingredients
from blackjax_tpu_torch.smc import base as base
from blackjax_tpu_torch.smc import ess as ess
from blackjax_tpu_torch.smc import from_mcmc as from_mcmc
from blackjax_tpu_torch.smc import resampling as resampling
from blackjax_tpu_torch.smc import solver as solver

# Annealing paths
from blackjax_tpu_torch.smc import adaptive_tempered as adaptive_tempered
from blackjax_tpu_torch.smc import partial_posteriors_path as partial_posteriors_path
from blackjax_tpu_torch.smc import tempered as tempered

# Persistent-particle variants
from blackjax_tpu_torch.smc import adaptive_persistent_sampling as adaptive_persistent_sampling
from blackjax_tpu_torch.smc import persistent_sampling as persistent_sampling

# Mutation-kernel tuning and recycling
from blackjax_tpu_torch.smc import inner_kernel_tuning as inner_kernel_tuning
from blackjax_tpu_torch.smc import pretuning as pretuning
from blackjax_tpu_torch.smc import tuning as tuning
from blackjax_tpu_torch.smc import waste_free as waste_free

from blackjax_tpu_torch.smc.base import extend_params as extend_params

__all__ = [name for name in dir() if not name.startswith("_")]
