"""MCMC mechanics and samplers ported so far."""
from blackjax_tpu_torch.mcmc import diffusions as diffusions
from blackjax_tpu_torch.mcmc import hmc as hmc
from blackjax_tpu_torch.mcmc import integrators as integrators
from blackjax_tpu_torch.mcmc import mala as mala
from blackjax_tpu_torch.mcmc import mclmc as mclmc
from blackjax_tpu_torch.mcmc import metrics as metrics
from blackjax_tpu_torch.mcmc import nuts as nuts
from blackjax_tpu_torch.mcmc import proposal as proposal
from blackjax_tpu_torch.mcmc import termination as termination
from blackjax_tpu_torch.mcmc import trajectory as trajectory

__all__ = [name for name in dir() if not name.startswith("_")]
