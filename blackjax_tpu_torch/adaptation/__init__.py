"""Warmup and adaptation engines ported so far."""
from blackjax_tpu_torch.adaptation import chees_adaptation as chees_adaptation
from blackjax_tpu_torch.adaptation import low_rank_adaptation as low_rank_adaptation
from blackjax_tpu_torch.adaptation import mass_matrix as mass_matrix
from blackjax_tpu_torch.adaptation import mclmc_adaptation as mclmc_adaptation
from blackjax_tpu_torch.adaptation import meads_adaptation as meads_adaptation
from blackjax_tpu_torch.adaptation import metric_buffers as metric_buffers
from blackjax_tpu_torch.adaptation import metric_estimators as metric_estimators
from blackjax_tpu_torch.adaptation import metric_recipes as metric_recipes
from blackjax_tpu_torch.adaptation import pathfinder_adaptation as pathfinder_adaptation
from blackjax_tpu_torch.adaptation import staged_adaptation as staged_adaptation
from blackjax_tpu_torch.adaptation import step_size as step_size
from blackjax_tpu_torch.adaptation import window_adaptation as window_adaptation
from blackjax_tpu_torch.adaptation.base import AdaptationInfo as AdaptationInfo
from blackjax_tpu_torch.adaptation.base import AdaptationResults as AdaptationResults

__all__ = [name for name in dir() if not name.startswith("_")]
