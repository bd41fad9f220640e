"""Variational inference ported so far (reference ``blackjax_tpu/vi``):
Pathfinder and multi-path Pathfinder."""
from blackjax_tpu_torch.vi import multipathfinder, pathfinder

__all__ = ["multipathfinder", "pathfinder"]
