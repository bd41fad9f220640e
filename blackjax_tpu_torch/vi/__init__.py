"""Variational inference (reference ``blackjax_tpu/vi``): the Gaussian
families, Pathfinder and multi-path Pathfinder, SVGD and the
Schrödinger-Föllmer sampler."""
from blackjax_tpu_torch.vi import (
    fullrank_vi,
    meanfield_vi,
    multipathfinder,
    pathfinder,
    schrodinger_follmer,
    svgd,
)

__all__ = [
    "fullrank_vi",
    "meanfield_vi",
    "multipathfinder",
    "pathfinder",
    "schrodinger_follmer",
    "svgd",
]
