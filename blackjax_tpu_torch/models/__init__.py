from blackjax_tpu_torch.models.targets import (
    Target,
    eight_schools_noncentered,
    hierarchical_gaussian,
    ill_conditioned_gaussian,
    standard_normal,
)

__all__ = [
    "Target",
    "eight_schools_noncentered",
    "hierarchical_gaussian",
    "ill_conditioned_gaussian",
    "standard_normal",
]
