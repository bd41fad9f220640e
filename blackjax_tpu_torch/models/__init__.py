from blackjax_tpu_torch.models.targets import (
    Target,
    eight_schools_noncentered,
    finnish_horseshoe,
    hierarchical_gaussian,
    ill_conditioned_gaussian,
    logistic_regression,
    standard_normal,
)

__all__ = [
    "Target",
    "eight_schools_noncentered",
    "finnish_horseshoe",
    "hierarchical_gaussian",
    "ill_conditioned_gaussian",
    "logistic_regression",
    "standard_normal",
]
