"""Stan-style window adaptation (reference
``blackjax_tpu/adaptation/window_adaptation.py``): a thin wrapper over the
staged engine with the Welford cores."""
from typing import Callable, Optional

import torch

from blackjax_tpu_torch.adaptation.base import return_all_adapt_info
from blackjax_tpu_torch.adaptation.mass_matrix import (
    MassMatrixAdaptationState,
    welford_algorithm,
)
from blackjax_tpu_torch.adaptation.staged_adaptation import (
    StagedAdaptationState,
    build_schedule,
    staged_adaptation,
)
from blackjax_tpu_torch.base import AdaptationAlgorithm
from blackjax_tpu_torch.types import Array

__all__ = ["window_adaptation", "WindowAdaptationState", "build_schedule"]

WindowAdaptationState = StagedAdaptationState


def window_adaptation(
    algorithm,
    logdensity_fn: Callable,
    is_mass_matrix_diagonal: bool = True,
    initial_inverse_mass_matrix: Optional[Array] = None,
    imm_shrinkage_to_previous: float = 0.0,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.80,
    adaptation_info_fn: Callable = return_all_adapt_info,
    n_chains: int = 1,
    **extra_parameters,
) -> AdaptationAlgorithm:
    """Tune ``(step_size, inverse_mass_matrix)`` for an HMC-family algorithm
    with Stan's three-phase window schedule.

    ``initial_inverse_mass_matrix`` seeds the first window's geometry;
    ``imm_shrinkage_to_previous`` is a pseudo-count that blends each
    window's estimate toward the previous window's (0 is Stan's behaviour).
    ``n_chains > 1`` adapts one step size and metric over a block of chains
    (see :func:`~blackjax_tpu_torch.adaptation.staged_adaptation.staged_adaptation`).
    """
    if imm_shrinkage_to_previous < 0:
        raise ValueError(
            f"imm_shrinkage_to_previous must be >= 0, got {imm_shrinkage_to_previous}."
        )
    initial_metric_state = None
    if initial_inverse_mass_matrix is not None:
        initial_inverse_mass_matrix = torch.as_tensor(initial_inverse_mass_matrix)
        ndim_expected = 1 if is_mass_matrix_diagonal else 2
        if initial_inverse_mass_matrix.dim() != ndim_expected:
            raise ValueError(
                "initial_inverse_mass_matrix has the wrong number of dimensions: "
                f"expected {ndim_expected} for "
                f"{'diagonal' if is_mass_matrix_diagonal else 'dense'} adaptation, "
                f"got {initial_inverse_mass_matrix.dim()}."
            )
        wc_init, _, _ = welford_algorithm(is_mass_matrix_diagonal)
        initial_metric_state = MassMatrixAdaptationState(
            initial_inverse_mass_matrix,
            wc_init(
                initial_inverse_mass_matrix.shape[0],
                dtype=initial_inverse_mass_matrix.dtype,
                device=initial_inverse_mass_matrix.device,
            ),
        )

    return staged_adaptation(
        algorithm,
        logdensity_fn,
        metric="welford_diag" if is_mass_matrix_diagonal else "welford_dense",
        metric_options={"imm_shrinkage_to_previous": imm_shrinkage_to_previous},
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        initial_metric_state=initial_metric_state,
        adaptation_info_fn=adaptation_info_fn,
        n_chains=n_chains,
        **extra_parameters,
    )
