"""MetricCore plugin layer for the staged warmup engine, and the named
recipe registry (reference ``blackjax_tpu/adaptation/metric_recipes.py``).

A ``MetricCore`` is ``(init, update, final)`` over a state that exposes
``.inverse_mass_matrix``:

- ``init(n_dims, *, dtype=None, device=None) -> state``;
- ``update(state, position, grad) -> state``, streaming accumulation of one
  ``(d,)`` draw or an ``(M, d)`` chain block;
- ``final(state) -> state`` at a slow-window boundary: recompute the
  inverse mass matrix and reset the window.

Ported: the ``welford_diag`` and ``welford_dense`` recipes. The Fisher,
low-rank and draws-SVD recipes of the reference's registry raise
``ValueError`` naming them as not yet ported.
"""
import dataclasses
from typing import Callable, NamedTuple, Optional

from blackjax_tpu_torch.adaptation.mass_matrix import mass_matrix_adaptation
from blackjax_tpu_torch.types import Array

__all__ = ["MetricCore", "MetricRecipe", "REGISTRY", "lookup_recipe"]


class MetricCore(NamedTuple):
    init: Callable
    update: Callable
    final: Callable


@dataclasses.dataclass(frozen=True)
class MetricRecipe:
    """A named, parameterized MetricCore constructor. ``needs`` declares the
    per-step inputs the core consumes and is checked against ``provides``
    when the recipe is built."""

    name: str
    build_core: Callable  # (**kwargs) -> MetricCore
    needs: frozenset = frozenset({"positions"})
    provides: frozenset = frozenset({"positions", "gradients"})
    emits: str = "diag"  # "diag" | "dense" | "low_rank"
    provenance: str = ""

    def __post_init__(self):
        if not set(self.needs) <= set(self.provides):
            raise ValueError(
                f"Recipe {self.name!r} declares needs={set(self.needs)} outside "
                f"provides={set(self.provides)}."
            )

    @property
    def provides_dense(self) -> bool:
        return self.emits == "dense"


def _build_welford_core(
    *,
    is_diagonal: bool,
    imm_shrinkage_to_previous: float = 0.0,
    initial_inverse_mass_matrix: Optional[Array] = None,
) -> MetricCore:
    mm_init, mm_update, mm_final = mass_matrix_adaptation(
        is_diagonal_matrix=is_diagonal,
        imm_shrinkage_to_previous=imm_shrinkage_to_previous,
    )

    def init(n_dims: int, *, dtype=None, device=None):
        return mm_init(n_dims, initial_inverse_mass_matrix, dtype=dtype, device=device)

    def update(state, position, grad=None):
        return mm_update(state, position, grad)

    return MetricCore(init, update, mm_final)


REGISTRY: dict[str, MetricRecipe] = {
    "welford_diag": MetricRecipe(
        "welford_diag",
        lambda **kw: _build_welford_core(is_diagonal=True, **kw),
        needs=frozenset({"positions"}),
        emits="diag",
        provenance="Stan-default diagonal Welford covariance (the baseline).",
    ),
    "welford_dense": MetricRecipe(
        "welford_dense",
        lambda **kw: _build_welford_core(is_diagonal=False, **kw),
        needs=frozenset({"positions"}),
        emits="dense",
        provenance="Dense Welford covariance (O(d^2); small d with strong "
        "correlation structure).",
    ),
}

# the reference's other recipes (ROADMAP queue 1, item 6)
_NOT_PORTED = (
    "fisher_diag",
    "fisher_low_rank",
    "fisher_low_rank_accumulating",
    "sample_cov_low_rank",
    "draws_svd_low_rank",
)


def lookup_recipe(name: str) -> MetricRecipe:
    if name in _NOT_PORTED:
        raise ValueError(
            f"Metric recipe {name!r} is not yet ported (ROADMAP queue 1, item 6); "
            f"available: {sorted(REGISTRY)}"
        )
    try:
        return REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown metric recipe {name!r}; available: {sorted(REGISTRY)}"
        ) from None
