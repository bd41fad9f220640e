"""Nested sampling (reference ``blackjax_tpu/ns/__init__.py``)."""
from blackjax_tpu_torch.ns import adaptive, base, from_mcmc, integrator, utils

__all__ = ["adaptive", "base", "from_mcmc", "integrator", "utils"]
