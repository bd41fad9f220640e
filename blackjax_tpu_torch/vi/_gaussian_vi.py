"""The optimization step shared by the Gaussian variational families
(mean-field and full-rank); reference ``blackjax_tpu/vi/_gaussian_vi.py``.

The parameters are a tuple of tensors. The reparameterised loss is
differentiated by ``torch.autograd.grad`` over that tuple; the
sticking-the-landing estimator detaches the parameters inside ``logq`` (the
reference's ``stop_gradient``). ``logdensity_fn`` and the family's ``logq``
map a ``(n, d)`` batch of draws to ``(n,)``.
"""
import math
from dataclasses import dataclass
from typing import Callable, Union

import torch

__all__ = ["KL", "RenyiAlpha", "Objective", "elbo_step"]


@dataclass(frozen=True)
class KL:
    """Reverse KL(q || p): the standard negative-ELBO objective."""


@dataclass(frozen=True)
class RenyiAlpha:
    """Rényi-alpha variational bound; reduces to reverse KL at alpha = 1."""

    alpha: float


Objective = Union[KL, RenyiAlpha]


def _loss_from_log_ratio(log_ratio: torch.Tensor, objective: Objective) -> torch.Tensor:
    if isinstance(objective, KL):
        return log_ratio.mean()
    if isinstance(objective, RenyiAlpha):
        alpha = objective.alpha
        if alpha == 1.0:
            return log_ratio.mean()
        scaled = (alpha - 1.0) * log_ratio
        return (torch.logsumexp(scaled, 0) - math.log(log_ratio.shape[0])) / (alpha - 1.0)
    raise TypeError(f"Unsupported objective type: {type(objective)!r}")


def elbo_step(
    rng_key,
    parameters: tuple,
    opt_state,
    logdensity_fn: Callable,
    optimizer,
    sample_fn: Callable,
    logq_fn: Callable,
    num_samples: int,
    objective: Objective = KL(),
    stl_estimator: bool = True,
) -> tuple:
    """One Monte-Carlo reparameterisation-gradient step of the variational
    objective: ``(new_parameters, new_opt_state, loss)``. With
    ``stl_estimator`` the score term is dropped by detaching the parameters
    inside ``logq`` (sticking the landing). ``optimizer`` is one of
    :mod:`blackjax_tpu_torch.optimizers.optax_twins`; its updates are added
    to the parameters leaf by leaf."""
    if stl_estimator and isinstance(objective, RenyiAlpha) and objective.alpha != 1.0:
        raise ValueError(
            "stl_estimator only applies to KL() / RenyiAlpha(alpha=1.0); pass "
            "stl_estimator=False for other alpha."
        )
    with torch.enable_grad():
        leaves = tuple(p.detach().requires_grad_(True) for p in parameters)
        z = sample_fn(rng_key, leaves, num_samples)
        logq_parameters = tuple(p.detach() for p in leaves) if stl_estimator else leaves
        logq = logq_fn(logq_parameters)(z)
        logp = logdensity_fn(z)
        loss = _loss_from_log_ratio(logq - logp, objective)
        grads = torch.autograd.grad(loss, leaves)
    updates, new_opt_state = optimizer.update(grads, opt_state, parameters)
    new_parameters = tuple(p + u for p, u in zip(parameters, updates))
    return new_parameters, new_opt_state, loss.detach()
