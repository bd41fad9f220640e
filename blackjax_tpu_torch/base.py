"""Core algorithm contracts (reference ``blackjax_tpu/base.py``).

The universal abstraction is the *kernel*: a function
``(generator, state) -> (new_state, info)`` paired with an
``init(position) -> state``. A state holds every chain at once: the leading
axis of each tensor is the chain axis, written out where the reference
``vmap``s a single-chain kernel.
"""
from typing import Any, Callable, NamedTuple, Protocol

from blackjax_tpu_torch.types import ArrayLikeTree, ArrayTree, PRNGKey

__all__ = [
    "InitFn",
    "UpdateFn",
    "SamplingAlgorithm",
    "VIAlgorithm",
    "AdaptationAlgorithm",
    "AdaptationResults",
    "RunFn",
    "build_sampling_algorithm",
]

State = ArrayTree
Info = ArrayTree


class InitFn(Protocol):
    """Builds an algorithm state from initial positions."""

    def __call__(self, position: ArrayLikeTree, rng_key: PRNGKey | None = None) -> State:
        ...


class UpdateFn(Protocol):
    """Moves every chain of the state one transition forward."""

    def __call__(self, rng_key: PRNGKey, state: State) -> tuple[State, Info]:
        ...


class SamplingAlgorithm(NamedTuple):
    """A pair ``(init, step)`` implementing a Markov transition kernel."""

    init: InitFn
    step: UpdateFn


class VIAlgorithm(NamedTuple):
    """Variational family: ``init``, ``step`` and ``sample``."""

    init: Callable
    step: Callable
    sample: Callable


class RunFn(Protocol):
    def __call__(self, rng_key: PRNGKey, position: ArrayLikeTree, num_steps: int) -> Any:
        ...


class AdaptationResults(NamedTuple):
    state: ArrayTree
    parameters: dict


class AdaptationInfo(NamedTuple):
    state: ArrayTree
    info: ArrayTree
    adaptation_state: ArrayTree


class AdaptationAlgorithm(NamedTuple):
    """Warmup: ``run(rng_key, position, num_steps) -> (results, info)``."""

    run: RunFn


def build_sampling_algorithm(
    kernel: Callable,
    init_state: Callable,
    logdensity_fn: Callable,
    init_args: tuple = (),
    kernel_args: tuple = (),
    *,
    pass_rng_key_to_init: bool = False,
) -> SamplingAlgorithm:
    """Close a general ``(generator, state, logdensity_fn, *args)`` kernel and
    its ``init`` over fixed parameters, yielding a ``SamplingAlgorithm``
    (reference ``base.py:85``)."""

    def init_fn(position: ArrayLikeTree, rng_key: PRNGKey | None = None):
        if pass_rng_key_to_init:
            if rng_key is None:
                raise ValueError(
                    "this algorithm's init requires a generator: call "
                    "algo.init(position, generator)"
                )
            return init_state(position, logdensity_fn, *init_args, rng_key)
        return init_state(position, logdensity_fn, *init_args)

    def step_fn(rng_key: PRNGKey, state: State) -> tuple[State, Info]:
        return kernel(rng_key, state, logdensity_fn, *kernel_args)

    return SamplingAlgorithm(init_fn, step_fn)
