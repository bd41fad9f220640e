"""The optax pieces the port's warmups use, in PyTorch (optax imports JAX,
which the port may not).

``adam`` is optax 0.2.6's ``adam``: ``chain(scale_by_adam(b1, b2, eps,
eps_root), scale(-learning_rate))``, with the state ``(ScaleByAdamState(count,
mu, nu), EmptyState())`` and the order of operations of ``scale_by_adam``:
the moments ``(1 - b) g**k + b m`` (one fused multiply-add, as XLA contracts
them in a compiled loop of updates), the int32 ``count`` incremented, the bias
corrections ``c = 1 - b**count`` and ``mu / (c1 (sqrt(nu / c2 + eps_root) +
eps))`` (XLA's simplifier folds the two divisions of ``mu_hat / (...)``
into one), then the scale. So optax's updates compiled in a ``scan`` and
these agree bit for bit. Parameters and updates are tensors or tuples of
tensors. ``apply_updates`` adds the updates in the parameters' dtypes.

``sgd`` is optax 0.2.6's ``sgd(learning_rate, momentum, nesterov)``:
``chain(trace(decay=momentum, nesterov), scale(-learning_rate))`` with
momentum, ``chain(identity(), scale(-learning_rate))`` without, the state
``(TraceState(trace) or EmptyState(), EmptyState())``. ``trace`` is ``t = g +
decay t`` and, with Nesterov's momentum, the update ``g + decay t`` of the new
trace, each one fused multiply-add, as XLA contracts them in a compiled loop of
updates; so ``sgd``'s updates and states agree with optax's bit for bit. (XLA
may also contract the parameters' ``p + (-lr) t`` where the update and its
application fuse, on some lanes and not others; ``apply_updates`` adds.)

``lbfgs`` is optax 0.2.6's L-BFGS (``alias.py:2591``): ``chain(scale_by_lbfgs(
memory_size), scale(-1.0), linesearch)`` with ``scale_by_zoom_linesearch``
(``linesearch.py:455-1646``) behind it, at optax's defaults (the tolerances,
the growth factor 2 and the interval threshold are constants here), its
safeguards and fallbacks kept: the interval search doubles the step; the zoom
tries the cubic minimiser, then the quadratic one, then bisection; a search
that fails takes its safe step. Two settings are ported, the two that are held
against optax: ``max_linesearch_steps`` and the first step's guess,
``"one"`` (optax's default ``lbfgs``) or ``"keep"`` (``minimize_lbfgs``'s). These
twins run **batched over a leading path axis**: parameters are ``(P, d)``,
every scalar of a state is ``(P,)``, and the objective ``value_fn`` maps a
``(P, d)`` batch to ``(P,)``. Each path keeps its own counters and ``done``
mask, and one host loop serves the batch, one read of the masks an
iteration: a path that has finished is frozen by ``torch.where`` while the
others go on, as JAX's ``vmap`` of ``lax.while_loop`` and ``lax.cond``
selects it, so a path of a batch computes what it computes alone. No
quantity is reduced across paths. The line search's ``update`` also takes
``active``, a ``(P,)`` mask of the paths to search (the others finish at
once and are discarded by the caller, as the reference discards a halted
path's untaken branch). Every ``vdot`` is ``(a * b).sum(-1)`` in the
parameters' dtype.
"""
from typing import Callable, NamedTuple

import torch

from blackjax_tpu_torch.mcmc.proposal import tree_select
from blackjax_tpu_torch.prng import exact_sqrt
from blackjax_tpu_torch.util import value_and_grad

__all__ = [
    "GradientTransformation",
    "ScaleByAdamState",
    "EmptyState",
    "adam",
    "TraceState",
    "trace",
    "sgd",
    "apply_updates",
    "scale",
    "ScaleByLBFGSState",
    "scale_by_lbfgs",
    "ZoomLinesearchState",
    "ZoomLinesearchInfo",
    "ScaleByZoomLinesearchState",
    "zoom_linesearch",
    "scale_by_zoom_linesearch",
    "lbfgs",
    "value_and_grad_from_state",
    "HOST_LOOPS",
]

# the host loop's iterations of every line search: each is one batched step
# of every path still searching (one evaluation of the objective)
HOST_LOOPS = {"zoom_linesearch": 0}

_INT32_MAX = 2**31 - 1

# optax's defaults of ``zoom_linesearch``: the tolerance on the errors, the
# interval search's growth factor, the sufficient-decrease and curvature
# constants, the approximate-decrease slack and the smallest interval
_TOL = 0.0
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(updates, state, params=None)
    -> (updates, state)``."""

    init: Callable
    update: Callable


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # 0-d int32
    mu: object
    nu: object


class EmptyState(NamedTuple):
    """The stateless ``scale``'s state."""


def _map(fn, *trees):
    """``fn`` over the leaves of tensors or (nested) tuples of tensors."""
    first = trees[0]
    if isinstance(first, tuple) and not hasattr(first, "_fields"):
        return tuple(_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def _moment(g, m, decay, order):
    """``(1 - decay) g**order + decay m`` with one product fused into the
    sum, as XLA's CPU backend contracts it in a compiled loop of updates (a
    ``scan``, as the warmups run): ``(1 - decay) g**order`` in float32,
    ``decay m`` in float64."""
    power = g if order == 1 else g * g
    if m.dtype == torch.float32:
        return torch.addcmul(decay * m, torch.full_like(power, 1 - decay), power)
    return torch.addcmul((1 - decay) * power, torch.full_like(m, decay), m)


def _bias_correction(decay, count, like):
    """``1 - decay**count``, the power in the moment's dtype, as XLA raises a
    float to an int32 array (float32 without x64, float64 with it)."""
    base = torch.full((), decay, dtype=like.dtype, device=like.device)  # a fill, no copy
    return 1 - torch.pow(base, count.to(like.dtype))


def adam(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    eps_root: float = 0.0,
) -> GradientTransformation:
    """optax's ``adam(learning_rate, b1, b2, eps, eps_root)`` (a constant
    learning rate)."""

    def init(params):
        zeros = _map(torch.zeros_like, params)
        count = torch.zeros((), dtype=torch.int32, device=_device(params))
        return ScaleByAdamState(count, zeros, _map(torch.zeros_like, params)), EmptyState()

    def update(updates, state, params=None):
        del params
        adam_state, empty = state
        mu = _map(lambda g, m: _moment(g, m, b1, 1), updates, adam_state.mu)
        nu = _map(lambda g, v: _moment(g, v, b2, 2), updates, adam_state.nu)
        count = torch.where(adam_state.count < _INT32_MAX, adam_state.count + 1,
                            adam_state.count)

        def step(m, v):
            nu_hat = v / _bias_correction(b2, count, v)
            denominator = exact_sqrt(nu_hat + eps_root) + eps
            # XLA rewrites (m / c1) / d as m / (c1 * d)
            return -learning_rate * (m / (_bias_correction(b1, count, m) * denominator))

        return _map(step, mu, nu), (ScaleByAdamState(count, mu, nu), empty)

    return GradientTransformation(init, update)


class TraceState(NamedTuple):
    """optax's ``trace`` state: the trace of past updates."""

    trace: object


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """optax's ``trace(decay, nesterov)``: the trace ``g + decay t`` and,
    with Nesterov's momentum, the update ``g + decay t`` of the new trace,
    each rounded once (``torch.addcmul``), as XLA contracts them."""

    def decayed(g, t):
        return torch.addcmul(g, torch.full_like(t, decay), t)

    def init(params):
        return TraceState(_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        del params
        new_trace = _map(decayed, updates, state.trace)
        out = _map(decayed, updates, new_trace) if nesterov else new_trace
        return out, TraceState(new_trace)

    return GradientTransformation(init, update)


def sgd(learning_rate: float, momentum: float | None = None,
        nesterov: bool = False) -> GradientTransformation:
    """optax's ``sgd(learning_rate, momentum, nesterov)`` (a constant
    learning rate): :func:`trace` when ``momentum`` is set, else the
    identity, then the scale by ``-learning_rate``."""
    inner = trace(momentum, nesterov) if momentum is not None else None

    def init(params):
        return (EmptyState() if inner is None else inner.init(params)), EmptyState()

    def update(updates, state, params=None):
        first, empty = state
        if inner is not None:
            updates, first = inner.update(updates, first, params)
        return _map(lambda u: -learning_rate * u, updates), (first, empty)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """``params + updates``, each sum in its parameter's dtype."""
    return _map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _device(params):
    leaf = params
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    return leaf.device


# ---------------------------------------------------------------------------
# L-BFGS and the zoom line search, batched over a leading path axis
# ---------------------------------------------------------------------------
def _vdot(a, b):
    return (a * b).sum(-1)


def _increment(count):
    """optax's ``safe_increment`` of an int32 counter."""
    return torch.where(count < _INT32_MAX, count + 1, count)


def scale(step_size: float) -> GradientTransformation:
    """optax's ``scale``: ``step_size * updates``."""

    def init(params):
        del params
        return EmptyState()

    def update(updates, state, params=None, **extra_args):
        del params, extra_args
        return step_size * updates, state

    return GradientTransformation(init, update)


class ScaleByLBFGSState(NamedTuple):
    """optax's state of ``scale_by_lbfgs``, a row a path: ``count`` (P,)
    int32, ``params`` and ``updates`` (P, d), the memories (P, m, d) and the
    weights (P, m)."""

    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor
    diff_updates_memory: torch.Tensor
    weights_memory: torch.Tensor


def _precondition_by_lbfgs(updates, diff_params_memory, diff_updates_memory, weights_memory,
                           identity_scale, memory_idx):
    """optax's two-loop recursion (``transform.py:1497``): the memory read
    in the order ``(memory_idx + j) % m`` of each path, the right product
    from the newest pair back, the identity's scale, then the left
    product."""
    num_paths, memory_size, dim = diff_params_memory.shape
    order = (memory_idx[:, None] + torch.arange(memory_size, device=updates.device)) % memory_size
    rows = order[..., None].expand(num_paths, memory_size, dim)
    dw = diff_params_memory.gather(1, rows)
    du = diff_updates_memory.gather(1, rows)
    rhos = weights_memory.gather(1, order)
    vec = updates
    alphas = [None] * memory_size
    for j in reversed(range(memory_size)):
        alphas[j] = rhos[:, j] * _vdot(dw[:, j], vec)
        vec = vec + (-alphas[j])[:, None] * du[:, j]
    vec = identity_scale[:, None] * vec
    for j in range(memory_size):
        beta = rhos[:, j] * _vdot(du[:, j], vec)
        vec = vec + (alphas[j] - beta)[:, None] * dw[:, j]
    return vec


def scale_by_lbfgs(memory_size: int = 10) -> GradientTransformation:
    """optax's ``scale_by_lbfgs`` (``transform.py:1570``): the update
    preconditioned by the memory's inverse-Hessian approximation. The
    memory is circular, written at ``(count - 1) % memory_size``; the
    identity's scale is ``s.y / y.y`` of the newest pair, and on the first
    step the capped reciprocal ``min(1, 1 / ||g||)`` of the gradient's
    norm."""
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")

    def init(params):
        num_paths, dim = params.shape
        zeros = torch.zeros((num_paths, memory_size, dim), dtype=params.dtype,
                            device=params.device)
        return ScaleByLBFGSState(
            torch.zeros(num_paths, dtype=torch.int32, device=params.device),
            torch.zeros_like(params), torch.zeros_like(params), zeros, zeros.clone(),
            torch.zeros((num_paths, memory_size), dtype=params.dtype, device=params.device))

    def update(updates, state: ScaleByLBFGSState, params, **extra_args):
        del extra_args
        memory_idx = state.count % memory_size
        prev_memory_idx = (state.count - 1) % memory_size
        started = state.count > 0
        diff_params = params - state.params
        diff_updates = updates - state.updates
        vdot_diff = _vdot(diff_updates, diff_params)
        weight = torch.where(vdot_diff == 0.0, torch.zeros_like(vdot_diff), 1.0 / vdot_diff)
        diff_params = tree_select(started, diff_params, torch.zeros_like(diff_params))
        diff_updates = tree_select(started, diff_updates, torch.zeros_like(diff_updates))
        weight = torch.where(started, weight, torch.zeros_like(weight))
        slot = torch.arange(memory_size, device=params.device) == prev_memory_idx[:, None]
        diff_params_memory = torch.where(slot[..., None], diff_params[:, None],
                                         state.diff_params_memory)
        diff_updates_memory = torch.where(slot[..., None], diff_updates[:, None],
                                          state.diff_updates_memory)
        weights_memory = torch.where(slot, weight[:, None], state.weights_memory)
        numerator = _vdot(diff_updates, diff_params)
        denominator = (diff_updates * diff_updates).sum(-1)
        identity_scale = torch.where(denominator > 0.0, numerator / denominator,
                                     torch.ones_like(numerator))
        capped_inv_norm = torch.clamp(1.0 / torch.sqrt((updates * updates).sum(-1)), max=1.0)
        identity_scale = torch.where(started, identity_scale, capped_inv_norm)
        precond = _precondition_by_lbfgs(updates, diff_params_memory, diff_updates_memory,
                                         weights_memory, identity_scale, memory_idx)
        return precond, ScaleByLBFGSState(_increment(state.count), params, updates,
                                          diff_params_memory, diff_updates_memory,
                                          weights_memory)

    return GradientTransformation(init, update)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The minimiser of the cubic through ``(a, fa)`` with slope ``fpa`` at
    ``a``, ``(b, fb)`` and ``(c, fc)`` (``linesearch.py:455``); NaN where
    there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc**2 * v0 + (-(db**2)) * v1) / denom
    B = ((-(dc**3)) * v0 + db**3 * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The minimiser of the quadratic through ``(a, fa)`` with slope ``fpa``
    at ``a`` and ``(b, fb)`` (``linesearch.py:496``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db**2)
    return a - C / (2.0 * B)


class ZoomLinesearchState(NamedTuple):
    """optax's ``ZoomLinesearchState`` (``linesearch.py:525``), a row a
    path."""

    count: torch.Tensor
    params: torch.Tensor
    updates: torch.Tensor
    stepsize_guess: torch.Tensor
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    slope: torch.Tensor
    value_init: torch.Tensor
    slope_init: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor
    error: torch.Tensor
    interval_found: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor
    low: torch.Tensor
    value_low: torch.Tensor
    slope_low: torch.Tensor
    high: torch.Tensor
    value_high: torch.Tensor
    slope_high: torch.Tensor
    cubic_ref: torch.Tensor
    value_cubic_ref: torch.Tensor
    safe_stepsize: torch.Tensor
    safe_value: torch.Tensor
    safe_grad: torch.Tensor


def zoom_linesearch(max_linesearch_steps: int) -> tuple[Callable, Callable, Callable]:
    """optax's ``zoom_linesearch`` (``linesearch.py:576``): ``(init, step,
    cond)``. ``step(state, value_and_grad_fn)`` moves every path one
    iteration: a path still looking for an interval (``_search_interval``,
    ``:815``) tries ``stepsize_guess`` first and then twice its last step; a path with an interval (``_zoom_into_interval``,
    ``:971``) tries the cubic minimiser, else the quadratic one, else the
    midpoint. Each path's trial step is evaluated once, in one batched call
    of ``value_and_grad_fn``, and both branches' states are built from it;
    the path's branch is selected, then, where it failed, its safe step."""

    def _decrease_error(stepsize, value_step, slope_step, value_init, slope_init):
        decrease_error = value_step - value_init - _SLOPE_RTOL * stepsize * slope_init
        approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * slope_init
        delta_values = value_step - value_init - _APPROX_DEC_RTOL * torch.abs(value_init)
        approx = torch.maximum(approx, delta_values)
        decrease_error = torch.minimum(approx, decrease_error)
        decrease_error = torch.clamp(decrease_error, min=0.0)
        return torch.where(torch.isnan(decrease_error), torch.inf, decrease_error)

    def _curvature_error(slope_step, slope_init):
        curvature_error = torch.clamp(
            torch.abs(slope_step) - _CURV_RTOL * torch.abs(slope_init), min=0.0)
        return torch.where(torch.isnan(curvature_error), torch.inf, curvature_error)

    def _try_safe_step(state: ZoomLinesearchState) -> ZoomLinesearchState:
        use_safe = (state.safe_stepsize > 0.0) | torch.isinf(state.decrease_error)
        return state._replace(
            stepsize=torch.where(use_safe, state.safe_stepsize, state.stepsize),
            value=torch.where(use_safe, state.safe_value, state.value),
            grad=tree_select(use_safe, state.safe_grad, state.grad))

    def _search_interval(state, new_stepsize, value_step, grad_step, slope_step):
        decrease_error = _decrease_error(new_stepsize, value_step, slope_step,
                                         state.value_init, state.slope_init)
        curvature_error = _curvature_error(slope_step, state.slope_init)
        new_error = torch.maximum(decrease_error, curvature_error)
        safe_decrease = decrease_error <= _TOL
        set_high_to_new = (decrease_error > 0.0) | (
            (value_step >= state.value) & (state.count > 0))
        set_low_to_new = (slope_step >= 0.0) & ~set_high_to_new
        pick = lambda new, old: torch.where(set_low_to_new, new, old)  # noqa: E731
        low = pick(new_stepsize, state.stepsize)
        value_low = pick(value_step, state.value)
        slope_low = pick(slope_step, state.slope)
        interval_found = set_high_to_new | set_low_to_new | (new_error <= _TOL)
        done = new_error <= _TOL
        return ZoomLinesearchState(
            count=_increment(state.count),
            params=state.params,
            updates=state.updates,
            stepsize_guess=state.stepsize_guess,
            stepsize=new_stepsize,
            value=value_step,
            grad=grad_step,
            slope=slope_step,
            value_init=state.value_init,
            slope_init=state.slope_init,
            decrease_error=decrease_error,
            curvature_error=curvature_error,
            error=new_error,
            interval_found=interval_found,
            done=done,
            failed=(state.count + 1 >= max_linesearch_steps) & ~done,
            low=low,
            value_low=value_low,
            slope_low=slope_low,
            high=pick(state.stepsize, new_stepsize),
            value_high=pick(state.value, value_step),
            slope_high=pick(state.slope, slope_step),
            cubic_ref=low,
            value_cubic_ref=value_low,
            safe_stepsize=torch.where(safe_decrease, new_stepsize, state.safe_stepsize),
            safe_value=torch.where(safe_decrease, value_step, state.safe_value),
            safe_grad=tree_select(safe_decrease, grad_step, state.safe_grad),
        )

    def _zoom_middle(state):
        """The trial step of ``_zoom_into_interval`` and whether the
        interval is below the threshold."""
        low, high = state.low, state.high
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        middle_cubic = _cubicmin(low, state.value_low, state.slope_low, high, state.value_high,
                                 state.cubic_ref, state.value_cubic_ref)
        use_cubic = (middle_cubic > left + cubic_chk) & (middle_cubic < right - cubic_chk)
        middle_quad = _quadmin(low, state.value_low, state.slope_low, high, state.value_high)
        use_quad = ~use_cubic & (middle_quad > left + quad_chk) & (middle_quad < right - quad_chk)
        use_bisection = ~use_cubic & ~use_quad
        middle = torch.where(use_cubic, middle_cubic, state.cubic_ref)
        middle = torch.where(use_quad, middle_quad, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)
        return middle, delta <= _INTERVAL_THRESHOLD

    def _zoom_into_interval(state, middle, too_small_int, value_middle, grad_middle,
                            slope_middle):
        decrease_error = _decrease_error(middle, value_middle, slope_middle, state.value_init,
                                         state.slope_init)
        curvature_error = _curvature_error(slope_middle, state.slope_init)
        new_error = torch.maximum(decrease_error, curvature_error)
        update_safe = (decrease_error <= _TOL) & (value_middle < state.safe_value)
        new_safe_stepsize = torch.where(update_safe, middle, state.safe_stepsize)
        done = new_error <= _TOL
        set_high_to_middle = (decrease_error > 0.0) | (value_middle >= state.value_low)
        set_high_to_low = (slope_middle * (state.high - state.low) >= 0.0) & ~set_high_to_middle
        set_low_to_middle = ~set_high_to_middle

        def new_high(middle_value, low_value, high_value):
            return torch.where(set_high_to_low, low_value,
                               torch.where(set_high_to_middle, middle_value, high_value))

        moved_high = set_high_to_middle | set_high_to_low
        presumably_failed = (state.count + 1 >= max_linesearch_steps) | (
            too_small_int & (new_safe_stepsize > 0.0))
        return ZoomLinesearchState(
            count=_increment(state.count),
            params=state.params,
            updates=state.updates,
            stepsize_guess=state.stepsize_guess,
            stepsize=middle,
            value=value_middle,
            grad=grad_middle,
            slope=slope_middle,
            value_init=state.value_init,
            slope_init=state.slope_init,
            decrease_error=decrease_error,
            curvature_error=curvature_error,
            error=new_error,
            interval_found=state.interval_found,
            done=done,
            failed=presumably_failed & ~done,
            low=torch.where(set_low_to_middle, middle, state.low),
            value_low=torch.where(set_low_to_middle, value_middle, state.value_low),
            slope_low=torch.where(set_low_to_middle, slope_middle, state.slope_low),
            high=new_high(middle, state.low, state.high),
            value_high=new_high(value_middle, state.value_low, state.value_high),
            slope_high=new_high(slope_middle, state.slope_low, state.slope_high),
            cubic_ref=torch.where(moved_high, state.high, state.low),
            value_cubic_ref=torch.where(moved_high, state.value_high, state.value_low),
            safe_stepsize=new_safe_stepsize,
            safe_value=torch.where(update_safe, value_middle, state.safe_value),
            safe_grad=tree_select(update_safe, grad_middle, state.safe_grad),
        )

    def init(updates, params, *, value, grad, prev_stepsize,
             initial_guess_strategy: str) -> ZoomLinesearchState:
        zero = torch.zeros_like(value)
        if initial_guess_strategy == "one":
            stepsize_guess = torch.ones_like(value)
        else:
            stepsize_guess = torch.as_tensor(prev_stepsize, dtype=value.dtype,
                                             device=value.device).expand_as(value)
        slope = _vdot(updates, grad)
        inf = torch.full_like(value, torch.inf)
        false = torch.zeros(value.shape, dtype=torch.bool, device=value.device)
        return ZoomLinesearchState(
            count=torch.zeros(value.shape, dtype=torch.int32, device=value.device),
            params=params, updates=updates, stepsize_guess=stepsize_guess,
            stepsize=zero, value=value, grad=grad, slope=slope,
            value_init=value, slope_init=slope,
            decrease_error=inf, curvature_error=inf, error=inf,
            interval_found=false, done=false, failed=false,
            low=zero, value_low=value, slope_low=slope,
            high=zero, value_high=value, slope_high=slope,
            cubic_ref=zero, value_cubic_ref=value,
            safe_stepsize=zero, safe_value=value, safe_grad=grad)

    def step(state: ZoomLinesearchState, value_and_grad_fn: Callable) -> ZoomLinesearchState:
        searched = torch.where(state.count == 0, state.stepsize_guess,
                               _INCREASE_FACTOR * state.stepsize)
        middle, too_small_int = _zoom_middle(state)
        trial = torch.where(state.interval_found, middle, searched)
        value_t, grad_t = value_and_grad_fn(state.params + trial[:, None] * state.updates)
        slope_t = _vdot(grad_t, state.updates)
        new_state = tree_select(
            state.interval_found,
            _zoom_into_interval(state, middle, too_small_int, value_t, grad_t, slope_t),
            _search_interval(state, searched, value_t, grad_t, slope_t))
        return tree_select(new_state.failed, _try_safe_step(new_state), new_state)

    def cond(state: ZoomLinesearchState):
        return ~(state.done | state.failed)

    return init, step, cond


class ZoomLinesearchInfo(NamedTuple):
    num_linesearch_steps: torch.Tensor
    decrease_error: torch.Tensor
    curvature_error: torch.Tensor


class ScaleByZoomLinesearchState(NamedTuple):
    learning_rate: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor
    info: ZoomLinesearchInfo


def scale_by_zoom_linesearch(max_linesearch_steps: int,
                             initial_guess_strategy: str = "keep") -> GradientTransformation:
    """optax's ``scale_by_zoom_linesearch`` (``linesearch.py:1331``):
    ``update(updates, state, params, *, value, grad, value_fn, active=None)``
    runs the zoom line search along ``updates`` from ``params`` until every
    active path is done or failed, one host read a step, and scales each
    path's updates by its step. The state keeps the last step (the next
    search's guess under ``"keep"``), the value and gradient there, and the
    search's trip count and errors."""
    if initial_guess_strategy not in ("one", "keep"):
        raise ValueError(f"Unknown initial guess strategy: {initial_guess_strategy}")
    init_ls, step_ls, cond_ls = zoom_linesearch(max_linesearch_steps)

    def init(params) -> ScaleByZoomLinesearchState:
        num_paths = params.shape[0]
        inf = torch.full((num_paths,), torch.inf, dtype=params.dtype, device=params.device)
        return ScaleByZoomLinesearchState(
            torch.ones(num_paths, dtype=params.dtype, device=params.device), inf,
            torch.zeros_like(params),
            ZoomLinesearchInfo(torch.zeros(num_paths, dtype=torch.int32, device=params.device),
                               inf, inf.clone()))

    def update(updates, state: ScaleByZoomLinesearchState, params, *, value, grad,
               value_fn: Callable, active=None, **extra_args):
        del extra_args
        ls_state = init_ls(updates, params, value=value, grad=grad,
                           prev_stepsize=state.learning_rate,
                           initial_guess_strategy=initial_guess_strategy)
        if active is not None:
            ls_state = ls_state._replace(done=~active)

        def evaluate(x):
            return value_and_grad(value_fn, x)

        while True:
            running = cond_ls(ls_state)
            if not bool(running.any()):
                break
            HOST_LOOPS["zoom_linesearch"] += 1
            ls_state = tree_select(running, step_ls(ls_state, evaluate), ls_state)
        learning_rate = ls_state.stepsize
        return learning_rate[:, None] * updates, ScaleByZoomLinesearchState(
            learning_rate, ls_state.value, ls_state.grad,
            ZoomLinesearchInfo(ls_state.count, ls_state.decrease_error,
                               ls_state.curvature_error))

    return GradientTransformation(init, update)


def _chain(*transforms) -> GradientTransformation:
    """optax's ``chain``: the extra arguments go to every transform."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None, **extra_args):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params, **extra_args)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def lbfgs(
    memory_size: int = 10,
    linesearch: GradientTransformation = scale_by_zoom_linesearch(
        max_linesearch_steps=20, initial_guess_strategy="one"),
) -> GradientTransformation:
    """optax's ``lbfgs`` (``alias.py:2591``) without a learning rate:
    ``chain(scale_by_lbfgs, scale(-1.0), linesearch)``, the zoom line search
    with 20 steps from a guess of 1 by default."""
    return _chain(scale_by_lbfgs(memory_size), scale(-1.0), linesearch)


def _find(state, field):
    """The values of ``field`` in the records of a (nested) state."""
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        found = [getattr(state, field)] if field in state._fields else []
        return found + [v for f in state for v in _find(f, field)]
    if isinstance(state, tuple):
        return [v for s in state for v in _find(s, field)]
    return []


def value_and_grad_from_state(value_fn: Callable) -> Callable:
    """optax's ``value_and_grad_from_state`` (``utils.py:266``):
    ``fn(params, *, state)`` returns the value and gradient that the line
    search stored in ``state``, and evaluates ``value_fn`` afresh on the
    paths whose stored value is infinite or NaN (one host read)."""

    def fn(params, *, state):
        values, grads = _find(state, "value"), _find(state, "grad")
        if len(values) != 1 or len(grads) != 1:
            raise ValueError(
                "Value or gradient not found in the state. Make sure that these values "
                "are stored in the state by the optimizer.")
        value, grad = values[0], grads[0]
        finite = torch.isfinite(value)
        if not bool(finite.all()):
            fresh_value, fresh_grad = value_and_grad(value_fn, params)
            value = torch.where(finite, value, fresh_value)
            grad = tree_select(finite, grad, fresh_grad)
        return value, grad

    return fn
