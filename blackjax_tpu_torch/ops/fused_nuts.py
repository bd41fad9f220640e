"""The continuous NUTS machine of the older Pallas kernel: ``num_steps``
transitions per chain in one CUDA kernel, on the fused leapfrog's targets.

Port of ``blackjax_tpu/ops/fused_nuts.py`` (``fused_nuts_run`` and its
Pallas kernel ``_nuts_kernel``). The machine is the flattened NUTS engine
taken one leapfrog leaf per iteration (``mcmc/trajectory.py``), with an
inline restart: a chain that closes a transition starts its next one on the
following iteration, the continuous runner's schedule. It is the machine of
:mod:`~blackjax_tpu_torch.ops.fused_nuts_dc` at ``pack=1, restart_every=1``
and a diagonal metric, except where the older kernel spells it otherwise:

- the proposal uniform is a block of its own (tag 4, keyed on the depth),
  where the dc machine takes the second word of the direction's block;
- a checkpoint slot's U-turn test forms ``rho = (sub_msum - ckpt_sum +
  ckpt_m) - 0.5 (ckpt_m + m)``; the momentum is ``sigma_m * sqrt(-2 log
  u1) * cos(2 pi u2)``, in that order;
- ``trace=N`` records 18 per-iteration columns (:data:`TRACE_COLS`) of the
  first ``N`` iterations, from a loop that runs without an early exit (a
  finished chain's registers keep evolving, masked, as in the reference).

Its randomness is the counter-based threefry of
:mod:`blackjax_tpu_torch.ops.counter_rng`, keyed on (seed, chain, step,
depth or leaf count, stream) as the Pallas kernel keys it, so the port draws
the reference's numbers and is held against it chain by chain.

Two implementations of the same machine live here:

- the CUDA kernel ``csrc/fused_nuts.cu`` (one warp per chain), launched for
  CUDA tensors, in one of two forms that :func:`plan` picks before the
  launch: the resident form (the hierarchical and Gaussian targets without
  a trace: one warp a block, most of a chain's state in a scratch in device
  memory, as the dc machine's resident form) or the registers form (the
  trace and logistic regression: four warps a block, the chain's state in
  registers). Both give the same bits. :data:`LAUNCHES` counts each form;
- :func:`fused_nuts_run_plain`, the plain PyTorch version on the ``(C, d)``
  batch with masks, taken for CPU tensors and used on the card as the
  kernel's reference.

Targets are :class:`~blackjax_tpu_torch.ops.fused_leapfrog.TargetKernel`:
the hierarchical and Gaussian targets and logistic regression, ``d <= 256``
on the card. The Pallas options ``interpret`` and ``debug`` and the
``FNUTS_DISABLE`` attribution switch are left out; ``tile_chains`` is
accepted and changes nothing (chains are independent on the GPU, and the
reference's per-tile chunk skip only skips finished chains).
"""
import ctypes
import dataclasses
import functools

import torch

from blackjax_tpu_torch.ops import _nvcc
from blackjax_tpu_torch.ops.counter_rng import (
    _TWO_PI,
    KEY1,
    MASK32,
    _to_unit,
    counter_uniforms,
    popcount8,
    threefry2x32,
)
from blackjax_tpu_torch.ops.fused_leapfrog import (
    TargetKernel,
    _ptr,
    _target_args,
    make_hierarchical_gaussian_target,
)
from blackjax_tpu_torch.ops.fused_nuts_dc import _dot, _logaddexp, _round_up, _sel

__all__ = [
    "FORMS",
    "LAUNCHES",
    "TRACE_COLS",
    "build",
    "fused_nuts_run",
    "fused_nuts_run_plain",
    "make_mxu_safe_hierarchical_target",
    "occupancy",
    "plan",
]

# kernel launches made by fused_nuts_run, by kernel name, and by the form
# the launch took
LAUNCHES = {"fused_nuts": 0, "fused_nuts:resident": 0, "fused_nuts:registers": 0}

# per-iteration quantities recorded by fused_nuts_run(trace=N), as the
# reference names them (fused_nuts.py:43-47)
TRACE_COLS = (
    "start", "at_start", "direction", "depth", "leaf", "delta", "u_leaf",
    "take", "sub_w", "u_prop", "take_traj", "prop_w", "closing", "done_new",
    "energy", "h0", "ltau", "aborted",
)

_MAX_CUDA_DIM = 256  # eight registers per lane and vector
_ANALYTIC = (0, 1)  # the hierarchical and Gaussian targets' cuda_target
FORMS = ("resident", "registers")


def make_mxu_safe_hierarchical_target(dim: int) -> TargetKernel:
    """The reference's hierarchical target for this kernel (``fused_nuts.py
    :62``). Its tile functions only route the same arithmetic around a
    Mosaic layout limit (the MXU broadcasts are exact), so here it is
    :func:`make_hierarchical_gaussian_target` under the reference's name."""
    return dataclasses.replace(
        make_hierarchical_gaussian_target(dim), name="hierarchical_gaussian_mxu_safe"
    )


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def _machine_plain(x0, imm, step_size, *, target, num_steps, max_depth, seed,
                   num_track, budget, chunk, divergence_threshold, trace):
    """The machine on a ``(C, d)`` f32 batch in plain PyTorch, with masks.

    Mirrors ``_nuts_kernel`` select for select, finished chains included.
    The loop stops once every chain has finished (checked once per
    ``chunk`` iterations, one host sync each) and, with ``trace``, has run
    ``trace`` iterations. Returns ``(acc_x (C, d), steps (C,) int32, grads
    (C,) f32, history (C, S, k), trace (len(TRACE_COLS), trace, C) or
    None)``."""
    C, d = x0.shape
    S = num_steps
    dev = x0.device
    f32 = torch.float32
    grad, logdensity = target.grad_tile, target.logdensity_tile
    eps = torch.tensor(step_size, dtype=f32, device=dev)
    pos = imm > 0.0
    sigma_m = torch.sqrt(torch.where(pos, 1.0 / torch.where(pos, imm, 1.0), 0.0))
    chain = torch.arange(C, dtype=torch.int64, device=dev)
    lanes = torch.arange(d, dtype=torch.int64, device=dev)
    seed = int(seed) & MASK32

    def kinetic(m):
        return 0.5 * _dot(m * imm, m)

    def turning(m_left, m_right, m_sum):
        rho = m_sum - 0.5 * (m_left + m_right)
        return (_dot(imm * m_left, rho) <= 0.0) | (_dot(imm * m_right, rho) <= 0.0)

    g0, ld0 = grad(x0), logdensity(x0)
    zero_v = torch.zeros_like(x0)
    zero_s = torch.zeros(C, dtype=f32, device=dev)
    zero_i = torch.zeros(C, dtype=torch.int64, device=dev)
    fbool = torch.zeros(C, dtype=torch.bool, device=dev)
    neg_inf = torch.full((C,), -torch.inf, dtype=f32, device=dev)
    s = dict(
        acc_x=x0, acc_g=g0, acc_ld=ld0,
        steps=zero_i,
        done=~fbool,  # forces a start on iteration 0
        cur_x=x0, cur_m=zero_v, cur_g=g0, cur_ld=ld0,
        left_x=x0, left_m=zero_v, left_g=g0, left_ld=ld0,
        right_x=x0, right_m=zero_v, right_g=g0, right_ld=ld0,
        msum=zero_v, sub_msum=zero_v,
        prop_x=x0, prop_g=g0, prop_ld=ld0,
        prop_w=zero_s, prop_slpa=zero_s,
        sub_x=x0, sub_g=g0, sub_ld=ld0,
        sub_w=zero_s, sub_slpa=zero_s,
        h0=zero_s,
        direction=zero_s + 1.0,
        depth=zero_i, leaf=zero_i, nstates=zero_i,
        div=fbool, turn=fbool,
        grads=zero_s,
        ckpt_m=[zero_v] * max_depth,
        ckpt_s=[zero_v] * max_depth,
    )
    hist = torch.zeros(C, S, num_track, dtype=f32, device=dev)
    traces = torch.zeros(len(TRACE_COLS), trace, C, dtype=f32, device=dev) if trace else None

    def leaf_step(s, it):
        live = s["steps"] < S

        # ---- inline restart: chains that closed start the next one ----
        start = s["done"] & live
        base_c0 = (chain * S + s["steps"]) & MASK32  # per-(chain, step) id
        b1, b2 = threefry2x32(seed, KEY1, lanes[None, :], (1 << 24) | base_c0[:, None])
        u1, u2 = _to_unit(b1, 1.0), _to_unit(b2)
        # (sigma_m sqrt(-2 log u1)) cos(2 pi u2), the reference's association
        fresh_m = sigma_m * torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
        h0_new = -s["acc_ld"] + kinetic(fresh_m)
        for name, fresh in [
            ("cur_x", s["acc_x"]), ("cur_m", fresh_m), ("cur_g", s["acc_g"]),
            ("cur_ld", s["acc_ld"]),
            ("left_x", s["acc_x"]), ("left_m", fresh_m), ("left_g", s["acc_g"]),
            ("left_ld", s["acc_ld"]),
            ("right_x", s["acc_x"]), ("right_m", fresh_m), ("right_g", s["acc_g"]),
            ("right_ld", s["acc_ld"]),
            ("msum", fresh_m), ("sub_msum", fresh_m * 0.0),
            ("prop_x", s["acc_x"]), ("prop_g", s["acc_g"]), ("prop_ld", s["acc_ld"]),
            ("sub_x", s["acc_x"]), ("sub_g", s["acc_g"]), ("sub_ld", s["acc_ld"]),
            ("prop_w", zero_s), ("prop_slpa", neg_inf),
            ("sub_w", zero_s), ("sub_slpa", neg_inf),
            ("h0", h0_new),
            ("depth", zero_i), ("leaf", zero_i), ("nstates", zero_i),
        ]:
            s[name] = _sel(start, fresh, s[name])
        s["div"] = s["div"] & ~start
        s["turn"] = s["turn"] & ~start
        s["done"] = s["done"] & ~start
        active = ~s["done"] & live

        # ---- subtree start: direction draw, register reset ----
        at_start = (s["leaf"] == 0) & active
        u_dir = counter_uniforms(seed, base_c0, 2, s["depth"])
        one = torch.ones_like(u_dir)
        direction = torch.where(at_start, torch.where(u_dir < 0.5, -one, one), s["direction"])
        fwd = direction > 0.0
        cur_x = _sel(at_start, _sel(fwd, s["right_x"], s["left_x"]), s["cur_x"])
        cur_m = _sel(at_start, _sel(fwd, s["right_m"], s["left_m"]), s["cur_m"])
        cur_g = _sel(at_start, _sel(fwd, s["right_g"], s["left_g"]), s["cur_g"])

        # ---- one leapfrog (velocity Verlet, diagonal metric) ----
        d_eps = (direction * eps)[:, None]
        m_half = cur_m + 0.5 * d_eps * cur_g
        new_x = cur_x + d_eps * (imm * m_half)
        new_g = grad(new_x)
        new_m = m_half + 0.5 * d_eps * new_g
        new_ld = logdensity(new_x)

        energy = -new_ld + kinetic(new_m)
        delta = s["h0"] - energy
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        leaf_w = delta
        leaf_slpa = torch.minimum(delta, torch.zeros_like(delta))
        leaf_div = (-delta > divergence_threshold) & active

        # ---- subtree progressive (uniform) sampling ----
        u_leaf = counter_uniforms(seed, base_c0, 3, s["nstates"])
        take = (u_leaf < torch.sigmoid(leaf_w - s["sub_w"])) & active
        sub_x = _sel(at_start, new_x, _sel(take, new_x, s["sub_x"]))
        sub_g = _sel(at_start, new_g, _sel(take, new_g, s["sub_g"]))
        sub_ld = _sel(at_start, new_ld, _sel(take, new_ld, s["sub_ld"]))
        sub_w = _sel(at_start, leaf_w, _logaddexp(s["sub_w"], leaf_w))
        sub_slpa = _sel(at_start, leaf_slpa, _logaddexp(s["sub_slpa"], leaf_slpa))
        sub_msum = _sel(at_start, new_m, s["sub_msum"] + new_m)

        # ---- checkpoint slots ----
        leaf_i = s["leaf"]
        idx_max = popcount8(leaf_i >> 1)
        idx_min = idx_max - popcount8(((~leaf_i) & (leaf_i + 1)) - 1) + 1
        is_even = (leaf_i % 2) == 0
        subtree_turning = fbool
        ckpt_m, ckpt_s = [], []
        for i in range(max_depth):
            w_i = is_even & (idx_max == i) & active
            ckpt_m.append(_sel(w_i, new_m, s["ckpt_m"][i]))
            ckpt_s.append(_sel(w_i, sub_msum, s["ckpt_s"][i]))
            chk = (i >= idx_min) & (i <= idx_max) & ~is_even
            subtree_sum = sub_msum - ckpt_s[i] + ckpt_m[i]
            subtree_turning = subtree_turning | (chk & turning(ckpt_m[i], new_m, subtree_sum))
        subtree_turning = subtree_turning & active

        # ---- subtree boundary ----
        leaf_next = leaf_i + 1
        subtree_complete = leaf_next >= (torch.ones_like(leaf_i) << s["depth"])
        aborted = leaf_div | subtree_turning
        closing = (subtree_complete | aborted) & active
        msum = _sel(closing, s["msum"] + sub_msum, s["msum"])
        to_left, to_right = closing & ~fwd, closing & fwd
        ends = {}
        for side, pred in (("left", to_left), ("right", to_right)):
            for name, new in (("x", new_x), ("m", new_m), ("g", new_g), ("ld", new_ld)):
                ends[f"{side}_{name}"] = _sel(pred, new, s[f"{side}_{name}"])

        # trajectory-level proposal merge (biased toward the new subtree);
        # an aborted subtree contributes acceptance statistics only
        u_prop = counter_uniforms(seed, base_c0, 4, s["depth"])
        p_biased = torch.minimum(torch.exp(sub_w - s["prop_w"]), torch.ones_like(sub_w))
        take_traj = (u_prop < p_biased) & closing & ~aborted
        prop_x = _sel(take_traj, sub_x, s["prop_x"])
        prop_g = _sel(take_traj, sub_g, s["prop_g"])
        prop_ld = _sel(take_traj, sub_ld, s["prop_ld"])
        merged_pw = _logaddexp(s["prop_w"], sub_w)
        prop_w = _sel(closing, _sel(aborted, s["prop_w"], merged_pw), s["prop_w"])
        prop_slpa = _sel(closing, _logaddexp(s["prop_slpa"], sub_slpa), s["prop_slpa"])

        full_turn = closing & turning(ends["left_m"], ends["right_m"], msum)
        depth = torch.where(closing, s["depth"] + 1, s["depth"])
        leaf_out = torch.where(closing, zero_i, leaf_next)
        div = s["div"] | leaf_div
        turn = s["turn"] | (closing & (subtree_turning | full_turn))
        done_new = div | turn | (closing & (depth >= max_depth))
        nstates = torch.where(active, s["nstates"] + 1, s["nstates"])

        # ---- transition close: accept, count, record ----
        just_closed = active & done_new
        s["grads"] = s["grads"] + torch.where(just_closed, nstates.to(f32), 0.0)
        row = s["steps"].clamp(max=S - 1)  # history row of the closing step
        hist[chain, row] = _sel(just_closed, prop_x[:, :num_track], hist[chain, row])
        steps = torch.where(just_closed, s["steps"] + 1, s["steps"])

        if traces is not None and it < trace:
            cols = dict(
                start=start, at_start=at_start, direction=direction, depth=depth,
                leaf=leaf_out, delta=delta, u_leaf=u_leaf, take=take, sub_w=sub_w,
                u_prop=u_prop, take_traj=take_traj, prop_w=prop_w, closing=closing,
                done_new=done_new, energy=energy, h0=s["h0"], ltau=new_x[:, 0],
                aborted=aborted,
            )
            traces[:, it] = torch.stack([cols[k].to(f32) for k in TRACE_COLS])

        s.update(
            cur_x=new_x, cur_m=new_m, cur_g=new_g, cur_ld=new_ld,
            msum=msum, sub_msum=sub_msum,
            prop_x=prop_x, prop_g=prop_g, prop_ld=prop_ld,
            prop_w=prop_w, prop_slpa=prop_slpa,
            sub_x=sub_x, sub_g=sub_g, sub_ld=sub_ld,
            sub_w=sub_w, sub_slpa=sub_slpa,
            direction=direction, depth=depth, leaf=leaf_out, nstates=nstates,
            div=div, turn=turn, done=done_new | s["done"],
            steps=steps,
            acc_x=_sel(just_closed, prop_x, s["acc_x"]),
            acc_g=_sel(just_closed, prop_g, s["acc_g"]),
            acc_ld=_sel(just_closed, prop_ld, s["acc_ld"]),
            ckpt_m=ckpt_m, ckpt_s=ckpt_s, **ends,
        )

    for c0 in range(0, budget, chunk):
        if c0 >= trace and bool((s["steps"] >= S).all()):
            break
        for it in range(c0, c0 + chunk):
            leaf_step(s, it)
    return s["acc_x"], s["steps"].to(torch.int32), s["grads"], hist, traces


# ---------------------------------------------------------------------------
# the form's plan
# ---------------------------------------------------------------------------


def plan(d: int, target: int, trace: int = 0, form: str = None) -> str:
    """The form of a launch on ``d`` dimensions of the target ``target`` (a
    ``cuda_target`` id) with ``trace`` traced iterations.

    ``form=None`` takes the resident form where it applies (the
    hierarchical and Gaussian targets, ``trace == 0``) and the registers
    form elsewhere; ``"resident"`` and ``"registers"`` ask for one. A form
    that does not apply raises ``ValueError``; nothing falls back to another.
    The layout of each form (shared memory, scratch in device memory) is the
    kernel's: the launch reads its scratch from the library."""
    if form not in (None, *FORMS):
        raise ValueError(f"form must be None or one of {FORMS}, got {form!r}")
    if not 1 <= d <= _MAX_CUDA_DIM:
        raise ValueError(f"the CUDA machine holds 1 <= d <= {_MAX_CUDA_DIM} per warp; got d={d}")
    resident_fits = target in _ANALYTIC and trace == 0
    if form == "resident" and not resident_fits:
        raise ValueError(
            "the resident form runs the hierarchical and Gaussian targets without a trace; "
            f"got target {target}, trace={trace}")
    return "registers" if form == "registers" or not resident_fits else "resident"


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float


@functools.lru_cache(maxsize=1)
def _library():
    return _bind(_nvcc.load("fused_nuts"))


def _bind(lib):
    """Declare the C interface of a library of the machine (also for a copy
    built with other constants, as ``dc_kernel_ms.py`` builds them)."""
    lib.bjt_fused_nuts.argtypes = (
        [_VP] * 14 + [_INT] * 11 + [_FLOAT] * 4 + [ctypes.c_uint32, _VP])
    lib.bjt_fused_nuts.restype = _INT
    lib.bjt_fused_nuts_scratch_floats.argtypes = [_INT] * 3 + [_VP]
    lib.bjt_fused_nuts_scratch_floats.restype = _INT
    lib.bjt_fused_nuts_occupancy.argtypes = [_INT] * 4 + [_VP]
    lib.bjt_fused_nuts_occupancy.restype = _INT
    lib.bjt_error_string.argtypes = [_INT]
    lib.bjt_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (or load) the kernel library; returns the compiler's report of
    registers, shared memory and spills per kernel."""
    _library()
    return _nvcc.build_log("fused_nuts")


def _launch_cuda(x, imm, step_size, *, target, num_steps, max_depth, seed, num_track,
                 budget, chunk, divergence_threshold, trace, form=None):
    del chunk  # the kernel stops each chain on its own
    C, d = x.shape
    form = plan(d, target.cuda_target, trace, form)
    dev = x.device
    _nvcc.require_cuda_f32("positions", x, dev, (C, d))
    _nvcc.require_cuda_f32("inverse_mass_matrix", imm, dev, (d,))
    pos = imm > 0.0
    sigma_m = torch.sqrt(torch.where(pos, 1.0 / torch.where(pos, imm, 1.0), 0.0)).contiguous()
    inv_var, matrix, rows, k = _target_args(target, dev, d)
    lib = _library()
    out_x = torch.empty_like(x)
    out_steps = torch.empty(C, dtype=torch.int32, device=dev)
    out_grads = torch.empty(C, dtype=torch.float32, device=dev)
    hist = torch.zeros(C, num_steps, num_track, dtype=torch.float32, device=dev)
    # (C, trace, cols) per chain; the caller gets (cols, trace, C)
    out_trace = (torch.zeros(C, trace, len(TRACE_COLS), dtype=torch.float32, device=dev)
                 if trace else None)
    floats = (ctypes.c_longlong * 2)()  # a chain's cold vectors and checkpoint slots
    lib.bjt_fused_nuts_scratch_floats(d, int(form == "resident"), max_depth, floats)
    cold, slots = (torch.empty(C * n, dtype=torch.float32, device=dev) if n else None
                   for n in floats)
    code = lib.bjt_fused_nuts(
        x.data_ptr(), imm.data_ptr(), sigma_m.data_ptr(), *map(_ptr, (inv_var, *matrix)),
        out_x.data_ptr(), out_steps.data_ptr(), out_grads.data_ptr(), hist.data_ptr(),
        *map(_ptr, (out_trace, cold, slots)), C, d, num_steps, num_track, max_depth, budget,
        trace, target.cuda_target, rows, len(TRACE_COLS), int(form == "resident"),
        float(step_size), float(divergence_threshold), *k, seed, _nvcc.stream_handle(dev),
    )
    _nvcc.check_launch(lib, code, "fused_nuts")
    LAUNCHES["fused_nuts"] += 1
    LAUNCHES[f"fused_nuts:{form}"] += 1
    traces = None if out_trace is None else out_trace.permute(2, 1, 0)
    return out_x, out_steps, out_grads, hist, traces


def occupancy(d: int, resident: bool = True, target: int = 0, max_depth: int = 8) -> dict:
    """What the card reports for the analytic target's instantiation for
    ``d`` in the resident form or the registers form: its resident warps an
    SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), its registers
    and its local memory a thread in bytes (its stack frame and any spills).
    Needs the card."""
    out = (_INT * 3)()
    lib = _library()
    code = lib.bjt_fused_nuts_occupancy(d, target, int(resident), max_depth, out)
    _nvcc.check_launch(lib, code, "bjt_fused_nuts_occupancy")
    return {"warps_per_sm": out[0], "registers": out[1], "local_bytes": out[2]}


def _prepare(positions, inverse_mass_matrix, *, target, num_steps, max_num_doublings=8,
             seed=0, num_track=8, budget=None, chunk=64, divergence_threshold=1000.0, trace=0):
    """Validate as the reference does; return the f32 positions, the
    diagonal inverse mass matrix and the machine's arguments."""
    C, d = positions.shape
    if d != target.dim:
        raise ValueError(f"positions dim {d} != registered target dim {target.dim}")
    if num_track > d:
        raise ValueError(f"num_track={num_track} > dim {d}")
    if not -(2**31) <= int(seed) < 2**31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    if budget is None:
        # the reference's default: about twice the expected leaves per chain
        # at the benchmark geometry (~15 leaves a transition)
        budget = 32 * num_steps
    x = positions.to(torch.float32).contiguous()
    imm = torch.as_tensor(inverse_mass_matrix).to(device=x.device, dtype=torch.float32)
    machine = dict(
        target=target, num_steps=num_steps, max_depth=max_num_doublings,
        seed=int(seed) & MASK32, num_track=num_track, budget=_round_up(budget, chunk),
        chunk=chunk, divergence_threshold=divergence_threshold, trace=int(trace),
    )
    return x, torch.broadcast_to(imm, (d,)).contiguous(), machine


def _result(out, trace):
    acc_x, steps, grads, hist, traces = out
    result = (acc_x, hist, grads.sum(), steps)
    if trace:
        return result + ({name: t for name, t in zip(TRACE_COLS, traces)},)
    return result


def fused_nuts_run(
    positions,
    inverse_mass_matrix,
    step_size,
    *,
    target: TargetKernel,
    num_steps: int,
    max_num_doublings: int = 8,
    seed: int = 0,
    num_track: int = 8,
    tile_chains: int = 256,
    budget: int = None,
    chunk: int = 64,
    divergence_threshold: float = 1000.0,
    trace: int = 0,
    form: str = None,
):
    """Run ``num_steps`` NUTS transitions per chain.

    ``positions`` is ``(C, d)``, ``inverse_mass_matrix`` a diagonal ``(d,)``
    (or a scalar). Returns ``(final_positions (C, d), history (C,
    num_steps, num_track), total_grads (), steps (C,) int32)``, as the
    reference does; ``steps[c] < num_steps`` means the leaf ``budget``
    (default ``32 * num_steps``, rounded up to a multiple of ``chunk``) ran
    out before chain ``c`` finished. History records coordinates ``0 ..
    num_track - 1`` after each transition; rows never reached stay zero.
    With ``trace=N`` a fifth output maps each name of :data:`TRACE_COLS` to
    its ``(N, C)`` values over the first ``N`` iterations.

    A CUDA tensor launches the kernel (``d <= 256``, else ``ValueError``)
    in the form :func:`plan` picks, or in ``form`` (``"resident"`` or
    ``"registers"``) where it is given; a form that does not apply raises,
    on any device. A CPU tensor runs the plain version. ``tile_chains`` is
    ignored.
    """
    del tile_chains
    x, imm, machine = _prepare(
        positions, inverse_mass_matrix, target=target, num_steps=num_steps,
        max_num_doublings=max_num_doublings, seed=seed, num_track=num_track, budget=budget,
        chunk=chunk, divergence_threshold=divergence_threshold, trace=trace,
    )
    if form is not None:
        plan(x.shape[1], target.cuda_target, machine["trace"], form)
    if x.device.type == "cuda":
        return _result(_launch_cuda(x, imm, float(step_size), form=form, **machine), trace)
    if x.device.type == "cpu":
        return _result(_machine_plain(x, imm, float(step_size), **machine), trace)
    raise NotImplementedError(f"no machine for device type {x.device.type!r}")


def fused_nuts_run_plain(positions, inverse_mass_matrix, step_size, *, target, num_steps,
                         max_num_doublings=8, seed=0, num_track=8, tile_chains=256,
                         budget=None, chunk=64, divergence_threshold=1000.0, trace=0):
    """The plain PyTorch version of :func:`fused_nuts_run`, with the same
    arguments and outputs, on the device of ``positions``: on the card it is
    the kernel's reference. It launches nothing of ours and counts nothing."""
    del tile_chains
    x, imm, machine = _prepare(
        positions, inverse_mass_matrix, target=target, num_steps=num_steps,
        max_num_doublings=max_num_doublings, seed=seed, num_track=num_track, budget=budget,
        chunk=chunk, divergence_threshold=divergence_threshold, trace=trace,
    )
    return _result(_machine_plain(x, imm, float(step_size), **machine), trace)
