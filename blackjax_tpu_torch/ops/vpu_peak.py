"""The sustained FP32 element-update rate of the card: the roofline that the
port's bounds are read against.

Port of ``benchmarks/vpu_peak.py`` (its Pallas kernel ``_kernel``, run by
``_run``): ``iters`` updates of every element of an ``(rows, 128)`` float32
block, with ``b = a * 0.5`` and ``t = a * 0.25`` for a run-time scalar
``a``, in one of two modes,

- ``"fma"``: ``x = x * a + b``,
- ``"select"``: ``x = where(x > t, x * a + b, x + b)``,

and in one of two roundings of ``x * a + b``: fused (one rounding, the FMA
instruction) or unfused (a multiply and an add, each rounded: what the
port's kernels compute under ``--fmad=false``). Two implementations:

- the CUDA kernel ``csrc/vpu_peak.cu``, launched for CUDA tensors: each
  thread keeps ``lanes`` values in registers, a block is ``warps`` warps,
  and :func:`block_rows` sizes a block that gives one block to each SM;
  :data:`LAUNCHES` counts its launches;
- :func:`vpu_peak_plain`, the same loop in PyTorch ops, taken for CPU
  tensors and used on the card as the kernel's reference. Its fused form
  rounds once: the product of two float32 values is exact in float64, the
  sum is rounded to odd there (exact error by TwoSum, then the odd
  neighbour where the sum was inexact), and rounding that to float32 gives
  the correctly rounded ``fma`` (a float64 rounded to odd carries the 26
  bits that a float32 rounding needs).

:func:`updates_per_second` reads the rate the way the reference's
``measure`` does: a two-point slope (``iters`` against ``4 * iters``) over
distinct inputs, here timed by CUDA events.
"""
import ctypes
import functools

import torch

from blackjax_tpu_torch.ops import _nvcc

__all__ = [
    "COLS",
    "LANES",
    "LAUNCHES",
    "MODES",
    "block_rows",
    "build",
    "updates_per_second",
    "vpu_peak",
    "vpu_peak_plain",
]

COLS = 128
MODES = ("fma", "select")
LANES = (1, 2, 4, 8, 13, 16)  # values a thread: the kernel's instantiations
LAUNCHES = {"vpu_peak": 0}


def _check(x: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x.dim() != 2 or x.shape[1] != COLS or x.dtype != torch.float32:
        raise ValueError(f"x must be float32 (rows, {COLS}), got {x.dtype} {tuple(x.shape)}")


def _fma_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x * a + b`` rounded once to float32: the exact product in float64,
    the sum rounded to odd, then rounded to nearest float32."""
    product = x.double() * a.double()
    bd = b.double()
    total = product + bd
    b_part = total - product
    error = (product - (total - b_part)) + (bd - b_part)  # TwoSum: exactly (product + b) - total
    even = (total.view(torch.int64) & 1) == 0
    toward = torch.where(error > 0, float("inf"), float("-inf")).to(total.dtype)
    odd = torch.where((error != 0) & even, torch.nextafter(total, toward), total)
    return odd.float()


def vpu_peak_plain(x: torch.Tensor, a, iters: int, mode: str = "fma",
                   fused: bool = True) -> torch.Tensor:
    """``iters`` updates of ``x`` in PyTorch ops, on ``x``'s device: the
    reference's loop (``benchmarks/vpu_peak.py:41-54``) with ``x * a + b``
    rounded once (``fused``) or twice."""
    _check(x, mode)
    a = torch.as_tensor(a, dtype=torch.float32, device=x.device)
    b, t = a * 0.5, a * 0.25
    for _ in range(int(iters)):
        update = _fma_plain(x, a, b) if fused else x * a + b
        x = update if mode == "fma" else torch.where(x > t, update, x + b)
    return x


@functools.lru_cache(maxsize=1)
def _library():
    lib = _nvcc.load("vpu_peak")
    lib.bjt_vpu_peak.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                                 ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.bjt_vpu_peak.restype = ctypes.c_int
    lib.bjt_error_string.argtypes = [ctypes.c_int]
    lib.bjt_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (or load) the kernel library; returns the compiler's report of
    registers and spills per instantiation."""
    _library()
    return _nvcc.build_log("vpu_peak")


def _launch_cuda(x, a, iters, mode, fused, lanes, warps):
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    if not 1 <= warps <= 32:
        raise ValueError(f"warps must be in 1..32, got {warps}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    out = torch.empty_like(x)
    lib = _library()
    code = lib.bjt_vpu_peak(x.data_ptr(), out.data_ptr(), float(a), int(iters), x.numel(),
                            lanes, warps, int(fused), int(mode == "select"),
                            _nvcc.stream_handle(x.device))
    _nvcc.check_launch(lib, code, "vpu_peak")
    LAUNCHES["vpu_peak"] += 1
    return out


def vpu_peak(x: torch.Tensor, a, iters: int, mode: str = "fma", fused: bool = True, *,
             lanes: int = 4, warps: int = 32) -> torch.Tensor:
    """``x`` after ``iters`` updates (see the module's head). A CUDA tensor
    launches the kernel, ``lanes`` values a thread and ``warps`` warps a
    block; a CPU tensor runs :func:`vpu_peak_plain`."""
    _check(x, mode)
    if x.device.type == "cuda":
        return _launch_cuda(x, a, iters, mode, fused, lanes, warps)
    if x.device.type == "cpu":
        return vpu_peak_plain(x, a, iters, mode, fused)
    raise NotImplementedError(f"no vpu_peak for device type {x.device.type!r}")


def block_rows(sms: int, lanes: int, warps: int) -> int:
    """Rows of a block that gives each of ``sms`` SMs one block of
    ``warps`` warps, ``lanes`` values a thread."""
    elements = sms * warps * 32 * lanes
    if elements % COLS:
        raise ValueError(f"{elements} elements do not make whole rows of {COLS}")
    return elements // COLS


def updates_per_second(mode: str, fused: bool, lanes: int, warps: int, iters: int, *,
                       device, a: float = 0.999) -> float:
    """Sustained element-updates a second of one mode and rounding on the
    card, as the reference's ``measure`` reads them: a block of one block an
    SM, ``0.5 + 0.01 N(0, 1)`` (a distinct input for every call), a warm
    call at ``iters`` and ``4 * iters``, then the slope of the timed pair,
    ``3 * iters`` updates of every element over the difference of their
    CUDA-event times."""
    device = torch.device(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = block_rows(sms, lanes, warps)
    generator = torch.Generator(device=device).manual_seed(lanes * 64 + warps)
    xs = [0.5 + 0.01 * torch.randn((rows, COLS), generator=generator, device=device)
          for _ in range(4)]

    def timed(x, n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        vpu_peak(x, a, n, mode, fused, lanes=lanes, warps=warps)
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3

    timed(xs[0], iters)
    timed(xs[1], 4 * iters)
    short, long = timed(xs[2], iters), timed(xs[3], 4 * iters)
    if long <= short:
        raise RuntimeError(
            f"vpu_peak: {4 * iters} iterations took {long * 1e3:.4f} ms, {iters} took "
            f"{short * 1e3:.4f} ms: launch jitter hides the work; raise iters")
    return rows * COLS * 3 * iters / (long - short)
