"""Builds the CUDA sources under ``blackjax_tpu_torch/csrc`` with ``nvcc`` into
a shared library with a plain C interface, loads it with ``ctypes``, and
holds what every kernel wrapper checks around a launch.

The build happens at first use, into the directory that the environment
variable ``BLACKJAX_TPU_TORCH_BUILD_DIR`` names, or by default into
``blackjax_tpu_torch/_build/`` (listed in ``.gitignore``); an installed
copy of the package whose directory is read-only sets the variable. Each
library's name is keyed on a hash of the source, the shared headers and the
flags, so an edited source or header is rebuilt and an unchanged one is
loaded as it is. The compiler's ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside the library and returned by
:func:`build_log`.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = [
    "BUILD_DIR_ENV", "NVCC_FLAGS", "build_dir", "load", "build_log", "check_launch",
    "require_cuda_f32", "stream_handle",
]

_PACKAGE = Path(__file__).resolve().parent.parent
_SRC_DIR = _PACKAGE / "csrc"
BUILD_DIR_ENV = "BLACKJAX_TPU_TORCH_BUILD_DIR"

# sm_90a: Hopper with its architecture-specific instructions. No fast math
# and no fused multiply-add contraction: the kernels round like their plain
# PyTorch versions (see the note at the top of each source).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels are built from source at first use on a machine with the "
            "CUDA toolkit"
        )
    return found


def build_dir() -> Path:
    """Where the libraries are built: ``$BLACKJAX_TPU_TORCH_BUILD_DIR``, or
    ``blackjax_tpu_torch/_build/`` where the variable is unset or empty."""
    return Path(os.environ.get(BUILD_DIR_ENV) or _PACKAGE / "_build")


def _paths(name: str):
    """The source, library and log paths of ``csrc/<name>.cu``. The
    library's name is keyed on the source, every ``csrc/*.cuh`` header (a
    source may include any of them) and the flags."""
    src = _SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = f"{name}-{digest.hexdigest()[:16]}"
    out = build_dir()
    return src, out / f"{stem}.so", out / f"{stem}.log"


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    src, lib, log = _paths(name)
    if not lib.exists():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True,
            text=True,
            check=False,
        )
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return ctypes.CDLL(str(lib))


def build_log(name: str) -> str:
    """The compiler's report from the build of ``csrc/<name>.cu``."""
    _, _, log = _paths(name)
    return log.read_text() if log.exists() else ""


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a library's launch function returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"{what} launch failed: {lib.bjt_error_string(code).decode()} ({code})"
        )


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_f32(name: str, t, device, shape) -> None:
    """A kernel argument must be a contiguous float32 tensor of ``shape`` on
    ``device``."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: expected float32 {shape} on {device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
