"""Where the dc NUTS machine's time goes on the Finnish horseshoe, on the card.

Runs ``fused_nuts_run_dc`` on the 100 x 200 horseshoe (d=404) at
``chip_smoke.py`` phase 10's settings (512 chains x 128 transitions,
``max_num_doublings=10``, ``pack=4``, ``restart_every=16``) from 0.05 N(0, I)
at a fixed step size of 1e-3 and a unit metric, once in each form of the
kernel (X copied into shared memory, the form the wrapper picks; X read from
L2, forced), timed by CUDA events, in the order shared, L2, shared.

Then it builds a copy of ``csrc/fused_nuts_dc.cu`` with ``clock64()``
counters around the leaf loop, the target's gradient and its two
contractions with X (the copy goes to a directory under the build directory;
the package's sources are not touched) and prints, for 512 chains x 16
transitions, each form's cycles per leaf in those sections, and the same for
horseshoes of 8 and 32 data rows (the slope over rows separates the forward
pass, paid per 32 x 4 rows, from the backward pass, paid per row). The
counters cost a few instructions per leaf.

    python3 horseshoe_dc_sections.py

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""
import ctypes
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _patch(src: Path) -> None:
    """Add the clock64 counters to the copy of the sources in ``src``."""
    def edit(name, pairs, tail):
        path = src / name
        text = path.read_text()
        for old, new in pairs:
            if old not in text:
                raise RuntimeError(f"{name}: anchor not found: {old.strip()[:60]}")
            text = text.replace(old, new, 1)
        path.write_text(text + tail)

    leaf = ("    const float new_ld = value_and_grad<N, F, kSharedX>(p, new_x, new_g, lane, "
            "scratch, x_sh);")
    edit("fused_nuts_dc.cuh", [
        ("namespace {\n", "namespace {\n__device__ unsigned long long g_sections[8192 * 2];\n"),
        ("  int iters = 0;\n", "  int iters = 0;\n  unsigned long long t_grad = 0;\n"
                               "  const long long t_loop = clock64();\n"),
        (leaf, "    const long long t_g0 = clock64();\n" + leaf +
               "\n    t_grad += clock64() - t_g0;"),
        ("    p.out_iters[chain] = iters;\n",
         "    p.out_iters[chain] = iters;\n    g_sections[chain * 2] = t_grad;\n"
         "    g_sections[chain * 2 + 1] = clock64() - t_loop;\n"),
    ], '\nextern "C" int bjt_sections(unsigned long long* host, int n) {\n'
       '  return (int)cudaMemcpyFromSymbol(host, g_sections, n * sizeof(unsigned long long));\n}\n')
    calls = ("row_pass_shared<H, R>(x_sh, m.rows, m.cols, bs, gs, gs, lane, row);",
             "row_pass<true>(m, bs, gs, lane, xtq, row);")
    edit("matrix_targets.cuh", [
        ("namespace {\n", "namespace {\n__device__ unsigned long long g_rows[8192];\n"),
        *(("    " + c, "    const long long t_r0 = clock64();\n    " + c +
           "\n    if (lane == 0) g_rows[blockIdx.x * 4 + (threadIdx.x >> 5)] += clock64() - t_r0;")
          for c in calls),
    ], '\nextern "C" int bjt_rows(unsigned long long* host, int n) {\n'
       '  const int e = (int)cudaMemcpyFromSymbol(host, g_rows, n * sizeof(unsigned long long));\n'
       '  static unsigned long long zeros[8192];\n'
       '  cudaMemcpyToSymbol(g_rows, zeros, sizeof(zeros));\n  return e;\n}\n')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("horseshoe_dc_sections: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from blackjax_tpu_torch.ops import _nvcc, targets_dc
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    lib = dc._library("diag")
    plan, library_of = dc.shared_memory_plan, dc._library

    def force_l2(n, family, metric, max_depth, rows=0, cols=0):
        p = plan(n, family, metric, max_depth, 0, 0)
        return dc.SharedMemoryPlan("l2", p.nbytes) if p.x_form else p

    def run(target, chains, steps, l2, library=None, **kw):
        x = torch.from_numpy((0.05 * np.random.default_rng(10).standard_normal(
            (chains, target.dim))).astype(np.float32)).to(dev)
        imm = torch.ones(target.dim, device=dev)
        kw = dict(target=target, num_steps=steps, max_num_doublings=10, seed=7, num_track=8,
                  **kw)
        dc.shared_memory_plan = force_l2 if l2 else plan
        if library is not None:
            dc._library = lambda kind="diag": library
        try:
            dc.fused_nuts_run_dc(x[:4], imm, 1e-3, **dict(kw, num_steps=1))
            if library is not None:  # reset the row counters after the first launch
                drained = np.zeros(8192, np.uint64)
                library.bjt_rows(drained.ctypes.data, drained.size)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = dc.fused_nuts_run_dc(x, imm, 1e-3, **kw)
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)
        finally:
            dc.shared_memory_plan, dc._library = plan, library_of

    hs = targets_dc.make_finnish_horseshoe_target_dc()
    for l2 in (False, True, False):
        (_, _, grads, steps), ms = run(hs, 512, 128, l2, pack=4, restart_every=16, chunk=256,
                                       budget=1600 * 128 * 4)
        print(f"512 x 128, X {'from L2' if l2 else 'in shared memory'}: {ms:.1f} ms, "
              f"{float(grads):.0f} grads ({float(grads) / (512 * 128):.1f} leaves a transition), "
              f"all chains complete: {bool((steps == 128).all())}", flush=True)

    out_dir = _nvcc.build_dir() / "sections"
    shutil.rmtree(out_dir, ignore_errors=True)
    shutil.copytree(_nvcc._SRC_DIR, out_dir / "csrc")
    _patch(out_dir / "csrc")
    t0 = time.perf_counter()
    built = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(out_dir / "sections.so"),
                            str(out_dir / "csrc" / "fused_nuts_dc.cu")],
                           capture_output=True, text=True)
    if built.returncode:
        print(built.stderr[-4000:], file=sys.stderr)
        return 1
    print(f"built the counted copy in {time.perf_counter() - t0:.1f} s", flush=True)
    counted = ctypes.CDLL(str(out_dir / "sections.so"))
    counted.bjt_fused_nuts_dc.argtypes = lib.bjt_fused_nuts_dc.argtypes
    counted.bjt_fused_nuts_dc.restype = ctypes.c_int
    counted.bjt_error_string.argtypes = [ctypes.c_int]
    counted.bjt_error_string.restype = ctypes.c_char_p
    counted.bjt_sections.argtypes = counted.bjt_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for rows, l2 in ((100, False), (100, True), (8, False), (32, False)):
        target = hs if rows == 100 else targets_dc.make_finnish_horseshoe_target_dc(rows, 200)
        (_, _, grads, _), ms = run(target, 512, 16, l2, library=counted, budget=1100 * 16)
        sections = np.zeros(8192 * 2, np.uint64)
        counted.bjt_sections(sections.ctypes.data, sections.size)
        row_cycles = np.zeros(8192, np.uint64)
        counted.bjt_rows(row_cycles.ctypes.data, row_cycles.size)
        leaves = float(grads) / 512
        grad, loop = (sections[i:2 * 512:2].astype(float).mean() / leaves for i in (0, 1))
        contraction = row_cycles[:512].astype(float).mean() / leaves
        print(f"{rows} x 200, X {'from L2' if l2 else 'in shared memory'}, 512 x 16: {ms:.1f} ms, "
              f"{leaves / 16:.1f} leaves a transition; cycles a leaf: loop {loop:.0f}, gradient "
              f"{grad:.0f} (contractions {contraction:.0f}, the rest {grad - contraction:.0f}), "
              f"machine {loop - grad:.0f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
