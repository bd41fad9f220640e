"""The dc NUTS machine on logistic regression at ``chip_smoke.py`` phase 11's
shape, on the card, for each number of chains a block of the tiles form.

The target is phase 9's logistic regression (4,096 x 54, numpy seed 9, prior
scale 10). Its metric is the Laplace approximation at the posterior mode
(Newton's method in float64 on the host): the inverse Hessian as the dense
metric, its diagonal, or a rank-10 payload (the 10 eigenpairs of the
correlation matrix whose eigenvalues lie farthest from 1, in log scale).
1,024 chains start at the mode plus 0.01 N(0, I) (numpy seed 11) and run
256 transitions at ``max_num_doublings=8`` and a fixed step size of 0.45.

For each value of ``--chains`` it builds a copy of the tree's dc sources
with ``kChainsLR = K`` (in a directory under the build directory; the
sources are not touched), runs one untimed launch, then ``--repeats`` timed
launches by CUDA events, and prints one line per (K, metric): each time,
their median, leaves per transition, the lockstep's idle warp-iteration
share and the block's bytes of shared memory. A tree without the tiles form
(one from before it) runs once, with its own libraries, as "L2 form".

With ``--sections`` the copy also gets ``clock64()`` counters (lane 0 of
each warp adds them up in device memory; a few instructions per section and
tile) and each (K, metric) runs one launch and prints the cycles a warp
spends per gradient in the leaf loop, the block's gradient, and the
gradient's parts: waiting for a tile and the barrier after it, the forward
products, the sigmoid and softplus terms, the barrier before the backward
pass, the backward products, the barrier after it, and the rest (staging the
positions, the final sums).

    python3 logreg_dc_tiles.py --chains 4 8 16
    python3 logreg_dc_tiles.py --chains 8 --sections
    python3 logreg_dc_tiles.py --root _archive_check/parent

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""
import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_DATA, DIM, CHAINS, TRANSITIONS, DOUBLINGS, STEP, RANK = 4096, 54, 1024, 256, 8, 0.45, 10
# the counters of --sections, in the order they are printed
SECTIONS = ("loop", "gradient", "tile wait", "forward", "sigmoid/softplus", "barrier 1",
            "backward", "barrier 2", "calls")


def _problem():
    """Phase 9's data, the posterior mode and the Laplace covariance."""
    rng = np.random.default_rng(9)
    X = rng.standard_normal((N_DATA, DIM)).astype(np.float32)
    y = (rng.random(N_DATA) < 1.0 / (1.0 + np.exp(-X @ rng.standard_normal(DIM))))
    y = y.astype(np.float32)
    Xd, yd, w = X.astype(np.float64), y.astype(np.float64), np.zeros(DIM)
    for _ in range(30):
        p = 1.0 / (1.0 + np.exp(-Xd @ w))
        hess = (Xd * (p * (1 - p))[:, None]).T @ Xd + np.eye(DIM) / 100.0
        w = w + np.linalg.solve(hess, Xd.T @ (yd - p) - w / 100.0)
    return X, y, w, np.linalg.inv(hess)


def _metrics(cov, torch, dev):
    sigma = np.sqrt(np.diag(cov))
    lam, vec = np.linalg.eigh(cov / np.outer(sigma, sigma))
    keep = np.argsort(-np.abs(np.log(lam)))[:RANK]
    from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    return {"dense": t(cov), "diag": t(np.diag(cov)),
            "low_rank": LowRankInverseMassMatrix(t(sigma), t(vec[:, keep]), t(lam[keep]))}


def _edit(path, pairs, tail=""):
    text = path.read_text()
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"{path.name}: anchor not found: {old.strip()[:60]}")
        text = text.replace(old, new, 1)
    path.write_text(text + tail)


def _add_sections(out):
    """clock64() counters in the copy of the sources in ``out``: g_lr[warp *
    9 + i] for SECTIONS[i], lane 0 of each warp adding its own."""
    add = "if ((threadIdx.x & 31) == 0) g_lr[(blockIdx.x * blockDim.x + threadIdx.x) / 32 * 9 + {i}]"
    _edit(out / "matrix_targets.cuh", [
        ("namespace {\n", "namespace {\n__device__ unsigned long long g_lr[1 << 16];\n"),
        ("  for (int t = 0; t < n_tiles; ++t) {\n",
         "  for (int t = 0; t < n_tiles; ++t) {\n    long long c0_ = clock64(), c1_;\n"),
        ("    __syncthreads();  // tile t has landed for every thread\n",
         "    __syncthreads();  // tile t has landed for every thread\n    c1_ = clock64(); "
         + add.format(i=2) + " += c1_ - c0_; c0_ = c1_;\n"),
        ("      const bool real = t * R + r_f < rows;\n",
         "      c1_ = clock64(); " + add.format(i=3) + " += c1_ - c0_; c0_ = c1_;\n"
         "      const bool real = t * R + r_f < rows;\n"),
        ("    __syncthreads();  // the sigmoids are in st\n",
         "    c1_ = clock64(); " + add.format(i=4) + " += c1_ - c0_; c0_ = c1_;\n"
         "    __syncthreads();  // the sigmoids are in st\n    c1_ = clock64(); "
         + add.format(i=5) + " += c1_ - c0_; c0_ = c1_;\n"),
        ("    __syncthreads();  // this half of the ring and st may be written again\n",
         "    c1_ = clock64(); " + add.format(i=6) + " += c1_ - c0_; c0_ = c1_;\n"
         "    __syncthreads();  // this half of the ring and st may be written again\n"
         "    " + add.format(i=7) + " += clock64() - c0_;\n"),
    ], '\nextern "C" int bjt_lr_sections(unsigned long long* host, int n) {\n'
       '  const int e = (int)cudaMemcpyFromSymbol(host, g_lr, n * sizeof(unsigned long long));\n'
       '  static unsigned long long zeros[1 << 16];\n'
       '  cudaMemcpyToSymbol(g_lr, zeros, sizeof(zeros));\n  return e;\n}\n')
    leaf = ("    const float new_ld = value_and_grad<N, F, kSharedX>(p, new_x, new_g, lane, "
            "scratch, x_sh);\n")
    _edit(out / "fused_nuts_dc.cuh", [
        ("  int iters = 0;\n", "  int iters = 0;\n  const long long t_loop_ = clock64();\n"),
        (leaf, "    const long long t_g0_ = clock64();\n" + leaf +
         "    " + add.format(i=1) + " += clock64() - t_g0_;\n    " + add.format(i=8) + " += 1;\n"),
        ("  if (!present) return;\n",
         "  " + add.format(i=0) + " += clock64() - t_loop_;\n  if (!present) return;\n"),
    ])


def _build(dc, nvcc_mod, chains, kinds, sections=False):
    """The libraries of a copy of the tree's dc sources with kChainsLR =
    chains (and the counters of --sections)."""
    out = nvcc_mod.build_dir() / f"chains_lr_{chains}{'_sections' if sections else ''}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(nvcc_mod._SRC_DIR, out)
    _edit(out / "fused_nuts_dc.cuh", [("constexpr int kChainsLR = 8;",
                                       f"constexpr int kChainsLR = {chains};")])
    if sections:
        _add_sections(out)

    def one(kind):
        name = dc._LIBRARIES[kind]
        lib = out / f"{name}.so"
        if not lib.exists():
            proc = subprocess.run(
                [nvcc_mod._nvcc(), *nvcc_mod.NVCC_FLAGS, "-o", str(lib), str(out / f"{name}.cu")],
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc {name} K={chains}:\n{proc.stderr[-3000:]}")
        bound = dc._bind(ctypes.CDLL(str(lib)), kind)
        if sections:
            bound.bjt_lr_sections.argtypes = [ctypes.c_void_p, ctypes.c_int]
        return kind, bound

    with ThreadPoolExecutor(max_workers=len(kinds)) as pool:
        return dict(pool.map(one, kinds))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--chains", type=int, nargs="+", default=[8])
    parser.add_argument("--metrics", nargs="+", default=["dense", "low_rank", "diag"])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--label", default=None)
    parser.add_argument("--sections", action="store_true")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("logreg_dc_tiles: no CUDA device visible", file=sys.stderr)
        return 1
    from blackjax_tpu_torch.ops import _nvcc
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc
    from blackjax_tpu_torch.ops import targets_dc

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    X, y, mode, cov = _problem()
    target = targets_dc.make_logreg_target_dc(X, y)
    metrics = _metrics(cov, torch, dev)
    jitter = 0.01 * np.random.default_rng(11).standard_normal((CHAINS, DIM))
    x = torch.from_numpy((mode + jitter).astype(np.float32)).to(dev)
    kw = dict(target=target, num_steps=TRANSITIONS, max_num_doublings=DOUBLINGS, seed=7,
              num_track=8, budget=2**DOUBLINGS * TRANSITIONS)
    tiles = hasattr(dc, "_CHAINS_LR")
    label = args.label or args.root
    for chains in args.chains if tiles else [None]:
        if tiles:
            libs = _build(dc, _nvcc, chains, args.metrics, args.sections)
            dc._library = libs.__getitem__
            dc._CHAINS_LR = chains
        if args.sections:
            for kind in args.metrics:
                dc.fused_nuts_run_dc(x, metrics[kind], STEP, **kw)
                torch.cuda.synchronize()
                counts = np.zeros(1 << 16, np.uint64)
                libs[kind].bjt_lr_sections(counts.ctypes.data, counts.size)
                per_warp = counts[:CHAINS * len(SECTIONS)].reshape(CHAINS, len(SECTIONS))
                per_warp = per_warp.astype(np.float64)
                calls = per_warp[:, -1]
                cycles = (per_warp[:, :-1] / calls[:, None]).mean(0)
                print(f"{label} {kind} K={chains}: cycles a warp spends per gradient call "
                      f"({calls.mean():.0f} calls a warp): " + ", ".join(
                          f"{name} {c:.0f}" for name, c in zip(SECTIONS, cycles))
                      + f", the gradient's rest {cycles[1] - cycles[2:].sum():.0f} ({card})",
                      flush=True)
            continue
        for kind in args.metrics:
            imm = metrics[kind]
            dc.fused_nuts_run_dc(x, imm, STEP, **kw)
            times = []
            for _ in range(args.repeats):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _, _, grads, steps = dc.fused_nuts_run_dc(x, imm, STEP, **kw)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            leaves = float(grads) / (CHAINS * TRANSITIONS)
            form = "L2 form"
            if tiles:
                x32, metric, machine = dc._prepare(x, imm, **kw)
                out = dc._launch_cuda(x32, metric, STEP, **machine)
                idle = dc.lockstep_idle_share(out[1], out[4], TRANSITIONS, machine["budget"])
                rank = RANK if kind == "low_rank" else 0
                plan = dc.shared_memory_plan(2, dc._CUDA_LOGREG, kind, DOUBLINGS, N_DATA,
                                             DIM, rank)
                form = (f"K={chains}: idle warp-iterations {idle:.4f}, {plan.nbytes} B of shared "
                        f"memory a block (metric in it: {plan.metric_shared})")
            print(f"{label} {kind}: {', '.join(f'{t:.2f}' for t in times)} ms, median "
                  f"{statistics.median(times):.2f} ms, {leaves:.3f} leaves a transition, "
                  f"{int((steps == TRANSITIONS).sum())} of {CHAINS} chains complete; {form} "
                  f"({card})", flush=True)
    if tiles:
        for chains in args.chains:
            for suffix in ("", "_sections"):
                shutil.rmtree(_nvcc.build_dir() / f"chains_lr_{chains}{suffix}", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
