"""The fused MCLMC and leapfrog kernels on logistic regression at ``chip_smoke.py``
phase 9's shape, on the card: a parent tree's kernels against this tree's,
and this tree's tiles form for each number of chains a block and rows a tile.

Phase 9's inputs: the logistic regression of 4,096 x 54 (numpy seed 9,
prior scale 10), 4,096 chains from 0.05 N(0, I), MCLMC for 64 steps (step
size 0.01, L 0.3, the refresh on, seed 7; 8 tracked coordinates, where
phase 9 tracks all 54) and the leapfrog for 10 steps (step size 0.005),
drawn in phase 9's order.

``--parent DIR`` builds the CUDA sources of the tree under DIR
(``fused_mclmc.cu`` and ``fused_leapfrog.cu`` with their headers; a tree
from before the tiles form takes X and X^T from L2) beside this tree's, and
then:

- holds the analytic instantiations (F = 0) of both trees bit for bit: the
  MCLMC kernel at phase 7's inputs (the hierarchical target, d=100, 4,096
  chains x 64 steps, refresh on; a tree with the resident form launches it)
  and the leapfrog at phase 5's (10 steps);
- times both trees' kernels on logistic regression, interleaved (parent,
  change, change, parent, ... ``--repeats`` rounds), one launch of MCLMC and
  ten of the leapfrog by CUDA events each, and prints each time and the
  medians; each tree's outputs are held against the plain version first
  (1e-5, floors 0.9 and 0.99, as phase 9).

``--chains K ...`` and ``--rows R ...`` build copies of this tree's sources
(in a directory under the build directory; the sources are not touched)
with ``kFusedChainsLR = K`` and ``kFusedTileRowsLR = R`` for every pair and
time them in the same rounds, each held against the plain version.
``--sections`` builds one more copy, at this tree's K and R, with
``clock64()`` counters in ``logreg_tiles`` (lane 0 of each warp adds its
cycles to its own counters in device memory; the gradient's calls only):
it prints the cycles a warp spends per gradient in staging the positions,
waiting for a tile, the forward products, the elementwise part (the
sigmoids), the two barriers, the backward products and the final sums.

    python3 fused_logreg_tiles.py --parent _archive_check/parent
    python3 fused_logreg_tiles.py --chains 8 16 32 --rows 64 128 256 --sections

``--timing`` reads each tree's ten back-to-back launches three ways: CUDA
events around them, the host clock around their enqueueing (no
synchronize), and torch.profiler's kernel records (each kernel's duration
and the gap from its end to the next one's start), to tell a kernel's time
from the time between kernels. ``--dim D`` runs all of it on a logistic
regression of 4,096 x D (numpy seed 9) instead of 4,096 x 54.

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""
import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from chip_smoke import _ptxas_summary

LR_N, LR_D, C, D = 4096, 54, 4096, 100
MCLMC_STEPS, LEAPFROG_STEPS, NUM_TRACK, SEED = 64, 10, 8, 7
AGREE_TOL, MCLMC_FLOOR, LEAPFROG_FLOOR = 1e-5, 0.9, 0.99
HIERARCHICAL, LOGISTIC_REGRESSION = 0, 2
# the counters of --sections, in the order they are printed
SECTIONS = ("stage", "tile wait", "forward", "elementwise", "barrier 1", "backward",
            "barrier 2", "sums", "total", "calls")

_VP, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _edit(path, pairs, tail=""):
    text = path.read_text()
    for old, new in pairs:
        if old not in text:
            raise RuntimeError(f"{path.name}: anchor not found: {old.strip()[:60]}")
        text = text.replace(old, new, 1)
    path.write_text(text + tail)


def _add_sections(out):
    """clock64() counters in logreg_tiles of the copy in ``out``:
    g_lr[warp * 10 + i] for SECTIONS[i], lane 0 of each warp adding its own,
    in the gradient's calls only."""
    add = ("if (kSpell == kTilesGrad && (threadIdx.x & 31) == 0) "
           "g_lr[(blockIdx.x * blockDim.x + threadIdx.x) / 32 * 10 + {i}] += {v};")

    def mark(i):
        return "c1_ = clock64(); " + add.format(i=i, v="c1_ - c0_") + " c0_ = c1_;\n"

    _edit(out / "matrix_targets.cuh", [
        ("namespace {\n", "namespace {\n__device__ unsigned long long g_lr[1 << 16];\n"),
        ("  float yxw = 0.f, ww = 0.f;\n",
         "  long long c0_ = clock64(), c1_, cs_ = c0_;\n  float yxw = 0.f, ww = 0.f;\n"),
        ("  issue(0);\n", "  issue(0);\n  " + mark(0)),
        ("    __syncthreads();  // tile t has landed for every thread\n",
         "    __syncthreads();  // tile t has landed for every thread\n    " + mark(1)),
        ("      const bool real = t * R + r_f < rows;\n",
         "      " + mark(2) + "      const bool real = t * R + r_f < rows;\n"),
        ("    __syncthreads();  // the sigmoids are in st\n",
         "    " + mark(3) + "    __syncthreads();  // the sigmoids are in st\n    " + mark(4)),
        ("    __syncthreads();  // this half of the ring and st may be written again\n",
         "    " + mark(5) + "    __syncthreads();  // this half of the ring and st may be "
         "written again\n    " + mark(6)),
        ("  if constexpr (kSpell == kTilesValue) return",
         "  " + mark(7) + "  " + add.format(i=8, v="clock64() - cs_") + "\n  "
         + add.format(i=9, v="1") + "\n  if constexpr (kSpell == kTilesValue) return"),
    ])
    _edit(out / "fused_mclmc.cu", [], (
        '\nextern "C" int bjt_lr_sections(unsigned long long* host, int n) {\n'
        '  const int e = (int)cudaMemcpyFromSymbol(host, g_lr, n * sizeof(unsigned long long));\n'
        '  static unsigned long long zeros[1 << 16];\n'
        '  cudaMemcpyToSymbol(g_lr, zeros, sizeof(zeros));\n  return e;\n}\n'))


def _build(nvcc, src_dir, out, edits=None):
    """Both libraries of the sources in ``src_dir``, built in ``out`` (a
    copy, edited by ``edits(out)``): {name: (CDLL, ptxas report)}."""
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src_dir, out)
    if edits is not None:
        edits(out)

    def one(name):
        lib = out / f"{name}.so"
        proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib),
                               str(out / f"{name}.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc {out.name}/{name}:\n{proc.stderr[-3000:]}")
        return name, (ctypes.CDLL(str(lib)), proc.stdout + proc.stderr)

    with ThreadPoolExecutor(max_workers=2) as pool:
        return dict(pool.map(one, ("fused_mclmc", "fused_leapfrog")))


def _inputs(torch, dev, dim):
    """Phase 9's logistic regression (at ``dim`` columns) and chains, phase
    7's and phase 5's analytic inputs."""
    rng9 = np.random.default_rng(9)
    X = rng9.standard_normal((LR_N, dim)).astype(np.float32)
    y = (rng9.random(LR_N) < 1.0 / (1.0 + np.exp(-X @ rng9.standard_normal(dim))))
    rng9.standard_normal((512, 10))  # phase 9's eight-schools chains
    rng9.standard_normal((512, dim))  # phase 9's dc chains

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    lr = dict(X=X, y=y.astype(np.float32), x=t(0.05 * rng9.standard_normal((C, dim))),
              m=t(rng9.standard_normal((C, dim))), imm=t(rng9.uniform(0.5, 1.5, dim)))
    rng7 = np.random.default_rng(7)
    x7 = t(0.5 * rng7.standard_normal((C, D)))
    m7 = t(rng7.standard_normal((C, D)))
    hier7 = dict(x=x7, m=m7 / torch.linalg.vector_norm(m7, dim=1, keepdim=True),
                 imm=t(rng7.uniform(0.5, 1.5, D)))
    rng5 = np.random.default_rng(5)
    hier5 = dict(x=t(0.5 * rng5.standard_normal((C, D))), m=t(rng5.standard_normal((C, D))),
                 imm=t(rng5.uniform(0.5, 1.5, D)))
    return lr, hier7, hier5


class Tree:
    """A tree's two libraries and how to launch them: with the tiles form
    (X as tiles of the rows its library's layout gives, and y) or, for a
    tree from before it, the L2 form (X, X^T, y)."""

    def __init__(self, torch, dev, label, libs, lr_data):
        self.torch, self.dev, self.label = torch, dev, label
        self.mclmc, self.leapfrog = libs["fused_mclmc"][0], libs["fused_leapfrog"][0]
        self.tiles = hasattr(self.leapfrog, "bjt_fused_tiles_layout")
        X, y = lr_data
        if self.tiles:
            from blackjax_tpu_torch.ops.fused_leapfrog import TilesPlan
            from blackjax_tpu_torch.ops.fused_nuts_dc import _lr_tiles

            out = (ctypes.c_longlong * 3)()
            self.leapfrog.bjt_fused_tiles_layout.argtypes = [_INT, _VP]
            if self.leapfrog.bjt_fused_tiles_layout(X.shape[1], out):
                raise RuntimeError(f"{label}: no tiles form at d={X.shape[1]}")
            self.layout = TilesPlan(*out)
            self.matrix = (torch.from_numpy(_lr_tiles(X, self.layout.tile_rows)).to(dev),
                           torch.from_numpy(y).to(dev))
        else:
            Xd = torch.from_numpy(X).to(dev)
            self.matrix = (Xd, Xd.t().contiguous(), torch.from_numpy(y).to(dev))
        n_ptr = len(self.matrix)
        # a tree with the resident form takes the form after the refresh flag
        self.forms = hasattr(self.mclmc, "bjt_fused_mclmc_occupancy")
        self.mclmc.bjt_fused_mclmc.argtypes = (
            [_VP] * (9 + n_ptr) + [ctypes.POINTER(_FLOAT)] + [_INT] * (8 + self.forms)
            + [_FLOAT] * 4 + [ctypes.c_uint32, _VP])
        self.leapfrog.bjt_fused_leapfrog.argtypes = (
            [_VP] * (7 + n_ptr) + [_INT] * 5 + [_FLOAT] * 3 + [_VP])
        self.rows = X.shape[0]

    def _data(self, target):
        if target == LOGISTIC_REGRESSION:
            return [a.data_ptr() for a in self.matrix], self.rows, (0.01, -0.005)
        return [None] * len(self.matrix), 0, (0.0, 0.0)

    def run_mclmc(self, x, m, imm, eps, L, target, steps=MCLMC_STEPS):
        torch = self.torch
        matrix, rows, k = self._data(target)
        out = (torch.empty_like(x), torch.empty_like(m),
               torch.empty(C, dtype=torch.float32, device=self.dev),
               torch.empty((C, steps, NUM_TRACK), dtype=torch.float32, device=self.dev))
        track = torch.arange(NUM_TRACK, dtype=torch.int32, device=self.dev)
        from blackjax_tpu_torch.mcmc.integrators import mclachlan_coefficients

        coefs = (_FLOAT * len(mclachlan_coefficients))(*mclachlan_coefficients)
        code = self.mclmc.bjt_fused_mclmc(
            x.data_ptr(), m.data_ptr(), imm.data_ptr(), None, *matrix, track.data_ptr(),
            *(o.data_ptr() for o in out), coefs, len(mclachlan_coefficients), C, x.shape[1],
            steps, NUM_TRACK, target, rows, 1,
            *([int(target != LOGISTIC_REGRESSION)] if self.forms else []), eps, L, *k, SEED,
            torch.cuda.current_stream(self.dev).cuda_stream)
        if code:
            raise RuntimeError(f"{self.label}: MCLMC launch failed ({code})")
        return out

    def run_leapfrog(self, x, m, imm, eps, target):
        torch = self.torch
        matrix, rows, k = self._data(target)
        out = (torch.empty_like(x), torch.empty_like(m),
               torch.empty(C, dtype=torch.float32, device=self.dev))
        code = self.leapfrog.bjt_fused_leapfrog(
            x.data_ptr(), m.data_ptr(), imm.data_ptr(), None, *matrix,
            *(o.data_ptr() for o in out), C, x.shape[1], LEAPFROG_STEPS, target, rows, eps,
            k[0], k[1], torch.cuda.current_stream(self.dev).cuda_stream)
        if code:
            raise RuntimeError(f"{self.label}: leapfrog launch failed ({code})")
        return out


def _share(torch, kern, plain):
    close = torch.ones(C, dtype=torch.bool, device=kern[0].device)
    err = 0.0
    for a, b in zip(kern, plain):
        if not bool(torch.isfinite(a).all()):
            return 0.0, float("nan")
        ok = torch.isclose(a, b, rtol=AGREE_TOL, atol=AGREE_TOL)
        close &= ok.flatten(1).all(1) if ok.dim() > 1 else ok
        err = max(err, float((a - b).abs().max()))
    return float(close.float().mean()), err


def _ms(torch, fn, calls=1):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", default=None)
    parser.add_argument("--chains", type=int, nargs="*", default=[])
    parser.add_argument("--rows", type=int, nargs="*", default=[])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--sections", action="store_true")
    parser.add_argument("--dim", type=int, default=LR_D)
    parser.add_argument("--timing", action="store_true")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fused_logreg_tiles: no CUDA device visible", file=sys.stderr)
        return 1
    import importlib

    from blackjax_tpu_torch.ops import _nvcc

    lf = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
    fm = importlib.import_module("blackjax_tpu_torch.ops.fused_mclmc")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    lr, hier7, hier5 = _inputs(torch, dev, args.dim)

    # the builds, all started together
    variants = [("change", _nvcc._SRC_DIR, None)]
    for k in args.chains:
        for r in args.rows or [256]:
            def edits(out, k=k, r=r):
                path = out / "matrix_targets.cuh"
                text, n = re.subn(r"constexpr int kFusedChainsLR = \d+;",
                                  f"constexpr int kFusedChainsLR = {k};", path.read_text())
                text, m = re.subn(r"constexpr int kFusedTileRowsLR = \d+;",
                                  f"constexpr int kFusedTileRowsLR = {r};", text)
                if (n, m) != (1, 1):
                    raise RuntimeError("matrix_targets.cuh: kFusedChainsLR or kFusedTileRowsLR "
                                       "not found")
                path.write_text(text)
            variants.append((f"K={k} R={r}", _nvcc._SRC_DIR, edits))
    if args.parent:
        variants.insert(0, ("parent", Path(args.parent) / "blackjax_tpu_torch" / "csrc", None))
    if args.sections:
        variants.append(("sections", _nvcc._SRC_DIR, _add_sections))
    build_root = _nvcc.build_dir() / "fused_logreg_tiles"
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        builds = list(pool.map(
            lambda v: _build(_nvcc, v[1], build_root / v[0].replace(" ", "_").replace("=", ""),
                             v[2]), variants))
    trees = []
    for (label, _, _), libs in zip(variants, builds):
        report = [line for name, (_, log) in libs.items() for line in _ptxas_summary(log)
                  if " F=2" in line]
        tree = Tree(torch, dev, label, libs, (lr["X"], lr["y"]))
        layout = (f"{tree.layout.chains} chains a block, {tree.layout.tile_rows}-row tiles, "
                  f"{tree.layout.nbytes} B a block" if tree.tiles else "L2 form")
        print(f"{label} ({layout}): ptxas {'; '.join(report)} ({card})", flush=True)
        trees.append(tree)

    # the analytic instantiations, bit for bit between the trees
    change = trees[[t.label for t in trees].index("change")]
    if args.parent:
        parent = trees[0]
        same = {}
        for name, run in (
                ("MCLMC", lambda t: t.run_mclmc(hier7["x"], hier7["m"], hier7["imm"], 0.5, 5.0,
                                                HIERARCHICAL)),
                ("leapfrog", lambda t: t.run_leapfrog(hier5["x"], hier5["m"], hier5["imm"], 0.1,
                                                      HIERARCHICAL))):
            a, b = run(parent), run(change)
            same[name] = all(torch.equal(u, v) for u, v in zip(a, b))
        print(f"analytic instantiations (F = 0), parent against change bit for bit: MCLMC "
              f"(phase 7's inputs, {MCLMC_STEPS} steps, refresh on) {same['MCLMC']}, leapfrog "
              f"(phase 5's inputs, {LEAPFROG_STEPS} steps) {same['leapfrog']} ({card})",
              flush=True)

    # logistic regression: each tree against the plain version, then timed
    target = lf.make_logistic_regression_target(lr["X"], lr["y"])
    m_unit = lr["m"] / torch.linalg.vector_norm(lr["m"], dim=1, keepdim=True)
    fm_kw = dict(target=target, num_steps=MCLMC_STEPS, seed=SEED, track_dims=range(NUM_TRACK))
    plain_mclmc = fm.fused_mclmc_plain(lr["x"], m_unit, lr["imm"], 0.01, 0.3, **fm_kw)
    plain_leapfrog = lf.fused_leapfrog_plain(lr["x"], lr["m"], lr["imm"], 0.005, target=target,
                                             num_steps=LEAPFROG_STEPS)
    timed = [t for t in trees if t.label != "sections"]
    calls = {
        "MCLMC": lambda t: t.run_mclmc(lr["x"], m_unit, lr["imm"], 0.01, 0.3,
                                       LOGISTIC_REGRESSION),
        "leapfrog": lambda t: t.run_leapfrog(lr["x"], lr["m"], lr["imm"], 0.005,
                                             LOGISTIC_REGRESSION),
    }
    checks = {}
    for t in timed:
        mc = _share(torch, calls["MCLMC"](t), plain_mclmc)
        lp = _share(torch, calls["leapfrog"](t), plain_leapfrog)
        checks[t.label] = (mc, lp)
    times = {(t.label, name): [] for t in timed for name in calls}
    order = timed + timed[::-1]
    for _ in range(args.repeats):
        for t in order:
            times[(t.label, "MCLMC")].append(_ms(torch, lambda: calls["MCLMC"](t)))
            times[(t.label, "leapfrog")].append(_ms(torch, lambda: calls["leapfrog"](t), 10))
    for t in timed:
        (mc_share, mc_err), (lp_share, lp_err) = checks[t.label]
        ok = mc_share >= MCLMC_FLOOR and lp_share >= LEAPFROG_FLOOR
        form = "tiles form" if t.tiles else "L2 form"
        print(f"{t.label} ({form}): MCLMC {C} x {MCLMC_STEPS} steps "
              f"{', '.join(f'{v:.3f}' for v in times[(t.label, 'MCLMC')])} ms, median "
              f"{statistics.median(times[(t.label, 'MCLMC')]):.3f} ms, {mc_share:.4f} of chains "
              f"agree to {AGREE_TOL} (floor {MCLMC_FLOOR}), max |diff| {mc_err:.3g}; leapfrog "
              f"{C} x {LEAPFROG_STEPS} steps "
              f"{', '.join(f'{v:.4f}' for v in times[(t.label, 'leapfrog')])} ms, median "
              f"{statistics.median(times[(t.label, 'leapfrog')]):.4f} ms, {lp_share:.4f} agree "
              f"(floor {LEAPFROG_FLOOR}), max |diff| {lp_err:.3g}; gates "
              f"{'pass' if ok else 'FAIL'} ({card})", flush=True)

    if args.timing:
        import time

        from torch.profiler import ProfilerActivity, profile

        for t in timed:
            for name, kernel in (("MCLMC", "mclmc_kernel"), ("leapfrog", "leapfrog_kernel")):
                def ten():
                    for _ in range(10):
                        calls[name](t)

                ten()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                host0 = time.perf_counter()
                start.record()
                ten()
                end.record()
                host_ms = (time.perf_counter() - host0) * 1e3
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    ten()
                    torch.cuda.synchronize()
                runs = sorted((e for e in prof.events() if kernel in e.name),
                              key=lambda e: e.time_range.start)
                names = sorted({e.name[:60] for e in prof.events()})
                dur = [e.time_range.elapsed_us() / 1e3 for e in runs]
                gaps = [(b.time_range.start - a.time_range.end) / 1e3
                        for a, b in zip(runs, runs[1:])]
                print(f"timing {t.label} {name}: ten launches back to back, per launch: CUDA "
                      f"events {start.elapsed_time(end) / 10:.4f} ms, host enqueue "
                      f"{host_ms / 10:.4f} ms, torch.profiler {len(runs)} kernel records, mean "
                      f"duration {statistics.mean(dur) if dur else float('nan'):.4f} ms, mean gap "
                      f"to the next {statistics.mean(gaps) if gaps else float('nan'):.4f} ms; "
                      f"the trace's names {names[:4]} ({card})", flush=True)

    if args.sections:
        t = trees[-1]
        t.mclmc.bjt_lr_sections.argtypes = [_VP, _INT]
        counts = np.zeros(1 << 16, np.uint64)
        t.mclmc.bjt_lr_sections(counts.ctypes.data, counts.size)  # clears the counters
        calls["MCLMC"](t)
        torch.cuda.synchronize()
        t.mclmc.bjt_lr_sections(counts.ctypes.data, counts.size)
        per_warp = counts[:C * len(SECTIONS)].reshape(C, len(SECTIONS)).astype(np.float64)
        n_calls = per_warp[:, -1]
        cycles = (per_warp[:, :-1] / n_calls[:, None]).mean(0)
        print(f"sections, MCLMC {C} x {MCLMC_STEPS} steps at K={t.layout.chains} "
              f"R={t.layout.tile_rows} "
              f"({n_calls.mean():.0f} gradients a warp): cycles a warp spends per gradient: "
              + ", ".join(f"{name} {c:.0f}" for name, c in zip(SECTIONS, cycles))
              + f" ({card})", flush=True)
    shutil.rmtree(build_root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
