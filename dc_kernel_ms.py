"""Milliseconds of one ``fused_nuts_run_dc`` launch on the card, for the copy of
``blackjax_tpu_torch`` found under ROOT (default: this file's directory).

Targets: ``flagship``, the 100-dim hierarchical Gaussian at phase 4's shape
in ``chip_smoke.py`` (4,096 chains x 256 transitions, ``max_num_doublings=8``)
at step size 0.15; ``horseshoe``, the 100 x 200 Finnish horseshoe at phase
10's settings (512 chains x 128 transitions, ``max_num_doublings=10``,
``pack=4``, ``restart_every=16``) at step size 1e-3; both from 0.05 (the
horseshoe) or 0.5 (the flagship) N(0, I) of numpy seed 1 and a unit metric;
``gaussian_dense`` and ``gaussian_low_rank``, phase 11's Gaussian pairs (d=100,
4,096 chains x 16 transitions, ``max_num_doublings=8``, step size 0.3, the
correlated dense metric or the rank-10 payload of numpy seed 12, from the
positions drawn after them).
After one untimed launch it times REPEATS launches by CUDA events and
prints one line: each time, their median, the gradient total and the card.

To compare two trees on one host, unpack the other tree into a directory
that ``.gitignore`` lists and run both roots in turn in one call, e.g.
``parent change change parent``::

    python3 dc_kernel_ms.py --root _archive_check/parent --target flagship

``--steps S`` and ``--step-size E`` run the flagship for S transitions at step
size E (phase 3's shape: 16 at 0.2). ``--inputs FILE`` runs the flagship on
phase 4's own start instead (the warm start's positions, step size and
metric, made by this file's ``chip_smoke.warm_start`` where FILE does not
exist yet, about 80 s, and saved; ``--machine older`` reads the same file). ``--dim D`` runs the flagship's
hierarchical Gaussian, or the Gaussian of the
dense and low-rank pairs (with a rank of min(10, D - 1)), at width D instead
of 100. On a tree with the resident form of the analytic targets, ``--form
registers`` forces the form that keeps one warp's state in registers (the only
form before it) and ``--form resident`` the resident form, at every width;
``--warps W ...`` builds a copy of the tree's diagonal dc source for each W
with the resident form's launch bound set to W warps an SM at every width
(``resident_warps`` in ``csrc/fused_nuts_dc.cuh``) and times each in turn;
``--block-warps B ...`` does the same for the resident form's warps a block
(``kResidentBlockWarps``), for each pair with ``--warps``. The line gives the
form launched and, where the tree can say, the instantiation's warps an SM,
registers and local memory.

``--sections`` (the flagship) builds a copy of the tree's diagonal dc source
with ``clock64()`` counters in the leaf loop of the kernel that the tree
launches for the flagship (the copy goes to a directory under the build
directory; the sources are not touched). Lane 0 of each warp adds the cycles
it spends in each part of a leaf to its chain's counters in device memory:
the gradient; the leapfrog and the energy; the merge within the subtree (its
threefry draw and its transcendentals); the U-turn checks against the
checkpoint slots; the subtree boundary (the biased merge, its draw and the
full-tree check); and the rest (restart, subtree start, transition close,
the loop). Each warp also records ``%globaltimer`` and ``%smid`` when it
starts and when it ends. It prints, for the timed launch of the copy: the
cycles a leaf in each part (all chains' cycles over all their leaves); the
share of the SMs' time, between the kernel's first start and its last end,
in which an SM held fewer than half the warps it can hold (the tail), and
the mean share of those warps it held; the per-chain iterations (max, p99,
mean); the instantiation's registers, spills and resident blocks an SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), beside the launch's
time without the counters. The counters cost a load, an add and a store
per part and leaf, and they keep the compiler from moving work across the
parts' borders. Last, chain 0 runs alone (one warp on the card), once
with the counters (its cycles a leaf by part) and once without: its time
over its iterations is a leaf's latency with no other warp beside it, the
least a chain's leaf can take in this kernel.

``--target eight_schools`` times phase 15's launch: the tracked
eight-schools configuration (512 chains x 800 transitions,
``max_num_doublings=10``, ``pack=4``, ``restart_every=16``, a budget of 160 x
800 x 4, all 10 coordinates tracked) from 0.1 N(0, I) of numpy seed 15 at
``--step-size`` and a unit metric, or with ``--inputs FILE`` on phase 15's
own start (the adapted step size and metric, made by this file's
``chip_smoke.eight_schools_start`` where FILE does not exist yet, about a
minute, and saved). It runs the form the tree's plan picks, or ``--form
thread`` (one chain a thread, where the tree has it) or ``--form
registers`` (one chain a warp), and prints each time, the median, the
per-chain iterations, the form's occupancy and a SHA-256 of every output
(positions, steps, gradients, history, iterations). ``--sections`` counts
the form's leaf by part as for the flagship (the thread form: each thread
its own chain, a warp's span from its chains'), and chain 0 alone.

``--machine older`` times the older NUTS machine instead: one
``fused_nuts_run`` launch (``csrc/fused_nuts.cu``) at phase 13's shape
(4,096 chains x 256 transitions, ``max_num_doublings=8``, a budget of 112 x
256 leaves, ``chunk=256``) on the flagship's positions and step size. Each
line also gives a SHA-256 of the outputs' bytes (final positions, history,
gradient total, steps), so that ``parent change change parent`` in one call
shows both the time and the bits. ``--form``, ``--warps`` and ``--sections``
work as for the dc machine, on ``csrc/fused_nuts.cu`` (a tree without the
resident form runs the registers form, and its sections count that form's
leaf loop); the per-chain iterations come from the counters (one leaf an
iteration). ``--inputs FILE`` runs it on phase 13's own inputs instead of
0.5 N(0, I) at ``--step-size``: phase 4's final positions, step size and
metric, loaded from FILE, or, where FILE does not exist yet, made by the
root's ``chip_smoke.warm_start`` (about 80 s on the card) and saved there,
so that the first run of a ``parent change change parent`` call, given the
change's root, makes them once for all four.

``--machine mclmc`` times the fused MCLMC kernel instead: one
``fused_mclmc`` launch (``csrc/fused_mclmc.cu``) on the flagship at phase
8's shape (4,096 chains x 1,000 steps, McLachlan's stages, 8 tracked dims,
seed 7), from phase 7's inputs (numpy seed 7, step size 0.5, L 5; ``--dim``
for another width, ``--steps`` for another depth), or with ``--inputs FILE``
on phase 8's own: the state after its five ``mclmc`` transitions, its tuned
L, step size and metric, made by ``chip_smoke.mclmc_start`` where FILE does
not exist yet. Each line gives the times, the form, the warps an SM,
registers, local memory and steps a pool where the tree can say, the ptxas
line, and a SHA-256 of the outputs (x, m, log density, history).
``--root``, ``--form`` and ``--warps W ...`` (copies whose resident form is
built for W warps an SM, ``mclmc_resident_warps``; ``--block-warps B ...``
for ``mclmc_block_warps``) work as for the machines above. ``--sections``
counts the launched form's step by part (the refresh draws, the refresh
norms, the kicks, the drifts with their gradients, the history, the rest;
cycles a step over all steps of all chains), with the warps' starts and ends
(how many warps started after the first one ended: a second wave), the
occupancy, and chain 0 alone with and without the counters. ``--sass``
builds the tree's source with ``-lineinfo`` into a cubin, writes its SASS
(``nvdisasm``) under ``chiprun_out/mclmc_sass/`` and prints a step's
warp-instructions of the launched form's flagship instantiation by part and
by pipe (integer, FP32, MUFU, conversions, shuffles), cold slow paths left
out, and the issue floor they set at an SM's issue rates.

``--machine hmc`` runs phase 6's HMC path of ``chip_smoke.py`` for the tree
under ``--root``: ``fused_hmc`` on the flagship, 1,000 transitions of 4,096
chains from phase 6's warm start (``--inputs FILE`` saves it, or loads it
where FILE exists, with the generator's state, so that every tree of a call
draws the same numbers). It prints the first run (its build and the history's
allocations included), then REPEATS runs, each with its time by CUDA events
and by the host clock, its launches and a SHA-256 of the tracked history and
the accept rates; the min-ESS of the last run; with ``--history FILE`` the
share of chains whose history equals the one saved in FILE (saved there by
the first tree that runs); a SHA-256 of phase 5's ``fused_leapfrog`` outputs;
and one transition's device records and time by torch.profiler.
``--sections`` counts the transition kernel's cycles by part (the prologue,
a step's kicks and drift, its gradient, the epilogue) at phase 5's shape for
both targets, with the warps' spans and chain 0 alone; ``--block-warps B
...`` builds a copy of the tree's source for each B warps a block
(``kTransitionBlockWarps``) and prints each copy's device time, whether its
outputs are the tree's bits and its agreement with the plain version.
"""
import argparse
import ctypes
import hashlib
import os
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the parts of a leaf that --sections counts, in the order they are printed
SECTIONS = ("gradient", "leapfrog and energy", "merge", "U-turn checks", "subtree boundary",
            "rest")


def _edit(path, pairs, tail=""):
    text = path.read_text()
    for old, new in pairs:
        if text.count(old) != 1:
            raise RuntimeError(f"{path.name}: anchor found {text.count(old)} times: "
                               f"{old.strip()[:70]}")
        text = text.replace(old, new, 1)
    path.write_text(text + tail)


_HEAD = r"""namespace {
__device__ unsigned long long g_sec[8192 * 8];
__device__ unsigned long long g_span[8192 * 3];
__device__ __forceinline__ unsigned long long sec_now() { return clock64(); }
__device__ __forceinline__ void sec_add(int chain, int i, unsigned long long& t) {
  const unsigned long long c = clock64();
  if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + i] += c - t;
  t = c;
}
// the thread form's: each thread counts its own chain
__device__ __forceinline__ void sec_add_t(int chain, int i, unsigned long long& t) {
  const unsigned long long c = clock64();
  g_sec[chain * 8 + i] += c - t;
  t = c;
}
__device__ __forceinline__ void sec_span_t(int chain, int at) {
  unsigned long long ns;
  unsigned int sm;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  g_span[chain * 3 + at] = ns;
  g_span[chain * 3 + 2] = sm;
}
__device__ __forceinline__ void sec_span(int chain, int at) {
  unsigned long long ns;
  unsigned int sm;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  if ((threadIdx.x & 31) == 0) {
    g_span[chain * 3 + at] = ns;
    g_span[chain * 3 + 2] = sm;
  }
}
"""

_TAIL = r"""
extern "C" int bjt_sections(unsigned long long* sec, unsigned long long* span, int n) {
  int e = (int)cudaMemcpyFromSymbol(sec, g_sec, n * 8 * sizeof(unsigned long long));
  if (!e) e = (int)cudaMemcpyFromSymbol(span, g_span, n * 3 * sizeof(unsigned long long));
  static unsigned long long zeros[8192 * 8];
  if (!e) e = (int)cudaMemcpyToSymbol(g_sec, zeros, sizeof(zeros));
  return e;
}
"""

# the leaf loop of the form of one warp's state in registers (every tree up
# to PR 9's): the anchors below are its lines
_REGISTERS = [
    ("  int iters = 0;\n", "  int iters = 0;\n  unsigned long long t_ = sec_now();\n"),
    ("    // ---- one velocity-Verlet leaf ----\n",
     "    sec_add(chain, 5, t_);\n    // ---- one velocity-Verlet leaf ----\n"),
    ("    const float new_ld = value_and_grad<N, F, kSharedX>(p, new_x, new_g, lane, scratch, "
     "x_sh);\n",
     "    sec_add(chain, 1, t_);\n"
     "    const float new_ld = value_and_grad<N, F, kSharedX>(p, new_x, new_g, lane, scratch, "
     "x_sh);\n    sec_add(chain, 0, t_);\n"
     "    if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + 6] += 1;\n"),
    ("    // ---- progressive uniform merge within the subtree ----\n",
     "    sec_add(chain, 1, t_);\n    // ---- progressive uniform merge within the subtree ----\n"),
    ("    // ---- checkpointed subtree U-turn (termination.py:37-43) ----\n",
     "    sec_add(chain, 2, t_);\n"
     "    // ---- checkpointed subtree U-turn (termination.py:37-43) ----\n"),
    ("    // ---- subtree boundary: merge into the trajectory ----\n",
     "    sec_add(chain, 3, t_);\n    // ---- subtree boundary: merge into the trajectory ----\n"),
    ("    // ---- transition close ----\n",
     "    sec_add(chain, 4, t_);\n    // ---- transition close ----\n"),
    ("    if (chain >= p.C) return;  // the whole warp leaves together\n",
     "    if (chain >= p.C) return;  // the whole warp leaves together\n"
     "    sec_span(chain, 0);\n"),
    ("  if (!present) return;\n", "  sec_add(chain, 5, t_);\n  if (!present) return;\n"
                                  "  sec_span(chain, 1);\n"),
]

# the resident form's leaf loop (nuts_dc_resident)
_RESIDENT = [
    ("  int iters = 0;  // resident\n",
     "  int iters = 0;  // resident\n  unsigned long long t_ = sec_now();\n"),
    ("    // ---- one velocity-Verlet leaf (resident) ----\n",
     "    sec_add(chain, 5, t_);\n    // ---- one velocity-Verlet leaf (resident) ----\n"),
    ("    const float new_ld = analytic_value_and_grad<N, T>(p, x, g, lane);\n",
     "    sec_add(chain, 1, t_);\n"
     "    const float new_ld = analytic_value_and_grad<N, T>(p, x, g, lane);\n"
     "    sec_add(chain, 0, t_);\n"
     "    if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + 6] += 1;\n"),
    ("    // ---- the energy and the U-turn checks' sums (resident) ----\n",
     "    sec_add(chain, 1, t_);\n"
     "    // ---- the energy and the U-turn checks' sums (resident) ----\n"),
    ("    // ---- progressive uniform merge within the subtree (resident) ----\n",
     "    sec_add(chain, 3, t_);\n"
     "    // ---- progressive uniform merge within the subtree (resident) ----\n"),
    ("    // ---- subtree boundary: merge into the trajectory (resident) ----\n",
     "    sec_add(chain, 2, t_);\n"
     "    // ---- subtree boundary: merge into the trajectory (resident) ----\n"),
    ("    // ---- transition close (resident) ----\n",
     "    sec_add(chain, 4, t_);\n    // ---- transition close (resident) ----\n"),
    ("  if (chain >= p.C) return;  // resident\n",
     "  if (chain >= p.C) return;  // resident\n  sec_span(chain, 0);\n"),
    ("  // ---- final state (resident) ----\n",
     "  sec_add(chain, 5, t_);\n  sec_span(chain, 1);\n  // ---- final state (resident) ----\n"),
]

# the thread form's leaf loop (nuts_dc_thread): each thread counts its chain
_THREAD = [
    ("  int iters = 0;  // thread\n",
     "  int iters = 0;  // thread\n  unsigned long long t_ = sec_now();\n"),
    ("    // ---- one velocity-Verlet leaf (thread) ----\n",
     "    sec_add_t(chain, 5, t_);\n    // ---- one velocity-Verlet leaf (thread) ----\n"),
    ("    const float new_ld = eight_schools_thread(u, s, x, g);\n",
     "    sec_add_t(chain, 1, t_);\n    const float new_ld = eight_schools_thread(u, s, x, g);\n"
     "    sec_add_t(chain, 0, t_);\n    g_sec[chain * 8 + 6] += 1;\n"),
    ("    // ---- progressive uniform merge within the subtree (thread) ----\n",
     "    sec_add_t(chain, 1, t_);\n"
     "    // ---- progressive uniform merge within the subtree (thread) ----\n"),
    ("    // ---- checkpointed subtree U-turn (thread) ----\n",
     "    sec_add_t(chain, 2, t_);\n    // ---- checkpointed subtree U-turn (thread) ----\n"),
    ("    // ---- subtree boundary: merge into the trajectory (thread) ----\n",
     "    sec_add_t(chain, 3, t_);\n"
     "    // ---- subtree boundary: merge into the trajectory (thread) ----\n"),
    ("    // ---- transition close (thread) ----\n",
     "    sec_add_t(chain, 4, t_);\n    // ---- transition close (thread) ----\n"),
    ("  if (chain >= p.C) return;  // thread\n",
     "  if (chain >= p.C) return;  // thread\n  sec_span_t(chain, 0);\n"),
    ("  // ---- final state (thread) ----\n",
     "  sec_add_t(chain, 5, t_);\n  sec_span_t(chain, 1);\n  // ---- final state (thread) ----\n"),
]

# the form's own occupancy query, appended where the tree has no export
_PARENT_OCCUPANCY = r"""
extern "C" int bjt_dc_occupancy(int d, int target, int form, int max_depth, int* out) {
  (void)d; (void)target; (void)form;
  const auto k = nuts_dc_kernel<4, 0, kDiag, false>;
  const size_t smem = block_bytes<4, 0, kDiag, false>(max_depth, 0, 0, 0, false);
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, k);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kWarps * 32, smem);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[0] *= kWarps;
  return e;
}
"""


def _sections_copy(nvcc, dc, form=None):
    """Build the counted copy of the tree's diagonal dc source, with the
    counters in the leaf loop of ``form`` (``"registers"``, ``"resident"``
    or ``"thread"``; by default the resident form where the tree has one);
    returns the bound library and its ptxas report."""
    out = nvcc.build_dir() / "dc_sections"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(nvcc._SRC_DIR, out)
    header = out / "fused_nuts_dc.cuh"
    text = header.read_text()
    if form is None:
        form = "resident" if "nuts_dc_resident" in text else "registers"
    anchors = {"registers": _REGISTERS, "resident": _RESIDENT, "thread": _THREAD}[form]
    _edit(header, [("namespace {\n", _HEAD)] + anchors)
    _edit(out / "fused_nuts_dc.cu", [],
          _TAIL + ("" if "bjt_dc_occupancy" in text else _PARENT_OCCUPANCY))
    lib_path = out / "fused_nuts_dc_sections.so"
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib_path),
                           str(out / "fused_nuts_dc.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc, the counted copy:\n{proc.stderr[-4000:]}")
    lib = dc._bind(ctypes.CDLL(str(lib_path)), "diag")
    lib.bjt_sections.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.bjt_dc_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib, proc.stdout + proc.stderr


def _warps_copy(nvcc, dc, warps, block_warps):
    """The bound diagonal library of a copy of the tree's dc sources whose
    resident form holds ``warps`` warps an SM at every width and
    ``block_warps`` a block (None: the tree's own)."""
    out = nvcc.build_dir() / f"dc_warps_{warps}_{block_warps}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(nvcc._SRC_DIR, out)
    header = out / "fused_nuts_dc.cuh"
    text = header.read_text()
    for value, pattern, line in (
            (warps, r"constexpr int resident_warps\(\) \{ return [^;]*; \}",
             f"constexpr int resident_warps() {{ return {warps}; }}"),
            (block_warps, r"constexpr int kResidentBlockWarps = \d+;",
             f"constexpr int kResidentBlockWarps = {block_warps};")):
        if value is not None:
            text, count = re.subn(pattern, line, text)
            if count != 1:
                raise RuntimeError(f"fused_nuts_dc.cuh: {pattern} not found")
    header.write_text(text)
    lib_path = out / "fused_nuts_dc.so"
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib_path),
                           str(out / "fused_nuts_dc.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc, {warps} warps an SM, {block_warps} a block:\n"
                           f"{proc.stderr[-4000:]}")
    return dc._bind(ctypes.CDLL(str(lib_path)), "diag")


def _eight_schools(args, torch, card, label):
    """--target eight_schools: phase 15's launch of chip_smoke.py (512 chains
    x 800 transitions, max_num_doublings 10, pack 4, restart_every 16, a
    budget of 160 x 800 x 4, all 10 coordinates tracked), in the form the
    tree's plan picks or ``--form``."""
    import chip_smoke
    from blackjax_tpu_torch.ops import _nvcc, targets_dc
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    dev = torch.device("cuda")
    target = targets_dc.make_eight_schools_target_dc()
    to_dc = targets_dc.eight_schools_dc_perm()[0]
    x = torch.from_numpy((0.1 * np.random.default_rng(15).standard_normal((512, 10)))[:, to_dc]
                         .astype(np.float32)).to(dev)
    step, imm = args.step_size, torch.ones(10, device=dev)
    if args.inputs:
        if not os.path.exists(args.inputs):
            x, step, imm, *_ = _own_chip_smoke().eight_schools_start(torch, dev)
            torch.save({"positions": x.cpu(), "step_size": float(step),
                        "inverse_mass_matrix": imm.cpu()}, args.inputs)
        saved = torch.load(args.inputs)
        x, imm = (saved[k].to(dev) for k in ("positions", "inverse_mass_matrix"))
        step = saved["step_size"]
        print(f"{label} eight_schools: phase 15's inputs from {args.inputs}: {tuple(x.shape)}, "
              f"step size {step:.6f}, mean metric {float(imm.mean()):.6f}", flush=True)
    kw = dict(target=target, num_steps=800, max_num_doublings=10, seed=7, num_track=10, pack=4,
              restart_every=16, chunk=256, budget=160 * 800 * 4)
    has_thread = hasattr(dc, "_EIGHT_SCHOOLS_THREAD")
    form = args.form or ("thread" if has_thread and dc._EIGHT_SCHOOLS_THREAD else "registers")
    if form == "resident" or (form == "thread" and not has_thread):
        raise SystemExit(f"{label}: no {form} form for eight schools in this tree")
    if has_thread:
        dc._EIGHT_SCHOOLS_THREAD = form == "thread"
    x32, metric, machine = dc._prepare(x, imm, **kw)

    def launch(xs=x32):
        return dc._launch_cuda(xs, metric, float(step), **machine)

    def occupancy():
        """(warps an SM or None, the words for it)"""
        if not has_thread:
            return None, "occupancy not exported by this tree"
        o = dc.occupancy(10, target=dc._CUDA_EIGHT_SCHOOLS, max_depth=10,
                         form=2 if form == "thread" else 0)
        return o["warps_per_sm"], (f"{o['warps_per_sm']} warps an SM, {o['registers']} "
                                   f"registers, {o['local_bytes']} B local a thread")

    def iterations(iters):
        it = iters.double().cpu().numpy()
        return f"max {it.max():.0f}, p99 {np.percentile(it, 99):.0f}, mean {it.mean():.1f}"

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    launch()
    if args.sections:
        lib, log = _sections_copy(_nvcc, dc, form)
        _, plain_ms = chip_smoke._timed(torch, launch)

        def counted(xs):
            """One counted launch: per-chain outputs, cycles a leaf by part,
            the chains' spans, the leaves and the milliseconds."""
            library = dc._library
            dc._library = lambda kind="diag": lib
            try:
                launch(xs)
                sec = np.zeros(8192 * 8, np.uint64)
                span = np.zeros(8192 * 3, np.uint64)
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))  # drains them
                out, ms = chip_smoke._timed(torch, lambda: launch(xs))
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))
            finally:
                dc._library = library
            sec = sec[:len(xs) * 8].reshape(len(xs), 8).astype(np.float64)
            per_leaf = sec[:, :len(SECTIONS)].sum(0) / sec[:, 6].sum()
            return out, per_leaf, span[:len(xs) * 3].reshape(len(xs), 3), sec[:, 6].sum(), ms

        def parts(per_leaf):
            return (", ".join(f"{n} {c:.0f}" for n, c in zip(SECTIONS, per_leaf))
                    + f", total {per_leaf.sum():.0f}")

        out, per_leaf, span, leaves, ms = counted(x32)
        if form == "thread":  # a warp's span: its first chain's start to its last one's end
            warps = span.reshape(-1, 32, 3)
            span = np.stack([warps[..., 0].min(1), warps[..., 1].max(1), warps[:, 0, 2]], 1)
        warps_sm, occ = occupancy()
        tail = "tail not measured (no occupancy export)"
        if warps_sm:
            below, held, span_ms, n_sm = _tail(span, warps_sm)
            tail = (f"tail: {below:.4f} of SM-time between the first start and the last end "
                    f"({span_ms:.3f} ms on {n_sm} SMs) with fewer than {warps_sm // 2} warps "
                    f"resident, mean {held:.4f} of {warps_sm} warps held")
        ptxas = [s for s in chip_smoke._ptxas_summary(log) if "F=4 M=0" in s or "thread" in s]
        print(f"{label} eight_schools sections ({form} form): launch {plain_ms:.3f} ms without "
              f"the counters, {ms:.3f} ms with them; cycles a leaf: {parts(per_leaf)}; "
              f"{leaves:.0f} leaves, all chains complete: {bool((out[1] == 800).all())}; {tail}; "
              f"iterations a chain: {iterations(out[4])}; {occ}; ptxas "
              f"{'; '.join(ptxas)} ({card})", flush=True)
        (_, _, _, _, iters1), lone_parts, _, _, lone_counted_ms = counted(x32[:1])
        launch(x32[:1])
        _, lone_ms = chip_smoke._timed(torch, lambda: launch(x32[:1]))
        n1 = float(iters1[0])
        for what, ms1 in (("without the counters", lone_ms), ("with them", lone_counted_ms)):
            ns = ms1 * 1e6 / n1
            print(f"{label} eight_schools, chain 0 alone {what}: {n1:.0f} iterations in "
                  f"{ms1:.3f} ms, {ns:.0f} ns a leaf ({ns * mhz / 1e3:.0f} cycles at {mhz:.0f} "
                  f"MHz) ({card})", flush=True)
        print(f"{label} eight_schools, chain 0 alone: cycles a leaf: {parts(lone_parts)}",
              flush=True)
        shutil.rmtree(_nvcc.build_dir() / "dc_sections", ignore_errors=True)
        return 0
    before = dict(dc.LAUNCHES)
    out = launch()
    times = []
    for _ in range(args.repeats):
        out, ms = chip_smoke._timed(torch, launch)
        times.append(ms)
    forms = ",".join(k.split(":", 1)[1] for k, v in dc.LAUNCHES.items()
                     if ":" in k and v != before[k])
    h = hashlib.sha256()
    for t in out:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    print(f"{label} eight_schools ({form} form): {', '.join(f'{t:.3f}' for t in times)} ms, "
          f"median {statistics.median(times):.3f} ms, {float(out[2].sum()):.0f} grads, "
          f"launched as {forms}, all chains complete: {bool((out[1] == 800).all())}, "
          f"iterations a chain: {iterations(out[4])}; {occupancy()[1]}; outputs (x, steps, "
          f"grads, history, iterations) sha256 {h.hexdigest()[:16]} ({card})", flush=True)
    return 0


def _occupancy(lib, resident, d=100):
    """(warps an SM, registers, local bytes a thread) of the flagship's
    instantiation (width d, max_depth 8) in the given form."""
    out = np.zeros(3, np.int32)
    code = lib.bjt_dc_occupancy(d, 0, int(resident), 8, out.ctypes.data)
    if code:
        raise RuntimeError(f"occupancy query failed ({code})")
    return tuple(int(v) for v in out)


def _tail(span, warps_per_sm):
    """The share of SM-time between the first start and the last end in
    which an SM held fewer than half of ``warps_per_sm`` warps, and the mean
    share of ``warps_per_sm`` it held, from per-warp (start ns, end ns,
    SM)."""
    start, end, sm = span[:, 0].astype(np.int64), span[:, 1].astype(np.int64), span[:, 2]
    t0, t1 = int(start.min()), int(end.max())
    sms = np.unique(sm)
    below, held = 0, 0
    for s in sms:
        on = sm == s
        times = np.concatenate([start[on], end[on]])
        steps = np.concatenate([np.ones(on.sum(), np.int64), -np.ones(on.sum(), np.int64)])
        order = np.argsort(times, kind="stable")
        times, count = np.append(times[order], t1), np.cumsum(steps[order])
        edges = np.concatenate([[t0], times])
        count = np.concatenate([[0], count])
        width = np.diff(edges)
        below += int(width[count < warps_per_sm / 2].sum())
        held += int((width * count).sum())
    total = len(sms) * (t1 - t0)
    return below / total, held / (total * warps_per_sm), (t1 - t0) / 1e6, len(sms)


# the older machine's leaf loops (csrc/fused_nuts.cu): the registers form
# (every tree) and the resident form (nuts_resident)
_OLDER_REGISTERS = [
    ("  for (int it = 0; it < p.budget; ++it) {\n",
     "  unsigned long long t_ = sec_now();\n  for (int it = 0; it < p.budget; ++it) {\n"),
    ("    // ---- one velocity-Verlet leaf ----\n",
     "    sec_add(chain, 5, t_);\n    // ---- one velocity-Verlet leaf ----\n"),
    ("    target_grad<N, F>(p, new_x, iv, new_g, lane, scratch);\n",
     "    sec_add(chain, 1, t_);\n    target_grad<N, F>(p, new_x, iv, new_g, lane, scratch);\n"
     "    sec_add(chain, 0, t_);\n    if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + 6] += 1;\n"),
    ("    // ---- progressive uniform merge within the subtree ----\n",
     "    sec_add(chain, 1, t_);\n    // ---- progressive uniform merge within the subtree ----\n"),
    ("    // ---- checkpointed subtree U-turn (termination.py:37-43) ----\n",
     "    sec_add(chain, 2, t_);\n"
     "    // ---- checkpointed subtree U-turn (termination.py:37-43) ----\n"),
    ("    // ---- subtree boundary: merge into the trajectory ----\n",
     "    sec_add(chain, 3, t_);\n    // ---- subtree boundary: merge into the trajectory ----\n"),
    ("    // ---- transition close ----\n",
     "    sec_add(chain, 4, t_);\n    // ---- transition close ----\n"),
    ("  if (chain >= p.C) return;  // the whole warp leaves together\n",
     "  if (chain >= p.C) return;  // the whole warp leaves together\n  sec_span(chain, 0);\n"),
    ("    copy<N>(cur_x, new_x); copy<N>(cur_m, new_m); copy<N>(cur_g, new_g);\n  }\n",
     "    copy<N>(cur_x, new_x); copy<N>(cur_m, new_m); copy<N>(cur_g, new_g);\n  }\n"
     "  sec_add(chain, 5, t_);\n  sec_span(chain, 1);\n"),
]

_OLDER_RESIDENT = [
    ("  for (int it = 0; it < p.budget; ++it) {  // resident\n",
     "  unsigned long long t_ = sec_now();\n"
     "  for (int it = 0; it < p.budget; ++it) {  // resident\n"),
    ("    // ---- one velocity-Verlet leaf (resident) ----\n",
     "    sec_add(chain, 5, t_);\n    // ---- one velocity-Verlet leaf (resident) ----\n"),
    ("    const float ld_part = resident_grad<N, T>(p, x, iv, g, lane);\n",
     "    sec_add(chain, 1, t_);\n"
     "    const float ld_part = resident_grad<N, T>(p, x, iv, g, lane);\n"
     "    sec_add(chain, 0, t_);\n"
     "    if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + 6] += 1;\n"),
    ("    // ---- the energy and the U-turn checks' sums (resident) ----\n",
     "    sec_add(chain, 1, t_);\n"
     "    // ---- the energy and the U-turn checks' sums (resident) ----\n"),
    ("    // ---- progressive uniform merge within the subtree (resident) ----\n",
     "    sec_add(chain, 3, t_);\n"
     "    // ---- progressive uniform merge within the subtree (resident) ----\n"),
    ("    // ---- subtree boundary: merge into the trajectory (resident) ----\n",
     "    sec_add(chain, 2, t_);\n"
     "    // ---- subtree boundary: merge into the trajectory (resident) ----\n"),
    ("    // ---- transition close (resident) ----\n",
     "    sec_add(chain, 4, t_);\n    // ---- transition close (resident) ----\n"),
    ("  if (chain >= p.C) return;  // resident\n",
     "  if (chain >= p.C) return;  // resident\n  sec_span(chain, 0);\n"),
    ("  // ---- final state (resident) ----\n",
     "  sec_add(chain, 5, t_);\n  sec_span(chain, 1);\n  // ---- final state (resident) ----\n"),
]

# the registers form's occupancy, appended where the tree has no export
_OLDER_PARENT_OCCUPANCY = r"""
extern "C" int bjt_fused_nuts_occupancy(int d, int target, int form, int max_depth, int* out) {
  (void)d; (void)target; (void)form;
  const auto k = nuts_kernel<4, 0, false>;
  const size_t smem = (size_t)kWarps * (2 * max_depth * 4 * 32 + scratch_floats<4>()) * 4;
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, k);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kWarps * 32, smem);
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[0] *= kWarps;
  return e;
}
"""


def _older_copy(nvcc, fn, tag, sections=None, warps=None):
    """The bound library of a copy of the tree's ``csrc/fused_nuts.cu``: with
    ``clock64()`` counters in the leaf loop of the form ``sections``
    (``"resident"`` or ``"registers"``), or with the resident form's launch
    bound set to ``warps`` warps an SM at every width. Returns the library
    and its ptxas report."""
    out = nvcc.build_dir() / f"older_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(nvcc._SRC_DIR, out)
    src = out / "fused_nuts.cu"
    text = src.read_text()
    if warps is not None:
        text, count = re.subn(r"constexpr int resident_warps\(\) \{ return [^;]*; \}",
                              f"constexpr int resident_warps() {{ return {warps}; }}", text)
        if count != 1:
            raise RuntimeError("fused_nuts.cu: resident_warps not found")
        src.write_text(text)
    if sections:
        loop = _OLDER_RESIDENT if sections == "resident" else _OLDER_REGISTERS
        _edit(src, [("namespace {\n", _HEAD)] + loop,
              _TAIL + ("" if "bjt_fused_nuts_occupancy" in text else _OLDER_PARENT_OCCUPANCY))
    lib_path = out / "fused_nuts.so"
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc, the copy {tag}:\n{proc.stderr[-4000:]}")
    lib = ctypes.CDLL(str(lib_path))
    if hasattr(fn, "_bind"):
        fn._bind(lib)
    else:  # a tree before the resident form: its one C interface
        lib.bjt_fused_nuts.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                                       + [ctypes.c_float] * 4 + [ctypes.c_uint32, ctypes.c_void_p])
        lib.bjt_fused_nuts.restype = ctypes.c_int
        lib.bjt_error_string.argtypes = [ctypes.c_int]
        lib.bjt_error_string.restype = ctypes.c_char_p
    lib.bjt_fused_nuts_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    if sections:
        lib.bjt_sections.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib, proc.stdout + proc.stderr


def _digest(out):
    """SHA-256 of the outputs' bytes: final positions, history, gradient
    total, steps."""
    h = hashlib.sha256()
    for t in out[:4]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _older(args, torch, card, label):
    """--machine older: the older machine at phase 13's shape."""
    from blackjax_tpu_torch.ops import _nvcc
    from blackjax_tpu_torch.ops import fused_nuts as fn

    import chip_smoke

    dev = torch.device("cuda")
    d, chains, step = args.dim, 4096, args.step_size
    x = torch.from_numpy((0.5 * np.random.default_rng(1).standard_normal(
        (chains, d))).astype(np.float32)).to(dev)
    imm = torch.ones(d, device=dev)
    if args.inputs:
        if not os.path.exists(args.inputs):
            positions, step, imm, *_ = chip_smoke.warm_start(torch, dev)
            torch.save({"positions": positions.cpu(), "step_size": float(step),
                        "inverse_mass_matrix": imm.cpu()}, args.inputs)
        saved = torch.load(args.inputs)
        x, imm = (saved[k].to(dev) for k in ("positions", "inverse_mass_matrix"))
        step, (chains, d) = saved["step_size"], x.shape
        print(f"{label} older: phase 13's inputs from {args.inputs}: {chains} x {d}, step size "
              f"{step:.6f}, mean metric {float(imm.mean()):.6f}", flush=True)
    kw = dict(target=fn.make_mxu_safe_hierarchical_target(d), num_steps=args.steps,
              max_num_doublings=8, seed=7, num_track=8, budget=112 * args.steps, chunk=256)
    has_forms = hasattr(fn, "plan")
    if args.form is not None:
        if not has_forms and args.form == "resident":
            raise SystemExit(f"{label}: this tree has no resident form")
        if has_forms:
            kw["form"] = args.form
    form = fn.plan(d, 0, 0, kw.get("form")) if has_forms else "registers"

    def launch(xs=x, **extra):
        return fn.fused_nuts_run(xs, imm, step, **kw, **extra)

    def occupancy(lib):
        out = np.zeros(3, np.int32)
        code = lib.bjt_fused_nuts_occupancy(d, 0, int(form == "resident"), 8, out.ctypes.data)
        if code:
            raise RuntimeError(f"occupancy query failed ({code})")
        return tuple(int(v) for v in out)

    launch()
    if args.sections:
        lib, log = _older_copy(_nvcc, fn, "sections", sections=form)
        warps_sm, regs, local = occupancy(lib)
        (_, _, _, _), plain_ms = chip_smoke._timed(torch, launch)

        def counted(xs):
            library = fn._library
            fn._library = lambda: lib
            try:
                launch(xs)
                sec = np.zeros(8192 * 8, np.uint64)
                span = np.zeros(8192 * 3, np.uint64)
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))  # drains them
                out, ms = chip_smoke._timed(torch, lambda: launch(xs))
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))
            finally:
                fn._library = library
            sec = sec[:len(xs) * 8].reshape(len(xs), 8).astype(np.float64)
            per_leaf = sec[:, :len(SECTIONS)].sum(0) / sec[:, 6].sum()
            return out, per_leaf, span[:len(xs) * 3].reshape(len(xs), 3), sec[:, 6], ms

        def parts(per_leaf):
            return (", ".join(f"{n} {c:.0f}" for n, c in zip(SECTIONS, per_leaf))
                    + f", total {per_leaf.sum():.0f}")

        out, per_leaf, span, leaves, ms = counted(x)
        below, held, span_ms, n_sm = _tail(span, warps_sm)
        ptxas = [s for s in chip_smoke._ptxas_summary(log) if "N=4" in s and "F=2" not in s]
        print(f"{label} older sections ({form} form): launch {plain_ms:.2f} ms without the "
              f"counters, {ms:.2f} ms with them; cycles a leaf: {parts(per_leaf)}; "
              f"{leaves.sum():.0f} leaves, all chains complete: "
              f"{bool((out[3] == args.steps).all())}; tail: {below:.4f} of SM-time between the "
              f"first start and the last end ({span_ms:.2f} ms on {n_sm} SMs) with fewer than "
              f"{warps_sm // 2} warps resident, mean {held:.4f} of {warps_sm} warps held; "
              f"iterations a chain: max {leaves.max():.0f}, p99 {np.percentile(leaves, 99):.0f}, "
              f"mean {leaves.mean():.1f}; occupancy {warps_sm} warps an SM, {regs} registers, "
              f"{local} B local a thread; ptxas {'; '.join(ptxas)} ({card})", flush=True)
        _, lone_parts, _, lone_leaves, lone_counted_ms = counted(x[:1])
        launch(x[:1])
        _, lone_ms = chip_smoke._timed(torch, lambda: launch(x[:1]))
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        n1 = float(lone_leaves[0])
        for what, ms1 in (("without the counters", lone_ms), ("with them", lone_counted_ms)):
            ns = ms1 * 1e6 / n1
            print(f"{label} older, chain 0 alone {what}: {n1:.0f} iterations in {ms1:.2f} ms, "
                  f"{ns:.0f} ns a leaf ({ns * mhz / 1e3:.0f} cycles at {mhz:.0f} MHz); the "
                  f"slowest chain's {leaves.max():.0f} iterations at that rate: "
                  f"{leaves.max() * ns / 1e6:.2f} ms ({card})", flush=True)
        print(f"{label} older, chain 0 alone: cycles a leaf: {parts(lone_parts)}", flush=True)
        shutil.rmtree(_nvcc.build_dir() / "older_sections", ignore_errors=True)
        return 0
    runs = [(None, None)]
    if args.warps:  # one nvcc a copy, all started together
        with ThreadPoolExecutor(max_workers=len(args.warps)) as pool:
            libs = pool.map(lambda w: _older_copy(_nvcc, fn, f"warps_{w}", warps=w)[0], args.warps)
            runs = list(zip(args.warps, libs))
    library = fn._library
    for warps, lib in runs:
        if lib is not None:  # the launch and its scratch follow the copy
            fn._library = lambda lib=lib: lib
        launch()
        times = []
        for _ in range(args.repeats):
            out, ms = chip_smoke._timed(torch, launch)
            times.append(ms)
        occ = ""
        if has_forms:
            w, r, loc = occupancy(fn._library())
            occ = f", {w} warps an SM, {r} registers, {loc} B local a thread"
        name = label + ("" if lib is None else f" ({warps} warps an SM)")
        print(f"{name} older d={d}: {', '.join(f'{t:.2f}' for t in times)} ms, median "
              f"{statistics.median(times):.2f} ms, {float(out[2]):.0f} grads, form {form}{occ}, "
              f"outputs sha256 {_digest(out)} ({card})", flush=True)
        if lib is not None:
            fn._library = library
            shutil.rmtree(_nvcc.build_dir() / f"older_warps_{warps}", ignore_errors=True)
    return 0


# the parts of an MCLMC step that --machine mclmc --sections counts, and
# that --sass attributes the step loop's instructions to
MCLMC_SECTIONS = ("refresh draws", "refresh norms", "kicks", "drifts and gradients", "history",
                  "rest")

# counters in the registers form's step loop (mclmc_kernel; every tree):
# ou_refresh takes the counter and the chain, so that its draws and its norm
# count apart
_MCLMC_REGISTERS = [
    ("                                           float nu, int lane) {\n  float noisy[N];\n",
     "                                           float nu, int lane, unsigned long long& t_,\n"
     "                                           int chain) {\n  float noisy[N];\n"),
    ("  const float norm = nan_max(row_norm<N>(noisy), 1e-30f);\n"
     "#pragma unroll\n  for (int k = 0; k < N; ++k) m[k] = noisy[k] / norm;\n}\n",
     "  sec_add(chain, 0, t_);\n  const float norm = nan_max(row_norm<N>(noisy), 1e-30f);\n"
     "#pragma unroll\n  for (int k = 0; k < N; ++k) m[k] = noisy[k] / norm;\n"
     "  sec_add(chain, 1, t_);\n}\n"),
    ("    if (p.refresh) ou_refresh<N>(p, m, row_base, 2u * (uint32_t)s, nu, lane);\n",
     "    if (p.refresh) ou_refresh<N>(p, m, row_base, 2u * (uint32_t)s, nu, lane, t_, chain);\n"),
    ("    if (p.refresh) ou_refresh<N>(p, m, row_base, 2u * (uint32_t)s + 1u, nu, lane);\n",
     "    if (p.refresh) ou_refresh<N>(p, m, row_base, 2u * (uint32_t)s + 1u, nu, lane, t_, "
     "chain);\n"),
    ("  target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);\n"
     "  for (int s = 0; s < p.num_steps; ++s) {\n",
     "  target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);\n"
     "  unsigned long long t_ = sec_now();\n  for (int s = 0; s < p.num_steps; ++s) {\n"),
    ("        kick<N>(m, g, sqrt_imm, ce, dims);\n",
     "        kick<N>(m, g, sqrt_imm, ce, dims);\n        sec_add(chain, 2, t_);\n"),
    ("        target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);\n      }\n",
     "        target_grad<N, F, kTiles>(p, x, iv, g, lane, smem);\n"
     "        sec_add(chain, 3, t_);\n      }\n"),
    ("      if (present && t < p.n_track) hist[t] = v;\n    }\n",
     "      if (present && t < p.n_track) hist[t] = v;\n    }\n    sec_add(chain, 4, t_);\n"
     "    if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + 6] += 1;\n"),
    ("  if (!kTiles && !present) return;  // the whole warp leaves together\n",
     "  if (!kTiles && !present) return;  // the whole warp leaves together\n"
     "  sec_span(chain, 0);\n"),
    ("  if (lane == 0) p.out_logdensity[chain] = ld;\n}\n",
     "  if (lane == 0) p.out_logdensity[chain] = ld;\n  sec_add(chain, 5, t_);\n"
     "  sec_span(chain, 1);\n}\n"),
]

# counters in the resident form's step loop (mclmc_resident)
_MCLMC_RESIDENT = [
    ("  if (chain >= p.C) return;  // resident\n",
     "  if (chain >= p.C) return;  // resident\n  sec_span(chain, 0);\n"),
    ("  for (int s = 0; s < p.num_steps; ++s) {  // resident\n",
     "  unsigned long long t_ = sec_now();\n"
     "  for (int s = 0; s < p.num_steps; ++s) {  // resident\n"),
    ("    // ---- the pooled draws (resident) ----\n",
     "    sec_add(chain, 5, t_);\n    // ---- the pooled draws (resident) ----\n"),
    ("    // ---- the refresh before the stages (resident) ----\n",
     "    sec_add(chain, 0, t_);\n    // ---- the refresh before the stages (resident) ----\n"),
    ("    // ---- the stages (resident) ----\n",
     "    sec_add(chain, 1, t_);\n    // ---- the stages (resident) ----\n"),
    ("        // ---- a kick (resident) ----\n",
     "        sec_add(chain, 5, t_);\n        // ---- a kick (resident) ----\n"),
    ("        // ---- a drift and its gradient (resident) ----\n",
     "        sec_add(chain, 5, t_);\n        // ---- a drift and its gradient (resident) ----\n"),
    ("        // ---- the kick's end (resident) ----\n",
     "        sec_add(chain, 2, t_);\n        // ---- the kick's end (resident) ----\n"),
    ("        // ---- the gradient's end (resident) ----\n",
     "        sec_add(chain, 3, t_);\n        // ---- the gradient's end (resident) ----\n"),
    ("    // ---- the refresh after the stages (resident) ----\n",
     "    sec_add(chain, 5, t_);\n    // ---- the refresh after the stages (resident) ----\n"),
    ("    // ---- the history (resident) ----\n",
     "    sec_add(chain, 1, t_);\n    // ---- the history (resident) ----\n"),
    ("    // ---- the step's end (resident) ----\n",
     "    sec_add(chain, 4, t_);\n    if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + 6] += 1;\n"
     "    // ---- the step's end (resident) ----\n"),
    ("  // ---- final state (resident) ----\n",
     "  sec_add(chain, 5, t_);\n  // ---- final state (resident) ----\n"),
    ("  // ---- the chain's end (resident) ----\n",
     "  sec_span(chain, 1);\n  // ---- the chain's end (resident) ----\n"),
]

# the registers form's occupancy at d = 100, appended where the tree has no
# export: warps an SM, registers, local bytes a thread, steps a pool (none)
_MCLMC_PARENT_OCCUPANCY = r"""
extern "C" int bjt_fused_mclmc_occupancy(int d, int target, int form, int* out) {
  (void)d; (void)target; (void)form;
  const auto k = mclmc_kernel<4, 0>;
  cudaFuncAttributes a;
  int e = (int)cudaFuncGetAttributes(&a, k);
  if (!e) e = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, k, kFusedWarps * 32, 0);
  out[0] *= kFusedWarps;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = 0;
  return e;
}
"""

# the SASS opcodes of each pipe that --sass counts, and the warp-instructions
# an SM issues of each a clock (Hopper, CUDA C++ Programming Guide's
# arithmetic throughput table for compute capability 9.0: 64 results a clock
# for 32-bit integer add, logic, shift and compare, 128 for FP32, 16 for
# special functions and conversions, 32 for shuffles; four schedulers)
SASS_PIPES = {
    "integer": (("IADD3", "LOP3", "SHF", "IMAD", "ISETP", "LEA", "IMNMX", "SEL", "PRMT",
                 "IABS", "POPC", "FLO", "BREV", "SGXT", "VIADD", "VIMNMX"), 2.0),
    "fp32": (("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK", "FSET", "FSWZADD"), 4.0),
    "mufu": (("MUFU",), 0.5),
    "conversion": (("I2F", "F2I", "F2F", "I2FP", "F2IP", "FRND"), 0.5),
    "shfl": (("SHFL",), 1.0),
}
SASS_ISSUE = 4.0  # warp-instructions an SM issues a clock, all pipes


def _pipe(opcode):
    base = opcode.split(".")[0]
    for name, (ops, _) in SASS_PIPES.items():
        if base in ops:
            return name
    return "other"


def _sass_functions(text):
    """{mangled name: [(opcode, frames, address, text)]} and {mangled name:
    {label: address}} from nvdisasm's output with line information and
    inlining: an instruction's frames are the (file, line) pairs of the
    ``//## File`` lines before it, the innermost first and the kernel's own
    line last (an instruction without such lines keeps the last frames)."""
    funcs, labels, name, frames, fresh, pending = {}, {}, None, (), True, []
    for raw in text.splitlines():
        head = re.match(r"\s*\.section\s+\.text\.([^,\s]+)", raw)
        if head:
            name, pending = head.group(1), []
            funcs[name], labels[name] = [], {}
            continue
        info = re.search(r'//## File "([^"]+)", line (\d+)', raw)
        if info:
            frame = (info.group(1), int(info.group(2)))
            frames, fresh = ((frame,) if fresh else frames + (frame,)), False
            continue
        if name is None:
            continue
        label = re.match(r"\s*\.?(L_x_\d+):", raw)
        if label:
            pending.append(label.group(1))
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", raw)
        if ins:
            addr = int(ins.group(1), 16)
            for lab in pending:
                labels[name][lab] = addr
            pending, fresh = [], True
            funcs[name].append((ins.group(2), frames, addr, raw))
    return funcs, labels


def _sass_count(text, source, kernel, pool=None):
    """A step's warp-instructions of the step loop of ``kernel`` (a regex
    on the mangled name) by part and pipe, from nvdisasm's text of a
    ``-lineinfo`` build and the lines of ``fused_mclmc.cu`` (``source``).

    The step loop is the function's widest backward branch, and its body
    runs once a step. Of the loops directly inside it, the stage loop (the
    one with a kick: the registers form, or S = 0) runs its kick path three
    times a step, its drift path twice and the rest five times
    (McLachlan's). The history's rounds (one for eight tracked dims) and,
    in the resident form, the pool walk's rounds (``pool = (rounds a pool,
    steps a pool)``) go to their loops by the stores in each (STG a round of
    history, STS a round of the pool; an unrolled loop holds more than one),
    widest first, and what is left to the straight copies after them; the
    rest of the pool's draws run once a pool. Cold code counts nothing: any
    other loop (the Payne-Hanek reduction of cosf, for |x| >= 105615), and
    the code that a forward branch skips where it calls a slow path (the
    IEEE division's and square root's) or holds such a loop and no shuffle
    (every hot branch of these kernels holds a reduction). An instruction
    belongs to the part of the outermost line of ``fused_mclmc.cu`` on its
    inlining chain that names one: a refresh (its draws where a frame is in
    counter_rng.cuh), the pool, a kick, a drift or a gradient, or the
    history; else the rest."""
    funcs, labels = _sass_functions(text)
    names = [n for n in funcs if re.search(kernel, n)]
    if len(names) != 1:
        raise RuntimeError(f"{kernel}: {len(names)} functions in the SASS")
    ins, at = funcs[names[0]], labels[names[0]]
    addrs = [a for _, _, a, _ in ins]

    def target(raw):
        jump = re.search(r"\bBRA\b.*?\.?(L_x_\d+)", raw)
        return at.get(jump.group(1)) if jump else None

    loops = [(target(raw), a) for _, _, a, raw in ins
             if target(raw) is not None and target(raw) <= a]
    if not loops:
        raise RuntimeError(f"{kernel}: no loop in the SASS")
    outer = max(loops, key=lambda lo: lo[1] - lo[0])
    inside = [lo for lo in loops if lo != outer and outer[0] <= lo[0] and lo[1] <= outer[1]]
    direct = [lo for lo in inside
              if not any(o != lo and o[0] <= lo[0] and lo[1] <= o[1] for o in inside)]

    def part(frames):
        draws = any(f.endswith("counter_rng.cuh") for f, _ in frames)
        for f, line in reversed(frames):
            if not f.endswith("fused_mclmc.cu") or not 0 < line <= len(source):
                continue
            code = source[line - 1]
            if "refresh" in code:
                return "refresh draws" if draws else "refresh norms"
            if "pool" in code:
                return "refresh draws"
            if "kick" in code:
                return "kicks"
            if re.search(r"x\[k\] \+ ce|grad<", code):
                return "drifts and gradients"
            if re.search(r"hist|n_track|dim & 31|held", code):
                return "history"
        return "refresh draws" if draws else "rest"

    parts = [part(frames) for _, frames, _, _ in ins]
    in_step = [outer[0] <= a <= outer[1] for a in addrs]

    def members(lo):
        return [i for i, a in enumerate(addrs) if lo[0] <= a <= lo[1]]

    def stores(idx, op):
        return sum(ins[i][0].split(".")[0] == op for i in idx)

    times = [1.0] * len(ins)
    loose, rounds_of = set(), {}  # rounds_of: loop -> (kind, stores a pass)
    for lo in inside:
        idx = members(lo)
        kinds = {parts[i] for i in idx}
        if lo not in direct:
            loose.update(idx)
        elif "kicks" in kinds:
            for i in idx:
                times[i] *= {"kicks": 3.0, "drifts and gradients": 2.0}.get(parts[i], 5.0)
        elif "refresh draws" in kinds and pool and stores(idx, "STS"):
            rounds_of[lo] = ("pool", stores(idx, "STS"))
        elif "history" in kinds and stores(idx, "STG"):
            rounds_of[lo] = ("history", stores(idx, "STG"))
        else:
            loose.update(idx)
    in_loop = {i for lo in inside for i in members(lo)}
    for kind, total, per in (("pool", pool[0] if pool else 0, 1.0 / pool[1] if pool else 1.0),
                             ("history", 1, 1.0)):
        left = total
        for lo, (_, k) in sorted(((lo, v) for lo, v in rounds_of.items() if v[0] == kind),
                                 key=lambda item: -item[1][1]):
            passes, left = left // k, left % k
            for i in members(lo):
                times[i] *= passes * per
        sec = "refresh draws" if kind == "pool" else "history"
        straight = [i for i in range(len(ins)) if in_step[i] and i not in in_loop
                    and parts[i] == sec]
        copies = stores(straight, "STS" if kind == "pool" else "STG")
        if kind == "pool" and pool:  # the setup once a pool, and the last rounds
            share = per * (left / copies if copies else 1.0)
        else:
            share = left / copies if copies else 1.0
        for i in straight:
            times[i] *= share
    # forward branches over slow paths, the narrowest first: a branch's
    # body, less the bodies already found cold, that calls a slow path or
    # holds a loose loop, and holds no shuffle, is cold
    cold = set()
    skips = sorted(((i, end) for i, (_, _, a, raw) in enumerate(ins)
                    if re.match(r"\s*/\*[0-9a-f]+\*/\s+@", raw)
                    and (end := target(raw)) is not None and end > a),
                   key=lambda s: s[1] - addrs[s[0]])
    for i, end in skips:
        span = [k for k in range(i + 1, len(ins)) if addrs[k] < end]
        rest = [k for k in span if k not in cold]
        if (any(ins[k][0].startswith("CALL") or k in loose for k in rest)
                and not any(ins[k][0].split(".")[0] == "SHFL" for k in rest)):
            cold.update(span)
    cold |= loose
    counts = {s: dict.fromkeys((*SASS_PIPES, "other", "all"), 0.0) for s in MCLMC_SECTIONS}
    for k, ((opcode, _, _, _), sec) in enumerate(zip(ins, parts)):
        if not in_step[k] or k in cold:
            continue
        counts[sec][_pipe(opcode)] += times[k]
        counts[sec]["all"] += times[k]
    return counts, len(direct), names[0]


def _sass(nvcc, label, src_dir, out_dir, kernel, pool, card):
    """Build ``src_dir``'s fused_mclmc.cu with -lineinfo into a cubin, write
    its SASS (nvdisasm, with line information) under ``out_dir``, and print a
    step's instructions of ``kernel`` by part and pipe and the issue floor
    they set."""
    work = nvcc.build_dir() / f"mclmc_sass_{re.sub(r'[^A-Za-z0-9]', '_', label)}"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src_dir, work)
    flags = [f for f in nvcc.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    cubin = work / "fused_mclmc.cubin"
    proc = subprocess.run([nvcc._nvcc(), *flags, "-lineinfo", "-cubin", "-o", str(cubin),
                           str(work / "fused_mclmc.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc -cubin:\n{proc.stderr[-3000:]}")
    bindir = os.path.dirname(nvcc._nvcc())
    text = subprocess.run([os.path.join(bindir, "nvdisasm"), "--print-line-info-inline",
                           "--print-code", str(cubin)], capture_output=True, text=True)
    if text.returncode:
        text = subprocess.run([os.path.join(bindir, "nvdisasm"), "--print-line-info",
                               "--print-code", str(cubin)], capture_output=True, text=True,
                              check=True)
    os.makedirs(out_dir, exist_ok=True)
    dump = os.path.join(out_dir, f"{os.path.basename(work)}.sass")
    with open(dump, "w") as f:
        f.write(text.stdout)
    source = (work / "fused_mclmc.cu").read_text().splitlines()
    try:
        counts, n_inner, name = _sass_count(text.stdout, source, kernel, pool)
    except (RuntimeError, ValueError, IndexError) as err:  # the dump stays for reading
        print(f"{label} mclmc SASS: not counted ({err}); {dump} ({card})", flush=True)
        return None
    total = {q: sum(c[q] for c in counts.values()) for q in (*SASS_PIPES, "other", "all")}
    floor = max([total["all"] / SASS_ISSUE]
                + [total[q] / rate for q, (_, rate) in SASS_PIPES.items()])
    print(f"{label} mclmc SASS of {name} ({n_inner} inner loops in the step loop; {dump}): "
          + "; ".join(f"{s}: " + ", ".join(f"{q} {c[q]:.1f}" for q in (*SASS_PIPES, "other",
                                                                          "all"))
                      for s, c in counts.items())
          + f"; a step: {', '.join(f'{q} {v:.1f}' for q, v in total.items())} warp-instructions;"
          f" issue floor {floor:.1f} SM-cycles a chain-step (the busiest of all issue at "
          f"{SASS_ISSUE:g} a clock and each pipe at its rate: "
          + ", ".join(f"{q} {total[q] / rate:.1f}" for q, (_, rate) in SASS_PIPES.items())
          + f") ({card})", flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return floor


def _mclmc_copy(nvcc, fm, tag, sections=None, warps=None, block_warps=None):
    """The library of a copy of the tree's ``csrc/fused_mclmc.cu``: with
    ``clock64()`` counters in the step loop of the form ``sections``, or
    with the resident form built for ``warps`` warps an SM at every width and
    ``block_warps`` a block. Returns the library and its ptxas report."""
    out = nvcc.build_dir() / f"mclmc_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(nvcc._SRC_DIR, out)
    src = out / "fused_mclmc.cu"
    text = src.read_text()
    for value, pattern, line in (
            (warps, r"constexpr int mclmc_resident_warps\(\) \{ return [^;]*; \}",
             f"constexpr int mclmc_resident_warps() {{ return {warps}; }}"),
            (block_warps, r"constexpr int mclmc_block_warps\(\) \{\s*return [^;]*;\s*\}",
             f"constexpr int mclmc_block_warps() {{ return {block_warps}; }}")):
        if value is not None:
            text, count = re.subn(pattern, line, text)
            if count != 1:
                raise RuntimeError(f"fused_mclmc.cu: {pattern} not found")
    src.write_text(text)
    if sections:
        loop = _MCLMC_RESIDENT if sections == "resident" else _MCLMC_REGISTERS
        _edit(src, [("namespace {\n", _HEAD)] + loop,
              _TAIL + ("" if "bjt_fused_mclmc_occupancy" in text else _MCLMC_PARENT_OCCUPANCY))
    lib_path = out / "fused_mclmc.so"
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc, the copy {tag}:\n{proc.stderr[-4000:]}")
    lib, own = ctypes.CDLL(str(lib_path)), fm._library()
    for name in ("bjt_fused_mclmc", "bjt_counter_normals", "bjt_error_string",
                 "bjt_fused_mclmc_occupancy", "bjt_mclmc_pool_layout"):
        if hasattr(own, name):  # the tree's own C interface, as its wrapper binds it
            getattr(lib, name).argtypes = getattr(own, name).argtypes
            getattr(lib, name).restype = getattr(own, name).restype
    lib.bjt_fused_mclmc_occupancy.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    if sections:
        lib.bjt_sections.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib, proc.stdout + proc.stderr


def _mclmc(args, torch, card, label):
    """--machine mclmc: the fused MCLMC kernel on the flagship at phase 8's
    shape."""
    import importlib

    from blackjax_tpu_torch.ops import _nvcc

    import chip_smoke

    fm = importlib.import_module("blackjax_tpu_torch.ops.fused_mclmc")
    lf = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
    dev = torch.device("cuda")
    steps = args.steps
    rng = np.random.default_rng(7)  # phase 7's inputs
    x = torch.from_numpy((0.5 * rng.standard_normal((4096, args.dim))).astype(np.float32)).to(dev)
    m = torch.from_numpy(rng.standard_normal((4096, args.dim)).astype(np.float32)).to(dev)
    m = m / torch.linalg.vector_norm(m, dim=1, keepdim=True)
    imm = torch.from_numpy(rng.uniform(0.5, 1.5, args.dim).astype(np.float32)).to(dev)
    step, L = 0.5, 5.0
    if args.inputs:
        if not os.path.exists(args.inputs):
            pos, mom, L, step, imm, *_ = chip_smoke.mclmc_start(torch, dev)
            torch.save({"positions": pos.cpu(), "momenta": mom.cpu(), "L": float(L),
                        "step_size": float(step), "inverse_mass_matrix": imm.cpu()}, args.inputs)
        saved = torch.load(args.inputs)
        x, m, imm = (saved[k].to(dev) for k in ("positions", "momenta", "inverse_mass_matrix"))
        step, L = saved["step_size"], saved["L"]
        print(f"{label} mclmc: phase 8's inputs from {args.inputs}: {tuple(x.shape)}, L {L:.6f}, "
              f"step size {step:.6f}, mean metric {float(imm.mean()):.6f}", flush=True)
    chains, d = x.shape
    kw = dict(target=lf.make_hierarchical_gaussian_target(d), num_steps=steps, seed=7,
              track_dims=range(8))
    has_forms = hasattr(fm, "plan")
    if args.form is not None:
        if not has_forms and args.form == "resident":
            raise SystemExit(f"{label}: this tree has no resident form")
        if has_forms:
            kw["form"] = args.form
    form = fm.plan(d, 0, kw.get("form")) if has_forms else "registers"

    def launch(xs=x, ms=m):
        return fm.fused_mclmc(xs, ms, imm, step, L, **kw)

    def occupancy(lib):
        out = np.zeros(4, np.int32)
        code = lib.bjt_fused_mclmc_occupancy(d, 0, int(form == "resident"), out.ctypes.data)
        if code:
            raise RuntimeError(f"occupancy query failed ({code})")
        return tuple(int(v) for v in out)

    def digest(out):
        h = hashlib.sha256()
        for t in out:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    launch()
    if args.sass:
        n = (d + 31) // 32
        kernel = (rf"mclmc_residentILi{n}ELi0ELi5E" if form == "resident"
                  else rf"mclmc_kernelILi{n}ELi0E")
        pool = None
        if form == "resident":
            steps_a_pool = occupancy(fm._library())[3]
            pool = (-(-2 * steps_a_pool * d // 32), steps_a_pool)
        _sass(_nvcc, label, _nvcc._SRC_DIR, os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "chiprun_out", "mclmc_sass"), kernel, pool, card)
    if args.sections:
        lib, log = _mclmc_copy(_nvcc, fm, "sections", sections=form)
        warps_sm, regs, local, pool = occupancy(lib)
        _, plain_ms = chip_smoke._timed(torch, launch)
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])

        def counted(xs, ms):
            library = fm._library
            fm._library = lambda: lib
            try:
                launch(xs, ms)
                sec = np.zeros(8192 * 8, np.uint64)
                span = np.zeros(8192 * 3, np.uint64)
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))  # drains them
                out, t = chip_smoke._timed(torch, lambda: launch(xs, ms))
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))
            finally:
                fm._library = library
            sec = sec[:len(xs) * 8].reshape(len(xs), 8).astype(np.float64)
            per_step = sec[:, :len(MCLMC_SECTIONS)].sum(0) / sec[:, 6].sum()
            return out, per_step, span[:len(xs) * 3].reshape(len(xs), 3), t

        def parts(per_step):
            return (", ".join(f"{n_} {c:.0f}" for n_, c in zip(MCLMC_SECTIONS, per_step))
                    + f", total {per_step.sum():.0f}")

        out, per_step, span, ms = counted(x, m)
        below, held, span_ms, n_sm = _tail(span, warps_sm)
        start = span[:, 0].astype(np.int64)
        end = span[:, 1].astype(np.int64)
        late = int((start > end.min()).sum())  # warps that started after the first one ended
        ptxas = [s for s in chip_smoke._ptxas_summary(log)
                 if f"N={(d + 31) // 32} " in s and ("F=0" in s or "T=0 S=5" in s)]
        print(f"{label} mclmc sections ({form} form): launch {plain_ms:.2f} ms without the "
              f"counters, {ms:.2f} ms with them; cycles a step: {parts(per_step)}; waves: "
              f"{late} of {len(x)} warps started after the first warp ended, the last "
              f"start {(start.max() - start.min()) / 1e6:.3f} ms after the first; tail: "
              f"{below:.4f} of SM-time between the first start and the last end ({span_ms:.2f} "
              f"ms on {n_sm} SMs) with fewer than {warps_sm // 2} warps resident, mean "
              f"{held:.4f} of {warps_sm} warps held; occupancy {warps_sm} warps an SM, {regs} "
              f"registers, {local} B local a thread, {pool} steps a pool; ptxas "
              f"{'; '.join(ptxas)} ({card})", flush=True)
        _, lone_parts, _, lone_counted_ms = counted(x[:1], m[:1])
        launch(x[:1], m[:1])
        _, lone_ms = chip_smoke._timed(torch, lambda: launch(x[:1], m[:1]))
        for what, ms1 in (("without the counters", lone_ms), ("with them", lone_counted_ms)):
            ns = ms1 * 1e6 / steps
            print(f"{label} mclmc, chain 0 alone {what}: {steps} steps in {ms1:.3f} ms, "
                  f"{ns:.0f} ns a step ({ns * mhz / 1e3:.0f} cycles at {mhz:.0f} MHz) ({card})",
                  flush=True)
        print(f"{label} mclmc, chain 0 alone: cycles a step: {parts(lone_parts)}", flush=True)
        shutil.rmtree(_nvcc.build_dir() / "mclmc_sections", ignore_errors=True)
        return 0
    runs = [(None, None, None)]
    if args.warps or args.block_warps:  # one nvcc a copy, all started together
        shapes = [(w, b) for w in args.warps or [None] for b in args.block_warps or [None]]
        with ThreadPoolExecutor(max_workers=len(shapes)) as pool:
            libs = pool.map(lambda wb: _mclmc_copy(_nvcc, fm, f"warps_{wb[0]}_{wb[1]}",
                                                   warps=wb[0], block_warps=wb[1])[0], shapes)
            runs = [(w, b, lib) for (w, b), lib in zip(shapes, libs)]
    library = fm._library
    for warps, block, lib in runs:
        if lib is not None:
            fm._library = lambda lib=lib: lib
        launch()
        times = []
        for _ in range(args.repeats):
            out, ms = chip_smoke._timed(torch, launch)
            times.append(ms)
        occ = ""
        if lib is None:
            n = (d + 31) // 32
            occ = ", ptxas " + "; ".join(
                s for s in chip_smoke._ptxas_summary(_nvcc.build_log("fused_mclmc"))
                if f"N={n} F=0" in s or f"N={n} T=0 S=5" in s)
        if hasattr(fm, "occupancy"):
            w, r, loc, pool = occupancy(fm._library())
            occ += f", {w} warps an SM, {r} registers, {loc} B local a thread, {pool} steps a pool"
        name = label + ("" if lib is None else
                        f" ({warps or 'default'} warps an SM, {block or 'default'} a block)")
        print(f"{name} mclmc d={d} C={chains} S={steps}: {', '.join(f'{t:.3f}' for t in times)} "
              f"ms, median {statistics.median(times):.3f} ms, form {form}{occ}, outputs sha256 "
              f"{digest(out)} ({card})", flush=True)
        if lib is not None:
            fm._library = library
            shutil.rmtree(_nvcc.build_dir() / f"mclmc_warps_{warps}_{block}", ignore_errors=True)
    return 0


# the parts of an HMC transition that --machine hmc --sections counts, in
# the order they are printed: the prologue (loads, the momentum, energy0 and
# the first gradient) and the epilogue (energy1, the accept, the stores) once
# a chain, the others once a step
HMC_SECTIONS = ("prologue", "kicks and drift", "gradient", "epilogue")

# counters in the transition form (hmc_transition in csrc/fused_leapfrog.cu)
_HMC_TRANSITION = [
    ("  const int lane = threadIdx.x & 31;\n  const Analytic<T> tp{p.d};\n",
     "  const int lane = threadIdx.x & 31;\n  const Analytic<T> tp{p.d};\n"
     "  sec_span(chain, 0);\n  unsigned long long t_ = sec_now();\n"),
    ("  // ---- the trajectory (transition) ----\n",
     "  sec_add(chain, 0, t_);\n  // ---- the trajectory (transition) ----\n"),
    ("    // ---- the gradient (transition) ----\n",
     "    sec_add(chain, 1, t_);\n    // ---- the gradient (transition) ----\n"),
    ("    // ---- the second kick (transition) ----\n",
     "    sec_add(chain, 2, t_);\n    // ---- the second kick (transition) ----\n"),
    ("    // ---- the step's end (transition) ----\n",
     "    sec_add(chain, 1, t_);\n    if ((threadIdx.x & 31) == 0) g_sec[chain * 8 + 6] += 1;\n"
     "    // ---- the step's end (transition) ----\n"),
    ("  // ---- the chain's end (transition) ----\n",
     "  sec_add(chain, 3, t_);\n  sec_span(chain, 1);\n  // ---- the chain's end (transition) ----\n"),
]


def _hmc_copy(nvcc, lf, tag, sections=False, block_warps=None):
    """The library of a copy of the tree's ``csrc/fused_leapfrog.cu``: with
    ``clock64()`` counters in the transition form, or with its warps a block
    (``kTransitionBlockWarps``) set. Returns the library and its ptxas
    report."""
    out = nvcc.build_dir() / f"hmc_{tag}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(nvcc._SRC_DIR, out)
    src = out / "fused_leapfrog.cu"
    text = src.read_text()
    if block_warps is not None:
        text, count = re.subn(r"constexpr int kTransitionBlockWarps = \d+;",
                              f"constexpr int kTransitionBlockWarps = {block_warps};", text)
        if count != 1:
            raise RuntimeError("fused_leapfrog.cu: kTransitionBlockWarps not found")
    src.write_text(text)
    if sections:
        _edit(src, [("namespace {\n", _HEAD)] + _HMC_TRANSITION, _TAIL)
    lib_path = out / "fused_leapfrog.so"
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc, the copy {tag}:\n{proc.stderr[-4000:]}")
    lib, own = ctypes.CDLL(str(lib_path)), lf._library()
    for name in ("bjt_fused_leapfrog", "bjt_hmc_transition", "bjt_fused_tiles_layout",
                 "bjt_error_string"):
        getattr(lib, name).argtypes = getattr(own, name).argtypes
        getattr(lib, name).restype = getattr(own, name).restype
    if sections:
        lib.bjt_sections.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    return lib, proc.stdout + proc.stderr


def _own_chip_smoke():
    """This file's ``chip_smoke.py`` (phase 6's start and path), whatever tree
    ``--root`` names: its functions use the root's package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_hmc", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                       "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _hmc(args, torch, card, label):
    """--machine hmc: phase 6's fused_hmc path and its transition."""
    import importlib

    import blackjax_tpu_torch
    from blackjax_tpu_torch.ops import _nvcc

    smoke = _own_chip_smoke()
    lf = importlib.import_module("blackjax_tpu_torch.ops.fused_leapfrog")
    dev = torch.device("cuda")
    if args.inputs and os.path.exists(args.inputs):
        saved = torch.load(args.inputs)
        x, imm = saved["positions"].to(dev), saved["inverse_mass_matrix"].to(dev)
        step, gen_state = saved["step_size"], saved["generator"]
    else:
        x, step, imm, generator, warm_s, warm_acc = smoke.hmc_start(torch, dev)
        gen_state = generator.get_state()
        print(f"{label} hmc: phase 6's warmup in {warm_s:.2f} s (acceptance {warm_acc:.4f}), "
              f"step size {step:.6f}, mean metric {float(imm.mean()):.6f}", flush=True)
        if args.inputs:
            torch.save({"positions": x.cpu(), "step_size": float(step),
                        "inverse_mass_matrix": imm.cpu(), "generator": gen_state}, args.inputs)
    target = lf.make_hierarchical_gaussian_target(x.shape[1])
    sampler = blackjax_tpu_torch.fused_hmc(target, step, imm, smoke.HMC_STEPS)
    has_transition = "fused_leapfrog:hmc_transition" in lf.LAUNCHES

    def generator():
        g = torch.Generator(device=dev)
        g.set_state(gen_state)
        return g

    if args.sections:
        if not has_transition:
            raise SystemExit(f"{label}: this tree has no transition form")
        return _hmc_sections(args, torch, card, label, lf, smoke, _nvcc)
    if args.block_warps:
        return _hmc_copies(args, torch, card, label, lf, smoke, _nvcc)

    # the first run pays for the build and for the device memory that the
    # kept history's positions take (as phase 6 does in chip_smoke.py)
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    _, cold_ms, cold_s = smoke.hmc_path(torch, sampler, generator(), x)
    segments = torch.cuda.memory_stats().get("segment.all.allocated", 0) - segments
    print(f"{label} hmc: the first run, its build and allocations included: {cold_ms:.2f} ms by "
          f"CUDA events, {cold_s:.4f} s host clock, {segments} device segments allocated "
          f"({card})", flush=True)
    for _ in range(args.repeats):
        before = dict(lf.LAUNCHES)
        (track, acc), ms, host_s = smoke.hmc_path(torch, sampler, generator(), x)
        launches = {k.split(":")[-1]: v - before[k] for k, v in lf.LAUNCHES.items()}
        h = hashlib.sha256()
        for t_ in (track, acc):
            h.update(t_.cpu().contiguous().numpy().tobytes())
        print(f"{label} hmc: {smoke.HMC_TRANSITIONS} transitions x {x.shape[0]} chains: {ms:.2f} "
              f"ms by CUDA events ({ms / smoke.HMC_TRANSITIONS:.4f} ms a transition), "
              f"{host_s:.4f} s host clock, mean acceptance {float(acc.mean()):.4f}, launches "
              f"{launches}, history sha256 {h.hexdigest()[:16]} ({card})", flush=True)
    hist = track.permute(1, 0, 2)  # (chains, samples, tracked)
    min_ess = float(blackjax_tpu_torch.ess(hist.double()).min())
    print(f"{label} hmc: min-ESS over {hist.shape[2]} tracked dims {min_ess:.1f} "
          f"({min_ess / (ms / 1e3):.4g} ESS/s on the last run)", flush=True)
    if args.history:
        if os.path.exists(args.history):
            other = torch.load(args.history).to(dev)
            equal = (hist == other).flatten(1).all(1)
            close = torch.isclose(hist, other, rtol=1e-5, atol=1e-5).flatten(1).all(1)
            parted = (hist != other).flatten(2).any(2)  # (chains, samples)
            first = parted.float().argmax(1)[parted.any(1)]
            print(f"{label} hmc: history against {args.history}: {float(equal.float().mean()):.4f} "
                  f"of chains bit for bit, {float(close.float().mean()):.4f} within 1e-5; "
                  f"{int(parted.any(1).sum())} chains part, the first at transition "
                  f"{int(first.min()) if len(first) else '-'}", flush=True)
        else:
            torch.save(hist.cpu(), args.history)
    # phase 5's fused_leapfrog on this tree: the SHA-256 of its outputs
    h = hashlib.sha256()
    for case in ("hierarchical", "gaussian"):
        (x5, _, m5, _, imm5, eps5), kw5 = _hmc_inputs(torch, lf, smoke, case)
        for t_ in lf.fused_leapfrog(x5, m5, imm5, eps5, **kw5):
            h.update(t_.cpu().contiguous().numpy().tobytes())
    print(f"{label} hmc: phase 5's fused_leapfrog outputs (both targets) sha256 "
          f"{h.hexdigest()[:16]}", flush=True)
    # one transition: its kernels' device time by torch.profiler
    from torch.profiler import ProfilerActivity, profile

    state = sampler.init(x)
    g = generator()
    for _ in range(3):
        state, _ = sampler.step(g, state)
    torch.cuda.synchronize()
    repeats = 20
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            state, _ = sampler.step(g, state)
        torch.cuda.synchronize()
    records = [e for e in prof.events() if e.device_type.name == "CUDA"
               and e.time_range.elapsed_us() > 0]
    kernel = [e for e in records if "hmc_transition" in e.name or "leapfrog_kernel" in e.name]
    total = sum(e.time_range.elapsed_us() for e in records) / 1e3 / repeats
    own = sum(e.time_range.elapsed_us() for e in kernel) / 1e3 / repeats
    print(f"{label} hmc: one transition by torch.profiler over {repeats}: {len(records) / repeats:.1f} "
          f"device records a transition, {total:.4f} ms of device time in all, of which the "
          f"fused kernel {own:.4f} ms ({card})", flush=True)
    return 0


def _hmc_inputs(torch, lf, smoke, case):
    """Phase 5's inputs for the transition kernel (numpy seed 5: positions
    0.5 N(0, I), normal draws, uniforms and a metric; step size 0.1)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    C, D = smoke.C, smoke.D
    x = torch.from_numpy((0.5 * rng.standard_normal((C, D))).astype(np.float32)).to(dev)
    z = torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32)).to(dev)
    imm = torch.from_numpy(rng.uniform(0.5, 1.5, D).astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.random(C).astype(np.float32)).to(dev)
    target = (lf.make_hierarchical_gaussian_target(D) if case == "hierarchical"
              else lf.make_gaussian_target(D, np.logspace(-1, 1, D)))
    return (x, target.logdensity_fn(x), z, u, imm, 0.1), dict(target=target,
                                                              num_steps=smoke.HMC_STEPS)


def _hmc_sections(args, torch, card, label, lf, smoke, nvcc):
    """--machine hmc --sections: the transition kernel's cycles by part, at
    phase 5's shape, for both targets, and chain 0 alone."""
    lib, log = _hmc_copy(nvcc, lf, "sections", sections=True)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    ptxas = [s for s in smoke._ptxas_summary(log) if s.startswith("hmc_transition N=4 ")]

    def counted(targs, kw):
        library = lf._library
        lf._library = lambda: lib
        try:
            lf._hmc_transition_cuda(*targs, **kw)
            n = len(targs[0])
            sec = np.zeros(8192 * 8, np.uint64)
            span = np.zeros(8192 * 3, np.uint64)
            lib.bjt_sections(sec.ctypes.data, span.ctypes.data, n)  # drains them
            out, ms = smoke._timed(torch, lambda: lf._hmc_transition_cuda(*targs, **kw))
            lib.bjt_sections(sec.ctypes.data, span.ctypes.data, n)
        finally:
            lf._library = library
        sec = sec[:n * 8].reshape(n, 8).astype(np.float64)
        counted_chains = sec[:, 6] > 0
        steps = sec[counted_chains, 6].sum()
        chains = counted_chains.sum()
        parts = [sec[counted_chains, 0].sum() / chains, sec[counted_chains, 1].sum() / steps,
                 sec[counted_chains, 2].sum() / steps, sec[counted_chains, 3].sum() / chains]
        span = span[:n * 3].reshape(n, 3)[counted_chains].astype(np.int64)
        return out, parts, span, ms

    def line(parts, steps):
        per_chain = parts[0] + steps * (parts[1] + parts[2]) + parts[3]
        return (", ".join(f"{n_} {c:.0f}" for n_, c in zip(HMC_SECTIONS, parts))
                + f"; a chain {per_chain:.0f} cycles ({per_chain / mhz:.3f} us at {mhz:.0f} MHz)")

    for case in ("hierarchical", "gaussian"):
        targs, kw = _hmc_inputs(torch, lf, smoke, case)
        lf._hmc_transition_cuda(*targs, **kw)
        _, plain_ms = smoke._timed(torch, lambda: lf._hmc_transition_cuda(*targs, **kw))
        dev_ms = smoke._device_ms(torch, lambda: lf._hmc_transition_cuda(*targs, **kw),
                                  "hmc_transition", repeats=50)
        _, parts, span, ms = counted(targs, kw)
        start, end = span[:, 0], span[:, 1]
        print(f"{label} hmc sections, {case} d={smoke.D} C={smoke.C} num_steps={kw['num_steps']}: "
              f"cycles a warp (prologue and epilogue a chain, the others a step): "
              f"{line(parts, kw['num_steps'])}; warps' spans: first start to last end "
              f"{(end.max() - start.min()) / 1e3:.2f} us, a warp's span mean "
              f"{(end - start).mean() / 1e3:.2f} us, starts spread over "
              f"{(start.max() - start.min()) / 1e3:.2f} us; launch {ms:.4f} ms by CUDA events with "
              f"the counters, {plain_ms:.4f} ms without; the kernel's device time by "
              f"torch.profiler {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}; ptxas "
              f"{'; '.join(ptxas)} ({card})", flush=True)
        one = tuple(a[:1] for a in targs[:4]) + targs[4:]  # x, ld, z, u of chain 0
        _, lone, _, _ = counted(one, kw)
        print(f"{label} hmc sections, {case}, chain 0 alone: {line(lone, kw['num_steps'])} "
              f"({card})", flush=True)
    shutil.rmtree(nvcc.build_dir() / "hmc_sections", ignore_errors=True)
    return 0


def _hmc_copies(args, torch, card, label, lf, smoke, nvcc):
    """--machine hmc --block-warps B ...: the transition kernel
    of each copy at phase 5's shape, both targets: its device time by
    torch.profiler, its outputs against the tree's own launch and the plain
    version, and its ptxas line."""
    shapes = args.block_warps
    lf._library()  # the tree's own first: the copies take its C interface
    with ThreadPoolExecutor(max_workers=len(shapes)) as pool:
        built = list(pool.map(lambda b: _hmc_copy(nvcc, lf, f"b{b}", block_warps=b), shapes))
    library = lf._library
    inputs = {case: _hmc_inputs(torch, lf, smoke, case) for case in ("hierarchical", "gaussian")}
    own = {case: lf._hmc_transition_cuda(*targs, **kw) for case, (targs, kw) in inputs.items()}
    plain = {case: lf._hmc_transition_plain(*targs, **kw) for case, (targs, kw) in inputs.items()}
    for rnd in range(args.repeats):
        for block, (lib, log) in [(None, (None, ""))] + list(zip(shapes, built)):
            times = []
            for case, (targs, kw) in inputs.items():
                if lib is not None:
                    lf._library = lambda lib=lib: lib
                try:
                    out = lf._hmc_transition_cuda(*targs, **kw)
                    dev_ms = smoke._device_ms(
                        torch, lambda: lf._hmc_transition_cuda(*targs, **kw), "hmc_transition",
                        repeats=50)
                finally:
                    lf._library = library
                same = all(torch.equal(a, b) for a, b in zip(out, own[case]))
                agree = out[3] == plain[case][3]
                for a, b in zip(out[:3], plain[case][:3]):
                    ok = torch.isclose(a, b, rtol=1e-5, atol=1e-5)
                    agree &= ok.all(1) if ok.dim() == 2 else ok
                times.append(f"{case} {'not measured' if dev_ms is None else f'{dev_ms:.4f}'} ms "
                             f"(bits of the tree's: {same}; {float(agree.float().mean()):.4f} of "
                             f"chains agree with the plain version)")
            ptxas = [s for s in smoke._ptxas_summary(log) if s.startswith("hmc_transition ")]
            print(f"{label} hmc round {rnd}, {block or 'default'} warps a block: "
                  f"{'; '.join(times)}"
                  + (f"; ptxas {'; '.join(ptxas)}" if ptxas else "") + f" ({card})", flush=True)
    for block in shapes:
        shutil.rmtree(nvcc.build_dir() / f"hmc_b{block}", ignore_errors=True)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--target", choices=("flagship", "horseshoe", "gaussian_dense",
                                             "gaussian_low_rank", "eight_schools"),
                        default="flagship")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--label", default=None)
    parser.add_argument("--sections", action="store_true")
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--step-size", type=float, default=0.15)
    parser.add_argument("--form", choices=("resident", "registers", "thread"), default=None)
    parser.add_argument("--warps", type=int, nargs="+", default=None)
    parser.add_argument("--block-warps", type=int, nargs="+", default=None)
    parser.add_argument("--machine", choices=("dc", "older", "mclmc", "hmc"), default="dc")
    parser.add_argument("--history", default=None)
    parser.add_argument("--sass", action="store_true")
    parser.add_argument("--inputs", default=None)
    args = parser.parse_args()
    if args.steps is None:
        args.steps = 1000 if args.machine == "mclmc" else 256
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("dc_kernel_ms: no CUDA device visible", file=sys.stderr)
        return 1
    if args.machine in ("older", "mclmc", "hmc"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        run = {"older": _older, "mclmc": _mclmc, "hmc": _hmc}[args.machine]
        return run(args, torch, card, args.label or args.root)
    if args.target == "eight_schools":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        return _eight_schools(args, torch, card, args.label or args.root)
    from blackjax_tpu_torch.ops import _nvcc, targets_dc
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc

    dev = torch.device("cuda")
    imm = None
    if args.target == "flagship":
        target, chains, scale = dc.make_hierarchical_target_dc(args.dim), 4096, 0.5
        step = args.step_size
        kw = dict(num_steps=args.steps, max_num_doublings=8, budget=2**8 * args.steps, chunk=256)
    elif args.target == "horseshoe":
        target, chains, scale, step = targets_dc.make_finnish_horseshoe_target_dc(), 512, 0.05, 1e-3
        kw = dict(num_steps=128, max_num_doublings=10, pack=4, restart_every=16, chunk=256,
                  budget=1600 * 128 * 4)
    else:  # chip_smoke.py phase 11's Gaussian pairs, drawn in its order
        from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix

        d, chains, step = args.dim, 4096, 0.3
        target = dc.make_gaussian_target_dc(d, np.linspace(0.5, 2.0, d))
        rng = np.random.default_rng(12)
        a = rng.standard_normal((d, d))
        dense = (0.5 * a @ a.T / d + np.diag(rng.uniform(0.5, 1.5, d))).astype(np.float32)
        rank = min(10, d - 1)
        u, _ = np.linalg.qr(rng.standard_normal((d, rank)))
        low_rank = [rng.uniform(0.6, 1.4, d), u,
                    np.concatenate([rng.uniform(2.5, 6.0, rank - rank // 2),
                                    rng.uniform(0.1, 0.4, rank // 2)])]
        x = torch.from_numpy((0.5 * rng.standard_normal((chains, d))).astype(np.float32)).to(dev)
        if args.target == "gaussian_dense":
            imm = torch.from_numpy(dense).to(dev)
        else:
            imm = LowRankInverseMassMatrix(
                *(torch.from_numpy(v.astype(np.float32)).to(dev) for v in low_rank))
        kw = dict(num_steps=16, max_num_doublings=8, budget=2**8 * 16)
    if imm is None:
        x = torch.from_numpy((scale * np.random.default_rng(1).standard_normal(
            (chains, target.dim))).astype(np.float32)).to(dev)
        imm = torch.ones(target.dim, device=dev)
    if args.target == "flagship" and args.inputs:  # phase 4's own start
        if not os.path.exists(args.inputs):
            positions, step, imm, *_ = _own_chip_smoke().warm_start(torch, dev)
            torch.save({"positions": positions.cpu(), "step_size": float(step),
                        "inverse_mass_matrix": imm.cpu()}, args.inputs)
        saved = torch.load(args.inputs)
        x, imm = (saved[k].to(dev) for k in ("positions", "inverse_mass_matrix"))
        step = saved["step_size"]
        print(f"{args.label or args.root} flagship: phase 4's inputs from {args.inputs}: "
              f"{tuple(x.shape)}, step size {step:.6f}, mean metric {float(imm.mean()):.6f}",
              flush=True)
    kw.update(target=target, seed=7, num_track=8)
    resident = hasattr(dc, "RESIDENT_WIDTHS")
    if args.form is not None:
        widths = (1, 2, 4, 8) if args.form == "resident" else ()
        dc.RESIDENT_WIDTHS = {kind: widths for kind in dc.RESIDENT_WIDTHS}
        resident = args.form == "resident"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    label = args.label or args.root

    def timed():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = dc.fused_nuts_run_dc(x, imm, step, **kw)
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    dc.fused_nuts_run_dc(x, imm, step, **kw)
    (_, _, grads, _), plain_ms = timed()
    if args.sections:
        if args.target != "flagship":
            raise SystemExit("--sections times the flagship")
        import chip_smoke

        lib, log = _sections_copy(_nvcc, dc)
        warps_sm, regs, local = _occupancy(lib, resident, args.dim)

        def counted(xs):
            """One counted launch on the positions xs: per-chain outputs,
            cycles a leaf by part, the warps' spans and the milliseconds."""
            library = dc._library
            dc._library = lambda kind="diag": lib
            try:
                x32, metric, machine = dc._prepare(xs, imm, **kw)
                dc._launch_cuda(x32, metric, step, **machine)
                sec = np.zeros(8192 * 8, np.uint64)
                span = np.zeros(8192 * 3, np.uint64)
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))  # drains them
                out, ms = chip_smoke._timed(
                    torch, lambda: dc._launch_cuda(x32, metric, step, **machine))
                lib.bjt_sections(sec.ctypes.data, span.ctypes.data, len(xs))
            finally:
                dc._library = library
            sec = sec[:len(xs) * 8].reshape(len(xs), 8).astype(np.float64)
            per_leaf = sec[:, :len(SECTIONS)].sum(0) / sec[:, 6].sum()
            return out, per_leaf, span[:len(xs) * 3].reshape(len(xs), 3), sec[:, 6].sum(), ms

        def parts(per_leaf):
            return (", ".join(f"{n} {c:.0f}" for n, c in zip(SECTIONS, per_leaf))
                    + f", total {per_leaf.sum():.0f}")

        (_, steps, chain_grads, _, iters), per_leaf, span, leaves, ms = counted(x)
        below, held, span_ms, n_sm = _tail(span, warps_sm)
        it = iters.cpu().numpy().astype(np.float64)
        cg = chain_grads.cpu().numpy().astype(np.float64)
        ptxas = [s for s in chip_smoke._ptxas_summary(log)
                 if " M=0" in s and (" F=0" in s or "resident" in s)]
        print(f"{label} flagship sections ({'resident' if resident else 'registers'} form): "
              f"launch {plain_ms:.2f} ms without the counters, {ms:.2f} ms with them; cycles a "
              f"leaf: {parts(per_leaf)}; {leaves:.0f} leaves, all chains complete: "
              f"{bool((steps == kw['num_steps']).all())}; tail: {below:.4f} of SM-time between "
              f"the first start and the last end ({span_ms:.2f} ms on {n_sm} SMs) with fewer than "
              f"{warps_sm // 2} warps resident, mean {held:.4f} of {warps_sm} warps held; "
              f"iterations a chain: max {it.max():.0f}, p99 {np.percentile(it, 99):.0f}, mean "
              f"{it.mean():.1f}; gradients a chain: max {cg.max():.0f}, p99 "
              f"{np.percentile(cg, 99):.0f}, mean {cg.mean():.1f}; occupancy {warps_sm} warps an "
              f"SM, {regs} registers, {local} B local a thread; ptxas {'; '.join(ptxas)} ({card})",
              flush=True)
        _, lone_parts, _, _, _ = counted(x[:1])
        print(f"{label} flagship sections, chain 0 alone: cycles a leaf: {parts(lone_parts)}",
              flush=True)
        # a leaf's latency with nothing beside it: chain 0 alone, one warp on the card
        x1, metric1, machine1 = dc._prepare(x[:1], imm, **kw)
        dc._launch_cuda(x1, metric1, step, **machine1)
        (_, _, _, _, iters1), ms1 = chip_smoke._timed(
            torch, lambda: dc._launch_cuda(x1, metric1, step, **machine1))
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        lone = ms1 * 1e6 / float(iters1[0])
        print(f"{label} flagship, chain 0 alone: {int(iters1[0])} iterations in {ms1:.2f} ms, "
              f"{lone:.0f} ns a leaf ({lone * mhz / 1e3:.0f} cycles at {mhz:.0f} MHz); the slowest "
              f"chain's {it.max():.0f} iterations at that rate: {it.max() * lone / 1e6:.2f} ms "
              f"({card})", flush=True)
        shutil.rmtree(_nvcc.build_dir() / "dc_sections", ignore_errors=True)
        return 0
    runs = [(None, None, None)]
    if args.warps or args.block_warps:  # one nvcc a copy, all started together
        shapes = [(w, b) for w in args.warps or [None] for b in args.block_warps or [None]]
        with ThreadPoolExecutor(max_workers=len(shapes)) as pool:
            libs = pool.map(lambda wb: _warps_copy(_nvcc, dc, *wb), shapes)
            runs = [(w, b, lib) for (w, b), lib in zip(shapes, libs)]
    resident_warps = getattr(dc, "resident_warps", None)
    block_warps = getattr(dc, "_RESIDENT_BLOCK_WARPS", None)
    for warps, block, library in runs:
        if library is not None:  # the plan follows the copy's launch bound and blocks
            dc._library = lambda kind="diag", lib=library: lib
            dc.resident_warps = resident_warps if warps is None else (lambda n, w=warps: w)
            dc._RESIDENT_BLOCK_WARPS = block_warps if block is None else block
        dc.fused_nuts_run_dc(x, imm, step, **kw)
        before = dict(dc.LAUNCHES)
        times = []
        for _ in range(args.repeats):
            (_, _, grads, _), ms = timed()
            times.append(ms)
        forms = ",".join(k.split(":", 1)[1] for k, v in dc.LAUNCHES.items()
                         if ":" in k and v != before[k])
        occupancy = ""
        if args.target == "flagship" and hasattr(dc, "RESIDENT_WIDTHS"):
            w, r, loc = _occupancy(dc._library("diag"), resident, args.dim)
            occupancy = f", {w} warps an SM, {r} registers, {loc} B local a thread"
        name = label + ("" if library is None else
                        f" ({warps or 'default'} warps an SM, {block or 'default'} a block)")
        print(f"{name} {args.target}{'' if args.dim == 100 else f' d={args.dim}'}: "
              f"{', '.join(f'{t:.2f}' for t in times)} ms, median {statistics.median(times):.2f} "
              f"ms, {float(grads):.0f} grads, form {forms or 'registers'}{occupancy} ({card})",
              flush=True)
        if library is not None:
            shutil.rmtree(_nvcc.build_dir() / f"dc_warps_{warps}_{block}", ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
