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
size E (phase 3's shape: 16 at 0.2). ``--dim D`` runs the flagship's
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


def _sections_copy(nvcc, dc):
    """Build the counted copy of the tree's diagonal dc source; returns the
    bound library and its ptxas report."""
    out = nvcc.build_dir() / "dc_sections"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(nvcc._SRC_DIR, out)
    header = out / "fused_nuts_dc.cuh"
    resident = "nuts_dc_resident" in header.read_text()
    _edit(header, [("namespace {\n", _HEAD)] + (_RESIDENT if resident else _REGISTERS))
    _edit(out / "fused_nuts_dc.cu", [], _TAIL + ("" if resident else _PARENT_OCCUPANCY))
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--target", choices=("flagship", "horseshoe", "gaussian_dense",
                                             "gaussian_low_rank"), default="flagship")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--label", default=None)
    parser.add_argument("--sections", action="store_true")
    parser.add_argument("--dim", type=int, default=100)
    parser.add_argument("--steps", type=int, default=256)
    parser.add_argument("--step-size", type=float, default=0.15)
    parser.add_argument("--form", choices=("resident", "registers"), default=None)
    parser.add_argument("--warps", type=int, nargs="+", default=None)
    parser.add_argument("--block-warps", type=int, nargs="+", default=None)
    parser.add_argument("--machine", choices=("dc", "older"), default="dc")
    parser.add_argument("--inputs", default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("dc_kernel_ms: no CUDA device visible", file=sys.stderr)
        return 1
    if args.machine == "older":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        return _older(args, torch, card, args.label or args.root)
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
