"""Smoke test of blackjax_tpu_torch on one NVIDIA GPU (H100).

Run from the root of a checkout, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It drives the port's main path once, at the flagship's full width (NUTS on
the 100-dim hierarchical posterior, 4,096 chains), and checks it in phases,
one line each:

1. the card (``nvidia-smi`` name and power limit) and the build of
   ``csrc/fused_nuts_dc.cu`` with nvcc, with its seconds and its register
   and spill report;
2. the kernel's own threefry2x32 device function against the plain version,
   bit for bit, on 100,000 counters;
3. the CUDA machine against its plain PyTorch version on the card at
   d=100, 4,096 chains, 16 transitions: identical step counts, the share of
   chains that agree to 1e-5 above the CPU test's floor, pooled moments,
   and both times;
4. the main path, launch counts reset just before it: the port's NUTS for 5
   transitions from a numpy-seeded init, then ``fused_nuts_run_dc`` for 256
   transitions from those positions, then min-ESS with the port's
   diagnostics; every chain must complete, everything must be finite, the
   kernel must have been launched, and the pooled moments of ``log_tau``
   must match its N(0, 1) marginal. Then the plain version from the same
   positions, for its time and its agreement.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and exits
non-zero without that line; so does a machine without CUDA, and a directory
without the package.
"""
import json
import re
import subprocess
import sys
import time

import numpy as np

D, C = 100, 4096
SEED = 7
STEP_SIZE = 0.2
MAX_DOUBLINGS = 8
NUM_TRACK = 8
AGREE_TOL = 1e-5
AGREE_FLOOR = 0.9  # tests/test_torch_fused_nuts_dc.py::AGREE_FLOOR


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _timed(torch, fn):
    """(result, milliseconds) of one call, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _ptxas_summary(log: str) -> list:
    """'kernel: registers, spill stores/loads' from nvcc's -Xptxas -v report;
    machine kernels are named by their registers per lane and vector (N)."""
    out, name = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            n = re.search(r"nuts_dc_kernelILi(\d+)E", entry.group(1))
            name = f"machine N={n.group(1)}" if n else "threefry export"
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill and name:
            out.append(f"{name}: spills {spill.group(1)}/{spill.group(2)} B")
        regs = re.search(r"Used (\d+) registers", line)
        if regs and out:
            out[-1] += f", {regs.group(1)} registers"
    return out


def _agreement(torch, a, b):
    """Share of chains whose positions and history agree to AGREE_TOL, and
    the largest absolute difference."""
    (ax, ah), (bx, bh) = a, b
    close = torch.isclose(ax, bx, rtol=AGREE_TOL, atol=AGREE_TOL).all(1)
    close &= torch.isclose(ah, bh, rtol=AGREE_TOL, atol=AGREE_TOL).flatten(1).all(1)
    err = max(float((ax - bx).abs().max()), float((ah - bh).abs().max()))
    return float(close.float().mean()), err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import blackjax_tpu_torch
    from blackjax_tpu_torch.models import hierarchical_gaussian
    from blackjax_tpu_torch.ops import counter_rng
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc
    from blackjax_tpu_torch.util import run_inference_algorithm

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: card and build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    log = dc.build()
    build_s = time.perf_counter() - t0
    print(f"phase 1: card {kind!r} ({smi}); built csrc/fused_nuts_dc.cu in "
          f"{build_s:.2f} s; ptxas per kernel: {'; '.join(_ptxas_summary(log))}")

    # ---- phase 2: threefry export, bit for bit ----
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (2, 100_000), dtype=np.uint64).astype(np.int64)
    words[:, :16] = 2**32 - 1 - np.arange(16)
    c0, c1 = torch.from_numpy(words[0]), torch.from_numpy(words[1])
    on_card = dc.threefry2x32_device(SEED, counter_rng.KEY1, c0.to(dev), c1.to(dev))
    plain = counter_rng.threefry2x32(SEED, counter_rng.KEY1, c0, c1)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(on_card, plain))
    _require(same, "threefry2x32 device function != plain version")
    print(f"phase 2: threefry2x32 device function equals the plain version bit for bit "
          f"on {c0.numel()} counters: {same}")

    # ---- phase 3: kernel against its plain version on the card ----
    target = dc.make_hierarchical_target_dc(D)
    imm = torch.ones(D, dtype=torch.float32, device=dev)
    x0 = torch.from_numpy((0.5 * rng.standard_normal((C, D))).astype(np.float32)).to(dev)

    def compare(x, num_steps):
        budget = 2**MAX_DOUBLINGS * num_steps  # guarantees completion
        kw = dict(target=target, num_steps=num_steps, max_num_doublings=MAX_DOUBLINGS,
                  seed=SEED, num_track=NUM_TRACK, budget=budget)
        kern, ms = _timed(torch, lambda: dc.fused_nuts_run_dc(x, imm, STEP_SIZE, **kw))
        plain, plain_ms = _timed(
            torch, lambda: dc.fused_nuts_run_dc_plain(x, imm, STEP_SIZE, **kw))
        _require(torch.equal(kern[3], plain[3]), f"steps differ at S={num_steps}")
        share, err = _agreement(torch, kern[:2], plain[:2])
        _require(share >= AGREE_FLOOR, f"only {share} of chains agree at S={num_steps}")
        return kern, plain, ms, plain_ms, share, err

    dc.fused_nuts_run_dc(x0[:64], imm, STEP_SIZE, target=target, num_steps=2,
                         num_track=NUM_TRACK, seed=SEED)  # first launch, untimed
    kern, plain, ms3, plain_ms3, share3, err3 = compare(x0, 16)
    kv, pv = kern[1].flatten(0, 1).var(0), plain[1].flatten(0, 1).var(0)
    _require(torch.allclose(kv, pv, rtol=0.05), "pooled variances differ")
    print(f"phase 3: d={D} C={C} S=16 max_doublings={MAX_DOUBLINGS}: steps identical, "
          f"{share3:.4f} of chains agree to {AGREE_TOL} (floor {AGREE_FLOOR}), max |diff| "
          f"{err3:.3g}, grads kernel {float(kern[2]):.0f} plain {float(plain[2]):.0f}, "
          f"pooled var log_tau kernel {float(kv[0]):.5f} plain {float(pv[0]):.5f}; "
          f"kernel {ms3:.3f} ms, plain {plain_ms3:.1f} ms ({smi})")

    # ---- phase 4: the main path ----
    S = 256
    flagship = hierarchical_gaussian(D)
    algo = blackjax_tpu_torch.nuts(flagship.logdensity_fn, step_size=STEP_SIZE,
                                   inverse_mass_matrix=imm, max_num_doublings=6)
    init = torch.from_numpy((0.5 * np.random.default_rng(1).standard_normal((C, D)))
                            .astype(np.float32)).to(dev)
    generator = torch.Generator(device=dev).manual_seed(SEED)
    for name in dc.LAUNCHES:
        dc.LAUNCHES[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = run_inference_algorithm(generator, algo, 5, initial_position=init)
    torch.cuda.synchronize()
    nuts_s = time.perf_counter() - t0
    positions = state.position
    run_kw = dict(target=target, num_steps=S, max_num_doublings=MAX_DOUBLINGS, seed=SEED,
                  num_track=NUM_TRACK, budget=2**MAX_DOUBLINGS * S)
    (fx, hist, grads, steps), ms4 = _timed(
        torch, lambda: blackjax_tpu_torch.fused_nuts_run_dc(positions, imm, STEP_SIZE, **run_kw))
    ess = blackjax_tpu_torch.ess(hist)  # (chains, samples, tracked)
    min_ess = float(ess.min())
    launches = dict(dc.LAUNCHES)

    _require(launches["fused_nuts_dc"] > 0, "the main path launched no kernel")
    _require(bool((steps == S).all()), f"chains short of {S} transitions: {int(steps.min())}")
    for name, t in [("positions", fx), ("history", hist), ("ess", ess)]:
        _require(bool(torch.isfinite(t).all()), f"non-finite {name}")
    _require(fx.shape == (C, D) and hist.shape == (C, S, NUM_TRACK), "output shapes")
    # log_tau's marginal is N(0, 1). The chains start without warmup from
    # 0.5 * N(0, I), deep in the funnel's neck, and drift out slowly: the
    # bound is a coarse sanity check on the second half of the history.
    log_tau = hist[:, S // 2:, 0].flatten()
    mean_lt, var_lt = float(log_tau.mean()), float(log_tau.var())
    _require(abs(mean_lt) < 0.3 and abs(var_lt - 1.0) < 0.3,
             f"log_tau moments {mean_lt}, {var_lt} far off its N(0, 1) marginal")
    secs = ms4 / 1e3
    print(f"phase 4: nuts 5 transitions x {C} chains in {nuts_s:.2f} s; fused_nuts_run_dc "
          f"d={D} C={C} S={S}: all {C} chains completed {S} transitions, kernel "
          f"{ms4:.2f} ms, {float(grads):.0f} grads ({float(grads) / secs:.4g} grads/s), "
          f"min-ESS over {NUM_TRACK} tracked dims {min_ess:.1f} ({min_ess / secs:.4g} ESS/s), "
          f"log_tau over the second half: mean {mean_lt:.4f} var {var_lt:.4f}; "
          f"launches {launches} ({smi})")

    plain, plain_ms4 = _timed(
        torch, lambda: dc.fused_nuts_run_dc_plain(positions, imm, STEP_SIZE, **run_kw))
    share4, err4 = _agreement(torch, (fx, hist), plain[:2])
    print(f"phase 4 plain version from the same positions: {plain_ms4:.1f} ms, "
          f"{share4:.4f} of chains agree with the kernel to {AGREE_TOL}, max |diff| {err4:.3g}")

    print(json.dumps({"kernels": [{
        "name": "fused_nuts_dc",
        "route": "cuda",
        "source": "blackjax_tpu_torch/csrc/fused_nuts_dc.cu",
        "replaces": "blackjax_tpu/ops/fused_nuts_dc.py:964",
        "launches": launches["fused_nuts_dc"],
        "max_abs_err": err3,
        "ms": ms4,
        "plain_ms": plain_ms4,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
