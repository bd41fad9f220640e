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
"""
import argparse
import os
import statistics
import subprocess
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--target", choices=("flagship", "horseshoe", "gaussian_dense",
                                             "gaussian_low_rank"), default="flagship")
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("dc_kernel_ms: no CUDA device visible", file=sys.stderr)
        return 1
    from blackjax_tpu_torch.ops import fused_nuts_dc as dc
    from blackjax_tpu_torch.ops import targets_dc

    dev = torch.device("cuda")
    imm = None
    if args.target == "flagship":
        target, chains, scale, step = dc.make_hierarchical_target_dc(100), 4096, 0.5, 0.15
        kw = dict(num_steps=256, max_num_doublings=8, budget=112 * 256, chunk=256)
    elif args.target == "horseshoe":
        target, chains, scale, step = targets_dc.make_finnish_horseshoe_target_dc(), 512, 0.05, 1e-3
        kw = dict(num_steps=128, max_num_doublings=10, pack=4, restart_every=16, chunk=256,
                  budget=1600 * 128 * 4)
    else:  # chip_smoke.py phase 11's Gaussian pairs, drawn in its order
        from blackjax_tpu_torch.mcmc.metrics import LowRankInverseMassMatrix

        d, chains, step = 100, 4096, 0.3
        target = dc.make_gaussian_target_dc(d, np.linspace(0.5, 2.0, d))
        rng = np.random.default_rng(12)
        a = rng.standard_normal((d, d))
        dense = (0.5 * a @ a.T / d + np.diag(rng.uniform(0.5, 1.5, d))).astype(np.float32)
        u, _ = np.linalg.qr(rng.standard_normal((d, 10)))
        low_rank = [rng.uniform(0.6, 1.4, d), u,
                    np.concatenate([rng.uniform(2.5, 6.0, 5), rng.uniform(0.1, 0.4, 5)])]
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
    dc.fused_nuts_run_dc(x, imm, step, **kw)
    times = []
    for _ in range(args.repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, _, grads, _ = dc.fused_nuts_run_dc(x, imm, step, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"{args.label or args.root} {args.target}: "
          f"{', '.join(f'{t:.2f}' for t in times)} ms, median {statistics.median(times):.2f} ms, "
          f"{float(grads):.0f} grads ({card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
