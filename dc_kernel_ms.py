"""Milliseconds of one ``fused_nuts_run_dc`` launch on the card, for the copy of
``blackjax_tpu_torch`` found under ROOT (default: this file's directory).

Targets: ``flagship``, the 100-dim hierarchical Gaussian at phase 4's shape
in ``chip_smoke.py`` (4,096 chains x 256 transitions, ``max_num_doublings=8``)
at step size 0.15; ``horseshoe``, the 100 x 200 Finnish horseshoe at phase
10's settings (512 chains x 128 transitions, ``max_num_doublings=10``,
``pack=4``, ``restart_every=16``) at step size 1e-3; both from 0.05 (the
horseshoe) or 0.5 (the flagship) N(0, I) of numpy seed 1 and a unit metric.
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
    parser.add_argument("--target", choices=("flagship", "horseshoe"), default="flagship")
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

    if args.target == "flagship":
        target, chains, scale, step = dc.make_hierarchical_target_dc(100), 4096, 0.5, 0.15
        kw = dict(num_steps=256, max_num_doublings=8, budget=112 * 256, chunk=256)
    else:
        target, chains, scale, step = targets_dc.make_finnish_horseshoe_target_dc(), 512, 0.05, 1e-3
        kw = dict(num_steps=128, max_num_doublings=10, pack=4, restart_every=16, chunk=256,
                  budget=1600 * 128 * 4)
    dev = torch.device("cuda")
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
