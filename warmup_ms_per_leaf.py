"""Milliseconds per leaf of the port's single-chain NUTS warmup on the card.

Runs ``window_adaptation(nuts, max_num_doublings=8)`` on the flagship
(the 100-dim hierarchical Gaussian) from zeros, as ``chip_smoke.py``'s
phase 4 does, with the copy of ``blackjax_tpu_torch`` found under ROOT
(default: this file's directory), and prints one line: the leaves, the
seconds and the milliseconds per leaf. A short untimed warmup compiles the
kernels first.

To compare two trees on one host, unpack the other tree into a directory
that ``.gitignore`` lists and name both roots in turn in one call, e.g.
``parent change change parent``::

    python3 warmup_ms_per_leaf.py --root _archive_check/parent --steps 100
"""
import argparse
import os
import subprocess
import sys
import time


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--label", default=None)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import blackjax_tpu_torch
    from blackjax_tpu_torch.adaptation.base import get_filter_adapt_info_fn
    from blackjax_tpu_torch.mcmc import nuts
    from blackjax_tpu_torch.models import hierarchical_gaussian

    dev = torch.device("cuda")
    flagship = hierarchical_gaussian(100)

    def run(steps):
        generator = torch.Generator(device=dev).manual_seed(7)
        warmup = blackjax_tpu_torch.window_adaptation(
            nuts, flagship.logdensity_fn, max_num_doublings=8,
            adaptation_info_fn=get_filter_adapt_info_fn(info_keys={"num_integration_steps"}),
        )
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, info = warmup.run(generator, torch.zeros(100, device=dev), steps)
        torch.cuda.synchronize()
        return time.perf_counter() - start, int(info.info.num_integration_steps.sum())

    run(5)
    seconds, leaves = run(args.steps)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip().splitlines()
    print(f"{args.label or args.root}: {args.steps} steps, {leaves} leaves in {seconds:.2f} s, "
          f"{seconds / leaves * 1e3:.3f} ms a leaf ({card[0] if card else 'card unknown'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
