"""The control of a cell's comparison: the reference computed in TF32 (the
tensor cores' float32, the step that would tempt a later change) put in
the program's place, at the cell's own size, on the cell's own input.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--blocks 3] [--device cuda]

For each seed it makes the cell's capture as a run does, draws blocks of
a run's window from the seed, and prints each compared number of the
control beside the cell's limit: every one of them has to fail at least
one limit.  It runs nothing of the program.  The benchmark's own runs do
not run it; ``tests/test_benchmark_control.py`` runs it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def control(name: str, seed: int, blocks: int, device: str,
            override: dict | None = None, first: int = 10,
            last: int = 2000) -> dict:
    """{number: control's reading} of cell ``name`` on ``seed``: the
    largest over ``blocks`` block indices drawn from [first, last)."""
    import numpy as np
    import torch

    from qbench.cell import _merge
    from qbench.manifest import Manifest, system_module

    man = Manifest()
    cell = man.workload(name)
    cfg = man.config(cell["config"])
    if override:
        cfg = _merge(cfg, override)
    mix = man.mix(cell["traffic"])
    sysmod = system_module(cfg["system"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ring = sysmod.ring(cfg, seed, mix["ring_blocks"], device, gen)
    ks = np.random.default_rng([seed, 4]).integers(first, last, blocks)
    per = sysmod.check(cfg, seed, lambda j: ring[j % len(ring)], len(ring),
                       {int(k): None for k in ks}, device, control=True)
    return {k: max(b[k] for b in per.values()) for k in cfg["limits"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    from qbench.manifest import Manifest
    limits = Manifest().config(Manifest().workload(args.workload)["config"]
                               )["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control(args.workload, seed, args.blocks, args.device)
        fails = [k for k in limits if got[k] > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got, "limits": limits,
                          "fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
