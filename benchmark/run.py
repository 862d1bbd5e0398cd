"""Run one cell of the benchmark of ``quisk_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Prints the result as the last line of
standard output (one JSON object) and the compared numbers with their
limits as the last lines of standard error.  Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 2; if
JAX or the JAX package is loaded once the window has closed, it exits 3.
"""

from __future__ import annotations

import time

_T_NOW = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (the
    interpreter's own start-up included), from /proc where it exists."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return _T_NOW - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return _T_NOW


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_process = process_start()

    # every cache the program or a kernel compiler keeps: a fixed path
    # inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    sys.path[:0] = [str(HERE), str(HERE.parent)]

    import torch
    from qbench import cell
    from qbench.manifest import Manifest

    man = Manifest()
    need = man.workload(args.workload)["chips"]
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = cell.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_process=t_process, manifest=man)
    found = cell.forbidden_modules()
    if found:
        print("loaded at exit: " + ", ".join(found), file=sys.stderr)
        return 3
    print(cell.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
