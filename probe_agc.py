#!/usr/bin/env python3
"""The AGC / ALC kernel (quisk_tpu_torch/csrc/agc_scan.cu) alone on one card.

1. builds it (nvcc's -Xptxas=-v lines: registers, spills);
2. holds its three modes to their plain versions at a small shape, on
   ``chip_smoke.py``'s test input (``agc_case``: bits, the largest
   difference, WcpAGC's gain in ulp);
3. checks two roundings the plain versions rely on, on the card: torch's
   float32 division by a Python number against division by a float32
   tensor (the former may be a product with the reciprocal), and
   torch.log10 against the kernel's log10f through WcpAGC's gain law;
4. reads the kernel's SASS (cuobjdump -sass), finds each mode's tile loop
   and estimates one sample's time on its hot path
   (``chip_smoke.agc_tile_estimates``: the longest dependent chain, and
   in-order issue by one warp, by probe_pll's assumed latency table); at
   the card's SM clock that is a least time per sample however many
   channels run; it counts the branches and convergence barriers left on
   the hot path;
5. times each mode at C=1024 over B = 512 .. 8192 (the slope is the
   measured time a sample), at C=1, and at C=32 on 32 distinct rows and on
   32 copies of one row (what lanes in different states cost);
6. with ``--ref SRC`` (another source of the kernel, e.g. an earlier
   commit's), builds it beside the checkout's, holds it to the plain
   versions too and times every case of 5 with both, in the order
   checkout, ref, ref, checkout;
7. prints one JSON object with all of it (``--out FILE`` also writes it,
   ``--sass FILE`` the kernel's SASS).

Run from the repository root on a card:  python3 probe_agc.py
  git show <commit>:quisk_tpu_torch/csrc/agc_scan.cu \
      > quisk_tpu_torch/_build/old_agc_scan.cu
  python3 probe_agc.py --ref quisk_tpu_torch/_build/old_agc_scan.cu
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from probe_pll import sass_functions
from quisk_tpu_torch import _kernels
from quisk_tpu_torch.ops import agc_scan

def timed(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def build(ref: Path | None) -> tuple[list[str], object, list[str]]:
    """The checkout's kernel and ``ref`` (if given) compiled together, one
    nvcc each: (the checkout's ptxas lines, the ref's bound launcher or
    None, its ptxas lines)."""
    proc = lib = None
    if ref is not None:
        out_dir = _kernels.BUILD_DIR / "ref"
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / f"lib{ref.stem}.so"
        proc = subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib),
             str(ref)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    built = _kernels.build(["agc_scan"])
    mine = ptxas_lines(built.get("agc_scan", {}).get("log", ""))
    if proc is None:
        return mine, None, []
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build of {ref} failed:\n{log}")
    return mine, agc_scan.bind(ctypes.CDLL(str(lib))), ptxas_lines(log)


@contextlib.contextmanager
def kernel_of(launcher):
    """Route the wrappers to ``launcher`` (None: the checkout's own)."""
    saved = agc_scan._launcher
    if launcher is not None:
        agc_scan._launcher = lambda: launcher
    try:
        yield
    finally:
        agc_scan._launcher = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    ap.add_argument("--sass", help="also write the kernel's SASS here")
    ap.add_argument("--ref", type=Path,
                    help="another source of the kernel to time beside it")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_agc: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True,
                           check=True).stdout.strip()
    out = {"card": smi, "sm_clock_max_mhz": float(clock)}
    out["ptxas"], ref, out["ref_ptxas"] = build(args.ref)
    print(f"card: {smi}; build: " + " | ".join(out["ptxas"])
          + (f"; ref build: {' | '.join(out['ref_ptxas'])}" if ref else ""),
          flush=True)

    rng = np.random.default_rng(7)
    kernels = {"checkout": None, **({"ref": ref} if ref else {})}
    for mode in cs.AGC_WRAPPERS:
        case = cs.agc_case(mode, rng, 37, 777, dev)
        for who, launcher in kernels.items():
            with kernel_of(launcher):
                r = cs.check_agc(mode, case)
            key = f"{mode}_check" + ("" if who == "checkout" else "_ref")
            out[key] = r
            print(f"{mode} ({who}) at C=37, B=777: {r}", flush=True)

    # torch's float32 division on the card: by a Python number, by a
    # float32 tensor, and the product with float32(1/960)
    x = torch.as_tensor(rng.standard_normal(1 << 20).astype(np.float32),
                        device=dev)
    by_number = x / 960
    by_tensor = x / torch.full((), 960.0, device=dev)
    by_recip = x * float(np.float32(1.0) / np.float32(960.0))
    on_cpu = (x.cpu() / 960).to(dev)
    out["division"] = {
        "number_vs_tensor": int((by_number != by_tensor).sum()),
        "number_vs_reciprocal": int((by_number != by_recip).sum()),
        "tensor_vs_cpu": int((by_tensor != on_cpu).sum()),
        "samples": x.numel()}
    # log10: torch on the card against log10f in the kernel (WcpAGC's gain
    # law on volts spanning its range)
    v = torch.as_tensor(np.geomspace(1e-7, 10.0, 1 << 20).astype(np.float32),
                        device=dev)
    cuda_log = torch.log10(v)
    cpu_log = torch.log10(v.cpu()).to(dev)
    out["log10"] = {"torch_cuda_vs_cpu": int((cuda_log != cpu_log).sum()),
                    "samples": v.numel()}
    print(f"division {out['division']}; log10 {out['log10']}", flush=True)

    so = _kernels._target("agc_scan")
    text, funcs = sass_functions(so)
    if args.sass:
        Path(args.sass).write_text(text)
    for mode, res in cs.agc_tile_estimates(funcs).items():
        out[f"{mode}_sass"] = res
        print(f"{mode} SASS: {res}", flush=True)

    order = ("checkout", "ref", "ref", "checkout") if ref else ("checkout",)
    for mode, fn in cs.AGC_WRAPPERS.items():
        times = {who: {} for who in kernels}
        for C, B in ((1024, 512), (1024, 2048), (1024, 8192), (32, 2048),
                     (1, 2048)):
            case = cs.agc_case(mode, rng, C, B, dev)
            cases = {f"{C}x{B}": case}
            if C == 32:
                cases["32x2048 same"] = cs.same_rows(case)
            for label, (xs, st, coef, kw) in cases.items():
                run = dict(kw, clips=False) if mode == "tx_alc" else kw
                ms = {who: [] for who in kernels}
                for who in order:
                    with kernel_of(kernels[who]):
                        ms[who].append(timed(
                            lambda: fn(*xs, st, coef, **run)))
                for who in kernels:
                    times[who][label] = sum(ms[who]) / len(ms[who])
        for who, t in times.items():
            slope_ns = (t["1024x8192"] - t["1024x512"]) / (8192 - 512) * 1e6
            key = "" if who == "checkout" else "_ref"
            out[f"{mode}_ms{key}"] = t
            out[f"{mode}_ns_per_sample{key}"] = slope_ns
            print(f"{mode} ({who}) times (ms) {t}; {slope_ns:.2f} ns a "
                  f"sample (slope over B at C=1024) = "
                  f"{slope_ns * float(clock) / 1e3:.0f} cycles at "
                  f"{clock} MHz", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
