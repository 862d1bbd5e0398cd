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
4. reads the kernel's SASS (cuobjdump -sass), finds each mode's sample
   loop and estimates one sample's time on its hot path by
   ``probe_pll.loop_chain`` (the longest dependent chain, and in-order
   issue by one warp, by an assumed latency table); at the card's SM clock
   that is a least time per sample however many channels run;
5. times each mode at C=1024 over B = 512 .. 8192 (the slope is the
   measured time a sample), and at C=1 and C=32;
6. prints one JSON object with all of it (``--out FILE`` also writes it,
   ``--sass FILE`` the kernel's SASS).

Run from the repository root on a card:  python3 probe_agc.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from probe_pll import loop_chain, sass_functions
from quisk_tpu_torch import _kernels

# the kernel template's instantiations: agc_scan_kernel<0|1|2>
_MODE_OF = {"ILi0E": "tx_alc", "ILi1E": "wcp", "ILi2E": "hang"}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    ap.add_argument("--sass", help="also write the kernel's SASS here")
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
    built = _kernels.build(["agc_scan"])
    log = built.get("agc_scan", {}).get("log", "")
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
    print(f"card: {smi}; build: " + " | ".join(out["ptxas"]), flush=True)

    rng = np.random.default_rng(7)
    for mode in cs.AGC_WRAPPERS:
        r = cs.check_agc(mode, cs.agc_case(mode, rng, 37, 777, dev))
        out[f"{mode}_check"] = r
        print(f"{mode} at C=37, B=777: {r}", flush=True)

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
    for name, ins in funcs.items():
        mode = next((m for k, m in _MODE_OF.items() if k in name), name)
        res = loop_chain(ins)
        if res["found"]:
            # loop_chain counts a sample a shared store; TxALC stores its
            # clip byte (STS.U8) beside its gain, so count the 32-bit ones
            lo, hi = res["span"]
            n = sum(1 for a, op, _, _ in ins
                    if lo <= a <= hi and op.startswith("STS")
                    and ".U8" not in op)
            for k in ("chain_cycles_a_sample", "in_order_cycles_a_sample"):
                res[k] *= res["samples_a_pass"] / max(n, 1)
            res["samples_a_pass"] = n
        res["function"] = name
        res["total_instructions"] = len(ins)
        out[f"{mode}_sass"] = res
        print(f"{mode} SASS: {res}", flush=True)

    for mode, fn in cs.AGC_WRAPPERS.items():
        times = {}
        for C, B in ((1024, 512), (1024, 2048), (1024, 8192), (32, 2048),
                     (1, 2048)):
            xs, st, coef, kw = cs.agc_case(mode, rng, C, B, dev)
            run = dict(kw, clips=False) if mode == "tx_alc" else kw
            times[f"{C}x{B}"] = timed(lambda: fn(*xs, st, coef, **run))
        slope_ns = ((times["1024x8192"] - times["1024x512"])
                    / (8192 - 512) * 1e6)
        out[f"{mode}_ms"] = times
        out[f"{mode}_ns_per_sample"] = slope_ns
        print(f"{mode} times (ms) {times}; {slope_ns:.2f} ns a sample "
              f"(slope over B at C=1024) = "
              f"{slope_ns * float(clock) / 1e3:.0f} cycles at "
              f"{clock} MHz", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
