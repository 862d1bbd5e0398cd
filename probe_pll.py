#!/usr/bin/env python3
"""The PLL kernel (quisk_tpu_torch/csrc/pll_demod.cu) alone on one card.

1. builds it (nvcc's -Xptxas=-v lines: registers, spills);
2. holds both modes to their plain version at a small shape (bits and the
   largest difference), on ``chip_smoke.py``'s test input (noise, a
   carrier on the even rows);
3. reads the kernel's SASS (cuobjdump -sass), finds each mode's sample
   loop (the innermost backward branch), counts its instructions and
   estimates one sample's time on its hot path (the rare paths cut, see
   ``hot_path``) two ways by an assumed latency table (LATENCY below: 4
   cycles for the fp32 and integer ALU, 18 for the MUFU unit, 6 for
   conversions, 24 for a shared-memory load, 8 otherwise): the longest
   dependent chain, and in-order issue by one warp; at the card's SM clock
   that is a least time per sample however many channels run;
4. times both modes at C=1024 over B = 512 .. 8192 (the slope is the
   measured time a sample), and at C=32 (one block, one warp);
5. prints one JSON object with all of it (and ``--out FILE`` writes it).

Run from the repository root on a card:  python3 probe_pll.py
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch.ops import pll

LATENCY = {"FFMA": 4, "FADD": 4, "FMUL": 4, "FMNMX": 4, "FSEL": 4,
           "FSETP": 4, "FSET": 4, "IADD3": 4, "IMAD": 4, "LOP3": 4,
           "SHF": 4, "ISETP": 4, "SEL": 4, "MOV": 4, "IABS": 4, "LEA": 4,
           "PRMT": 4, "FCHK": 4, "PLOP3": 4, "P2R": 4, "R2P": 4,
           "MUFU": 18, "F2I": 6, "I2F": 6, "F2F": 6, "FRND": 6,
           "I2FP": 6, "F2IP": 6, "LDS": 24}
DEFAULT_LATENCY = 8
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);")


def sass_functions(so: Path) -> dict:
    from torch.utils.cpp_extension import CUDA_HOME
    tool = shutil.which("cuobjdump") or str(Path(CUDA_HOME) / "bin" /
                                             "cuobjdump")
    text = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = _INS.search(line)
        if m and name:
            guard = (m.group(2) or "").strip().lstrip("@!")
            funcs[name].append((int(m.group(1), 16), m.group(3),
                                m.group(4).strip(), guard))
    return text, funcs


def regs(ops: str) -> list[str]:
    return re.findall(r"\b(U?R\d+|U?P\d)\b", ops)


def _target(ops: str):
    m = re.search(r"0x([0-9a-f]+)", ops)
    return int(m.group(1), 16) if m else None


SLOW = ("CALL", "LDL", "STL", "LDG")


def hot_path(body: list, slow: tuple = SLOW) -> list:
    """The loop body less its rare paths: the innermost span a forward
    branch skips around a call, a local or global memory access (the
    opcodes that start with one of ``slow``) or a loop of its own (the
    range reductions of cosf / sinf for |x| >= 105615, the division's slow
    path), and the span an unconditional forward branch jumps over (the
    special cases of atan2f, of a zero or infinite argument, and of the
    wrap)."""
    spans = [(a, _target(o)) for a, op, o, _ in body
             if op.startswith("BRA") and (_target(o) or 0) > a]
    cut = set()
    for addr, op, ops, _ in body:
        inner_loop = op.startswith("BRA") and (_target(ops) or addr) < addr
        if op.startswith(slow) or inner_loop:
            around = [sp for sp in spans if sp[0] < addr < sp[1]]
            if around:
                a, t = min(around, key=lambda sp: sp[1] - sp[0])
                cut.update(i[0] for i in body if a < i[0] < t)
    for addr, op, ops, guard in body:
        t = _target(ops)
        if (op.startswith("BRA") and not guard and addr not in cut and t
                and t > addr):
            cut.update(i[0] for i in body if addr < i[0] < t)
    return [i for i in body if i[0] not in cut]


def sample_loop(ins: list, need=("LDS", "STS")) -> list | None:
    """The shortest loop (backward branch) whose body holds every opcode
    of ``need``: by default the sample loop, which loads x from shared
    memory and stores y there."""
    loops = []
    for addr, op, ops, _ in ins:
        t = _target(ops)
        if op.startswith("BRA") and t is not None and t < addr:
            body = [i for i in ins if t <= i[0] <= addr]
            if set(need) <= {i[1].split(".")[0] for i in body}:
                loops.append(body)
    return min(loops, key=len) if loops else None


def chain_estimate(body: list, per_pass: int, slow: tuple = SLOW) -> dict:
    """Two estimates of one pass over the loop ``body``'s hot path
    (:func:`hot_path`) by LATENCY, per sample (``per_pass`` samples a
    pass): the longest dependent chain (each instruction ready a latency
    after its last source), and in-order issue by one warp (each
    instruction issued a cycle after the one before it, and not before its
    sources are ready); ``slow`` as :func:`hot_path` takes it."""
    hot = hot_path(body, slow)
    ready: dict[str, int] = {}
    issue = 0
    for _, op, ops, guard in hot:
        base = op.split(".")[0]
        rs = regs(ops)
        if base in ("STS", "STG") or not rs:
            issue += 1
            continue
        srcs = rs[1:] + ([guard] if guard else [])
        src_ready = max((ready.get(r, 0) for r in srcs), default=0)
        issue = max(issue + 1, src_ready)
        ready[rs[0]] = max(ready.get(rs[0], 0),
                           src_ready + LATENCY.get(base, DEFAULT_LATENCY))
    chain = max(ready.values())
    return {"found": True, "instructions": len(body),
            "hot_path_instructions": len(hot),
            "samples_a_pass": per_pass,
            "mufu": sum(1 for i in hot if i[1].startswith("MUFU")),
            "chain_cycles_a_sample": chain / max(per_pass, 1),
            "in_order_cycles_a_sample": max(issue, chain) / max(per_pass, 1),
            "span": [body[0][0], body[-1][0]]}


def loop_chain(ins: list) -> dict:
    """The sample loop (:func:`sample_loop`) and :func:`chain_estimate` of
    it, a sample a shared store."""
    body = sample_loop(ins)
    if body is None:
        return {"found": False}
    return chain_estimate(body, sum(1 for i in body
                                    if i[1].startswith("STS")))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_pll: no CUDA device", file=sys.stderr)
        return 2
    # imported here: chip_smoke imports this module's SASS readers
    import chip_smoke as cs
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True,
                           check=True).stdout.strip()
    out = {"card": smi, "sm_clock_max_mhz": float(clock)}
    built = _kernels.build(["pll_demod"])
    log = built.get("pll_demod", {}).get("log", "")
    out["ptxas"] = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
    print(f"card: {smi}; build: " + " | ".join(out["ptxas"]), flush=True)

    ops = cs.pll_ops(dev)
    rng = np.random.default_rng(5)
    for mode, fn in (("sync_am", pll.pll_sync_am), ("pll_fm", pll.pll_fm)):
        coef = ops[mode].coef()
        x, st, _ = cs.pll_test_input(rng, 37, 777, mode, dev)
        n0 = fn.launches
        (ks, ky) = fn(x, st, coef)
        (ps, py) = pll.pll_demod_plain(mode, x, st, coef)
        torch.cuda.synchronize()
        err = float((ky - py).abs().max())
        out[f"{mode}_check"] = {
            "launches": fn.launches - n0, "max_abs_err": err,
            "peak": float(py.abs().max()),
            "bit_equal": bool(torch.equal(ky, py)) and all(
                torch.equal(a, b) for a, b in zip(ks, ps))}
        print(f"{mode} at C=37, B=777: {out[f'{mode}_check']}", flush=True)

    so = _kernels._target("pll_demod")
    text, funcs = sass_functions(so)
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/pll_demod.sass").write_text(text)
    for name, ins in funcs.items():
        mode = "sync_am" if "ILi0E" in name else "pll_fm"
        res = loop_chain(ins)
        res["function"] = name
        res["total_instructions"] = len(ins)
        out[f"{mode}_sass"] = res
        print(f"{mode} SASS: {res}", flush=True)

    for mode, fn in (("sync_am", pll.pll_sync_am), ("pll_fm", pll.pll_fm)):
        coef = ops[mode].coef()
        times = {}
        for C, B in ((1024, 512), (1024, 2048), (1024, 8192), (32, 2048)):
            x, st, _ = cs.pll_test_input(rng, C, B, mode, dev)
            for _ in range(2):
                fn(x, st, coef)
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(10):
                fn(x, st, coef)
            b.record()
            b.synchronize()
            times[f"{C}x{B}"] = a.elapsed_time(b) / 10
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
