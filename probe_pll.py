#!/usr/bin/env python3
"""The PLL kernel (quisk_tpu_torch/csrc/pll_demod.cu) alone on one card.

1. builds it (nvcc's -Xptxas=-v lines: registers, spills), and with
   ``--ref SRC`` (another source of the kernel, e.g. an earlier commit's;
   may be given more than once) each such source beside it, one nvcc each,
   all started together;
2. holds both modes of each build to the plain version, every output and
   carried state bit for bit (``chip_smoke.check_pll_bits``), at a small
   shape on ``chip_smoke.py``'s test input (noise, a carrier on the even
   rows), on its special rows (a NaN sample, |ph| ~ 2e5, exact zeros,
   constants, infinities, every magnitude; ``chip_smoke.pll_special_case``)
   and on the sweeps that hold the kernel's sine and cosine (sync AM,
   ``chip_smoke.pll_trig_case``) and its atan2 (PLL FM,
   ``chip_smoke.pll_atan2_case``) to torch's;
3. reads each build's SASS (cuobjdump -sass) and estimates one sample's
   time on its hot path two ways by an assumed latency table (LATENCY
   below: 4 cycles for the fp32 and integer ALU, 18 for the MUFU unit, 6
   for conversions, 24 for a shared-memory load, 8 otherwise): the
   longest dependent chain, and in-order issue by one warp; at the card's
   SM clock that is a least time per sample however many channels run.
   A build with a tile loop (the copies of the next tile in, LDGSTS, and
   the wait for them, DEPBAR) is read by ``chip_smoke.pll_tile_estimates``
   (with the branches left on its hot path); the earlier design, by its
   sample loop (``loop_chain``: the innermost loop with a shared load and
   store, the rare paths cut, see ``hot_path``);
4. times both modes of each build at C=1024 over B = 512 .. 8192 (the
   slope is the measured time a sample), on [1024, 2048] of exact zeros,
   at C=1, and at C=32 (one block, one warp) on 32 distinct rows and on
   32 copies of one row, the builds in turns (checkout, refs, refs in
   reverse, checkout);
5. prints one JSON object with all of it (``--out FILE`` also writes it,
   ``--sass FILE`` the checkout's SASS and each ref's beside it).

Run from the repository root on a card:  python3 probe_pll.py
  git show <commit>:quisk_tpu_torch/csrc/pll_demod.cu \
      > quisk_tpu_torch/_build/old_pll_demod.cu
  python3 probe_pll.py --ref quisk_tpu_torch/_build/old_pll_demod.cu
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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


def build(refs: list[Path]) -> tuple[list[str], dict, dict]:
    """The checkout's kernel and every source in ``refs`` compiled
    together, one nvcc each: (the checkout's ptxas lines, {ref's stem:
    bound launcher}, {ref's stem: its ptxas lines})."""
    out_dir = _kernels.BUILD_DIR / "ref"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for ref in refs:
        lib = out_dir / f"lib{ref.stem}.so"
        procs[ref.stem] = (lib, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib),
             str(ref)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = _kernels.build(["pll_demod"])
    mine = ptxas_lines(built.get("pll_demod", {}).get("log", ""))
    launchers, logs = {}, {}
    for stem, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build of {stem} failed:\n{log}")
        launchers[stem] = pll.bind(ctypes.CDLL(str(lib)))
        logs[stem] = ptxas_lines(log)
    return mine, launchers, logs


def ptxas_lines(log: str) -> list[str]:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


@contextlib.contextmanager
def kernel_of(launcher):
    """Route the wrappers to ``launcher`` (None: the checkout's own)."""
    saved = pll._launcher
    if launcher is not None:
        pll._launcher = lambda: launcher
    try:
        yield
    finally:
        pll._launcher = saved


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


def sass_estimates(so: Path, sass_out: Path | None) -> dict:
    """Each mode's SASS estimates: of the sample loop (loop_chain) where
    the build has one (the earlier design), else of the tile loop
    (chip_smoke.pll_tile_estimates)."""
    import chip_smoke as cs
    text, funcs = sass_functions(so)
    if sass_out is not None:
        sass_out.write_text(text)
    out = {("sync_am" if "ILi0E" in name else "pll_fm"):
           {**loop_chain(ins), "loop": "sample"}
           for name, ins in funcs.items()}
    if not all(v["found"] for v in out.values()):
        out = {m: {**v, "loop": "tile"}
               for m, v in cs.pll_tile_estimates(funcs).items()}
    for name, ins in funcs.items():
        mode = "sync_am" if "ILi0E" in name else "pll_fm"
        out[mode]["function"] = name
        out[mode]["total_instructions"] = len(ins)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON to this file")
    ap.add_argument("--sass", type=Path,
                    help="also write the kernel's SASS here (and each "
                         "ref's beside it, its name suffixed)")
    ap.add_argument("--ref", type=Path, action="append", default=[],
                    help="another source of the kernel to time beside it "
                         "(may be given more than once)")
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
    clock = cs.sm_clock_mhz()
    out = {"card": smi, "sm_clock_max_mhz": clock}
    out["ptxas"], refs, out["ref_ptxas"] = build(args.ref)
    print(f"card: {smi}; build: " + " | ".join(out["ptxas"]) + "".join(
        f"; {k}: {' | '.join(v)}" for k, v in out["ref_ptxas"].items()),
        flush=True)

    kernels = {"checkout": None, **refs}
    ops = cs.pll_ops(dev)
    rng = np.random.default_rng(5)
    # bits: a small shape, the special rows (NaN, |ph| ~ 2e5, zeros,
    # constants) and the sincosf sweep, each kernel against the plain
    # version
    sweeps = {"sync_am": ("trig sweep", cs.pll_trig_case(rng, 1024, 256,
                                                         dev)),
              "pll_fm": ("atan2 sweep", cs.pll_atan2_case(rng, 1024, 256,
                                                          dev))}
    for mode in cs.PLL_WRAPPERS:
        coef = ops[mode].coef()
        cases = {"C=37 B=777": cs.pll_test_input(rng, 37, 777, mode,
                                                 dev)[:2],
                 "special rows": cs.pll_special_case(rng, mode, dev)}
        for who, launcher in kernels.items():
            res = {}
            with kernel_of(launcher):
                for label, (x, st) in cases.items():
                    try:
                        res[label] = cs.check_pll_bits(mode, x, st, coef)
                    except AssertionError as e:
                        res[label] = {"bit_equal": False, "where": str(e)}
                label, case = sweeps[mode]
                try:
                    res[label] = cs.check_pll_bits(mode, *case)
                except AssertionError as e:
                    res[label] = {"bit_equal": False, "where": str(e)}
            key = f"{mode}_check" + ("" if who == "checkout" else f"_{who}")
            out[key] = res
            print(f"{mode} ({who}): {res}", flush=True)

    sass = {"checkout": _kernels._target("pll_demod"),
            **{k: _kernels.BUILD_DIR / "ref" / f"lib{k}.so" for k in refs}}
    for who, so in sass.items():
        dst = None
        if args.sass is not None:
            dst = (args.sass if who == "checkout" else
                   args.sass.with_name(f"{args.sass.stem}_{who}.sass"))
        for mode, res in sass_estimates(so, dst).items():
            key = f"{mode}_sass" + ("" if who == "checkout" else f"_{who}")
            out[key] = res
            print(f"{mode} SASS ({who}): {res}", flush=True)

    order = (["checkout", *refs, *reversed(list(refs)), "checkout"] if refs
             else ["checkout"])
    for mode, fn in cs.PLL_WRAPPERS.items():
        coef = ops[mode].coef()
        times = {who: {} for who in kernels}
        for C, B in ((1024, 512), (1024, 2048), (1024, 8192), (32, 2048),
                     (1, 2048)):
            x, st, _ = cs.pll_test_input(rng, C, B, mode, dev)
            cases = {f"{C}x{B}": (x, st)}
            if C == 32:
                cases["32x2048 same"] = (x[:1].repeat(32, 1),
                                         tuple(s[:1].repeat(32) for s in st))
            if B == 2048 and C == 1024:
                cases["1024x2048 zeros"] = (torch.zeros_like(x), st)
            for label, (xc, sc) in cases.items():
                ms = {who: [] for who in kernels}
                for who in order:
                    with kernel_of(kernels[who]):
                        ms[who].append(timed(lambda: fn(xc, sc, coef)))
                for who in kernels:
                    times[who][label] = sum(ms[who]) / len(ms[who])
        for who, t in times.items():
            slope_ns = (t["1024x8192"] - t["1024x512"]) / (8192 - 512) * 1e6
            key = "" if who == "checkout" else f"_{who}"
            out[f"{mode}_ms{key}"] = t
            out[f"{mode}_ns_per_sample{key}"] = slope_ns
            print(f"{mode} ({who}) times (ms) {t}; {slope_ns:.2f} ns a "
                  f"sample (slope over B at C=1024) = "
                  f"{slope_ns * clock / 1e3:.0f} cycles at {clock:.0f} MHz",
                  flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
