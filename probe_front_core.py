#!/usr/bin/env python3
"""Hold the front kernel against another build of it on one CUDA card.

Builds ``quisk_tpu_torch/csrc/fused_tune_decimate.cu`` as the port does
and a second source of the same kernel (``--ref``, e.g. an earlier
version taken with ``git show <commit>:quisk_tpu_torch/csrc/
fused_tune_decimate.cu``), one nvcc each, started together, and binds the
second with ``fused_front.bind``.  Then, on the same inputs:

1. the kernel at the flagship shape (plain mode: C=1024, B=40960, T=1421,
   d=20), the featured shape (NB-detect mode, avg_win 64, kwidth 961,
   impulses) and the NFM shape (plain: B=8192, T=133, d=4): both builds
   held to the plain PyTorch version (within 1e-4 of the peak), their
   outputs compared bit for bit, and both timed with CUDA events (20 calls
   after 3 of warm-up, in the order checkout, ref, ref, checkout);
2. the featured RxChain of ``chip_smoke.py`` over 8 blocks, through the
   checkout's kernel, the ref's, and the checkout's again: the audio of
   every channel and block compared bit for bit, and each card run held
   to the CPU chain on channels 0-7 by ``chip_smoke.py``'s featured gate.
   The blocks are those that ``chip_smoke.py`` feeds its featured phase,
   its seeded stream taken through the same draws (its kernel checks
   before that phase run again and print their peaks): as the script
   draws them now, and as they were when the plain mode's edge shapes
   still drew from the main stream (``EARLIER_EDGE_SHAPES``, at a
   1024-output tile).

Prints the card, a line per comparison and timing; ``--out FILE`` writes
the numbers as JSON.  Exits non-zero without a card, or when a build
disagrees with the plain version.

Run from the repository root:
    git show <commit>:quisk_tpu_torch/csrc/fused_tune_decimate.cu > old.cu
    python3 probe_front_core.py --ref old.cu
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from quisk_tpu_torch import _kernels
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import fused_front as ff
from quisk_tpu_torch.rx import RxChain

# (channels, block, taps, decim, words) of the plain mode's edge shapes as
# an earlier chip_smoke.py drew them from its main stream before the
# featured phase, when the full tile was 1024 outputs
EARLIER_EDGE_SHAPES = ((3, 2, 45, 2, None), (4, 891, 61, 3, None),
                    (2, 4092, 133, 4, None), (3, 200, 1, 2, None),
                    (3, 500, 3, 5, None), (2, 6000, 1440, 20, None),
                    (2, 315, 45, 5, None), (2, 700, 33, 1, None),
                    (2, 640, 45, 2, (0, 2 ** 31 + 12345)))


def build_ref(src: Path) -> tuple[dict, list[str]]:
    """The checkout's kernel (built as the port builds it) and ``src``
    compiled together; returns the ref's bound launchers and its ptxas
    lines."""
    out_dir = _kernels.BUILD_DIR / "ref"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{src.stem}.so"
    proc = subprocess.Popen(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _kernels.build(["fused_tune_decimate"])
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"build of {src} failed:\n{log}")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    launchers = [n for n in ff._SIGNATURES if not n.endswith("_plan")]
    return ff.bind(ctypes.CDLL(str(lib)), launchers), ptxas


@contextlib.contextmanager
def kernel_of(launchers):
    """Route the port's front wrappers to ``launchers`` (None: the
    checkout's own) inside the block."""
    saved = ff._launchers
    if launchers is not None:
        ff._launchers = lambda: launchers
    try:
        yield
    finally:
        ff._launchers = saved


def kernel_cases(dev, rng) -> dict:
    """{label: (wrapper, args, plain)} at the three path shapes."""
    def front(cfg, tune, mode):
        return RxChain.create(cfg, tune_hz=tune, mode=mode, device=dev).front

    def args_of(op, impulses):
        B, T = op.block, op.ntaps
        x = cs.noise_blocks(rng, 1, B)[0]
        if impulses:
            cs.add_impulses(rng, x)
        hist = cs.noise_blocks(rng, 1, T - 1)[0]
        phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, cs.C), device=dev)
        return (torch.as_tensor(x, device=dev),
                torch.as_tensor(hist, device=dev), op.word, phase0, op.h_rev,
                op.decim)

    flag = front(cs.flagship_config(), cs.TUNE, cs.MODE)
    feat = front(cs.featured_config(), cs.TUNE, cs.MODE)
    nfm = front(cs.nfm_config(), [(-cs.FS_NFM / 4 + (i + 0.5) * cs.FS_NFM
                                   / (2 * cs.C)) for i in range(cs.C)],
                int(Mode.FM))
    nb_tail = (torch.ones((cs.C, feat.gain_hist_groups), device=dev),
               torch.ones((cs.C, 1), device=dev),
               torch.tensor(4.0, device=dev), feat.rc, feat.avg_win)
    a_flag, a_feat, a_nfm = (args_of(flag, False), args_of(feat, True),
                             args_of(nfm, False))
    return {
        "flagship plain": (ff.fused_tune_decimate, a_flag,
                           ff.fused_tune_decimate_plain(*a_flag)),
        "featured NB-detect": (
            ff.fused_tune_decimate_nb, a_feat + nb_tail,
            ff.fused_tune_decimate_nb_plain(*a_feat, *nb_tail)[0]),
        "NFM plain": (ff.fused_tune_decimate, a_nfm,
                      ff.fused_tune_decimate_plain(*a_nfm)),
    }


def compare_kernels(dev, ref) -> list[dict]:
    rows = []
    for label, (fn, args, want) in kernel_cases(
            dev, np.random.default_rng(cs.SEED)).items():
        outs = {}
        for who, fns in (("checkout", None), ("ref", ref)):
            with kernel_of(fns):
                out = fn(*args)
            torch.cuda.synchronize()
            y = out[0] if isinstance(out, tuple) else out
            peak = float(want.abs().max())
            err = float((y - want).abs().max())
            if not err <= cs.KERNEL_TOL * peak:
                raise AssertionError(f"{label}, {who}: max|kernel-plain| "
                                     f"{err} of a {peak} peak")
            outs[who] = out if isinstance(out, tuple) else (out,)
        same = all(torch.equal(a, b) for a, b in zip(outs["checkout"],
                                                     outs["ref"]))
        differ = sum(int((a != b).sum()) for a, b in zip(outs["checkout"],
                                                         outs["ref"]))
        ms = {"checkout": [], "ref": []}
        for who in ("checkout", "ref", "ref", "checkout"):
            with kernel_of(ref if who == "ref" else None):
                ms[who].append(cs.cuda_ms(lambda: fn(*args), 20, 3))
        print(f"  {label}: outputs bit for bit equal {same} ({differ} "
              f"elements differ); checkout {ms['checkout'][0]:.4f} / "
              f"{ms['checkout'][1]:.4f} ms, ref {ms['ref'][0]:.4f} / "
              f"{ms['ref'][1]:.4f} ms", flush=True)
        rows.append({"shape": label, "bit_equal": same,
                     "elements_differ": differ, "ms": ms})
    return rows


def featured_stream(dev, edge_shapes) -> list[np.ndarray]:
    """The blocks of chip_smoke.py's featured phase: its stream from SEED
    taken through the same draws before that phase, ``edge_shapes`` the
    plain-mode edge shapes drawn from the main stream (none: as it draws
    now).  The kernel checks among those draws run as the script runs them
    and print their outputs' peaks, which witness the stream's state."""
    rng = np.random.default_rng(cs.SEED)
    cs.check_tile_choice(dev, rng)
    for Cn, B, T, d, words in edge_shapes:
        rng.standard_normal(T)
        cs.noise_blocks(rng, 1, B, Cn)
        cs.noise_blocks(rng, 1, T - 1, Cn)
        if words is None:
            rng.integers(0, 2 ** 32, Cn)
        rng.integers(0, 2 ** 32, Cn)
    op = RxChain.create(cs.flagship_config(), tune_hz=cs.TUNE, mode=cs.MODE,
                        device=dev).front
    cs.check_plain_mode(op, cs.noise_blocks(rng, 2, op.block))
    for _ in range(cs.N_BLOCKS):                 # the main path's blocks
        cs.noise_blocks(rng, 1, op.block)
    cs.phase_gain_kernels({}, rng)
    return cs.featured_blocks(rng, cs.N_BLOCKS, op.block)


def featured_gate(audio, cpu_audio, label: str) -> str:
    """chip_smoke.py's featured card-vs-CPU gate: "pass" or the failure."""
    try:
        m = cs.compare_with_cpu(audio, cpu_audio, cs.MODE,
                                cs.FEATURED_FROM_BLOCK, cs.FEATURED_MATCH_DB,
                                label)
        assert m["compared"] >= 3 * (cs.N_BLOCKS - cs.FEATURED_FROM_BLOCK), m
        assert m["fm_compared"] >= 1 and len(m["fm_split"]) <= 1, m
    except AssertionError as e:
        return f"fails: {e.args}"
    return "pass"


def compare_chains(dev, ref) -> list[dict]:
    chain = RxChain.create(cs.featured_config(), tune_hz=cs.TUNE,
                           mode=cs.MODE, device=dev)
    cpu = RxChain.create(dataclasses.replace(cs.featured_config(),
                                             channels=8),
                         tune_hz=cs.TUNE[:8], mode=cs.MODE[:8], device="cpu")
    rows = []
    for stream, shapes in (("as drawn now", ()),
                           ("edge shapes on the main stream",
                            EARLIER_EDGE_SHAPES)):
        print(f"  the stream's draws, {stream}:", flush=True)
        blocks = featured_stream(dev, shapes)
        runs = []
        for fns in (None, ref, None):
            with kernel_of(fns):
                runs.append(cs.run_chain(chain, blocks)[1])
        torch.cuda.synchronize()
        same_ref = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        same_self = all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
        differ = [int((a != b).sum()) for a, b in zip(runs[0], runs[1])]
        _, cpu_audio = cs.one_thread(lambda: cs.run_chain(cpu, blocks,
                                                          rows=8))
        gates = {who: featured_gate(a, cpu_audio, f"{stream}, {who}")
                 for who, a in (("checkout", runs[0]), ("ref", runs[1]))}
        print(f"  featured chain, blocks {stream}: audio of all {cs.C} "
              f"channels, {cs.N_BLOCKS} blocks, checkout vs ref bit for bit "
              f"equal {same_ref} (samples differing per block {differ}), "
              f"checkout vs itself {same_self}; gate checkout: "
              f"{gates['checkout']}; gate ref: {gates['ref']}", flush=True)
        rows.append({"stream": stream, "bit_equal": same_ref,
                     "self_equal": same_self, "differ": differ,
                     "gates": gates})
        del blocks, runs
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", required=True, type=Path,
                    help="another source of fused_tune_decimate.cu")
    ap.add_argument("--out", help="write the numbers to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_front_core: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    ref, ptxas = build_ref(args.ref)
    for line in ptxas:
        print(f"  ptxas ref: {line}")
    kernels = compare_kernels(dev, ref)
    chains = compare_chains(dev, ref)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "ref": str(args.ref), "kernels": kernels,
                       "chains": chains, "ptxas_ref": ptxas}, f, indent=1)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
