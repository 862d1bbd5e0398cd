#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (quisk_tpu_torch).

Drives the port's main path on one CUDA card: the flagship receiver
(960 kS/s in, 1024 channels cycling USB/LSB/AM/FM, the whole /20 cascade
fused into the hand-written front kernel, 1025-tap overlap-save channel
filter, mixed demod, lookahead AGC, 2048-sample audio blocks).  Phases,
each fatal on failure:

1. environment: the card's name and power limit; build every kernel in
   quisk_tpu_torch/csrc/ (one nvcc each, started together);
2. the fused tune+decimate kernel at a small half-band shape whose tile
   N does not fill (>= 100 dB against the float64 reference; taps too
   long for shared memory must raise), then at the flagship shape
   (C=1024, B=40960, T=1421, d=20) over 2 streamed blocks: >= 100 dB
   against the float64 reference, max abs difference to the plain
   PyTorch version within 1e-4 of the output's peak;
3. the flagship RxChain on the card for 8 blocks of seeded noise with a
   carrier 1 kHz above channel 0's dial (USB): finite [1024, 2048]
   audio per block, the 1 kHz beat recovered, one kernel launch per
   block, and channels 0-7 equal (> 90 dB from block 2 on, FM by RMS)
   to the same chain run on the CPU;
4. timing with CUDA events after warm-up: ms per block, input Msps, the
   real-time factor, per-stage times, and per kernel its ms, the plain
   version's ms, the bound and a one-call PyTorch yardstick.

Prints, before the last line, the card's name and power limit and one
JSON object of kernels; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
``--out FILE`` also writes every number measured to FILE as JSON.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.ops.fused_front import (fused_tune_decimate,
                                             fused_tune_decimate_plain,
                                             fused_tune_decimate_reference)
from quisk_tpu_torch.rx import RxChain, RxChainConfig

FS = 960000.0
C = 1024
AUDIO_BLOCK = 2048
MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]
MODE = [MODES[i % 4] for i in range(C)]
TUNE = [(-FS / 4 + (i + 0.5) * FS / (2 * C)) for i in range(C)]
BEAT_HZ = 1000.0
N_BLOCKS = 8
SEED = 0
DEVICE = "cuda"
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, fp32 non-tensor
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
KERNEL_TOL = 1e-4          # max |kernel - plain| relative to max |plain|
KERNEL_SNR_DB = 100.0      # kernel vs float64 reference
CPU_MATCH_DB = 90.0        # card chain vs CPU chain, non-FM rows


def snr_db(ref, got) -> float:
    ref = ref.to(torch.complex128)
    err = got.to(torch.complex128) - ref
    return float(10 * torch.log10(torch.mean(torch.abs(ref) ** 2)
                                  / torch.mean(torch.abs(err) ** 2)))


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def noise_blocks(rng, n: int, B: int) -> list[np.ndarray]:
    out = []
    for _ in range(n):
        x = np.empty((C, B), np.complex64)
        x.real = rng.standard_normal((C, B), dtype=np.float32)
        x.imag = rng.standard_normal((C, B), dtype=np.float32)
        out.append(x)
    return out


def phase_environment(report: dict) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    built = _kernels.build()
    secs = time.perf_counter() - t0
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    print(f"kernels built: {sorted(built) or 'cached'} in {secs:.2f} s",
          flush=True)
    report.update(card=smi, build_s=secs)
    return smi


def check_tile_choice(dev, rng) -> None:
    """The launcher's tile rule off the flagship shape: a half-band /2 with
    N=100 outputs (a tile below 256 that N does not fill), and taps too
    long for one block's shared memory, which must raise."""
    h_rev = torch.as_tensor(design.halfband(45)[::-1].astype(np.float32),
                            device=dev)
    Cs, B, T, d = 8, 200, 45, 2
    x = torch.as_tensor(noise_blocks(rng, 1, B)[0][:Cs], device=dev)
    hist = torch.as_tensor(noise_blocks(rng, 1, T - 1)[0][:Cs], device=dev)
    word = torch.as_tensor(rng.integers(0, 2 ** 32, Cs), device=dev)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, Cs), device=dev)
    y = fused_tune_decimate(x, hist, word, phase0, h_rev, d)
    y_ref = fused_tune_decimate_reference(x, hist, word, phase0, h_rev, d)
    snr = snr_db(y_ref, y)
    print(f"  kernel at C={Cs}, B={B}, T={T}, d={d}: {snr:.2f} dB vs "
          f"float64", flush=True)
    assert y.shape == (Cs, B // d) and snr >= KERNEL_SNR_DB, snr
    T, B = 200001, 40
    try:
        fused_tune_decimate(x[:1, :B].contiguous(), torch.zeros(
            (1, T - 1), dtype=torch.complex64, device=dev), word[:1],
            phase0[:1], torch.ones(T, device=dev), 20)
    except ValueError as e:
        print(f"  {T} taps at d=20 refused: {e}", flush=True)
    else:
        raise AssertionError(f"{T} taps at d=20 launched")


def phase_kernel(report: dict, rng) -> dict:
    dev = torch.device(DEVICE)
    check_tile_choice(dev, rng)
    op = RxChain.create(flagship_config(), tune_hz=TUNE, mode=MODE,
                        device=dev).front
    B, T, d = op.block, op.ntaps, op.decim
    assert (B, T, d) == (40960, 1421, 20), (B, T, d)
    st = op.init_state(C)
    count0 = fused_tune_decimate.launches
    max_err, snrs = 0.0, []
    for x_np in noise_blocks(rng, 2, B):
        x = torch.as_tensor(x_np, device=dev)
        phase0, hist = st
        st, y = op(st, x)
        y_plain = fused_tune_decimate_plain(x, hist, op.word, phase0,
                                            op.h_rev, d)
        y_ref = fused_tune_decimate_reference(x, hist, op.word, phase0,
                                              op.h_rev, d)
        torch.cuda.synchronize()
        assert y.shape == (C, B // d) and bool(torch.isfinite(
            torch.view_as_real(y)).all())
        snr = snr_db(y_ref, y)
        err = float(torch.max(torch.abs(y - y_plain)))
        peak = float(torch.max(torch.abs(y_plain)))
        print(f"  kernel vs float64 {snr:.2f} dB, plain vs float64 "
              f"{snr_db(y_ref, y_plain):.2f} dB, max|kernel-plain| "
              f"{err:.3e} (peak {peak:.3f})", flush=True)
        assert snr >= KERNEL_SNR_DB, f"kernel SNR {snr} dB"
        assert err <= KERNEL_TOL * peak, f"kernel vs plain {err}"
        max_err = max(max_err, err)
        snrs.append(snr)
    rose = fused_tune_decimate.launches - count0
    assert rose == 2, f"launch counter rose by {rose}"
    report["kernel_check"] = {"snr_db": snrs, "max_abs_err": max_err}
    return {"op": op, "x": x, "st": st, "max_abs_err": max_err}


def flagship_config() -> RxChainConfig:
    return RxChainConfig(sample_rate=FS, channels=C, audio_block=AUDIO_BLOCK,
                         agc=True, fused_frontend=True)


def phase_main_path(report: dict, rng):
    dev = torch.device(DEVICE)
    chain = RxChain.create(flagship_config(), tune_hz=TUNE, mode=MODE,
                           device=dev)
    assert chain.front is not None and chain.front.decim == 20
    assert not chain.stages and chain.device.type == dev.type
    B = chain.block_in
    blocks = noise_blocks(rng, N_BLOCKS, B)
    n = np.arange(N_BLOCKS * B, dtype=np.float64)
    carrier = np.exp(2j * np.pi * (TUNE[0] + BEAT_HZ) * n / FS)
    for i, x in enumerate(blocks):
        x[0] += carrier[i * B:(i + 1) * B].astype(np.complex64)

    st = chain.init_state()
    audio = []
    fused_tune_decimate.launches = 0
    for x in blocks:
        st, a = chain.step(st, torch.as_tensor(x, device=dev))
        audio.append(a)
    torch.cuda.synchronize()
    launches = fused_tune_decimate.launches
    print(f"  main path: {N_BLOCKS} blocks, fused front launches "
          f"{launches}", flush=True)
    assert launches == N_BLOCKS, launches
    for a in audio:
        assert a.shape == (C, AUDIO_BLOCK) and a.dtype == torch.float32
        assert bool(torch.isfinite(a).all())

    a0 = torch.cat([a[0] for a in audio[2:]]).cpu().numpy().astype(
        np.float64)
    spec = np.abs(np.fft.rfft(a0 * np.hanning(a0.size)))
    freqs = np.fft.rfftfreq(a0.size, 1.0 / chain.fs_audio)
    f_peak = float(freqs[np.argmax(spec)])
    contrast = float(20 * np.log10(spec.max() / np.median(spec)))
    print(f"  channel 0 (USB) beat note at {f_peak:.1f} Hz, "
          f"{contrast:.1f} dB over the median bin", flush=True)
    assert abs(f_peak - BEAT_HZ) <= 30.0, f_peak
    assert contrast > 20.0, contrast

    # the same chain on the CPU for channels 0-7 (channels are independent)
    cpu_cfg = RxChainConfig(sample_rate=FS, channels=8,
                            audio_block=AUDIO_BLOCK, agc=True,
                            fused_frontend=True)
    cpu = RxChain.create(cpu_cfg, tune_hz=TUNE[:8], mode=MODE[:8],
                         device="cpu")
    cst = cpu.init_state()
    cpu_out = []
    # one CPU thread: torch's intra-op workers have been seen to return
    # cos/sin ~1e-4 off for a whole chunk on some hosts
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(4):
            cst, ca = cpu.step(cst, torch.as_tensor(blocks[i][:8]))
            cpu_out.append(ca)
    finally:
        torch.set_num_threads(threads)
    worst = []
    for i, ca in enumerate(cpu_out):
        if i < 2:
            continue               # AGC lookahead: first blocks near silent
        ga = audio[i][:8].cpu().to(torch.float64)
        ca = ca.to(torch.float64)
        for r in range(8):
            s = snr_db(ca[r], ga[r])
            if MODE[r] == int(Mode.FM) and s <= CPU_MATCH_DB:
                db = 20 * np.log10(float(ga[r].pow(2).mean().sqrt()
                                         / ca[r].pow(2).mean().sqrt()))
                assert abs(db) < 0.1, (i, r, s, db)
            else:
                assert s > CPU_MATCH_DB, (i, r, s)
            worst.append(s)
    print(f"  card vs CPU chain, channels 0-7, blocks 2-3: min "
          f"{min(worst):.1f} dB", flush=True)
    report["main_path"] = {"blocks": N_BLOCKS, "launches": launches,
                           "beat_hz": f_peak, "beat_contrast_db": contrast,
                           "cpu_match_min_db": min(worst)}
    return chain, blocks, launches


def phase_timing(report: dict, smi: str, chain, blocks, kern: dict):
    dev = torch.device(DEVICE)
    B = chain.block_in
    xs = [torch.as_tensor(blocks[i], device=dev) for i in range(2)]
    state = {"st": chain.init_state(), "i": 0}

    def step():
        state["st"], _ = chain.step(state["st"], xs[state["i"] % 2])
        state["i"] += 1

    ms_block = cuda_ms(step, iters=20, warmup=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    budget_ms = B / FS * 1e3
    msps = C * B / (ms_block * 1e-3) / 1e6

    # per-stage device times on this block's real intermediates
    st = chain.init_state()
    x = xs[0]
    _, y_front = chain.front(st["front"], x)
    _, y_bp = chain.bp(st["bp"], y_front)
    _, aud = chain.demod(st["demod"], y_bp)
    stages = {
        "front": cuda_ms(lambda: chain.front(st["front"], x), 10),
        "channel_filter": cuda_ms(lambda: chain.bp(st["bp"], y_front), 10),
        "demod": cuda_ms(lambda: chain.demod(st["demod"], y_bp), 10),
        "agc": cuda_ms(lambda: chain.agc(st["agc"], aud), 10),
    }

    op, xk, (phase0, hist) = kern["op"], kern["x"], kern["st"]
    T, d = op.ntaps, op.decim
    N = op.block // d
    args = (xk, hist, op.word, phase0, op.h_rev, d)
    k_ms = cuda_ms(lambda: fused_tune_decimate(*args), 20)
    p_ms = cuda_ms(lambda: fused_tune_decimate_plain(*args), 5)

    # yardstick, never called by the port: torch mix + cuDNN strided
    # conv1d in full fp32 (TF32 off for the call)
    w = op.h_rev.view(1, 1, T)             # conv1d correlates: h reversed

    def library():
        ext = torch.cat([hist, xk], dim=-1)
        nn = torch.arange(ext.shape[-1], device=dev)
        ph = (phase0[:, None] + op.word[:, None] * nn) & 0xFFFFFFFF
        ph = ph - (ph >= (1 << 31)).long() * (1 << 32)
        ang = ph.float() * float(np.float32(2 * np.pi / 2 ** 32))
        tuned = ext * torch.polar(torch.ones_like(ang), -ang)
        iq = torch.view_as_real(tuned).permute(0, 2, 1).reshape(2 * C, 1, -1)
        return torch.nn.functional.conv1d(iq, w, stride=d)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_ms = cuda_ms(library, 5)
        lib_y = library().view(C, 2, N)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    lib_err = float(torch.max(torch.abs(
        torch.complex(lib_y[:, 0], lib_y[:, 1])
        - fused_tune_decimate_plain(*args))))

    nbytes = (C * (op.block + T - 1) * 8 + C * N * 8 + T * 4 + 2 * C * 8)
    flops = C * N * T * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"

    print(f"timing [{smi}]:", flush=True)
    print(f"  flagship step {ms_block:.4f} ms/block (device events), "
          f"{host_ms:.4f} ms/block (host clock), {msps:.1f} Msps in, "
          f"real-time factor {budget_ms / ms_block:.2f}x of "
          f"{budget_ms:.2f} ms", flush=True)
    print("  stages (ms): " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in stages.items()))
    print(f"  fused_tune_decimate {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms (max|lib-plain| {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    report["timing"] = {"ms_per_block": ms_block,
                        "host_ms_per_block": host_ms, "msps": msps,
                        "budget_ms": budget_ms,
                        "realtime_factor": budget_ms / ms_block,
                        "stages_ms": stages}
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    report: dict = {"torch": torch.__version__, "cuda": torch.version.cuda}
    rng = np.random.default_rng(SEED)
    smi = phase_environment(report)
    kern = phase_kernel(report, rng)
    chain, blocks, launches = phase_main_path(report, rng)
    times = phase_timing(report, smi, chain, blocks, kern)
    kernels = [{"name": "fused_tune_decimate", "route": "cuda",
                "source": "quisk_tpu_torch/csrc/fused_tune_decimate.cu",
                "replaces": "quisk_tpu/ops/pallas_kernels.py:137",
                "launches": launches,
                "max_abs_err": kern["max_abs_err"], **times}]
    report["kernels"] = kernels
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**report, "device": device}, f, indent=1)
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
