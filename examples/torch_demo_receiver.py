"""Demo: a complete multi-channel receiver session on quisk_tpu_torch,
headless.

The PyTorch/CUDA counterpart of examples/demo_receiver.py.  Synthesizes a
busy 960 kHz band (SSB voice, AM broadcast, NFM, CW), builds a 4-channel
receiver tuned to each signal with per-channel modes, runs the full chain
(noise blanker, channel filters, demod, AGC), renders a spectrum +
waterfall, and writes per-channel audio WAVs.

    python examples/torch_demo_receiver.py [--out-dir /tmp/demo] [--cpu]

Runs on the CUDA card by default and raises without one; --cpu runs it on
the CPU.  The capture crosses to the device once and each block is
expanded there for the four sub-receivers.  The chain keeps the
reference's unfused front end, so this program launches none of the
port's hand-written kernels.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quisk_tpu_torch._device import resolve_device  # noqa: E402

OUT_DIR = "/tmp/quisk_tpu_demo"
FS = 960_000.0


def synth_band(fs: float, n: int):
    """A band with four stations; returns (iq, station list)."""
    from quisk_tpu_torch.app.cw import text_to_key_samples
    from quisk_tpu_torch.io import sources
    t = np.arange(n) / fs
    stations = [
        ("SSB voice", -310_000.0, "USB"),
        ("AM broadcast", -90_000.0, "AM"),
        ("NFM repeater", 140_000.0, "FM"),
        ("CW beacon", 355_000.0, "CWU"),
    ]
    iq = np.zeros(n, np.complex128)
    n48 = n * 48_000 // int(fs)
    voice = sources.voice_like(48e3, n48, band=(300.0, 2700.0))
    iq += 0.5 * np.repeat(sources.ssb_signal(voice, 48e3), 20)[:n] \
        * np.exp(2j * np.pi * stations[0][1] * t)
    am_audio = sources.voice_like(48e3, n48, seed=1, band=(100.0, 4000.0))
    iq += 0.4 * np.repeat(sources.am_signal(am_audio, 48e3, depth=0.8),
                          20)[:n] * np.exp(2j * np.pi * stations[1][1] * t)
    fm_audio = sources.voice_like(48e3, n48, seed=2, band=(300.0, 2500.0))
    iq += 0.4 * np.repeat(sources.fm_signal(fm_audio, deviation_hz=5e3,
                                            fs=48e3), 20)[:n] \
        * np.exp(2j * np.pi * stations[2][1] * t)
    key = text_to_key_samples("cq cq de quisk tpu", 22.0, fs)
    key = np.resize(key, n)
    iq += 0.3 * key * np.exp(2j * np.pi * (stations[3][1] + 600.0) * t)
    iq += 1e-4 * (np.random.default_rng(0).standard_normal(n)
                  + 1j * np.random.default_rng(1).standard_normal(n))
    return iq.astype(np.complex64), stations


def wav_name(station: str) -> str:
    return station.lower().replace(" ", "_") + ".wav"


def run(device=None, seconds: float = 1.0, out_dir: str = OUT_DIR) -> dict:
    """The session on ``device`` (None: the card): prints what the
    reference prints, writes the WAVs and returns the audio [4, n] (host
    float32), the stations, the audio rate, the block count and the host
    seconds of the block loop."""
    from quisk_tpu_torch.app.graph import GraphService, WaterfallRenderer
    from quisk_tpu_torch.io import wav
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.rx import RxChain, RxChainConfig

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)

    cfg = RxChainConfig(sample_rate=FS, channels=4, audio_block=2048,
                        agc=True, noise_blanker=2)
    # one block to know sizes
    probe = RxChain.create(cfg, tune_hz=0.0, mode=int(Mode.USB), device=dev)
    n = max(2, int(seconds * FS / probe.block_in)) * probe.block_in
    iq, stations = synth_band(FS, n)
    print(f"band: {FS/1e3:.0f} kHz wide, {n/FS:.2f} s;")
    for name, f, m in stations:
        print(f"  {name:14s} at {f/1e3:+8.1f} kHz  [{m}]")

    chain = RxChain.create(
        cfg, tune_hz=[f for _, f, _ in stations],
        mode=[int(Mode[m]) for _, _, m in stations], device=dev)

    gs = GraphService(fft_size=4096, block=probe.block_in, channels=1,
                      sample_rate=FS, pixels=96, device=dev)
    wf = WaterfallRenderer(pixels=96, rows=64)

    B = chain.block_in
    x = torch.as_tensor(iq, device=dev)
    st = chain.init_state()
    outs = []
    t0 = time.perf_counter()
    for i in range(n // B):
        blk = x[None, i * B:(i + 1) * B]
        # all four sub-receivers share the one antenna stream
        st, a = chain.step(st, blk.expand(chain.channels, B))
        outs.append(a)
        tr = gs.feed(blk)
        if tr is not None:
            wf.add_row(tr[0])
    audio = torch.cat(outs, dim=-1).cpu().numpy()
    loop_s = time.perf_counter() - t0

    # ASCII spectrum
    tr = gs.feed(x[None, :B])
    db = wf.pixels()[0].astype(float).sum(-1) if tr is None else tr[0]
    lo, hi = np.percentile(db, 5), db.max()
    bars = " .:-=+*#%@"
    line = "".join(bars[int(np.clip((v - lo) / (hi - lo + 1e-9), 0, 0.999)
                            * len(bars))] for v in db)
    print("\nspectrum (-480 .. +480 kHz):")
    print(line)

    for (name, f, m), ch in zip(stations, audio):
        path = os.path.join(out_dir, wav_name(name))
        peak = np.max(np.abs(ch)) + 1e-9
        wav.write_audio_wav(path, ch / max(1.0, peak), chain.fs_audio)
        print(f"wrote {path} ({len(ch)} samples, rms "
              f"{np.sqrt(np.mean(ch**2)):.3f})")
    print(f"waterfall: {wf.pixels().shape} rows rendered")
    return {"audio": audio, "stations": stations, "fs_audio": chain.fs_audio,
            "blocks": n // B, "loop_s": loop_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run("cpu" if args.cpu else None, args.seconds, args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
