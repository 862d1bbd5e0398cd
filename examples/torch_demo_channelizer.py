"""Demo: wideband capture -> polyphase channelizer -> every station at once,
on quisk_tpu_torch.

The PyTorch/CUDA counterpart of examples/demo_channelizer.py: ONE
2x-oversampled DFT filterbank splits the whole band into K uniform
channels in a single pass, a grouped mixed demodulator runs each channel's
mode, and the per-channel power spectrum shows everything on the air at
once.

    python examples/torch_demo_channelizer.py [--channels 256] [--out-dir /tmp/demo] [--cpu]

Runs on the CUDA card by default and raises without one; --cpu runs it on
the CPU.  The polyphase sums run in the hand-written kernel
(``pallas_poly``, csrc/pfb_poly.cu); where K is a multiple of 256 the
stage-2 IDFT and the demodulators run in the fused kernel too
(``pallas_demod``, csrc/pfb_demod.cu), whose audio columns come out
permuted: channel c sits at column ``pipe.chan_pos[c]``.  On the CPU both
take their plain PyTorch versions.
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
BLOCKS = 8


def band(K: int, n: int, fs: float) -> tuple[np.ndarray, list]:
    """Three stations on channel centers, [1, n] complex64, and their
    (channel, name) list."""
    from quisk_tpu_torch.io import sources

    t = np.arange(n) / fs

    # channel c sits at c*fs/K
    def chan_freq(c):
        return c * fs / K if c <= K // 2 else (c - K) * fs / K

    am_audio = sources.voice_like(2 * 48000.0, n, band=(300.0, 2800.0))
    am_audio = 0.8 * am_audio / np.max(np.abs(am_audio))
    stations = [(5, "AM broadcast"), (K - 9, "AM (negative freq)"),
                (17, "carrier")]
    iq = np.zeros(n, np.complex128)
    iq += (1.0 + 0.5 * am_audio) * np.exp(2j * np.pi * chan_freq(5) * t)
    iq += 0.7 * (1.0 + 0.5 * am_audio[::-1]) * np.exp(
        2j * np.pi * chan_freq(K - 9) * t)
    iq += 0.4 * np.exp(2j * np.pi * chan_freq(17) * t)
    iq += 0.02 * (np.random.default_rng(0).standard_normal(n)
                  + 1j * np.random.default_rng(1).standard_normal(n))
    return iq.astype(np.complex64)[None], stations


def run(device=None, channels: int = 256, out_dir: str = OUT_DIR) -> dict:
    """The channelizer on ``device`` (None: the card): prints what the
    reference prints and the route taken, writes the channel-5 WAV and
    returns the audio [K, T] in channel order and the mean power [K] (host
    numpy), the pipeline, the capture [1, n] on the device, the block
    count and the host seconds of the block loop."""
    from quisk_tpu_torch.io import wav
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.ops.channelizer import PFBRxPipeline

    dev = resolve_device(device)
    K = channels
    fs = 48000.0 * K / 2          # channel rate is 2*fs/K = 96 kHz
    blk = K * 1024
    n = BLOCKS * blk
    iq, stations = band(K, n, fs)

    # the fused demod kernel needs K = 128 * K1 with K1 even
    kernels = K % 256 == 0
    pipe = PFBRxPipeline.create(K, blk, [int(Mode.AM)] * K,
                                channel_rate=2.0 * 48000.0, pallas_poly=True,
                                pallas_demod=kernels, device=dev)
    print("route: polyphase kernel (pfb_poly_oversampled), "
          + ("fused stage-2 IDFT + demod kernel (pfb_demod_call)" if kernels
             else "torch-op IDFT and demod (K not a multiple of 256)")
          + f" on {dev.type}")
    x = torch.as_tensor(iq, device=dev)
    st = pipe.init_state(1)
    audio = []
    pw_acc = torch.zeros(K, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    for b in range(BLOCKS):
        st, (a, spec) = pipe(st, x[:, b * blk:(b + 1) * blk])
        audio.append(a[0])
        pw_acc += spec[0]
    # kernel route: [n_out*K1, 128] a block, one frame's flat row in
    # position order; torch-op route: [n_out, K] in channel order
    aud = torch.cat(audio, dim=0).reshape(-1, K)
    if kernels:
        aud = aud[:, torch.as_tensor(pipe.chan_pos, device=dev)]
    aud = aud.T.cpu().numpy()                           # [K, n*2/K]
    pw_acc = pw_acc.cpu().numpy()
    loop_s = time.perf_counter() - t0

    pw = 10 * np.log10(pw_acc / BLOCKS + 1e-12)
    top = np.argsort(pw)[::-1][:5]
    print(f"{K}-channel PFB over {fs/1e6:.2f} MHz; strongest channels:")
    for c in sorted(top):
        f = c * fs / K if c <= K // 2 else (c - K) * fs / K
        print(f"  ch {int(c):4d} @ {f/1e3:+9.1f} kHz: {pw[c]:6.1f} dB")
    for c, name in stations:
        assert pw[c] > pw.mean() + 10, (name, pw[c], pw.mean())

    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "pfb_ch5_am.wav")
    a5 = aud[5] / max(1e-9, np.max(np.abs(aud[5])))
    wav.write_audio_wav(out, (0.9 * a5).astype(np.float32), 2 * 48000.0)
    print(f"wrote {out} ({a5.shape[-1]} samples @ {2*48000.0:.0f} Hz)")
    return {"audio": aud, "power": pw_acc / BLOCKS, "pipe": pipe, "x": x,
            "blocks": BLOCKS, "loop_s": loop_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=256)
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run("cpu" if args.cpu else None, args.channels, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
