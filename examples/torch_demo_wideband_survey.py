"""Demo: live wideband UDP capture -> PFB channelizer -> band survey, on
quisk_tpu_torch.

The PyTorch/CUDA counterpart of examples/demo_wideband_survey.py: the
ingest-to-audio path end-to-end, all for real (sockets, rings, reader
thread, channelizer, demod):

  synthesized multi-station band
    -> jumbo-frame wideband UDP stream (io/native.WidebandStream)
    -> 'wideband' hardware plugin (the native C++ pump when g++ builds it)
    -> PFBRxPipeline (polyphase filterbank + IDFT + per-mode demod +
       per-channel power spectrum)
    -> strongest-channel survey + demodulated AM audio WAV

    python examples/torch_demo_wideband_survey.py [--channels 128] [--cpu]

Runs on the CUDA card by default and raises without one; --cpu runs it on
the CPU.  The polyphase sums run in the hand-written kernel
csrc/pfb_poly.cu (``pallas_poly``), once a block; the IDFT and the
demodulators are torch ops.  The stream is sent as whole 8160-sample
datagrams and paced at 4x real time: a host whose socket buffers are
small loses datagrams to an unpaced sender.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quisk_tpu_torch._device import resolve_device  # noqa: E402

OUT_DIR = "/tmp/quisk_tpu_demo"


def run(device=None, channels: int = 128, blocks: int = 6,
        out_dir: str = OUT_DIR) -> dict:
    """The survey on ``device`` (None: the card): prints what the reference
    prints, writes the AM WAV and returns the AM audio, the mean power
    [K], the pump's stats, the pipeline, the first block on the device,
    the block count and the host seconds of the receive loop."""
    from quisk_tpu_torch.hw import get_hardware
    from quisk_tpu_torch.io import sources, wav
    from quisk_tpu_torch.io.native import WidebandStream
    from quisk_tpu_torch.io.pump import PacketSender
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.ops.channelizer import PFBRxPipeline

    dev = resolve_device(device)
    K = channels
    fs = 16000.0 * K                  # channel rate = 2*fs/K = 32 kHz
    blk = K * 256
    # pad to whole 8160-pair packets (the sender drops a partial tail)
    n = -(-(blocks * blk) // 8160) * 8160 + 8160

    # --- the band: SSB voice, AM broadcast, FM station on channel centers
    plan = [(5, Mode.USB), (K // 3, Mode.AM), (2 * K // 3, Mode.FM)]
    band = np.zeros(n, np.complex128)
    for ch, mode in plan:
        band += 0.5 * sources.station_iq(mode, fs, n, carrier_hz=ch * fs / K,
                                         seed=ch)
    band = sources.awgn(band.astype(np.complex64), snr_db=45.0)

    # --- the receiver: PFB pipeline, mixed per-channel modes
    mode_vec = [int(Mode.USB)] * K
    for ch, mode in plan:
        mode_vec[ch] = int(mode)
    pipe = PFBRxPipeline.create(K, blk, mode_vec, channel_rate=2 * fs / K,
                                pallas_poly=True, device=dev)

    # --- live transport: wideband hw plugin + jumbo-frame UDP sender
    hw = get_hardware("wideband")(n_streams=1, sample_rate=fs)
    print(hw.open())
    addrs = hw.start_pump()
    ws = WidebandStream()
    sender = PacketSender(ws.build, addrs[0], pairs_per_packet=8160)
    tx = threading.Thread(target=sender.send_stream,
                          args=(band,), kwargs=dict(rate_hz=4 * fs))
    tx.start()

    st = pipe.init_state(1)
    audio, got, first = [], 0, None
    pw_acc = torch.zeros(K, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    deadline = time.time() + 60.0
    while got < blocks and time.time() < deadline:
        x = hw.read_samples(blk)
        if x is None:
            time.sleep(0.005)
            continue
        x = torch.as_tensor(x, device=dev)
        if first is None:
            first = x
        st, (a, spec) = pipe(st, x)
        audio.append(a[0])                        # [n_out, K] time-major
        pw_acc += spec[0]
        got += 1
    aud = torch.cat(audio, dim=0).cpu().numpy() if audio else None  # [T, K]
    pw_acc = pw_acc.cpu().numpy()
    loop_s = time.perf_counter() - t0
    tx.join(timeout=10.0)
    stats = hw.pump.stats()
    hw.close()
    sender.close()
    assert got == blocks, f"starved: only {got} blocks"

    pw = 10 * np.log10(pw_acc / got + 1e-12)
    top = sorted(int(c) for c in np.argsort(pw)[::-1][:len(plan)])
    print(f"{K}-channel survey over {fs/1e6:.2f} MHz "
          f"({stats['packets']} packets, {stats['seq_errors']} seq errors):")
    for c in top:
        print(f"  ch {c:4d} @ {c * fs / K / 1e3:8.1f} kHz: {pw[c]:6.1f} dB")
    assert top == sorted(c for c, _ in plan), (top, plan)

    am_ch = plan[1][0]
    a = aud[aud.shape[0] // 3:, am_ch]
    a = a - a.mean()
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "survey_am.wav")
    wav.write_audio_wav(out, (0.9 * a / max(1e-9, np.abs(a).max())
                              ).astype(np.float32), 2 * fs / K)
    print(f"wrote {out} ({len(a)} samples @ {2 * fs / K:.0f} Hz)")
    return {"am_audio": a, "power": pw_acc / got, "stats": stats,
            "top": top, "pipe": pipe, "x": first, "blocks": got,
            "loop_s": loop_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--blocks", type=int, default=6)
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run("cpu" if args.cpu else None, args.channels, args.blocks,
        args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
