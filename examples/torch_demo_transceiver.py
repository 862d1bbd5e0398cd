"""Demo: a full transmit -> receive loopback session on quisk_tpu_torch,
headless.

The PyTorch/CUDA counterpart of examples/demo_transceiver.py.  Drives the
TX chain (mic bandpass, pre-emphasis, compressor, conformance ALC,
SSB/FM/CW modulators, polyphase interpolation to the TX rate), then
demodulates its own transmission with the RX chain — the reference's
DEBUG_MIC self-test flow (sound.c:886-888, 1090-1099) as a demo:

  voice -> TxChain (SSB @192k) -> RxChain (USB) -> audio WAV
  voice -> TxChain (FM + CTCSS) -> RxChain (FM) -> audio WAV
  two-tone IMD through a nonlinear PA, before/after the closed
  PureSignal predistortion loop (wdsp/calcc.c flow)

    python examples/torch_demo_transceiver.py [--out-dir /tmp/demo_tx] [--cpu]

Runs on the CUDA card by default and raises without one; --cpu runs it on
the CPU.  Every TX chain here carries the conformance ALC, whose
recurrence is one launch of the hand-written kernel csrc/agc_scan.cu
(mode kTxAlc) a TX step on the card (its plain version on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quisk_tpu_torch._device import resolve_device  # noqa: E402

OUT_DIR = "/tmp/quisk_tpu_demo_tx"
B = 2048


def loopback(mode_tx: str, mode_rx: str, blocks: int = 10,
             ctcss_hz: float = 0.0, device=None, voice=None):
    """``blocks`` of mic audio through the TX chain at 192 kS/s into the
    RX chain; returns (mic audio, demodulated audio), host float32.  The
    mic audio is ``voice`` ([blocks * 2048] float) or voice-like noise."""
    from quisk_tpu_torch.io import sources
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.rx import RxChain, RxChainConfig
    from quisk_tpu_torch.tx import TxChain, TxChainConfig

    dev = resolve_device(device)
    tx = TxChain.create(
        TxChainConfig(channels=1, audio_block=B, tx_rate=192000.0,
                      compress_db=6.0, preemphasis=0.3, ctcss_hz=ctcss_hz),
        mode=int(Mode[mode_tx]), device=dev)
    rx = RxChain.create(
        RxChainConfig(sample_rate=192000.0, channels=1, audio_block=B,
                      agc=True),
        tune_hz=0.0, mode=int(Mode[mode_rx]), device=dev)
    if voice is None:
        voice = sources.voice_like(48000.0, blocks * B)
    voice = np.asarray(voice, np.float32)
    mic = torch.as_tensor(voice[None], device=dev)
    st_tx, st_rx = tx.init_state(), rx.init_state()
    outs = []
    for i in range(blocks):
        st_tx, iq = tx.step(st_tx, mic[:, i * B:(i + 1) * B])
        st_rx, audio = rx.step(st_rx, iq)
        outs.append(audio)
    return voice, torch.cat(outs, dim=-1)[0].cpu().numpy()


def imd_demo(device=None):
    """Two-tone IMD through a compressive PA, then the closed PureSignal
    loop: reference run (no correction) vs corrected run, refined twice —
    the same flow Radio.calibrate_puresignal drives (wdsp/calcc.c;
    microphone.c:1581 PreDistort)."""
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.tx import TxChain, TxChainConfig
    from quisk_tpu_torch.tx.puresignal import SimulatedPA, two_tone_imd_db

    dev = resolve_device(device)
    tx = TxChain.create(
        TxChainConfig(channels=1, audio_block=B, tx_rate=48000.0,
                      predistort=True),
        mode=int(Mode.IMD), device=dev)  # chain generates the 700+1900 tones
    tx_ref = dataclasses.replace(tx, predist=None)
    pa = SimulatedPA()
    zero = torch.zeros((1, B), dtype=torch.float32, device=dev)

    def on_air(chain):
        st = chain.init_state()
        for _ in range(4):
            st, iq = chain.step(st, zero)
        return iq[0].cpu().numpy()

    before = two_tone_imd_db(pa(on_air(tx_ref)), 48000.0, 700.0, 1900.0)

    pd = tx.predist
    for _ in range(2):                   # capture -> refine -> install
        st_r, st_d = tx_ref.init_state(), tx.init_state()
        refs, fbs = [], []
        for _ in range(4):
            st_r, iq_r = tx_ref.step(st_r, zero)
            st_d, iq_d = tx.step(st_d, zero)
            refs.append(iq_r[0].cpu().numpy())
            fbs.append(pa(iq_d[0].cpu().numpy()))
        pd = pd.refine(np.concatenate(refs), np.concatenate(fbs))
        tx = dataclasses.replace(tx, predist=pd)

    after = two_tone_imd_db(pa(on_air(tx)), 48000.0, 700.0, 1900.0)
    return before, after


def live_session(blocks: int = 20, device=None):
    """Mic-file -> TX -> simulated PA -> RX loopback, LIVE through the
    full-duplex Radio.run_once block loop: the paced capture thread feeds
    the mic, PTT keys the loop, the loopback hardware plays the PA output
    back at the dial offset, and tx_monitor (the reference's DEBUG_MIC
    self-test, sound.c:886-888) lets us hear our own demodulated signal.
    Returns (mic voice, demodulated audio, smeter dB while transmitting)."""
    from quisk_tpu_torch.app.config import RadioConfig
    from quisk_tpu_torch.app.radio import Radio
    from quisk_tpu_torch.io import sources

    # agc off so the recovered audio keeps the voice envelope (AGC rides
    # syllables; its conformance is tested separately)
    cfg = RadioConfig(sample_rate=48000.0, audio_block=B, mode="USB",
                      tune_hz=9000.0, agc=False)
    radio = Radio(cfg, hardware="loopback", device=device)
    radio.open()
    radio.enable_tx()
    radio.tx_monitor = True
    # warm the RX and TX paths BEFORE starting the paced mic: a kernel's
    # first use builds it with nvcc, which stalls the loop for seconds,
    # and the capture thread (correctly) ages out a bounded-latency
    # buffer meanwhile
    radio.run_once()
    radio.transmit(np.zeros(radio.tx.block, np.float32), ptt=True)
    voice = sources.voice_like(48000.0, blocks * B, band=(400.0, 2300.0))
    voice = (0.5 * voice / np.max(np.abs(voice))).astype(np.float32)
    radio.enable_mic(voice, latency_ms=2000.0)
    t0 = time.time()
    while radio.mic.fill < blocks * radio.tx.block and time.time() - t0 < 8.0:
        time.sleep(0.01)
    radio.set_ptt(True)
    outs = []
    for _ in range(blocks):
        outs.append(radio.run_once()[0])
    smeter = radio.smeter_db()
    radio.set_ptt(False)
    radio.run_once()
    radio.close()
    return voice, np.concatenate(outs), smeter


def run(device=None, out_dir: str = OUT_DIR) -> dict:
    """The three parts on ``device`` (None: the card), printing what the
    reference prints and writing its WAVs; returns each part's arrays and
    host seconds."""
    from quisk_tpu_torch.io.wav import write_audio_wav

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    out: dict = {"seconds": {}}
    for name, mtx, mrx, ctcss in (("ssb", "USB", "USB", 0.0),
                                  ("fm", "FM", "FM", 88.5)):
        t0 = time.perf_counter()
        voice, audio = loopback(mtx, mrx, ctcss_hz=ctcss, device=dev)
        out["seconds"][f"loopback_{name}"] = time.perf_counter() - t0
        out[name] = (voice, audio)
        path = os.path.join(out_dir, f"loopback_{name}.wav")
        write_audio_wav(path, audio / max(1e-9, float(np.max(np.abs(audio)))),
                        48000.0)
        print(f"{name}: TX->RX loopback audio rms "
              f"{np.std(audio[4 * 2048:]):.3f} -> {path}")

    t0 = time.perf_counter()
    out["imd"] = imd_demo(dev)
    out["seconds"]["imd"] = time.perf_counter() - t0
    before, after = out["imd"]
    print(f"two-tone IMD through PA: {before:.1f} dBc raw, "
          f"{after:.1f} dBc with PureSignal predistortion")

    t0 = time.perf_counter()
    voice, audio, smeter = out["live"] = live_session(device=dev)
    out["seconds"]["live"] = time.perf_counter() - t0
    path = os.path.join(out_dir, "live_loopback.wav")
    write_audio_wav(path, audio / max(1e-9, float(np.max(np.abs(audio)))),
                    48000.0)
    print(f"live full-duplex session: mic-file -> TX -> PA -> RX loopback, "
          f"own signal S-meter {smeter:.1f} dBFS, audio rms "
          f"{np.std(audio[4 * 2048:]):.3f} -> {path}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=OUT_DIR)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    run("cpu" if args.cpu else None, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
