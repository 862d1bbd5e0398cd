"""Command-line runner: file in -> audio/spectra/IQ out.

The reference's app surface is a wxPython GUI (quisk.py); this framework's
equivalent headless surface is a CLI over the same capabilities:

  quisk-tpu-torch rx --in iq.wav --out audio.wav --mode USB --tune 7000
  quisk-tpu-torch tx --in audio.wav --out iq.wav --mode LSB
  quisk-tpu-torch spectrum --in iq.wav --pixels 120   (ASCII spectrum)
  quisk-tpu-torch info --in iq.wav              (rates + decimation plan)
  quisk-tpu-torch config list                   (the persisted flags)

(or ``python -m quisk_tpu_torch.app.cli ...``).  ``rx``, ``tx`` and
``spectrum`` run on the card and fail without one; ``--cpu`` runs them on
the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--in", dest="inp", required=True, help="input WAV")
    p.add_argument("--out", dest="out", default=None, help="output WAV")
    p.add_argument("--mode", default="USB",
                   help="CWL/CWU/LSB/USB/AM/FM/DGT_U/DGT_L/DGT_IQ")
    p.add_argument("--tune", type=float, default=0.0,
                   help="tuning offset from center, Hz")
    p.add_argument("--bandwidth", type=float, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")


def _device(args):
    """The device a command runs on: the card (raising without one)
    unless ``--cpu`` asks for the CPU."""
    from quisk_tpu_torch._device import resolve_device
    return resolve_device("cpu" if getattr(args, "cpu", False) else None)


def cmd_rx(args) -> int:
    import torch

    from quisk_tpu_torch.io import wav
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.rx import RxChain, RxChainConfig

    dev = _device(args)

    iq, fs = wav.read_iq_wav(args.inp)
    mode = Mode[args.mode]
    cfg = RxChainConfig(sample_rate=fs, channels=1, agc=not args.no_agc,
                        fm_deviation_hz=args.fm_deviation,
                        noise_blanker=args.nb, auto_notch=args.notch,
                        nr=args.nr, anf=args.anf,
                        squelch=args.squelch > 0,
                        squelch_threshold=args.squelch or 1.2)
    chain = RxChain.create(cfg, tune_hz=[args.tune], mode=int(mode),
                           bandwidth_hz=([args.bandwidth] if args.bandwidth
                                         else None),
                           device=dev)
    n = len(iq) // chain.block_in * chain.block_in
    if n == 0:
        print(f"input too short: {len(iq)} < one block {chain.block_in}",
              file=sys.stderr)
        return 2
    st = chain.init_state()
    st, audio = chain.process(st, torch.as_tensor(
        np.asarray(iq[:n], np.complex64)[None], device=dev))
    audio = audio[0].cpu().numpy()
    out = args.out or "audio.wav"
    peak = np.max(np.abs(audio)) + 1e-9
    wav.write_audio_wav(out, audio / max(1.0, peak), chain.fs_audio)
    print(f"wrote {out}: {len(audio)} samples @ {chain.fs_audio:.1f} Hz "
          f"(peak {peak:.3f})")
    return 0


def cmd_tx(args) -> int:
    import torch

    from quisk_tpu_torch.io import wav
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.tx import TxChain, TxChainConfig

    dev = _device(args)
    audio, fs = wav.read_audio_wav(args.inp)
    tx = TxChain.create(TxChainConfig(channels=1, audio_rate=fs,
                                      tx_rate=fs * args.interp,
                                      fm_deviation_hz=args.fm_deviation,
                                      compress_db=args.compress),
                        mode=int(Mode[args.mode]), device=dev)
    n = len(audio) // tx.block * tx.block
    st = tx.init_state()
    outs = []
    for i in range(n // tx.block):
        st, iq = tx.step(st, torch.as_tensor(np.asarray(
            audio[i * tx.block:(i + 1) * tx.block], np.float32)[None],
            device=dev))
        outs.append(iq)
    iq = torch.cat(outs, dim=-1)[0].cpu().numpy()
    out = args.out or "iq.wav"
    wav.write_iq_wav(out, iq / (np.max(np.abs(iq)) + 1e-9), fs * args.interp)
    print(f"wrote {out}: {len(iq)} IQ samples @ {fs * args.interp:.0f} Hz")
    return 0


def cmd_spectrum(args) -> int:
    from quisk_tpu_torch.app.graph import GraphService
    from quisk_tpu_torch.io import wav

    dev = _device(args)
    iq, fs = wav.read_iq_wav(args.inp)
    fft = args.fft
    block = fft * max(1, (len(iq) // fft) if len(iq) < 16 * fft else 16)
    block = min(block, len(iq) // fft * fft)
    gs = GraphService(fft, block, 1, fs, pixels=args.pixels, refresh_hz=1e9,
                      device=dev)
    trace = gs.feed(np.asarray(iq[:block], np.complex64)[None])
    row = trace[0]
    lo, hi = row.max() - args.range_db, row.max()
    chars = " .:-=+*#%@"
    line = "".join(chars[int(np.clip((v - lo) / (hi - lo), 0, 0.999) * len(chars))]
                   for v in row)
    from quisk_tpu_torch.ops.spectrum import rebin_freqs
    f = gs.freqs()
    fpix = rebin_freqs(f, len(row))
    print(f"{f[0]/1e3:+.1f}k {line} {f[-1]/1e3:+.1f}k")
    print(f"peak {row.max():.1f} dBFS at {fpix[np.argmax(row)]:.0f} Hz")
    return 0


def cmd_info(args) -> int:
    from quisk_tpu_torch.io import wav
    from quisk_tpu_torch.rx.planner import plan_block_sizes, plan_decimation

    iq, fs = wav.read_iq_wav(args.inp)
    plan = plan_decimation(fs)
    blocks = plan_block_sizes(plan)
    print(json.dumps({
        "samples": len(iq), "sample_rate": fs,
        "duration_s": len(iq) / fs,
        "decimation_stages": list(plan.stages),
        "fractional": str(plan.frac) if plan.frac else None,
        "audio_rate": plan.fs_out,
        "block_sizes": blocks,
    }, indent=1))
    return 0


def cmd_config(args) -> int:
    """The runtime config surface (parity configure.py:543-588: view and
    edit every flag, persisted per named radio in the JSON settings db)."""
    from quisk_tpu_torch.app import flags as flagmod
    from quisk_tpu_torch.app.config import Settings, default_settings_path

    path = args.settings or str(default_settings_path())
    st = Settings(path)
    fl = st.get_flags(args.radio)

    if args.action == "sections":
        for s in flagmod.sections():
            print(s)
        return 0
    if args.action == "docs":
        print(flagmod.docs_markdown())
        return 0
    if args.action == "list":
        for name, fg in flagmod.REGISTRY.items():
            if args.section and fg.section != args.section:
                continue
            v = fl.get(name)
            if args.changed and v == fg.default:
                continue
            mark = "*" if v != fg.default else " "
            print(f"{mark} {fg.section:18s} {name:34s} = {v!r}")
        return 0
    if args.action == "get":
        try:
            print(json.dumps(fl.get(args.name)))
        except AttributeError:
            print(f"unknown flag {args.name!r}", file=sys.stderr)
            return 1
        return 0
    if args.action == "set":
        try:
            value = json.loads(args.value)
        except ValueError:
            value = args.value             # bare strings need no quotes
        try:
            fl.set(args.name, value)
        except (KeyError, TypeError, ValueError) as e:
            print(str(e), file=sys.stderr)
            return 1
        st.set_flags(args.radio, fl)
        st.save()
        print(f"{args.name} = {fl.get(args.name)!r}  (saved to {path})")
        return 0
    if args.action == "unset":
        if args.name not in flagmod.REGISTRY:
            print(f"unknown flag {args.name!r}", file=sys.stderr)
            return 1
        fl._values.pop(args.name, None)
        st.set_flags(args.radio, fl)
        st.save()
        print(f"{args.name} restored to default "
              f"{flagmod.REGISTRY[args.name].default!r}")
        return 0
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="quisk-tpu-torch",
                                 description="SDR DSP framework on PyTorch "
                                             "and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("rx", help="demodulate an IQ WAV to audio")
    _add_common(p)
    p.add_argument("--no-agc", action="store_true")
    p.add_argument("--fm-deviation", type=float, default=2500.0)
    p.add_argument("--nb", type=int, default=0, choices=(0, 1, 2, 3),
                   help="noise blanker level")
    p.add_argument("--notch", action="store_true", help="auto-notch")
    p.add_argument("--nr", action="store_true", help="spectral NR")
    p.add_argument("--anf", action="store_true", help="LMS auto-notch")
    p.add_argument("--squelch", type=float, default=0.0,
                   help="SSB squelch threshold (0 = off)")
    p.set_defaults(fn=cmd_rx)

    p = sub.add_parser("tx", help="modulate audio WAV to IQ")
    _add_common(p)
    p.add_argument("--interp", type=int, default=1, help="TX rate multiple")
    p.add_argument("--compress", type=float, default=0.0, help="drive dB")
    p.add_argument("--fm-deviation", type=float, default=2500.0)
    p.set_defaults(fn=cmd_tx)

    p = sub.add_parser("spectrum", help="ASCII spectrum of an IQ WAV")
    p.add_argument("--in", dest="inp", required=True)
    p.add_argument("--fft", type=int, default=1024)
    p.add_argument("--pixels", type=int, default=100)
    p.add_argument("--range-db", type=float, default=80.0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.set_defaults(fn=cmd_spectrum)

    p = sub.add_parser("info", help="show rates + decimation plan for a WAV")
    p.add_argument("--in", dest="inp", required=True)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("config",
                       help="view/edit persisted flags per named radio")
    p.add_argument("action",
                   choices=("list", "get", "set", "unset", "sections",
                            "docs"))
    p.add_argument("name", nargs="?", help="flag name (get/set/unset)")
    p.add_argument("value", nargs="?", help="new value (set; JSON or text)")
    p.add_argument("--radio", default="default", help="named radio")
    p.add_argument("--settings", default=None,
                   help="settings db path (default: $QUISK_TPU_SETTINGS "
                        "or ~/.quisk_tpu/quisk_settings.json)")
    p.add_argument("--section", default=None, help="filter list by section")
    p.add_argument("--changed", action="store_true",
                   help="list only non-default values")
    p.set_defaults(fn=cmd_config)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
