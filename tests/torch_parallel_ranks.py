"""One rank of the worlds that tests/test_torch_parallel.py launches: runs
every case of the port's ``parallel`` package on this rank's share of
seeded inputs and writes its outputs, their place and its collective
counts to ``{out}/w{world}_r{rank}.npz`` (keys ``case.name``).  Imports
neither JAX nor the JAX package; the test holds the stitched outputs to
them.

    python tests/torch_parallel_ranks.py --rank 0 --world 2 \\
        --init file:///tmp/w/store --out /tmp/w
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from quisk_tpu_torch.io import sources  # noqa: E402
from quisk_tpu_torch.modes import Mode  # noqa: E402
from quisk_tpu_torch.ops import design  # noqa: E402
from quisk_tpu_torch.ops.channelizer import OversampledPFB  # noqa: E402
from quisk_tpu_torch.ops.demod import MixedDemod  # noqa: E402
from quisk_tpu_torch.ops.nco import freq_word, phase_tensor  # noqa: E402
from quisk_tpu_torch.parallel import timeshard as ts  # noqa: E402
from quisk_tpu_torch.parallel.comm import init_world  # noqa: E402
from quisk_tpu_torch.parallel.dcn_worker import COUNT_KINDS  # noqa: E402
from quisk_tpu_torch.parallel.pfbshard import (  # noqa: E402
    make_sharded_pfb_step, shard_pfb_inputs)
from quisk_tpu_torch.parallel.scaling import (  # noqa: E402
    flagship, measure_scaling, measure_timeshard)
from quisk_tpu_torch.parallel.shard import (  # noqa: E402
    channel_rows, make_mesh, make_sharded_step, shard_over_channels,
    twin_count)
from quisk_tpu_torch.rx import RxChain, RxChainConfig  # noqa: E402

CPU = torch.device("cpu")
MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]

# the cases' shapes, shared with the test
CHAIN_C, CHAIN_BLOCKS = 16, 6
FUSED_C, FUSED_BLOCKS = 256, 3
FEAT_C, FEAT_BLOCKS = 32, 6
FEATURED = dict(noise_blanker=2, auto_notch=True, nr=True, anf=True,
                squelch=True, fm_squelch=True)
FS = 192000.0
PFB_BLOCKS = 2
# timeshard_rx in AM: a station 25 kHz up, the channel filter +-4 kHz
AM_TUNE_HZ = 25000.0
AM_BAND = (-4000.0, 4000.0)


def tune(C: int, fs: float = FS, span: float = 2.0) -> list[float]:
    return [(-fs / 4 + (i + 0.5) * fs / (span * C)) for i in range(C)]


def chain_input(C: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * (rng.standard_normal((C, n))
                   + 1j * rng.standard_normal((C, n)))).astype(np.complex64)


def featured_input(C: int, n: int, seed: int = 32) -> np.ndarray:
    """Noise, a carrier 1 kHz above channel 0's dial, an FM carrier on
    channel 3 and impulses on every 7th channel."""
    rng = np.random.default_rng(seed)
    x = 0.05 * (rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n)))
    t = np.arange(n) / FS
    tn = tune(C)
    x[0] += 0.5 * np.exp(2j * np.pi * (tn[0] + 1000.0) * t)
    x[3] += 0.5 * np.exp(2j * np.pi * (tn[3] + 300.0 * np.sin(
        2 * np.pi * 400.0 * t)) * t)
    for c in range(0, C, 7):
        for p in rng.integers(0, n, 3 * FEAT_BLOCKS):
            x[c, p] += 30.0 * np.exp(1j * rng.uniform(0, 2 * np.pi))
    return x.astype(np.complex64)


def featured_kw(C: int) -> dict:
    """The featured receiver's configuration fields (either package's)."""
    return dict(sample_rate=FS, channels=C, audio_block=512, agc=True,
                **FEATURED)


def fused_kw(C: int) -> dict:
    return dict(sample_rate=FS, channels=C, audio_block=256, agc=False,
                fused_frontend=True, noise_blanker=2)


def timeshard_inputs() -> dict:
    """The inputs of tests/test_timeshard.py, from the port's sources."""
    rng = np.random.default_rng(42)
    C = 2
    out = {
        "fir": (rng.standard_normal((C, 8192))
                + 1j * rng.standard_normal((C, 8192))).astype(np.complex64),
        "fir_d2": (rng.standard_normal((C, 8192))
                   + 1j * rng.standard_normal((C, 8192))
                   ).astype(np.complex64),
        "one_pole": rng.standard_normal((C, 4096)).astype(np.float32),
        "nco": np.broadcast_to(sources.tone(7001.5, 48000.0, 8192).astype(
            np.complex64), (C, 8192)).copy(),
    }
    fs, N = 192000.0, 16384
    voice = sources.voice_like(fs, N, band=(300.0, 2700.0), seed=4)
    out["ssb"] = np.broadcast_to(sources.ssb_signal(
        voice, fs, carrier_hz=40000.0).astype(np.complex64), (C, N)).copy()
    voice = sources.voice_like(fs, N, band=(300.0, 2700.0), seed=6)
    out["fm"] = np.broadcast_to(sources.fm_signal(
        voice, fs, deviation_hz=2500.0, carrier_hz=-30000.0).astype(
        np.complex64), (C, N)).copy()
    voice = sources.voice_like(fs, N, band=(300.0, 2700.0), seed=8)
    out["am"] = np.broadcast_to(sources.am_signal(
        voice / np.max(np.abs(voice)), fs, carrier_hz=AM_TUNE_HZ).astype(
        np.complex64), (C, N)).copy()
    return out


class Results(dict):
    def counted(self, mesh, name: str, before: dict) -> None:
        self[f"{name}.counts"] = np.asarray(
            [mesh.counts[k] - before.get(k, 0) for k in COUNT_KINDS])


def run_chain(res, mesh, name, chain, twin, x, nblk) -> None:
    """Step this rank's shard of ``chain`` over ``nblk`` blocks of x."""
    C = chain.channels
    step = make_sharded_step(chain, mesh, C)
    ch = shard_over_channels(chain, mesh, C, twin)
    st = shard_over_channels(chain.init_state(), mesh, C, twin.init_state())
    lo, hi = channel_rows(C, mesh.index("chan"), mesh.size("chan"))
    B = chain.block_in
    before = dict(mesh.counts)
    outs = []
    for i in range(nblk):
        st, a = step(ch, st, torch.as_tensor(x[lo:hi, i * B:(i + 1) * B]))
        outs.append(a.numpy())
    res.counted(mesh, name, before)
    res[f"{name}.audio"] = np.concatenate(outs, axis=-1)
    res[f"{name}.rows"] = np.asarray([lo, hi])


def chain_cases(res, n) -> None:
    mesh = make_mesh(device=CPU)
    # unfused, as the JAX flagship it is held to (the fused front is the
    # 256-channel case's)
    chain = flagship(CHAIN_C, sample_rate=FS, audio_block=256, fused=False,
                     device=CPU)
    twin = flagship(twin_count(CHAIN_C), sample_rate=FS, audio_block=256,
                    fused=False, device=CPU)
    run_chain(res, mesh, "chain", chain, twin,
              chain_input(CHAIN_C, CHAIN_BLOCKS * chain.block_in, 30),
              CHAIN_BLOCKS)
    if n == 2:                          # 128 channels a rank
        def fused(C):
            return RxChain.create(RxChainConfig(**fused_kw(C)),
                                  tune_hz=tune(C), mode=int(Mode.USB),
                                  device=CPU)
        chain = fused(FUSED_C)
        run_chain(res, mesh, "fused", chain, fused(twin_count(FUSED_C)),
                  chain_input(FUSED_C, FUSED_BLOCKS * chain.block_in, 5),
                  FUSED_BLOCKS)

    def featured(C):
        return RxChain.create(RxChainConfig(**featured_kw(C)),
                              tune_hz=tune(C),
                              mode=[MODES[i % 4] for i in range(C)],
                              device=CPU)
    chain = featured(FEAT_C)
    run_chain(res, mesh, "featured", chain, featured(twin_count(FEAT_C)),
              featured_input(FEAT_C, FEAT_BLOCKS * chain.block_in),
              FEAT_BLOCKS)


def time_mesh(n):
    nc = 2 if n == 4 else 1
    return make_mesh((nc, n // nc), ("chan", "time"), device=CPU)


def local(mesh, x):
    C, N = x.shape
    lo, hi = channel_rows(C, mesh.index("chan"), mesh.size("chan"))
    t0, t1 = channel_rows(N, mesh.index("time"), mesh.size("time"))
    return torch.as_tensor(np.ascontiguousarray(x[lo:hi, t0:t1])), \
        np.asarray([lo, hi, t0, t1])


def timeshard_cases(res, n) -> None:
    mesh = time_mesh(n)
    xs = timeshard_inputs()
    x, pos = local(mesh, xs["fir"])
    res["fir.y"], res["fir.pos"] = ts.shard_fir(
        x, design.lowpass(201, 3000.0, 48000.0), mesh).numpy(), pos
    x, pos = local(mesh, xs["fir_d2"])
    res["fir_d2.y"], res["fir_d2.pos"] = ts.shard_fir(
        x, design.halfband(45), mesh, decim=2).numpy(), pos
    x, pos = local(mesh, xs["one_pole"])
    before = dict(mesh.counts)
    res["one_pole.y"] = ts.shard_one_pole(x, 0.97, 0.03, mesh).numpy()
    res.counted(mesh, "one_pole", before)
    res["one_pole.pos"] = pos
    x, pos = local(mesh, xs["nco"])
    word = phase_tensor(np.broadcast_to(freq_word(7001.5, 48000.0),
                                        (x.shape[0],)), CPU)
    res["nco.y"] = ts.shard_nco_mix(x, word, mesh, "time",
                                    x.shape[-1]).numpy()
    res["nco.pos"] = pos
    stages = [(design.halfband(45), 2), (design.halfband(45), 2)]
    for mode, f0, band in (("ssb", 40000.0, (300.0, 3100.0)),
                           ("fm", -30000.0, (-6250.0, 6250.0)),
                           ("am", AM_TUNE_HZ, AM_BAND)):
        x, pos = local(mesh, xs[mode])
        before = dict(mesh.counts)
        res[f"{mode}.y"] = ts.timeshard_rx(
            x, mesh, sample_rate=192000.0, tune_hz=f0, stages=stages,
            bp_taps=design.bandpass_analytic(1025, *band, 48000.0),
            mode=mode, fm_deviation_hz=2500.0).numpy()
        res.counted(mesh, mode, before)
        res[f"{mode}.pos"] = pos


def pfb_case(res, n) -> None:
    mesh = make_mesh(axis="dev", device=CPU)
    K, B = 16 * n, 16 * n * 8 * n
    fam = [int(Mode.USB), int(Mode.AM), int(Mode.FM)]

    def demod(k):
        return MixedDemod.create([fam[(3 * i) // k] for i in range(k)],
                                 sample_rate=96000.0, channels=k, device=CPU)

    pfb = OversampledPFB.create(K, B, taps_per_branch=8, pallas_poly=True,
                                device=CPU)
    step = make_sharded_pfb_step(pfb, demod(K), mesh)
    dm, st = shard_pfb_inputs(demod(K), mesh, K, demod(twin_count(K)))
    t0, t1 = channel_rows(B, mesh.index("dev"), n)
    rng = np.random.default_rng(7)
    hist = pfb.init_state(1)
    before = dict(mesh.counts)
    for _ in range(PFB_BLOCKS):
        xh = (rng.standard_normal((1, B)) + 1j * rng.standard_normal((1, B))
              ).astype(np.complex64)
        st, hist, audio, spec = step(dm, st, hist,
                                     torch.as_tensor(xh[:, t0:t1]))
    res.counted(mesh, "pfb", before)
    res["pfb.audio"], res["pfb.spec"] = audio[0].numpy(), spec[0].numpy()
    res["pfb.rows"] = np.asarray(channel_rows(K, mesh.index("dev"), n))


def scaling_cases(res, n, rank) -> None:
    kw = dict(device_counts=(1, 2, 4), sample_rate=FS, audio_block=256,
              device=CPU)
    weak = measure_scaling(channels_per_device=8, iters=1, **kw)
    timed = measure_scaling(channels_per_device=8, iters=3, **kw)
    strong = measure_scaling(channels_per_device=4, iters=1, weak=False,
                             **kw)
    sps, ms = measure_timeshard(time_mesh(n), channels=4, n_samples=1024,
                                iters=1)
    if rank == 0:
        res["scaling.json"] = np.asarray(json.dumps({
            "weak": [p.__dict__ for p in weak],
            "timed": [p.__dict__ for p in timed],
            "strong": [p.__dict__ for p in strong],
            "timeshard": [sps, ms]}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    import torch.distributed as dist
    init_world(args.init, args.rank, args.world, "gloo", device=CPU,
               timeout_s=120.0)
    res = Results()
    try:
        with torch.no_grad():
            chain_cases(res, args.world)
            timeshard_cases(res, args.world)
            pfb_case(res, args.world)
            scaling_cases(res, args.world, args.rank)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(args.out, f"w{args.world}_r{args.rank}.npz"),
             **res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
