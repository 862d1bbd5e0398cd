"""One rank of a multi-process receive job over ``torch.distributed``.

Counterpart of ``quisk_tpu.parallel.dcn_worker`` (the reference's
two-machine remote-operation split, ac2yd/remote.c, as N processes of one
job).  Each process is one rank: it joins the world at ``--init`` (a
``file://`` or ``tcp://host:port`` URL) over ``--backend`` (gloo or nccl,
the caller's choice) on ``--device`` (cpu or cuda), runs one job and
writes its rows and their place to an ``.npz`` in ``--outdir``:

- default: the flagship chain (192 kS/s, 256-sample audio blocks, AGC off,
  the decimators in the front kernel), ``--channels`` channels, each
  process reading its rows of a seeded capture (``ShardedFileIngest``),
  every channel a station of its own mode on its own tune; writes
  ``audio_p{pid}.npz`` (audio, lo, hi, process_count);
- ``--pfb``: the 2x-oversampled PFB channelizer with a seeded wideband
  capture split over the ranks in time (ring halos, one ``all_to_all``
  corner turn, demod on each rank's channels); ``--channels`` is K (16 a
  rank by default), ``--block`` the samples a block (K * 8 * nproc by
  default); writes ``pfb_p{pid}.npz`` (the last block's audio rows, spec,
  lo, hi);
- ``--timeshard``: ``timeshard_rx`` (SSB) of a seeded [channels, block]
  noise capture split over the ranks in time on a (chan=1, time=nproc)
  mesh; writes ``ts_p{pid}.npz`` (audio, lo, hi, t0, t1).

Every file also holds the rank's collective counts, the bytes it staged
through the host, its launches of kernels #1 and #4 and its ms a step.
Run as, for each pid:

    python -m quisk_tpu_torch.parallel.dcn_worker --pid 0 --nproc 2 \\
        --init file:///tmp/job/store --backend gloo --device cpu \\
        --outdir /tmp/job --channels 16 --blocks 3
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch


#: the order of the counts written to each file
COUNT_KINDS = ("send", "recv", "all_gather", "all_to_all", "all_reduce",
               "host_bytes")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _save(args, name: str, mesh, step_ms, **arrays) -> None:
    from quisk_tpu_torch.ops.fused_front import fused_tune_decimate
    from quisk_tpu_torch.ops.pfb_kernels import pfb_poly_oversampled

    os.makedirs(args.outdir, exist_ok=True)
    np.savez(os.path.join(args.outdir, f"{name}_p{args.pid}.npz"),
             process_count=args.nproc, step_ms=np.asarray(step_ms),
             counts=np.asarray([mesh.counts[k] for k in COUNT_KINDS]),
             launches=np.asarray([fused_tune_decimate.launches,
                                  pfb_poly_oversampled.launches]),
             **arrays)


def chain_job(args, dev) -> str:
    from quisk_tpu_torch.io import sources
    from quisk_tpu_torch.parallel.multihost import (ShardedFileIngest,
                                                    shard_tree_multihost)
    from quisk_tpu_torch.parallel.scaling import flagship
    from quisk_tpu_torch.parallel.shard import (make_mesh, make_sharded_step,
                                                twin_count)

    mesh = make_mesh(device=dev)
    C = args.channels or 16
    # AGC off: its 1 s release memory carries the filter warm-up for longer
    # than the job runs, spoiling an exact comparison
    chain = flagship(C, sample_rate=192000.0, audio_block=256, agc=False,
                     device=dev)
    twin = flagship(twin_count(C), sample_rate=192000.0, audio_block=256,
                    agc=False, device=dev)
    step = make_sharded_step(chain, mesh, C)
    chain_s = shard_tree_multihost(chain, mesh, C, twin)
    state_s = shard_tree_multihost(chain.init_state(), mesh, C,
                                   twin.init_state())
    # every channel a modulated station of its own mode on its own tune,
    # identical in every process and in the caller's unsharded run
    n_samp = args.blocks * chain.block_in
    tunes = chain.tune_base.cpu().numpy()
    modes = chain.demod.mode.cpu().numpy()
    del chain, twin
    iq = np.stack([sources.station_iq(int(modes[c]), 192000.0, n_samp,
                                      float(tunes[c]), seed=c)
                   for c in range(C)])
    ingest = ShardedFileIngest(iq, mesh, block=chain_s.block_in)
    outs, ms = [], []
    while (x := ingest.next_block()) is not None:
        _sync(dev)
        t = time.perf_counter()
        state_s, audio = step(chain_s, state_s, x)
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
        outs.append(audio.cpu().numpy())
    lo, hi = ingest.rows
    audio = np.concatenate(outs, axis=-1)
    _save(args, "audio", mesh, ms, audio=audio, lo=lo, hi=hi)
    return f"rows [{lo},{hi}), audio {audio.shape}"


def pfb_job(args, dev) -> str:
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.ops.channelizer import OversampledPFB
    from quisk_tpu_torch.ops.demod import MixedDemod
    from quisk_tpu_torch.parallel.pfbshard import (make_sharded_pfb_step,
                                                   shard_pfb_inputs)
    from quisk_tpu_torch.parallel.shard import (channel_rows, make_mesh,
                                                twin_count)

    n = args.nproc
    mesh = make_mesh(axis="dev", device=dev)
    K = args.channels or 16 * n
    B = args.block or K * 8 * n
    modes = [int(Mode.USB), int(Mode.AM), int(Mode.FM)]

    def demod(k):
        return MixedDemod.create([modes[(3 * i) // k] for i in range(k)],
                                 sample_rate=96000.0, channels=k, device=dev)

    pfb = OversampledPFB.create(K, B, taps_per_branch=8, pallas_poly=True,
                                device=dev)
    step = make_sharded_pfb_step(pfb, demod(K), mesh)
    dm_s, st_s = shard_pfb_inputs(demod(K), mesh, K, demod(twin_count(K)))
    t0, t1 = channel_rows(B, mesh.index("dev"), n)
    rng = np.random.default_rng(7)
    hist = pfb.init_state(1)
    ms = []
    for _ in range(args.blocks):
        xh = (rng.standard_normal((1, B)) + 1j * rng.standard_normal((1, B))
              ).astype(np.complex64)
        x = torch.as_tensor(xh[:, t0:t1]).to(dev)
        _sync(dev)
        t = time.perf_counter()
        st_s, hist, audio, spec = step(dm_s, st_s, hist, x)
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    lo, hi = channel_rows(K, mesh.index("dev"), n)
    _save(args, "pfb", mesh, ms, audio=audio[0].cpu().numpy(),
          spec=spec[0].cpu().numpy(), lo=lo, hi=hi)
    return f"{K}ch over {n} processes, rows [{lo},{hi})"


def timeshard_job(args, dev) -> str:
    from quisk_tpu_torch.parallel.scaling import (TS_RATE, seeded_capture,
                                                  timeshard_filters)
    from quisk_tpu_torch.parallel.shard import channel_rows, make_mesh
    from quisk_tpu_torch.parallel.timeshard import timeshard_rx

    n = args.nproc
    mesh = make_mesh((1, n), ("chan", "time"), device=dev)
    C = args.channels or 16
    N = args.block or 8192 * n
    t0, t1 = channel_rows(N, mesh.index("time"), n)
    iq = seeded_capture(C, N, dev)[:, t0:t1].contiguous()
    stages, bp = timeshard_filters()
    ms = []
    for _ in range(args.blocks):
        _sync(dev)
        t = time.perf_counter()
        audio = timeshard_rx(iq, mesh, sample_rate=TS_RATE, tune_hz=10000.0,
                             stages=stages, bp_taps=bp, mode="ssb")
        _sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    D = N // audio.shape[-1] // n
    _save(args, "ts", mesh, ms, audio=audio.cpu().numpy(), lo=0, hi=C,
          t0=t0 // D, t1=t1 // D)
    return f"time [{t0},{t1}) of {N}, audio {tuple(audio.shape)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--init", required=True,
                    help="file:///path or tcp://host:port of the world")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", required=True, choices=("cpu", "cuda"))
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--channels", type=int, default=0,
                    help="channels (K for --pfb); 0: the job's default")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--block", type=int, default=0,
                    help="samples a block (--pfb) or of the capture "
                         "(--timeshard); 0: the job's default")
    job = ap.add_mutually_exclusive_group()
    job.add_argument("--pfb", action="store_true",
                     help="the time-sharded PFB channelizer job")
    job.add_argument("--timeshard", action="store_true",
                     help="the (chan, time) halo-exchange receive job")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds a rank waits on a peer before it fails")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    import torch.distributed as dist

    from quisk_tpu_torch.parallel.comm import init_world

    dev = init_world(args.init, args.pid, args.nproc, args.backend,
                     device=args.device, timeout_s=args.timeout)
    try:
        run = (pfb_job if args.pfb else timeshard_job if args.timeshard
               else chain_job)
        what = run(args, dev)
    finally:
        dist.destroy_process_group()
    print(f"dcn_worker pid={args.pid} OK: process_count={args.nproc}, "
          f"{args.backend} on {dev}, {what}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
