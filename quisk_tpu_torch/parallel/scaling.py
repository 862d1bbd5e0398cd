"""Scaling harness: samples/s of the channel-sharded receive step at
1..N ranks, weak and strong, and of the (chan, time) halo-exchange path.

Counterpart of ``quisk_tpu.parallel.scaling``.  Every rank of one launched
world calls :func:`measure_scaling`; each rank count n is timed on the
first n ranks (``make_mesh(n)``, a ``new_group`` of them) while the others
wait.  Weak scaling holds the channels a rank fixed (more ranks, more
receivers), strong scaling the total.  Efficiency(n) = throughput(n) /
(n * throughput(1)).

Timing: on the card, CUDA events around each step on every rank, the
point's step the slowest rank's median; on the CPU, a barrier, the step
and a barrier again under the host clock.  Ranks that share silicon (CPU
ranks, or more ranks than cards) can at best hold total throughput flat,
so ``eff_of_ideal`` divides by 1/n there, and such points measure the
harness, not scaling.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.parallel.comm import all_gather, barrier, make_mesh
from quisk_tpu_torch.parallel.shard import (make_sharded_step,
                                            shard_over_channels, twin_count)
from quisk_tpu_torch.rx.chain import RxChain, RxChainConfig


def flagship(channels: int, sample_rate: float = 960000.0,
             audio_block: int = 2048, agc: bool = True, fused: bool = True,
             device=None) -> RxChain:
    """The flagship receiver (the reference's ``__graft_entry__._flagship``):
    ``channels`` channels cycling USB/LSB/AM/FM, tuned across the middle
    half of the band; ``fused`` puts the decimators in the front kernel
    (``bench.py``'s flagship)."""
    modes = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]
    tune = [(-sample_rate / 4 + (i + 0.5) * sample_rate / channels)
            for i in range(channels)]
    cfg = RxChainConfig(sample_rate=sample_rate, channels=channels,
                        audio_block=audio_block, agc=agc,
                        fused_frontend=fused)
    return RxChain.create(cfg, tune_hz=tune,
                          mode=[modes[i % 4] for i in range(channels)],
                          device=device)


@dataclasses.dataclass
class ScalePoint:
    devices: int
    channels: int
    samples_per_s: float
    efficiency: float      # raw: throughput(n) / (n * throughput(1))
    eff_of_ideal: float    # efficiency / what the ranks can ideally give
    step_ms: float
    #: relative spread of the timing samples (max-min)/median; NaN with
    #: iters=1, where the table flags the point as smoke only
    noise_pct: float = float("nan")
    #: the ranks share silicon (CPU ranks, or more ranks than cards)
    shared: bool = False


#: the efficiency a quotable point on silicon of its own may not exceed
EFF_BOUND = 1.5
#: the halo-exchange receive path's input rate: its filters are designed
#: for 192 kS/s in, 48 kS/s out
TS_RATE = 192000.0
#: the seed of every rank's copy of the halo-exchange path's capture
CAPTURE_SEED = 0


def _time(mesh, fn, iters: int) -> tuple[float, float]:
    """(median seconds, relative spread) of ``fn()`` on every rank of the
    mesh, the slowest rank's; one warm-up call first."""
    cuda = mesh.device.type == "cuda"
    fn()
    times = []
    for _ in range(iters):
        if cuda:
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3)
        else:
            barrier(mesh)
            t = time.perf_counter()
            fn()
            barrier(mesh)
            times.append(time.perf_counter() - t)
    med = float(np.median(times))
    spread = ((max(times) - min(times)) / med) if iters > 1 else float("nan")
    if cuda and mesh.world > 1:
        mine = torch.tensor([med, spread], dtype=torch.float64,
                            device=mesh.device)
        for axis in mesh.axes:
            per_rank = all_gather(mesh, axis, mine)
            mine = per_rank[per_rank[:, 0].argmax()]
        med, spread = (float(v) for v in mine)
    return med, spread


def measure_scaling(device_counts: Sequence[int] = (1, 2, 4, 8),
                    channels_per_device: int = 16,
                    sample_rate: float = 192000.0,
                    audio_block: int = 512,
                    iters: int = 5,
                    weak: bool = True,
                    device=None) -> list[ScalePoint]:
    """Time the sharded :func:`flagship` step at each rank count that the
    world holds; every rank calls it, and rank 0 returns the points (the
    other ranks an empty list).  The 1-rank point anchors efficiency; a
    point's ranks share silicon on the CPU and where they outnumber the
    cards."""
    import torch.distributed as dist

    device = resolve_device(device)

    def make_chain(c):
        return flagship(c, sample_rate=sample_rate, audio_block=audio_block,
                        device=device)
    counts = [n for n in device_counts if n <= dist.get_world_size()]
    base_channels = channels_per_device * (1 if weak else max(counts))
    points: list[ScalePoint] = []
    anchor = None
    for n in counts:
        mesh = make_mesh(n, device=device)
        if mesh is None:
            continue
        shared = device.type == "cpu" or n > torch.cuda.device_count()
        C = channels_per_device * n if weak else base_channels
        chain = make_chain(C)
        twin = make_chain(twin_count(C))
        step = make_sharded_step(chain, mesh, C)
        chain_l = shard_over_channels(chain, mesh, C, twin)
        state = shard_over_channels(chain.init_state(), mesh, C,
                                    twin.init_state())
        del chain, twin
        x = torch.zeros((chain_l.channels, chain_l.block_in),
                        dtype=torch.complex64, device=device)
        dt, spread = _time(mesh, lambda: step(chain_l, state, x), iters)
        sps = C * chain_l.block_in / dt
        if anchor is None:
            anchor = sps / n
        eff = sps / (n * anchor)
        ideal = (1.0 / n) if shared else 1.0
        points.append(ScalePoint(devices=n, channels=C, samples_per_s=sps,
                                 efficiency=eff, eff_of_ideal=eff / ideal,
                                 step_ms=dt * 1e3, noise_pct=spread,
                                 shared=shared))
    return points if dist.get_rank() == 0 else []


def timeshard_filters() -> tuple[list, np.ndarray]:
    """The halo-exchange receive path's filters at 192 kS/s: two
    half-bands (/4) and a 129-tap 300-3100 Hz analytic channel filter."""
    from quisk_tpu_torch.ops import design
    return ([(design.halfband(45), 2), (design.halfband(45), 2)],
            design.bandpass_analytic(129, 300.0, 3100.0, 48000.0))


def seeded_capture(channels: int, n_samples: int, device) -> torch.Tensor:
    """A [channels, n_samples] complex64 noise capture made on ``device``
    from a torch generator seeded ``CAPTURE_SEED``: every rank on one
    device type makes the same numbers."""
    gen = torch.Generator(device).manual_seed(CAPTURE_SEED)
    return torch.randn((channels, n_samples), dtype=torch.complex64,
                       generator=gen, device=device)


def measure_timeshard(mesh, channels: int, n_samples: int, iters: int = 3
                      ) -> tuple[float, float]:
    """Time the (chan, time) halo-exchange receive path on ``mesh`` (every
    rank of it calls): whole-capture SSB of :func:`seeded_capture` through
    :func:`timeshard_filters` (parallel/timeshard.py).  Returns
    (samples_per_s, step_ms), the slowest rank's."""
    from quisk_tpu_torch.parallel.shard import channel_rows
    from quisk_tpu_torch.parallel.timeshard import timeshard_rx

    lo, hi = channel_rows(channels, mesh.index("chan"), mesh.size("chan"))
    t0, t1 = channel_rows(n_samples, mesh.index("time"), mesh.size("time"))
    local = seeded_capture(channels, n_samples, mesh.device)[
        lo:hi, t0:t1].contiguous()
    stages, bp = timeshard_filters()
    dt, _ = _time(mesh, lambda: timeshard_rx(
        local, mesh, sample_rate=TS_RATE, tune_hz=10000.0, stages=stages,
        bp_taps=bp, mode="ssb"), iters)
    return channels * n_samples / dt, dt * 1e3


def quotable(p: ScalePoint) -> bool:
    """True when the point's timing spread is known and at most 25%."""
    return bool(np.isfinite(p.noise_pct) and p.noise_pct <= 0.25)


def efficiency_within_bound(p: ScalePoint) -> bool:
    """The efficiency bound of a scaling point: a quotable point on silicon
    of its own is at most ``EFF_BOUND`` (super-linear beyond it means the
    anchor or the point mis-timed); a smoke point, or one on shared
    silicon, whose load moves it either way, is held to none."""
    return p.shared or not quotable(p) or p.efficiency <= EFF_BOUND


def format_table(points: Sequence[ScalePoint], title: str = "weak") -> str:
    lines = [f"scaling ({title}): devices  channels  Msps  "
             "eff(raw)  of-ideal  ms/step"]
    shaky = False
    for p in points:
        flag = ""
        if not quotable(p):
            flag, shaky = "  *", True
        lines.append(f"  {p.devices:7d}  {p.channels:8d}  "
                     f"{p.samples_per_s / 1e6:8.1f}  {p.efficiency:8.2%}  "
                     f"{p.eff_of_ideal:8.2%}  {p.step_ms:7.2f}{flag}")
    if shaky:
        lines.append("  * timing spread >25% or iters too few for a "
                     "spread estimate — harness smoke only, NOT a "
                     "quotable efficiency")
    return "\n".join(lines)
