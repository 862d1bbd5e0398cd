"""Time-block sharding: one long capture split across ranks in time, with
the overlap-save boundary samples passed between neighbours.

Counterpart of ``quisk_tpu.parallel.timeshard``.  Every streaming FIR
keeps ``taps-1`` samples of history (filter.h:7-9; FIRCORE's 50% overlap,
wdsp/firmin.c:409-432).  When the time axis is split across ranks that
history lives on the left neighbour, so before filtering each rank
receives its neighbour's tail through a ring of point-to-point sends
(:func:`quisk_tpu_torch.parallel.comm.ring_from_left`; the reference's
``ppermute``).  The first rank takes zeros, a fresh filter's state.

The same trick handles every recurrence that crosses a boundary:

- FIR / decimator history: the last ``taps-1`` samples;
- the FM discriminator's previous sample: the last sample;
- one-pole IIR state: a shard's output is affine in its incoming state,
  y_out = A * y_in + B, so one ``all_gather`` of every shard's (A, B) per
  channel and a fold over the shards before this one give it;
- NCO phase: the integer phase of the shard's first sample is a function
  of its global offset, so no communication at all.

Each function takes this rank's block and the mesh; the sharded FIRs run
on the port's banded fp32 matmul engines, so no tap-fold copy of the input
is made.
"""

from __future__ import annotations

import numpy as np
import torch

from quisk_tpu_torch.ops.fir import HalfbandFIR, MatmulFIR
from quisk_tpu_torch.ops.iir import first_order_scan
from quisk_tpu_torch.ops.nco import (MASK32, TWO_PI_OVER_2_32, freq_word,
                                     phase_tensor)
from quisk_tpu_torch.parallel.comm import Mesh, all_gather, ring_from_left
from quisk_tpu_torch.parallel.shard import channel_rows


def halo_from_left(x: torch.Tensor, n_halo: int, mesh: Mesh,
                   axis: str = "time") -> torch.Tensor:
    """[..., n_halo]: the left neighbour's tail of x (zeros on the first
    shard, and with no call along an axis of one rank)."""
    tail = x[..., x.shape[-1] - n_halo:].contiguous()
    got = ring_from_left(mesh, axis, tail)
    if got is None or mesh.index(axis) == 0:
        return torch.zeros_like(tail)
    return got


def _real_fir(taps: np.ndarray, halo, x, decim: int) -> torch.Tensor:
    if decim == 2 and HalfbandFIR.is_halfband(taps):
        op = HalfbandFIR.create(taps, x.shape[-1], device=x.device)
    else:
        op = MatmulFIR.create(taps, x.shape[-1], decim, device=x.device)
    return op(halo, x)[1]


def shard_fir(x: torch.Tensor, taps, mesh: Mesh, axis: str = "time",
              decim: int = 1) -> torch.Tensor:
    """Streaming-equivalent FIR of a time-sharded [C, B_local] complex64
    block: ``y[n] = sum_k taps[k] xe[n*decim + T-1-k]`` over the halo and
    the block.  ``decim`` must divide B_local, so the decimation phase
    lines up at shard edges (the block-streaming API's condition).  The
    sums run in the time domain, as the reference's convolution does
    (complex taps as two real banded products): an FFT's rounding floor
    would turn the near-zero outputs of a filling history into noise
    whose phase an FM discriminator then reads."""
    taps = np.asarray(taps)
    if x.shape[-1] % decim:
        raise ValueError(f"decim {decim} does not divide the shard's "
                         f"{x.shape[-1]} samples")
    x = x.to(torch.complex64)
    halo = halo_from_left(x, taps.shape[-1] - 1, mesh, axis)
    if not np.iscomplexobj(taps):
        return _real_fir(taps, halo, x, decim)
    a = _real_fir(taps.real, halo, x, decim)
    b = _real_fir(taps.imag, halo, x, decim)
    return torch.complex(a.real - b.imag, a.imag + b.real)


def shard_one_pole(x: torch.Tensor, a: float, b: float, mesh: Mesh,
                   axis: str = "time") -> torch.Tensor:
    """y[n] = a*y[n-1] + b*x[n] across the whole time-sharded [C, B_local]
    signal: the local scan from y_in = 0 (``ops/iir.py``'s
    ``first_order_scan``), then one ``all_gather`` of every shard's
    (a^B_local, last output) per channel and the fold over the shards
    before this one."""
    C, Bl = x.shape
    y_local = first_order_scan(x, a, b, torch.zeros((C,), dtype=x.dtype,
                                                    device=x.device))
    a_t = torch.tensor(a, dtype=x.dtype, device=x.device)
    A_B = all_gather(mesh, axis, torch.stack([(a_t ** Bl).expand(C),
                                              y_local[:, -1]]))
    y_in = torch.zeros((C,), dtype=x.dtype, device=x.device)
    for k in range(mesh.index(axis)):
        y_in = A_B[k, 0] * y_in + A_B[k, 1]
    powers = a_t ** torch.arange(1, Bl + 1, dtype=x.dtype, device=x.device)
    return y_local + y_in[:, None] * powers[None, :]


def shard_fm_disc(x: torch.Tensor, mesh: Mesh, axis: str = "time"
                  ) -> torch.Tensor:
    """Phase-difference discriminator with the previous sample fetched
    from the left neighbour (zero on the first shard)."""
    prev = halo_from_left(x, 1, mesh, axis)
    d = x * torch.conj(torch.cat([prev, x[:, :-1]], dim=-1))
    return torch.atan2(d.imag, d.real)


def shard_nco_mix(x: torch.Tensor, word: torch.Tensor, mesh: Mesh,
                  axis: str, block_local: int) -> torch.Tensor:
    """Mix down with a drift-free NCO whose phase starts at the shard's
    global offset: ``word`` [C] int64 (uint32 values), the phase
    ``word * n`` formed in int64 and masked to 32 bits (exact while
    n < 2^31, as the reference's uint32 product), then converted unsigned
    to float32 as the reference's ``astype(float32)`` does."""
    n = (mesh.index(axis) * block_local
         + torch.arange(block_local, dtype=torch.int64, device=x.device))
    ph = (word[:, None] * n[None, :]) & MASK32
    ang = ph.to(torch.float32) * TWO_PI_OVER_2_32
    return x * torch.complex(torch.cos(ang), -torch.sin(ang))


def timeshard_rx(iq: torch.Tensor, mesh: Mesh, *, sample_rate: float,
                 tune_hz, stages, bp_taps, mode: str = "ssb",
                 fm_deviation_hz: float = 2500.0,
                 deemph_hz: float = 300.0) -> torch.Tensor:
    """Whole-capture receive over a ``(chan, time)`` mesh.

    ``iq`` is this rank's [C_local, N_local] block of the global [C, N]
    capture: rows ``channel_rows(C, chan index, chan size)``, samples
    ``time index * N_local`` on.  ``tune_hz`` is one frequency or one per
    global channel; ``stages`` is [(taps, decim), ...], then the complex
    ``bp_taps`` channel filter; ``mode`` "ssb", "am" or "fm".  Returns this
    rank's block of the audio [C, N / prod(decim)]."""
    C_l, N_l = iq.shape
    C = C_l * mesh.size("chan")
    lo, hi = channel_rows(C, mesh.index("chan"), mesh.size("chan"))
    if hi - lo != C_l:
        raise ValueError(f"{C_l} rows do not split {C} channels evenly")
    word = np.broadcast_to(freq_word(tune_hz, sample_rate), (C,))[lo:hi]
    D = int(np.prod([d for _, d in stages]))
    fs_out = sample_rate / D
    a_de = float(np.exp(-2.0 * np.pi * deemph_hz / fs_out))
    fm_gain = float(fs_out / (2.0 * np.pi * fm_deviation_hz))

    x = shard_nco_mix(iq, phase_tensor(word, iq.device), mesh, "time", N_l)
    for taps, d in stages:
        x = shard_fir(x, taps, mesh, "time", decim=d)
    x = shard_fir(x, np.asarray(bp_taps).astype(np.complex128), mesh, "time")
    if mode == "ssb":
        return 2.0 * x.real
    if mode == "am":
        env = torch.abs(x)
        d1 = env - torch.cat([halo_from_left(env, 1, mesh, "time"),
                              env[:, :-1]], dim=-1)
        return shard_one_pole(d1, 0.995, 1.0, mesh, "time")
    if mode == "fm":
        disc = shard_fm_disc(x, mesh, "time") * fm_gain
        return shard_one_pole(disc, a_de, 1.0 - a_de, mesh, "time")
    raise ValueError(mode)
