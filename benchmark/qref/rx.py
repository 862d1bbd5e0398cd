"""Plain reference of the per-channel receiver: tune, decimate, channel
filter, demodulate, lookahead AGC, in float64, from the configuration
and the input blocks alone.

Each channel is its own stream of ``block_in`` complex samples a block.
Stream sample ``s`` (counted from the first block the program was given)
is mixed down by the NCO angle ``2 pi ((word * s) mod 2^32) / 2^32``,
filtered by the folded decimation cascade and kept at every ``decim``-th
sample, filtered by the mode's analytic bandpass at the audio rate, and
demodulated (SSB ``2 Re y``; AM ``2`` times the DC-blocked envelope,
pole 0.995; FM the phase-difference discriminator, gated below 1e-12,
times ``fs / (2 pi deviation)``, through the 300 Hz de-emphasis pole).
The AGC (quisk.c:2162) delays the audio by a 15 ms lookahead ``W``, takes
the largest magnitude in the window ``[n, n + W)`` of the delayed stream,
the limit ``min(log(0.9 / env), log(10^4))``, and the log gain
``lg[n] = min(lg[n-1] + inc, limit[n])`` with ``inc`` 60 dB/s.

To reproduce block ``k`` the reference replays the input from block
``j0 = k - prefix - burn`` with every state at zero: the filters' and
demodulators' memories then settle within the ``burn`` blocks that hold
6000 samples and the lookahead (the AM pole
leaves 0.995^6000 ~ 9e-14 of a wrong start).  The AGC's log gain
remembers further: ``lg[n] = min(L + (n+1) inc, H[n])`` with ``H`` the
part decided by the limits the reference has seen and ``L`` the gain at
the start of its record.  ``L`` is at least ``min(0, log(0.9 / A))`` for
any ``A`` that bounds the channel's audio, which follows from the largest
input magnitude through the filters' l1 norms.  Where ``H`` stays under
that bound plus ``inc`` times the record's length all over block ``k``,
the gain is ``H`` whatever came before; elsewhere the record is doubled,
back to the first block, where every state is the program's zero start.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from qref import design, ops
from qref.spec import FAMILY, rx_modes, rx_tunes
from qref.tf32 import round_tf32

SUPPORTED = {"sample_rate", "channels", "audio_rate", "audio_block",
             "filter_taps", "agc", "agc_profile", "fm_deviation_hz",
             "cw_pitch", "decim_atten_db", "fused_frontend"}
SETTLE = 6000              # samples for a zero start to settle: the AM
#                            pole leaves 0.995^6000 ~ 9e-14 of it
PREFIX = 12                # AGC record in blocks, doubled where needed
MARGIN = 1.01              # on the audio bound, for float32 rounding


@dataclasses.dataclass
class RxReference:
    fs: float
    fs_out: float
    channels: int
    block_in: int
    block_audio: int
    decim: int
    h_front: np.ndarray            # float64 [T]
    words: np.ndarray              # int64 [C], uint32 values
    family: list                   # "ssb" / "am" / "fm" per channel
    bp: np.ndarray                 # complex128 [C, T_bp]
    fm_gain: float
    de_a: float
    dc_a: float = 0.995
    agc: bool = True
    W: int = 720
    inc: float = 0.0
    max_lg: float = 0.0
    target: float = 0.9
    device: str = "cpu"
    extended: int = 0              # channels whose AGC record was doubled

    @classmethod
    def create(cls, cfg: dict, device="cpu") -> "RxReference":
        ch = cfg["chain"]
        extra = set(ch) - SUPPORTED
        if extra:
            raise ValueError(f"the reference has no stage for {sorted(extra)}")
        if ch.get("agc_profile", "delay") != "delay":
            raise ValueError("the reference's AGC is the lookahead profile")
        fs = float(ch["sample_rate"])
        fs_out = float(ch.get("audio_rate", 48000.0))
        h, d = design.front_taps(fs, fs_out, ch.get("decim_atten_db", 100.0))
        modes = rx_modes(cfg)
        pitch = ch.get("cw_pitch", design.CW_PITCH)
        rit = np.array([-pitch if m == "CWU" else pitch if m == "CWL" else 0.0
                        for m in modes])
        words = design.freq_word(rx_tunes(cfg) + rit, fs)
        ntaps = ch.get("filter_taps", 1025)
        bands = {m: design.bandpass(ntaps, *design.mode_band(m), fs_out)
                 for m in set(modes)}
        dev_hz = ch.get("fm_deviation_hz", 5000.0)
        return cls(fs=fs, fs_out=fs_out, channels=ch["channels"],
                   block_in=ch.get("audio_block", 2048) * d,
                   block_audio=ch.get("audio_block", 2048), decim=d,
                   h_front=h, words=words,
                   family=[FAMILY[m] for m in modes],
                   bp=np.stack([bands[m] for m in modes]),
                   fm_gain=fs_out / (2.0 * np.pi * dev_hz),
                   de_a=float(np.exp(-2.0 * np.pi * 300.0 / fs_out)),
                   agc=bool(ch.get("agc", True)),
                   W=max(1, int(round(15e-3 * fs_out))),
                   inc=np.log(10.0) * 60.0 / 20.0 / fs_out,
                   max_lg=np.log(10.0) * 80.0 / 20.0, device=str(device))

    # ---------------------------------------------------------------- bounds
    def audio_bound(self, xmax: np.ndarray) -> np.ndarray:
        """Per channel, a bound on the pre-AGC audio's magnitude for any
        input whose magnitude stays under ``xmax`` [C]."""
        y = (np.abs(self.h_front).sum() * np.abs(self.bp).sum(-1)
             * np.asarray(xmax, np.float64))
        # SSB 2 |Re y|; AM: the DC blocker keeps a nonnegative envelope
        # under its largest value, so 2 |y|; FM: |angle| <= pi through a
        # one-pole of DC gain 1
        fam = np.array(self.family)
        return MARGIN * np.where(fam == "fm", np.pi * self.fm_gain, 2.0 * y)

    # ---------------------------------------------------------------- stages
    def _front(self, x: torch.Tensor, s0: int, rows, lowp: bool):
        """Tune and decimate [Cc, N] complex128 starting at stream sample
        s0 -> [Cc, N / decim]."""
        dev = x.device
        N = x.shape[-1]
        s = (torch.arange(N, dtype=torch.int64, device=dev) + s0) % (1 << 32)
        w = torch.as_tensor(self.words[rows], device=dev)[:, None]
        # (w * s) mod 2^32 without leaving int64: split w in 16-bit halves
        cnt = (s * (w & 0xFFFF) + (((s * (w >> 16)) & 0xFFFF) << 16)) \
            % (1 << 32)
        ang = cnt.to(torch.float64) * (2.0 * np.pi / 2 ** 32)
        mixed = x * torch.exp(torch.complex(torch.zeros_like(ang), -ang))
        h = torch.as_tensor(self.h_front, device=dev)
        if lowp:
            mixed, h = round_tf32(mixed), round_tf32(h)
        L = design.next_pow2(N + h.shape[0] - 1)
        y = torch.fft.ifft(torch.fft.fft(mixed, L) * torch.fft.fft(h, L))
        return y[:, :N:self.decim]

    def _channel_filter(self, y: torch.Tensor, rows, lowp: bool):
        bp = torch.as_tensor(self.bp[rows], device=y.device)
        if lowp:
            y, bp = round_tf32(y), round_tf32(bp)
        N = y.shape[-1]
        L = design.next_pow2(N + bp.shape[-1] - 1)
        return torch.fft.ifft(torch.fft.fft(y, L) * torch.fft.fft(bp, L))[:, :N]

    def _agc(self, a: torch.Tensor, exact: bool, r0: int,
             low: torch.Tensor):
        """The last block of the AGC's output over the record ``a``
        [Cc, Na], and per channel whether it is decided (always, when the
        record starts at the stream's start)."""
        Cc, Na = a.shape
        W = self.W
        ext = torch.cat([torch.zeros((Cc, W), dtype=a.dtype, device=a.device),
                         a], dim=1)
        env = ops.window_max(ext.abs(), W)[:, :Na]
        limit = torch.clamp(torch.log(self.target / torch.clamp(env, min=1e-9)),
                            max=self.max_lg)
        n = torch.arange(Na, dtype=torch.float64, device=a.device)
        if exact:
            lg = n * self.inc + torch.clamp(
                torch.cummin(limit - n * self.inc, dim=1).values,
                max=self.inc)
            ok = torch.ones(Cc, dtype=torch.bool)
        else:
            m = n[r0:] - r0
            H = m * self.inc + torch.cummin(limit[:, r0:] - m * self.inc,
                                            dim=1).values
            tail = slice(Na - r0 - self.block_audio, Na - r0)
            ok = torch.all(H[:, tail] <= low[:, None] + (m[tail] + 1)
                           * self.inc, dim=1).cpu()
            lg = torch.cat([torch.zeros((Cc, r0), dtype=H.dtype,
                                        device=H.device), H], dim=1)
        out = ext[:, :Na] * torch.exp(lg)
        return out[:, Na - self.block_audio:], ok.numpy()

    # ------------------------------------------------------------- the block
    def block(self, get_block, k: int, xmax: np.ndarray, lowp: bool = False,
              chunk: int = 64) -> np.ndarray:
        """Audio of block ``k`` [C, block_audio] float64.  ``get_block(j)``
        returns input block j [C, block_in] complex64 (any device);
        ``xmax`` [C] bounds each channel's input magnitude over every block
        the program was given.  ``lowp`` computes the control: every
        filter's data and taps rounded to TF32."""
        out = np.empty((self.channels, self.block_audio))
        todo = np.arange(self.channels)
        prefix = PREFIX
        burn = -(-(SETTLE + self.W) // self.block_audio)
        low = np.minimum(0.0, np.log(self.target / self.audio_bound(xmax)))
        while todo.size:
            j0 = max(0, k - prefix - burn)
            exact = j0 == 0
            left = []
            for c0 in range(0, todo.size, chunk):
                rows = todo[c0:c0 + chunk]
                sel = torch.as_tensor(rows)
                x = torch.cat([get_block(j).index_select(
                    0, sel.to(get_block(j).device)).to(self.device)
                    .to(torch.complex128) for j in range(j0, k + 1)], dim=1)
                y = self._front(x, j0 * self.block_in, rows, lowp)
                y = self._channel_filter(y, rows, lowp)
                a = ops.demod(y, [self.family[i] for i in rows],
                              self.fm_gain, self.de_a, self.dc_a)
                if self.agc:
                    r0 = 0 if exact else burn * self.block_audio
                    blk, ok = self._agc(a, exact, r0, torch.as_tensor(
                        low[rows], device=a.device))
                else:
                    blk, ok = a[:, -self.block_audio:], np.ones(rows.size,
                                                                bool)
                out[rows] = blk.cpu().numpy()
                left.extend(rows[~ok].tolist())
            todo = np.array(left, dtype=np.int64)
            self.extended += todo.size
            prefix *= 2
        return out

