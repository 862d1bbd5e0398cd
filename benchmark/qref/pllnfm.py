"""Plain reference of the narrowband-FM receiver with WDSP's FM demodulator
(wdsp/fmd.c ``xfmd``: PLL discriminator, de-emphasis, CTCSS notch) and
Quisk's RF squelch (quisk.c:2076-2085), in float64 torch, from the
configuration and the input blocks alone.

Per channel, stream sample ``s`` (counted from the first block the
program was given) is mixed down by the NCO angle ``2 pi ((word s) mod
2^32) / 2^32``, filtered by the folded decimation cascade and kept at
every ``decim``-th sample, and filtered at the audio rate by the EXT
channel filter (a 1025-tap Blackman windowed-sinc lowpass of half the
EXT mode's 10 kHz, centred on the carrier): qref/rx.py's stages.  Then:

- the second-order PLL, sample by sample: ``err = atan2`` of the sample
  rotated by ``-ph``; ``fr = clamp(fr + beta err, +-max_freq)``;
  ``ph += fr + alpha err``, wrapped into ``[-pi, pi)``; audio
  ``(fr + alpha err) gain``, ``alpha = 2 zeta wn``, ``beta = wn^2``,
  ``zeta = 0.707``, ``wn = 2 pi 5 kHz / fs``, ``max_freq = 2 pi 10 kHz /
  fs``, ``gain = fs / (2 pi deviation)``;
- the 300 Hz de-emphasis one-pole (``qref.ops.one_pole``);
- the RBJ notch at ``ctcss_hz``, q = 5, as the direct-form recurrence
  ``y = b0 x + b1 x1 + b2 x2 - a1 y1 - a2 y2``, sample by sample;
- the lookahead AGC of qref/rx.py (``RxReference._agc``, with its record
  doubling);
- the FM squelch: a block's mean power of the channel-filtered baseband in
  dB against ``fm_squelch_db``; a block over it re-arms a hold of 0.2 s
  of blocks, each other block counts it down; the gain ramps toward open
  (hold above 0) or closed over 5 ms, a raised cosine from the last
  block's gain.

Departures from wdsp/fmd.c, on purpose: one CTCSS tone for every channel;
the notch is the RBJ notch of q = 5, not ``snotch``'s parameterisation;
its five coefficients are rounded to float32, as a receiver that keeps
them in float32 holds them (at radius 0.9987 the rounding moves the zero
0.03 Hz and leaves 1.6e-3 of the tone, more than a correct receiver's
audio differs from this reference; everything else is float64).

To reproduce block ``k`` the reference replays the input from block
``j0 = k - prefix - burn`` with every state at zero.  The PLL is
contractive (two loops on one input close their phase difference by a
factor ~0.5 a sample), the de-emphasis settles within ~800 samples, the
notch's zero-input response falls under 1e-13 within ``settle`` samples
(~0.55 s), and the squelch's hold within 6 blocks, all inside ``burn``.
The AGC's gain is decided as qref/rx.py decides it, with the PLL's bound
on the audio (``(max_freq + alpha pi) gain`` times the notch's l1 norm),
and the record doubles where it is not; a channel whose squelch is shut
through block ``k`` is silent whatever its gain.  ``lowp`` computes the
control: every filter's data and taps (front, channel filter,
de-emphasis, notch) rounded to TF32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from qref import design, ops
from qref.rx import MARGIN, RxReference
from qref.spec import rx_tunes
from qref.tf32 import round_tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUPPORTED = {"sample_rate", "channels", "audio_rate", "audio_block",
             "filter_taps", "agc", "fm_deviation_hz", "decim_atten_db",
             "fused_frontend", "ext_demod", "ctcss_hz", "fm_squelch",
             "fm_squelch_db"}
EXT_BANDWIDTH_HZ = 10000.0
PLL_LOOP_HZ, PLL_ZETA, PLL_MAX_OFFSET_HZ = 5000.0, 0.707, 10000.0
DEEMPH_HZ = 300.0
NOTCH_Q = 5.0
SQUELCH_HOLD_S, SQUELCH_RAMP_S = 0.2, 5e-3
PREFIX = 16                # AGC record in blocks, doubled where needed:
#                            60 dB/s climbs the ~4.3 nats from the audio
#                            bound's gain to a station's in ~15 blocks
RESIDUE = 1e-13            # what a zero start may leave of the notch


def rbj_notch(f0: float, fs: float, q: float = NOTCH_Q) -> tuple:
    """(b0, b1, b2, a1, a2) of the RBJ notch, rounded to float32."""
    w0 = 2.0 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2.0 * q)
    c = math.cos(w0)
    a0 = 1.0 + alpha
    return tuple(float(np.float32(v / a0)) for v in
                 (1.0, -2.0 * c, 1.0, -2.0 * c, 1.0 - alpha))


def notch_settle(coef: tuple) -> int:
    """Samples after which the notch's zero-input response is under
    ``RESIDUE`` of its start: the first n with ||A^n|| < RESIDUE, A the
    feedback pair's 2x2 step."""
    _, _, _, a1, a2 = coef
    A = np.array([[-a1, -a2], [1.0, 0.0]])
    step = np.linalg.matrix_power(A, 256)
    P, n = np.eye(2), 0
    while np.linalg.norm(P, 2) >= RESIDUE:
        P, n = P @ step, n + 256
    return n


def notch_l1(coef: tuple, n: int) -> float:
    """The l1 norm of the notch's impulse response over ``n`` samples plus
    a bound on the rest (the tail is under RESIDUE of its start)."""
    b0, b1, b2, a1, a2 = coef
    h = np.zeros(n)
    y1 = y2 = 0.0
    for i in range(n):
        x = (b0 if i == 0 else 0.0) + (b1 if i == 1 else 0.0) + (
            b2 if i == 2 else 0.0)
        y = x - a1 * y1 - a2 * y2
        h[i] = y
        y2, y1 = y1, y
    return float(np.abs(h).sum() * (1.0 + 1e-6))


@dataclasses.dataclass
class PllNfmReference:
    rx: RxReference            # the front, the channel filter and the AGC
    alpha: float
    beta: float
    max_freq: float
    gain: float
    de_a: float
    notch: tuple | None
    squelch: bool
    squelch_db: float
    hold_blocks: int
    ramp: int
    settle: int
    bound: float               # on the audio before the AGC, any input
    device: str = "cpu"
    extended: int = 0          # channels whose AGC record was doubled

    @classmethod
    def create(cls, cfg: dict, device="cpu") -> "PllNfmReference":
        ch = cfg["chain"]
        extra = set(ch) - SUPPORTED
        if extra:
            raise ValueError(f"the reference has no stage for {sorted(extra)}")
        if ch.get("ext_demod") != "pll_fm":
            raise ValueError("the reference's demodulator is pll_fm")
        if set(cfg["modes"]["cycle"]) != {"EXT"}:
            raise ValueError("every channel is EXT")
        fs = float(ch["sample_rate"])
        fo = float(ch.get("audio_rate", 48000.0))
        h, d = design.front_taps(fs, fo, ch.get("decim_atten_db", 100.0))
        C = ch["channels"]
        Ba = ch.get("audio_block", 2048)
        bp = design.bandpass(ch.get("filter_taps", 1025),
                             -EXT_BANDWIDTH_HZ / 2.0, EXT_BANDWIDTH_HZ / 2.0,
                             fo)
        wn = 2.0 * math.pi * PLL_LOOP_HZ / fo
        dev_hz = ch.get("fm_deviation_hz", 5000.0)
        rx = RxReference(
            fs=fs, fs_out=fo, channels=C, block_in=Ba * d, block_audio=Ba,
            decim=d, h_front=h, words=design.freq_word(rx_tunes(cfg), fs),
            family=["ext"] * C, bp=np.broadcast_to(bp, (C, bp.size)),
            fm_gain=fo / (2.0 * math.pi * dev_hz),
            de_a=math.exp(-2.0 * math.pi * DEEMPH_HZ / fo),
            agc=bool(ch.get("agc", True)), W=max(1, round(15e-3 * fo)),
            inc=math.log(10.0) * 60.0 / 20.0 / fo,
            max_lg=math.log(10.0) * 80.0 / 20.0, device=str(device))
        f0 = float(ch.get("ctcss_hz", 0.0))
        notch = rbj_notch(f0, fo) if f0 > 0.0 else None
        n_notch = notch_settle(notch) if notch else 0
        alpha = 2.0 * PLL_ZETA * wn
        max_freq = 2.0 * math.pi * PLL_MAX_OFFSET_HZ / fo
        l1 = notch_l1(notch, n_notch) if notch else 1.0
        return cls(rx=rx, alpha=alpha, beta=wn * wn, max_freq=max_freq,
                   gain=rx.fm_gain, de_a=rx.de_a, notch=notch,
                   squelch=bool(ch.get("fm_squelch", False)),
                   squelch_db=float(ch.get("fm_squelch_db", -60.0)),
                   hold_blocks=max(1, round(SQUELCH_HOLD_S * fo / Ba)),
                   ramp=max(1, int(SQUELCH_RAMP_S * fo)),
                   settle=max(n_notch, 1000) + bp.size,
                   bound=MARGIN * (max_freq + alpha * math.pi) * rx.fm_gain
                   * l1, device=str(device))

    @property
    def burn(self) -> int:
        """Blocks replayed before the AGC's record: the states' settling,
        the AGC's window and the squelch's hold."""
        Ba = self.rx.block_audio
        return max(-(-(self.settle + self.rx.W) // Ba), self.hold_blocks + 2)

    # ---------------------------------------------------------------- stages
    def pll(self, z: torch.Tensor) -> torch.Tensor:
        """The loop over z [n, N] complex128 from rest -> [n, N] float64.
        It carries ``nph``, minus the loop's phase, and wraps it into
        [-pi, pi) (the loop reads the phase only through its sine and
        cosine); ten launches a sample."""
        zt = z.T.contiguous()
        nph = torch.zeros(z.shape[0], dtype=torch.float64, device=z.device)
        fr = torch.zeros_like(nph)
        one = torch.ones_like(nph)
        out = torch.empty(zt.shape, dtype=torch.float64, device=z.device)
        for n in range(zt.shape[0]):
            err = torch.angle(zt[n] * torch.polar(one, nph))
            fr.add_(err, alpha=self.beta).clamp_(-self.max_freq,
                                                 self.max_freq)
            step = torch.add(fr, err, alpha=self.alpha, out=out[n])
            nph.sub_(step).add_(math.pi).remainder_(2.0 * math.pi).sub_(
                math.pi)
        return out.T * self.gain

    def deemph(self, a: torch.Tensor, lowp: bool) -> torch.Tensor:
        da, db = self.de_a, 1.0 - self.de_a
        if lowp:
            a, da, db = round_tf32(a), *(float(round_tf32(torch.tensor(v)))
                                         for v in (da, db))
        return ops.one_pole(a, da, db)

    def ctcss(self, a: torch.Tensor, lowp: bool) -> torch.Tensor:
        if self.notch is None:
            return a
        b0, b1, b2, a1, a2 = self.notch
        if lowp:
            a = round_tf32(a)
            b0, b1, b2, a1, a2 = (float(round_tf32(torch.tensor(v)))
                                  for v in self.notch)
        x1 = ops.before(a)
        f = (b0 * a + b1 * x1 + b2 * ops.before(x1)).T.contiguous()
        y = torch.empty_like(f)
        zero = torch.zeros_like(f[0])
        for n in range(f.shape[0]):
            y1 = y[n - 1] if n >= 1 else zero
            y2 = y[n - 2] if n >= 2 else zero
            torch.add(f[n], y1, alpha=-a1, out=y[n])
            y[n].add_(y2, alpha=-a2)
        return y.T

    def rf_db(self, z: torch.Tensor) -> torch.Tensor:
        """[n, blocks]: each block's mean power of z in dB."""
        n, N = z.shape
        Ba = self.rx.block_audio
        p = (z.abs() ** 2).reshape(n, N // Ba, Ba).mean(-1)
        return 10.0 * torch.log10(p + 1e-20)

    def squelch_gain(self, rf: torch.Tensor) -> torch.Tensor:
        """The last block's squelch gain [n, Ba] over the blocks' levels
        ``rf`` [n, blocks], from a shut squelch."""
        n, nb = rf.shape
        Ba = self.rx.block_audio
        t = torch.arange(Ba, dtype=torch.float64, device=rf.device)
        frac = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp(t / self.ramp,
                                                            max=1.0))
        hold = torch.zeros(n, dtype=torch.int64, device=rf.device)
        g = torch.zeros(n, dtype=torch.float64, device=rf.device)
        for b in range(nb):
            hold = torch.where(rf[:, b] > self.squelch_db,
                               torch.full_like(hold, self.hold_blocks),
                               torch.clamp(hold - 1, min=0))
            gb = g[:, None] + ((hold > 0).to(g.dtype) - g)[:, None] * frac
            g = gb[:, -1]
        return gb

    # ------------------------------------------------------------ the blocks
    def _baseband(self, get_block, k: int, j0: int, rows, lowp: bool,
                  chunk: int) -> torch.Tensor:
        """The channel-filtered baseband [len(rows), (k + 1 - j0) Ba] of
        ``rows`` replayed from block j0, from rest."""
        rx = self.rx
        outs = []
        for c0 in range(0, len(rows), chunk):
            r = rows[c0:c0 + chunk]
            sel = torch.as_tensor(r)
            x = torch.cat([get_block(j).index_select(
                0, sel.to(get_block(j).device)).to(self.device)
                .to(torch.complex128) for j in range(j0, k + 1)], dim=1)
            y = rx._front(x, j0 * rx.block_in, r, lowp)
            outs.append(rx._channel_filter(y, r, lowp))
            del x, y
        return torch.cat(outs, dim=0)

    def blocks(self, get_block, ks, rows, lowp: bool = False,
               chunk: int = 64) -> dict:
        """{k: (audio [len(rows), Ba] float64, rf_db [len(rows)])} of each
        block ``k`` of ``ks`` on channels ``rows``.  Blocks whose replays
        are as long are stepped through the PLL and the notch together."""
        Ba = self.rx.block_audio
        low = min(0.0, math.log(self.rx.target / self.bound))
        out = {k: (np.empty((len(rows), Ba)), np.empty(len(rows)))
               for k in ks}
        todo = [(k, np.arange(len(rows))) for k in ks]
        prefix = PREFIX
        while todo:
            groups: dict = {}
            for k, idx in todo:
                j0 = max(0, k - prefix - self.burn)
                groups.setdefault(k - j0, []).append((k, j0, idx))
            left = []
            for jobs in groups.values():
                z = torch.cat([self._baseband(get_block, k, j0, rows[idx],
                                              lowp, chunk)
                               for k, j0, idx in jobs], dim=0)
                a = self.ctcss(self.deemph(self.pll(z), lowp), lowp)
                rf = self.rf_db(z)
                del z
                g = (self.squelch_gain(rf) if self.squelch
                     else torch.ones((a.shape[0], Ba), dtype=a.dtype,
                                     device=a.device))
                at = 0
                for k, j0, idx in jobs:
                    n = len(idx)
                    ak = a[at:at + n]
                    if self.rx.agc:
                        exact = j0 == 0
                        r0 = 0 if exact else self.burn * Ba
                        blk, ok = self.rx._agc(ak, exact, r0, torch.full(
                            (n,), low, dtype=torch.float64, device=a.device))
                    else:
                        blk, ok = ak[:, -Ba:], np.ones(n, bool)
                    gk = g[at:at + n]
                    ok = ok | (gk == 0).all(-1).cpu().numpy()
                    out[k][0][idx] = (blk * gk).cpu().numpy()
                    out[k][1][idx] = rf[at:at + n, -1].cpu().numpy()
                    if not ok.all():
                        left.append((k, idx[~ok]))
                        self.extended += int((~ok).sum())
                    at += n
                del a, g
            todo = left
            prefix *= 2
        return out
