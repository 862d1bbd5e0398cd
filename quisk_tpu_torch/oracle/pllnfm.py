"""Plain reference of the narrowband-FM receiver with WDSP's FM demodulator,
in float64 torch, one whole stream at a time.

The chain, from its published description (Quisk 4.2.52's receive path,
quisk.c:1731-1843 and quisk.c:2076-2085; WDSP's ``xfmd``, wdsp/fmd.c), per
channel of a ``[C, N]`` complex capture at ``sample_rate``:

- the NCO mix: stream sample ``s`` times ``exp(-i 2 pi ((word s) mod
  2^32) / 2^32)``, ``word = round(f / fs 2^32) mod 2^32``;
- the decimating front filter to the audio rate: the half-band /2 stages
  (45 taps, Kaiser 120 dB, even offsets but the centre zeroed) and Kaiser
  /3, /5 stages, folded into one filter, every ``decim``-th output kept;
- the EXT channel filter: a 1025-tap Blackman windowed-sinc lowpass of
  half of ``EXT_BANDWIDTH_HZ`` (10 kHz), centred on the carrier;
- the second-order PLL, sample by sample: ``err = atan2`` of the sample
  rotated by ``-ph``; ``fr = clamp(fr + beta err, +-max_freq)``;
  ``ph += fr + alpha err``, wrapped into ``[-pi, pi]``; audio
  ``(fr + alpha err) gain`` with ``alpha = 2 zeta wn``, ``beta = wn^2``,
  ``zeta = 0.707``, ``wn = 2 pi 5 kHz / fs``, ``max_freq = 2 pi 10 kHz /
  fs`` and ``gain = fs / (2 pi deviation)``;
- the de-emphasis, the one-pole ``y = a y + (1 - a) x``, ``a = exp(-2 pi
  300 / fs)``, sample by sample;
- the CTCSS notch (``ctcss_hz`` above 0): the RBJ notch at ``ctcss_hz``,
  q = 5, as the direct-form recurrence ``y = b0 x + b1 x1 + b2 x2 - a1 y1
  - a2 y2``, sample by sample;
- the lookahead AGC (quisk.c:2162): the audio delayed by ``W`` = 15 ms,
  the largest magnitude in the window of the next ``W`` samples of the
  undelayed stream, the limit ``min(log(0.9 / env), log(10^4))`` and the
  log gain ``lg[n] = min(lg[n-1] + inc, limit[n])``, ``inc`` 60 dB/s;
- the FM squelch (quisk.c:2076-2085): a block's mean power of the
  channel-filtered baseband in dB against ``fm_squelch_db``; a block over
  it re-arms a hold of 0.2 s of blocks, each other block counts it down;
  the gain ramps toward open (hold above 0) or closed over 5 ms, a raised
  cosine from the last block's gain.

Every stage starts from rest at stream sample 0.  ``lowp`` makes the
control: every filter's data and taps (the front filter, the channel
filter, the de-emphasis and the notch) rounded to TF32, the tensor cores'
float32 (10 mantissa bits), before the filter runs.

Departures from wdsp/fmd.c, on purpose:

- one CTCSS tone for all channels (upstream sets one a receiver too, so a
  batch of receivers shares it here);
- the notch is the RBJ notch of q = 5 (a 20 Hz wide notch at 100 Hz),
  not ``snotch``'s own bandwidth parameterisation;
- the notch's five coefficients are rounded to float32, as a receiver that
  keeps its coefficients in float32 holds them: the pole pair sits at
  radius 0.9987, where rounding the coefficients moves the zero by
  0.03 Hz and leaves 1.6e-3 of the tone at 100 Hz (the float64 design
  leaves 6e-12), which is more than a correct receiver's audio differs
  from this reference.  Everything else is computed from float64
  constants.

It imports no kernel or op of the port and nothing of JAX; the filter
designs are worked out again here with SciPy.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy import signal as sig

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

EXT_BANDWIDTH_HZ = 10000.0     # the EXT mode's channel filter width
PLL_LOOP_HZ = 5000.0
PLL_ZETA = 0.707
PLL_MAX_OFFSET_HZ = 10000.0
DEEMPH_HZ = 300.0
NOTCH_Q = 5.0
AGC_TARGET = 0.9
AGC_MAX_DB = 80.0
AGC_RELEASE_DB_PER_S = 60.0
AGC_LOOKAHEAD_S = 15e-3
SQUELCH_HOLD_S = 0.2
SQUELCH_RAMP_S = 5e-3


def _stages(fs_in: float, fs_out: float) -> list[int]:
    """The integer /2, /5, /3 stages of an exact ``fs_in / fs_out``."""
    ratio = int(round(fs_in / fs_out))
    if abs(fs_in / ratio - fs_out) > 1e-6:
        raise ValueError("only a whole-number rate ratio")
    out = []
    for p in (2, 5, 3):
        while ratio % p == 0:
            out.append(p)
            ratio //= p
    if ratio != 1:
        raise ValueError("only /2, /3 and /5 stages")
    return out


def front_taps(fs_in: float, fs_out: float) -> tuple[np.ndarray, int]:
    """The decimation cascade folded into one filter (float64 taps) and
    its decimation: stage ``i`` upsampled by the decimation before it."""
    comb, d_tot, fs = np.ones(1), 1, fs_in
    for d in _stages(fs_in, fs_out):
        if d == 2:
            h = sig.firwin(45, 0.5, window=("kaiser", sig.kaiser_beta(120.0)))
            k = np.arange(45) - 22
            h[(k % 2 == 0) & (k != 0)] = 0.0
            h /= h.sum()
        else:
            out = fs / d
            n, beta = sig.kaiserord(100.0, 0.1 * out / (0.5 * fs))
            h = sig.firwin(n | 1, 0.45 * out, fs=fs, window=("kaiser", beta))
        up = np.zeros((len(h) - 1) * d_tot + 1)
        up[::d_tot] = h
        comb = np.convolve(comb, up)
        d_tot *= d
        fs /= d
    return comb, d_tot


def ext_bandpass(ntaps: int, fs: float) -> np.ndarray:
    """The EXT channel filter: a Blackman windowed-sinc lowpass of half
    the EXT bandwidth, centred on 0 Hz (its band is symmetric)."""
    return sig.firwin(ntaps | 1, EXT_BANDWIDTH_HZ / 2.0, fs=fs,
                      window="blackman").astype(np.complex128)


def rbj_notch(f0: float, fs: float, q: float = NOTCH_Q) -> tuple:
    """(b0, b1, b2, a1, a2) of the RBJ notch, rounded to float32."""
    w0 = 2.0 * math.pi * f0 / fs
    alpha = math.sin(w0) / (2.0 * q)
    c = math.cos(w0)
    a0 = 1.0 + alpha
    return tuple(float(np.float32(v / a0)) for v in
                 (1.0, -2.0 * c, 1.0, -2.0 * c, 1.0 - alpha))


def round_tf32(t):
    """A tensor (real or complex) or a float rounded to TF32, nearest."""
    if not isinstance(t, torch.Tensor):
        return float(round_tf32(torch.tensor(t, dtype=torch.float64)))
    if t.is_complex():
        return torch.complex(round_tf32(t.real), round_tf32(t.imag))
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32).to(t.dtype)


def freq_word(freq_hz, fs: float) -> np.ndarray:
    f = np.asarray(freq_hz, dtype=np.float64)
    return np.round(f / fs * 4294967296.0).astype(np.int64) % (1 << 32)


def _causal(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k h[k] x[n - k] along the last axis, from rest."""
    N = x.shape[-1]
    L = 1 << math.ceil(math.log2(N + h.shape[-1] - 1))
    return torch.fft.ifft(torch.fft.fft(x, L) * torch.fft.fft(h, L))[..., :N]


@dataclasses.dataclass
class PllNfmOracle:
    fs: float
    fs_out: float
    decim: int
    block_audio: int
    h_front: np.ndarray
    words: np.ndarray
    bp: np.ndarray
    alpha: float
    beta: float
    max_freq: float
    gain: float
    de_a: float
    notch: tuple | None
    agc: bool
    W: int
    inc: float
    max_lg: float
    squelch: bool
    squelch_db: float
    hold_blocks: int
    ramp: int
    lowp: bool = False

    def _r(self, t):
        return round_tf32(t) if self.lowp else t

    @classmethod
    def create(cls, sample_rate: float, tune_hz, audio_rate: float = 48000.0,
               audio_block: int = 2048, filter_taps: int = 1025,
               fm_deviation_hz: float = 5000.0, ctcss_hz: float = 0.0,
               agc: bool = True, fm_squelch: bool = False,
               fm_squelch_db: float = -60.0, lowp: bool = False
               ) -> "PllNfmOracle":
        h, d = front_taps(sample_rate, audio_rate)
        fo = audio_rate
        wn = 2.0 * math.pi * PLL_LOOP_HZ / fo
        return cls(
            fs=sample_rate, fs_out=fo, decim=d, block_audio=audio_block,
            h_front=h, words=freq_word(tune_hz, sample_rate),
            bp=ext_bandpass(filter_taps, fo),
            alpha=2.0 * PLL_ZETA * wn, beta=wn * wn,
            max_freq=2.0 * math.pi * PLL_MAX_OFFSET_HZ / fo,
            gain=fo / (2.0 * math.pi * fm_deviation_hz),
            de_a=math.exp(-2.0 * math.pi * DEEMPH_HZ / fo),
            notch=rbj_notch(ctcss_hz, fo) if ctcss_hz > 0.0 else None,
            agc=agc, W=max(1, round(AGC_LOOKAHEAD_S * fo)),
            inc=math.log(10.0) * AGC_RELEASE_DB_PER_S / 20.0 / fo,
            max_lg=math.log(10.0) * AGC_MAX_DB / 20.0,
            squelch=fm_squelch, squelch_db=fm_squelch_db,
            hold_blocks=max(1, round(SQUELCH_HOLD_S * fo / audio_block)),
            ramp=max(1, int(SQUELCH_RAMP_S * fo)), lowp=lowp)

    # ---------------------------------------------------------------- stages
    def baseband(self, x: torch.Tensor) -> torch.Tensor:
        """Mix, front filter, decimation and EXT filter: x [C, N]
        (complex, from stream sample 0) -> [C, N / decim] complex128."""
        x = x.to(torch.complex128)
        dev = x.device
        s = torch.arange(x.shape[-1], dtype=torch.int64, device=dev)
        w = torch.as_tensor(self.words, device=dev)[:, None]
        # (w s) mod 2^32 in int64: w split in 16-bit halves
        cnt = (s * (w & 0xFFFF) + (((s * (w >> 16)) & 0xFFFF) << 16)) \
            % (1 << 32)
        ang = cnt.to(torch.float64) * (2.0 * math.pi / 2 ** 32)
        r = self._r
        y = _causal(r(x * torch.polar(torch.ones_like(ang), -ang)),
                    r(torch.as_tensor(self.h_front, device=dev)))
        return _causal(r(y[:, ::self.decim]),
                       r(torch.as_tensor(self.bp, device=dev)))

    def pll(self, z: torch.Tensor) -> torch.Tensor:
        """The loop over z [C, N] complex128 -> audio [C, N] float64."""
        C, N = z.shape
        zt = z.T.contiguous()
        ph = torch.zeros(C, dtype=torch.float64, device=z.device)
        fr = torch.zeros_like(ph)
        out = torch.empty((N, C), dtype=torch.float64, device=z.device)
        for n in range(N):
            v = zt[n] * torch.polar(torch.ones_like(ph), -ph)
            err = torch.atan2(v.imag, v.real)
            fr = torch.clamp(fr + self.beta * err, -self.max_freq,
                             self.max_freq)
            step = fr + self.alpha * err
            ph = ph + step
            ph = torch.where(ph > math.pi, ph - 2.0 * math.pi,
                             torch.where(ph < -math.pi, ph + 2.0 * math.pi,
                                         ph))
            out[n] = step * self.gain
        return out.T

    def deemph(self, a: torch.Tensor) -> torch.Tensor:
        at = self._r(a.T.contiguous())
        out = torch.empty_like(at)
        y = torch.zeros_like(at[0])
        da, db = self._r(self.de_a), self._r(1.0 - self.de_a)
        for n in range(at.shape[0]):
            y = da * y + db * at[n]
            out[n] = y
        return out.T

    def ctcss(self, a: torch.Tensor) -> torch.Tensor:
        if self.notch is None:
            return a
        b0, b1, b2, a1, a2 = map(self._r, self.notch)
        at = self._r(a.T.contiguous())
        out = torch.empty_like(at)
        z = torch.zeros_like(at[0])
        x1 = x2 = y1 = y2 = z
        for n in range(at.shape[0]):
            y = b0 * at[n] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
            x2, x1, y2, y1 = x1, at[n], y1, y
            out[n] = y
        return out.T

    def lookahead_agc(self, a: torch.Tensor) -> torch.Tensor:
        if not self.agc:
            return a
        C, N = a.shape
        W = self.W
        ext = torch.cat([torch.zeros((C, W), dtype=a.dtype,
                                     device=a.device), a], dim=1)
        win = torch.nn.functional.pad(ext.abs(), (0, W - 1))
        env = win.unfold(-1, W, 1).amax(-1)[:, :N]
        limit = torch.clamp(torch.log(AGC_TARGET / torch.clamp(env,
                                                               min=1e-9)),
                            max=self.max_lg)
        lg = torch.zeros(C, dtype=a.dtype, device=a.device)
        out = torch.empty_like(a)
        for n in range(N):
            lg = torch.minimum(lg + self.inc, limit[:, n])
            out[:, n] = ext[:, n] * torch.exp(lg)
        return out

    def rf_db(self, y: torch.Tensor) -> torch.Tensor:
        """[C, blocks]: each block's mean power of the channel-filtered
        baseband, in dB."""
        C, N = y.shape
        p = (y.abs() ** 2).reshape(C, N // self.block_audio,
                                   self.block_audio).mean(-1)
        return 10.0 * torch.log10(p + 1e-20)

    def squelch_gain(self, rf_db: torch.Tensor) -> tuple:
        """(gain [C, N] float64, open [C, blocks] bool): the hold and the
        ramp, block by block."""
        C, nb = rf_db.shape
        Ba = self.block_audio
        t = torch.arange(Ba, dtype=torch.float64, device=rf_db.device)
        frac = 0.5 - 0.5 * torch.cos(math.pi * torch.clamp(t / self.ramp,
                                                            max=1.0))
        hold = torch.zeros(C, dtype=torch.int64, device=rf_db.device)
        g = torch.zeros(C, dtype=torch.float64, device=rf_db.device)
        gains, opened = [], []
        for b in range(nb):
            hold = torch.where(rf_db[:, b] > self.squelch_db,
                               torch.full_like(hold, self.hold_blocks),
                               torch.clamp(hold - 1, min=0))
            target = (hold > 0).to(torch.float64)
            gb = g[:, None] + (target - g)[:, None] * frac[None, :]
            g = gb[:, -1]
            gains.append(gb)
            opened.append(hold > 0)
        return torch.cat(gains, dim=1), torch.stack(opened, dim=1)

    # ------------------------------------------------------------ the stream
    def run(self, x: torch.Tensor) -> dict:
        """The whole stream x [C, N] (N a whole number of blocks):
        {"audio": [C, N / decim] float64, "rf_db": [C, blocks],
        "open": [C, blocks] bool}."""
        y = self.baseband(x)
        a = self.lookahead_agc(self.ctcss(self.deemph(self.pll(y))))
        rf = self.rf_db(y)
        out = {"audio": a, "rf_db": rf,
               "open": torch.ones(rf.shape, dtype=torch.bool)}
        if self.squelch:
            g, out["open"] = self.squelch_gain(rf)
            out["audio"] = a * g
        return out
