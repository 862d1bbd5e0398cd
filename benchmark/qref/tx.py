"""Plain reference of Quisk's transmit chain (microphone.c
``quisk_process_microphone`` and ``tx_filter``), in float64 torch, from the
configuration and the mic blocks alone.

Per channel (one transmitter a row, its mode fixed), mic sample ``a[n]``
at the audio rate ``fs`` goes through:

- pre-emphasis ``p[n] = a[n] - c a[n-1]`` (microphone.c:452-465);
- the soft compressor (484-518): ``x = drive p`` with ``drive =
  10^(compress_db / 20)``; below the knee 0.5 ``|x|`` passes, above it
  ``0.5 + s (t - t^2 / 2)``, ``t = (|x| - 0.5) / s`` clipped to [0, 1],
  ``s = 2 (1 - 0.5)``, so the curve reaches the ceiling 1.0 with slope 0;
  the sign kept; a drive of 1 or less passes the audio unchanged;
- the analytic bandpass (469; 605 ``tx_filter_digital``): a 513-tap
  Blackman windowed-sinc lowpass of half the band, shifted to the band's
  centre (``qref.design.bandpass``), 300-2700 Hz on voice rows and
  50-3050 Hz on digital rows, a causal convolution ``z = h * x``;
- the modulator (1226-1278): USB and DGT_U ``z``, LSB ``conj z``, AM the
  real ``am_carrier + (1 - am_carrier) Re z``, FM ``exp(j phi)`` with
  ``phi = g_pm Re z + b sin(theta)``: the audio reaches the deviation at
  the band's top edge and, with a CTCSS tone, takes 85% of it, so ``g_pm
  = 2 * 0.85 deviation / 2700`` (the 2 makes up the analytic filter's
  0.5 on a real tone) and the tone swings ``b = 0.15 deviation /
  tone_hz`` rad; ``theta`` advances ``2 pi tone_hz / fs`` a sample;
- the ALC, ``process_alc`` (270-358) on the modulated samples, below;
- interpolation by ``L = tx_rate / fs`` (1307-1336): the samples
  zero-stuffed by L and filtered by a Kaiser image-reject lowpass (90 dB,
  passband to 0.4 fs, stopband from fs / 2, gain L); the output at TX
  sample ``N`` is the filter's causal output at ``N - (L - 1)``;
- the TX tune (sound.c:708): TX sample ``s`` (counted from the first
  block) rotated by ``2 pi ((word s) mod 2^32) / 2^32``, the word the
  channel's offset in 2^32 parts of the TX rate; the I/Q trim is the
  identity.

The ALC delays the modulated stream by ``A = 20 ms`` and multiplies the
delayed sample by the gain ``g`` of the newest one; per sample ``n``
(newest magnitude ``m``, ``tm = target / m``, target ``(32767 - 10) /
32767``; silent below 100 / 32758):

- a clip, ``m (g + gc A) > target``: ``fg = clamp(tm, 0.1, 3)``, ``gc =
  (fg - g) / A`` (a ramp over the delay that lands on the safe gain),
  the block restarts here (``bi`` = the ALC index ``n mod A``);
- else, where the block completes (``n mod A == bi``): a recovery ramp
  ``gc = (clamp(g + r A, 0.1, 3) - g) / A``, ``r = min(nc, 1 / (5 fs))``
  (the observed headroom, bounded by a 5 s gain doubling) if fewer than
  ``A - 10`` samples since the last reset were silent, else ``r = gc``;
  ``fg`` its end;
- else an observation: ``cnt`` counts the loud samples since the last
  reset, ``nc = min(nc, (tm - fg) / max(cnt, 1))`` over them, and the
  silent ones are counted;
- a clip or a completed block resets ``nc`` (1e10), ``cnt`` and the
  silent count; then ``g += gc``.

From rest ``g = 1``, ``gc = fg = 0``, ``nc = 1e10``, ``bi = 0``.  The loop
is stepped event to event (``Alc.run``): between a reset and the next clip
or completed block the gain moves on a line, the counts are running sums
and ``nc`` a running minimum, so each step takes a whole stretch of up to
``A`` samples; ``benchmark/tests/test_benchmark_tx.py`` holds it to the
sample-by-sample loop.  That loop takes ~400 us a sample over 4096 rows in
NumPy on one CPU core (4.1 min for 300 blocks of 2048), and on the card ~25
launches a sample: far over a run's budget, where the event-stepped one replays the
cell's 240-359 blocks in ~25 s on the card.

Three departures from Quisk, each on purpose:

- The CTCSS tone's phase at each block's start follows the program's
  float32 carry: ``theta_0 = 0``, ``theta_{j+1} = (theta_j + w B) mod 2
  pi`` in float32 with ``w`` the float32 step (``ctcss_carry``); inside
  the block it advances in float64.  The float32 step is off by up to
  3.6e-8 of itself, which over thousands of blocks puts the tone's phase
  out by more than the comparison's limit, a gap that grows with the
  block index and says nothing of the block.
- A clip by less than 1e-12 of the target is taken for none (``CLIP``).
  An FM row's ``|exp(j phi)|`` is 1 to a rounding, and once its gain has
  landed on the target such ties would restart the ALC's block at every
  other sample, moving the gain by less than 1e-12 and making each of
  those samples an event of the loop; which way a tie falls is a
  rounding in Quisk's double and in the program's float32 alike.
- To reproduce block ``k`` the reference replays the mic input from
  rest, as the program starts, from the latest block at least ``REPLAY``
  blocks before ``k`` at which the ring and the ALC's index stand as at
  the first block (a multiple of ``period``, 120 blocks in the cell), and
  not from a record that doubles until two replays agree, as
  ``qref/rx.py`` does for its AGC.  This ALC's recovery is slow (a 5 s
  doubling) and on the ring's periodic input it settles into one of
  several orbits (which samples clip, where its blocks complete): two
  replays from rest at other phases can agree with each other and not
  with the stream (on digital rows whose tone jumped in phase once a
  ring, replays P and 2P blocks back agreed to 1e-9 at block 619 and
  differed from the replay from the first block by 4.3% and 3.1%).  From
  rest at the first block's phase a channel reaches the stream's orbit
  within ~213 blocks (100 channels on the CPU; replays from block 360 and
  from block 0 gave block 600 bit for bit); a channel whose orbit
  wanders stays within the spread that ``iq_gap``'s limit covers, and
  ``phase_gap`` does not see it.

``lowp`` computes the control: every filter's data and taps (the
pre-emphasis, the analytic filter, the interpolator) rounded to TF32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from scipy import signal as sig

from qref import design
from qref.spec import rx_modes, rx_tunes
from qref.tf32 import round_tf32

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SUPPORTED = {"channels", "audio_rate", "tx_rate", "audio_block",
             "mic_band", "filter_taps", "preemphasis", "compress_db", "alc",
             "fm_deviation_hz", "ctcss_hz", "am_carrier"}
MODES = ("USB", "LSB", "AM", "FM", "DGT_U")
DGT_BAND = (50.0, 3050.0)
KNEE, CEILING = 0.5, 1.0
FM_AUDIO_SHARE, CTCSS_SHARE = 0.85, 0.15
ALC_MS, GAIN_MIN, GAIN_MAX, DOUBLE_S = 20.0, 0.1, 3.0, 5.0
TARGET = (32767.0 - 10.0) / 32767.0
CLIP = TARGET * (1.0 + 1e-12)   # a clip by less is a rounding tie
MIN_MAGN = 100.0 / 32758.0
INTERP_DB, INTERP_PASS = 90.0, 0.4
SPAN = 8                   # blocks replayed a step
REPLAY = 240               # blocks at least in a replay from rest


def image_reject(L: int, fs_out: float) -> np.ndarray:
    """The interpolator's Kaiser lowpass at the TX rate, gain L."""
    fs_in = fs_out / L
    transition = (0.5 - INTERP_PASS) * fs_in
    ntaps, beta = sig.kaiserord(INTERP_DB, transition / (0.5 * fs_out))
    ntaps |= 1
    h = sig.firwin(ntaps, INTERP_PASS * fs_in + transition / 2.0, fs=fs_out,
                   window=("kaiser", beta))
    return h * L


def compress(p: torch.Tensor, drive: float) -> torch.Tensor:
    if drive <= 1.0:
        return p
    x = p * drive
    m = x.abs()
    span = 2.0 * (CEILING - KNEE)
    t = torch.clamp((m - KNEE) / span, 0.0, 1.0)
    y = torch.where(m <= KNEE, m, KNEE + span * (t - 0.5 * t * t))
    return torch.sign(x) * torch.clamp(y, max=CEILING)


def ctcss_carry(w: float, block: int, blocks: int) -> np.ndarray:
    """[blocks] float64: the float32 tone phase at each block's start."""
    w32, two_pi = np.float32(w), np.float32(2.0 * math.pi)
    step = np.float32(w32 * np.float32(block))
    out = np.zeros(blocks)
    ph = np.float32(0.0)
    for j in range(1, blocks):
        ph = np.fmod(np.float32(ph + step), two_pi)
        out[j] = float(ph)
    return out


@dataclasses.dataclass
class Alc:
    """``process_alc`` for rows of one mode each; the state is a dict of
    [R] tensors (``rest``)."""

    A: int
    d_limit: float

    def rest(self, R: int, device) -> dict:
        f = {"dtype": torch.float64, "device": device}
        return {"g": torch.ones(R, **f), "gc": torch.zeros(R, **f),
                "fg": torch.zeros(R, **f), "nc": torch.full((R,), 1e10, **f),
                "cnt": torch.zeros(R, **f), "flt": torch.zeros(R, **f),
                "bi": torch.zeros(R, dtype=torch.int64, device=device)}

    def run(self, st: dict, m: torch.Tensor, ix0: int, per: int) -> tuple:
        """(the gain [R, N] each sample sees, the clips [R, N / per] in each
        stretch of ``per`` samples) for the newest magnitudes ``m`` [R, N]
        float64, the ALC index ``ix0`` at the first sample; updates
        ``st``.  Each step takes every row to its next event: a clip (with
        the clips that follow it sample after sample) or a completed
        block, which comes within ``A`` samples."""
        R, N = m.shape
        A, dev = self.A, m.device
        decay = 1.0 - 1.0 / A
        pad = torch.zeros((R, A), dtype=torch.float64, device=dev)
        mp = torch.cat([m, pad], 1)
        tmp = TARGET / torch.clamp(mp, min=1e-9)
        loud = mp >= MIN_MAGN
        gains = torch.empty((R, N + A), dtype=torch.float64, device=dev)
        clips = torch.zeros((R, N // per), dtype=torch.int64, device=dev)
        d = torch.arange(A, device=dev)
        pos = torch.zeros(R, dtype=torch.int64, device=dev)
        s = st
        while bool((pos < N).any()):
            n = pos[:, None] + d
            inb = n < N
            mw, tmw, lw = mp.gather(1, n), tmp.gather(1, n), loud.gather(1, n)
            gw = s["g"][:, None] + s["gc"][:, None] * d
            clip = (mw * (gw + s["gc"][:, None] * A) > CLIP) & inb
            d_blk = torch.remainder(s["bi"] - ix0 - pos, A)
            ev = clip | ((d == d_blk[:, None]) & inb)
            has = ev.any(1)
            e = torch.where(has, torch.where(ev, d, A).amin(1), N - pos)
            before = (d < e[:, None]) & inb
            lb = lw & before
            cnt_d = s["cnt"][:, None] + torch.cumsum(lb, 1)
            obs = torch.where(lb, (tmw - s["fg"][:, None])
                              / torch.clamp(cnt_d, min=1.0), math.inf)
            nc = torch.minimum(s["nc"], obs.amin(1))
            flt = s["flt"] + (before & ~lw).sum(1)
            at = torch.clamp(e, max=A - 1)[:, None]
            is_clip = has & clip.gather(1, at)[:, 0]
            is_blk = has & ~is_clip
            clips.scatter_add_(1, torch.clamp((pos + e) // per,
                                              max=N // per - 1)[:, None],
                               is_clip[:, None].to(torch.int64))
            # a clip that the next samples keep setting off, as a rising
            # envelope does: while each sample clips, g[n+1] = a g[n] +
            # fg[n] / A with a = 1 - 1/A, a first-order recurrence taken
            # whole; the run ends at the last sample whose successor does
            # not clip
            rel = (d - e[:, None]).to(torch.float64)
            on = (rel >= 0) & inb
            fgw = torch.clamp(tmw, GAIN_MIN, GAIN_MAX)
            t = torch.where(on, fgw / A * decay ** (-rel - 1.0), 0.0)
            gs = decay ** rel * (gw.gather(1, at) + torch.cumsum(t, 1) - t)
            nxt = gs + (fgw - gs) * ((A + 1) / A)
            cont = (mw[:, 1:] * nxt[:, :-1] > CLIP) & on[:, :-1] & inb[:, 1:]
            last = torch.where(is_clip, torch.where(
                on[:, :-1] & ~cont, d[:-1], A - 1).amin(1), e)
            storm = (rel > 0) & (d <= last[:, None]) & is_clip[:, None]
            # the window's gains; a later step rewrites those past the event
            gains.scatter_(1, n, torch.where(storm, gs, gw))
            lat = torch.clamp(last, max=A - 1)[:, None]
            g = torch.where(is_clip, gs.gather(1, lat)[:, 0],
                            s["g"] + s["gc"] * e)
            fg1 = fgw.gather(1, lat)[:, 0]
            r = torch.where(flt < A - 10, torch.clamp(nc, max=self.d_limit),
                            s["gc"])
            fg2 = torch.clamp(g + r * A, GAIN_MIN, GAIN_MAX)
            gc = torch.where(is_clip, (fg1 - g) / A, torch.where(
                is_blk, (fg2 - g) / A, s["gc"]))
            s = {"g": g + torch.where(has, gc, 0.0), "gc": gc,
                 "fg": torch.where(is_clip, fg1, torch.where(
                     is_blk, fg2, s["fg"])),
                 "nc": torch.where(has, 1e10, nc),
                 "cnt": torch.where(has, 0.0, cnt_d[:, -1]),
                 "flt": torch.where(has, 0.0, flt.to(torch.float64)),
                 "bi": torch.where(is_clip,
                                   torch.remainder(ix0 + pos + last, A),
                                   s["bi"])}
            pos = pos + last + has.to(torch.int64)
        st.update(s)
        return gains[:, :N], clips > 0


@dataclasses.dataclass
class TxReference:
    fs: float                      # audio rate
    fs_tx: float
    L: int
    block: int
    channels: int
    modes: list                    # per channel
    pre: float
    drive: float
    taps: np.ndarray               # complex128 [C, T]
    am_carrier: float
    pm_gain: float
    ctcss_amp: float
    ctcss_w: float
    alc: Alc | None
    h_up: np.ndarray               # float64 [T_up]
    words: np.ndarray              # int64 [C], uint32 values
    device: str = "cpu"
    ramps: int = 0                 # checked channel blocks whose gain moved
    replayed: int = 0              # blocks in the longest replay
    clipped: int = 0               # ... that had a clip
    _carry: np.ndarray = dataclasses.field(default_factory=lambda:
                                           np.zeros(1))

    @classmethod
    def create(cls, cfg: dict, device="cpu") -> "TxReference":
        ch = cfg["chain"]
        extra = set(ch) - SUPPORTED
        if extra:
            raise ValueError(f"the reference has no stage for {sorted(extra)}")
        modes = rx_modes(cfg)
        if set(modes) - set(MODES):
            raise ValueError(f"the reference's modes are {MODES}")
        fs = float(ch.get("audio_rate", 48000.0))
        fs_tx = float(ch.get("tx_rate", fs))
        L = round(fs_tx / fs)
        if abs(fs_tx / fs - L) > 1e-9:
            raise ValueError("tx_rate must be an integer multiple of the "
                             "audio rate")
        T = ch.get("filter_taps", 513)
        lo, hi = ch.get("mic_band", (300.0, 2700.0))
        voice = design.bandpass(T, lo, hi, fs)
        dgt = design.bandpass(T, *DGT_BAND, fs)
        dev_hz = float(ch.get("fm_deviation_hz", 2500.0))
        tone = float(ch.get("ctcss_hz", 0.0))
        share = FM_AUDIO_SHARE if tone > 9.0 else 1.0
        return cls(
            fs=fs, fs_tx=fs_tx, L=L, block=ch.get("audio_block", 2048),
            channels=ch["channels"], modes=modes,
            pre=float(ch.get("preemphasis", 0.0)),
            drive=10.0 ** (float(ch.get("compress_db", 0.0)) / 20.0),
            taps=np.stack([dgt if m == "DGT_U" else voice for m in modes]),
            am_carrier=float(ch.get("am_carrier", 0.5)),
            pm_gain=2.0 * share * dev_hz / hi,
            ctcss_amp=CTCSS_SHARE * dev_hz / tone if tone > 9.0 else 0.0,
            ctcss_w=2.0 * math.pi * tone / fs,
            alc=(Alc(A=int(fs * ALC_MS / 1000.0),
                     d_limit=1.0 / (fs * DOUBLE_S))
                 if ch.get("alc", True) else None),
            h_up=image_reject(L, fs_tx) if L > 1 else np.ones(1),
            words=design.freq_word(rx_tunes(cfg), fs_tx), device=str(device))

    @property
    def block_tx(self) -> int:
        return self.block * self.L

    def carry(self, j: np.ndarray) -> np.ndarray:
        """The CTCSS phase at the start of blocks ``j``."""
        if j.max() >= self._carry.size:
            self._carry = ctcss_carry(self.ctcss_w, self.block,
                                      max(2 * int(j.max()), 64))
        return self._carry[j]

    # ---------------------------------------------------------------- stages
    def _spectrum(self, h: torch.Tensor, nfft: int, lowp: bool):
        return torch.fft.fft(round_tf32(h) if lowp else h, nfft)

    @staticmethod
    def _fir(xe: torch.Tensor, H: torch.Tensor, T: int, n: int,
             lowp: bool) -> torch.Tensor:
        """The last ``n`` outputs of the causal convolution of rows ``xe``
        [R, n + T - 1] with T taps of spectrum ``H`` [R | 1, nfft]: the
        valid part."""
        if lowp:
            xe = round_tf32(xe)
        y = torch.fft.ifft(torch.fft.fft(xe.to(torch.complex128),
                                         H.shape[-1]) * H)
        return y[:, T - 1:T - 1 + n]

    def _modulated(self, st: dict, mic: torch.Tensor, fam: dict,
                   j0: np.ndarray, lowp: bool) -> torch.Tensor:
        """Blocks j0, j0 + 1, ... of mic audio (``j0`` [R], a row's first
        block), [R, n B] float64 -> the modulated samples [R, n B]
        complex128."""
        R, N = mic.shape
        B = self.block
        x1 = torch.cat([st["mic"][:, None], mic[:, :-1]], 1)
        st["mic"] = mic[:, -1]
        c = self.pre
        if lowp:
            mic, x1 = round_tf32(mic), round_tf32(x1)
            c = float(round_tf32(torch.tensor(c, dtype=torch.float64)))
        p = mic - c * x1
        xe = torch.cat([st["hist"], compress(p, self.drive)], 1)
        st["hist"] = xe[:, N:]
        T = self.taps.shape[-1]
        nfft = design.next_pow2(N + T - 1)
        if st.get("nfft") != nfft:
            st["H"] = self._spectrum(st["taps"], nfft, lowp)
            st["nfft"] = nfft
        z = self._fir(xe, st["H"], T, N, lowp)
        out = torch.where(fam["lower"], z.conj(), z)
        zr = z.real
        am = self.am_carrier + (1.0 - self.am_carrier) * zr
        out = torch.where(fam["am"], am.to(torch.complex128), out)
        n = torch.arange(N, device=mic.device)
        start = torch.as_tensor(self.carry(j0[:, None] + np.arange(N // B)),
                                device=mic.device)
        theta = (start[:, n // B]
                 + self.ctcss_w * (n % B + 1).to(torch.float64))
        phi = self.pm_gain * zr + self.ctcss_amp * torch.sin(theta)
        fm = torch.polar(torch.ones_like(phi), phi)
        return torch.where(fam["fm"], fm, out)

    def _interp(self, a: torch.Tensor, lowp: bool) -> torch.Tensor:
        """The TX-rate samples of the last block of ``a`` [R, 2B] (two
        blocks of the ALC's output)."""
        if self.L == 1:
            return a[:, self.block:]
        R, n2 = a.shape
        L, Bt = self.L, self.block_tx
        u = torch.zeros((R, n2 * L), dtype=torch.complex128, device=a.device)
        u[:, ::L] = a
        T = self.h_up.size
        nfft = design.next_pow2(Bt + T - 1)
        H = self._spectrum(torch.as_tensor(self.h_up, device=a.device),
                           nfft, lowp)[None, :]
        # output N of the last block is the filter's output at N - (L - 1)
        end = n2 * L - (L - 1)
        return self._fir(u[:, end - Bt - T + 1:end], H, T, Bt, lowp)

    def _tune(self, rows: np.ndarray, k: int) -> torch.Tensor:
        Bt = self.block_tx
        dev = self.device
        s = k * Bt + torch.arange(Bt, device=dev)
        w = torch.as_tensor(self.words[rows], device=dev)[:, None]
        ang = ((w * s) % (1 << 32)).to(torch.float64) * (2.0 * math.pi
                                                          / 2 ** 32)
        return torch.polar(torch.ones_like(ang), ang)

    # ----------------------------------------------------------- the blocks
    def period(self, ring_blocks: int | None) -> int | None:
        """Blocks after which the ALC's input repeats: the ring's and the
        ALC index's (``B j mod A``) periods; None without either."""
        if not ring_blocks or self.alc is None:
            return None
        A = self.alc.A
        return math.lcm(ring_blocks, A // math.gcd(self.block, A))

    def blocks(self, get_block, ks, rows: np.ndarray, lowp: bool = False,
               ring_blocks: int | None = None) -> dict:
        """{k: I/Q [len(rows), B L] complex128} of each block ``k`` of
        ``ks`` on channels ``rows``, each replayed from rest, as the
        program starts, at the first block or, where the input repeats
        every ``ring_blocks`` blocks, at the latest block at least
        ``REPLAY`` blocks before ``k`` that starts a ``period`` (there the
        ring and the ALC's index stand as at the first block).  Every
        block's replay runs in one pass, ``SPAN`` blocks a step."""
        R, B = len(rows), self.block
        dev = self.device
        ks = sorted(int(k) for k in ks)
        P = self.period(ring_blocks)
        j0 = np.array([max(0, (k - REPLAY) // P * P) if P else 0
                       for k in ks])
        n_blocks = [k - j + 1 for k, j in zip(ks, j0)]
        # one row of the pass a checked channel a block of ks
        jr = np.repeat(j0, R)
        rr = np.tile(rows, len(ks))
        modes = [self.modes[r] for r in rr]

        def mask(*names):
            return torch.as_tensor([m in names for m in modes],
                                   device=dev)[:, None]
        fam = {"lower": mask("LSB"), "am": mask("AM"), "fm": mask("FM")}
        T = self.taps.shape[-1]
        A = self.alc.A if self.alc else 0
        st = {"taps": torch.as_tensor(self.taps[rr], device=dev),
              "mic": torch.zeros(len(rr), dtype=torch.float64, device=dev),
              "hist": torch.zeros((len(rr), T - 1), dtype=torch.float64,
                                  device=dev)}
        alc = self.alc.rest(len(rr), dev) if self.alc else None
        line = torch.zeros((len(rr), A), dtype=torch.complex128, device=dev)
        sel = torch.as_tensor(rows, device=dev)
        kept = {}
        for i0 in range(0, max(n_blocks), SPAN):
            n = min(SPAN, max(n_blocks) - i0)
            mic = torch.cat([torch.cat([get_block(int(j) + i).index_select(
                0, sel.to(get_block(int(j) + i).device)).to(dev)
                for j in j0]) for i in range(i0, i0 + n)],
                1).to(torch.float64)
            iq = self._modulated(st, mic, fam, jr + i0, lowp)
            del mic
            if alc is not None:
                ext = torch.cat([line, iq], 1)
                line = ext[:, n * B:]
                # every row's first block starts a period: one ALC index
                gains, clips = self.alc.run(alc, iq.abs(),
                                            (int(j0[0]) + i0) * B % A, B)
                iq = ext[:, :n * B] * gains
                del ext
            for q, k in enumerate(ks):
                part = slice(q * R, (q + 1) * R)
                for i in range(i0, i0 + n):
                    if i in (n_blocks[q] - 2, n_blocks[q] - 1):
                        kept[(k, i - n_blocks[q] + 1)] = (
                            iq[part, (i - i0) * B:(i - i0 + 1) * B].clone())
                    if i == n_blocks[q] - 1 and alc is not None:
                        g = gains[part, (i - i0) * B:(i - i0 + 1) * B]
                        self.ramps += int(((g.amax(1) - g.amin(1)) > 1e-9)
                                          .sum())
                        self.clipped += int(clips[part, i - i0].sum())
            del iq
        self.replayed = max(n_blocks)
        out = {}
        zero = torch.zeros((R, B), dtype=torch.complex128, device=dev)
        for k in ks:
            a = torch.cat([kept.get((k, -1), zero), kept[(k, 0)]], 1)
            out[k] = (self._interp(a, lowp) * self._tune(rows, k)
                      ).cpu().numpy()
        return out
