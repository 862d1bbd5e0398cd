"""Transmit chain: mic audio -> processed -> modulated IQ at the TX rate.

The reference's ``quisk_process_microphone`` (microphone.c:1092) and
``tx_filter`` (microphone.c:372), batched over ``[channels, block]``: the
IMD two-tone substitution, the optional phase rotator, pre-emphasis
(microphone.c:452-465), the soft compressor (484-518), the 513-tap
analytic bandpass (the Hilbert split, 469; DGT modes a wide flat filter),
the per-mode modulators (1226-1278: SSB is the analytic signal, LSB its
conjugate, AM 0.5 + audio/2, FM phase modulation of the bandpassed audio
with the CTCSS phase at 15% of the deviation, CW the keyed envelope), ALC
on the modulated IQ (270), CESSB on the SSB rows, the predistortion slot,
interpolation to the TX rate (1307-1336), Spot, the TX tune NCO and the TX
I/Q balance trim.

The ``[C]`` modes are data: each row takes its own modulator by masks, so
one step serves a mix of modes.  The CTCSS and IMD oscillator phases are
carried and wrapped mod 2 pi each block.  The ``set_*`` methods return a
new chain and leave the old chain's tensors as they were.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.ops.agc import TxALC
from quisk_tpu_torch.ops.compress import OvershootControl, SoftCompressor
from quisk_tpu_torch.ops.fir import OverlapSaveFIR
from quisk_tpu_torch.ops.iir import PhaseRotator, Preemphasis
from quisk_tpu_torch.ops.nco import NCO, freq_word, phase_tensor
from quisk_tpu_torch.ops.resample import Interpolator
from quisk_tpu_torch.rx.frontend import balance_matrix
from quisk_tpu_torch.tx.puresignal import Predistorter

TWO_PI = 2.0 * np.pi
DGT_MODES = frozenset(int(m) for m in (Mode.DGT_U, Mode.DGT_L, Mode.DGT_IQ,
                                       Mode.DGT_FDV, Mode.FDV_U, Mode.FDV_L))
LOWER_MODES = (Mode.LSB, Mode.CWL, Mode.DGT_L, Mode.FDV_L)


@dataclasses.dataclass(frozen=True)
class TxChainConfig:
    """Static configuration of a transmit chain (the fields of
    ``quisk_tpu.tx.TxChainConfig``)."""

    channels: int
    audio_rate: float = 48000.0
    tx_rate: float = 48000.0            # audio_rate times an integer
    audio_block: int = 2048
    mic_band: tuple[float, float] = (300.0, 2700.0)
    filter_taps: int = 513
    preemphasis: float = 0.0            # 0..1, first-difference coefficient
    compress_db: float = 0.0            # 0 = off
    alc: bool = True
    fm_deviation_hz: float = 2500.0
    ctcss_hz: float = 0.0
    am_carrier: float = 0.5             # carrier fraction
    cessb: bool = False                 # CESSB overshoot control
    predistort: bool = False            # PureSignal correction slot
    phase_rotator: bool = False         # WDSP phrot on the mic audio


def _pm_scaling(tone_hz: float, deviation_hz: float, band_hi: float):
    """(pm_gain, ctcss_amp): FM is phase modulation of the bandpassed audio,
    beta rad per full-scale unit reaching the deviation at the band edge;
    with CTCSS the audio gets 85% and the tone's phase amplitude is 15% of
    the deviation (microphone.c:1242-1262).  The factor 2 makes up the
    analytic filter's 0.5 real-part gain."""
    beta = deviation_hz / band_hi
    if tone_hz > 9.0:
        return 2.0 * 0.85 * beta, 0.15 * deviation_hz / tone_hz
    return 2.0 * beta, 0.0


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=device)


@dataclasses.dataclass(frozen=True)
class TxChain:
    analytic: OverlapSaveFIR            # 300-2700 analytic bandpass
    phrot: PhaseRotator | None
    preemph: Preemphasis
    comp: SoftCompressor
    alc: TxALC | None
    cessb: OvershootControl | None
    predist: Predistorter | None
    interp: Interpolator | None
    mode: torch.Tensor                  # [C] int64
    trim: tuple                         # (m00, m10, m11) each [C, 1] f32
    spot: torch.Tensor                  # [C, 1] f32, < 0 = off
    tune: NCO                           # at the TX rate, word 0 = off
    pm_gain: torch.Tensor               # rad per unit bandpassed audio
    ctcss_word: torch.Tensor            # rad/sample CTCSS increment
    ctcss_amp: torch.Tensor             # rad CTCSS phase amplitude
    am_carrier: torch.Tensor
    channels: int
    block: int
    block_tx: int
    audio_rate: float = 48000.0

    @classmethod
    def create(cls, config: TxChainConfig, mode: Sequence[int] | int = Mode.USB,
               device=None) -> "TxChain":
        device = resolve_device(device)
        C = config.channels
        B = config.audio_block
        lo, hi = config.mic_band
        m_arr = np.broadcast_to(np.asarray(mode, np.int64), (C,))
        # voice rows the mic bandpass, digital rows a wide flat filter
        # (microphone.c:605 tx_filter_digital)
        voice_taps = design.bandpass_analytic(config.filter_taps, lo, hi,
                                              config.audio_rate)
        if any(int(mm) in DGT_MODES for mm in m_arr):
            dgt_taps = design.bandpass_analytic(
                config.filter_taps, 50.0, 3050.0, config.audio_rate)
            taps = np.stack([dgt_taps if int(mm) in DGT_MODES else voice_taps
                             for mm in m_arr])
        else:
            taps = voice_taps
        ratio = config.tx_rate / config.audio_rate
        L = int(round(ratio))
        if abs(ratio - L) > 1e-9:
            raise ValueError("tx_rate must be an integer multiple of "
                             "audio_rate")
        pm_gain, ct_amp = _pm_scaling(config.ctcss_hz, config.fm_deviation_hz,
                                      hi)
        ones = torch.ones((C, 1), dtype=torch.float32, device=device)
        return cls(
            analytic=OverlapSaveFIR.create(taps, B, device=device),
            phrot=(PhaseRotator.create(fs=config.audio_rate, device=device)
                   if config.phase_rotator else None),
            # always built: coefficient 0 / drive 0 dB pass through exactly,
            # so per-mode settings are data (set_audio_settings)
            preemph=Preemphasis.create(config.preemphasis, device=device),
            comp=SoftCompressor.create(config.compress_db, device=device),
            alc=(TxALC.create(config.audio_rate, mode=m_arr, channels=C,
                              device=device) if config.alc else None),
            cessb=(OvershootControl.create(B, config.audio_rate,
                                           band=config.mic_band,
                                           device=device)
                   if config.cessb else None),
            predist=(Predistorter.identity(device=device)
                     if config.predistort else None),
            interp=(Interpolator.create(L, B, fs_out=config.tx_rate,
                                        device=device) if L > 1 else None),
            mode=torch.as_tensor(m_arr.copy(), device=device),
            trim=(ones, torch.zeros_like(ones), ones),
            spot=torch.full((C, 1), -1.0, dtype=torch.float32, device=device),
            tune=NCO.create(np.zeros(C), config.tx_rate, B * L, C,
                            device=device),
            pm_gain=_f32(pm_gain, device),
            ctcss_word=_f32(TWO_PI * config.ctcss_hz / config.audio_rate,
                            device),
            ctcss_amp=_f32(ct_amp, device),
            am_carrier=_f32(config.am_carrier, device),
            channels=C, block=B, block_tx=B * L,
            audio_rate=config.audio_rate)

    @property
    def device(self) -> torch.device:
        return self.mode.device

    def set_audio_settings(self, clip_db=None, preemph=None) -> "TxChain":
        """New chain with per-channel TX audio clip (dB of compressor
        drive, 0 = off) and / or pre-emphasis coefficient (0 = off), the
        per-mode txAudioClip* / txAudioPreemph* of quisk.py:5681-5695."""
        new = self
        if clip_db is not None:
            arr = np.broadcast_to(np.asarray(clip_db, np.float32),
                                  (self.channels,))
            new = dataclasses.replace(new, comp=SoftCompressor.create(
                arr, device=self.device))
        if preemph is not None:
            arr = np.broadcast_to(np.asarray(preemph, np.float32),
                                  (self.channels,))
            new = dataclasses.replace(new, preemph=Preemphasis.create(
                arr, device=self.device))
        return new

    def init_state(self):
        C, dev = self.channels, self.device
        return {
            "imd_phase": torch.zeros((C, 2), dtype=torch.float32, device=dev),
            "analytic": self.analytic.init_state(C),
            "phrot": self.phrot.init_state(C) if self.phrot else (),
            "preemph": self.preemph.init_state(C),
            "alc": self.alc.init_state(C) if self.alc else (),
            "ctcss_phase": torch.zeros((C,), dtype=torch.float32, device=dev),
            "tune_phase": self.tune.init_state(C),
            "interp": self.interp.init_state(C) if self.interp else (),
            "cessb": self.cessb.init_state(C) if self.cessb else (),
        }

    def _is(self, *modes) -> torch.Tensor:
        """[C, 1] mask of the rows in any of ``modes``."""
        m = self.mode[:, None]
        out = m == int(modes[0])
        for mm in modes[1:]:
            out = out | (m == int(mm))
        return out

    def _ramp(self) -> torch.Tensor:
        return torch.arange(self.block, dtype=torch.float32,
                            device=self.device)[None, :] + 1.0

    def condition(self, st: dict, audio: torch.Tensor) -> torch.Tensor:
        """The mic audio as the modulators' filter sees it: the IMD rows'
        700 + 1900 Hz two-tone (microphone.c:140-159), then the phase
        rotator, pre-emphasis and the compressor.  Updates ``st``."""
        n = self._ramp()
        ph1 = st["imd_phase"][:, 0:1] + (TWO_PI * 700.0 / self.audio_rate) * n
        ph2 = st["imd_phase"][:, 1:2] + (TWO_PI * 1900.0 / self.audio_rate) * n
        two_tone = 0.5 * (torch.sin(ph1) + torch.sin(ph2))
        st["imd_phase"] = torch.stack(
            [torch.remainder(ph1[:, -1], TWO_PI),
             torch.remainder(ph2[:, -1], TWO_PI)], dim=-1)
        a = torch.where(self._is(Mode.IMD), two_tone, audio)
        # the phase rotator comes first, as in the WDSP TX graph (TXA.c:562)
        if self.phrot is not None:
            st["phrot"], a = self.phrot(st["phrot"], a)
        st["preemph"], a = self.preemph(st["preemph"], a)
        _, a = self.comp((), a)
        return a

    def modulators(self, st: dict, audio: torch.Tensor,
                   z: torch.Tensor) -> torch.Tensor:
        """Per-row modulation of the analytic audio ``z``: SSB / DGT (LSB
        rows conjugated), AM envelope, FM phase with CTCSS, CW the keyed
        ``audio`` itself.  Updates the CTCSS phase in ``st``."""
        zr = z.real
        iq_ssb = torch.where(self._is(*LOWER_MODES), z.conj(), z)
        iq_am = (self.am_carrier + (1.0 - self.am_carrier) * zr).to(
            torch.complex64)
        ct = st["ctcss_phase"][:, None] + self.ctcss_word * self._ramp()
        total = self.pm_gain * zr + self.ctcss_amp * torch.sin(ct)
        iq_fm = torch.complex(torch.cos(total), torch.sin(total))
        st["ctcss_phase"] = torch.remainder(ct[:, -1], TWO_PI)
        iq_cw = audio.to(torch.complex64)
        return torch.where(self._is(Mode.AM), iq_am, torch.where(
            self._is(Mode.FM), iq_fm, torch.where(
                self._is(Mode.CWU, Mode.CWL), iq_cw, iq_ssb)))

    def pre_alc(self, state, audio: torch.Tensor):
        """(state, modulated IQ [C, block]): the step up to the ALC."""
        st = dict(state)
        a = self.condition(st, audio)
        st["analytic"], z = self.analytic(st["analytic"],
                                          a.to(torch.complex64))
        return st, self.modulators(st, audio, z)

    def post_alc(self, st: dict, iq: torch.Tensor) -> torch.Tensor:
        """CESSB on the SSB-like rows, the predistortion slot, then the
        interpolator to the TX rate.  Updates ``st``."""
        if self.cessb is not None:
            st["cessb"], iq_c = self.cessb(st["cessb"], iq)
            iq = torch.where(self._is(Mode.AM, Mode.FM), iq, iq_c)
        if self.predist is not None:
            _, iq = self.predist((), iq)
        if self.interp is not None:
            st["interp"], iq = self.interp(st["interp"], iq)
        return iq

    def place(self, st: dict, iq: torch.Tensor) -> torch.Tensor:
        """Spot (microphone.c:1218: a plain carrier at the spot level), the
        TX tune NCO (sound.c:708: the IQ rotated up to the TX offset, so
        an RX tuned to +f recovers it) and the TX I/Q balance trim
        (sound.c:735).  Updates the tune phase in ``st``."""
        iq = torch.where(self.spot >= 0.0, self.spot.to(torch.complex64), iq)
        st["tune_phase"], ztune = self.tune.phasor(st["tune_phase"])
        iq = iq * ztune
        m00, m10, m11 = self.trim
        re, im = iq.real, iq.imag
        return torch.complex(m00 * re, m10 * re + m11 * im)

    def step(self, state, audio: torch.Tensor):
        """audio [C, block] float32 -> (state, iq [C, block_tx] complex64)."""
        st, iq = self.pre_alc(state, audio)
        if self.alc is not None:
            st["alc"], iq = self.alc(st["alc"], iq)
        iq = self.post_alc(st, iq)
        return st, self.place(st, iq)

    def set_ctcss(self, tone_hz: float, deviation_hz: float,
                  band_hi: float) -> "TxChain":
        """Retune, enable or disable the CTCSS tone (QS.set_ctcss,
        quisk.py:6684)."""
        pm_gain, ct_amp = _pm_scaling(tone_hz, deviation_hz, band_hi)
        dev = self.device
        return dataclasses.replace(
            self, pm_gain=_f32(pm_gain, dev),
            ctcss_word=_f32(TWO_PI * tone_hz / self.audio_rate, dev),
            ctcss_amp=_f32(ct_amp, dev))

    def set_tune(self, offset_hz, channel=None) -> "TxChain":
        """New chain transmitting ``offset_hz`` from the hardware TX center
        (sound.c:708, QS.set_tune); one row with ``channel``."""
        rate = self.audio_rate * (self.block_tx / self.block)
        if channel is None:
            word = phase_tensor(freq_word(
                np.full(self.channels, float(offset_hz)), rate), self.device)
        else:
            word = self.tune.word.clone()
            word[channel] = int(freq_word(float(offset_hz), rate)[0])
        return dataclasses.replace(
            self, tune=dataclasses.replace(self.tune, word=word))

    def set_spot(self, level: float, channel=None) -> "TxChain":
        """Spot (microphone.c:1218): ``level`` 0..1 transmits a plain
        carrier at that amplitude; negative turns it off."""
        if channel is None:
            spot = torch.full_like(self.spot, float(level))
        else:
            spot = self.spot.clone()
            spot[channel, 0] = float(level)
        return dataclasses.replace(self, spot=spot)

    def set_ampl_phase(self, ampl: float, phase_deg: float,
                       channel=None) -> "TxChain":
        """New chain with the TX I/Q balance trim (the is_tx=1 arm of
        quisk_set_ampl_phase, sound.c:1565-1581)."""
        vals = [np.float32(v)
                for v in balance_matrix(ampl, phase_deg, invert=False)]
        if channel is None:
            trim = tuple(torch.full_like(t, float(v))
                         for t, v in zip(self.trim, vals))
        else:
            trim = tuple(t.clone() for t in self.trim)
            for t, v in zip(trim, vals):
                t[channel, 0] = float(v)
        return dataclasses.replace(self, trim=trim)
