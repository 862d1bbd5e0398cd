"""The composed receive chain: tune -> decimate -> filter -> demod -> AGC.

The per-block RX pipeline of the reference (``quisk_process_samples``,
quisk.c:2289): complex tune by NCO, decimation, channel filter and
demodulation, fractional decimation to the audio rate, AGC — batched over
a ``[channels, block]`` tensor, so one step demodulates many independent
receivers.  Shapes and rates are static (chosen by the planner); tunables
(NCO words, filter masks, mode ids) are tensors.

With ``fused_frontend`` the whole leading run of decimators folds into one
filter by the cascade identity and runs, with the mix, in the CUDA front
kernel (ops/fused_front.py).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.modes import CW_PITCH, DEFAULT_BANDWIDTH, Mode
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.ops.agc import AGC
from quisk_tpu_torch.ops.demod import MixedDemod
from quisk_tpu_torch.ops.fir import OverlapSaveFIR, make_fir
from quisk_tpu_torch.ops.fused_front import FusedTuneDecimate
from quisk_tpu_torch.ops.nco import NCO, freq_word
from quisk_tpu_torch.ops.resample import FracDecim
from quisk_tpu_torch.rx.planner import plan_block_sizes, plan_decimation

# optional stages of quisk_tpu.rx.RxChainConfig and the port slice that
# brings each; until then asking for one raises
_LATER = {
    "noise_blanker": "slice 2 (featured RX)",
    "auto_notch": "slice 2 (featured RX)",
    "nr": "slice 2 (featured RX)",
    "anf": "slice 2 (featured RX)",
    "squelch": "slice 2 (featured RX)",
    "fm_squelch": "slice 2 (featured RX)",
    "front_cond": "slice 3 (raw-IQ conditioning)",
    "dc_remove_bw": "slice 3 (raw-IQ conditioning)",
}


def mode_band(mode: Mode, bandwidth: float | None = None,
              cw_pitch: float = CW_PITCH) -> tuple[float, float]:
    """Audio passband edges (Hz, may be negative) for a mode (quisk.py:5405
    MakeFilterCoef: SSB from ~300 Hz off the carrier, CW centred on the
    pitch, AM/FM/IQ symmetric about the carrier)."""
    bw = float(bandwidth if bandwidth is not None else DEFAULT_BANDWIDTH[mode])
    if mode in (Mode.CWU, Mode.CWL):
        lo, hi = cw_pitch - bw / 2.0, cw_pitch + bw / 2.0
        return (-hi, -lo) if mode == Mode.CWL else (lo, hi)
    if mode.is_ssb_like:
        lo, hi = 300.0, 300.0 + bw
        return (-hi, -lo) if mode.is_lower else (lo, hi)
    return (-bw / 2.0, bw / 2.0)


def _cw_rit(modes: np.ndarray, cw_pitch: float) -> np.ndarray:
    """Per-channel RIT offset: CW filters centre on +-cw_pitch, so the NCO
    lands a carrier at the dial on the pitch (quisk.py:6175-6177)."""
    return np.where(modes == int(Mode.CWU), -cw_pitch,
                    np.where(modes == int(Mode.CWL), cw_pitch, 0.0))


def _bands(modes, bandwidth_hz, cw_pitch):
    C = len(modes)
    bws = (np.broadcast_to(np.asarray(bandwidth_hz, np.float64), (C,))
           if bandwidth_hz is not None else [None] * C)
    return [mode_band(Mode(int(m)), bw, cw_pitch) for m, bw in zip(modes, bws)]


@dataclasses.dataclass(frozen=True)
class RxChainConfig:
    """Static configuration of a receive chain (the fields of
    ``quisk_tpu.rx.RxChainConfig``; the optional stages raise until their
    slice is ported)."""

    sample_rate: float
    channels: int
    audio_rate: float = 48000.0
    audio_block: int = 2048
    filter_taps: int = 1025
    agc: bool = True
    agc_profile: str = "delay"
    fm_deviation_hz: float = 5000.0
    cw_pitch: float = CW_PITCH
    decim_atten_db: float = 100.0
    noise_blanker: int = 0
    auto_notch: bool = False
    nr: bool = False
    anf: bool = False
    squelch: bool = False
    squelch_threshold: float = 1.2
    fm_squelch: bool = False
    fm_squelch_db: float = -60.0
    ext_demod: str | None = None
    fused_frontend: bool = False
    front_cond: bool = False
    dc_remove_bw: int = 0

    def check_ported(self) -> None:
        for name, where in _LATER.items():
            if getattr(self, name):
                raise NotImplementedError(
                    f"RxChainConfig.{name} is not ported yet: {where}")
        if self.agc_profile != "delay":
            raise NotImplementedError(
                f"agc_profile={self.agc_profile!r} is not ported yet: "
                f"slice 2 (featured RX)")


def fuse_cascade(stage_specs):
    """Fold a run of decimators into one filter by the cascade identity
    decim_d2(h2 * decim_d1(h1 * x)) = decim_d1d2((h1 * up_d1(h2)) * x).
    ``stage_specs`` is [(taps float64, decim), ...]; returns (taps, decim)."""
    comb, d_tot = None, 1
    for taps, d in stage_specs:
        if comb is None:
            comb = taps
        else:
            up = np.zeros((len(taps) - 1) * d_tot + 1)
            up[::d_tot] = taps
            comb = np.convolve(comb, up)
        d_tot *= d
    return comb, d_tot


@dataclasses.dataclass(frozen=True)
class RxChain:
    """The receive chain. Build with :meth:`create`; tunables are tensors."""

    nco: NCO | None                       # unfused mixer
    front: FusedTuneDecimate | None       # fused mixer + decimators
    stages: tuple                         # unfused decimator stages
    bp: OverlapSaveFIR                    # per-channel analytic bandpass
    frac: FracDecim | None
    demod: MixedDemod
    agc: AGC | None
    # per-stage runtime enables: [C, 1] f32 blend weights, 1 = stage
    # output, 0 = exact pass-through (keys only for stages that exist)
    ons: dict
    tune_base: torch.Tensor               # [C] dial frequency (pre-RIT)
    channels: int
    block_in: int
    block_audio: int
    fs_audio: float

    @property
    def device(self) -> torch.device:
        return self.tune_base.device

    # ---------------------------------------------------------------- build
    @classmethod
    def create(cls, config: RxChainConfig,
               tune_hz: Sequence[float] | float = 0.0,
               mode: Sequence[int] | int = Mode.USB,
               bandwidth_hz: Sequence[float] | None = None,
               device=None) -> "RxChain":
        config.check_ported()
        device = resolve_device(device)
        C = config.channels
        plan = plan_decimation(config.sample_rate, config.audio_rate)
        blocks = plan_block_sizes(plan, config.audio_block)
        B_in, B_mid, B_audio = blocks["input"], blocks["mid"], blocks["audio"]

        modes = np.broadcast_to(np.asarray(mode, np.int32), (C,))
        base = np.broadcast_to(np.atleast_1d(
            np.asarray(tune_hz, np.float64)), (C,))
        tune_eff = base + _cw_rit(modes, config.cw_pitch)

        stage_specs = []
        for d, fs_stage in zip(plan.stages, plan.stage_rates()):
            if d == 2:
                taps = design.halfband(45)
            else:
                taps = design.decimator(d, fs_stage,
                                        atten_db=config.decim_atten_db)
            stage_specs.append((np.asarray(taps, np.float64), d))

        nco = front = None
        stages = []
        if config.fused_frontend and stage_specs:
            comb, d_tot = fuse_cascade(stage_specs)
            front = FusedTuneDecimate.create(comb, tune_eff,
                                             config.sample_rate, B_in, d_tot,
                                             C, device=device)
        else:
            nco = NCO.create(tune_eff, config.sample_rate, B_in, C,
                             device=device)
            b = B_in
            for taps, d in stage_specs:
                stages.append(make_fir(taps, b, decim=d, device=device))
                b //= d

        cache: dict[tuple, np.ndarray] = {}
        bands = _bands(modes, bandwidth_hz, config.cw_pitch)
        for lo, hi in set(bands):
            cache[(lo, hi)] = design.bandpass_analytic(
                config.filter_taps, lo, hi, plan.fs_mid)
        bp = OverlapSaveFIR.create(np.stack([cache[b] for b in bands]), B_mid,
                                   device=device)
        frac = (FracDecim.create(plan.frac, B_mid, device=device)
                if plan.frac else None)
        demod = MixedDemod.create(modes, plan.fs_out, C,
                                  config.fm_deviation_hz,
                                  ext_demod=config.ext_demod, device=device)
        agc = AGC.create(plan.fs_out, device=device) if config.agc else None
        ons = ({"agc": torch.ones((C, 1), dtype=torch.float32, device=device)}
               if agc is not None else {})
        return cls(nco=nco, front=front, stages=tuple(stages), bp=bp,
                   frac=frac, demod=demod, agc=agc, ons=ons,
                   tune_base=torch.as_tensor(base.astype(np.float32),
                                             device=device),
                   channels=C, block_in=B_in, block_audio=B_audio,
                   fs_audio=plan.fs_out)

    # --------------------------------------------------------------- retune
    def retune(self, config: RxChainConfig,
               tune_hz: Sequence[float] | float | None = None,
               mode: Sequence[int] | int | None = None,
               bandwidth_hz: Sequence[float] | None = None,
               notches_hz=None) -> "RxChain":
        """New chain with updated tunables (NCO words, filter masks, mode
        vector); shapes are unchanged, so the carried state stays valid
        (use ``bp.retune_crossfade`` for a crossfade over a few blocks)."""
        C = self.channels
        new = self
        modes = np.broadcast_to(np.asarray(
            mode if mode is not None else self.demod.mode.cpu().numpy(),
            np.int32), (C,))
        if tune_hz is not None or mode is not None:
            base = (np.broadcast_to(np.atleast_1d(
                        np.asarray(tune_hz, np.float64)), (C,))
                    if tune_hz is not None
                    else self.tune_base.cpu().numpy().astype(np.float64))
            tune_eff = base + _cw_rit(modes, config.cw_pitch)
            new = dataclasses.replace(new, tune_base=torch.as_tensor(
                base.astype(np.float32), device=self.device))
            if new.front is not None:
                new = dataclasses.replace(new, front=new.front.with_word(
                    freq_word(tune_eff, config.sample_rate)))
            else:
                new = dataclasses.replace(new, nco=NCO.create(
                    tune_eff, config.sample_rate, self.block_in, C,
                    device=self.device))
        if mode is not None or bandwidth_hz is not None or notches_hz is not None:
            bands = _bands(modes, bandwidth_hz, config.cw_pitch)
            # per-channel manual notches (wdsp/nbp.c): (f_center, width)
            # pairs carved out of the channel filter at design time
            if notches_hz is None:
                nlists = [()] * C
            elif notches_hz and isinstance(notches_hz[0], (int, float)):
                raise ValueError("notches_hz: per-channel sequences of "
                                 "(center_hz, width_hz) pairs")
            elif len(notches_hz) and (
                    not len(notches_hz[0])
                    or isinstance(notches_hz[0][0], (tuple, list))):
                nlists = [tuple(map(tuple, nl)) for nl in notches_hz]
                if len(nlists) == 1:
                    nlists = nlists * C
            else:                        # one flat list of pairs: broadcast
                nlists = [tuple(map(tuple, notches_hz))] * C
            plan = plan_decimation(config.sample_rate, config.audio_rate)
            cache: dict[tuple, np.ndarray] = {}
            for band, nl in set(zip(bands, nlists)):
                lo, hi = band
                cache[(band, nl)] = design.bandpass_with_notches(
                    config.filter_taps, lo, hi, plan.fs_mid, nl)
            taps = np.stack([cache[(b, nl)] for b, nl in zip(bands, nlists)])
            new = dataclasses.replace(new, bp=new.bp.retuned(taps))
            if mode is not None:
                new = dataclasses.replace(new, demod=dataclasses.replace(
                    new.demod, mode=torch.as_tensor(modes.copy(),
                                                    device=self.device)))
        return new

    # ------------------------------------------------- runtime stage toggles
    def set_stage(self, name: str, on, channel: int | None = None
                  ) -> "RxChain":
        """Turn an optional stage on/off at runtime (data only): off is an
        exact pass-through.  Per channel with ``channel``, else all."""
        if name not in self.ons:
            raise KeyError(f"stage {name!r} not built into this chain "
                           f"(have {sorted(self.ons)})")
        if channel is None:
            arr = torch.full((self.channels, 1), 1.0 if on else 0.0,
                             dtype=torch.float32, device=self.device)
        else:
            arr = self.ons[name].clone()
            arr[channel, 0] = 1.0 if on else 0.0
        return dataclasses.replace(self, ons={**self.ons, name: arr})

    def stage_on(self, name: str) -> bool:
        """True if the stage exists and channel 0 has it enabled."""
        return name in self.ons and bool(self.ons[name][0, 0] != 0)

    # ---------------------------------------------------------------- state
    def init_state(self):
        C = self.channels
        return {
            "nco": self.nco.init_state(C) if self.nco is not None else (),
            "front": (self.front.init_state(C)
                      if self.front is not None else ()),
            "stages": tuple(s.init_state(C) for s in self.stages),
            "bp": self.bp.init_state(C),
            "frac": self.frac.init_state(C) if self.frac else (),
            "demod": self.demod.init_state(C),
            "agc": self.agc.init_state(C) if self.agc is not None else (),
        }

    # ----------------------------------------------------------------- step
    def step(self, state, x: torch.Tensor):
        """One block: x [C, block_in] complex64 -> audio [C, block_audio]
        (complex64 when a channel is DGT_IQ)."""
        st = dict(state)
        if self.front is not None:
            st["front"], y = self.front(st["front"], x)
        else:
            st["nco"], y = self.nco(st["nco"], x)
        new_stage_states = []
        for op, s in zip(self.stages, st["stages"]):
            s, y = op(s, y)
            new_stage_states.append(s)
        st["stages"] = tuple(new_stage_states)
        st["bp"], y = self.bp(st["bp"], y)
        if self.frac is not None:
            st["frac"], y = self.frac(st["frac"], y)
        y_filtered = y
        st["demod"], audio = self.demod(st["demod"], y)
        if self.agc is not None:
            st["agc"], a2 = self.agc(st["agc"], audio)
            g = self.ons["agc"]
            audio = a2 * g + audio * (1.0 - g)
        if self.demod.iq_out:
            # DGT-IQ pass-through (quisk.c:2141-2153): those channels emit
            # the channel-filtered IQ; real audio rides Re of the others
            is_iq = (self.demod.mode == int(Mode.DGT_IQ))[:, None]
            audio = torch.where(is_iq, y_filtered, audio.to(torch.complex64))
        return st, audio

    def step_blocks(self, state, iq: torch.Tensor, nblocks: int):
        """``nblocks`` consecutive blocks: iq [C, nblocks*block_in] ->
        audio [C, nblocks*block_audio]; identical to successive steps."""
        outs = []
        for i in range(nblocks):
            state, a = self.step(
                state, iq[:, i * self.block_in:(i + 1) * self.block_in])
            outs.append(a)
        return state, torch.cat(outs, dim=-1)

    def process(self, state, iq: torch.Tensor):
        """Many blocks: iq [C, N] -> audio [C, N_audio] (whole blocks)."""
        return self.step_blocks(state, iq, iq.shape[-1] // self.block_in)
