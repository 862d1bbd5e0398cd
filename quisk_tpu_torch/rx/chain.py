"""The composed receive chain: condition -> blank -> tune -> decimate ->
filter -> demod -> notch / ANF / NR -> AGC -> squelch.

The per-block RX pipeline of the reference (``quisk_process_samples``,
quisk.c:2289): complex tune by NCO, decimation, channel filter and
demodulation, fractional decimation to the audio rate, AGC — batched over
a ``[channels, block]`` tensor, so one step demodulates many independent
receivers.  Shapes and rates are static (chosen by the planner); tunables
(NCO words, filter masks, mode ids) are tensors.

Stage order follows the reference RX path (quisk.c:2289): raw-IQ
conditioning (rx/frontend.py: rail delay, I/Q balance, DC removal,
inversion; built with ``front_cond`` or ``dc_remove_bw``), blanker on raw
IQ, tune, decimate, channel filter, demodulate, then the audio processors
(auto-notch, LMS notch and spectral NR before the AGC, squelch muting
last).  Every optional stage has a ``[C, 1]`` blend weight in ``ons``:
1 is the stage's output, 0 an exact pass-through.

With ``fused_frontend`` the whole leading run of decimators folds into one
filter by the cascade identity and runs, with the mix, in the CUDA front
kernel (ops/fused_front.py).  The JAX chain fuses only when the channel
count is a multiple of 128 and its VMEM model allows; this chain fuses
whenever ``fused_frontend`` is set.  When the noise blanker runs on the
16:1 coarse grid (pool 16: wideband rates such as 960 kS/s) its detection
and gain run inside the front kernel too (the NB-detect mode): the blanker
then adds no pass over the full-rate input.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.modes import CW_PITCH, DEFAULT_BANDWIDTH, Mode
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.ops.agc import AGC, WcpAGC
from quisk_tpu_torch.ops.demod import MixedDemod
from quisk_tpu_torch.ops.fir import OverlapSaveFIR, make_fir
from quisk_tpu_torch.ops.fused_front import FusedTuneDecimate
from quisk_tpu_torch.ops.nco import NCO, freq_word
from quisk_tpu_torch.ops.noise import AutoNotch, NoiseBlanker
from quisk_tpu_torch.ops.nr import BlockLMS, SpectralNR
from quisk_tpu_torch.ops.resample import FracDecim
from quisk_tpu_torch.ops.squelch import FMSquelch, SSBSquelch
from quisk_tpu_torch.rx.frontend import FrontConditioner
from quisk_tpu_torch.rx.planner import plan_block_sizes, plan_decimation
from quisk_tpu_torch.utils.profiling import span


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
    ``quisk_tpu.rx.RxChainConfig`` but the TPU-only ``mxu_stft``).

    ``agc_profile``: "delay" is the block-parallel lookahead AGC
    (quisk.c:2162), "wcp" the conformance-exact WDSP 5-state AGC.
    ``noise_blanker``: 0 off, 1/2/3 the level.  ``front_cond`` builds the
    raw-IQ conditioner (trim set at runtime with ``cond.with_balance``);
    ``dc_remove_bw``: 0 off, 1 the window average, > 1 the one-pole DC
    blocker of that bandwidth in Hz.  ``ext_demod`` names the demodulator
    of the ``Mode.EXT`` channels: ``"pll_fm"`` is WDSP's FM receiver
    (wdsp/fmd.c: the PLL discriminator at ``fm_deviation_hz``, de-emphasis
    and, where ``ctcss_hz`` is above 0, the CTCSS notch at that tone),
    built from these fields; any other name is a factory registered with
    ``ops.demod.register_ext_demod``."""

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
    ctcss_hz: float = 0.0
    fused_frontend: bool = False
    front_cond: bool = False
    dc_remove_bw: int = 0

    def check(self) -> None:
        if self.agc_profile not in ("delay", "wcp"):
            raise ValueError(f"agc_profile={self.agc_profile!r}: want "
                             f"'delay' or 'wcp'")
        if self.ctcss_hz and self.ext_demod != "pll_fm":
            raise ValueError(f"ctcss_hz={self.ctcss_hz!r}: the CTCSS notch "
                             f"is the pll_fm demodulator's")


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
    agc: AGC | WcpAGC | None
    nb: NoiseBlanker | None               # on raw IQ, pre-tune
    notch: AutoNotch | None               # on audio
    nr: SpectralNR | None                 # on audio
    anf: BlockLMS | None                  # on audio
    squelch: SSBSquelch | None            # last: mutes audio
    fm_sq: FMSquelch | None               # RF-measured squelch
    # per-stage runtime enables: [C, 1] f32 blend weights, 1 = stage
    # output, 0 = exact pass-through (keys only for stages that exist)
    ons: dict
    tune_base: torch.Tensor               # [C] dial frequency (pre-RIT)
    channels: int
    block_in: int
    block_audio: int
    fs_audio: float
    cond: FrontConditioner | None = None  # raw-IQ conditioning, first

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
        config.check()
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

        nb = (NoiseBlanker.create(config.sample_rate, config.noise_blanker,
                                  device=device)
              if config.noise_blanker else None)
        cond = None
        if config.front_cond or config.dc_remove_bw > 0:
            cond = FrontConditioner.create(C, config.sample_rate,
                                           dc_bw=config.dc_remove_bw,
                                           device=device)
        nco = front = None
        stages = []
        if config.fused_frontend and stage_specs:
            comb, d_tot = fuse_cascade(stage_specs)
            nb_detect = ({"avg_win": nb.avg_win, "kwidth": nb.kwidth}
                         if nb is not None and nb.pool == 16 else None)
            front = FusedTuneDecimate.create(comb, tune_eff,
                                             config.sample_rate, B_in, d_tot,
                                             C, nb_detect=nb_detect,
                                             device=device)
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
                                  ext_demod=config.ext_demod, device=device,
                                  ctcss_hz=config.ctcss_hz)
        agc = None
        if config.agc:
            kind = WcpAGC if config.agc_profile == "wcp" else AGC
            agc = kind.create(plan.fs_out, device=device)
        notch = (AutoNotch.create(B_audio, device=device)
                 if config.auto_notch else None)
        nr = SpectralNR.create(B_audio, device=device) if config.nr else None
        anf = (BlockLMS.create(B_audio, notch=True, device=device)
               if config.anf else None)
        squelch = (SSBSquelch.create(plan.fs_out, B_audio,
                                     config.squelch_threshold, device=device)
                   if config.squelch else None)
        fm_sq = (FMSquelch.create(plan.fs_out, B_audio, config.fm_squelch_db,
                                  device=device)
                 if config.fm_squelch else None)
        ons = {name: torch.ones((C, 1), dtype=torch.float32, device=device)
               for name, op in (("nb", nb), ("notch", notch), ("nr", nr),
                                ("anf", anf), ("agc", agc),
                                ("squelch", squelch), ("fm_sq", fm_sq))
               if op is not None}
        return cls(nco=nco, front=front, stages=tuple(stages), bp=bp,
                   frac=frac, demod=demod, agc=agc, nb=nb, notch=notch,
                   nr=nr, anf=anf, squelch=squelch, fm_sq=fm_sq, ons=ons,
                   tune_base=torch.as_tensor(base.astype(np.float32),
                                             device=device),
                   channels=C, block_in=B_in, block_audio=B_audio,
                   fs_audio=plan.fs_out, cond=cond)

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

    def set_nb_level(self, level: int) -> "RxChain":
        """Noise-blanker threshold level 1/2/3 (the reference's NB cycle
        button, quisk.c:716-727: limits 6.0/4.0/2.5) — data only."""
        if self.nb is None:
            raise KeyError("chain built without a noise blanker")
        return dataclasses.replace(self, nb=dataclasses.replace(
            self.nb, limit=NoiseBlanker.level_limit(level, self.device)))

    def with_host_nb_detect(self) -> "RxChain":
        """A verification route, not a receiver option: this chain with
        the blanker's detection taken out of the front kernel.
        ``NoiseBlanker.detect`` computes the coarse gain as torch ops and
        the front kernel's gained mode applies it, at the cost of one more
        pass over the full-rate input.  The JAX chain has no such route
        (it reaches the gained mode only through
        ``FusedTuneDecimate.__call__(gain16=)``) and ``create`` never
        picks it; it exists so that in-kernel detection and the gained
        mode can be held against each other inside a whole chain."""
        if not self._nb_fused:
            raise ValueError("the blanker's detection is not in the front "
                             "kernel")
        return dataclasses.replace(self, front=dataclasses.replace(
            self.front, rc=None, with_gain=True))

    @property
    def _nb_fused(self) -> bool:
        """True when blanker detection and gain run inside the front
        kernel (``FusedTuneDecimate.call_nb``)."""
        return (self.front is not None and self.nb is not None
                and self.front.nb_detect is not None and self.nb.pool == 16)

    @property
    def _nb_gained(self) -> bool:
        """True when the blanker's gain, detected by torch ops, is applied
        inside the front kernel (``FusedTuneDecimate.__call__`` with
        ``gain16``)."""
        return (self.front is not None and self.nb is not None
                and not self._nb_fused and self.front.with_gain
                and self.nb.pool == 16)

    # ---------------------------------------------------------------- state
    def init_state(self):
        C = self.channels

        def st(op):
            return op.init_state(C) if op is not None else ()

        # coarse blanker-gain history covering the front's raw FIR history
        # (gain 1: nothing blanked before the stream)
        nbg = (torch.ones((C, self.front.gain_hist_groups),
                          dtype=torch.float32, device=self.device)
               if self._nb_fused or self._nb_gained else ())
        return {
            "nbg": nbg,
            "nco": st(self.nco),
            "cond": st(self.cond),
            "front": st(self.front),
            "stages": tuple(s.init_state(C) for s in self.stages),
            "bp": self.bp.init_state(C),
            "frac": st(self.frac),
            "demod": self.demod.init_state(C),
            "agc": st(self.agc),
            "nb": st(self.nb),
            "notch": st(self.notch),
            "nr": st(self.nr),
            "anf": st(self.anf),
            "squelch": st(self.squelch),
            "fm_sq": st(self.fm_sq),
        }

    # ----------------------------------------------------------------- step
    def step(self, state, x: torch.Tensor, key_down=False):
        """One block: x [C, block_in] complex64 -> audio [C, block_audio]
        (complex64 when a channel is DGT_IQ).  Raw-IQ conditioning
        (``key_down`` gates its window-average DC mode, sound.c:221-229)
        -> blanker (in the front
        kernel, or by torch ops with the gain in the kernel, or standalone)
        -> front -> stages -> channel filter -> frac -> RF level for the FM
        squelch -> demod -> notch -> anf -> nr -> agc -> squelch -> fm_sq,
        each optional stage from the blanker on blended by its ``ons``
        weight."""
        st = dict(state)

        def blend(name, wet, dry):
            g = self.ons[name]
            return wet * g + dry * (1.0 - g)

        with span("rx.step"):
            with span("rx.front"):
                if self.cond is not None:
                    st["cond"], x = self.cond(st["cond"], x,
                                              key_down=key_down)
                if self._nb_fused:
                    st["front"], y, gout = self.front.call_nb(
                        st["front"], x, st["nbg"], self.ons["nb"],
                        self.nb.limit)
                    st["nbg"] = gout[:, -self.front.gain_hist_groups:]
                elif self._nb_gained:
                    st["nb"], gc = self.nb.detect(st["nb"], x)
                    gc = 1.0 + self.ons["nb"] * (gc - 1.0)
                    st["front"], y = self.front(
                        st["front"], x,
                        gain16=torch.cat([st["nbg"], gc], dim=-1))
                    st["nbg"] = gc[:, -self.front.gain_hist_groups:]
                else:
                    if self.nb is not None:
                        st["nb"], xb = self.nb(st["nb"], x)
                        x = blend("nb", xb, x)
                    if self.front is not None:
                        st["front"], y = self.front(st["front"], x)
                    else:
                        st["nco"], y = self.nco(st["nco"], x)
                new_stage_states = []
                for op, s in zip(self.stages, st["stages"]):
                    s, y = op(s, y)
                    new_stage_states.append(s)
                st["stages"] = tuple(new_stage_states)
            with span("rx.filter"):
                st["bp"], y = self.bp(st["bp"], y)
                if self.frac is not None:
                    st["frac"], y = self.frac(st["frac"], y)
                if self.fm_sq is not None:
                    rf_db = self.fm_sq.measure(y)  # pre-demod carrier power
            y_filtered = y
            with span("rx.demod"):
                st["demod"], audio = self.demod(st["demod"], y)
            for name, op, where in (("notch", self.notch, "rx.notch"),
                                    ("anf", self.anf, "rx.anf"),
                                    ("nr", self.nr, "rx.nr"),
                                    ("agc", self.agc, "rx.agc"),
                                    ("squelch", self.squelch, "rx.squelch")):
                if op is not None:
                    with span(where):
                        st[name], a2 = op(st[name], audio)
                        audio = blend(name, a2, audio)
            if self.fm_sq is not None:
                with span("rx.fm_sq"):
                    st["fm_sq"], a2 = self.fm_sq(st["fm_sq"], audio, rf_db)
                    audio = blend("fm_sq", a2, audio)
            if self.demod.iq_out:
                # DGT-IQ pass-through (quisk.c:2141-2153): those channels
                # emit the channel-filtered IQ; real audio rides Re of the
                # others
                is_iq = (self.demod.mode == int(Mode.DGT_IQ))[:, None]
                audio = torch.where(is_iq, y_filtered,
                                    audio.to(torch.complex64))
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
