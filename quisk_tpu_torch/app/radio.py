"""The radio application object: everything wired together, headless.

Parity: quisk.py's ``App`` (3710) — the reference's GUI object owns the
config, the hardware plugin, the sound loop, the spectrum display, CAT
servers and state persistence.  Here the same orchestration without wx:

  cfg = RadioConfig(sample_rate=..., mode="USB", ...)
  radio = Radio(cfg, hardware="sim")            # on the card
  radio = Radio(cfg, hardware="sim", device="cpu")
  radio.open()
  audio = radio.run(blocks=50)        # pull -> chain -> audio/spectrum
  radio.set_frequency(7_055_000); radio.set_mode("LSB")   # data-only
  radio.close()

The chain, its state, the spectrum services and the TX chain live on the
session's device; the hardware plugin hands over host numpy blocks, which
``run_once`` moves to the device (a one-row capture crosses as one row and
is expanded there for every channel), and audio comes back as host numpy.

External control (rigctld server) attaches to the same state: frequency/
mode/PTT changes from WSJT-X retune the running chain between blocks.

Not in this module yet (the servers and devices of slice 7b of the port):
the serial, K4 and TCI CAT servers, the web UI, audio playback and live
microphone capture, the CQ voice keyer, the serial CW key, MIDI, and the
favourites / memories / station markers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.app.config import RadioConfig, Settings
from quisk_tpu_torch.app.graph import GraphService, WaterfallRenderer
from quisk_tpu_torch.app.status import StatusBoard
from quisk_tpu_torch.hw.base import get_hardware
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.rx import RxChain


class Radio:
    """Headless radio session around one RX chain.

    ``hardware`` is a registry key or a Hardware instance.  All tunables
    route through :meth:`set_frequency`/:meth:`set_mode`, which retune the
    chain as data (RxChain.retune: tensors swap, nothing is rebuilt).
    ``device=None`` runs on the card (and raises without one);
    ``device="cpu"`` runs on the CPU.
    """

    def __init__(self, cfg: RadioConfig, hardware="sim",
                 settings: Settings | None = None,
                 rigctl_port: int | None = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.hw = (get_hardware(hardware)(cfg)
                   if isinstance(hardware, str) else hardware)
        self.settings = settings
        # the per-radio flag surface (configure.py:543-588 round trip):
        # overrides persisted in the settings db are restored here
        from quisk_tpu_torch.app.flags import Flags
        self.flags = (settings.get_flags(cfg.name)
                      if settings is not None else Flags())
        self.status = StatusBoard()
        self.rx_cfg = cfg.rx_chain_config()
        # VFO split (parity quisk.c:200 rx_tune_freq = tune - VFO): the chain
        # tunes by a *baseband offset* within +-sample_rate/2; a CAT client
        # sends absolute dial frequencies.  Small cfg.tune_hz values are
        # treated as offsets from a 0 Hz VFO (back-compat for tests/sims);
        # anything outside the passband centers the VFO on it.
        if abs(cfg.tune_hz) <= 0.45 * cfg.sample_rate:
            self.vfo_hz = 0.0
        else:
            self.vfo_hz = float(cfg.tune_hz)
        self.freq_hz = float(cfg.tune_hz)
        offset = self.freq_hz - self.vfo_hz
        # multi-RX surface (parity quisk.c:2590-2652 sub-receivers):
        # channel 0 is the main receiver; channels 1..C-1 are sub-RX with
        # independent offset/mode, an L/R/both play route, and (for
        # DGT-IQ) a per-channel digital I/Q output
        C = cfg.channels
        self.offsets = np.full(C, offset, np.float64)
        self.channel_modes = [cfg.mode] * C
        # per-channel filter bandwidth; None = the mode's default width
        # (the reference's filter-button row, quisk.py:5095 + MakeFilterCoef)
        self.bandwidths: list = [cfg.bandwidth_hz] * C
        self.routes = ["both"] + ["off"] * (C - 1)
        self._digital_out: dict[int, np.ndarray] = {}
        # hardware plugins may demand spectrum inversion (the SDR-8600 IF
        # flips 2 m / 70 cm: hw.invert_spectrum)
        self.invert = bool(cfg.invert_spectrum
                           or getattr(self.hw, "invert_spectrum", False))
        if self.invert and not self.rx_cfg.front_cond:
            self.rx_cfg = dataclasses.replace(self.rx_cfg, front_cond=True)
        self.ampl_phase = (0.0, 0.0)     # current I/Q balance trim
        # speaker volume + mute (quisk.py sliderVol / QS.set_volume and
        # the Mute button — a playback-path multiplier; digital/DGT-IQ
        # outputs stay unscaled like the reference's sound routing)
        self.volume = 1.0
        self.muted = False
        self.cat_ptt = False             # PTT latched by a CAT client
        self.manual_ptt = False          # the PTT button (set_ptt)
        self.manual_key = False          # a host-driven CW key (set_cw_key)
        # split RX/TX + RIT (quisk.py:4012 split_rxtx / 2112 ritFreq;
        # QS.set_tune(rxFreq + ritFreq, txFreq) at quisk.py:5781)
        self.split_rxtx = 0              # 0 = off; 1..4 = play option
        self.split_offset = 0.0          # remembered tx-rx spacing
        self.tx_freq_hz = self.freq_hz   # TX dial (== RX dial unsplit)
        self.rit_hz = 0.0
        self.rit_on = False
        self._split_saved = None         # channel-1 state to restore
        self._keyed = False              # current TX state of the loop
        # the microphone: any object with get(n) -> float32 [n] (the live
        # capture device, enable_mic, is slice 7b); None = silence
        self.mic = None
        self.tx = None                   # TxChain once enable_tx ran
        self.tx_iq_last = None           # most recent transmitted IQ block
        if settings is not None:
            self.volume = float(settings.get_state().get("volume", 1.0))
        self.chain = RxChain.create(self.rx_cfg, tune_hz=self.offsets,
                                    mode=[int(Mode[m])
                                          for m in self.channel_modes],
                                    bandwidth_hz=(
                                        [float(cfg.bandwidth_hz)] * C
                                        if cfg.bandwidth_hz else None),
                                    device=self.device)
        if self.chain.cond is not None:
            saved = (settings.get_state().get("ampl_phase")
                     if settings is not None else None) or self.ampl_phase
            self.ampl_phase = tuple(saved)
            self._apply_trim()
        self.cfg.tune_hz = offset
        self.graph = GraphService(fft_size=cfg.fft_size,
                                  block=self.chain.block_in,
                                  channels=C, sample_rate=cfg.sample_rate,
                                  refresh_hz=cfg.graph_refresh_hz,
                                  window=cfg.graph_window,
                                  overlap=cfg.graph_overlap,
                                  device=self.device)
        self.waterfall = WaterfallRenderer(pixels=1024)
        self._state = self.chain.init_state()
        # manual notch database (wdsp/nbp.c): absolute-RF entries carved
        # into the channel filters as data; persisted through Settings
        from quisk_tpu_torch.app.notchdb import NotchDB
        if settings is not None and settings.get_state().get("notches"):
            self.notch_db = NotchDB.from_list(
                settings.get_state()["notches"])
        else:
            self.notch_db = NotchDB()
        if len(self.notch_db):
            self._retune()               # carve restored notches in
        self.rigctl = None
        if rigctl_port is not None:
            from quisk_tpu_torch.app.rigctl import RadioState, RigctlServer
            st = RadioState()
            st.freq = int(self.freq_hz)
            st.mode = cfg.mode
            st.on_change = self._on_cat_change
            self.rigctl = RigctlServer(st, port=rigctl_port)
            self.rigctl.start()

    # ---- lifecycle ------------------------------------------------------
    def open(self) -> str:
        status = self.hw.open()
        # announce the initial dial/VFO (the reference tunes the hardware
        # right after open, quisk.py:4345 post-open ChangeHwFrequency)
        self.hw.ChangeFrequency(int(self.tx_freq_hz), int(self.vfo_hz))
        self.hw.StartSamples()
        return status

    def close(self) -> None:
        self.hw.StopSamples()
        self.hw.close()
        if self.rigctl is not None:
            self.rigctl.stop()
        if self.settings is not None:
            self.settings.save()

    # ---- the runtime flag surface (configure.py:543-588: view/edit any
    # flag on a running radio, persisted per named radio) ------------------
    def get_flag(self, name: str):
        return self.flags.get(name)

    def set_flag(self, name: str, value) -> None:
        """Set a registry flag (validated) and persist it for this named
        radio; restored on the next construction with the same Settings
        (the reference's configure.py JSON load/store round trip)."""
        self.flags.set(name, value)
        if self.settings is not None:
            self.settings.set_flags(self.cfg.name, self.flags)
            self.settings.save()

    def flags_dict(self, section: str | None = None,
                   changed_only: bool = False) -> dict:
        """{name: {value, default, type, section, help, choices,
        changed}} for the config surface."""
        from quisk_tpu_torch.app.flags import REGISTRY
        out = {}
        for name, fl in REGISTRY.items():
            if section is not None and fl.section != section:
                continue
            v = self.flags.get(name)
            if changed_only and v == fl.default:
                continue
            out[name] = {"value": v, "default": fl.default,
                         "type": fl.type, "section": fl.section,
                         "help": fl.help, "choices": list(fl.choices),
                         "changed": v != fl.default}
        return out

    # ---- control --------------------------------------------------------
    def set_frequency(self, freq_hz: float) -> None:
        """Tune to an absolute dial frequency.  The chain is retuned by
        ``freq - VFO``; when the offset would leave the passband the VFO
        recenters on the new frequency (and the hardware is told to move),
        so a CAT client sending 7.074 MHz never wraps the NCO word
        (parity quisk.c:200: rx_tune_freq = tune - VFO)."""
        self.freq_hz = float(freq_hz)
        offset = self.freq_hz - self.vfo_hz
        if abs(offset) > 0.45 * self.cfg.sample_rate:
            old_vfo = self.vfo_hz
            self.vfo_hz = self.freq_hz
            offset = 0.0
            # sub-receivers hold their ABSOLUTE frequency across the VFO
            # recenter (offsets are VFO-relative); one that no longer fits
            # the capture passband is clamped to its edge and counted
            half = 0.5 * self.cfg.sample_rate
            for c in range(1, len(self.offsets)):
                new_off = (old_vfo + self.offsets[c]) - self.vfo_hz
                if abs(new_off) > half:
                    new_off = float(np.clip(new_off, -half, half))
                    self.status.count("subrx_out_of_band")
                self.offsets[c] = new_off
        self.cfg.tune_hz = offset
        self.offsets[0] = offset
        if not self.split_rxtx:
            # unsplit: TX rides the RX dial (quisk.py OnBtnSplit else-arm:
            # txFreq = rxFreq); hardware is always told the TX dial like
            # ChangeHwFrequency(self.txFreq, self.VFO)
            self.tx_freq_hz = self.freq_hz
        else:
            self._apply_split_channel()
        self.hw.ChangeFrequency(int(self.tx_freq_hz), int(self.vfo_hz))
        self._update_tx_tune()
        self._retune()

    def set_mode(self, mode: str) -> None:
        self.cfg.mode = mode
        self.channel_modes[0] = mode
        if self.split_rxtx and self.cfg.channels > 1:
            self.channel_modes[1] = mode   # split monitor follows the mode
        self.hw.ChangeMode(mode)
        self._retune()
        if self.tx is not None:
            self._apply_tx_audio()

    # ---- band switching with per-band memory (quisk.py:3823 bandState;
    # band buttons save (VFO, tune, mode) and restore on return) ----------
    #: amateur allocations (quisk_conf_defaults.py:2553 BandEdge — the
    #: ITU band-plan facts, not code)
    BAND_EDGES = {
        "137k": (135_700, 137_800), "500k": (472_000, 479_000),
        "160": (1_800_000, 2_000_000), "80": (3_500_000, 4_000_000),
        "60": (5_300_000, 5_430_000), "40": (7_000_000, 7_300_000),
        "30": (10_100_000, 10_150_000), "20": (14_000_000, 14_350_000),
        "17": (18_068_000, 18_168_000), "15": (21_000_000, 21_450_000),
        "12": (24_890_000, 24_990_000), "10": (28_000_000, 29_700_000),
        "6": (50_000_000, 54_000_000), "2": (144_000_000, 148_000_000),
        "70cm": (420_000_000, 450_000_000),
    }

    def set_band(self, band: str) -> None:
        """Switch bands: save (VFO, dial, mode) for the current band and
        restore the target band's last state — or, on first visit, tune
        the band center with the reference's default mode rule (LSB below
        9 MHz, USB above; quisk.py ChangeBand).  Persisted via Settings
        (StateNames 'bandState'/'lastBand', quisk.py:3713)."""
        if not hasattr(self, "band_state"):
            self.band_state = {}
            if self.settings is not None:
                self.band_state = dict(
                    self.settings.get_state().get("band_state") or {})
        cur = getattr(self, "band", None)
        if cur is not None:
            self.band_state[cur] = [self.vfo_hz, self.freq_hz,
                                    self.cfg.mode]
        self.band = band
        if band in self.band_state:
            vfo, freq, mode = self.band_state[band]
        else:
            f1, f2 = self.BAND_EDGES.get(band, (10_000_000, 12_000_000))
            vfo = ((f1 + f2) // 2 // 10_000) * 10_000
            mode = "LSB" if vfo < 9_000_000 else "USB"
            freq = vfo
        self.vfo_hz = float(vfo)
        self.set_mode(mode)
        if hasattr(self.hw, "ChangeBand"):
            self.hw.ChangeBand(band)      # quisk.py:6366 Hardware.ChangeBand
        self.set_frequency(float(freq))
        if hasattr(self.hw, "ChangeBandFilters"):
            self.hw.ChangeBandFilters()   # quisk.py:3174 hardware hook
        if self.settings is not None:
            self.settings.update_state(band=band,
                                       band_state=self.band_state)

    # ---- per-mode TX audio settings (quisk.py:3716 txAudioClipUsb/Am/
    # Fm/Fdv + txAudioPreemph*, applied on mode change at 5681-5695) ------
    _TX_AUDIO_FAMILY = {"USB": "Usb", "LSB": "Usb", "AM": "Am", "FM": "Fm",
                        "DGT_FM": "Fm", "FDV_U": "Fdv", "FDV_L": "Fdv",
                        "DGT_FDV": "Fdv"}

    def _tx_family(self) -> str | None:
        return self._TX_AUDIO_FAMILY.get(self.cfg.mode)

    def set_tx_audio(self, clip_db: float | None = None,
                     preemph: float | None = None) -> None:
        """Set the TX audio clip (compressor drive dB) and/or preemphasis
        coefficient for the CURRENT mode's family; remembered per family
        and re-applied on every mode change, like the reference's
        txAudioClip*/txAudioPreemph* per-mode state."""
        fam = self._tx_family()
        if fam is None:
            return                     # CW/DGT data modes: no mic shaping
        entry = self.tx_audio.setdefault(fam, {"clip_db": 0.0,
                                               "preemph": 0.0})
        if clip_db is not None:
            entry["clip_db"] = float(clip_db)
        if preemph is not None:
            entry["preemph"] = float(preemph)
        self._apply_tx_audio()

    def _apply_tx_audio(self) -> None:
        if self.tx is None:
            return
        fam = self._tx_family()
        entry = getattr(self, "tx_audio", {}).get(
            fam or "", {"clip_db": 0.0, "preemph": 0.0})
        self.tx = self.tx.set_audio_settings(clip_db=entry["clip_db"],
                                             preemph=entry["preemph"])

    def set_sub_rx(self, channel: int, freq_hz: float | None = None,
                   mode: str | None = None, route: str | None = None) -> None:
        """Configure sub-receiver ``channel`` (1..C-1): absolute frequency
        (must fall in the current passband around the VFO), mode, and the
        audio play route ('left'/'right'/'both'/'off' — parity
        quisk.c:2601-2620 play methods; DGT-IQ channels instead publish
        their I/Q to :meth:`digital_output`)."""
        if not 0 < channel < self.cfg.channels:
            raise ValueError(f"sub-rx channel must be 1..{self.cfg.channels - 1}")
        if freq_hz is not None:
            off = float(freq_hz) - self.vfo_hz
            if abs(off) > 0.5 * self.cfg.sample_rate:
                raise ValueError("sub-rx frequency outside the passband; "
                                 "move the main VFO first")
            self.offsets[channel] = off
        if mode is not None:
            self.channel_modes[channel] = mode
        if route is not None:
            self.routes[channel] = route
        self._retune()

    # ---- split RX/TX + RIT (quisk.py:5783 OnBtnSplit, 2112 ritFreq;
    # the second demod bank + play routings are quisk.c:2537-2590) --------
    def set_rit(self, rit_hz: float, on: bool | None = None) -> None:
        """Receive incremental tuning (ritButton/ritScale): shifts the
        demod tune by ``rit_hz`` while the dial, the hardware, and TX
        stay put (QS.set_tune(rxFreq + ritFreq, txFreq), quisk.py:5781);
        the split monitor bank shifts too (quisk.c:2538)."""
        self.rit_hz = float(rit_hz)
        self.rit_on = bool(abs(self.rit_hz) > 0 if on is None else on)
        self._retune()

    def set_split(self, enable: bool, tx_freq: float | None = None,
                  play: int = 1) -> None:
        """Split RX/TX: on enable, TX moves to ``tx_freq`` (default
        rx + 1 kHz in CW / 3 kHz voice, spacing remembered across
        toggles, quisk.py:5786-5793) and demod bank 1 monitors the TX
        frequency with the reference's four play routings (quisk.c:2548:
        1 = stereo, higher frequency left; 2 = stereo, lower left;
        3 = mono RX; 4 = mono TX monitor).  The monitor bank needs
        cfg.channels >= 2; TX-side split works on any channel count."""
        if enable:
            if tx_freq is None:
                if self.split_offset == 0.0:
                    self.split_offset = (1000.0 if self.cfg.mode in
                                         ("CWL", "CWU") else 3000.0)
                tx_freq = self.freq_hz + self.split_offset
            self.tx_freq_hz = float(tx_freq)
            self.split_offset = self.tx_freq_hz - self.freq_hz
            self.split_rxtx = int(play)
            if self._split_saved is None and self.cfg.channels > 1:
                self._split_saved = (float(self.offsets[1]),
                                     self.channel_modes[1], self.routes[1])
            self._apply_split_channel()
        else:
            if self.split_rxtx:
                self.split_offset = self.tx_freq_hz - self.freq_hz
            self.split_rxtx = 0
            self.tx_freq_hz = self.freq_hz
            if self._split_saved is not None:
                (self.offsets[1], self.channel_modes[1],
                 self.routes[1]) = self._split_saved
                self._split_saved = None
            self.routes[0] = "both"
        self.hw.ChangeFrequency(int(self.tx_freq_hz), int(self.vfo_hz))
        self._update_tx_tune()
        self._retune()

    def set_tx_frequency(self, tx_freq: float) -> None:
        """Move the TX dial while split (CAT traffic lands here); unsplit
        it tunes both sides via :meth:`set_frequency`."""
        if not self.split_rxtx:
            self.set_frequency(tx_freq)
            return
        self.tx_freq_hz = float(tx_freq)
        self.split_offset = self.tx_freq_hz - self.freq_hz
        self._apply_split_channel()
        self.hw.ChangeFrequency(int(self.tx_freq_hz), int(self.vfo_hz))
        self._update_tx_tune()
        self._retune()

    def _apply_split_channel(self) -> None:
        """Point demod bank 1 at the TX frequency and set the stereo play
        routing (quisk.c:2548-2590; real part = left ear here)."""
        if self.cfg.channels < 2:
            return
        off = self.tx_freq_hz - self.vfo_hz
        half = 0.5 * self.cfg.sample_rate
        if abs(off) > half:
            off = float(np.clip(off, -half, half))
            self.status.count("subrx_out_of_band")
        self.offsets[1] = off
        self.channel_modes[1] = self.channel_modes[0]
        play = self.split_rxtx
        if play == 3:                      # mono receive channel
            self.routes[0], self.routes[1] = "both", "off"
        elif play == 4:                    # mono transmit monitor
            self.routes[0], self.routes[1] = "off", "both"
        else:
            hi_is_main = self.freq_hz >= self.tx_freq_hz
            main_left = hi_is_main if play == 1 else not hi_is_main
            self.routes[0] = "left" if main_left else "right"
            self.routes[1] = "right" if main_left else "left"

    def _update_tx_tune(self) -> None:
        """Keep the TX chain's baseband tune in sync: radios whose own
        DDS places TX (hw.tx_dds) transmit at baseband DC; soundcard
        radios get the digital rotation to tx_freq - VFO (sound.c:708)."""
        if self.tx is None:
            return
        off = (0.0 if getattr(self.hw, "tx_dds", True)
               else self.tx_freq_hz - self.vfo_hz)
        self.tx = self.tx.set_tune(off)

    def _retune(self) -> None:
        modes = [int(Mode[m]) for m in self.channel_modes]
        want_iq = any(m == "DGT_IQ" for m in self.channel_modes)
        # per-channel filter widths: explicit where set, the mode default
        # elsewhere (mode_band(bw=None) uses the same table)
        if any(b is not None for b in self.bandwidths):
            from quisk_tpu_torch.modes import DEFAULT_BANDWIDTH
            bws = [float(b) if b is not None
                   else float(DEFAULT_BANDWIDTH[Mode[m]])
                   for b, m in zip(self.bandwidths, self.channel_modes)]
        else:
            bws = None
        # RIT shifts the DEMOD tune only — not the dial, the hardware, or
        # TX (quisk.py:5781 QS.set_tune(rxFreq + ritFreq, txFreq)); the
        # split monitor bank gets it too (quisk.c:2538 tx_tune + rit)
        offsets = np.array(self.offsets, np.float64)
        rit = self.rit_hz if self.rit_on else 0.0
        if rit:
            offsets[0] += rit
            if self.split_rxtx and len(offsets) > 1:
                offsets[1] += rit
        # manual notch database entries that land in each channel's
        # passband, carved into the channel filter (wdsp/nbp.c semantics)
        notches = None
        if len(self.notch_db):
            from quisk_tpu_torch.rx.chain import _cw_rit
            rits = _cw_rit(np.asarray(modes), self.rx_cfg.cw_pitch)
            notches = [self.notch_db.baseband(self.vfo_hz + off, r)
                       for off, r in zip(offsets, rits)]
            self._notched = True
        elif getattr(self, "_notched", False):
            # last notch removed: one clean redesign to uncarve the masks
            notches = [()] * len(modes)
            self._notched = False
        if want_iq != self.chain.demod.iq_out:
            # complex pass-through is a create-time static (it changes the
            # chain's output dtype): rebuild + reset carried state
            old_ons = self.chain.ons
            chain = RxChain.create(self.rx_cfg, tune_hz=offsets,
                                   mode=modes, bandwidth_hz=bws,
                                   device=self.device)
            # carry the runtime stage toggles across the rebuild
            self.chain = dataclasses.replace(chain, ons={
                k: old_ons.get(k, v) for k, v in chain.ons.items()})
            self._state = self.chain.init_state()
            self._apply_trim()
            if notches is not None:
                self.chain = self.chain.retune(self.rx_cfg, mode=modes,
                                               bandwidth_hz=bws,
                                               notches_hz=notches)
        else:
            self.chain = self.chain.retune(self.rx_cfg, tune_hz=offsets,
                                           mode=modes, bandwidth_hz=bws,
                                           notches_hz=notches)

    def filter_response(self, channel: int = 0, points: int = 2048) -> dict:
        """Current RX channel-filter response + 3/6 dB bandwidths (the
        FilterScreen data, quisk.py:3570)."""
        from quisk_tpu_torch.app.graph import filter_response
        from quisk_tpu_torch.rx.planner import plan_decimation

        plan = plan_decimation(self.cfg.sample_rate, self.cfg.audio_rate)
        return filter_response(self.chain.bp, plan.fs_mid, channel, points)

    def _apply_trim(self) -> None:
        if self.chain.cond is not None:
            self.chain = dataclasses.replace(
                self.chain, cond=self.chain.cond.with_balance(
                    self.ampl_phase[0], self.ampl_phase[1],
                    invert=self.invert))

    def set_volume(self, volume: float) -> None:
        """Speaker volume 0..1 (quisk.py sliderVol); persisted."""
        self.volume = float(np.clip(volume, 0.0, 1.0))
        if self.settings is not None:
            self.settings.update_state(volume=self.volume)

    def set_mute(self, muted: bool) -> None:
        """Mute button: silences the speaker path only (digital outputs
        and the spectrum keep flowing, like the reference)."""
        self.muted = bool(muted)

    def set_spot(self, level: float) -> None:
        """Spot button: transmit a plain carrier at ``level`` (0..1) for
        antenna tuning; negative turns it off (microphone.c:1218)."""
        if self.tx is None:
            raise ValueError("no TX chain (call enable_tx first)")
        self.tx = self.tx.set_spot(level)
        self.spot_level = float(level)

    def set_ampl_phase(self, ampl: float, phase_deg: float,
                       is_tx: bool = False) -> None:
        """Set the RX (or, with ``is_tx``, TX) I/Q balance trim (parity
        quisk_set_ampl_phase, sound.c:1560-1581; the GUI's per-band
        amplitude/phase adjust).  Data-only; persisted via Settings like
        the reference's bandAmplPhase database (quisk.py:3826)."""
        if is_tx:
            if self.tx is None:
                raise ValueError("no TX chain (call enable_tx first)")
            self.tx = self.tx.set_ampl_phase(ampl, phase_deg)
            if self.settings is not None:
                self.settings.update_state(
                    tx_ampl_phase=[float(ampl), float(phase_deg)])
            return
        if self.chain.cond is None:
            raise ValueError("enable cfg.front_cond to use the balance trim")
        self.ampl_phase = (float(ampl), float(phase_deg))
        self._apply_trim()
        if self.settings is not None:
            self.settings.update_state(ampl_phase=list(self.ampl_phase))

    # ---- runtime DSP stage toggles (the reference's NB/Notch/NR2/AGC/
    # Sqlch main-screen buttons, quisk.py:4917-4960) -----------------------
    def set_stage(self, name: str, on: bool,
                  channel: int | None = None) -> None:
        """Toggle an optional DSP stage live — pure data.  ``name`` in
        {'nb','notch','nr','anf','agc','squelch','fm_sq'}; raises KeyError
        if the chain was built without it."""
        self.chain = self.chain.set_stage(name, bool(on), channel=channel)

    def set_nb_level(self, level: int) -> None:
        """The NB cycle button (NB 1/2/3): threshold as data; level 0
        turns the blanker off."""
        if int(level) == 0:
            self.set_stage("nb", False)
            return
        self.chain = self.chain.set_nb_level(int(level))
        if not self.chain.stage_on("nb"):
            self.chain = self.chain.set_stage("nb", True)

    def stage_states(self) -> dict:
        """{stage: on} for every optional stage built into the chain."""
        return {k: bool(v[0, 0] != 0) for k, v in self.chain.ons.items()}

    def set_bandwidth(self, bw_hz: float | None, channel: int = 0) -> None:
        """The filter-button row (quisk.py:5095 + MakeFilterCoef 5405):
        set the channel filter width live; None restores the mode's
        default.  Pure data — masks swap."""
        self.bandwidths[channel] = (None if bw_hz is None
                                    else float(bw_hz))
        if channel == 0:
            self.cfg.bandwidth_hz = self.bandwidths[0]
        self._retune()

    def set_squelch_level(self, value: float) -> None:
        """The Sqlch slider (quisk.py sliderSquelch): SSB squelch opening
        threshold (spectral-flatness nats) and/or FM squelch RF threshold
        (value interpreted as dB when the chain has the FM squelch) —
        pure data."""
        ch = self.chain
        v = torch.tensor(float(value), dtype=torch.float32,
                         device=self.device)
        if ch.squelch is not None:
            ch = dataclasses.replace(ch, squelch=dataclasses.replace(
                ch.squelch, threshold=v))
        if ch.fm_sq is not None:
            ch = dataclasses.replace(ch, fm_sq=dataclasses.replace(
                ch.fm_sq, threshold_db=v))
        if ch is self.chain:
            raise KeyError("chain built without a squelch")
        self.chain = ch

    def set_agc_level(self, max_gain_db: float | None = None,
                      target: float | None = None) -> None:
        """The AGC dual-slider (quisk.py BtnAGC + agcMaxGain/agcOffGain):
        maximum AGC gain in dB and/or the output target level — data."""
        if self.chain.agc is None:
            raise KeyError("chain built without AGC")

        def f32(x):
            return torch.tensor(float(x), dtype=torch.float32,
                                device=self.device)

        agc = self.chain.agc
        if max_gain_db is not None:
            agc = dataclasses.replace(agc, max_lgain=f32(
                float(max_gain_db) * np.log(10.0) / 20.0))
        if target is not None:
            agc = dataclasses.replace(agc, target=f32(target))
        self.chain = dataclasses.replace(self.chain, agc=agc)

    def set_fdx(self, on: bool) -> None:
        """The FDX button (quisk.py:5021): full duplex — keep RX audio
        live while transmitting (no sidetone/silence substitution)."""
        if self.tx is None:
            raise ValueError("no TX chain (call enable_tx first)")
        self.tx_monitor = bool(on)

    def set_sidetone(self, level: float) -> None:
        """CW sidetone volume 0..1 (quisk.py sidetone slider)."""
        if self.tx is None:
            raise ValueError("no TX chain (call enable_tx first)")
        self.sidetone.level = float(np.clip(level, 0.0, 1.0))

    def add_tone(self, freq_hz: float = 0.0, level: float = 0.1) -> None:
        """The Test 1 button (quisk.py:5939 QS.add_tone): inject a test
        carrier into the RX capture before the chain; 0 turns it off."""
        self._test_tone = (float(freq_hz), float(level)) if freq_hz else None
        self._test_tone_t = 0

    # ---- manual notches (wdsp/nbp.c notch-bank bandpass) ----------------
    def add_notch(self, freq_hz: float, width_hz: float = 100.0) -> None:
        """Add a persistent manual notch at an absolute RF frequency; it
        is carved into every channel filter whose passband contains it
        and tracks retunes (pure data)."""
        self.notch_db.add(freq_hz, width_hz)
        self._retune()

    def remove_notch(self, freq_hz: float) -> None:
        if self.notch_db.remove(freq_hz):
            self._retune()

    def set_notch_active(self, freq_hz: float, active: bool) -> None:
        self.notch_db.set_active(freq_hz, active)
        self._retune()

    def _on_cat_change(self, field, value) -> None:
        if field == "freq":
            self.set_frequency(value)
        elif field == "mode":
            self.set_mode(value)
        elif field == "volume":
            self.set_volume(float(value))
        elif field == "band":
            try:
                self.set_band(str(value))
            except (KeyError, ValueError):
                pass                     # unknown band id: ignore like quisk
        elif field == "ptt":
            # latched into the next transmit(); with no TX DSP configured,
            # key the hardware line directly (quisk.py:6695 SetPTT from
            # CAT handlers)
            self.cat_ptt = bool(value)
            if self.tx is None:
                self.hw.OnButtonPTT(self.cat_ptt)
        elif field == "tx_freq":
            self.set_tx_frequency(float(value))
        elif field == "split":
            # clients enable split first, then send the TX freq (hamlib
            # S / I order) — enable with the remembered spacing and let
            # the tx_freq change that follows move the TX dial
            self.set_split(bool(value))
        elif field in ("rit", "rit_on"):
            st = self._cat_state()
            self.set_rit(float(getattr(st, "rit", 0.0)),
                         on=bool(getattr(st, "rit_on", False)))

    def _cat_state(self):
        """One RadioState shared by every CAT surface so clients see a
        consistent radio."""
        if self.rigctl is not None:
            return self.rigctl.state
        if getattr(self, "_catstate", None) is None:
            from quisk_tpu_torch.app.rigctl import RadioState

            st = RadioState()
            st.freq = int(self.freq_hz)
            st.mode = self.cfg.mode
            st.on_change = self._on_cat_change
            self._catstate = st
        return self._catstate

    # ---- the block loop (the reference's sound-thread iteration) ---------
    def run_once(self) -> np.ndarray | None:
        """Pull one block from hardware through the chain; feeds the
        spectrum/waterfall; returns the audio block (host numpy, or None
        if starved).

        Full duplex like the reference's ONE loop iteration (quisk.c:2371;
        sound.c:1034-1186): key sources are polled first; when keyed the
        mic section runs (mic -> TX chain -> hardware IQ) and the RX audio
        is replaced by sidetone/silence under 5 ms envelopes; on release
        the keyup envelope restores RX click-free (quisk.c:2711-2738)."""
        # hardware housekeeping like the reference's loop (quisk.py:4466
        # HeartBeat ~10 Hz; 5570-5585 ReturnFrequency hardware-initiated
        # tuning, e.g. a front-panel knob)
        self._hb_count = getattr(self, "_hb_count", 0) + 1
        hb_every = max(1, int(round(
            self.cfg.sample_rate / self.chain.block_in / 10.0)))
        if self._hb_count % hb_every == 0:
            self.hw.HeartBeat()
        tune, vfo = self.hw.ReturnFrequency()
        if tune is not None or vfo is not None:
            if vfo is not None and vfo != self.vfo_hz:
                self.vfo_hz = float(vfo)
            self.set_frequency(float(tune if tune is not None
                                     else self.freq_hz))
        keyed, cw_key, mic = self._poll_tx_keys()
        x = self.hw.read_samples(self.chain.block_in)
        if x is None:
            self.status.count("read_starved")
            return None
        tt = getattr(self, "_test_tone", None)
        if tt is not None:
            # Test 1 button: inject a carrier into the capture
            # (QS.add_tone, quisk.py:5939-5944)
            f, lvl = tt
            n = np.arange(x.shape[-1]) + self._test_tone_t
            x = x + lvl * np.exp(
                2j * np.pi * f * n / self.cfg.sample_rate
            ).astype(np.complex64)
            self._test_tone_t += x.shape[-1]
        chain = self.chain
        xd = torch.as_tensor(np.asarray(x, np.complex64), device=self.device)
        if xd.shape[0] == 1 and chain.channels > 1:
            # split model: all demod banks share one capture
            # (quisk.c:2537-2652 split/multirx on the same samples); the
            # capture crosses to the device as one row and is expanded
            # there, not copied once per channel
            xd = xd.expand(chain.channels, xd.shape[1])
        self._state, audio_d = chain.step(self._state, xd, key_down=keyed)
        audio = audio_d.cpu().numpy()
        if np.iscomplexobj(audio):
            # DGT-IQ channels publish raw I/Q for digital programs
            # (quisk.c:2630-2652 per-sub-RX digital output devices)
            for c, m in enumerate(self.channel_modes):
                if m == "DGT_IQ":
                    self._digital_out[c] = audio[c]
            audio = np.real(audio)
        if self.tx is not None:
            audio = self._duplex_audio(audio, keyed, cw_key, mic)
        audio = audio * (0.0 if self.muted else self.volume)
        trace = self.graph.feed(xd)
        self._apply_zoom_req()               # radio-thread zoom changes
        cap = getattr(self, "_zoomcap", None)
        if cap is not None:
            zs, zst = cap
            zst, _ = zs.accumulate(zst, xd[0:1])
            self._zoomcap = (zs, zst)
        if trace is not None:
            self.waterfall.add_row(trace[0])
        rec = getattr(self, "_record", None)
        if rec is not None:              # live record taps (sound.c:255-421)
            if rec["kind"] == "iq":
                row = rec["channel"] if x.shape[0] > 1 else 0
                rec["blocks"].append(np.array(x[row], np.complex64))
            else:
                rec["blocks"].append(
                    np.real(audio[rec["channel"]]).astype(np.float32))
        if self.settings is not None:
            self.settings.update_state(tune_hz=self.cfg.tune_hz,
                                       mode=self.cfg.mode,
                                       notches=self.notch_db.to_list())
        return np.asarray(audio)

    # ---- record buttons (sound.c:255-421 + quisk.c:295-577: record the
    # speaker audio or the raw samples to WAV while running) --------------
    def start_record(self, path: str, kind: str = "audio",
                     channel: int = 0) -> None:
        """Start recording ``kind`` ('audio' = demodulated speaker audio,
        'iq' = raw capture samples) of one channel; stop_record writes
        the WAV."""
        if kind not in ("audio", "iq"):
            raise ValueError("kind must be 'audio' or 'iq'")
        self._record = {"path": path, "kind": kind, "channel": int(channel),
                        "blocks": []}

    def stop_record(self) -> str | None:
        """Write the recording started by :meth:`start_record`; returns
        the path (None if nothing was recorded)."""
        rec = getattr(self, "_record", None)
        self._record = None
        if rec is None or not rec["blocks"]:
            return None
        from quisk_tpu_torch.io import wav
        data = np.concatenate(rec["blocks"], axis=-1)
        if rec["kind"] == "iq":
            wav.write_iq_wav(rec["path"], data, self.cfg.sample_rate)
        else:
            wav.write_audio_wav(rec["path"], data, self.cfg.audio_rate)
        return rec["path"]

    def run(self, blocks: int) -> np.ndarray:
        """Run ``blocks`` iterations; returns concatenated audio [C, N]."""
        outs = []
        for _ in range(blocks):
            a = self.run_once()
            if a is not None:
                outs.append(a)
        if not outs:
            return np.zeros((self.chain.channels, 0), np.float32)
        return np.concatenate(outs, axis=-1)

    # ---- multi-RX audio routing / outputs --------------------------------
    def mix_stereo(self, audio: np.ndarray) -> np.ndarray:
        """Route per-channel audio [C, N] to a stereo pair [2, N] by each
        channel's play method (parity quisk.c:2601-2620: sub-RX audio to
        left, right, or both ears)."""
        out = np.zeros((2, audio.shape[-1]), np.float32)
        for c, route in enumerate(self.routes[: audio.shape[0]]):
            if self.channel_modes[c] == "DGT_IQ" or route == "off":
                continue
            if route in ("left", "both"):
                out[0] += audio[c]
            if route in ("right", "both"):
                out[1] += audio[c]
        return out

    def digital_output(self, channel: int) -> np.ndarray | None:
        """Latest raw I/Q block of a DGT-IQ channel (the per-sub-RX
        digital output device, quisk.c:2630-2652)."""
        return self._digital_out.get(channel)

    def multirx_graph(self) -> np.ndarray | None:
        """Latest spectrum rows for channels 1.. (get_multirx_graph
        parity, quisk.c:4868); None before the first refresh."""
        if not self.graph.waterfall:
            return None
        return self.graph.waterfall[-1][1:]

    # ---- transmit -------------------------------------------------------
    def enable_tx(self, tx_rate: float | None = None,
                  sidetone_level: float = 0.3, **tx_kwargs) -> None:
        """Attach a transmit chain + PTT controller.  TX then runs inside
        :meth:`run_once` (full duplex, keyed by PTT/CW/VOX/CAT) and is
        also callable directly via :meth:`transmit`."""
        from quisk_tpu_torch.app.cw import KeyEnvelope, Sidetone
        from quisk_tpu_torch.tx import TxChain, TxChainConfig
        from quisk_tpu_torch.tx.ptt import PttController, VoxControl
        # one TX block per RX block keeps the loop real-time balanced
        # (the reference's mic section consumes one mic block per sound
        # loop iteration, sound.c:1034)
        tx_kwargs.setdefault("audio_block", self.chain.block_audio)
        self.tx_config = TxChainConfig(
            channels=1, audio_rate=self.cfg.audio_rate,
            tx_rate=tx_rate or self.cfg.tx_rate, **tx_kwargs)
        self.tx = TxChain.create(self.tx_config, mode=int(self.cfg.modes()),
                                 device=self.device)
        self._tx_state = self.tx.init_state()
        if self.settings is not None:
            saved = self.settings.get_state().get("tx_ampl_phase")
            if saved:
                self.tx = self.tx.set_ampl_phase(saved[0], saved[1])
        self.ptt = PttController(self.cfg.audio_rate, self.tx.block,
                                 max_tx_secs=600.0)
        self.vox = VoxControl(self.cfg.audio_rate, self.tx.block)
        self.vox_enabled = False         # the VOX button (quisk.py VOX ctrl)
        self._cw_env = KeyEnvelope(self.cfg.audio_rate)
        # half-duplex audio switching (quisk.c:2371-2433): a 5 ms envelope
        # fades RX audio out on key-down and back in on key-up, and the
        # sidetone (sound.c:679) replaces it in CW modes
        self._rx_key_env = KeyEnvelope(self.cfg.audio_rate)
        self.sidetone = Sidetone(self.cfg.audio_rate,
                                 pitch_hz=self.rx_cfg.cw_pitch,
                                 level=sidetone_level)
        # DEBUG_MIC-style monitor (sound.c:886): keep RX audio live while
        # transmitting so you hear your own demodulated signal
        self.tx_monitor = False
        # per-family settings seeded from the built chain's config so a
        # mode change to an untouched family restores the configured values
        seed = {"clip_db": float(tx_kwargs.get("compress_db", 0.0)),
                "preemph": float(tx_kwargs.get("preemphasis", 0.0))}
        self.tx_audio = {f: dict(seed) for f in ("Usb", "Am", "Fm", "Fdv")}
        self._apply_tx_audio()
        self._update_tx_tune()           # soundcard radios / split TX

    def transmit(self, mic_block: np.ndarray, ptt: bool = False,
                 cw_key: bool = False) -> np.ndarray | None:
        """One TX block: mic [block] float -> IQ [block_tx] complex, or
        None when not keyed (VOX/PTT/failsafes decide)."""
        ptt = ptt or self.cat_ptt        # T 1 from a CAT client
        vox = self.vox.process(mic_block) and self.vox_enabled
        if not self.ptt.process(ptt=ptt, cw_key=cw_key, vox=vox):
            return None
        self.hw.OnButtonPTT(True)
        iq = self._run_tx_block(mic_block, cw_key)
        self._send_tx_iq(iq)
        return iq

    def _run_tx_block(self, mic_block: np.ndarray, cw_key: bool) -> np.ndarray:
        """mic [block] -> IQ [block_tx] through the TX chain; in CW modes
        the chain's audio input is the key envelope, shaped with the 5 ms
        raised-cosine ramps (quisk.c:2386/2408) so the keyed carrier never
        clicks."""
        if self.cfg.mode in ("CWU", "CWL"):
            key = np.full(self.tx.block, 1.0 if cw_key else 0.0, np.float32)
            mic_block = self._cw_env.process(key)
        a = torch.as_tensor(np.asarray(mic_block, np.float32)[None],
                            device=self.device)
        self._tx_state, iq = self.tx.step(self._tx_state, a)
        return iq[0].cpu().numpy()

    def _send_tx_iq(self, iq: np.ndarray) -> None:
        """Hand one transmitted IQ block to the hardware plugin (the TX
        half of the sound loop, sound.c:1151-1186: play_samples /
        tx_udp send) and remember it for taps/tests."""
        self.tx_iq_last = iq
        w = getattr(self.hw, "write_samples", None)
        if w is not None:
            w(iq)

    # ---- full-duplex key polling + audio switching -----------------------
    def set_ptt(self, pressed: bool) -> None:
        """The PTT button (quisk.py OnButtonPTT): keys the next loop
        iterations until released."""
        self.manual_ptt = bool(pressed)

    def set_cw_key(self, down: bool) -> None:
        """A host-driven CW key (remote/MIDI keyers enter here)."""
        self.manual_key = bool(down)

    def set_vox(self, enabled: bool, threshold: float | None = None,
                hold_secs: float | None = None) -> None:
        """The VOX button + level controls (quisk.py VOX button,
        microphone.c:1150-1175): when enabled, mic level keys the TX."""
        self.vox_enabled = bool(enabled)
        if threshold is not None:
            self.vox.threshold = float(threshold)
        if hold_secs is not None:
            self.vox.hold_blocks = max(1, int(round(
                hold_secs * self.cfg.audio_rate / self.tx.block)))

    def _poll_tx_keys(self):
        """Combine every key source into this iteration's TX decision:
        -> (keyed, cw_key, mic_block|None).  Mirrors the reference's key
        polling at the top of the sound loop (sound.c:898-920 +
        quisk_is_key_down)."""
        if self.tx is None:
            return False, False, None
        if self.mic is not None:
            mic = self.mic.get(self.tx.block)
        else:
            mic = np.zeros(self.tx.block, np.float32)
        cw_key = self.manual_key
        ptt = self.manual_ptt or self.cat_ptt
        vox = self.vox.process(mic) and self.vox_enabled
        keyed = self.ptt.process(ptt=ptt, cw_key=cw_key, vox=vox)
        if keyed != self._keyed:
            self.hw.OnButtonPTT(keyed)   # T/R switch (quisk.py:6695)
            self._keyed = keyed
        return keyed, cw_key, mic

    def _duplex_audio(self, audio: np.ndarray, keyed: bool, cw_key: bool,
                      mic: np.ndarray | None) -> np.ndarray:
        """The TX half of one loop iteration: fade RX audio out/in with
        the 5 ms key envelope, substitute the CW sidetone, and while keyed
        run mic -> TX chain -> hardware IQ (quisk.c:2371-2433 sidetone/
        silence substitution; 2711-2738 keyup envelope; sound.c:1034-1186
        mic section)."""
        if keyed:
            self._send_tx_iq(self._run_tx_block(mic, cw_key))
        if self.tx_monitor:              # DEBUG_MIC: hear your own TX
            return audio
        n = audio.shape[-1]
        key_wave = np.full(n, 1.0 if keyed else 0.0, np.float32)
        env = self._rx_key_env.process(key_wave)
        if env.max() > 0.0:              # keyed or still ramping back
            audio = audio * (1.0 - env)[None, :]
            if self.cfg.mode in ("CWU", "CWL") and self.sidetone.level > 0:
                st_wave = np.full(n, 1.0 if cw_key else 0.0, np.float32)
                audio[0] += env * self.sidetone.process(st_wave)
        return audio

    # ---- PureSignal closed loop -----------------------------------------
    def calibrate_puresignal(self, pa, iterations: int = 2,
                             blocks: int = 4) -> "object":
        """Close the adaptive-predistortion loop (wdsp/calcc.c flow,
        microphone.c:1581 PreDistort): drive the TX chain through ``pa``
        (the PA or its feedback tap, ``iq -> iq`` on host numpy), compare
        the feedback against an undistorted reference run of the same
        chain, refine the predistorter and install it as DATA on the
        running TxChain.  Requires ``enable_tx(predistort=True)``.

        Calibrate in Mode.IMD (the chain then generates the standard
        two-tone test internally, like the reference's IMD TX mode).
        Returns the new Predistorter (already installed).
        """
        if self.tx is None or self.tx.predist is None:
            raise RuntimeError("enable_tx(predistort=True) first")
        # reference chain: identical but with the correction disabled
        tx_ref = dataclasses.replace(self.tx, predist=None)
        audio = torch.zeros((self.tx.channels, self.tx.block),
                            dtype=torch.float32, device=self.device)
        pd = self.tx.predist
        for _ in range(iterations):
            st_r, st_d = tx_ref.init_state(), self.tx.init_state()
            refs, fbs = [], []
            for _ in range(blocks):
                st_r, iq_ref = tx_ref.step(st_r, audio)
                st_d, iq_d = self.tx.step(st_d, audio)
                refs.append(iq_ref[0].cpu().numpy())
                fbs.append(np.asarray(pa(iq_d[0].cpu().numpy())))
            pd = pd.refine(np.concatenate(refs), np.concatenate(fbs))
            self.tx = dataclasses.replace(self.tx, predist=pd)
        self._tx_state = self.tx.init_state()
        return pd

    # ---- displays -------------------------------------------------------
    def smeter_db(self) -> float:
        lo, hi = -3000.0, 3000.0
        return float(self.graph.smeter_dbfs(self.cfg.tune_hz + lo,
                                            self.cfg.tune_hz + hi)[0])

    def set_graph_window(self, window: str) -> None:
        """Switch the spectrum analysis window (rect/hann/hamming/
        blackman/blackman-harris/flat-top) on the live graph — data only,
        the S-meter's leakage correction follows the window
        (quisk.c:5212/5311; wdsp/analyzer.c window table)."""
        self.graph.set_window(window)
        self.cfg.graph_window = window

    # ---- multi-resolution zoom (wdsp/analyzer.c span management) ---------
    def set_zoom(self, zoom: float, center_hz: float | None = None) -> None:
        """UI zoom control.  Past the base FFT's resolution limit
        (fft_size/pixels), pixel re-binning only interpolates — so the
        radio engages a :class:`~quisk_tpu_torch.ops.spectrum.ZoomSpectrum`
        re-capture of the view (mix to the view center, lowpass decimate,
        re-FFT) whose rows genuinely resolve ``decim`` times finer.

        Thread-safe by STAGING: this may be called from a server thread,
        so it only records the request; the radio loop applies it between
        blocks."""
        self._zoom_req = (float(zoom),
                          float(center_hz) if center_hz is not None
                          else None)

    def _apply_zoom_req(self) -> None:
        """Radio-thread application of the staged zoom request, plus
        re-derivation when the VFO moved (the capture NCO mixes a
        vfo-RELATIVE offset — after a retune the old offset would show
        a shifted band under stale labels)."""
        from quisk_tpu_torch.ops.spectrum import ZoomSpectrum

        req = getattr(self, "_zoom_req", None)
        cap = getattr(self, "_zoomcap", None)
        if req is None and (cap is None
                            or getattr(self, "_zoom_vfo", None)
                            == self.vfo_hz):
            return
        if req is not None:
            self.ui_zoom, center = req
            self.ui_zoom_center = (center if center is not None
                                   else self.vfo_hz)
            self._zoom_req = None
        zoom = self.ui_zoom
        fs = self.cfg.sample_rate
        self._zoom_vfo = self.vfo_hz
        native_limit = self.graph.sa.fft_size / self.graph.pixels
        fft_z = 512
        block = self.chain.block_in
        # decim must stay <= zoom so the re-captured span fs/decim COVERS
        # the displayed window fs/zoom (a larger decim would leave the
        # outer pixels as edge-clamped fabrication), and decim*fft_z must
        # beat the base FFT or the re-capture adds nothing
        cands = [d for d in (2, 4, 8, 16, 32, 64, 128, 256, 512)
                 if block % d == 0 and (block // d) % fft_z == 0
                 and d <= zoom and d * fft_z > self.graph.sa.fft_size]
        if zoom <= max(1.0, native_limit) or not cands:
            self._zoomcap = None
            return
        decim = max(cands)
        center_bb = self.ui_zoom_center - self.vfo_hz   # baseband offset
        zs = ZoomSpectrum.create(fft_z, block, center_hz=center_bb,
                                 sample_rate=fs, decim=decim, overlap=0.5,
                                 device=self.device)
        # fresh state on every engage/pan/retune: the decimator history
        # and running average hold the OLD passband — blending them into
        # the new view would show wrong data under the new labels
        self._zoomcap = (zs, zs.init_state(1))

    def _zoom_trace(self):
        """(start_hz, bin_hz, row[pixels]) of the re-captured zoom view,
        or None until the zoomed average has data."""
        cap = getattr(self, "_zoomcap", None)
        if cap is None:
            return None
        zs, st = cap
        if float(st[2][1]) < 1.0:
            return None
        fs = self.cfg.sample_rate
        db = zs.graph_db(st)[0].cpu().numpy()
        f = zs.freqs(fs, center_hz=self.ui_zoom_center)   # absolute Hz
        span = fs / self.ui_zoom
        lo = self.ui_zoom_center - 0.5 * span
        px = self.graph.pixels
        xi = lo + (np.arange(px) + 0.5) * (span / px)
        row = np.interp(xi, f, db).astype(np.float32)
        self._zoomcap = (zs, (st[0], st[1], zs.an.reset(st[2])))
        return lo, span / px, row
