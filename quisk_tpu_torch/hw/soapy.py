"""Generic SoapySDR hardware plugin.

Parity: soapypkg/quisk_hardware.py (161 LoC) + soapypkg/soapy.c — the
reference drives any SoapySDR-supported radio through a small parameter
surface: ``soapy_setAntenna_rx/tx``, ``soapy_setSampleRate_rx/tx`` and
``soapy_setBandwidth_rx/tx`` (config values in kHz, applied in Hz),
``soapy_setFrequency_rx/tx`` with a transverter offset subtracted
(quisk_hardware.py:85-91), and three gain modes (:62-81): ``automatic``
(AGC on), ``total`` (one overall dB value), ``detailed`` (per-element
dB values, skipping the synthetic 'total' element).

Here the same surface against an injected ``device`` exposing the
SoapySDR Device API subset (setAntenna/setSampleRate/setBandwidth/
setFrequency/setGainMode/setGain/setGainElement/readStream) — a real
deployment passes ``SoapySDR.Device(...)`` (gated import below), tests
inject a double.  RX samples arrive from ``readStream`` as interleaved
CF32, converted to the framework's [n_rx, n] complex64 pull API.
"""

from __future__ import annotations

import numpy as np

from quisk_tpu_torch.hw.base import Hardware, register_hardware

try:                                   # optional dependency, never required
    import SoapySDR as _soapysdr       # pragma: no cover
except ImportError:
    _soapysdr = None


def open_soapy_device(args: str):
    """Real-device constructor (reference soapy.c open_device)."""
    if _soapysdr is None:
        raise RuntimeError("SoapySDR module not available")
    return _soapysdr.Device(args)      # pragma: no cover


@register_hardware("soapy")
class SoapyHardware(Hardware):
    """Any SoapySDR radio; ``device`` is injected (see module docstring)."""

    RX, TX = 0, 1                      # SOAPY_SDR_RX / _TX direction codes

    def __init__(self, conf=None, device=None, enable_tx: bool = False,
                 transverter_offset: float = 0.0):
        super().__init__(conf)
        self.device = device
        self.enable_tx = enable_tx
        self.transverter_offset = float(transverter_offset)
        self.fVFO = 0.0                # float VFO (quisk_hardware.py:23)
        self.rx_rate = 48000.0
        self._stream = None
        self._rxbuf = np.zeros(0, np.complex64)

    # ---- parameter surface ----------------------------------------------
    def _apply(self, settings: dict) -> None:
        """Apply a soapy_* settings dict (the reference's radio_dict keys,
        kHz string values for rates/bandwidths)."""
        d = self.device
        if d is None:
            return
        for rxtx, direction in (("_rx", self.RX), ("_tx", self.TX)):
            if direction == self.TX and not self.enable_tx:
                continue
            ant = settings.get("soapy_setAntenna" + rxtx, "")
            if ant:
                d.setAntenna(direction, 0, ant)
            for name, setter in (("soapy_setSampleRate", d.setSampleRate),
                                 ("soapy_setBandwidth", d.setBandwidth)):
                value = settings.get(name + rxtx, "")
                try:
                    hz = float(value) * 1e3          # config keys are kHz
                except (TypeError, ValueError):
                    continue
                setter(direction, 0, hz)
                if name == "soapy_setSampleRate" and rxtx == "_rx":
                    self.rx_rate = hz
            self._apply_gain(settings, rxtx, direction)

    def _apply_gain(self, settings: dict, rxtx: str, direction: int) -> None:
        d = self.device
        mode = settings.get("soapy_gain_mode" + rxtx, "total")
        values = settings.get("soapy_gain_values" + rxtx, {})
        if mode == "automatic":
            d.setGainMode(direction, 0, True)
        elif mode == "total":
            d.setGainMode(direction, 0, False)
            d.setGain(direction, 0, float(values.get("total", 0)))
        elif mode == "detailed":
            d.setGainMode(direction, 0, False)
            for name, gain in values.items():
                if name == "total":    # synthetic element, skip (:77-78)
                    continue
                d.setGainElement(direction, 0, name, float(gain))

    def open(self) -> str:
        if self.device is None:
            return "Soapy module not available"      # quisk_hardware.py:35
        if self.conf is not None:
            self._apply(getattr(self.conf, "soapy_settings", {}) or {})
        self.status_text = "SoapySDR device"
        return self.status_text

    def close(self) -> None:
        if self.device is not None and self._stream is not None:
            self.device.deactivateStream(self._stream)
            self._stream = None

    def ChangeFrequency(self, tx_freq, vfo_freq, source="", band=""):
        d = self.device
        fvfo = float(vfo_freq - self.transverter_offset)
        if d is not None:
            if fvfo != self.fVFO:
                self.fVFO = fvfo
                d.setFrequency(self.RX, 0, fvfo)
            if self.enable_tx:
                d.setFrequency(self.TX, 0,
                               float(tx_freq - self.transverter_offset))
        return super().ChangeFrequency(tx_freq, vfo_freq, source, band)

    def ReturnVfoFloat(self) -> float:
        return self.fVFO

    def VarDecimGetChoices(self) -> list[int]:
        return []              # rate comes from SoapySDR config (:146-148)

    def VarDecimSet(self, index: int) -> float:
        return float(self.rx_rate)

    # ---- sample plane -----------------------------------------------------
    def StartSamples(self) -> None:
        d = self.device
        if d is not None:
            self._stream = d.setupStream(self.RX, "CF32")
            d.activateStream(self._stream)

    def read_samples(self, n: int) -> np.ndarray | None:
        """Exactly ``n`` samples as [1, n], buffering short reads, or None
        until enough arrived (Radio.run_once's jitted step is compiled for
        a fixed block shape).  ``readStream`` may return an int count (the
        test double / an adapter) or a SoapySDR ``StreamResult`` whose
        ``ret`` field is the count or a negative error code."""
        d = self.device
        if d is None or self._stream is None:
            return None
        while len(self._rxbuf) < n:
            buf = np.empty(n, np.complex64)
            res = d.readStream(self._stream, buf, n)
            got = int(getattr(res, "ret", res))
            if got <= 0:
                break
            self._rxbuf = (np.concatenate([self._rxbuf, buf[:got]])
                           if len(self._rxbuf) else buf[:got].copy())
        if len(self._rxbuf) < n:
            return None
        out, self._rxbuf = self._rxbuf[:n], self._rxbuf[n:]
        return out[None]
