"""Graph/waterfall data service — the ``get_graph`` equivalent.

Parity: quisk.c:5142 ``get_graph``: accumulate windowed FFTs, every
``1/graph_refresh`` seconds emit an averaged dB trace re-binned to display
pixels, plus the S-meter for the tuned passband; waterfall rows are the
same trace quantised to a palette (the reference keeps an RGB row buffer in
C, quisk.c:5334 — here rows are just arrays for any frontend to render).

The spectrum services run on the device of the chain they serve: a block
that is already on the card is analysed there, and only the display rows
come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.spectrum import SpectrumAnalyzer, rebin_pixels


class GraphService:
    """Stateful wrapper: feed IQ blocks, poll dB traces (host numpy)."""

    def __init__(self, fft_size: int, block: int, channels: int,
                 sample_rate: float, pixels: int = 1024,
                 refresh_hz: float = 7.0, window: str = "hann",
                 overlap: float = 0.0, device=None):
        self.device = resolve_device(device)
        self.sa = SpectrumAnalyzer.create(fft_size, block, window=window,
                                          overlap=overlap, device=self.device)
        self.state = self.sa.init_state(channels)
        self.sample_rate = sample_rate
        self.pixels = pixels
        self.blocks_per_refresh = max(
            1, int(round(sample_rate / block / refresh_hz)))
        self._since_refresh = 0
        self.waterfall: list[np.ndarray] = []
        self.max_waterfall_rows = 512

    def feed(self, iq_block) -> np.ndarray | None:
        """Accumulate one [C, block] IQ block (a tensor, or host numpy moved
        to the service's device); returns a [C, pixels] dB trace when a
        refresh interval has elapsed, else None."""
        self.state, _ = self.sa.accumulate(
            self.state, torch.as_tensor(iq_block, device=self.device))
        self._since_refresh += 1
        if self._since_refresh < self.blocks_per_refresh:
            return None
        trace = rebin_pixels(self.sa.graph_db(self.state),
                             self.pixels).cpu().numpy()
        self._last_full = self.state       # S-meter reads stay valid
        self.state = self.sa.reset(self.state)
        self._since_refresh = 0
        self.waterfall.append(trace)
        if len(self.waterfall) > self.max_waterfall_rows:
            self.waterfall.pop(0)
        return trace

    def set_window(self, window: str) -> None:
        """Swap the analysis window live (data only — same compiled
        accumulate program; wdsp/analyzer.c window option).  The running
        average restarts: mixing windows in one accumulation would blur
        the leakage correction."""
        self.sa = self.sa.with_window(window)
        self.state = self.sa.reset(self.state)
        self._last_full = None
        self._since_refresh = 0

    def smeter_dbfs(self, f_lo, f_hi) -> np.ndarray:
        """Current S-meter power (dBFS) per channel for [f_lo, f_hi].
        Right after a refresh the live accumulator is empty; fall back to
        the last full interval so meters never read the reset state."""
        state = self.state
        if float(state[1]) < 1.0 and getattr(self, "_last_full", None) is not None:
            state = self._last_full
        p = self.sa.smeter_power(state, self.sample_rate, f_lo, f_hi)
        return (10.0 * torch.log10(p + 1e-20)).cpu().numpy()

    def freqs(self) -> np.ndarray:
        return self.sa.freqs(self.sample_rate)


# ------------------------------------------------------------- waterfall
def waterfall_palette(n: int = 256) -> np.ndarray:
    """[n, 3] uint8 palette, black->blue->green->yellow->red->white (the
    reference's default waterfall color ramp, quisk.c watfall_RgbData)."""
    stops = np.array([[0, 0, 0], [0, 0, 160], [0, 160, 160], [0, 200, 0],
                      [230, 230, 0], [240, 0, 0], [255, 255, 255]],
                     np.float64)
    pos = np.linspace(0.0, 1.0, len(stops))
    t = np.linspace(0.0, 1.0, n)
    rgb = np.stack([np.interp(t, pos, stops[:, c]) for c in range(3)], axis=1)
    return rgb.astype(np.uint8)


class WaterfallRenderer:
    """dB rows -> scrolling RGB pixel rows (parity quisk.c:5334-5480:
    C-side circular RGB row buffer with palette mapping and scroll).

    Rows are stored newest-first; :meth:`pixels` returns [rows, pixels, 3]
    uint8 ready for any frontend.
    """

    def __init__(self, pixels: int, rows: int = 256,
                 floor_db: float = -140.0, range_db: float = 80.0):
        self.palette = waterfall_palette()
        self.rows = rows
        self.floor_db = floor_db
        self.range_db = range_db
        self.buf = np.zeros((rows, pixels, 3), np.uint8)
        self._count = 0

    def add_row(self, db_row: np.ndarray) -> None:
        idx = np.clip((np.asarray(db_row) - self.floor_db) / self.range_db
                      * 255.0, 0.0, 255.0).astype(np.uint8)
        self.buf = np.roll(self.buf, 1, axis=0)
        self.buf[0] = self.palette[idx]
        self._count = min(self._count + 1, self.rows)

    def pixels(self) -> np.ndarray:
        return self.buf[: self._count]


# ------------------------------------------------------------ scan mode
class ScanStitcher:
    """Stitch successive frequency blocks into one wide spectrum (parity
    quisk.c:5194-5198, 5246-5266 'scan mode': the VFO steps across a wide
    span; each dwell contributes the valid fraction of its FFT; segments
    are concatenated into one trace).
    """

    def __init__(self, n_blocks: int, pixels_per_block: int,
                 valid_fraction: float = 0.84):
        self.n_blocks = n_blocks
        self.ppb = pixels_per_block
        self.valid = valid_fraction
        self.trace = np.full((n_blocks, pixels_per_block), -180.0)
        self.filled = np.zeros(n_blocks, bool)

    def add_block(self, index: int, db_pixels: np.ndarray) -> None:
        """db_pixels: [P] full-span pixels for VFO step `index`; only the
        central valid fraction is kept (filter skirts trimmed)."""
        P = len(db_pixels)
        keep = int(P * self.valid)
        lo = (P - keep) // 2
        seg = db_pixels[lo: lo + keep]
        # resample the kept segment onto this block's pixel slots
        xi = np.linspace(0, keep - 1, self.ppb)
        self.trace[index] = np.interp(xi, np.arange(keep), seg)
        self.filled[index] = True

    def complete(self) -> bool:
        return bool(self.filled.all())

    def spectrum(self) -> np.ndarray:
        """[n_blocks * pixels_per_block] stitched wide trace."""
        return self.trace.reshape(-1)


# ------------------------------------------------------------- bandscope
class BandscopeService:
    """Wideband raw-ADC spectrum (parity quisk.c:2875/2959/4957: Hermes
    EP4 frames -> window+FFT+average -> zoomed pixels).  Real input (raw
    ADC), rFFT, running average, same palette/zoom machinery as the graph.
    """

    def __init__(self, fft_size: int, clock_hz: float, pixels: int = 1024):
        self.fft = fft_size
        self.clock = clock_hz
        self.pixels = pixels
        self.window = np.hanning(fft_size)
        self.accum = np.zeros(fft_size // 2 + 1)
        self.count = 0
        self._tail = np.zeros(0)

    def add_samples(self, adc: np.ndarray) -> None:
        buf = np.concatenate([self._tail, np.asarray(adc, np.float64)])
        n = len(buf) // self.fft * self.fft
        self._tail = buf[n:]             # carry partial frames (EP4 packets
        if n == 0:                       # are much smaller than the FFT)
            return
        frames = buf[:n].reshape(-1, self.fft) * self.window
        S = np.abs(np.fft.rfft(frames, axis=-1)) ** 2
        self.accum += S.sum(axis=0)
        self.count += S.shape[0]

    def spectrum_db(self, zoom: float = 1.0,
                    center_frac: float = 0.5) -> np.ndarray | None:
        """[pixels] averaged dB trace over [0, clock/2], or None if empty."""
        if not self.count:
            return None
        # full-scale sine reads 0 dB: each frame's peak |rfft| is
        # A * sum(hann)/2 = A * fft/4, power accumulates linearly in count
        scale = self.count * (self.fft / 4.0) ** 2
        db = 10.0 * np.log10(self.accum / scale + 1e-30)
        F = len(db)
        span = max(int(F / zoom), self.pixels)
        lo = int(np.clip(center_frac * F - span / 2, 0, F - span))
        seg = db[lo: lo + span]
        edges = np.linspace(0, len(seg), self.pixels + 1).astype(int)
        out = np.array([seg[a:b].max() if b > a else seg[min(a, len(seg)-1)]
                        for a, b in zip(edges[:-1], edges[1:])])
        self.accum[:] = 0.0
        self.count = 0
        return out

    def freqs(self) -> np.ndarray:
        return np.linspace(0.0, self.clock / 2.0, self.pixels)


class ScanController:
    """Drives scan mode: steps the hardware VFO across a wide span, feeds
    each dwell's spectrum into a :class:`ScanStitcher` (parity quisk.c
    ``change_scan``/scan state 139-143: the reference's GUI steps the VFO
    and stitches blocks the same way)."""

    def __init__(self, hardware, stitcher: ScanStitcher,
                 start_hz: float, stop_hz: float, sample_rate: float,
                 valid_fraction: float = 0.84):
        self.hw = hardware
        self.st = stitcher
        self.fs = sample_rate
        step = sample_rate * valid_fraction
        self.centers = [start_hz + step * (k + 0.5)
                        for k in range(stitcher.n_blocks)]
        if self.centers[-1] - step / 2 > stop_hz:
            raise ValueError("stitcher block count exceeds the span")
        self.index = 0
        self._retune()

    def _retune(self):
        c = self.centers[self.index]
        self.hw.ChangeFrequency(int(c), int(c), source="scan")

    def feed(self, db_pixels: np.ndarray) -> np.ndarray | None:
        """Feed the current dwell's spectrum; steps the VFO; returns the
        stitched wide trace when a full sweep completes."""
        self.st.add_block(self.index, db_pixels)
        self.index = (self.index + 1) % self.st.n_blocks
        self._retune()
        if self.index == 0 and self.st.complete():
            return self.st.spectrum()
        return None

    def freqs(self) -> np.ndarray:
        span = self.fs * 0.84 * self.st.n_blocks
        f0 = self.centers[0] - self.fs * 0.84 / 2
        return f0 + np.arange(self.st.n_blocks * self.st.ppb) \
            * span / (self.st.n_blocks * self.st.ppb)


def measure_audio_rms(audio: np.ndarray) -> np.ndarray:
    """RMS audio level per channel (parity quisk.c:3193 measure_audio /
    2155-2158 audio power metering)."""
    a = np.asarray(audio)
    return np.sqrt(np.mean(a * a, axis=-1))


# ------------------------------------------------------ scope / filter / audio
class ScopeService:
    """Raw-sample oscilloscope trace (parity quisk.py:3389 ScopeScreen:
    the debug time-domain view of the capture stream).

    ``capture`` maps one IQ block to display-width I and Q traces; the
    zoom control widens the time window by powers of two (more samples
    per pixel, peak-decimated so narrow pulses stay visible).
    """

    def __init__(self, width: int = 1024):
        self.width = width

    def capture(self, iq_block, channel: int = 0, zoom: int = 0):
        x = np.asarray(iq_block)
        if x.ndim == 2:
            x = x[channel]
        span = min(len(x), self.width << max(0, int(zoom)))
        x = x[:span]
        stride = max(1, span // self.width)
        n = (len(x) // stride) * stride
        seg = x[:n].reshape(-1, stride)
        # keep the absolute-peak sample of each pixel's bucket
        idx = np.argmax(np.abs(seg), axis=1)
        pick = seg[np.arange(len(seg)), idx]
        return {"i": np.real(pick).astype(np.float32),
                "q": np.imag(pick).astype(np.float32),
                "samples_per_pixel": stride}


def filter_response(bp, sample_rate: float, channel: int = 0,
                    points: int = 2048) -> dict:
    """RX channel-filter frequency response + 3/6 dB bandwidths (parity
    quisk.py:3570 FilterScreen.NewFilter: QS.get_filter + the two
    max-minus-3-dB span sweeps).

    ``bp`` is the chain's OverlapSaveFIR; its frequency mask IS the
    response, so no extra FFT of taps is needed — just re-grid to the
    display width.
    """
    mask = bp.mask.cpu().numpy()
    if mask.ndim == 2:
        mask = mask[channel]
    h = np.fft.fftshift(mask)
    db = 20.0 * np.log10(np.abs(h) + 1e-12)
    f = np.fft.fftshift(np.fft.fftfreq(bp.nfft, 1.0 / sample_rate))
    xi = np.linspace(0, len(db) - 1, points)
    db_r = np.interp(xi, np.arange(len(db)), db)
    f_r = np.interp(xi, np.arange(len(f)), f)

    def bw(down_db):
        th = db_r.max() - down_db
        on = np.nonzero(db_r > th)[0]
        return float(f_r[on[-1]] - f_r[on[0]]) if len(on) else 0.0

    return {"freqs_hz": f_r.astype(np.float64), "db": db_r,
            "bw3_hz": bw(3.0), "bw6_hz": bw(6.0)}


class AudioFFTService:
    """FFT graph of (TX or RX) audio (parity quisk.py:3617
    AudioFFTScreen).  Same accumulate/refresh pattern as GraphService but
    for real audio blocks; the spectrum is one-sided."""

    def __init__(self, fft_size: int, block: int, sample_rate: float,
                 channels: int = 1, refresh_hz: float = 7.0, device=None):
        self.device = resolve_device(device)
        self.sa = SpectrumAnalyzer.create(fft_size, block, device=self.device)
        self.state = self.sa.init_state(channels)
        self.sample_rate = sample_rate
        self.blocks_per_refresh = max(
            1, int(round(sample_rate / block / refresh_hz)))
        self._since = 0

    def feed(self, audio_block) -> np.ndarray | None:
        """[C, block] real audio; returns [C, fft_size//2] dB (0..fs/2)
        each refresh interval, else None."""
        x = torch.as_tensor(np.asarray(audio_block, np.float32),
                            device=self.device)
        self.state, _ = self.sa.accumulate(self.state,
                                           x.to(torch.complex64))
        self._since += 1
        if self._since < self.blocks_per_refresh:
            return None
        full = self.sa.graph_db(self.state).cpu().numpy()  # fftshifted
        self.state = self.sa.reset(self.state)
        self._since = 0
        return full[:, full.shape[1] // 2:]               # positive half
