"""The port's spectrum services against the JAX package's on the same numpy
IQ (float32 on the CPU, torch on one thread): the averaged power of every
window, disjoint and at overlap 0.5, >= 100 dB; the S-meter and the
measured frequency within float32 of the JAX results; the pixel re-binning
equal; the zoom re-capture against the JAX one and resolving two tones a
third of a base bin apart (tests/test_spectrum.py:189)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.io import sources
from quisk_tpu.ops import spectrum as jspec

from quisk_tpu_torch import convert
from quisk_tpu_torch.ops import spectrum as spec

CPU = "cpu"
FS = 48000.0
L, B = 256, 2048
WINDOWS = ["rect", "hann", "hamming", "blackman", "blackman-harris",
           "flat-top"]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return 10 * np.log10(np.sum(ref ** 2) / (np.sum(err ** 2) + 1e-300))


def iq_blocks(C, nblk, seed):
    """Tones at per-channel offsets over low noise."""
    rng = np.random.default_rng(seed)
    n = nblk * B
    f = np.array([1500.0, -7300.0, 11000.0, 333.3])[:C]
    t = np.arange(n) / FS
    x = np.exp(2j * np.pi * f[:, None] * t) * np.array(
        [1.0, 0.3, 0.05, 0.8])[:C, None]
    x = x + 1e-3 * (rng.standard_normal((C, n))
                    + 1j * rng.standard_normal((C, n)))
    return x.astype(np.complex64)


def run(jan, an, x):
    jst, pst = jan.init_state(x.shape[0]), an.init_state(x.shape[0])
    for i in range(x.shape[-1] // an.block):
        a = np.ascontiguousarray(x[:, i * an.block:(i + 1) * an.block])
        jst, _ = jan.accumulate(jst, jnp.asarray(a))
        pst, _ = an.accumulate(pst, torch.as_tensor(a))
    return jst, pst


@pytest.mark.parametrize("overlap", [0.0, 0.5])
@pytest.mark.parametrize("window", WINDOWS)
def test_power_matches_jax(window, overlap):
    x = iq_blocks(4, 3, 1)
    jan = jspec.SpectrumAnalyzer.create(L, B, window=window, overlap=overlap)
    an = spec.SpectrumAnalyzer.create(L, B, window=window, overlap=overlap,
                                      device=CPU)
    assert an.hop == jan.hop
    assert np.array_equal(an.window.numpy(), np.asarray(jan.window))
    assert float(an.enbw_bins) == float(jan.enbw_bins)
    jst, pst = run(jan, an, x)
    jp, pp = np.asarray(jan.power(jst)), an.power(pst).numpy()
    for c in range(4):
        assert snr_db(jp[c], pp[c]) >= 100.0, (window, c)
    jdb, pdb = np.asarray(jan.graph_db(jst)), an.graph_db(pst).numpy()
    assert np.max(np.abs(jdb - pdb)[jp > 1e-12 * jp.max()]) < 1e-3
    lo, hi = [1000.0, -8000.0, 10000.0, 0.0], [2000.0, -6000.0, 12000.0, 700.0]
    js = np.asarray(jan.smeter_power(jst, FS, np.asarray(lo), np.asarray(hi)))
    ps = an.smeter_power(pst, FS, lo, hi).numpy()
    assert np.allclose(ps, js, rtol=1e-5, atol=0)
    assert np.array_equal(an.freqs(FS), jan.freqs(FS))


def test_state_converts_and_streams_on():
    x = iq_blocks(3, 4, 2)
    jan = jspec.SpectrumAnalyzer.create(L, B, window="blackman-harris",
                                        overlap=0.5)
    an = convert.spectrum_from_numpy(
        {"window": np.asarray(jan.window), "enbw_bins": jan.enbw_bins,
         "block": jan.block, "hop": jan.hop}, device=CPU)
    jst = jan.init_state(3)
    for i in range(2):
        jst, _ = jan.accumulate(jst, jnp.asarray(x[:, i * B:(i + 1) * B]))
    pst = convert.spectrum_state_from_numpy(tuple(np.asarray(s) for s in jst),
                                            device=CPU)
    assert pst[2].dtype == torch.complex64
    back = convert.spectrum_state_to_numpy(pst)
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(back, jst))
    for i in range(2, 4):
        a = x[:, i * B:(i + 1) * B]
        jst, _ = jan.accumulate(jst, jnp.asarray(a))
        pst, _ = an.accumulate(pst, torch.as_tensor(a))
    jp, pp = np.asarray(jan.power(jst)), an.power(pst).numpy()
    assert min(snr_db(jp[c], pp[c]) for c in range(3)) >= 100.0


def test_with_window_and_reset():
    x = iq_blocks(2, 2, 3)
    an = spec.SpectrumAnalyzer.create(L, B, overlap=0.5, device=CPU)
    st, _ = an.accumulate(an.init_state(2), torch.as_tensor(x[:, :B]))
    ft = an.with_window("flat-top")
    assert ft.window.shape == an.window.shape
    assert float(ft.enbw_bins) == pytest.approx(3.77, abs=0.01)
    st2, _ = ft.accumulate(st, torch.as_tensor(x[:, B:]))
    r = ft.reset(st2)
    assert float(r[1]) == 0.0 and float(r[0].abs().max()) == 0.0
    assert torch.equal(r[2], st2[2])           # samples kept
    # a full-scale tone reads 0 dBFS and its S-meter power 1 for every
    # window (the ENBW travels with the window)
    tone = sources.tone(6000.0, FS, B).astype(np.complex64)[None]
    for w in WINDOWS:
        a = an.with_window(w)
        s, _ = a.accumulate(a.init_state(1), torch.as_tensor(tone))
        assert abs(float(a.graph_db(s).max())) < 4.0, w
        assert abs(float(a.smeter_power(s, FS, 5000.0, 7000.0)[0]) - 1.0
                   ) < 0.05, w


def test_measure_frequency_matches_jax():
    x = iq_blocks(4, 1, 4)
    jf = np.asarray(jspec.measure_frequency(jnp.asarray(x), FS))
    pf = spec.measure_frequency(torch.as_tensor(x), FS).numpy()
    assert np.allclose(pf, jf, rtol=0, atol=1e-3), (pf, jf)
    assert np.allclose(pf, [1500.0, -7300.0, 11000.0, 333.3], atol=2.0)


@pytest.mark.parametrize("zoom,center", [(1.0, 0.0), (4.0, 0.1),
                                         (16.0, -0.3), (2.5, 0.45)])
def test_rebin_equals_jax(zoom, center):
    rng = np.random.default_rng(5)
    db = rng.standard_normal((3, 1024)).astype(np.float32)
    want = np.asarray(jspec.rebin_pixels(jnp.asarray(db), 200, zoom, center))
    got = spec.rebin_pixels(torch.as_tensor(db), 200, zoom, center).numpy()
    assert np.array_equal(got, want)
    f = np.fft.fftshift(np.fft.fftfreq(1024, 1 / FS))
    assert np.array_equal(spec.rebin_freqs(f, 200, zoom, center),
                          jspec.rebin_freqs(f, 200, zoom, center))


def test_zoom_spectrum_matches_jax_and_resolves_sub_bin_tones():
    fs = 256000.0
    Lz, Bz = 256, 8192
    f1, f2 = 20000.0, 20000.0 + fs / Lz / 3.0
    n = 8 * Bz
    x = (sources.tone(f1, fs, n) + sources.tone(f2, fs, n)
         ).astype(np.complex64)[None]
    base = spec.SpectrumAnalyzer.create(Lz, Bz, device=CPU)
    zm = spec.ZoomSpectrum.create(Lz, Bz, center_hz=20000.0, sample_rate=fs,
                                  decim=16, overlap=0.5, device=CPU)
    jzm = jspec.ZoomSpectrum.create(Lz, Bz, center_hz=20000.0,
                                    sample_rate=fs, decim=16, overlap=0.5)
    st_b, st_z, jst = base.init_state(1), zm.init_state(1), jzm.init_state(1)
    for b in range(8):
        xb = x[:, b * Bz:(b + 1) * Bz]
        st_b, _ = base.accumulate(st_b, torch.as_tensor(xb))
        st_z, _ = zm.accumulate(st_z, torch.as_tensor(xb))
        jst, _ = jzm.accumulate(jst, jnp.asarray(xb))

    def n_peaks(p):
        p = p / p.max()
        return int(np.sum((p[1:-1] > p[:-2]) & (p[1:-1] >= p[2:])
                          & (p[1:-1] > 0.05)))

    assert n_peaks(base.power(st_b).numpy()[0]) == 1
    p_zoom = zm.power(st_z).numpy()[0]
    assert n_peaks(p_zoom) == 2
    fz = zm.freqs(fs, center_hz=20000.0)
    top2 = sorted(fz[i] for i in np.argsort(p_zoom)[-2:])
    zoom_bin = fs / 16 / Lz
    assert abs(top2[0] - f1) < zoom_bin and abs(top2[1] - f2) < zoom_bin
    assert snr_db(np.asarray(jzm.power(jst))[0], p_zoom) >= 90.0
    assert np.array_equal(fz, jzm.freqs(fs, center_hz=20000.0))
    moved = zm.retuned(21000.0, fs)
    assert int(moved.nco.word[0]) != int(zm.nco.word[0])
