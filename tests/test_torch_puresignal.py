"""The port's PureSignal predistorter, EER splitter and CIC compensator: the
host calibration equal to the JAX package's bit for bit, the device
lookup within float32 of it, and the behaviour of the JAX package's own
tests (tests/test_puresignal.py, tests/test_eer_cic.py) run on the port."""

import numpy as np
import pytest
import torch
from scipy import signal as sig

import jax.numpy as jnp
from quisk_tpu.io import sources
from quisk_tpu.tx import puresignal as jps

from quisk_tpu_torch.ops import design
from quisk_tpu_torch.tx.eer import EERSplitter
from quisk_tpu_torch.tx.puresignal import (Predistorter, SimulatedPA,
                                           measure_pa_gain, two_tone_imd_db)

CPU = "cpu"
FS = 48000.0
B = 2048


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pa(x, sat=1.2, am_pm=0.4):
    """Saleh-like PA: AM/AM compression plus AM/PM rotation."""
    a = np.abs(x)
    return x / (1.0 + (a / sat) ** 2) * np.exp(1j * am_pm * (a / sat) ** 2)


def _two_tone(n, level=0.6):
    t = np.arange(n) / FS
    return level / 2.0 * (np.exp(2j * np.pi * 700.0 * t)
                          + np.exp(2j * np.pi * 1900.0 * t))


def _apply(pd, x):
    _, y = pd((), torch.as_tensor(x[None].astype(np.complex64)))
    return y.numpy()[0].astype(np.complex128)


def test_calibration_equals_the_jax_package():
    x = _two_tone(1 << 13)
    for pa in (_pa, SimulatedPA(), SimulatedPA(g3=-0.3, ampm_rad=0.3)):
        fb = pa(x)
        for a, b in zip(measure_pa_gain(x, fb, 64, smooth=1),
                        jps.measure_pa_gain(x, fb, 64, smooth=1)):
            assert np.array_equal(a, b)
        pd = Predistorter.from_measurement(x, fb, device=CPU)
        jpd = jps.Predistorter.from_measurement(x, fb)
        assert np.array_equal(pd.c_re.numpy(), np.asarray(jpd.c_re))
        assert np.array_equal(pd.c_im.numpy(), np.asarray(jpd.c_im))
        clean = pa(_apply(pd, x))
        r, jr = pd.refine(x, clean), jpd.refine(x, clean)
        assert np.array_equal(r.c_re.numpy(), np.asarray(jr.c_re))
        assert np.array_equal(r.c_im.numpy(), np.asarray(jr.c_im))
        assert float(r.env_max) == float(jr.env_max)
    assert np.array_equal(SimulatedPA()(x), jps.SimulatedPA()(x))
    assert two_tone_imd_db(_pa(x), FS, 700.0, 1900.0) == jps.two_tone_imd_db(
        _pa(x), FS, 700.0, 1900.0)


def test_predistortion_improves_imd():
    x = _two_tone(1 << 13)
    dirty = _pa(x)
    before = two_tone_imd_db(dirty, FS, 700.0, 1900.0)
    pd = Predistorter.from_measurement(x, dirty, device=CPU)
    clean = _pa(_apply(pd, x))
    after = two_tone_imd_db(clean, FS, 700.0, 1900.0)
    assert before > -35.0
    assert after < before - 12.0, (before, after)
    pd2 = pd.refine(x, clean)
    after2 = two_tone_imd_db(_pa(_apply(pd2, x)), FS, 700.0, 1900.0)
    assert after2 < before - 15.0, (before, after, after2)


def test_predistortion_through_the_simulated_pa():
    pa = SimulatedPA()
    x = 1.1 * _two_tone(1 << 13)
    before = two_tone_imd_db(pa(x), FS, 700.0, 1900.0)
    pd = Predistorter.from_measurement(x, pa(x), device=CPU)
    pd = pd.refine(x, pa(_apply(pd, x)))
    after = two_tone_imd_db(pa(_apply(pd, x)), FS, 700.0, 1900.0)
    assert after < before - 12.0, (before, after)


def test_identity_predistorter_is_transparent():
    x = _two_tone(4096).astype(np.complex64)
    assert np.allclose(_apply(Predistorter.identity(device=CPU), x), x,
                       atol=1e-6)


def test_eer_split_reconstructs_signal():
    voice = sources.voice_like(FS, 8 * B)
    z = sig.hilbert(0.8 * voice / np.max(np.abs(voice)))
    eer = EERSplitter.create(floor=0.01, device=CPU)
    _, (env, ph) = eer((), torch.as_tensor(z[None].astype(np.complex64)))
    env, ph = env.numpy()[0], ph.numpy()[0]
    mask = env > 0.05
    assert np.max(np.abs(np.abs(ph[mask]) - 1.0)) < 1e-3
    err = env * ph - z
    assert np.sqrt(np.mean(np.abs(err[mask]) ** 2)) < 1e-3


def test_eer_delay_alignment():
    eer = EERSplitter.create(delay_samples=16, device=CPU)
    st = eer.init_state(1)
    assert st.dtype == torch.complex64 and st.device.type == "cpu"
    x = np.exp(2j * np.pi * 0.01 * np.arange(2 * B))[None].astype(
        np.complex64)
    st, (_, ph1) = eer(st, torch.as_tensor(x[:, :B]))
    st, (_, ph2) = eer(st, torch.as_tensor(x[:, B:]))
    ph = torch.cat([ph1, ph2], dim=-1).numpy()[0]
    assert np.max(np.abs(ph[16:B] - x[0, :B - 16])) < 1e-5
    assert np.max(np.abs(ph[B:B + 16] - x[0, B - 16:B])) < 1e-5


def test_cic_compensator_flattens_droop():
    decim, stages, fs_out = 8, 4, 96000.0
    h = design.cic_compensator(255, stages, decim, fs_out)
    f, H = sig.freqz(h, worN=2048, fs=fs_out)
    fin = fs_out * decim
    cic = np.abs(np.sin(np.pi * f * decim / fin)
                 / (decim * np.sin(np.pi * np.maximum(f, 1e-9) / fin))
                 ) ** stages
    cic[0] = 1.0
    pb = f <= 0.38 * fs_out
    combined = np.abs(H) * cic
    assert -20 * np.log10(cic[pb].min()) > 3.0
    assert 20 * np.log10(combined[pb].max() / combined[pb].min()) < 0.5


def test_predistorter_lookup_matches_jax_on_a_wide_envelope():
    """Envelopes below, inside and beyond the table's range."""
    x = _two_tone(1 << 13)
    jpd = jps.Predistorter.from_measurement(x, _pa(x))
    pd = Predistorter.from_measurement(x, _pa(x), device=CPU)
    rng = np.random.default_rng(5)
    z = (rng.uniform(0, 1.6, (3, B)) * np.exp(2j * np.pi * rng.uniform(
        size=(3, B)))).astype(np.complex64)
    _, jy = jpd((), jnp.asarray(z))
    _, py = pd((), torch.as_tensor(z))
    err = np.abs(py.numpy() - np.asarray(jy))
    assert np.max(err) <= 1e-6 * np.max(np.abs(np.asarray(jy)))
