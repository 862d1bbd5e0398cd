"""The port's spectral noise reduction and block-LMS predictor against
``quisk_tpu.ops.nr`` on the same numpy inputs, float32 on the CPU (torch
on one thread), both sides with a true FFT (``mxu_dft=False``).

Both ops adapt from their own output (the decision-directed SNR, the LMS
weights), so rounding differences feed back; over 6 streamed blocks the
audio and the carried state stay >= 80 dB from the JAX op's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import nr as jnr

from quisk_tpu_torch.ops import nr

CPU = "cpu"
FS = 48e3


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """Run the port's CPU ops on one thread: on some CPU hosts torch's
    intra-op worker threads have returned elementwise transcendentals
    off by ~1e-4 for a whole worker's chunk, intermittently."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / (np.mean(err ** 2) + 1e-300))


def test_exp1_on_a_grid():
    v = np.concatenate([np.logspace(-12, 0, 200), np.linspace(1.0, 700.0,
                                                              400)]
                       ).astype(np.float32)
    got = nr.exp1(torch.as_tensor(v)).numpy()
    ref = np.asarray(jnr._exp1(jnp.asarray(v)))
    assert np.allclose(got, ref, rtol=2e-6, atol=1e-30)
    # and against the integral itself where float64 quadrature is easy
    from scipy.special import exp1 as e1
    mid = (v > 1e-3) & (v < 50)
    assert np.allclose(got[mid], e1(v[mid].astype(np.float64)), rtol=1e-5,
                       atol=1e-7)


def _voice_in_noise(rng, C, n):
    t = np.arange(n) / FS
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * t))
    voice = env * (np.sin(2 * np.pi * 440.0 * t)
                   + 0.5 * np.sin(2 * np.pi * 1230.0 * t))
    return (0.3 * voice + 0.1 * rng.standard_normal((C, n))).astype(
        np.float32)


@pytest.mark.parametrize("block", [512, 2048])
def test_spectral_nr_matches_jax(block):
    C = 4
    jop = jnr.SpectralNR.create(block, mxu_dft=False)
    op = nr.SpectralNR.create(block, device=CPU)
    assert np.array_equal(op.window.numpy(), np.asarray(jop.window))
    assert (op.alpha, op.noise_up, op.noise_down, op.gain_floor) == (
        jop.alpha, jop.noise_up, jop.noise_down, jop.gain_floor)
    sig = _voice_in_noise(np.random.default_rng(50), C, 6 * block)
    jst, pst = jop.init_state(C), op.init_state(C)
    for i in range(6):
        a = np.ascontiguousarray(sig[:, i * block:(i + 1) * block])
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        if i:                                   # block 0 is mostly tail-in
            assert snr_db(jy, py.numpy()) > 80.0
        for js, ps in zip(jst, pst):
            assert ps.shape == js.shape
            assert snr_db(js, ps.numpy()) > 80.0
    # it reduces noise: the output is quieter than the input
    assert np.mean(py.numpy() ** 2) < np.mean(a ** 2)


@pytest.mark.parametrize("fdaf", [True, False], ids=["fdaf", "time"])
@pytest.mark.parametrize("notch", [True, False], ids=["anf", "anr"])
def test_block_lms_matches_jax(fdaf, notch):
    C, block = 3, 1024
    kw = dict(taps=64, delay=8, notch=notch, fdaf=fdaf, sub=256)
    jop = jnr.BlockLMS.create(block, mxu_dft=False, **kw)
    op = nr.BlockLMS.create(block, device=CPU, **kw)
    assert (op.sub, op.taps, op.delay) == (jop.sub, jop.taps, jop.delay)
    rng = np.random.default_rng(51)
    t = np.arange(6 * block) / FS
    sig = (0.5 * np.sin(2 * np.pi * 1000.0 * t)
           + 0.1 * rng.standard_normal((C, 6 * block))).astype(np.float32)
    jst, pst = jop.init_state(C), op.init_state(C)
    for i in range(6):
        a = np.ascontiguousarray(sig[:, i * block:(i + 1) * block])
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        assert snr_db(jy, py.numpy()) > 80.0
        assert snr_db(jst[0], pst[0].numpy()) > 80.0
        assert np.array_equal(pst[1].numpy(), np.asarray(jst[1]))
    # the predictor has locked on the tone: ANF removes it, ANR keeps it
    P = np.abs(np.fft.rfft(py.numpy()[0] * np.hanning(block))) ** 2
    Pin = np.abs(np.fft.rfft(a[0] * np.hanning(block))) ** 2
    k = int(round(1000.0 / FS * block))
    ratio = 10 * np.log10(P[k - 2:k + 3].sum() / Pin[k - 2:k + 3].sum())
    assert (ratio < -10.0) if notch else (ratio > -3.0)


def test_fdaf_equals_time_domain():
    """The two forms of the update are the same filter."""
    C, block = 2, 1024
    a = _voice_in_noise(np.random.default_rng(52), C, block)
    outs = []
    for fdaf in (True, False):
        op = nr.BlockLMS.create(block, taps=64, delay=8, fdaf=fdaf,
                                device=CPU)
        _, y = op(op.init_state(C), torch.as_tensor(a))
        outs.append(y.numpy())
    assert snr_db(outs[1], outs[0]) > 90.0
