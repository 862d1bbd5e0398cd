"""The port's noise blanker and auto-notch against ``quisk_tpu.ops.noise``
on the same numpy inputs, float32 on the CPU (torch on one thread).

Blanker: the exact path (48 kS/s) and the coarse paths (pool 4 at
192 kS/s, pool 16 at 960 kS/s), 3 streamed blocks of noise with impulses.
The coarse gains (``detect``) must be equal except where a float32 sum
taken in another order may decide a group the other way (|max - thr|
within 1e-5 of thr, counted, at most 2 per run); blanked IQ >= 100 dB.
Auto-notch: two tones in noise over 6 blocks, the brick masks (the peak
decisions) equal and the audio >= 80 dB (two float32 FFT libraries)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import noise as jnoise

from quisk_tpu_torch.ops import noise

CPU = "cpu"


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
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / (np.mean(np.abs(err) ** 2) + 1e-300))


def impulsive(rng, C, B):
    x = (rng.standard_normal((C, B)) + 1j * rng.standard_normal((C, B))
         ).astype(np.complex64)
    for c in range(0, C, 2):
        for p in rng.integers(0, B, 4):
            x[c, p] += 40.0 * np.exp(1j * rng.uniform(0, 2 * np.pi))
    return x


@pytest.mark.parametrize("fs,pool,B", [(48e3, 1, 2048), (192e3, 4, 8192),
                                       (960e3, 16, 10240)])
def test_blanker_matches_jax(fs, pool, B):
    C = 6
    jop = jnoise.NoiseBlanker.create(fs, 2)
    op = noise.NoiseBlanker.create(fs, 2, device=CPU)
    assert (op.pool, op.kwidth, op.avg_win) == (jop.pool, jop.kwidth,
                                                jop.avg_win)
    assert op.pool == pool and float(op.limit) == float(jop.limit) == 4.0
    rng = np.random.default_rng(40)
    jst, pst = jop.init_state(C), op.init_state(C)
    assert pst.shape == jst.shape and pst.dtype == torch.complex64
    blanked = 0
    for _ in range(3):
        x = impulsive(rng, C, B)
        jst, jy = jop(jst, jnp.asarray(x))
        pst, py = op(pst, torch.as_tensor(x))
        assert np.array_equal(pst.numpy(), np.asarray(jst))
        assert snr_db(jy, py.numpy()) > 100.0
        blanked += int(np.sum(py.numpy() == 0))
    assert blanked > 0                          # impulses were zeroed


@pytest.mark.parametrize("fs,B", [(192e3, 8192), (960e3, 10240)])
def test_blanker_detect_matches_jax(fs, B):
    C = 6
    jop = jnoise.NoiseBlanker.create(fs, 2)
    op = noise.NoiseBlanker.create(fs, 2, device=CPU)
    rng = np.random.default_rng(41)
    jst, pst = jop.init_state(C), op.init_state(C)
    differ = 0
    for _ in range(3):
        x = impulsive(rng, C, B)
        jst, jg = jop.detect(jst, jnp.asarray(x))
        pst, pg = op.detect(pst, torch.as_tensor(x))
        assert pg.shape == (C, B // op.pool)
        assert pg.min() == 0.0 and pg.max() == 1.0
        # a flipped decision moves a gain by up to 1; rounding of the
        # widening sum by a few 1e-7
        differ += int(np.sum(np.abs(pg.numpy() - np.asarray(jg)) > 1e-5))
    assert differ <= 2 * (2 * ((op.kwidth // 2) // op.pool) + 1)


def test_blanker_exact_path_has_no_detect():
    op = noise.NoiseBlanker.create(48e3, 1, device=CPU)
    assert op.pool == 1 and float(op.limit) == 6.0
    with pytest.raises(ValueError):
        op.detect(op.init_state(2), torch.zeros((2, 64),
                                                dtype=torch.complex64))


def test_median_averages_the_middle_pair():
    v = np.array([[4.0, 1.0, 3.0, 2.0], [5.0, 5.0, 1.0, 9.0]], np.float32)
    assert np.array_equal(noise._median(torch.as_tensor(v)).numpy()[:, 0],
                          np.asarray(jnp.median(jnp.asarray(v), axis=-1)))
    odd = v[:, :3]
    assert np.array_equal(noise._median(torch.as_tensor(odd)).numpy()[:, 0],
                          np.median(odd, axis=-1))


@pytest.mark.parametrize("block", [512, 2048])
def test_auto_notch_matches_jax(block):
    C, fs = 4, 48e3
    jop = jnoise.AutoNotch.create(block, mxu_dft=False)
    op = noise.AutoNotch.create(block, device=CPU)
    assert (op.nfft, op.ntaps, op.depth_bins, op.n_notch) == (
        jop.nfft, jop.ntaps, jop.depth_bins, jop.n_notch)
    assert np.array_equal(op.window.numpy(), np.asarray(jop.window))
    rng = np.random.default_rng(42)
    t = np.arange(6 * block) / fs
    tones = (0.5 * np.sin(2 * np.pi * 1000.0 * t)
             + 0.3 * np.sin(2 * np.pi * 2350.0 * t + 1.0))
    sig = (0.05 * rng.standard_normal((C, 6 * block)) + tones).astype(
        np.float32)
    sig[3] -= tones.astype(np.float32)                  # a channel of noise
    jst, pst = jop.init_state(C), op.init_state(C)
    for i in range(6):
        a = np.ascontiguousarray(sig[:, i * block:(i + 1) * block])
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        assert snr_db(jy, py.numpy()) > 80.0
        assert snr_db(jst[0], pst[0].numpy()) > 100.0
        assert np.array_equal(pst[1].numpy(), np.asarray(jst[1]))
    # the decisions: both notch the two tones on channels 0-2, none on 3
    mask = op.notch_mask(pst[0]).numpy()
    jmask = op.notch_mask(torch.as_tensor(np.array(jst[0]))).numpy()
    assert np.array_equal(mask, jmask)
    bins = np.round(np.array([1000.0, 2350.0]) / fs * op.nfft).astype(int)
    assert np.all(mask[:3][:, bins] == 0) and np.all(mask[3] == 1)
    # and the tones are gone from the last block
    F = np.fft.rfftfreq(block, 1 / fs)
    P = np.abs(np.fft.rfft(py.numpy()[0] * np.hanning(block))) ** 2
    Pin = np.abs(np.fft.rfft(a[0] * np.hanning(block))) ** 2
    near = np.abs(F - 1000.0) < 100.0
    assert 10 * np.log10(P[near].sum() / Pin[near].sum()) < -20.0
