"""The port's squelches against ``quisk_tpu.ops.squelch`` on the same
numpy inputs: open -> hold -> close with the raised-cosine ramp.  The hold
counters (int32) must be equal block by block, the gains within 1e-6 and
the audio >= 100 dB (float32 on the CPU, two FFT libraries)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import squelch as jsq

from quisk_tpu_torch.ops import squelch

CPU = "cpu"
FS = 48e3
B = 2048


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
    """inf where the two are equal (a closed squelch gives zeros)."""
    ref = np.asarray(ref, np.float64)
    err = np.mean((np.asarray(got, np.float64) - ref) ** 2)
    return np.inf if err == 0 else 10 * np.log10(np.mean(ref ** 2) / err)


def test_ramp_gain_equal():
    prev = np.array([0.0, 1.0, 0.3], np.float32)
    tgt = np.array([1.0, 0.0, 0.3], np.float32)
    for ramp in (1, 240, 5000):
        got = squelch.ramp_gain(torch.as_tensor(prev), torch.as_tensor(tgt),
                                B, ramp).numpy()
        ref = np.asarray(jsq._ramp_gain(jnp.asarray(prev), jnp.asarray(tgt),
                                        B, ramp))
        assert np.max(np.abs(got - ref)) < 1e-6
    assert got[0, 0] == 0.0 and got[1, 0] == 1.0


def test_ssb_squelch_open_hold_close():
    C = 3
    # a short hold, so that the close is reached in a few blocks
    jop = jsq.SSBSquelch.create(FS, B, hold_secs=0.1)
    op = squelch.SSBSquelch.create(FS, B, hold_secs=0.1, device=CPU)
    assert (op.hold_blocks, op.ramp, op.f_lo_bin, op.f_hi_bin) == (
        jop.hold_blocks, jop.ramp, jop.f_lo_bin, jop.f_hi_bin)
    assert op.hold_blocks == 2 and (op.f_lo_bin, op.f_hi_bin) == (3, 28)
    rng = np.random.default_rng(60)
    t = np.arange(B) / FS
    voice = (np.sin(2 * np.pi * 500.0 * t) + np.sin(2 * np.pi * 1200.0 * t))
    jst, pst = jop.init_state(C), op.init_state(C)
    assert pst[0].dtype == torch.int32
    holds = []
    for i in range(8):
        a = 0.05 * rng.standard_normal((C, B))
        if i in (1, 2):                 # voice on channels 0 and 1
            a[:2] += voice
        a = a.astype(np.float32)
        m_ref = np.asarray(jop.voice_metric(jnp.asarray(a)))
        m_got = op.voice_metric(torch.as_tensor(a)).numpy()
        assert np.max(np.abs(m_ref - m_got)) < 1e-4
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        assert np.array_equal(pst[0].numpy(), np.asarray(jst[0]))
        assert pst[0].dtype == torch.int32
        assert np.max(np.abs(pst[1].numpy() - np.asarray(jst[1]))) < 1e-6
        assert snr_db(jy, py.numpy()) > 100.0
        holds.append(pst[0].numpy().copy())
    holds = np.stack(holds)
    assert holds[:, 0].tolist() == [0, 2, 2, 1, 0, 0, 0, 0]   # open/hold/close
    assert holds[:, 2].max() == 0                              # never opened
    assert pst[1].numpy().tolist() == [0.0, 0.0, 0.0]


def test_fm_squelch_open_hold_close():
    C = 3
    jop = jsq.FMSquelch.create(FS, B)
    op = squelch.FMSquelch.create(FS, B, device=CPU)
    assert (op.hold_blocks, op.ramp) == (jop.hold_blocks, jop.ramp) == (5,
                                                                        240)
    rng = np.random.default_rng(61)
    jst, pst = jop.init_state(C), op.init_state(C)
    holds = []
    for i in range(9):
        level = np.array([1e-1 if i == 1 else 1e-5, 1e-5, 1.0])[:, None]
        rf = (level * (rng.standard_normal((C, B))
                       + 1j * rng.standard_normal((C, B)))
              ).astype(np.complex64)
        audio = rng.standard_normal((C, B)).astype(np.float32)
        j_db = np.asarray(jop.measure(jnp.asarray(rf)))
        p_db = op.measure(torch.as_tensor(rf))
        assert np.max(np.abs(j_db - p_db.numpy())) < 1e-3
        jst, jy = jop(jst, jnp.asarray(audio), jnp.asarray(j_db))
        pst, py = op(pst, torch.as_tensor(audio), p_db)
        assert np.array_equal(pst[0].numpy(), np.asarray(jst[0]))
        assert pst[0].dtype == torch.int32
        assert np.max(np.abs(pst[1].numpy() - np.asarray(jst[1]))) < 1e-6
        assert snr_db(jy, py.numpy()) > 100.0
        holds.append(pst[0].numpy().copy())
    holds = np.stack(holds)
    assert holds[:, 0].tolist() == [0, 5, 4, 3, 2, 1, 0, 0, 0]
    assert holds[:, 1].max() == 0 and holds[:, 2].min() == 5
    assert pst[1].numpy().tolist() == [0.0, 0.0, 1.0]
