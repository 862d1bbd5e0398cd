"""The port's hang AGCs and biquad against the JAX package on the same
numpy inputs (float32 on the CPU, torch on one thread).

``HangAGC`` and ``WcpAGC`` run a per-sample state machine: the integer
states and counters must be equal to the JAX op's sample for sample
through the blocks, the float trajectories within float32 rounding.
``WcpAGC`` is also held to the port's own float64 oracle with the
tolerance of tests/test_wcpagc.py (2e-2 of the peak, correlation >
0.9999), and the oracle copy to the JAX package's.  ``Biquad`` scans the
same recurrence in another tree order.  A float32 scan over powers of a
matrix with poles near the unit circle loses digits on either side: held
to the float64 recurrence the JAX op reaches 75 dB (notch), 78 dB
(highpass) and 100 dB (peak) on this input and the port 77, 75 and 94 dB,
so the port is held to >= 70 dB against the JAX op and against float64,
and to within 6 dB of the JAX op's own distance from float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import agc as jagc
from quisk_tpu.ops import iir as jiir
from quisk_tpu.oracle import wcpagc as joracle

from quisk_tpu_torch.ops import agc, iir
from quisk_tpu_torch.oracle import wcpagc as oracle

CPU = "cpu"
FS = 48e3
B = 512


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


def bursts(n, C, seed, amp=0.5):
    """Tone bursts with silence gaps: attack, hang and decay all occur."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = amp * np.sin(2 * np.pi * 700.0 * t) * ((t % 0.04) < 0.022)
    x = x[None] * np.array([1.0, 0.1, 2.0, 0.01])[:C, None]
    x = x + 1e-4 * rng.standard_normal((C, n))
    x[:, int(0.9 * n):] *= 0.05
    return x.astype(np.float32)


def test_hang_agc_matches_jax():
    C = 4
    kw = dict(hang_ms=5.0, release_db_per_s=600.0)
    jop = jagc.HangAGC.create(FS, **kw)
    op = agc.HangAGC.create(FS, device=CPU, **kw)
    assert (op.hang_samples, op.lookahead) == (jop.hang_samples,
                                               jop.lookahead)
    x = bursts(4 * B, C, 70)
    jst, pst = jop.init_state(C), op.init_state(C)
    assert pst[2].dtype == torch.int32
    hang_max = 0
    for i in range(4):
        a = np.ascontiguousarray(x[:, i * B:(i + 1) * B])
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        assert np.array_equal(pst[2].numpy(), np.asarray(jst[2]))
        assert pst[2].dtype == torch.int32
        assert np.allclose(pst[1].numpy(), np.asarray(jst[1]), atol=1e-5)
        if i:
            assert snr_db(jy, py.numpy()) > 100.0
        hang_max = max(hang_max, int(pst[2].numpy().max()))
    assert hang_max > 0                     # a hang was running at a join


def test_wcp_constants_equal():
    p, q = oracle.WcpParams(sample_rate=FS), joracle.WcpParams(
        sample_rate=FS)
    assert p.derived() == q.derived()
    assert p.attack_buffsize == q.attack_buffsize
    jop = jagc.WcpAGC.create(FS)
    op = agc.WcpAGC.create(FS, device=CPU)
    for name, v in op.k.items():
        assert float(v) == float(getattr(jop, name)), name
    assert (op.hang_samples, op.hang_enable, op.lookahead) == (
        jop.hang_samples, jop.hang_enable, jop.lookahead)


def test_wcp_oracle_copy_equals_jax_package_oracle():
    x = bursts(2048, 1, 71)[0].astype(np.float64)
    kw = dict(sample_rate=FS, hangtime=0.01, tau_decay=0.02)
    got = oracle.wcpagc_oracle(x, oracle.WcpParams(**kw))
    ref = joracle.wcpagc_oracle(x, joracle.WcpParams(**kw))
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)


def test_wcp_agc_matches_jax_and_oracle():
    C, nblk = 4, 6
    # short time constants, so that every state occurs within 6 blocks
    kw = dict(hangtime=0.01, tau_decay=0.02, tau_hang_decay=0.01,
              tau_fast_backaverage=0.02, tau_hang_backmult=0.05,
              hang_thresh=0.1)
    jop = jagc.WcpAGC.create(FS, **kw)
    op = agc.WcpAGC.create(FS, device=CPU, **kw)
    x = bursts(nblk * B, C, 72)
    jst, pst = jop.init_state(C), op.init_state(C)
    outs, seen = [], set()
    for i in range(nblk):
        a = np.ascontiguousarray(x[:, i * B:(i + 1) * B])
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        assert set(pst) == set(jst)
        for name in ("hang_counter", "state", "decay_type"):
            assert pst[name].dtype == torch.int32
            assert np.array_equal(pst[name].numpy(), np.asarray(jst[name]))
        for name in ("volts", "save_volts", "fast_ba", "hang_ba"):
            assert np.allclose(pst[name].numpy(), np.asarray(jst[name]),
                               rtol=1e-4, atol=1e-9), name
        assert np.array_equal(pst["delay"].numpy(), np.asarray(jst["delay"]))
        if i:
            assert snr_db(jy, py.numpy()) > 80.0
        outs.append(py.numpy())
        seen |= set(pst["state"].numpy().tolist())
    got = np.concatenate(outs, axis=-1)
    states = set()
    for c in range(C):
        ref, _, st_trace = oracle.wcpagc_oracle(
            x[c].astype(np.float64), oracle.WcpParams(sample_rate=FS, **kw))
        states |= set(st_trace.tolist())
        err = np.abs(got[c] - ref).max() / np.abs(ref).max()
        assert err < 2e-2, (c, err)
        assert np.corrcoef(got[c, B:], ref[B:])[0, 1] > 0.9999
    assert states >= {0, 1, 2, 4}         # pop, hang and hang decay occurred


@pytest.mark.parametrize("kind", ["notch", "peak", "highpass"])
def test_biquad_matches_jax(kind):
    C, blk = 3, 1024
    args = {"notch": (1000.0, FS), "peak": (1500.0, FS),
            "highpass": (300.0, FS)}[kind]
    jop = getattr(jiir.Biquad, kind)(*args)
    op = getattr(iir.Biquad, kind)(*args, CPU)
    for f in ("b0", "b1", "b2", "a1", "a2"):
        assert float(getattr(op, f)) == float(getattr(jop, f))
    rng = np.random.default_rng(73)
    t = np.arange(3 * blk) / FS
    x = (np.sin(2 * np.pi * 1000.0 * t)
         + 0.3 * rng.standard_normal((C, 3 * blk))).astype(np.float32)
    jst, pst = jop.init_state(C), op.init_state(C)
    ref64 = _biquad_f64(op, x)
    outs, jouts = [], []
    for i in range(3):
        a = np.ascontiguousarray(x[:, i * blk:(i + 1) * blk])
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        assert snr_db(jy, py.numpy()) > 70.0
        for js, ps in zip(jst[:2], pst[:2]):
            assert np.array_equal(ps.numpy(), np.asarray(js))
        outs.append(py.numpy())
        jouts.append(np.asarray(jy))
    port_db = snr_db(ref64, np.concatenate(outs, axis=-1))
    jax_db = snr_db(ref64, np.concatenate(jouts, axis=-1))
    assert port_db > 70.0 and port_db > jax_db - 6.0, (port_db, jax_db)


def _biquad_f64(op, x):
    """The recurrence itself, sample by sample in float64."""
    b0, b1, b2, a1, a2 = (float(getattr(op, f))
                          for f in ("b0", "b1", "b2", "a1", "a2"))
    y = np.zeros(x.shape, np.float64)
    x = x.astype(np.float64)
    for n in range(x.shape[1]):
        xm1 = x[:, n - 1] if n >= 1 else 0.0
        xm2 = x[:, n - 2] if n >= 2 else 0.0
        ym1 = y[:, n - 1] if n >= 1 else 0.0
        ym2 = y[:, n - 2] if n >= 2 else 0.0
        y[:, n] = b0 * x[:, n] + b1 * xm1 + b2 * xm2 - a1 * ym1 - a2 * ym2
    return y
