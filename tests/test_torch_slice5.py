"""The rest of slice 5 of the port against the JAX package, on the CPU:
the spectral noise blanker, the partitioned overlap-save FIR, diversity
combining, the TX ALC oracle and ``AMDemod.envelope``.

- ``SpectralNoiseBlanker``: output >= 90 dB per row against the JAX op over
  8 blocks of audio with impulses (both packages FFT with pocketfft, but
  sum the frame powers in other orders), the carried background within
  1e-5 relative and the last flag equal.  A frame whose detector ratio
  p / (k_detect * bg) lies within 1e-4 of 1 may flag on one side only
  (and then everything after it on that row may differ): such rows are
  counted and left out from that block on.
- ``PartitionedOLS`` against the JAX op and against the port's
  ``OverlapSaveFIR`` within 1e-4 (tests/test_fir.py:124-175).
- ``DiversityCombiner`` and both weight estimators against the JAX
  package, and the behaviour of tests/test_ratematch_div.py:104-135.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quisk_tpu.modes import Mode as JMode
from quisk_tpu.ops import diversity as jdiv
from quisk_tpu.ops.demod import AMDemod as JAMDemod
from quisk_tpu.ops.design import bandpass_analytic, kaiser_lowpass
from quisk_tpu.ops.fir import PartitionedOLS as JPartitionedOLS
from quisk_tpu.ops.noise import SpectralNoiseBlanker as JSNB
from quisk_tpu.oracle.wcpagc import alc_oracle as j_alc_oracle

from quisk_tpu_torch import convert
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import diversity
from quisk_tpu_torch.ops.agc import TxALC
from quisk_tpu_torch.ops.demod import AMDemod
from quisk_tpu_torch.ops.fir import OverlapSaveFIR, PartitionedOLS
from quisk_tpu_torch.ops.noise import SpectralNoiseBlanker
from quisk_tpu_torch.oracle.wcpagc import alc_oracle

FS = 48000.0
B = 2048
CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """One torch thread: on some CPU hosts torch's intra-op workers have
    returned cos/sin ~1e-4 off for a whole worker chunk."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref).astype(np.complex128)
    err = np.mean(np.abs(np.asarray(got).astype(np.complex128) - ref) ** 2,
                  axis=-1)
    return 10 * np.log10(np.mean(np.abs(ref) ** 2, axis=-1) / (err + 1e-30))


# ------------------------------------------------------- spectral blanker
def _impulsive_audio(rows: int, nblk: int, seed: int) -> np.ndarray:
    """Tones plus noise, with bursts of impulses on every row."""
    rng = np.random.default_rng(seed)
    n = nblk * B
    t = np.arange(n) / FS
    f = rng.uniform(300.0, 3000.0, (rows, 1))
    x = np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal((rows, n))
    for r in range(rows):
        for h in rng.integers(B // 2, n - 16, 12):
            x[r, h:h + 8] += 30.0 * rng.standard_normal(8)
    return x.astype(np.float32)


def _snb_arrays(j) -> dict:
    return {"window": np.asarray(j.window), "block": j.block,
            "k_detect": j.k_detect, "bg_rate": j.bg_rate}


def test_snb_matches_jax():
    rows, nblk = 8, 8
    x = _impulsive_audio(rows, nblk, 11)
    j = JSNB.create(B)
    made = SpectralNoiseBlanker.create(B, device=CPU)
    op = convert.snb_from_numpy(_snb_arrays(j), CPU)
    assert torch.equal(made.window, op.window) and made.fft == op.fft == 256
    jstep = jax.jit(j.__call__)
    js, ps = j.init_state(rows), op.init_state(rows)
    left_out = np.zeros(rows, bool)
    near, flagged = 0, 0
    for i in range(nblk):
        a = x[:, i * B:(i + 1) * B]
        ratio = op.frame_ratio(ps, torch.as_tensor(a)).numpy()
        at_threshold = np.abs(ratio - 1.0) < 1e-4
        near += int(at_threshold.sum())
        left_out |= at_threshold.any(axis=-1)
        flagged += int((ratio > 1.0).sum())
        js, jy = jstep(js, a)
        ps, py = op(ps, torch.as_tensor(a))
        keep = ~left_out
        s = snr_db(np.asarray(jy)[keep], py.numpy()[keep])
        assert s.min() >= 90.0, (i, s)
        bj, bp = np.asarray(js[2])[keep], ps[2].numpy()[keep]
        assert np.all(np.abs(bp - bj) <= 1e-5 * np.abs(bj)), i
        assert np.array_equal(np.asarray(js[3])[keep], ps[3].numpy()[keep])
    assert flagged >= rows * 4, flagged      # the impulses were flagged
    assert left_out.sum() <= 1, (near, left_out)


def test_snb_state_crosses_from_jax():
    rows = 4
    x = _impulsive_audio(rows, 4, 12)
    j = JSNB.create(B)
    op = convert.snb_from_numpy(_snb_arrays(j), CPU)
    jstep = jax.jit(j.__call__)
    js = j.init_state(rows)
    outs = []
    for i in range(4):
        js, y = jstep(js, x[:, i * B:(i + 1) * B])
        outs.append(np.asarray(y))
        if i == 1:
            ps = convert.state_from_numpy(tuple(np.asarray(v) for v in js),
                                          CPU)
    for i in (2, 3):
        ps, py = op(ps, torch.as_tensor(x[:, i * B:(i + 1) * B]))
        assert snr_db(outs[i], py.numpy()).min() >= 90.0


def test_snb_removes_impulses_keeps_tone():
    """tests/test_ratematch_div.py:67-97 at 10 blocks instead of 16."""
    nblk = 10
    snb = SpectralNoiseBlanker.create(B, device=CPU)
    n = nblk * B
    t = np.arange(n) / FS
    tone = np.sin(2 * np.pi * 750.0 * t).astype(np.float32)
    x = tone.copy()
    rng = np.random.default_rng(1)
    for h in rng.integers(4 * B, n - B, 25):
        x[h:h + 8] += 30.0 * rng.standard_normal(8).astype(np.float32)
    st = snb.init_state(1)
    outs = []
    for i in range(nblk):
        st, y = snb(st, torch.as_tensor(x[None, i * B:(i + 1) * B]))
        outs.append(y.numpy())
    y = np.concatenate(outs, axis=-1)[0]
    seg = slice(4 * B, (nblk - 1) * B)
    assert np.max(np.abs(y[seg])) < 3.0          # impulses gone
    d = snb.fft // 2
    c = np.corrcoef(y[4 * B + d:(nblk - 1) * B + d],
                    tone[4 * B:(nblk - 1) * B])[0, 1]
    assert c > 0.95, c


def test_snb_refuses_bad_block_and_mxu_dft():
    with pytest.raises(ValueError):
        SpectralNoiseBlanker.create(1000, device=CPU)
    with pytest.raises(TypeError):
        SpectralNoiseBlanker.create(B, mxu_dft=True, device=CPU)


# ------------------------------------------------------- partitioned OLS
def _pols_arrays(j) -> dict:
    return {"H": np.asarray(j.H), "ntaps": j.ntaps, "block": j.block,
            "decim": j.decim}


def _run(op, x, nblk, blk, state=None):
    st = op.init_state(x.shape[0]) if state is None else state
    ys = []
    for k in range(nblk):
        st, y = op(st, x[:, k * blk:(k + 1) * blk])
        ys.append(np.asarray(y))
    return st, ys


def test_partitioned_ols_matches_jax_and_single_partition():
    """tests/test_fir.py:124-145: 10001 taps at a 512-sample block, 20
    partitions, against the JAX op and the port's OverlapSaveFIR."""
    blk, T, C = 512, 10001, 2
    taps = bandpass_analytic(T, 300.0, 2800.0, 48000.0)
    j = JPartitionedOLS.create(taps, blk)
    b = PartitionedOLS.create(taps, blk, device=CPU)
    conv = convert.partitioned_ols_from_numpy(_pols_arrays(j), CPU)
    assert torch.equal(b.H, conv.H) and (b.P, b.nfft) == (20, 1024)
    a = OverlapSaveFIR.create(taps, blk, device=CPU)
    rng = np.random.default_rng(0)
    nblk = 24
    x = (rng.standard_normal((C, nblk * blk))
         + 1j * rng.standard_normal((C, nblk * blk))).astype(np.complex64)
    _, jy = _run(j, jnp.asarray(x), nblk, blk)
    xt = torch.as_tensor(x)
    _, by = _run(b, xt, nblk, blk)
    _, ay = _run(a, xt, nblk, blk)
    for k in range(nblk):
        assert np.max(np.abs(by[k] - jy[k])) < 1e-4, k
        assert np.max(np.abs(by[k] - ay[k])) < 1e-4, k


def test_partitioned_ols_decim_retune_and_state_from_jax():
    """tests/test_fir.py:148-175: the decimating engine against
    OverlapSaveFIR and the JAX op, ``retuned`` swaps the response with one
    block of latency, and the JAX op's state carries across."""
    blk, C = 256, 2
    t1 = kaiser_lowpass(3000.0, 48000.0, atten_db=60.0)
    a = OverlapSaveFIR.create(t1, blk, decim=4, device=CPU)
    b = PartitionedOLS.create(t1, blk, decim=4, device=CPU)
    j = JPartitionedOLS.create(t1, blk, decim=4)
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((C, 8 * blk))
         + 1j * rng.standard_normal((C, 8 * blk))).astype(np.complex64)
    xt = torch.as_tensor(x)
    js, jy = _run(j, jnp.asarray(x), 8, blk)
    sa, ay = _run(a, xt, 8, blk)
    sb, by = _run(b, xt, 8, blk)
    for k in range(8):
        assert by[k].shape == (C, blk // 4)
        assert np.max(np.abs(ay[k] - by[k])) < 1e-4
        assert np.max(np.abs(jy[k] - by[k])) < 1e-4
    # the JAX state (host numpy complex) continues in the port
    ps = convert.state_from_numpy(tuple(np.asarray(v) for v in js), CPU)
    jn, jyn = j(js, jnp.asarray(x[:, :blk]))
    _, pyn = b(ps, xt[:, :blk])
    assert np.max(np.abs(pyn.numpy() - np.asarray(jyn))) < 1e-4
    t2 = np.resize(kaiser_lowpass(6000.0, 48000.0, atten_db=60.0), len(t1))
    b2, a2 = b.retuned(t2), a.retuned(t2)
    assert b2.H.shape == b.H.shape and not torch.equal(b2.H, b.H)
    with pytest.raises(ValueError):
        b.retuned(t2[:-1])
    sb2, sa2 = sb, sa
    for k in range(3):           # flush P partitions' mixed history
        sa2, ya = a2(sa2, xt[:, k * blk:(k + 1) * blk])
        sb2, yb = b2(sb2, xt[:, k * blk:(k + 1) * blk])
    assert float(torch.max(torch.abs(ya - yb))) < 1e-4


def test_partitioned_ols_per_channel_taps():
    blk = 128
    taps = np.stack([bandpass_analytic(301, lo, hi, 48000.0)
                     for lo, hi in ((300.0, 2800.0), (-5000.0, 5000.0))])
    b = PartitionedOLS.create(taps, blk, device=CPU)
    j = JPartitionedOLS.create(taps, blk)
    assert b.H.shape == (2, 3, 2 * blk)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 4 * blk))
         + 1j * rng.standard_normal((2, 4 * blk))).astype(np.complex64)
    _, jy = _run(j, jnp.asarray(x), 4, blk)
    _, by = _run(b, torch.as_tensor(x), 4, blk)
    for k in range(4):
        assert np.max(np.abs(by[k] - jy[k])) < 1e-4


# ------------------------------------------------------------- diversity
def _pair_snapshot(seed=0, n=8192, interf_phase=1.1):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    sig = np.exp(2j * np.pi * 0.01 * t)
    interf = 5.0 * np.exp(2j * np.pi * 0.07 * t)
    noise = 0.05 * (rng.standard_normal((2, n))
                    + 1j * rng.standard_normal((2, n)))
    x0 = sig + interf + noise[0]
    x1 = (0.8 * np.exp(0.4j) * sig + interf * np.exp(1j * interf_phase)
          + noise[1])
    return np.stack([x0, x1])[None].astype(np.complex64)   # [1, 2, n]


def test_diversity_matches_jax():
    C, n = 6, 4096
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((C, 2, n))
         + 1j * rng.standard_normal((C, 2, n))).astype(np.complex64)
    for fn in ("estimate_max_snr_weights", "null_steering_weights"):
        wj = getattr(jdiv, fn)(x)
        wp = getattr(diversity, fn)(x)
        assert wp.dtype == np.complex64 and np.allclose(wp, wj, atol=1e-6)
    w = diversity.null_steering_weights(x)
    jc = jdiv.DiversityCombiner.create(C, gain=0.7, phase_deg=30.0)
    pc = diversity.DiversityCombiner.create(C, gain=0.7, phase_deg=30.0,
                                            device=CPU)
    assert np.array_equal(np.asarray(jc.w_re), pc.w_re.numpy())
    assert np.array_equal(np.asarray(jc.w_im), pc.w_im.numpy())
    jc, pc = jc.set_weights(w), pc.set_weights(w)
    conv = convert.diversity_from_numpy(
        {"w_re": np.asarray(jc.w_re), "w_im": np.asarray(jc.w_im)}, CPU)
    assert torch.equal(conv.w_re, pc.w_re) and torch.equal(conv.w_im,
                                                           pc.w_im)
    _, yj = jc((), jnp.asarray(x))
    st, yp = pc(pc.init_state(C), torch.as_tensor(x))
    assert st == () and yp.shape == (C, n) and yp.dtype == torch.complex64
    assert snr_db(np.asarray(yj), yp.numpy()).min() > 120.0


def test_diversity_null_steering_kills_interferer():
    x = _pair_snapshot()
    t = np.arange(x.shape[-1])
    interf_only = np.stack([np.exp(2j * np.pi * 0.07 * t),
                            np.exp(2j * np.pi * 0.07 * t + 1.1j)])[None]
    w = diversity.null_steering_weights(interf_only.astype(np.complex64))
    div = diversity.DiversityCombiner.create(1, device=CPU).set_weights(w)
    _, y = div((), torch.as_tensor(x))
    y = y.numpy()[0]
    Y = np.abs(np.fft.fft(y))
    f = np.fft.fftfreq(len(y))
    k_int = np.argmin(np.abs(f - 0.07))
    k_sig = np.argmin(np.abs(f - 0.01))
    # interferer (5x stronger in) driven below the signal at the output
    assert Y[k_int] < 0.1 * Y[k_sig], (Y[k_int], Y[k_sig])


def test_diversity_max_snr_beats_single_antenna():
    x = _pair_snapshot(interf_phase=3.0)
    t = np.arange(x.shape[-1])
    rng = np.random.default_rng(5)
    sig_snap = np.stack([np.exp(2j * np.pi * 0.01 * t),
                         0.8 * np.exp(0.4j) * np.exp(2j * np.pi * 0.01 * t)])
    sig_snap = (sig_snap + 0.3 * (rng.standard_normal((2, len(t)))
                                  + 1j * rng.standard_normal((2, len(t)))))
    w = diversity.estimate_max_snr_weights(sig_snap[None].astype(
        np.complex64))
    div = diversity.DiversityCombiner.create(1, device=CPU).set_weights(w)
    _, y = div((), torch.as_tensor(x))
    y = y.numpy()[0]
    Y = np.abs(np.fft.fft(y))
    k_sig = np.argmin(np.abs(np.fft.fftfreq(len(y)) - 0.01))
    single = np.abs(np.fft.fft(x[0, 0]))[k_sig]
    assert Y[k_sig] > 1.1 * single         # coherent gain over one antenna


# -------------------------------------------------------- ALC oracle, misc
@pytest.mark.parametrize("cplx", [False, True])
def test_alc_oracle_equals_jax_copy(cplx):
    n = 4 * B
    rng = np.random.default_rng(7)
    x = 0.2 * rng.standard_normal(n)
    if cplx:
        x = x + 0.2j * rng.standard_normal(n)
    x[B:3 * B] *= 8.0                          # overdriven segment
    modes = np.where(np.arange(n) < 3 * B, int(Mode.USB), int(Mode.AM))
    assert int(Mode.USB) == int(JMode.USB) and int(Mode.AM) == int(JMode.AM)
    out, g = alc_oracle(x, modes, FS)
    jout, jg = j_alc_oracle(x, modes, FS)
    assert np.array_equal(out, jout) and np.array_equal(g, jg)
    assert np.abs(out[2 * B:3 * B]).max() < 1.05


def test_txalc_matches_port_oracle():
    """The port's TxALC against the port's copy of the oracle, with the
    tolerance of tests/test_wcpagc.py:113-124, at 6 blocks."""
    n = 6 * B
    rng = np.random.default_rng(2)
    x = 0.2 * rng.standard_normal(n)
    x[2 * B:4 * B] *= 8.0
    ref, _ = alc_oracle(x, np.full(n, int(Mode.USB)), FS)
    alc = TxALC.create(FS, mode=int(Mode.USB), channels=1, device=CPU)
    st = alc.init_state(1)
    outs = []
    xt = torch.as_tensor(x[None].astype(np.complex64))
    for i in range(6):
        st, y = alc(st, xt[:, i * B:(i + 1) * B])
        outs.append(y.numpy())
    got = np.concatenate(outs, axis=-1)[0].real
    assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
    assert np.abs(got[3 * B:4 * B]).max() < 1.05


def test_am_envelope_matches_jax():
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((3, 257))
         + 1j * rng.standard_normal((3, 257))).astype(np.complex64)
    got = AMDemod.create(CPU).envelope(torch.as_tensor(x)).numpy()
    ref = np.asarray(JAMDemod.create().envelope(jnp.asarray(x)))
    assert got.dtype == np.float32 and np.allclose(got, ref, rtol=1e-6)


# ---------------------------------------------------------- oracle copies
@pytest.mark.parametrize("name", ["fir_stream", "nco_phase", "mix_down",
                                  "ssb_demod", "am_demod", "fm_demod",
                                  "one_pole", "agc", "snr_db",
                                  "frac_align_snr", "align_and_snr"])
def test_dsp_oracle_copy_equals_jax_package(name):
    """The port's copy of quisk_tpu/oracle/dsp.py gives the same numbers."""
    from quisk_tpu.oracle import dsp as jdsp
    from quisk_tpu_torch.oracle import dsp
    rng = np.random.default_rng(13)
    x = rng.standard_normal(4000) + 1j * rng.standard_normal(4000)
    r = rng.standard_normal(4000)
    args = {"fir_stream": (x, rng.standard_normal(33)),
            "nco_phase": (5, 100, 1234.5, 48000.0),
            "mix_down": (x, 1234.5, 48000.0),
            "ssb_demod": (x,), "am_demod": (x,), "fm_demod": (x, 48000.0),
            "one_pole": (r, 0.9, 0.1), "agc": (r, 48000.0),
            "snr_db": (r, r + 0.01 * rng.standard_normal(4000)),
            "frac_align_snr": (r, np.roll(r, 3) + 0.01 * r),
            "align_and_snr": (r, np.roll(r, 3), 8)}[name]
    got, ref = getattr(dsp, name)(*args), getattr(jdsp, name)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        assert np.array_equal(np.asarray(g), np.asarray(w))
