"""The port's TX-path ops against the JAX package's on the same numpy inputs
(float32 on the CPU, torch on one thread).

Memoryless ops and FIRs are held to >= 100 dB, the recurrences and the
STFT compressor to >= 90 dB with their state carried over 3-4 blocks, the
design functions bit for bit.  ``TxALC`` decides per sample: its gains
must agree within 1e-5 relative and its clip decisions must be the same
at every sample (the JAX op's decisions read from its state stepped one
sample at a time)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from quisk_tpu.ops import agc as jagc
from quisk_tpu.ops import compress as jcompress
from quisk_tpu.ops import design as jdesign
from quisk_tpu.ops import eq as jeq
from quisk_tpu.ops import iir as jiir
from quisk_tpu.ops import resample as jresample
from quisk_tpu.tx import eer as jeer
from quisk_tpu.tx import puresignal as jps

from quisk_tpu_torch.ops import agc, compress, design, eq, iir, resample
from quisk_tpu_torch.tx import eer, puresignal

CPU = "cpu"
FS = 48e3
B = 512


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The port's CPU ops on one thread (ROADMAP Queue 3: multi-threaded
    cos/sin on some hosts)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref).astype(np.complex128)
    err = np.asarray(got).astype(np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / (np.mean(np.abs(err) ** 2) + 1e-300))


def voice(C, n, seed, amp=0.8):
    """Band-limited noise, normalised per row to ``amp`` peak."""
    from scipy import signal as sig
    rng = np.random.default_rng(seed)
    b, a = sig.butter(6, [300.0, 3000.0], btype="band", fs=FS)
    x = sig.lfilter(b, a, rng.standard_normal((C, n)), axis=-1)
    return (amp * x / np.max(np.abs(x), axis=-1, keepdims=True)
            ).astype(np.float32)


def analytic(C, n, seed, amp=0.8):
    from scipy import signal as sig
    return sig.hilbert(voice(C, n, seed, amp)).astype(np.complex64)


def stream(jop, op, x, jst, pst, blk=B):
    """Both ops over x in blocks of ``blk``; yields (jy, py) per block."""
    for i in range(x.shape[-1] // blk):
        a = np.ascontiguousarray(x[..., i * blk:(i + 1) * blk])
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        yield jy, py


def cat(ys):
    return np.concatenate([np.asarray(y) for y in ys], axis=-1)


# ------------------------------------------------------------------ design
def test_design_functions_equal():
    assert np.array_equal(design.kaiser_lowpass(2000.0, FS),
                          jdesign.kaiser_lowpass(2000.0, FS))
    assert np.array_equal(design.kaiser_lowpass(900.0, 256e3, 80.0, 300.0),
                          jdesign.kaiser_lowpass(900.0, 256e3, 80.0, 300.0))
    for L, fs in ((2, 96e3), (4, 192e3), (5, 240e3)):
        assert np.array_equal(design.interpolator(L, fs),
                              jdesign.interpolator(L, fs))
    for f1, f2 in ((200.0, 2800.0), (500.0, 2500.0)):
        assert np.array_equal(design.remez_bandpass(127, f1, f2, FS),
                              jdesign.remez_bandpass(127, f1, f2, FS))
    assert np.array_equal(design.cic_compensator(255, 4, 8, 96e3),
                          jdesign.cic_compensator(255, 4, 8, 96e3))
    t = jdesign.bandpass_analytic(513, 300.0, 2700.0, FS)
    for a, b in zip(design.freq_response(t, FS), jdesign.freq_response(t, FS)):
        assert np.array_equal(a, b)


# ----------------------------------------------------------- memoryless/FIR
@pytest.mark.parametrize("c", [0.3, [0.0, 0.5, 0.97, 0.2]])
def test_preemphasis_matches_jax(c):
    x = voice(4, 3 * B, 1)
    jop = jiir.Preemphasis.create(np.asarray(c, np.float32))
    op = iir.Preemphasis.create(c, device=CPU)
    got = list(stream(jop, op, x, jop.init_state(4), op.init_state(4)))
    assert snr_db(cat(j for j, _ in got), cat(p for _, p in got)) >= 100.0


@pytest.mark.parametrize("drive", [6.0, 14.0, [0.0, 6.0, 12.0, 20.0]])
def test_soft_compressor_matches_jax(drive):
    x = 1.5 * voice(4, 2 * B, 2)
    jop = jcompress.SoftCompressor.create(np.asarray(drive, np.float32))
    op = compress.SoftCompressor.create(drive, device=CPU)
    got = list(stream(jop, op, x, (), ()))
    jy, py = cat(j for j, _ in got), cat(p for _, p in got)
    assert snr_db(jy, py) >= 100.0
    if np.ndim(drive):                      # drive 0 dB passes exactly
        assert np.array_equal(py[0], x[0])


@pytest.mark.parametrize("L", [2, 4])
@pytest.mark.parametrize("complex_in", [True, False])
def test_interpolator_matches_jax(L, complex_in):
    x = analytic(3, 4 * B, 3) if complex_in else voice(3, 4 * B, 3)
    jop = jresample.Interpolator.create(L, B, fs_out=L * FS,
                                        complex_state=complex_in)
    op = resample.Interpolator.create(L, B, fs_out=L * FS,
                                      complex_state=complex_in, device=CPU)
    assert (op.R, op._span, op.ntaps) == (jop.R, jop._span, jop.ntaps)
    assert np.array_equal(op.M.numpy(), np.asarray(jop.M))
    got = list(stream(jop, op, x, jop.init_state(3), op.init_state(3)))
    jy, py = cat(j for j, _ in got), cat(p for _, p in got)
    assert py.shape == (3, 4 * B * L)
    assert snr_db(jy, py) >= 100.0


def test_halfband_decim2_matches_jax():
    x = analytic(3, 4 * B, 4)
    jop = jresample.HalfbandDecim2.create(B)
    op = resample.HalfbandDecim2.create(B, device=CPU)
    got = list(stream(jop, op, x, jop.init_state(3), op.init_state(3)))
    jy, py = cat(j for j, _ in got), cat(p for _, p in got)
    assert py.shape == (3, 2 * B)
    assert snr_db(jy, py) >= 100.0


@pytest.mark.parametrize("delay", [0, 16, 700])
def test_eer_splitter_matches_jax(delay):
    x = analytic(3, 3 * B, 5)
    jop = jeer.EERSplitter.create(env_gain=0.9, phase_gain=1.1, floor=0.02,
                                  delay_samples=delay)
    op = eer.EERSplitter.create(env_gain=0.9, phase_gain=1.1, floor=0.02,
                                delay_samples=delay, device=CPU)
    st = op.init_state(3)
    assert st == () if delay == 0 else st.dtype == torch.complex64
    got = list(stream(jop, op, x, jop.init_state(3), st))
    for k in range(2):
        assert snr_db(cat(j[k] for j, _ in got),
                      cat(p[k] for _, p in got)) >= 100.0


def test_predistorter_matches_jax():
    pa = jps.SimulatedPA()
    t = np.arange(1 << 13) / FS
    x = 0.45 * (np.exp(2j * np.pi * 700.0 * t) + np.exp(2j * np.pi * 1900.0
                                                          * t))
    jop = jps.Predistorter.from_measurement(x, pa(x))
    op = puresignal.Predistorter.from_measurement(x, puresignal.SimulatedPA()(x),
                                                  device=CPU)
    assert np.array_equal(op.c_re.numpy(), np.asarray(jop.c_re))
    assert np.array_equal(op.c_im.numpy(), np.asarray(jop.c_im))
    assert float(op.env_max) == float(jop.env_max)
    xx = analytic(3, 2 * B, 6, amp=1.1)
    got = list(stream(jop, op, xx, (), ()))
    assert snr_db(cat(j for j, _ in got), cat(p for _, p in got)) >= 100.0


@pytest.mark.parametrize("gains", [[0.0] * 5, [6.0, -3.0, 2.0, 9.0, -12.0]])
def test_graphic_eq_matches_jax(gains):
    freqs = [30.0, 125.0, 500.0, 2000.0, 8000.0]
    assert np.array_equal(eq.eq_taps(257, freqs, gains, FS),
                          jeq.eq_taps(257, freqs, gains, FS))
    x = voice(3, 3 * B, 7)
    jop = jeq.GraphicEQ.create(B, FS, freqs, gains)
    op = eq.GraphicEQ.create(B, FS, freqs, gains, device=CPU)
    got = list(stream(jop, op, x, jop.init_state(3), op.init_state(3)))
    assert snr_db(cat(j for j, _ in got), cat(p for _, p in got)) >= 100.0
    # retune: same shapes, new taps, equal to the JAX op retuned
    jop2, op2 = jop.retune(freqs, gains[::-1]), op.retune(freqs, gains[::-1])
    got = list(stream(jop2, op2, x, jop2.init_state(3), op2.init_state(3)))
    assert snr_db(cat(j for j, _ in got), cat(p for _, p in got)) >= 100.0


# -------------------------------------------------------------- recurrences
def test_phase_rotator_matches_jax():
    x = voice(4, 4 * 2048, 8)
    for blk in (B, 2048):                       # scan and chunked forms
        jop = jiir.PhaseRotator.create()
        op = iir.PhaseRotator.create(device=CPU)
        got = list(stream(jop, op, x, jop.init_state(4), op.init_state(4),
                          blk=blk))
        assert len(got) >= 4
        assert snr_db(cat(j for j, _ in got), cat(p for _, p in got)) >= 90.0


def test_overshoot_control_matches_jax():
    x = analytic(3, 4 * B, 9, amp=2.5)          # clipping on every block
    jop = jcompress.OvershootControl.create(B, FS)
    op = compress.OvershootControl.create(B, FS, device=CPU)
    got = list(stream(jop, op, x, jop.init_state(3), op.init_state(3)))
    py = cat(p for _, p in got)
    assert snr_db(cat(j for j, _ in got), py) >= 90.0
    assert np.max(np.abs(py)) <= 1.02 * 1.0001


def test_cf_compressor_matches_jax():
    x = voice(3, 4 * B, 10)
    x[1] *= 0.02                                 # below target: lifted
    jop = jeq.CFCompressor.create(B, FS)
    op = eq.CFCompressor.create(B, FS, device=CPU)
    jst, pst = jop.init_state(3), op.init_state(3)
    got = list(stream(jop, op, x, jst, pst))
    assert snr_db(cat(j for j, _ in got), cat(p for _, p in got)) >= 90.0


# -------------------------------------------------------------------- ALC
A_SAMPLES = 960


def alc_input(C, n, seed):
    """Modulated-IQ-like input: voice bursts driven into clipping, a stretch
    of silence under min_magn, per-channel levels."""
    x = analytic(C, n, seed, amp=1.0)
    t = np.arange(n)
    gate = ((t // 700) % 3 != 2).astype(np.float32)       # bursts + gaps
    level = np.array([1.6, 0.4, 2.5, 0.9], np.float32)[:C, None]
    x = x * gate * level
    x[:, int(0.55 * n):int(0.7 * n)] *= 1e-4               # silence
    return x.astype(np.complex64)


def jax_alc_per_sample(jop, x):
    """The JAX op stepped one sample at a time: its carried values after
    each sample (gain of the active mode, gain_change, final_gain,
    counter, fault, block_index) and index before each sample."""
    f = jax.jit(lambda st, xx: jop(st, xx))
    st = jop.init_state(x.shape[0])
    m = np.asarray(jop.mode)
    rows = {k: [] for k in ("g", "gain_change", "final_gain", "counter",
                            "fault", "block_index", "index_pre")}
    for n in range(x.shape[-1]):
        rows["index_pre"].append(int(st["index"]))
        st, _ = f(st, jnp.asarray(x[:, n:n + 1]))
        s = jax.device_get(st)
        rows["g"].append(s["gain_now"][np.arange(len(m)), m])
        for k in ("gain_change", "final_gain", "counter", "fault",
                  "block_index"):
            rows[k].append(s[k])
    return {k: np.stack(v, axis=-1) if k != "index_pre" else np.asarray(v)
            for k, v in rows.items()}


def test_tx_alc_decisions_match_jax_sample_by_sample():
    C, n = 4, 4 * B
    modes = [3, 5, 3, 5]                       # two modes, per-mode memory
    x = alc_input(C, n, 11)
    jop = jagc.TxALC.create(FS, mode=modes, channels=C)
    op = agc.TxALC.create(FS, mode=modes, channels=C, device=CPU)
    assert op.buf == jop.buf == A_SAMPLES
    ref = jax_alc_per_sample(jop, x)
    st = op.init_state(C)
    clips = []
    for i in range(n // B):
        st, _, cl = op.trace(st, torch.as_tensor(x[:, i * B:(i + 1) * B]))
        clips.append(cl.numpy())
    clips = np.concatenate(clips, axis=-1)
    # the JAX op's clip decisions from its states: a clip resets the
    # counters and sets block_index to the index; where block_index already
    # equals the index (a block-complete sample) the reset does not say
    # which branch ran, and the gain check below decides
    bi_pre = np.concatenate([np.zeros((C, 1), np.int32),
                             ref["block_index"][:, :-1]], axis=-1)
    idx = ref["index_pre"][None, :]
    reset = (ref["counter"] == 0) & (ref["fault"] == 0)
    known = bi_pre != idx
    j_clip = reset & (ref["block_index"] == idx)
    flips = int(np.sum((clips != j_clip) & known))
    assert flips == 0, flips
    assert clips.sum() > 20 and (~known).sum() > 0     # clips and blocks
    assert (idx == 0).sum() >= 2                       # index wrapped
    # the port's final state against the JAX op's
    assert np.array_equal(st["block_index"].numpy(),
                          ref["block_index"][:, -1])
    assert int(st["index"]) == (n % A_SAMPLES)
    for k in ("counter", "fault"):
        assert np.array_equal(st[k].numpy(), ref[k][:, -1]), k


def test_tx_alc_gains_match_jax_over_blocks():
    C, nblk = 4, 4
    modes = [3, 5, 4, 5]
    x = alc_input(C, nblk * B, 12)
    jop = jagc.TxALC.create(FS, mode=modes, channels=C)
    op = agc.TxALC.create(FS, mode=modes, channels=C, device=CPU)
    jst, pst = jop.init_state(C), op.init_state(C)
    assert pst["buffer"].dtype == torch.complex64
    xd = np.concatenate([np.zeros((C, A_SAMPLES), np.complex64), x], -1)
    n_live = 0
    for i in range(nblk):
        a = x[:, i * B:(i + 1) * B]
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.as_tensor(a))
        raw = xd[:, i * B:(i + 1) * B]
        live = np.abs(raw) > 1e-3            # none while the delay fills
        if not live.any():
            continue
        jg = np.abs(np.asarray(jy))[live] / np.abs(raw)[live]
        pg = np.abs(py.numpy())[live] / np.abs(raw)[live]
        assert np.max(np.abs(pg - jg) / jg) < 1e-5, i
        n_live += 1
        assert np.allclose(pst["gain_now"].numpy(),
                           np.asarray(jst["gain_now"]), rtol=1e-5, atol=0)
        for k in ("counter", "fault", "block_index", "index"):
            assert np.array_equal(pst[k].numpy(), np.asarray(jst[k])), k
    assert n_live >= 2
    # a mode switch keeps each mode's gain: channel 0 leaves USB for AM and
    # comes back with its USB gain
    g_usb = float(pst["gain_now"][0, 3])
    op_am = agc.TxALC.create(FS, mode=[4, 5, 4, 5], channels=C, device=CPU)
    pst2, _ = op_am(pst, torch.as_tensor(x[:, :B]))
    assert float(pst2["gain_now"][0, 3]) == g_usb
