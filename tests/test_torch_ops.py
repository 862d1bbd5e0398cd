"""Each op of the port against its JAX counterpart on the same inputs
(made with numpy, handed to both).  Both run float32 on the CPU; they sum
in other orders, so outputs are held to an SNR floor (or an absolute
tolerance of a few float32 ulps where the op is elementwise), and integer
phases to exact equality."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax.numpy as jnp
from quisk_tpu.ops import agc as jagc
from quisk_tpu.ops import demod as jdemod
from quisk_tpu.ops import design as jdesign
from quisk_tpu.ops import fir as jfir
from quisk_tpu.ops import iir as jiir
from quisk_tpu.ops import nco as jnco
from quisk_tpu.ops import resample as jresample

from quisk_tpu_torch.ops import agc, demod, fir, iir, nco, resample
from quisk_tpu_torch.modes import Mode

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """Run the port's CPU ops on one thread: on some CPU hosts torch's
    intra-op worker threads have returned elementwise transcendentals
    (cos) off by ~1e-4 for a whole worker's chunk, intermittently, which
    these SNR floors would catch as a port fault."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / (np.mean(np.abs(err) ** 2) + 1e-300))


def cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def t(a):
    return torch.as_tensor(np.asarray(a).copy())


def n(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ------------------------------------------------------------------- NCO
@pytest.mark.parametrize("freq", [-123456.7, 98765.4, 191999.0])
def test_nco_many_blocks(freq):
    C, B, fs = 8, 1024, 384000.0
    freqs = [freq + 1000.0 * i for i in range(C)]
    jop = jnco.NCO.create(freqs, fs, B, C)
    op = nco.NCO.create(freqs, fs, B, C, device=CPU)
    w = np.asarray(jop.word)
    assert np.array_equal(n(op.word).astype(np.uint32), w)
    if freq < 0:
        assert np.all(w >= 1 << 31)          # bit 31 set
    rng = np.random.default_rng(1)
    js, ps = jop.init_state(C), op.init_state(C)
    for _ in range(40):
        x = cnoise(rng, (C, B))
        js, jy = jop(js, x)
        ps, py = op(ps, t(x))
        assert np.array_equal(n(ps).astype(np.uint32), np.asarray(js))
        assert snr_db(jy, n(py)) > 120.0


def test_freq_word_equal():
    f = np.linspace(-480e3, 480e3, 101)
    assert np.array_equal(nco.freq_word(f, 960e3),
                          np.asarray(jnco.freq_word(f, 960e3)))


# ------------------------------------------------------------------- FIR
def _stream(jop, op, xs, jst, pst):
    for x in xs:
        jst, jy = jop(jst, x)
        pst, py = op(pst, t(x))
        yield np.asarray(jy), n(py)


@pytest.mark.parametrize("per_channel", [False, True])
def test_overlap_save(per_channel):
    C, B = 6, 512
    bands = [(300.0, 3100.0), (-3100.0, -300.0), (-3000.0, 3000.0)] * 2
    taps = np.stack([jdesign.bandpass_analytic(257, lo, hi, 48e3)
                     for lo, hi in bands])
    if not per_channel:
        taps = taps[0]
    jop = jfir.OverlapSaveFIR.create(taps, B)
    op = fir.OverlapSaveFIR.create(taps, B, device=CPU)
    assert np.array_equal(n(op.mask), np.asarray(jop.mask))
    rng = np.random.default_rng(2)
    xs = [cnoise(rng, (C, B)) for _ in range(3)]
    for jy, py in _stream(jop, op, xs, jop.init_state(C), op.init_state(C)):
        assert snr_db(jy, py) > 110.0


def test_overlap_save_retune_and_crossfade():
    C, B = 4, 512
    taps = jdesign.bandpass_analytic(257, 300.0, 3100.0, 48e3)
    new = jdesign.bandpass_analytic(257, -3100.0, -300.0, 48e3)
    jop = jfir.OverlapSaveFIR.create(taps, B)
    op = fir.OverlapSaveFIR.create(taps, B, device=CPU)
    assert np.array_equal(n(op.retuned(new).mask),
                          np.asarray(jop.retuned(new).mask))
    jx = jop.retune_crossfade(new, 4)
    px = op.retune_crossfade(new, 4)
    assert len(px) == 4
    rng = np.random.default_rng(3)
    jst, pst = jop.init_state(C), op.init_state(C)
    for ja, pa in zip(jx, px):
        assert np.array_equal(n(pa.mask), np.asarray(ja.mask))
        x = cnoise(rng, (C, B))
        jst, jy = ja(jst, x)
        pst, py = pa(pst, t(x))
        assert snr_db(jy, n(py)) > 110.0
    with pytest.raises(ValueError):
        op.retuned(np.ones(100))


@pytest.mark.parametrize("kind,decim,block", [
    ("halfband", 2, 2048), ("halfband", 2, 96),
    ("matmul", 5, 2560), ("matmul", 3, 384)])
def test_decimators(kind, decim, block):
    C = 4
    if kind == "halfband":
        taps = jdesign.halfband(45)
    else:
        taps = jdesign.decimator(decim, 240e3)
    jop = jfir.make_fir(taps, block, decim=decim)
    op = fir.make_fir(taps, block, decim=decim, device=CPU)
    assert type(op).__name__ == type(jop).__name__
    assert op.R == jop.R
    rng = np.random.default_rng(4)
    xs = [cnoise(rng, (C, block)) for _ in range(3)]
    jst, pst = jop.init_state(C), op.init_state(C)
    for jy, py in _stream(jop, op, xs, jst, pst):
        assert jy.shape == py.shape
        assert snr_db(jy, py) > 120.0


@pytest.mark.parametrize("complex_taps", [False, True])
def test_conv_fir(complex_taps):
    C, B, d = 3, 240, 3
    taps = jdesign.decimator(d, 144e3)
    if complex_taps:
        taps = jdesign.tune(taps, 5000.0, 144e3)
    jop = jfir.ConvFIR.create(taps, B, d)
    op = fir.make_fir(taps, B, decim=d, method="conv", device=CPU)
    rng = np.random.default_rng(5)
    xs = [cnoise(rng, (C, B)) for _ in range(3)]
    for jy, py in _stream(jop, op, xs, jop.init_state(C), op.init_state(C)):
        assert snr_db(jy, py) > 120.0


def test_frac_decim():
    C, B = 3, 2400
    jop = jresample.FracDecim.create(25 / 24, B)
    op = resample.FracDecim.create(25 / 24, B, device=CPU)
    assert (op.n_out, op.ratio_num, op.ratio_den) == (
        jop.n_out, jop.ratio_num, jop.ratio_den)
    rng = np.random.default_rng(6)
    xs = [cnoise(rng, (C, B)) for _ in range(3)]
    for jy, py in _stream(jop, op, xs, jop.init_state(C), op.init_state(C)):
        assert snr_db(jy, py) > 130.0


# ------------------------------------------------------------------- IIR
@pytest.mark.parametrize("B", [512, 2048])          # affine scan / chunked
@pytest.mark.parametrize("kind", ["onepole", "dcblock"])
def test_iir_branches(B, kind):
    C = 5
    if kind == "onepole":
        jop = jiir.OnePole.lowpass(300.0, 48e3)
        op = iir.OnePole.lowpass(300.0, 48e3, CPU)
        assert float(op.a) == float(jop.a) and float(op.b) == float(jop.b)
        jst, pst = jop.init_state(C), op.init_state(C)
    else:
        jop = jiir.DCBlock.create(0.995)
        op = iir.DCBlock.create(CPU, 0.995)
        jst, pst = jop.init_state(C), op.init_state(C)
    rng = np.random.default_rng(7)
    for _ in range(3):
        x = (rng.standard_normal((C, B)) + 0.5).astype(np.float32)
        jst, jy = jop(jst, x)
        pst, py = op(pst, t(x))
        assert snr_db(jy, n(py)) > 110.0


def test_scan_negative_coefficient():
    """The chunked branch builds powers as |a|^d sign(a)^d."""
    C, B = 3, 2048
    rng = np.random.default_rng(8)
    x = rng.standard_normal((C, B)).astype(np.float32)
    y0 = rng.standard_normal(C).astype(np.float32)
    a = np.float32(-0.9)
    jy = jiir._first_order_scan(jnp.asarray(x), jnp.float32(a), 1.0,
                                jnp.asarray(y0))
    py = iir.first_order_scan(t(x), torch.tensor(a), 1.0, t(y0))
    assert snr_db(jy, n(py)) > 110.0


class _AtenOps(TorchDispatchMode):
    """The names of the aten ops dispatched inside the context."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("layout", ["channel_major", "time_major"])
@pytest.mark.parametrize("kind", ["onepole", "dcblock"])
def test_one_pole_builds_its_constants_once(kind, layout):
    """OnePole and DCBlock build the scan's constants when they are made:
    one call at B = 2048 (the chunked form) runs none of the ops that
    make them (arange, pow, clamp, remainder) and turns no Python number
    into a tensor (on a card, an upload from pageable memory that waits)."""
    C, B = 4, 2048
    op = (iir.OnePole.lowpass(300.0, 48e3, CPU) if kind == "onepole"
          else iir.DCBlock.create(CPU, 0.995))
    x = t(np.random.default_rng(9).standard_normal((C, B)).astype(
        np.float32))
    call = op if layout == "channel_major" else op.apply_tm
    if layout == "time_major":
        x = x.T.contiguous()
    st = op.init_state(C)
    with _AtenOps() as ops:
        _, y = call(st, x)
    assert y.shape == x.shape
    assert {"mm", "bmm"} & set(ops.names)              # the chunked form
    assert not {"arange", "pow", "clamp", "remainder", "lift_fresh",
                "scalar_tensor"} & set(ops.names), ops.names


# ----------------------------------------------------------------- demod
def _demods(fs=48e3):
    return [(jdemod.SSBDemod.create(), demod.SSBDemod.create(CPU)),
            (jdemod.AMDemod.create(), demod.AMDemod.create(CPU)),
            (jdemod.FMDemod.create(fs, 5000.0),
             demod.FMDemod.create(fs, CPU, 5000.0))]


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("zeros", [False, True])
def test_demods(which, zeros):
    C, B = 4, 512
    jop, op = _demods()[which]
    jst, pst = jop.init_state(C), op.init_state(C)
    rng = np.random.default_rng(9)
    # a slowly wandering carrier: FM phase steps stay far from +-pi
    ph = np.cumsum(0.3 + 0.05 * rng.standard_normal((C, 3 * B)), axis=-1)
    sig = (np.exp(1j * ph) * (1.0 + 0.2 * np.sin(ph / 7))).astype(
        np.complex64)
    if zeros:
        sig[:] = 0
    for i in range(3):
        x = np.ascontiguousarray(sig[:, i * B:(i + 1) * B])
        jst, jy = jop(jst, x)
        pst, py = op(pst, t(x))
        jy, py = np.asarray(jy), n(py)
        if zeros:
            assert np.array_equal(py, np.zeros_like(py))
            assert np.array_equal(py, jy)
        else:
            assert snr_db(jy, py) > 100.0


def test_fm_gate():
    """|d| below 1e-12 gives exactly 0, not the angle of residue."""
    op = demod.FMDemod.create(48e3, CPU)
    x = torch.tensor([[1e-7 + 1e-7j, -1e-7 + 1e-7j, 1.0 + 0j, 1j]],
                     dtype=torch.complex64)
    _, disc = op.discriminate(torch.zeros(1, dtype=torch.complex64), x)
    assert disc[0, 1].item() == 0.0
    assert disc[0, 3].item() == pytest.approx(np.pi / 2, rel=1e-6)


def test_mixed_demod_and_ext():
    C, B = 8, 512
    modes = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM),
             int(Mode.EXT), int(Mode.CWU), int(Mode.AM), int(Mode.FM)]

    class Neg:                            # a custom demod: audio = -Re(x)
        def init_state(self, channels):
            return ()

        def __call__(self, state, x):
            return state, -x.real

    demod.register_ext_demod("neg", lambda fs, c, device: Neg())
    jop = jdemod.MixedDemod.create(modes, 48e3, C)
    op = demod.MixedDemod.create(modes, 48e3, C, ext_demod="neg", device=CPU)
    rng = np.random.default_rng(10)
    jst, pst = jop.init_state(C), op.init_state(C)
    for _ in range(2):
        x = cnoise(rng, (C, B))
        jst, jy = jop(jst, x)
        pst, py = op(pst, t(x))
        jy, py = np.asarray(jy), n(py)
        keep = [i for i in range(C) if modes[i] != int(Mode.EXT)]
        assert snr_db(jy[keep], py[keep]) > 100.0
        assert np.array_equal(py[4], -x[4].real)


# ------------------------------------------------------------------- AGC
@pytest.mark.parametrize("window", [1, 7, 720])
def test_sliding_max(window):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 1500)).astype(np.float32)
    assert np.array_equal(n(agc.sliding_max(t(x), window)),
                          np.asarray(jagc.sliding_max(jnp.asarray(x),
                                                      window)))


def test_min_scan():
    rng = np.random.default_rng(12)
    lim = rng.standard_normal((4, 2048)).astype(np.float32)
    lg0 = rng.standard_normal(4).astype(np.float32)
    inc = np.float32(1.4e-4)
    jr = np.asarray(jagc._min_scan(jnp.asarray(lim), jnp.float32(inc),
                                   jnp.asarray(lg0)))
    pr = n(agc.min_scan(t(lim), torch.tensor(inc), t(lg0)))
    assert np.max(np.abs(jr - pr)) < 1e-5
    # against the per-sample recurrence itself
    ref = np.empty_like(lim, dtype=np.float64)
    prev = lg0.astype(np.float64)
    for i in range(lim.shape[1]):
        prev = np.minimum(prev + float(inc), lim[:, i])
        ref[:, i] = prev
    assert np.max(np.abs(ref - pr)) < 1e-5


def test_agc():
    C, B = 4, 2048
    jop = jagc.AGC.create(48e3)
    op = agc.AGC.create(48e3, device=CPU)
    assert op.lookahead == jop.lookahead == 720
    jst, pst = jop.init_state(C), op.init_state(C)
    rng = np.random.default_rng(13)
    for i in range(4):
        scale = np.array([1e-3, 0.1, 1.0, 30.0], np.float32)[:, None]
        a = (rng.standard_normal((C, B)) * scale).astype(np.float32)
        jst, jy = jop(jst, a)
        pst, py = op(pst, t(a))
        if i:
            assert snr_db(jy, n(py)) > 100.0
        assert np.allclose(n(pst[1]), np.asarray(jst[1]), atol=1e-5)
