"""The port's PFB channelizers, grouped demods and PFB receiver against the
JAX package's on equal numpy inputs, state carried across blocks and
through ``convert`` both ways.

The JAX side runs its Pallas kernels in interpret mode on the CPU (as
tests/test_channelizer.py does); the port's wrappers take their plain
versions for CPU tensors, so ``pallas_poly`` / ``pallas_demod`` select the
same arithmetic here and the kernel routes' shapes, layouts and state.

Floors: channelizer outputs and non-FM audio >= 80 dB (both sides are
float32 and sum the IDFT in another order: pocketfft against XLA's FFT,
four real matmuls against a 3-product Karatsuba); the histories are equal
bit for bit; FM audio on noise by RMS within 0.1 dB (the discriminator
wraps at +-pi, where one rounding difference flips a sample by 2 pi and
the de-emphasis smears it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import channelizer as jch
from quisk_tpu.ops import demod as jdemod
from quisk_tpu.ops import iir as jiir

from quisk_tpu_torch import convert
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import channelizer as ch
from quisk_tpu_torch.ops import demod, iir
from quisk_tpu_torch.ops.pfb_kernels import pfb_demod_call

FS = 96000.0
MODES4 = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """torch on one thread, as the other parity files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / (np.mean(np.abs(err) ** 2) + 1e-300))


def rms_db(ref, got):
    return 20 * np.log10(np.sqrt(np.mean(np.asarray(got) ** 2))
                         / np.sqrt(np.mean(np.asarray(ref) ** 2)))


def cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def t(a):
    return torch.as_tensor(np.asarray(a).copy())


def tree_np(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(tree_np(v) for v in tree)
    return np.asarray(tree)


def quarters(K):
    return [MODES4[(4 * i) // K] for i in range(K)]


# --------------------------------------------------------------- prototype
@pytest.mark.parametrize("K,P,att", [(512, 8, 90.0), (4096, 8, 90.0),
                                     (64, 4, 70.0)])
def test_prototype_equal(K, P, att):
    assert np.array_equal(ch.pfb_prototype(K, P, att),
                          jch.pfb_prototype(K, P, att))


# ------------------------------------------------------------ channelizers
@pytest.mark.parametrize("pallas_poly", [False, True],
                         ids=["views", "kernel"])
@pytest.mark.parametrize("name", ["PFBChannelizer", "OversampledPFB"])
def test_channelizer_matches_jax(name, pallas_poly):
    K, S = 512, 2
    B = K * 16
    jop = getattr(jch, name).create(K, B, pallas_poly=pallas_poly)
    op = getattr(ch, name).create(K, B, pallas_poly=pallas_poly,
                                  device="cpu")
    assert np.array_equal(np.asarray(jop.h_poly), op.h_poly.numpy())
    rng = np.random.default_rng(50)
    js, ps = jop.init_state(S), op.init_state(S)
    assert ps.shape == js.shape and ps.dtype == torch.complex64
    for _ in range(2):
        x = cnoise(rng, (S, B))
        js, jy = jop(js, jnp.asarray(x))
        ps, py = op(ps, t(x))
        assert py.shape == np.asarray(jy).shape
        assert snr_db(jy, py.numpy()) > 80.0
        assert np.array_equal(np.asarray(js), ps.numpy())


def test_channelizer_continues_from_jax_state():
    """One block in JAX, its history carried across, one in the port; and
    the port's history back into the JAX op."""
    K, S = 512, 2
    B = K * 16
    jop = jch.OversampledPFB.create(K, B, pallas_poly=True)
    op = convert.pfb_from_numpy({"h_poly": np.asarray(jop.h_poly),
                                 "block": B, "pallas_poly": True,
                                 "oversampled": True}, "cpu")
    assert isinstance(op, ch.OversampledPFB) and op.P == 8
    rng = np.random.default_rng(51)
    x = [cnoise(rng, (S, B)) for _ in range(3)]
    js = jop.init_state(S)
    js, _ = jop(js, jnp.asarray(x[0]))
    ps, py = op(convert.state_from_numpy(np.asarray(js), "cpu"), t(x[1]))
    js, jy = jop(js, jnp.asarray(x[1]))
    assert snr_db(jy, py.numpy()) > 80.0
    _, jy2 = jop(convert.state_to_numpy(ps), jnp.asarray(x[2]))
    _, py2 = op(ps, t(x[2]))
    assert snr_db(jy2, py2.numpy()) > 80.0
    crit = convert.pfb_from_numpy({"h_poly": np.asarray(jop.h_poly),
                                   "block": B}, "cpu")
    assert isinstance(crit, ch.PFBChannelizer) and not crit.pallas_poly


def test_tone_lands_in_its_channel():
    K, B = 128, 128 * 32
    for cls, rate in ((ch.PFBChannelizer, 1), (ch.OversampledPFB, 2)):
        op = cls.create(K, B, device="cpu")
        c = 37
        x = np.exp(2j * np.pi * (c / K) * np.arange(2 * B)
                   ).astype(np.complex64)[None]
        st = op.init_state(1)
        for i in range(2):
            st, y = op(st, t(x[:, i * B:(i + 1) * B]))
        p = (y[0].abs() ** 2).mean(-1).numpy()
        assert y.shape == (1, K, rate * B // K)
        assert int(np.argmax(p)) == c
        assert 10 * np.log10(p[c] / np.delete(p, [c - 1, c, c + 1]).max()) > 80


def test_create_refuses_bad_shapes_and_the_matmul_dft():
    with pytest.raises(ValueError):
        ch.PFBChannelizer.create(128, 1000, device="cpu")
    with pytest.raises(ValueError):
        ch.OversampledPFB.create(127, 127 * 4, device="cpu")
    with pytest.raises(ValueError, match="pallas_demod"):
        ch.PFBRxPipeline.create(384, 384 * 4, int(Mode.USB), FS,
                                pallas_demod=True, device="cpu")
    for cls, args in ((ch.PFBChannelizer, (128, 1024)),
                      (ch.OversampledPFB, (128, 1024)),
                      (ch.PFBRxPipeline, (128, 1024, int(Mode.USB), FS))):
        with pytest.raises(TypeError, match="mxu_dft"):
            cls.create(*args, mxu_dft=True, device="cpu")
    with pytest.raises(RuntimeError):             # the default is the card
        ch.PFBChannelizer.create(128, 1024)


# ------------------------------------------------------- time-major one-pole
@pytest.mark.parametrize("T", [2048, 96])
def test_apply_tm_matches_jax(T):
    """Both branches: the chunked triangular matmul (T = 2048) and the
    log-step scan (T = 96), with a lead axis, over 2 blocks."""
    S, C = 2, 24
    jlp, jdc = jiir.OnePole.lowpass(300.0, FS), jiir.DCBlock.create(0.995)
    lp = iir.OnePole.lowpass(300.0, FS, "cpu")
    dc = iir.DCBlock.create("cpu", 0.995)
    rng = np.random.default_rng(52)
    jl, pl_ = jnp.zeros((S, C)), torch.zeros((S, C))
    jd = (jnp.zeros((S, C)), jnp.zeros((S, C)))
    pd = (torch.zeros((S, C)), torch.zeros((S, C)))
    for _ in range(2):
        x = rng.standard_normal((S, T, C)).astype(np.float32)
        jl, jy = jlp.apply_tm(jl, jnp.asarray(x))
        pl_, py = lp.apply_tm(pl_, t(x))
        assert snr_db(jy, py.numpy()) > 100.0
        jd, jy = jdc.apply_tm(jd, jnp.asarray(np.abs(x)))
        pd, py = dc.apply_tm(pd, t(np.abs(x)))
        assert snr_db(jy, py.numpy()) > 100.0
        assert np.allclose(np.asarray(jd[1]), pd[1].numpy(), atol=1e-5)
    # the time-major form equals the channel-major one on the transpose
    x = rng.standard_normal((T, C)).astype(np.float32)
    _, a = lp.apply_tm(torch.zeros(C), t(x))
    _, b = lp(torch.zeros(C), t(x.T))
    assert snr_db(b.numpy().T, a.numpy()) > 100.0


# ------------------------------------------------------------ grouped demods
RUN_MODES = ([int(Mode.USB)] * 5 + [int(Mode.AM)] * 7 + [int(Mode.FM)] * 6
             + [int(Mode.CWU)] * 3 + [int(Mode.FM)] * 4 + [int(Mode.AM)] * 7)


def _demod_arrays(jd, tm):
    am_dc = jd.am_dc if tm else jd.am.dc
    de = jd.fm_deemph if tm else jd.fm.deemph
    return {"runs": jd.runs,
            "ssb_gain": np.asarray(jd.ssb_gain if tm else jd.ssb.gain),
            "am_gain": np.asarray(jd.am_gain if tm else jd.am.gain),
            "fm_gain": np.asarray(jd.fm_gain if tm else jd.fm.gain),
            "am_pole": np.asarray(am_dc.a), "fm_a": np.asarray(de.a),
            "fm_b": np.asarray(de.b)}


def _fm_columns(runs):
    return np.concatenate([np.arange(lo, hi) for f, lo, hi in runs
                           if f == "fm"])


def test_grouped_demod_matches_jax():
    C, Bc = len(RUN_MODES), 512
    jd = jdemod.GroupedDemod.create(RUN_MODES, FS, C)
    made = demod.GroupedDemod.create(RUN_MODES, FS, C, device="cpu")
    conv = convert.grouped_demod_from_numpy(_demod_arrays(jd, False), "cpu")
    assert made.runs == conv.runs == tuple(jd.runs) and len(made.runs) == 6
    assert torch.equal(made.fm.gain, conv.fm.gain)
    assert torch.equal(made.fm.deemph.a, conv.fm.deemph.a)
    fm = _fm_columns(jd.runs)
    other = np.setdiff1d(np.arange(C), fm)
    rng = np.random.default_rng(53)
    js, ps = jd.init_state(C), conv.init_state(C)
    for blk in range(3):
        x = cnoise(rng, (C, Bc))
        js, ja = jd(js, jnp.asarray(x))
        if blk == 1:         # carry the JAX state across mid-stream
            ps = convert.state_from_numpy(tree_np(js), "cpu")
        else:
            ps, pa = conv(ps, t(x))
            assert snr_db(np.asarray(ja)[other], pa.numpy()[other]) > 100.0
            assert abs(rms_db(np.asarray(ja)[fm], pa.numpy()[fm])) < 0.1


@pytest.mark.parametrize("T", [64, 2048])
def test_grouped_demod_tm_matches_jax(T):
    C, S = len(RUN_MODES), 2
    jd = jdemod.GroupedDemodTM.create(RUN_MODES, FS, C)
    made = demod.GroupedDemodTM.create(RUN_MODES, FS, C, device="cpu")
    conv = convert.grouped_demod_tm_from_numpy(_demod_arrays(jd, True),
                                               "cpu")
    for f in ("ssb_gain", "am_gain", "fm_gain"):
        assert torch.equal(getattr(made, f), getattr(conv, f))
    assert torch.equal(made.am_dc.a, conv.am_dc.a)
    assert torch.equal(made.fm_deemph.b, conv.fm_deemph.b)
    assert made.runs == conv.runs == tuple(jd.runs)
    fm = _fm_columns(jd.runs)
    other = np.setdiff1d(np.arange(C), fm)
    rng = np.random.default_rng(54)
    js, ps = jd.init_state(C, lead=(S,)), made.init_state(C, lead=(S,))
    assert [len(s) for s in ps] == [len(s) for s in js]
    for blk in range(3):
        z = cnoise(rng, (S, T, C))
        z[:, :, fm[0]] = np.exp(1j * 0.3 * (np.arange(T) + blk * T))  # carrier
        js, ja = jd(js, jnp.asarray(z.real), jnp.asarray(z.imag))
        ps, pa = made(ps, t(z.real), t(z.imag))
        ja, pa = np.asarray(ja), pa.numpy()
        assert pa.shape == (S, T, C)
        assert snr_db(ja[..., other], pa[..., other]) > 100.0
        assert snr_db(ja[..., fm[0]], pa[..., fm[0]]) > 80.0
        assert abs(rms_db(ja[..., fm[1:]], pa[..., fm[1:]])) < 0.1
        if blk == 0:         # through convert and back mid-stream
            back = convert.state_to_numpy(ps)
            ps = convert.state_from_numpy(back, "cpu")
            assert [tuple(a.shape for a in s) for s in back] == [
                tuple(np.asarray(a).shape for a in s) for s in js]


# -------------------------------------------------------------- PFB receiver
def _pipe_arrays(jp, B, pallas_poly):
    kd = None
    if jp.kd is not None:
        kd = tree_np(jp.kd)
    return {"pfb": {"h_poly": np.asarray(jp.pfb.h_poly), "block": B,
                    "pallas_poly": pallas_poly},
            "demod": _demod_arrays(jp.demod, True), "kd": kd,
            "with_spectrum": jp.with_spectrum}


@pytest.fixture(scope="module", params=[False, True],
                ids=["torch_ops", "kernels"])
def jax_pipeline(request):
    """3 blocks through the JAX receiver at K=256, B=256*16 (n_out=32),
    S=2, TT=8; its outputs per block unpermuted by its own chan_pos, and
    its state after block 1."""
    kern = request.param
    K, S = 256, 2
    B = K * 16
    n_out = 2 * B // K
    jp = jch.PFBRxPipeline.create(K, B, quarters(K), channel_rate=FS,
                                  mxu_dft=False, pallas_poly=kern,
                                  pallas_demod=kern, TT=8)
    rng = np.random.default_rng(55)
    xs = [cnoise(rng, (S, B)) for _ in range(3)]
    tt = np.arange(3 * B)
    # an FM carrier with a tone on the centre of FM channel 200
    car = np.exp(2j * np.pi * (200 / K) * tt + 2j * np.sin(
        2 * np.pi * 0.0004 * tt))
    for i, x in enumerate(xs):
        x += 4.0 * car[None, i * B:(i + 1) * B].astype(np.complex64)
    st = jp.init_state(S)
    outs, mid = [], None
    for i, x in enumerate(xs):
        st, (a, sp) = jp(st, jnp.asarray(x))
        a = np.asarray(a)
        if kern:
            a = a.reshape(S, n_out, K)[:, :, jp.chan_pos]
        outs.append((a, np.asarray(sp)))
        if i == 0:
            mid = tree_np(st)
    return dict(kern=kern, K=K, B=B, S=S, n_out=n_out, xs=xs, outs=outs,
                mid=mid, final=tree_np(st),
                arrays=_pipe_arrays(jp, B, kern), jp=jp)


def _assert_pipeline_block(run, ja, jsp, pa, psp, pipe):
    K, S, n_out = run["K"], run["S"], run["n_out"]
    pa = pa.numpy()
    if run["kern"]:
        assert pa.shape == (S, n_out * pipe.K1, pipe.K2)
        pa = pa.reshape(S, n_out, K)[:, :, pipe.chan_pos]
    assert pa.shape == ja.shape == (S, n_out, K)
    fm = np.arange(3 * K // 4, K)
    noise_fm = fm[(fm < 197) | (fm > 203)]      # off the carrier's skirt
    assert snr_db(ja[..., :3 * K // 4], pa[..., :3 * K // 4]) > 80.0
    assert snr_db(ja[..., 200], pa[..., 200]) > 80.0
    assert abs(rms_db(ja[..., noise_fm], pa[..., noise_fm])) < 0.1
    assert psp.shape == (S, K)
    assert np.allclose(psp.numpy(), jsp, rtol=1e-4, atol=1e-9)


def test_pipeline_matches_jax(jax_pipeline):
    run = jax_pipeline
    pipe = ch.PFBRxPipeline.create(run["K"], run["B"], quarters(run["K"]),
                                   channel_rate=FS, pallas_poly=run["kern"],
                                   pallas_demod=run["kern"], device="cpu")
    st = pipe.init_state(run["S"])
    for x, (ja, jsp) in zip(run["xs"], run["outs"]):
        st, (pa, psp) = pipe(st, t(x))
        _assert_pipeline_block(run, ja, jsp, pa, psp, pipe)
    # the final state has the JAX state's layout and, off the FM
    # de-emphasis, its values
    back = convert.state_to_numpy(st)
    assert np.array_equal(back[0], run["final"][0])
    if run["kern"]:
        K1 = pipe.K1
        assert back[1].shape == run["final"][1].shape == (2, 5 * K1, 128)
        for rows in (slice(0, 2 * K1), slice(3 * K1, 5 * K1)):
            assert np.max(np.abs(back[1][:, rows]
                                 - run["final"][1][:, rows])) < 2e-4
    else:
        assert [len(s) for s in back[1]] == [len(s) for s in run["final"][1]]


def test_pipeline_through_convert_both_ways(jax_pipeline):
    """Parameters from the JAX pipeline's arrays; block 0 in JAX, its state
    carried across, blocks 1-2 in the port; then the port's state back into
    the JAX pipeline for one more block."""
    run = jax_pipeline
    pipe = convert.pfb_pipeline_from_numpy(run["arrays"], "cpu")
    made = ch.PFBRxPipeline.create(run["K"], run["B"], quarters(run["K"]),
                                   channel_rate=FS, pallas_poly=run["kern"],
                                   pallas_demod=run["kern"], device="cpu")
    assert pipe.pallas_demod == made.pallas_demod == run["kern"]
    assert pipe.pfb.pallas_poly == run["kern"]
    for f in ("K1", "K2", "g_ssb", "g_am", "g_fm", "a_dc", "a_de", "b_de"):
        assert getattr(pipe, f) == getattr(made, f), f
    if run["kern"]:
        flat = lambda kd: [kd[0], *kd[1], *kd[2], kd[3], kd[4]]  # noqa: E731
        assert all(torch.equal(a, b) for a, b in zip(flat(pipe.kd),
                                                     flat(made.kd)))
    st = convert.state_from_numpy(run["mid"], "cpu")
    for i in (1, 2):
        st, (pa, psp) = pipe(st, t(run["xs"][i]))
        _assert_pipeline_block(run, *run["outs"][i], pa, psp, pipe)
    back = convert.state_to_numpy(st)
    rng = np.random.default_rng(56)
    x = cnoise(rng, (run["S"], run["B"]))
    jp = run["jp"]
    jst = (back[0], (jnp.asarray(back[1]) if run["kern"] else back[1]))
    _, (ja, jsp) = jp(jst, jnp.asarray(x))
    _, (pa, psp) = pipe(st, t(x))
    ja = np.asarray(ja)
    if run["kern"]:
        ja = ja.reshape(run["S"], run["n_out"], run["K"])[:, :, jp.chan_pos]
    # the carrier is gone from this block: channel 200 is FM on noise now
    fm0 = 3 * run["K"] // 4
    pa_u = pa.numpy()
    if run["kern"]:
        pa_u = pa_u.reshape(ja.shape)[:, :, pipe.chan_pos]
    assert snr_db(ja[..., :fm0], pa_u[..., :fm0]) > 80.0
    assert abs(rms_db(ja[..., fm0:], pa_u[..., fm0:])) < 0.5
    assert np.allclose(psp.numpy(), np.asarray(jsp), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("built", ["create", "convert"])
def test_pipeline_power_row_in_channel_order(built):
    """The kernel route's power row is the fused kernel's sums, held at
    position ``chan_pos[c]`` for channel c, gathered at ``chan_pos``: bit
    for bit, for a pipeline from ``create`` and from ``convert``'s
    construction (the step reorders by a transpose, uploading nothing)."""
    K, B, S = 256, 256 * 16, 2
    if built == "create":
        pipe = ch.PFBRxPipeline.create(K, B, quarters(K), channel_rate=FS,
                                       pallas_poly=True, pallas_demod=True,
                                       device="cpu")
    else:
        jp = jch.PFBRxPipeline.create(K, B, quarters(K), channel_rate=FS,
                                      mxu_dft=False, pallas_poly=True,
                                      pallas_demod=True, TT=8)
        pipe = convert.pfb_pipeline_from_numpy(_pipe_arrays(jp, B, True),
                                               "cpu")
    x = t(cnoise(np.random.default_rng(58), (S, B)))
    st = pipe.init_state(S)
    _, (_, spec) = pipe(st, x)
    _, v = pipe.pfb.poly_stacked(st[0], x)
    _, (twr, twi), (w2r, w2i), am_m, fm_m = pipe.kd
    _, sums, _ = pfb_demod_call(
        pipe.stage1(v), st[1], twr, twi, w2r, w2i, am_m, fm_m,
        g_ssb=pipe.g_ssb, g_am=pipe.g_am, g_fm=pipe.g_fm, a_dc=pipe.a_dc,
        a_de=pipe.a_de, b_de=pipe.b_de)
    pos = torch.as_tensor(pipe.chan_pos)
    assert torch.equal(spec, (sums.reshape(S, -1) * (1.0 / v.shape[1]))[:,
                                                                       pos])


def test_pipeline_routes_agree_in_the_port():
    """The kernel route's layout against the torch-op route's, unpermuted:
    the two differ only in how the IDFT is summed."""
    K, B, S = 256, 256 * 16, 1
    a = ch.PFBRxPipeline.create(K, B, quarters(K), channel_rate=FS,
                                device="cpu")
    b = ch.PFBRxPipeline.create(K, B, quarters(K), channel_rate=FS,
                                pallas_poly=True, pallas_demod=True,
                                with_spectrum=False, device="cpu")
    assert np.array_equal(b.chan_perm[b.chan_pos], np.arange(K))
    rng = np.random.default_rng(57)
    sa, sb = a.init_state(S), b.init_state(S)
    for _ in range(2):
        x = t(cnoise(rng, (S, B)))
        sa, (aa, spa) = a(sa, x)
        sb, (ab, spb) = b(sb, x)
        ab = ab.reshape(S, -1, K)[:, :, b.chan_pos]
        nf = 3 * K // 4
        assert snr_db(aa[..., :nf].numpy(), ab[..., :nf].numpy()) > 80.0
        assert spa.shape == (S, K) and spb.shape == (S, 1)
