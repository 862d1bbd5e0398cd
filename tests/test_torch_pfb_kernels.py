"""The plain PyTorch versions of the PFB kernels (quisk_tpu_torch/ops/
pfb_kernels.py) against the JAX package's Pallas kernels called directly,
in interpret mode on the CPU, on equal numpy inputs.

The polyphase sums are P (or 2P) products and additions per output in the
same order on both sides: held to >= 100 dB (they differ by a fused
multiply-add here and there).  The fused IDFT + demod kernel sums its
128-point product in another order (four real matmuls against the
3-product Karatsuba) and runs its one-poles as a scan against triangular
products: non-FM channels are held to >= 80 dB and 2e-4 absolute (the JAX
package's own test of its kernel against its XLA route allows 5e-3,
tests/test_channelizer.py:231), FM channels on noise to an RMS within
0.1 dB (the discriminator wraps at +-pi, where a rounding difference flips
a sample by 2 pi), FM channels with a carrier to >= 80 dB.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import pallas_kernels as jpk
from quisk_tpu.ops.channelizer import PFBRxPipeline as JPipeline
from quisk_tpu.ops.channelizer import pfb_prototype as jprototype

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import pfb_kernels as pk
from quisk_tpu_torch.ops.channelizer import PFBRxPipeline

FS = 96000.0


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """torch on one thread, as the other parity files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / (np.mean(err ** 2) + 1e-300))


def cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _h_poly(K, P=8):
    return jprototype(K, P).reshape(P, K).astype(np.float32)


# ------------------------------------------------------------ polyphase sums
@pytest.mark.parametrize("K,mult,S", [(512, 16, 2), (256, 8, 1)])
def test_poly_oversampled_plain_matches_pallas(K, mult, S):
    P, M = 8, K // 2
    B = K * mult
    n_out = B // M
    rng = np.random.default_rng(40)
    hist = cnoise(rng, (S, (2 * P - 1) * M))
    x = cnoise(rng, (S, B))
    h = _h_poly(K)
    v = pk.pfb_poly_oversampled_plain(torch.as_tensor(hist),
                                      torch.as_tensor(x), torch.as_tensor(h))
    assert v.shape == (S, n_out, 2, K) and v.is_contiguous()
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(v, pk.pfb_poly_oversampled(
        torch.as_tensor(hist), torch.as_tensor(x), torch.as_tensor(h)))
    G = np.concatenate([hist, x], axis=-1).reshape(S, n_out + 2 * P - 1, M)
    for s in range(S):
        jr, ji = jpk.pfb_poly_oversampled(
            jnp.asarray(G[s].real), jnp.asarray(G[s].imag), jnp.asarray(h),
            n_out, interpret=True)
        ref = np.stack([np.asarray(jr)[:, ::-1], np.asarray(ji)[:, ::-1]], 1)
        assert snr_db(ref, v[s].numpy()) > 100.0
        assert np.max(np.abs(ref - v[s].numpy())) < 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("K,mult,S", [(512, 16, 2), (128, 8, 1)])
def test_poly_critical_plain_matches_pallas(K, mult, S):
    P = 8
    B = K * mult
    n_out = B // K
    rng = np.random.default_rng(41)
    hist = cnoise(rng, (S, (P - 1) * K))
    x = cnoise(rng, (S, B))
    h = _h_poly(K)
    v = pk.pfb_poly_critical_plain(torch.as_tensor(hist), torch.as_tensor(x),
                                   torch.as_tensor(h))
    assert v.shape == (S, n_out, 2, K)
    assert torch.equal(v, pk.pfb_poly_critical(
        torch.as_tensor(hist), torch.as_tensor(x), torch.as_tensor(h)))
    F = np.concatenate([hist, x], axis=-1).reshape(S, n_out + P - 1, K)
    for s in range(S):
        jr, ji = jpk.pfb_poly_critical(
            jnp.asarray(F[s].real), jnp.asarray(F[s].imag), jnp.asarray(h),
            n_out, interpret=True)
        ref = np.stack([np.asarray(jr)[:, ::-1], np.asarray(ji)[:, ::-1]], 1)
        assert snr_db(ref, v[s].numpy()) > 100.0


@pytest.mark.parametrize("hop", [1, 2])
def test_poly_plain_other_tap_counts_and_odd_blocks(hop):
    """P = 3 and a frame count no tile divides, against a float64 loop over
    the definition v[m, j] = sum_p G[m + hop*p + hh, q] h_poly[P-1-p, j]."""
    K, P, n_out, S = 12, 3, 7, 2
    Mf = K // hop
    rng = np.random.default_rng(42)
    hist = cnoise(rng, (S, (hop * P - 1) * Mf))
    x = cnoise(rng, (S, n_out * Mf))
    h = rng.standard_normal((P, K)).astype(np.float32)
    fn = pk.pfb_poly_critical if hop == 1 else pk.pfb_poly_oversampled
    v = fn(torch.as_tensor(hist), torch.as_tensor(x), torch.as_tensor(h))
    G = np.concatenate([hist, x], -1).reshape(S, -1, Mf).astype(np.complex128)
    ref = np.zeros((S, n_out, K), np.complex128)
    for j in range(K):
        hh, q = divmod(K - 1 - j, Mf)
        for p in range(P):
            ref[:, :, j] += (G[:, hop * p + hh: hop * p + hh + n_out, q]
                             * float(h[P - 1 - p, j]))
    got = v[:, :, 0].numpy() + 1j * v[:, :, 1].numpy()
    assert np.max(np.abs(got - ref)) < 1e-5


def test_poly_wrappers_refuse_bad_inputs():
    h = torch.zeros((8, 16))
    x = torch.zeros((1, 64), dtype=torch.complex64)
    hist = torch.zeros((1, 15 * 8), dtype=torch.complex64)
    with pytest.raises(ValueError, match="multiple"):
        pk.pfb_poly_oversampled(hist, x[:, :60], h)
    with pytest.raises(ValueError, match="hist"):
        pk.pfb_poly_oversampled(hist[:, 1:], x, h)
    with pytest.raises(TypeError, match="complex64"):
        pk.pfb_poly_critical(torch.zeros((1, 7 * 16)), x, h)
    with pytest.raises(ValueError, match="contiguous"):
        pk.pfb_poly_critical(torch.zeros((1, 7 * 16), dtype=torch.complex64),
                             torch.zeros((1, 128),
                                         dtype=torch.complex64)[:, ::2], h)


# ---------------------------------------------------- stage-2 IDFT + demod
MODES4 = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]


def _pipes(K, B, mode_vec, TT):
    jp = JPipeline.create(K, B, mode_vec, channel_rate=FS,
                          pallas_demod=True, TT=TT)
    pp = PFBRxPipeline.create(K, B, mode_vec, channel_rate=FS,
                              pallas_demod=True, device="cpu")
    return jp, pp


def _jax_demod(jp, bb, st):
    w1x, (twr, twi), (w2r, w2i, w2s), am_m, fm_m, tdc, tde, dec = jp.kd
    return jpk.pfb_demod_call(
        jnp.asarray(bb), jnp.asarray(st), twr, twi, w2r, w2i, w2s, am_m,
        fm_m, tdc, tde, dec, TT=jp.TT, K1=jp.K1, K2=jp.K2, g_ssb=jp.g_ssb,
        g_am=jp.g_am, g_fm=jp.g_fm, b_de=jp.b_de, interpret=True)


def _port_demod(pp, bb, st, fn=pk.pfb_demod_plain):
    _, (twr, twi), (w2r, w2i), am_m, fm_m = pp.kd
    return fn(torch.as_tensor(bb), torch.as_tensor(st), twr, twi, w2r, w2i,
              am_m, fm_m, g_ssb=pp.g_ssb, g_am=pp.g_am, g_fm=pp.g_fm,
              a_dc=pp.a_dc, a_de=pp.a_de, b_de=pp.b_de)


def test_demod_constants_equal_jax():
    K, B = 512, 512 * 16
    mode_vec = [MODES4[(4 * i) // K] for i in range(K)]
    jp, pp = _pipes(K, B, mode_vec, 8)
    w1x, (twr, twi), (w2r, w2i, _), am_m, fm_m, tdc, _, dec = jp.kd
    for a, b in ((w1x, pp.kd[0]), (twr, pp.kd[1][0]), (twi, pp.kd[1][1]),
                 (w2r, pp.kd[2][0]), (w2i, pp.kd[2][1]), (am_m, pp.kd[3]),
                 (fm_m, pp.kd[4])):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert (pp.g_ssb, pp.g_am, pp.g_fm, pp.b_de) == (jp.g_ssb, jp.g_am,
                                                     jp.g_fm, jp.b_de)
    assert np.float32(pp.a_dc) == np.asarray(dec)[0, 0]
    assert np.float32(pp.a_de) == np.asarray(dec)[0, 1]
    assert np.array_equal(pp.chan_perm, jp.chan_perm)
    assert np.array_equal(pp.chan_pos, jp.chan_pos)


@pytest.mark.parametrize("masks", ["mixed", "all_am", "all_fm"])
def test_demod_plain_matches_pallas(masks):
    """3 streamed calls on stage-1 planes of noise, the carry fed on from a
    random entering state, S = 2; K1 = 4, n_out = 32, TT = 8 (4 tiles)."""
    K, n_out, S = 512, 32, 2
    B = K * n_out // 2
    mode_vec = {"mixed": [MODES4[(4 * i) // K] for i in range(K)],
                "all_am": [int(Mode.AM)] * K,
                "all_fm": [int(Mode.FM)] * K}[masks]
    jp, pp = _pipes(K, B, mode_vec, 8)
    K1, K2 = jp.K1, jp.K2
    rng = np.random.default_rng(43)
    st0 = (0.1 * rng.standard_normal((S, 5 * K1, K2))).astype(np.float32)
    st0[:, 3 * K1:4 * K1] = np.abs(st0[:, 3 * K1:4 * K1])      # an envelope
    j_st = [st0[s] for s in range(S)]
    p_st = torch.as_tensor(st0)
    fm_pos = pp.kd[4].numpy().reshape(-1) > 0
    for blk in range(3):
        bb = (rng.standard_normal((S, n_out * 2 * K1, K2)) / np.sqrt(K)
              ).astype(np.float32)
        pa, psp, p_st = _port_demod(pp, bb, p_st.numpy())
        assert pa.shape == (S, n_out * K1, K2) and psp.shape == (S, K1, K2)
        for s in range(S):
            ja, jsp, jst = _jax_demod(jp, bb[s], j_st[s])
            j_st[s] = np.asarray(jst)
            ja = np.asarray(ja).reshape(n_out, K)
            ga = pa[s].numpy().reshape(n_out, K)
            if (~fm_pos).any():
                assert snr_db(ja[:, ~fm_pos], ga[:, ~fm_pos]) > 80.0
                assert np.max(np.abs(ja[:, ~fm_pos] - ga[:, ~fm_pos])) < 2e-4
            if fm_pos.any():
                db = 20 * np.log10(np.sqrt(np.mean(ga[:, fm_pos] ** 2))
                                   / np.sqrt(np.mean(ja[:, fm_pos] ** 2)))
                assert abs(db) < 0.1, (blk, s, db)
            assert np.allclose(psp[s].numpy(), np.asarray(jsp), rtol=1e-4)
            # carries: z, env, y_dc everywhere; y_de off the FM rows is
            # the de-emphasis of noise-driven wraps, held by the audio
            got = p_st[s].numpy().reshape(5, K1 * K2)
            want = j_st[s].reshape(5, K1 * K2)
            for row in (0, 1, 3, 4):
                assert np.max(np.abs(got[row] - want[row])) < 2e-4, row


def test_demod_plain_fm_carrier_matches_pallas():
    """An FM carrier (a rotating phasor per channel, well above the noise)
    makes the discriminator well conditioned: all-FM audio sample by
    sample."""
    K, n_out = 256, 64
    jp, pp = _pipes(K, K * n_out // 2, [int(Mode.FM)] * K, 8)
    K1, K2 = jp.K1, jp.K2
    rng = np.random.default_rng(44)
    # build z[t, c] = exp(j phi_c[t]) and invert the kernel's stage 2 and
    # twiddle numerically to get the planes that produce it
    t = np.arange(n_out)[:, None]
    dev = rng.uniform(0.05, 0.6, K)[None, :]
    z = np.exp(1j * (dev * t + 0.8 * np.sin(0.3 * t + dev)))
    z = z + 0.01 * cnoise(rng, z.shape)
    _, (twr, twi), (w2r, w2i), _, _ = pp.kd
    W2 = w2r.numpy().astype(np.complex128) + 1j * w2i.numpy()
    tw = twr.numpy().astype(np.complex128) + 1j * twi.numpy()
    zp = z.reshape(n_out, K1, K2)          # positions (c1, c2)
    c = zp @ np.linalg.inv(W2)
    sgn = 1 - 2 * ((t % 2)[:, :, None] * (np.arange(K1) % 2)[None, :, None])
    b = c * sgn / tw[None]
    bb = np.stack([b.real, b.imag], axis=1).reshape(1, n_out * 2 * K1, K2)
    bb = bb.astype(np.float32)
    st = np.zeros((1, 5 * K1, K2), np.float32)
    pa, _, pst = _port_demod(pp, bb, st)
    ja, _, jst = _jax_demod(jp, bb[0], st[0])
    assert snr_db(np.asarray(ja)[K1:], pa[0].numpy()[K1:]) > 80.0
    assert np.max(np.abs(np.asarray(jst) - pst[0].numpy())) < 2e-4
    assert float(np.sqrt(np.mean(pa[0].numpy() ** 2))) > 0.05


def test_demod_wrapper_takes_plain_on_cpu_and_counts_nothing():
    K, n_out = 256, 16
    _, pp = _pipes(K, K * n_out // 2, [MODES4[(4 * i) // K]
                                       for i in range(K)], 8)
    rng = np.random.default_rng(45)
    bb = rng.standard_normal((1, n_out * 2 * pp.K1, 128)).astype(np.float32)
    st = np.zeros((1, 5 * pp.K1, 128), np.float32)
    before = pk.pfb_demod_call.launches
    a = _port_demod(pp, bb, st, pk.pfb_demod_call)
    b = _port_demod(pp, bb, st)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert pk.pfb_demod_call.launches == before
    assert pk.pfb_poly_oversampled.launches == 0
    assert pk.pfb_poly_critical.launches == 0


def test_demod_wrapper_refuses_bad_inputs():
    K1 = 2
    z = lambda *s: torch.zeros(s)                      # noqa: E731
    good = dict(bb=z(1, 8 * 2 * K1, 128), st=z(1, 5 * K1, 128),
                twr=z(K1, 128), twi=z(K1, 128), w2r=z(128, 128),
                w2i=z(128, 128), am=z(K1, 128), fm=z(K1, 128))
    kw = dict(g_ssb=2.0, g_am=2.0, g_fm=1.0, a_dc=0.9, a_de=0.9, b_de=0.1)
    pk.pfb_demod_call(*good.values(), **kw)
    for name, bad, exc in (("bb", z(1, 8 * 2 * K1, 64), ValueError),
                           ("bb", z(1, 8 * 2 * K1 + 1, 128), ValueError),
                           ("st", z(1, 4 * K1, 128), ValueError),
                           ("w2r", z(128, 128).double(), TypeError),
                           ("am", z(K1, 256)[:, ::2], ValueError)):
        with pytest.raises(exc):
            pk.pfb_demod_call(*{**good, name: bad}.values(), **kw)
