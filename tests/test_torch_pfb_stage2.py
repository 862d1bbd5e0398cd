"""What the PFB demod kernel (quisk_tpu_torch/csrc/pfb_demod.cu) relies on,
held on the CPU, where the kernel itself cannot run.

- The stage-2 basis that PFBRxPipeline builds is the 128-point inverse DFT
  times a rotation of its columns, r = w2[0]: the wrapper's structure check
  accepts it and refuses anything else.
- The kernel's factorisation of that transform (four 32-point DFTs across
  the lanes of a warp by decimation in frequency, a twiddle, a 4-point DFT
  in registers, the rotation), written here in numpy in float32 as the
  kernel computes it, gives the plain version's stage-2 product to within
  1e-5 of the peak.
- The plain version over n_out frames equals the same frames streamed in
  chunks, carries handed on; and the kernel's two-launch carry algebra
  (each chunk's one-poles run from zero, then the carries folded across
  chunks in order and a^(k+1) * carry added to AM and FM positions) gives
  the one-call result, a ragged last chunk included.  The carry algebra is
  exact in real arithmetic; the two sides round differently, so audio is
  held to 1e-5 of its peak and spec to 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import pfb_kernels as pk
from quisk_tpu_torch.ops.channelizer import PFBRxPipeline

FS = 96000.0
K2 = 128
MODES4 = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """torch on one thread, as the other parity files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pipe(K, mode_vec=None):
    mode_vec = ([MODES4[(4 * i) // K] for i in range(K)] if mode_vec is None
                else mode_vec)
    return PFBRxPipeline.create(K, 2 * K, mode_vec, channel_rate=FS,
                                pallas_demod=True, device="cpu")


def _kw(pp):
    return dict(g_ssb=pp.g_ssb, g_am=pp.g_am, g_fm=pp.g_fm, a_dc=pp.a_dc,
                a_de=pp.a_de, b_de=pp.b_de)


def _random_state(rng, S, K1):
    st = (0.1 * rng.standard_normal((S, 5, K1, K2))).astype(np.float32)
    st[:, 3] = np.abs(st[:, 3])                             # an envelope
    return torch.as_tensor(st.reshape(S, 5 * K1, K2))


# ------------------------------------------------------- structure of w2
@pytest.mark.parametrize("K", [256, 512, 4096])
def test_stage2_rotation_accepts_the_pipeline_basis(K):
    _, _, (w2r, w2i), _, _ = _pipe(K).kd
    r = pk._stage2_rotation(w2r, w2i)
    assert r.shape == (K2,)
    assert np.array_equal(r, w2r[0].double().numpy()
                          + 1j * w2i[0].double().numpy())
    assert np.allclose(np.abs(r), 1.0, atol=1e-6)
    # a second call with the same constants is answered from the cache
    assert pk._stage2_rotation(w2r, w2i) is r


def test_stage2_rotation_refuses_other_bases():
    _, _, (w2r, w2i), _, _ = _pipe(256).kd
    bad = w2r.clone()
    bad[5, 7] += 1e-3
    with pytest.raises(ValueError, match="inverse DFT"):
        pk._stage2_rotation(bad, w2i)
    rng = np.random.default_rng(50)
    with pytest.raises(ValueError, match="inverse DFT"):
        pk._stage2_rotation(
            torch.as_tensor(rng.standard_normal((K2, K2)), dtype=torch.float32),
            w2i)
    # an edit in place after a check is seen (the version moves)
    w2 = w2r.clone()
    pk._stage2_rotation(w2, w2i)
    w2[3, 3] = 0.0
    with pytest.raises(ValueError, match="inverse DFT"):
        pk._stage2_rotation(w2, w2i)


# ------------------------------------------------ the kernel's FFT in numpy
def _kernel_stage2(br, bi, twr, twi, r, sg):
    """Stage 2 as csrc/pfb_demod.cu computes it, in float32: br, bi, twr,
    twi [..., 128] (n2), r [128] complex, sg [...] the frame's sign.
    Returns z [..., 128] (c2) complex64."""
    f32 = np.float32
    tab = pk._fft_twiddles(torch.device("cpu")).numpy()      # [2, 128]
    assert np.array_equal(tab, np.stack(
        [np.cos(2 * np.pi * np.arange(K2) / K2),
         np.sin(2 * np.pi * np.arange(K2) / K2)]).astype(f32))
    W = tab[0] + 1j * tab[1].astype(np.complex64)
    lane = np.arange(32)
    # lane l holds n2 = 4l + i: x [..., i, l]
    lay = lambda v: np.swapaxes(v.reshape(*v.shape[:-1], 32, 4), -1, -2)  # noqa
    b_r, b_i, t_r, t_i = lay(br), lay(bi), lay(twr), lay(twi)
    xr = (b_r * t_r - b_i * t_i).astype(f32)
    xi = (b_r * t_i + b_i * t_r).astype(f32)
    for s in range(5):
        h = 16 >> s
        hi = (lane & h) != 0
        sgn = np.where(hi, f32(-1), f32(1))
        pr, pi = xr[..., lane ^ h], xi[..., lane ^ h]
        xr, xi = (sgn * xr + pr).astype(f32), (sgn * xi + pi).astype(f32)
        if s < 4:
            w = np.where(hi, W[(lane & (h - 1)) * (64 // h)], 1.0 + 0j)
            wr, wi = w.real.astype(f32), w.imag.astype(f32)
            xr, xi = (xr * wr - xi * wi).astype(f32), (xr * wi + xi * wr
                                                       ).astype(f32)
    b = np.array([int(f"{v:05b}"[::-1], 2) for v in lane])   # bitreverse5
    for i in range(1, 4):
        w = W[i * b]
        wr, wi = w.real.astype(f32), w.imag.astype(f32)
        u = xr[..., i, :].copy()
        xr[..., i, :] = u * wr - xi[..., i, :] * wi
        xi[..., i, :] = u * wi + xi[..., i, :] * wr
    x = xr.astype(np.complex64) + 1j * xi.astype(np.complex64)
    s02, d02 = x[..., 0, :] + x[..., 2, :], x[..., 0, :] - x[..., 2, :]
    s13, d13 = x[..., 1, :] + x[..., 3, :], x[..., 1, :] - x[..., 3, :]
    X = [s02 + s13, d02 + 1j * d13, s02 - s13, d02 - 1j * d13]
    z = np.zeros(br.shape, np.complex64)
    for a in range(4):
        z[..., b + 32 * a] = X[a] * r[b + 32 * a].astype(np.complex64)
    return z * np.asarray(sg, np.float32)[..., None]


@pytest.mark.parametrize("K", [256, 4096])
def test_kernel_fft_matches_plain_stage2(K):
    """z of the second frame (odd: the hop parity applies on odd c1) of
    each of S streams, as st' rows zr, zi of the plain version, against the
    kernel's factorisation on the same rows."""
    pp = _pipe(K)
    K1 = pp.K1
    _, (twr, twi), (w2r, w2i), am_m, fm_m = pp.kd
    S = 6
    rng = np.random.default_rng(51)
    bb = (rng.standard_normal((S, 2 * 2 * K1, K2)) / np.sqrt(K)
          ).astype(np.float32)
    st = torch.zeros((S, 5 * K1, K2))
    _, _, st_out = pk.pfb_demod_plain(torch.as_tensor(bb), st, twr, twi, w2r,
                                      w2i, am_m, fm_m, **_kw(pp))
    want = (st_out[:, :K1].numpy().astype(np.complex128)
            + 1j * st_out[:, K1:2 * K1].numpy())             # [S, K1, 128]
    rows = bb.reshape(S, 2, 2, K1, K2)[:, 1]                 # frame t = 1
    sg = np.where(np.arange(K1) % 2 == 1, -1.0, 1.0)[None, :]
    got = _kernel_stage2(rows[:, 0], rows[:, 1], twr.numpy()[None],
                         twi.numpy()[None], pk._stage2_rotation(w2r, w2i),
                         np.broadcast_to(sg, (S, K1)))
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * peak, (
        np.abs(got - want).max(), peak)


# ------------------------------------------------------- carries by chunk
def _carrier_planes(rng, pp, n_out, S):
    """Stage-1 planes whose stage-2 output is a frequency-modulated
    carrier on every channel plus a little noise (the FM discriminator then
    stays off its +-pi wrap, so FM audio compares sample by sample)."""
    K1, K = pp.K1, pp.K1 * K2
    _, (twr, twi), (w2r, w2i), _, _ = pp.kd
    t = np.arange(n_out)[None, :, None]
    dev = rng.uniform(0.05, 0.6, (S, 1, K))
    z = np.exp(1j * (dev * t + 0.8 * np.sin(0.3 * t + dev)))
    z = z + 0.01 * (rng.standard_normal(z.shape)
                    + 1j * rng.standard_normal(z.shape))
    W2 = w2r.numpy().astype(np.complex128) + 1j * w2i.numpy()
    tw = twr.numpy().astype(np.complex128) + 1j * twi.numpy()
    c = z.reshape(S, n_out, K1, K2) @ np.linalg.inv(W2)
    sgn = 1 - 2 * ((np.arange(n_out) % 2)[:, None, None]
                   * (np.arange(K1) % 2)[None, :, None])
    b = c * sgn / tw[None, None]
    return np.stack([b.real, b.imag], axis=2).reshape(
        S, n_out * 2 * K1, K2).astype(np.float32)


def _call(pp, bb, st):
    _, (twr, twi), (w2r, w2i), am_m, fm_m = pp.kd
    return pk.pfb_demod_plain(torch.as_tensor(np.ascontiguousarray(bb)),
                              st.contiguous(), twr, twi, w2r, w2i, am_m,
                              fm_m, **_kw(pp))


def _close(got, want, label):
    peak = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * max(peak, 1.0), (label, err, peak)


def test_plain_streamed_in_chunks_equals_one_call():
    K, S, L = 256, 2, 32
    n_out = 3 * L + 10                   # chunks of 32, 32, 32 and 10
    pp = _pipe(K)
    K1 = pp.K1
    rng = np.random.default_rng(52)
    bb = _carrier_planes(rng, pp, n_out, S)
    st0 = _random_state(rng, S, K1)
    audio, spec, st = _call(pp, bb, st0)
    rows = 2 * K1
    parts, spec_sum, st_c = [], torch.zeros_like(spec), st0
    for t0 in range(0, n_out, L):
        n = min(L, n_out - t0)
        a, sp, st_c = _call(pp, bb[:, t0 * rows:(t0 + n) * rows], st_c)
        parts.append(a)
        spec_sum = spec_sum + sp
    _close(torch.cat(parts, dim=1), audio, "audio")
    assert torch.allclose(spec_sum, spec, rtol=TOL, atol=0.0)
    _close(st_c, st, "st'")


def test_two_launch_carry_algebra_equals_one_call():
    """Launch (a): each chunk from a zero one-pole state (z and env of the
    frame before it handed on); launch (b): the carries entering chunk k
    folded in chunk order from st, C_k+1 = a^L_k * C_k + e_k, and
    g_am * a_dc^(j+1) * C_dc, a_de^(j+1) * C_de added to AM, FM positions."""
    K, S, L = 512, 2, 64
    n_out = 2 * L + 10                   # chunks of 64, 64 and 10
    pp = _pipe(K)
    K1 = pp.K1
    rng = np.random.default_rng(53)
    bb = _carrier_planes(rng, pp, n_out, S)
    st0 = _random_state(rng, S, K1)
    audio, spec, st = _call(pp, bb, st0)

    rows = 2 * K1
    am_m, fm_m = pp.kd[3], pp.kd[4]
    s5 = st0.reshape(S, 5, K1, K2)
    c_dc, c_de = s5[:, 4].clone(), s5[:, 2].clone()
    prev = s5.clone()
    parts, spec_sum = [], torch.zeros_like(spec)
    for t0 in range(0, n_out, L):
        n = min(L, n_out - t0)
        zero = prev.clone()
        zero[:, 2] = 0.0
        zero[:, 4] = 0.0
        a0, sp, st_k = _call(pp, bb[:, t0 * rows:(t0 + n) * rows],
                             zero.reshape(S, 5 * K1, K2))
        e = st_k.reshape(S, 5, K1, K2)
        j = torch.arange(1, n + 1, dtype=torch.float64)[:, None, None]
        pdc = (float(pp.a_dc) ** j).float()
        pde = (float(pp.a_de) ** j).float()
        fix = (am_m * float(np.float32(pp.g_am)) * pdc * c_dc[:, None]
               + fm_m * pde * c_de[:, None])           # [S, n, K1, K2]
        parts.append(a0.reshape(S, n, K1, K2) + fix)
        c_dc = float(np.float32(float(pp.a_dc) ** n)) * c_dc + e[:, 4]
        c_de = float(np.float32(float(pp.a_de) ** n)) * c_de + e[:, 2]
        spec_sum = spec_sum + sp
        prev = e
    _close(torch.cat(parts, dim=1).reshape(S, n_out * K1, K2), audio,
           "audio")
    assert torch.allclose(spec_sum, spec, rtol=TOL, atol=0.0)
    s5_out = st.reshape(S, 5, K1, K2)
    _close(c_dc, s5_out[:, 4], "y_dc")
    _close(c_de, s5_out[:, 2], "y_de")
    for r in (0, 1, 3):
        _close(prev[:, r], s5_out[:, r], f"st' row {r}")
