"""The PFB channelizer's kernels: the two polyphase branch sums and the
fused stage-2 IDFT + demod.

Counterpart of the PFB half of ``quisk_tpu.ops.pallas_kernels``:

- :func:`pfb_poly_oversampled` (``pfb_poly_oversampled``,
  pallas_kernels.py:666) and :func:`pfb_poly_critical`
  (``pfb_poly_critical``, :741): ``csrc/pfb_poly.cu``, one template, two
  launchers;
- :func:`pfb_demod_call` (``pfb_demod_call``, :933): ``csrc/pfb_demod.cu``.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its
``_plain`` version (the same arithmetic in PyTorch ops) only for tensors
on the CPU; each has its own launch counter.  The kernels' source notes
say what bounds them on an H100 and how their designs answer that.

Differences of interface from the TPU kernels, none of result:

- the polyphase kernels take the complex history and block as they lie
  (interleaved complex64, two buffers) instead of split and concatenated
  (re, im) frame views, take a stream axis, fold the caller's trailing
  lane reversal into their indexing, and return ``v`` [S, n_out, 2, K]:
  per frame the real row then the imaginary row.  ``v[:, :, 0]`` and
  ``v[:, :, 1]`` are the planes ``vr``, ``vi`` of ``poly_ri``, and
  ``v.view(S, n_out, 2*K1, K2)`` is the ``[ar; ai]`` stack of the
  receiver's stage-1 product, without a copy;
- the demod kernel takes a stream axis and the one-pole coefficients
  ``a_dc``, ``a_de`` themselves: it runs the recurrences as recurrences,
  so the triangular matrices and decay columns of the TPU kernel
  (``tdc``, ``tde``, ``dec``) and the Karatsuba sum ``w2s`` have no
  counterpart, and there is no time-tile parameter ``TT``.  It computes
  stage 2 as a 128-point FFT followed by the rotation ``r = w2[0]``, so on
  the card ``w2`` must be the inverse DFT times ``diag(r)``, as
  ``PFBRxPipeline.create`` builds it (:func:`_stage2_rotation` checks).
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import numpy as np
import torch

from quisk_tpu_torch import _kernels
from quisk_tpu_torch.ops.iir import first_order_scan

_ERR_BAD_SHAPE = -1              # the launchers' kErrBadShape
K2 = 128                         # stage-2 length of the demod kernel


@functools.cache
def _poly_launchers():
    lib = _kernels.load("pfb_poly")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out = {}
    for name in ("pfb_poly_oversampled", "pfb_poly_critical"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 4 + [i32, i64, i32, i32, ptr]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


@functools.cache
def _demod_launchers():
    """(scratch-size query, launcher) of ``csrc/pfb_demod.cu``."""
    lib = _kernels.load("pfb_demod")
    scratch = lib.pfb_demod_scratch_floats
    scratch.argtypes = [ctypes.c_int] * 3
    scratch.restype = ctypes.c_longlong
    fn = lib.pfb_demod
    fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return scratch, fn


def _run(ref: torch.Tensor, name: str, fn, *args) -> None:
    """Call a launcher on ref's device and stream; raise on failure."""
    err = _kernels.call(ref, fn, *args)
    if err == _ERR_BAD_SHAPE:
        raise ValueError(f"{name}: shape outside the kernel's grid limits")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


# ------------------------------------------------------------ polyphase sums
def _poly_check(hist, x, h_poly, hop: int) -> tuple[int, int, int, int]:
    if x.dim() != 2 or h_poly.dim() != 2:
        raise ValueError("x must be [S, B] and h_poly [P, K]")
    S, B = x.shape
    P, K = h_poly.shape
    if K % hop or B < 1 or B % (K // hop):
        raise ValueError(f"need K % {hop} == 0 and a block that is a "
                         f"multiple of K/{hop}, got K={K}, B={B}")
    Mf = K // hop
    _kernels.check_tensors(x, {
        "x": (x, torch.complex64, (S, B)),
        "hist": (hist, torch.complex64, (S, (hop * P - 1) * Mf)),
        "h_poly": (h_poly, torch.float32, (P, K)),
    })
    return S, B, K, P


def _poly_plain(hist, x, h_poly, hop: int) -> torch.Tensor:
    """Shifted-view accumulation (quisk_tpu/ops/channelizer.py:126-132,
    :235-247): ``hop*P`` slices of the frame view times one tap row each,
    then the lane reversal."""
    S, B, K, P = _poly_check(hist, x, h_poly, hop)
    Mf = K // hop
    n_out = B // Mf
    G = torch.view_as_real(torch.cat([hist, x], dim=-1)).reshape(
        S, n_out + hop * P - 1, Mf, 2)
    hrev = h_poly.flip(0, 1)
    parts = []
    for hh in range(hop):
        acc = torch.zeros((S, n_out, Mf, 2), dtype=torch.float32,
                          device=x.device)
        for p in range(P):
            w = hrev[p, hh * Mf:(hh + 1) * Mf]
            acc = acc + G[:, hop * p + hh: hop * p + hh + n_out] * w[:, None]
        parts.append(acc)
    v = torch.cat(parts, dim=2).flip(2)                   # [S, n_out, K, 2]
    return v.permute(0, 1, 3, 2).contiguous()


def _poly(hist, x, h_poly, hop: int, wrapper, name: str) -> torch.Tensor:
    S, B, K, P = _poly_check(hist, x, h_poly, hop)
    if x.device.type == "cpu":
        return _poly_plain(hist, x, h_poly, hop)
    v = torch.empty((S, B // (K // hop), 2, K), dtype=torch.float32,
                    device=x.device)
    _run(x, name, _poly_launchers()[name], hist.data_ptr(), x.data_ptr(),
         h_poly.data_ptr(), v.data_ptr(), S, B, K, P)
    wrapper.launches += 1
    return v


def pfb_poly_oversampled_plain(hist, x, h_poly) -> torch.Tensor:
    """PyTorch version of :func:`pfb_poly_oversampled`."""
    return _poly_plain(hist, x, h_poly, 2)


def pfb_poly_oversampled(hist, x, h_poly) -> torch.Tensor:
    """Branch sums of the 2x-oversampled PFB (hop K/2).

    hist [S, (2P-1)*K/2] and x [S, B] complex64 (B a multiple of K/2),
    h_poly [P, K] float32, not reversed.  Returns v [S, 2B/K, 2, K]
    float32 with ``v[s, m, 0|1, j] = sum_p G[m + 2p + hh, q] *
    h_poly[P-1-p, j]`` on the (re | im) plane, K-1-j = hh*K/2 + q and G the
    [.., K/2] half-frame view of [hist | x]: the pre-IDFT branch sums, lane
    reversal applied.  Launches the CUDA kernel for CUDA tensors
    (``pfb_poly_oversampled.launches``); CPU tensors take the plain
    version."""
    return _poly(hist, x, h_poly, 2, pfb_poly_oversampled,
                 "pfb_poly_oversampled")


pfb_poly_oversampled.launches = 0


def pfb_poly_critical_plain(hist, x, h_poly) -> torch.Tensor:
    """PyTorch version of :func:`pfb_poly_critical`."""
    return _poly_plain(hist, x, h_poly, 1)


def pfb_poly_critical(hist, x, h_poly) -> torch.Tensor:
    """Branch sums of the critically-sampled PFB (hop K).

    hist [S, (P-1)*K] and x [S, B] complex64 (B a multiple of K), h_poly
    [P, K] float32.  Returns v [S, B/K, 2, K] float32 with ``v[s, m, 0|1,
    j] = sum_p F[m + p, K-1-j] * h_poly[P-1-p, j]``, F the [.., K] frame
    view of [hist | x].  Launches the CUDA kernel for CUDA tensors
    (``pfb_poly_critical.launches``); CPU tensors take the plain version."""
    return _poly(hist, x, h_poly, 1, pfb_poly_critical, "pfb_poly_critical")


pfb_poly_critical.launches = 0


# ---------------------------------------------------- stage-2 IDFT + demod
def _demod_check(bb, st, twr, twi, w2r, w2i, am, fm) -> tuple[int, int, int]:
    if bb.dim() != 3 or twr.dim() != 2:
        raise ValueError("bb must be [S, n_out*2*K1, K2], twr [K1, K2]")
    S, rows, k2 = bb.shape
    K1 = twr.shape[0]
    if k2 != K2 or rows < 2 * K1 or rows % (2 * K1):
        raise ValueError(f"need K2 == {K2} columns and whole (re | im) row "
                         f"groups of {2 * K1}, got {tuple(bb.shape)}")
    f32 = torch.float32
    _kernels.check_tensors(bb, {
        "bb": (bb, f32, (S, rows, K2)),
        "st": (st, f32, (S, 5 * K1, K2)),
        "twr": (twr, f32, (K1, K2)),
        "twi": (twi, f32, (K1, K2)),
        "w2r": (w2r, f32, (K2, K2)),
        "w2i": (w2i, f32, (K2, K2)),
        "am": (am, f32, (K1, K2)),
        "fm": (fm, f32, (K1, K2)),
    })
    return S, rows // (2 * K1), K1


def pfb_demod_plain(bb, st, twr, twi, w2r, w2i, am, fm, *, g_ssb: float,
                    g_am: float, g_fm: float, a_dc: float, a_de: float,
                    b_de: float):
    """PyTorch version of :func:`pfb_demod_call`: twiddle, parity, the
    stage-2 product as four real fp32 matmuls, the three demodulators with
    their one-poles as time-major scans, the mask select and the power
    sum."""
    S, n_out, K1 = _demod_check(bb, st, twr, twi, w2r, w2i, am, fm)
    dev = bb.device
    b4 = bb.reshape(S, n_out, 2, K1, K2)
    br, bi = b4[:, :, 0], b4[:, :, 1]
    t = torch.arange(n_out, device=dev)[:, None, None]
    c1 = torch.arange(K1, device=dev)[None, :, None]
    sgn = (1 - 2 * ((t % 2) * (c1 % 2))).to(torch.float32)
    cr = (br * twr - bi * twi) * sgn
    ci = (br * twi + bi * twr) * sgn
    zr = torch.matmul(cr, w2r) - torch.matmul(ci, w2i)   # [S, n_out, K1, K2]
    zi = torch.matmul(cr, w2i) + torch.matmul(ci, w2r)
    spec = (zr * zr + zi * zi).sum(dim=1)
    s5 = st.reshape(S, 5, K1, K2)

    def before(first, v):
        return torch.cat([first[:, None], v[:, :-1]], dim=1)

    def one_pole(u, a, y_prev):
        # time on axis 1: fold (K1, K2) into the scan's channel axis
        y = first_order_scan(u.reshape(S, n_out, K1 * K2), a, 1.0,
                             y_prev.reshape(S, K1 * K2), dim=-2)
        return y.reshape(S, n_out, K1, K2)

    a_ssb = float(np.float32(g_ssb)) * zr
    env = torch.sqrt(zr * zr + zi * zi)
    y_dc = one_pole(env - before(s5[:, 3], env), float(a_dc), s5[:, 4])
    zr1, zi1 = before(s5[:, 0], zr), before(s5[:, 1], zi)
    dr = zr * zr1 + zi * zi1
    di = zi * zr1 - zr * zi1
    disc = torch.where(dr * dr + di * di > 1e-24, torch.atan2(di, dr),
                       torch.zeros((), dtype=torch.float32, device=dev))
    y_de = one_pole(float(np.float32(b_de * g_fm)) * disc, float(a_de),
                    s5[:, 2])
    a_am = float(np.float32(g_am)) * y_dc
    audio = a_ssb + am * (a_am - a_ssb) + fm * (y_de - a_ssb)
    st_out = torch.cat([zr[:, -1], zi[:, -1], y_de[:, -1], env[:, -1],
                        y_dc[:, -1]], dim=1)
    return audio.reshape(S, n_out * K1, K2), spec, st_out


@functools.cache
def _fft_twiddles(device: torch.device) -> torch.Tensor:
    """The demod kernel's twiddle table [2, K2] float32: cos and sin of
    2 pi j / K2, made in float64."""
    ang = 2 * np.pi * np.arange(K2) / K2
    return torch.as_tensor(np.stack([np.cos(ang), np.sin(ang)]).astype(
        np.float32), device=device)


_ROTATIONS: dict = {}             # (ptr, version) pairs -> (refs, r)
_W2_RTOL = 8 * float(np.finfo(np.float32).eps)


def _stage2_rotation(w2r: torch.Tensor, w2i: torch.Tensor) -> np.ndarray:
    """The rotation ``r`` [K2] complex128 of a stage-2 basis of the form
    ``w2[n2, c2] = e^{2 pi i n2 c2 / K2} * r[c2]``, the form the demod
    kernel computes as a 128-point FFT (``r`` is row 0).  Raises ValueError
    if ``w2r + i*w2i`` is not of that form within float32 rounding
    (8 eps of the largest |r|).  Reads ``w2`` to the host once per tensor
    pair and version, so a call with the same constants does not
    synchronise."""
    key = (w2r.data_ptr(), w2r._version, w2i.data_ptr(), w2i._version)
    hit = _ROTATIONS.get(key)
    if hit is not None and hit[0]() is w2r and hit[1]() is w2i:
        return hit[2]
    W = (w2r.detach().cpu().double().numpy()
         + 1j * w2i.detach().cpu().double().numpy())
    r = W[0].copy()
    n = np.arange(K2)
    dft = np.exp(2j * np.pi * (np.outer(n, n) % K2) / K2)     # [n2, c2]
    err = float(np.abs(W - dft * r[None, :]).max())
    if not err <= _W2_RTOL * max(1.0, float(np.abs(r).max())):
        raise ValueError(f"w2 is not the {K2}-point inverse DFT times a "
                         f"rotation of its columns (max deviation {err:.3g})"
                         f": the demod kernel computes stage 2 as an FFT")
    if len(_ROTATIONS) > 64:
        _ROTATIONS.clear()
    _ROTATIONS[key] = (weakref.ref(w2r), weakref.ref(w2i), r)
    return r


def pfb_demod_call(bb, st, twr, twi, w2r, w2i, am, fm, *, g_ssb: float,
                   g_am: float, g_fm: float, a_dc: float, a_de: float,
                   b_de: float):
    """Stage 2 of the cross-branch IDFT, the demodulators and the power
    spectrum in one pass.

    bb [S, n_out*2*K1, K2] float32: the stage-1 planes, rows (t, re|im,
    c1), K2 = 128; st [S, 5*K1, K2] the entering carries (rows zr, zi,
    y_de, env, y_dc); twr, twi [K1, K2] the twiddles and w2r, w2i [K2, K2]
    the stage-2 basis, the commutator rotation folded into both; am, fm
    [K1, K2] 0/1 masks at position c1*K2 + c2 (channel c1 + K1*c2).
    Returns (audio [S, n_out*K1, K2], spec [S, K1, K2] — the power SUM over
    time — and st' [S, 5*K1, K2]).  The (-1)^(t*c1) hop parity counts t
    within the call.  Launches the CUDA kernel for CUDA tensors
    (``pfb_demod_call.launches``: one per call, though the kernel runs as
    two CUDA launches, the chunks and then the carries across them); there
    ``w2`` must be of the form :func:`_stage2_rotation` checks and bb, st,
    twr, twi, am and fm 16-byte aligned.  CPU tensors take the plain
    version, for any ``w2``."""
    S, n_out, K1 = _demod_check(bb, st, twr, twi, w2r, w2i, am, fm)
    kw = dict(g_ssb=g_ssb, g_am=g_am, g_fm=g_fm, a_dc=a_dc, a_de=a_de,
              b_de=b_de)
    if bb.device.type == "cpu":
        return pfb_demod_plain(bb, st, twr, twi, w2r, w2i, am, fm, **kw)
    _stage2_rotation(w2r, w2i)
    for name, t in (("bb", bb), ("st", st), ("twr", twr), ("twi", twi),
                    ("am", am), ("fm", fm)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    scratch_floats, launch = _demod_launchers()
    n_scratch = scratch_floats(S, n_out, K1)
    if n_scratch == _ERR_BAD_SHAPE:
        raise ValueError("pfb_demod: shape outside the kernel's grid limits")
    f32 = dict(dtype=torch.float32, device=bb.device)
    audio = torch.empty((S, n_out * K1, K2), **f32)
    spec = torch.empty((S, K1, K2), **f32)
    st_out = torch.empty((S, 5 * K1, K2), **f32)
    scratch = torch.empty(n_scratch, **f32)
    _run(bb, "pfb_demod", launch, bb.data_ptr(), st.data_ptr(),
         twr.data_ptr(), twi.data_ptr(), w2r.data_ptr(), w2i.data_ptr(),
         am.data_ptr(), fm.data_ptr(), _fft_twiddles(bb.device).data_ptr(),
         audio.data_ptr(), spec.data_ptr(), st_out.data_ptr(),
         scratch.data_ptr(), S, n_out, K1, g_ssb, g_am,
         float(np.float32(b_de * g_fm)), a_dc, a_de)
    pfb_demod_call.launches += 1
    return audio, spec, st_out


pfb_demod_call.launches = 0
