"""The lookahead AGC (ops/agc.py ``AGC``) on the CPU: its plain route
against the JAX package's op over chained blocks, the algebra that the card's
kernel (``csrc/agc_delay.cu``) relies on, modelled in numpy, and the checks
both routes make.  The kernel itself is held to the plain route on a card by
tests/test_torch_agc_delay_card.py.

Tolerances are tests/test_torch_ops.py's ``test_agc``: output >= 100 dB
against the JAX op once a whole lookahead of input has gone in (before, the
delay line's zeros lifted by the gain ceiling), the carried log gain within
1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import agc as jagc

from quisk_tpu_torch.ops import agc

CPU = "cpu"
FS = 48e3
SCALES = np.array([1e-3, 0.1, 1.0, 30.0], np.float32)


def snr_db(ref, got):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / (np.mean(err ** 2) + 1e-300))


def audio(rng, C, B):
    """Noise at four levels a row, with a burst 50 times louder, so that
    the limit attacks and releases within a block."""
    a = rng.standard_normal((C, B)) * SCALES[np.arange(C) % 4][:, None]
    a[:, B // 3] *= 50.0
    return a.astype(np.float32)


@pytest.mark.parametrize("C,B", [(4, 2048), (3, 256), (2, 1000)])
def test_agc_matches_jax(C, B):
    """Four chained blocks, the state carried on both sides; (3, 256) has a
    block shorter than the 720-sample lookahead, so part of the new delay
    line comes from the old one."""
    jop = jagc.AGC.create(FS)
    op = agc.AGC.create(FS, device=CPU)
    assert op.lookahead == jop.lookahead == 720
    jst, pst = jop.init_state(C), op.init_state(C)
    rng = np.random.default_rng(20 + B)
    for i in range(4):
        a = audio(rng, C, B)
        jst, jy = jop(jst, jnp.asarray(a))
        pst, py = op(pst, torch.from_numpy(a))
        if i * B >= op.lookahead:      # the output past the start's zeros
            assert snr_db(jy, py.numpy()) > 100.0
        assert np.allclose(pst[1].numpy(), np.asarray(jst[1]), atol=1e-5)
        assert np.array_equal(pst[0].numpy(), np.asarray(jst[0]))


def test_call_is_plain_on_cpu():
    op = agc.AGC.create(FS, device=CPU)
    st = op.init_state(3)
    a = torch.from_numpy(audio(np.random.default_rng(1), 3, 777))
    (d1, l1), y1 = op(st, a)
    (d2, l2), y2 = op.plain(st, a)
    assert torch.equal(y1, y2) and torch.equal(d1, d2)
    assert torch.equal(l1, l2)


# ------------------------------------------- the kernel's algebra, in numpy
def fma32(a, b, c):
    """float32 fma: the product of two float32 values is exact in
    float64, so one rounding of the float64 sum stands in for it."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(
        np.float32)


def segmented(x, W, reverse, op):
    """Inclusive max within the W-segments of x (from x's start), scanned
    from the end if ``reverse``: the kernel's two van Herk passes."""
    out = np.empty_like(x)
    for s in range(0, x.shape[-1], W):
        seg = x[..., s:s + W]
        if reverse:
            out[..., s:s + W] = op.accumulate(seg[..., ::-1], -1)[..., ::-1]
        else:
            out[..., s:s + W] = op.accumulate(seg, -1)
    return out


def kernel_model(delay, a, lg0, target, max_lgain, inc):
    """The kernel's arithmetic in float32: the window max from the segment
    suffix and prefix maxima, the limit, u = limit - j*inc by one fma, its
    exact prefix min U, lg = min(lg0 + (n+1) inc, n inc + U)."""
    W, B = delay.shape[-1], a.shape[-1]
    ext = np.concatenate([delay, a], -1)
    x = np.abs(ext)
    env = np.maximum(segmented(x, W, True, np.maximum)[:, :B],
                     segmented(x, W, False, np.maximum)[:, W - 1:W - 1 + B])
    lim = np.minimum(np.log(target / np.maximum(env, np.float32(1e-9))),
                     max_lgain).astype(np.float32)
    n = np.arange(B, dtype=np.float32)
    U = np.minimum.accumulate(fma32(-n, inc, lim), -1)
    lg = np.minimum(fma32(n + 1, inc, lg0[:, None]), fma32(n, inc, U))
    return ext, env, lg


def recurrence64(lim, inc, lg0):
    out = np.empty(lim.shape, np.float64)
    prev = lg0.astype(np.float64)
    for i in range(lim.shape[1]):
        prev = np.minimum(prev + np.float64(inc), lim[:, i])
        out[:, i] = prev
    return out


@pytest.mark.parametrize("W,B", [(720, 2048), (720, 256), (7, 1000),
                                 (1, 50)])
def test_kernel_model_window_max(W, B):
    """The segment suffix / prefix maxima give sliding_max's envelope bit
    for bit, whether B is above, below or far above W."""
    rng = np.random.default_rng(30 + W + B)
    delay = rng.standard_normal((3, W)).astype(np.float32)
    a = audio(rng, 3, B)
    _, env, _ = kernel_model(delay, a, np.zeros(3, np.float32),
                             np.float32(0.9), np.float32(9.21),
                             np.float32(1.4e-4))
    ext = torch.from_numpy(np.concatenate([delay, a], -1))
    ref = agc.sliding_max(ext.abs(), W)[:, :B].numpy()
    assert np.array_equal(env, ref)


@pytest.mark.parametrize("scale", [1e-4, 1e-2, 1.0])
def test_kernel_model_scan(scale):
    """The closed form of the counted maps' prefix lies within two
    roundings of the float64 recurrence on the same limits; the plain
    route's doubling within its log2(B) + 1.  Near log gains of 9 (audio at
    1e-4, the gain ceiling) an ulp is 9.5e-7."""
    op = agc.AGC.create(FS, device=CPU)
    target, max_lgain, inc = (t.numpy() for t in (
        op.target, op.max_lgain, op.release_inc))
    rng = np.random.default_rng(40)
    C, B, W = 4, 2048, op.lookahead
    delay = (rng.standard_normal((C, W)) * scale).astype(np.float32)
    a = (audio(rng, C, B) / SCALES[np.arange(C) % 4][:, None]
         * scale).astype(np.float32)
    lg0 = rng.uniform(-2, 9, C).astype(np.float32)
    ext, env, lg = kernel_model(delay, a, lg0, target, max_lgain, inc)
    lim = np.minimum(np.log(target / np.maximum(env, np.float32(1e-9))),
                     max_lgain).astype(np.float32)
    exact = recurrence64(lim, inc, lg0)
    # an ulp at the magnitude of the terms rounded: |lg|, and |u| <= |lim|
    # + B inc
    mag = np.maximum(np.abs(exact), np.abs(lim)) + B * np.float64(inc)
    ulp = np.spacing(mag.astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(lg - exact) <= 2 * ulp)
    plain = agc.min_scan(torch.from_numpy(lim), torch.tensor(inc),
                         torch.from_numpy(lg0)).numpy()
    assert np.all(np.abs(plain - exact) <= 12 * ulp)
    # and the whole block: the model's output against the plain route's
    (_, lg_p), out_p = op.plain((torch.from_numpy(delay),
                                 torch.from_numpy(lg0)), torch.from_numpy(a))
    out = ext[:, :B] * np.exp(lg)
    peak = np.abs(out_p.numpy()).max(-1, keepdims=True)
    assert np.all(np.abs(out - out_p.numpy()) <= 2e-5 * peak)
    assert np.all(np.abs(lg[:, -1] - lg_p.numpy()) <= 5e-6)


# ------------------------------------------------------------- the checks
def _bad_calls():
    C, B = 3, 64
    op = agc.AGC.create(FS, device=CPU)
    W = op.lookahead
    d, lg = op.init_state(C)
    a = torch.zeros((C, B))
    wide = torch.zeros((C, 2 * B))
    return [
        (TypeError, op, (d, lg), a.double()),
        (TypeError, op, (d.double(), lg), a),
        (TypeError, op, (d, lg.to(torch.int32)), a),
        (ValueError, op, (d, lg), a[0]),                     # rank 1
        (ValueError, op, (d, lg), a[None]),                  # rank 3
        (ValueError, op, (d, lg), torch.zeros((C, 0))),      # no samples
        (ValueError, op, (d, lg), torch.zeros((C + 1, B))),  # rows
        (ValueError, op, (torch.zeros((C, W + 1)), lg), a),  # delay length
        (ValueError, op, (d, torch.zeros(C + 1)), a),        # log gains
        (ValueError, op, (d, lg), wide[:, ::2]),             # strided samples
        (ValueError, op, (torch.zeros((C, 2 * W))[:, ::2], lg), a),
        (ValueError, op, (d, lg), torch.zeros(C * B).as_strided(
            (C, B), (B // 2, 1))),                           # rows overlap
        (TypeError, agc.AGC(op.target.double(), op.max_lgain,
                            op.release_inc, W), (d, lg), a),
        (ValueError, agc.AGC(op.target[None], op.max_lgain, op.release_inc,
                             W), (d, lg), a),
    ]


@pytest.mark.parametrize("case", range(14))
def test_checks(case):
    calls = _bad_calls()
    assert len(calls) == 14
    exc, op, st, a = calls[case]
    with pytest.raises(exc):
        op(st, a)


def test_strided_rows_accepted():
    """Rows may lie apart (a slice of a wider block); samples are the
    same as those of a contiguous copy."""
    op = agc.AGC.create(FS, device=CPU)
    st = op.init_state(2)
    wide = torch.from_numpy(audio(np.random.default_rng(2), 2, 300))
    (_, lg1), y1 = op(st, wide[:, 10:210])
    (_, lg2), y2 = op(st, wide[:, 10:210].contiguous())
    assert torch.equal(y1, y2) and torch.equal(lg1, lg2)


def test_meta_tensor_raises():
    """A device that is neither the CPU nor a card raises: the torch ops,
    which would run on it, are not a fallback."""
    op = agc.AGC.create(FS, device="meta")
    st = op.init_state(2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        op(st, torch.zeros((2, 64), device="meta"))
    assert agc.agc_delay.launches == 0
