"""The second-order IIR section (ops/iir.py ``Biquad``) on the CPU: the
arithmetic of the card's kernel (``csrc/biquad.cu``) modelled in numpy and
its plain route (``Biquad.plain``, the float64 log-step scan) held to the
float64 recurrence over chained blocks, the CPU route against the plain
one, and the checks both routes make.  The kernel itself is held to the
plain route on a card by tests/test_torch_biquad_card.py; the plain route
to the JAX op by tests/test_torch_agc.py.

Tolerances.  Both routes round the output and the carried state to float32
once.  Stepped a block at a time from the float32 state carried in, the
float64 recurrence lies within float32 rounding of both (~150 dB on this
input): they are held to >= 140 dB there.  Against one unbroken float64
run over all the blocks, the float32 state handed from block to block costs
the 100 Hz, q = 5 notch (poles at r = 0.9987) ~25 dB, since a state an ulp
off rings through the next ~800 samples: 119.7 dB at its worst here, so >=
110 dB, the same for both routes."""

import numpy as np
import pytest
import torch

from quisk_tpu_torch.ops import iir

CPU = "cpu"
FS = 48e3
KINDS = {"notch": (100.0, FS, CPU, 5.0),        # PLLFMDemod's CTCSS notch
         "peak": (1500.0, FS, CPU),
         "highpass": (300.0, FS, CPU)}
SHAPES = [(8, 2048), (3, 1), (2, 777)]
CASES = [(k, C, B) for k in KINDS for C, B in SHAPES]
NBLK = 4


def snr_db(ref, got) -> float:
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return 10 * np.log10(np.mean(ref ** 2) / (np.mean(err ** 2) + 1e-300))


def coefs(op) -> list[float]:
    return [float(c) for c in op.coefs()]


def signal(rng, C, n):
    """The CTCSS tone under noise, as the NFM receiver's audio carries it."""
    t = np.arange(n) / FS
    return (0.5 * np.sin(2 * np.pi * 100.0 * t)
            + 0.3 * rng.standard_normal((C, n))).astype(np.float32)


def kernel_model(c, state, x):
    """The kernel's arithmetic on one block: per sample in float64,
    f = b0 x + b1 x[-1] + b2 x[-2], t = f - a2 y[-2], y = t - a1 y[-1]
    (the kernel's fused multiply-adds here a product and a sum: a float64
    rounding apart, far under float32's); the output and the new state
    rounded to float32 once each."""
    b0, b1, b2, a1, a2 = c
    x1, x2, y1, y2 = (np.asarray(s, np.float64) for s in state)
    y = np.empty(x.shape, np.float32)
    for n in range(x.shape[1]):
        xn = x[:, n].astype(np.float64)
        t = (b0 * xn + b1 * x1 + b2 * x2) - a2 * y2
        yn = t - a1 * y1
        y[:, n] = yn
        x2, x1, y2, y1 = x1, xn, y1, yn
    return tuple(v.astype(np.float32) for v in (x1, x2, y1, y2)), y


def recurrence64(c, state, x):
    """The recurrence itself in float64 from ``state``, sample by sample:
    the output and the state left in float64."""
    b0, b1, b2, a1, a2 = c
    x1, x2, y1, y2 = (np.asarray(s, np.float64) for s in state)
    y = np.empty(x.shape, np.float64)
    for n in range(x.shape[1]):
        xn = x[:, n].astype(np.float64)
        y[:, n] = b0 * xn + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x2, x1, y2, y1 = x1, xn, y1, y[:, n]
    return (x1, x2, y1, y2), y


def chained(route, c, C, B, seed):
    """NBLK blocks through ``route(state, x) -> (state, y)`` from rest; the
    whole output, the float64 recurrence stepped per block from each
    block's carried state, and one unbroken float64 run."""
    x = signal(np.random.default_rng(seed), C, NBLK * B)
    st = tuple(np.zeros(C, np.float32) for _ in range(4))
    outs, per_block = [], []
    for i in range(NBLK):
        xb = np.ascontiguousarray(x[:, i * B:(i + 1) * B])
        per_block.append(recurrence64(c, st, xb)[1])
        new, y = route(st, xb)
        assert np.array_equal(new[0], xb[:, -1])          # x1' = x[B-1]
        assert np.array_equal(new[1], np.concatenate(    # x2' = x[B-2]
            [st[0][:, None], xb], -1)[:, -2])
        assert np.array_equal(new[2], y[:, -1])          # y1' = y[B-1]
        assert np.array_equal(new[3], np.concatenate(
            [st[2][:, None], y], -1)[:, -2])
        outs.append(y)
        st = new
    whole = recurrence64(c, (np.zeros(C),) * 4, x)[1]
    return (np.concatenate(outs, -1), np.concatenate(per_block, -1),
            whole)


def plain_route(op):
    def route(st, xb):
        new, y = op.plain(tuple(torch.from_numpy(s) for s in st),
                          torch.from_numpy(xb))
        return tuple(s.numpy() for s in new), y.numpy()
    return route


@pytest.mark.parametrize("kind,C,B", CASES)
def test_kernel_model_matches_recurrence(kind, C, B):
    op = getattr(iir.Biquad, kind)(*KINDS[kind])
    c = coefs(op)
    got, per_block, whole = chained(
        lambda st, xb: kernel_model(c, st, xb), c, C, B, seed=C + B)
    assert snr_db(per_block, got) >= 140.0
    assert snr_db(whole, got) >= 110.0


@pytest.mark.parametrize("kind,C,B", CASES)
def test_plain_matches_recurrence(kind, C, B):
    op = getattr(iir.Biquad, kind)(*KINDS[kind])
    c = coefs(op)
    got, per_block, whole = chained(plain_route(op), c, C, B, seed=C + B)
    assert snr_db(per_block, got) >= 140.0
    assert snr_db(whole, got) >= 110.0


@pytest.mark.parametrize("C,B", SHAPES)
def test_call_is_plain_on_cpu(C, B):
    op = iir.Biquad.notch(*KINDS["notch"])
    st = op.plain(op.init_state(C),
                  torch.from_numpy(signal(np.random.default_rng(1), C, B)))[0]
    x = torch.from_numpy(signal(np.random.default_rng(2), C, B))
    n0 = iir.biquad_df1.launches
    s1, y1 = op(st, x)
    s2, y2 = op.plain(st, x)
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert iir.biquad_df1.launches == n0


def test_strided_rows_accepted():
    """Rows may lie apart (a slice of a wider block): the same as a
    contiguous copy."""
    op = iir.Biquad.notch(*KINDS["notch"])
    st = op.init_state(3)
    wide = torch.from_numpy(signal(np.random.default_rng(3), 3, 300))
    s1, y1 = op(st, wide[:, 7:207])
    s2, y2 = op(st, wide[:, 7:207].contiguous())
    assert torch.equal(y1, y2)
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))


# ------------------------------------------------------------- the checks
def _bad_calls():
    C, B = 3, 64
    op = iir.Biquad.notch(*KINDS["notch"])
    st = op.init_state(C)
    x = torch.zeros((C, B))
    wide = torch.zeros((C, 2 * B))
    short = tuple(torch.zeros(C - 1) for _ in range(4))
    return [
        (TypeError, op, st, x.double()),                      # dtype
        (TypeError, op, (st[0].double(),) + st[1:], x),       # state dtype
        (ValueError, op, st, x[0]),                           # rank 1
        (ValueError, op, st, x[None]),                        # rank 3
        (ValueError, op, st, torch.zeros((C, 0))),            # no samples
        (ValueError, op, st, torch.zeros((C + 1, B))),        # rows
        (ValueError, op, st, wide[:, ::2]),                   # strided
        (ValueError, op, short, x),                           # state [C-1]
        (ValueError, op, st[:3], x),                          # 3 tensors
        (ValueError, op, (torch.zeros(C, device="meta"),) + st[1:], x),
        (TypeError, iir.Biquad(op.b0.double(), op.b1, op.b2, op.a1, op.a2),
         st, x),                                              # coef dtype
        (ValueError, iir.Biquad(op.b0[None], op.b1, op.b2, op.a1, op.a2),
         st, x),                                              # coef rank
    ]


@pytest.mark.parametrize("case", range(12))
def test_checks(case):
    calls = _bad_calls()
    assert len(calls) == 12
    exc, op, st, x = calls[case]
    with pytest.raises(exc):
        op(st, x)


def test_meta_tensor_raises():
    """A device that is neither the CPU nor a card raises: the torch ops,
    which would run on it, are not a fallback."""
    op = iir.Biquad.notch(100.0, FS, "meta", q=5.0)
    st = op.init_state(2)
    n0 = iir.biquad_df1.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        op(st, torch.zeros((2, 64), device="meta"))
    assert iir.biquad_df1.launches == n0
