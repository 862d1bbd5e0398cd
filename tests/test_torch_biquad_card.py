"""The biquad kernel (``csrc/biquad.cu``, ops/iir.py ``biquad_df1``) on a
card, held to the float64 recurrence and to the plain route
(``Biquad.plain``, the float64 log-step scan as torch ops).  Without a card
every test here skips; on one, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_biquad_card.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not need.)  Imports neither JAX nor the JAX package.

Tolerances: each block, from the state the kernel carried in, >= 130 dB
on every row against the float64 recurrence stepped in numpy and against
the plain route (both round the output once to float32: ~150 dB), and
every sample within an ulp of its row's peak of the plain route's (each
lies within half an ulp of the exact value; near a zero crossing the
scan's float64 cancellation is above an ulp of the sample itself); the
carried samples bit for bit, the carried outputs the block's last.  The
routes are compared from one state each block: a float32 state an ulp
apart rings through the CTCSS notch's next ~800 samples (poles at r =
0.9987), far above the rounding."""

import numpy as np
import pytest
import torch

from quisk_tpu_torch.ops import iir

pytestmark = pytest.mark.card
FS = 48e3


@pytest.fixture
def dev():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def notch(dev, f0=100.0):
    return iir.Biquad.notch(f0, FS, dev, q=5.0)


def signal(rng, C, B, dev):
    t = np.arange(B) / FS
    x = 0.5 * np.sin(2 * np.pi * 100.0 * t) + 0.3 * rng.standard_normal((C, B))
    return torch.as_tensor(x.astype(np.float32), device=dev)


def recurrence64(op, state, x):
    """The float64 recurrence from ``state`` over the block, in numpy."""
    b0, b1, b2, a1, a2 = (float(c) for c in op.coefs())
    x1, x2, y1, y2 = (s.double().cpu().numpy() for s in state)
    x = x.double().cpu().numpy()
    y = np.empty_like(x)
    for n in range(x.shape[1]):
        y[:, n] = b0 * x[:, n] + b1 * x1 + b2 * x2 - a1 * y1 - a2 * y2
        x2, x1, y2, y1 = x1, x[:, n], y1, y[:, n]
    return y


def row_db(ref, got) -> float:
    """The worst row's SNR of ``got`` against ``ref``, in dB."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float((10 * np.log10((ref ** 2).mean(-1)
                                / ((err ** 2).mean(-1) + 1e-300))).min())


def assert_block(op, st, x, got):
    """One kernel block against the recurrence and the plain route, from
    the same state: every sample within an ulp of its row's peak of the
    plain route's, and the carried state the block's last samples."""
    (sk, yk), (sp, yp) = got, op.plain(st, x)
    yk_np, yp_np = yk.cpu().numpy(), yp.cpu().numpy()
    assert row_db(recurrence64(op, st, x), yk_np) >= 130.0
    assert row_db(yp_np, yk_np) >= 130.0
    peak = np.maximum(np.abs(yk_np), np.abs(yp_np)).max(-1, keepdims=True)
    assert np.all(np.abs(yk_np - yp_np) <= np.spacing(peak))
    assert torch.equal(sk[0], sp[0]) and torch.equal(sk[1], sp[1])
    assert torch.equal(sk[2], yk[:, -1])
    assert torch.equal(sk[3], torch.cat([st[2][:, None], yk], -1)[:, -2])


@pytest.mark.parametrize("C,B", [(8192, 2048), (1024, 2048), (1, 2048),
                                 (3, 1), (5, 777), (2, 8000)])
def test_kernel_matches_recurrence_and_plain(dev, C, B):
    """4 chained blocks: the NFM cell's shape, the flagship's count, one
    channel, one sample, a block no tile divides whose rows are not
    16-byte aligned, a long block."""
    op = notch(dev)
    rng = np.random.default_rng(C + B)
    st = op.init_state(C)
    n0 = iir.biquad_df1.launches
    for _ in range(4):
        x = signal(rng, C, B, dev)
        got = op(st, x)
        assert_block(op, st, x, got)
        st = got[0]
    torch.cuda.synchronize()
    assert iir.biquad_df1.launches == n0 + 4


def test_strided_and_unaligned_rows(dev):
    """Rows a slice of a wider block (not 16-byte aligned), the state the
    plain route's strided views."""
    op = notch(dev)
    rng = np.random.default_rng(3)
    C, B = 40, 1000
    st = op.plain(op.init_state(C), signal(rng, C, B, dev))[0]
    assert st[0].stride(0) != 1 and st[2].stride(0) != 1
    wide = signal(rng, C, B + 3, dev)
    x = wide[:, 1:B + 1]
    assert x.data_ptr() % 16 and x.stride(0) == B + 3
    assert_block(op, st, x.contiguous(), op(st, x))


def test_launch_count(dev):
    op = notch(dev)
    st = op.init_state(2)
    n0 = iir.biquad_df1.launches
    for i in range(3):
        st, _ = op(st, torch.zeros((2, 64), device=dev))
        assert iir.biquad_df1.launches == n0 + i + 1
    op.plain(st, torch.zeros((2, 64), device=dev))
    assert iir.biquad_df1.launches == n0 + 3


def test_coefficients_read_on_the_card(dev):
    """Coefficients rewritten in place on the card (no sync between) take
    effect at the next launch: the 100 Hz notch becomes a 150 Hz one."""
    op, other = notch(dev), notch(dev, 150.0)
    rng = np.random.default_rng(5)
    C, B = 16, 2048
    st = op.init_state(C)
    x = signal(rng, C, B, dev)
    before = op(st, x)[1]
    for mine, theirs in zip(op.coefs(), other.coefs()):
        mine.copy_(theirs)
    got = op(st, x)
    assert_block(other, st, x, got)
    assert not torch.allclose(got[1], before)


def test_cuda_graph_capture(dev):
    """One call captured and replayed: the wrapper makes no host sync and
    allocates through torch, so the capture holds; a replay on new data
    matches the plain route."""
    op = notch(dev)
    rng = np.random.default_rng(6)
    C, B = 64, 2048
    st = tuple(s.contiguous() for s in
               op.plain(op.init_state(C), signal(rng, C, B, dev))[0])
    x = signal(rng, C, B, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(st, x)                                     # build, load, warm
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    n0 = iir.biquad_df1.launches
    with torch.cuda.graph(g):
        out = op(st, x)
    assert iir.biquad_df1.launches == n0 + 1          # counted at capture
    x.copy_(signal(rng, C, B, dev))
    g.replay()
    torch.cuda.synchronize()
    assert_block(op, st, x, out)
    assert iir.biquad_df1.launches == n0 + 1          # a replay adds none
