"""The lookahead AGC's kernel (``csrc/agc_delay.cu``, ops/agc.py
``agc_delay``) held to the plain route (``AGC.plain``, torch ops) on a card.
Without a card every test here skips; on one, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_agc_delay_card.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not need.)  Imports neither JAX nor the JAX package.

Tolerances: the output within 2e-5 of each row's peak, the log gain within
5e-6 (the kernel's scan lies two roundings from the exact recurrence, the
plain doubling up to log2(B) + 1; an ulp near a log gain of 9 is 9.5e-7),
the new delay line bit for bit."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.ops import agc

pytestmark = pytest.mark.card
FS = 48e3
SCALES = np.array([1e-3, 0.1, 1.0, 30.0, 3e-4], np.float32)


@pytest.fixture
def dev():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def audio(rng, C, B, dev):
    a = rng.standard_normal((C, B)) * SCALES[np.arange(C) % 5][:, None]
    a[:, B // 3] *= 50.0
    return torch.from_numpy(a.astype(np.float32)).to(dev)


def assert_close(got, ref):
    (dg, lg), yg = got
    (dr, lr), yr = ref
    assert torch.equal(dg, dr)
    peak = yr.abs().amax(-1, keepdim=True)
    assert bool(((yg - yr).abs() <= 2e-5 * peak).all())
    assert float((lg - lr).abs().max()) <= 5e-6


@pytest.mark.parametrize("C,B", [(1, 2048), (4, 256), (3, 1), (5, 777),
                                 (1024, 2048), (8192, 2048), (2, 8000)])
def test_kernel_matches_plain(dev, C, B):
    """Chained blocks from one state each side; a block shorter than the
    lookahead, one sample, an odd length, the paths' shapes, and a block
    whose shared memory passes the 48 KB default (opt-in)."""
    op = agc.AGC.create(FS, device=dev)
    rng = np.random.default_rng(C + B)
    sk = sp = op.init_state(C)
    n0 = agc.agc_delay.launches
    blocks = 3 if C * B > 1 << 20 else 6
    for _ in range(blocks):
        a = audio(rng, C, B, dev)
        got, ref = op(sk, a), op.plain(sp, a)
        assert_close(got, ref)
        sk, sp = got[0], ref[0]
    torch.cuda.synchronize()
    assert agc.agc_delay.launches == n0 + blocks


def test_strided_and_unaligned_rows(dev):
    """Rows a slice of a wider block (not 16-byte aligned), a delay line
    and a log gain from the plain route (strided views)."""
    op = agc.AGC.create(FS, device=dev)
    rng = np.random.default_rng(3)
    C, B = 6, 1000
    st = op.plain(op.init_state(C), audio(rng, C, B, dev))[0]
    assert st[0].stride(0) != op.lookahead and st[1].stride(0) != 1
    wide = audio(rng, C, B + 3, dev)
    a = wide[:, 1:B + 1]
    assert_close(op(st, a), op.plain(st, a.contiguous()))


def test_lookahead_not_a_multiple_of_4(dev):
    op = agc.AGC.create(FS, lookahead_ms=0.15, device=dev)     # W = 7
    assert op.lookahead % 4
    rng = np.random.default_rng(4)
    sk = sp = op.init_state(3)
    for _ in range(3):
        a = audio(rng, 3, 300, dev)
        got, ref = op(sk, a), op.plain(sp, a)
        assert_close(got, ref)
        sk, sp = got[0], ref[0]


def test_shared_memory_limit_raises(dev):
    op = agc.AGC.create(FS, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        op(op.init_state(1), torch.zeros((1, 200_000), device=dev))


def test_set_agc_level_reaches_kernel(dev):
    """Radio.set_agc_level swaps the 0-dim parameters; the kernel reads
    them on the card at its next launch, with no rebuild."""
    @dataclasses.dataclass(frozen=True)
    class Chain:
        agc: agc.AGC
    op = agc.AGC.create(FS, device=dev)
    radio = types.SimpleNamespace(chain=Chain(op), device=dev)
    rng = np.random.default_rng(5)
    C, B = 5, 2048
    st = op.init_state(C)
    a = audio(rng, C, B, dev)
    # a log gain above both ceilings: the new one binds at once
    st = (op(st, a)[0][0], torch.full((C,), 9.0, device=dev))
    a = audio(rng, C, B, dev)
    _, before = op(st, a)
    Radio.set_agc_level(radio, max_gain_db=20.0, target=0.5)
    new = radio.chain.agc
    assert new is not op and new.target.device.type == "cuda"
    got, ref = new(st, a), new.plain(st, a)
    assert_close(got, ref)
    peak = got[1].abs().amax(-1)
    assert float(peak[2]) <= 0.5 * (1 + 1e-5)        # the new target
    # the quietest row (3e-4) sits at the new 20 dB ceiling
    assert float(got[0][1][4]) == pytest.approx(np.log(10.0), abs=1e-5)
    assert not torch.allclose(got[1], before)


def test_cuda_graph_capture(dev):
    """One call captured and replayed: the wrapper makes no host sync and
    allocates through torch, so the capture holds; a replay on new data
    matches the plain route."""
    op = agc.AGC.create(FS, device=dev)
    rng = np.random.default_rng(6)
    C, B = 64, 2048
    st = op.plain(op.init_state(C), audio(rng, C, B, dev))[0]
    st = (st[0].contiguous(), st[1].contiguous())
    a = audio(rng, C, B, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(st, a)                                     # build, load, warm
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    n0 = agc.agc_delay.launches
    with torch.cuda.graph(g):
        out = op(st, a)
    assert agc.agc_delay.launches == n0 + 1           # counted at capture
    a.copy_(audio(rng, C, B, dev))
    g.replay()
    torch.cuda.synchronize()
    assert_close(out, op.plain(st, a))
    assert agc.agc_delay.launches == n0 + 1           # a replay adds none


def test_launch_count(dev):
    op = agc.AGC.create(FS, device=dev)
    st = op.init_state(2)
    n0 = agc.agc_delay.launches
    for i in range(3):
        st, _ = op(st, torch.zeros((2, 64), device=dev))
        assert agc.agc_delay.launches == n0 + i + 1
    op.plain(st, torch.zeros((2, 64), device=dev))
    assert agc.agc_delay.launches == n0 + 3
