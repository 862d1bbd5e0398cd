"""The mixed demodulator's kernel (``csrc/mixed_demod.cu``, ops/demod.py
``mixed_demod``) on a card, held to the plain route (``MixedDemod.plain``,
the torch ops on the card) and to the families computed in float64 from
the same samples.  Without a card every test here skips; on one, from the
repository's root:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_mixed_demod_card.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not need.)  Imports neither JAX nor the JAX package.

Tolerances are ROADMAP's floors: AM and FM rows >= 100 dB a row against
the plain route and >= 80 dB against float64 (measured on the CPU with a
copy of the kernel built against a stub of the CUDA names: >= 112 dB and
>= 136 dB); SSB, DGT_IQ and EXT rows the plain route's bits (one product,
or the EXT op's own audio); the carried previous samples bit for bit.
Each side carries its own state over the blocks.  The signals switch on
inside the first block, so the FM discriminator meets its 1e-12 gate
there, where a rounding apart opens it a sample apart (ROADMAP Queue F):
FM rows are compared from the next block on."""

import dataclasses

import numpy as np
import pytest
import torch

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import demod
from quisk_tpu_torch.ops.demod import MixedDemod
from quisk_tpu_torch.rx import RxChain, RxChainConfig

pytestmark = pytest.mark.card
FS = 48e3
CYCLING = [int(m) for m in (Mode.USB, Mode.LSB, Mode.AM, Mode.FM, Mode.EXT,
                            Mode.CWU, Mode.DGT_IQ, Mode.FM)]
QUARTERS = [int(m) for m in (Mode.USB, Mode.LSB, Mode.AM, Mode.FM)]
PLL = dict(ext_demod="pll_fm", ctcss_hz=100.0)


@pytest.fixture
def dev():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def cycling(C: int) -> list[int]:
    return [CYCLING[i % len(CYCLING)] for i in range(C)]


def quarters(C: int) -> list[int]:
    """The sharded PFB step's plan: a quarter of the channels a family."""
    return [QUARTERS[(4 * i) // C] for i in range(C)]


def signal(rng, C: int, B: int, blk: int, dev) -> torch.Tensor:
    """Block ``blk`` of a carrier a row at its own offset, FM-swung 2 rad
    at 500 Hz and AM-swung 50% at 300 Hz, under noise 34 dB down; in block
    0 it rises from 1e-9 to full scale, through the FM gate."""
    t = (blk * B + np.arange(B)) / FS
    f = rng.uniform(-3000.0, 3000.0, (C, 1))
    ph = 2 * np.pi * f * t + 2.0 * np.sin(2 * np.pi * 500.0 * t)
    amp = 0.5 * (1.0 + 0.5 * np.sin(2 * np.pi * 300.0 * t))
    if blk == 0:
        amp = amp * 10.0 ** np.minimum(0.0, -9.0 + 18.0 * np.arange(B) / B)
    noise = rng.standard_normal((C, B)) + 1j * rng.standard_normal((C, B))
    x = amp * np.exp(1j * ph) + 0.01 * (amp > 1e-3) * noise
    return torch.as_tensor(x.astype(np.complex64), device=dev)


def row_db(ref, got) -> float:
    """The worst row's SNR of ``got`` against ``ref``, in dB."""
    ref = torch.as_tensor(ref).double()
    err = torch.as_tensor(got).double().to(ref.device) - ref
    return float((10 * torch.log10((ref ** 2).mean(-1)
                                   / ((err ** 2).mean(-1) + 1e-300))).min())


class Ref64:
    """Every family in float64 on the host from the float32 samples, its
    state carried from rest as the routes carry theirs."""

    def __init__(self, op: MixedDemod, C: int):
        self.a_am, self.g_am = float(op.am.dc.a), float(op.am.gain)
        self.a_fm, self.b_fm = float(op.fm.deemph.a), float(op.fm.deemph.b)
        self.g_fm, self.g_ssb = float(op.fm.gain), float(op.ssb.gain)
        self.ex, self.ya, self.yf = np.zeros(C), np.zeros(C), np.zeros(C)
        self.p = np.zeros(C, np.complex128)

    def __call__(self, x: torch.Tensor) -> dict:
        x = x.cpu().numpy().astype(np.complex128)
        env = np.abs(x)
        d_am = env - np.concatenate([self.ex[:, None], env[:, :-1]], -1)
        d = x * np.conj(np.concatenate([self.p[:, None], x[:, :-1]], -1))
        u = self.b_fm * self.g_fm * np.where(np.abs(d) > 1e-12,
                                             np.angle(d), 0.0)
        am, fm = np.empty_like(env), np.empty_like(env)
        ya, yf = self.ya, self.yf
        for n in range(x.shape[1]):
            ya = self.a_am * ya + d_am[:, n]
            yf = self.a_fm * yf + u[:, n]
            am[:, n], fm[:, n] = ya, yf
        self.ex, self.ya, self.yf, self.p = env[:, -1], ya, yf, x[:, -1]
        return {"am": self.g_am * am, "fm": fm, "ssb": self.g_ssb * x.real}


def assert_block(modes, blk: int, x, kern, plain, ref: dict) -> None:
    """One block of the kernel route against the plain route and float64,
    each from its own state: AM / FM rows by SNR, every other row the plain
    route's bits; the carried states."""
    (ka, kf, _), yk = kern
    (pa, pf, _), yp = plain
    m = torch.as_tensor(modes, device=yk.device)
    for fam, mode in (("am", int(Mode.AM)), ("fm", int(Mode.FM))):
        rows = (m == mode).nonzero().flatten()
        if not len(rows) or (fam == "fm" and blk == 0):
            continue
        assert row_db(yp[rows], yk[rows]) >= 100.0, (fam, blk)
        assert row_db(ref[fam][rows.cpu().numpy()], yk[rows]) >= 80.0, \
            (fam, blk)
    rest = ((m != int(Mode.AM)) & (m != int(Mode.FM))).nonzero().flatten()
    assert torch.equal(yk[rest], yp[rest])
    assert torch.equal(kf[0], pf[0])                   # FM's previous sample
    assert torch.equal(kf[0], x[:, -1])
    assert torch.allclose(ka[0], pa[0], rtol=2.4e-7, atol=0)   # envelope
    assert torch.allclose(ka[1], pa[1], rtol=0, atol=1e-6)
    if blk > 0:
        assert torch.allclose(kf[1], pf[1], rtol=0, atol=1e-6)


def drive(dev, modes, B: int, nblk: int, ext: dict, retune=None,
          seed: int = 0) -> None:
    """``nblk`` chained blocks through both routes and float64; ``retune``
    (block, modes) changes every side's modes from that block on."""
    C = len(modes)
    op = MixedDemod.create(modes, FS, C, device=dev, **ext)
    rng = np.random.default_rng(seed + C + B)
    sk = sp = op.init_state(C)
    ref = Ref64(op, C)
    for blk in range(nblk):
        if retune is not None and blk == retune[0]:
            modes = retune[1]
            op = dataclasses.replace(op, mode=torch.as_tensor(
                modes, dtype=torch.int32, device=dev))
        x = signal(rng, C, B, blk, dev)
        n0 = demod.mixed_demod.launches
        kern, plain = op(sk, x), op.plain(sp, x)
        assert demod.mixed_demod.launches == n0 + 1
        assert_block(modes, blk, x, kern, plain, ref(x))
        sk, sp = kern[0], plain[0]
    torch.cuda.synchronize()


@pytest.mark.parametrize("C,B,nblk,plan", [
    (8192, 2048, 8, "cycling"),        # the benchmark's resident cells
    (1024, 2048, 8, "cycling"),        # the flagship
    (8, 512, 8, "cycling"),
    (3, 1000, 8, "cycling"),           # an odd B: a short last chunk
    (5, 1, 8, "cycling"),              # one sample a block
    (4096, 16384, 3, "quarters"),      # the sharded PFB step, a world of 1
])
def test_kernel_matches_plain_and_float64(dev, C, B, nblk, plan):
    """Cycling modes with the PLL on the EXT rows and DGT_IQ rows; the
    sharded PFB step's quarters (no EXT)."""
    if plan == "cycling":
        drive(dev, cycling(C), B, nblk, PLL)
    else:
        drive(dev, quarters(C), B, nblk, {})


def test_all_ext_with_the_pll(dev):
    """The NFM cell's plan: every row EXT.  The audio is the PLL path's
    bits, and the AM and FM states advance as the plain route's do."""
    drive(dev, [int(Mode.EXT)] * 1024, 2048, 8, PLL)


@pytest.mark.parametrize("C", [64, 8192])
def test_retune_mid_stream(dev, C):
    """EXT -> AM and USB -> FM at block 4: the retuned rows go on from
    the state their family carried while unused, on both routes and in
    float64."""
    before = [int(Mode.EXT), int(Mode.USB)] * (C // 2)
    after = [int(Mode.AM), int(Mode.FM)] * (C // 2)
    drive(dev, before, 2048, 8, PLL, retune=(4, after), seed=1)


@dataclasses.dataclass(frozen=True)
class PlainMixed(MixedDemod):
    """MixedDemod that runs its plain route on the card too."""

    def __call__(self, state, x):
        return self.plain(state, x)


def test_chain_with_dgt_iq_rows(dev):
    """The flagship chain at 64 channels with DGT_IQ rows, against the same
    chain whose demodulator runs the plain route: DGT_IQ rows carry the
    filtered IQ bit for bit, the rest hold from block 1 (the filter's
    warm-up meets the FM gate in block 0)."""
    C = 64
    modes = cycling(C)
    cfg = RxChainConfig(sample_rate=960e3, channels=C, audio_block=2048,
                        agc=True, fused_frontend=True)
    tune = [-240e3 + (c + 0.5) * 960e3 / (2 * C) for c in range(C)]
    chain = RxChain.create(cfg, tune_hz=tune, mode=modes, device=dev)
    assert chain.demod.iq_out
    plain = dataclasses.replace(chain, demod=PlainMixed(**{
        f.name: getattr(chain.demod, f.name)
        for f in dataclasses.fields(MixedDemod)}))
    rng = np.random.default_rng(7)
    sk, sp = chain.init_state(), plain.init_state()
    m = torch.as_tensor(modes, device=dev)
    iq = m == int(Mode.DGT_IQ)
    B = chain.block_in
    for blk in range(4):
        # an FM-swung carrier 500 Hz above each dial, under noise 34 dB
        # down: the discriminator off +-pi (on noise it wraps there)
        t = (blk * B + np.arange(B)) / 960e3
        ph = (2 * np.pi * (np.asarray(tune)[:, None] + 500.0) * t
              + 2.0 * np.sin(2 * np.pi * 300.0 * t))
        x = 0.5 * np.exp(1j * ph) + 0.01 * (
            rng.standard_normal((C, B)) + 1j * rng.standard_normal((C, B)))
        x = torch.as_tensor(x.astype(np.complex64), device=dev)
        n0 = demod.mixed_demod.launches
        sk, ak = chain.step(sk, x)
        sp, ap = plain.step(sp, x)
        assert demod.mixed_demod.launches == n0 + 1
        assert ak.dtype == torch.complex64
        assert torch.equal(ak[iq], ap[iq])
        if blk > 0:
            assert row_db(ap[~iq].real, ak[~iq].real) >= 100.0


def test_fm_gate(dev):
    """|x[n] conj(x[n-1])| below 1e-12 gives a zero discriminator, as on
    the plain route: a row of 1e-7 samples leaves the de-emphasis at rest."""
    op = MixedDemod.create(int(Mode.FM), FS, 2, device=dev)
    x = torch.full((2, 64), 1e-7 + 1e-7j, dtype=torch.complex64, device=dev)
    x[1] = signal(np.random.default_rng(2), 1, 64, 1, dev)[0]
    st = op.init_state(2)
    (_, (_, yk), _), ak = op(st, x)
    _, ap = op.plain(st, x)
    assert torch.equal(ak[0], torch.zeros(64, device=dev))
    assert float(yk[0]) == 0.0
    assert row_db(ap[1:], ak[1:]) >= 100.0


def test_strided_unaligned_rows_and_states(dev):
    """Rows a slice of a wider block (not 16-byte aligned), time-major
    samples (the sharded PFB step's transposed planes), the state the plain
    route's strided views, an EXT audio with strided samples."""
    C, B = 40, 1000
    op = MixedDemod.create(cycling(C), FS, C, device=dev)
    rng = np.random.default_rng(3)
    st = op.plain(op.init_state(C), signal(rng, C, B, 1, dev))[0]
    assert st[0][0].stride(0) != 1 and st[1][0].stride(0) != 1
    wide = signal(rng, C, B + 3, 2, dev)
    x = wide[:, 1:B + 1]
    assert x.data_ptr() % 16 and x.stride(0) == B + 3
    got = op(st, x)
    assert_block(cycling(C), 1, x, got, op.plain(st, x.contiguous()),
                 _ref_from(op, st, x))
    xt = x.T.contiguous().T                       # strides (1, C)
    assert xt.stride(1) == C
    assert_block(cycling(C), 1, xt, op(st, xt), op.plain(st, x.contiguous()),
                 _ref_from(op, st, x))
    ext = torch.randn((C, 2 * B), device=dev)[:, ::2]
    (a1, f1), y1 = demod.mixed_demod(op, st[0], st[1], x, ext)
    rows = torch.as_tensor(cycling(C), device=dev) == int(Mode.EXT)
    assert torch.equal(y1[rows], ext[rows])


def _ref_from(op, st, x) -> dict:
    """The float64 families of one block from the state ``st``."""
    ref = Ref64(op, x.shape[0])
    (ax, ay), (fp, fy), _ = st
    ref.ex, ref.ya = ax.double().cpu().numpy(), ay.double().cpu().numpy()
    ref.p = fp.cpu().numpy().astype(np.complex128)
    ref.yf = fy.double().cpu().numpy()
    return ref(x)


def test_launch_count_and_bad_ext_audio(dev):
    op = MixedDemod.create(cycling(8), FS, 8, device=dev)
    st = op.init_state(8)
    x = signal(np.random.default_rng(4), 8, 64, 1, dev)
    n0 = demod.mixed_demod.launches
    for i in range(3):
        st, _ = op(st, x)
        assert demod.mixed_demod.launches == n0 + i + 1
    op.plain(st, x)
    assert demod.mixed_demod.launches == n0 + 3
    with pytest.raises(TypeError):
        demod.mixed_demod(op, st[0], st[1], x,
                          torch.zeros((8, 64), dtype=torch.float64,
                                      device=dev))
    assert demod.mixed_demod.launches == n0 + 3


def test_cuda_graph_capture(dev):
    """One call captured and replayed: the wrapper makes no host sync and
    allocates through torch, so the capture holds; a replay on new data
    matches the plain route."""
    C, B = 64, 2048
    op = MixedDemod.create(cycling(C), FS, C, device=dev)
    rng = np.random.default_rng(6)
    st = op.plain(op.init_state(C), signal(rng, C, B, 1, dev))[0]
    x = signal(rng, C, B, 2, dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        op(st, x)                                     # build, load, warm
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    n0 = demod.mixed_demod.launches
    with torch.cuda.graph(g):
        out = op(st, x)
    assert demod.mixed_demod.launches == n0 + 1       # counted at capture
    x.copy_(signal(rng, C, B, 3, dev))
    g.replay()
    torch.cuda.synchronize()
    assert_block(cycling(C), 1, x, out, op.plain(st, x), _ref_from(op, st, x))
    assert demod.mixed_demod.launches == n0 + 1       # a replay adds none
