"""What the front kernel's register-blocked FIR core
(quisk_tpu_torch/csrc/fused_tune_decimate.cu) relies on, held on the CPU,
where the kernel itself cannot run.

- The kernel's accumulation, written here in numpy as the kernel orders
  it: blocks of O outputs, threads of R consecutive outputs, the window
  staged P phases at a time (the last groups halved to fit d) into rows
  that store element j at slot j + j//R (unwritten slots poisoned with
  NaN), each thread's samples taken a chunk of R at a time with the next
  chunk beside it, every product an fma in float32 in the order over p
  and then taps, the ragged edges masked (samples past the window or the
  block staged as zero, outputs at or past N dropped).  It gives the plain version's output to within 1e-5
  of the peak at the flagship's taps and decimation, at the NFM shape and
  at the shapes its edges are made of, for several (O, R, P).
- The padded row layout: at every slide step the 16 lanes of each
  half-warp read 16 distinct 8-byte bank pairs (an unpadded row at R = 8
  gives an 8-way conflict), and the staging stores of P rows with the row
  stride the launcher picks spread over the banks too.
- The NB-detect mode's gout rule: over the tiles of a block, each x-group
  is written exactly once, from inside the tile's gain slab.
"""

import numpy as np
import pytest
import torch

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import fused_front as ff
from quisk_tpu_torch.ops.nco import MASK32
from quisk_tpu_torch.rx import RxChain, RxChainConfig

TOL = 1e-5
TWO_PI_OVER_2_32 = np.float32(2 * np.pi / 2 ** 32)
R = 8                            # the kernel's outputs a thread
# (O, R, P): the launcher's full tile (256 threads, 4 phases a group) and
# the tiles it shrinks to, fewer threads while half a tile covers N (O down
# to 32 threads), fewer phases while shared memory does not fit
DESIGNS = [(2048, R, 4), (1024, R, 4), (512, R, 2), (256, R, 1),
           (2048, R, 2), (256, R, 4)]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """torch on one thread, as the other parity files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def row_stride(O: int, nqp: int, R: int, P: int) -> int:
    """The launcher's row stride: the padded row's slots, rounded up to
    16/P mod 16 float2 slots."""
    slots = (O + nqp) // R * (R + 1)
    want = (16 // P) % 16
    return slots + (want - slots % 16) % 16


def fma32(a, b, c):
    """float32 fma: the product is exact in float64, one rounding."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def tuned(x, hist, word, phase0):
    """ext = [hist | x] mixed by the int32-angle NCO in float32."""
    ext = np.concatenate([hist, x], axis=-1)
    n = np.arange(ext.shape[-1], dtype=np.int64)
    ph = (phase0[:, None] + word[:, None] * n[None, :]) & MASK32
    ang = ph.astype(np.uint32).view(np.int32).astype(np.float32) \
        * TWO_PI_OVER_2_32
    cs, sn = np.cos(ang), np.sin(ang)
    a, b = ext.real.astype(np.float32), ext.imag.astype(np.float32)
    return a * cs + b * sn, b * cs - a * sn


def core_emulation(x, hist, word, phase0, h_rev, d, O, R, P):
    """y [C, B/d] as the kernel computes it (see the module note)."""
    C, B = x.shape
    T = h_rev.shape[0]
    H, N, L = T - 1, B // d, B + T - 1
    nq = -(-T // d)
    nqp = -(-nq // R) * R
    nt = O // R
    hp = np.zeros((d, nqp), np.float32)
    for p in range(d):
        t = np.arange(nqp) * d + p
        hp[p, t < T] = h_rev[t[t < T]]
    t_re, t_im = tuned(x, hist, word, phase0)
    rowj = O + nqp
    rs = row_stride(O, nqp, R, P)
    j = np.arange(rowj)
    thread = np.arange(nt) * (R + 1)
    y = np.full((C, N), np.nan, np.complex64)
    for k0 in range(0, N, O):
        n0, W = k0 * d, O * d + H
        acc_re = np.zeros((C, nt, R), np.float32)
        acc_im = np.zeros((C, nt, R), np.float32)
        pa = 0
        while pa < d:
            np_ = P                     # groups of P, halved to fit d
            while np_ > d - pa:
                np_ //= 2
            buf_re = np.full((C, np_ * rs), np.nan, np.float32)
            buf_im = np.full((C, np_ * rs), np.nan, np.float32)
            for pp in range(np_):
                wo = j * d + pa + pp
                n = n0 + wo
                ok = (wo < W) & (n < L)
                slot = pp * rs + j + j // R
                buf_re[:, slot] = np.where(ok, t_re[:, np.minimum(n, L - 1)],
                                           0)
                buf_im[:, slot] = np.where(ok, t_im[:, np.minimum(n, L - 1)],
                                           0)
            for pp in range(np_):
                base = pp * rs + thread

                def chunk(ch):
                    """[C, nt, R] re, im of each thread's chunk ch."""
                    at = base + ch * (R + 1)
                    return (np.stack([buf_re[:, at + r] for r in range(R)], -1),
                            np.stack([buf_im[:, at + r] for r in range(R)], -1))
                now = chunk(0)
                for ch in range(nqp // R):
                    nxt = chunk(ch + 1)
                    h = hp[pa + pp, ch * R:(ch + 1) * R]
                    two_re = np.concatenate([now[0], nxt[0]], -1)
                    two_im = np.concatenate([now[1], nxt[1]], -1)
                    for s in range(R):
                        # output r takes sample r + s: now[r+s] or nxt[r+s-R]
                        acc_re = fma32(two_re[..., s:s + R], h[s], acc_re)
                        acc_im = fma32(two_im[..., s:s + R], h[s], acc_im)
                    now = nxt
            pa += np_
        k = k0 + np.arange(O)
        live = k < N
        out = (acc_re + 1j * acc_im).reshape(C, O)
        y[:, k[live]] = out[:, live]
    return y


def _random_case(rng, C, B, T, d, words=None):
    x = (rng.standard_normal((C, B))
         + 1j * rng.standard_normal((C, B))).astype(np.complex64)
    hist = (rng.standard_normal((C, T - 1))
            + 1j * rng.standard_normal((C, T - 1))).astype(np.complex64)
    word = (rng.integers(0, 2 ** 32, C) if words is None
            else np.asarray(words)).astype(np.int64)
    phase0 = rng.integers(0, 2 ** 32, C).astype(np.int64)
    h_rev = (rng.standard_normal(T) / np.sqrt(T)).astype(np.float32)
    return x, hist, word, phase0, h_rev


def _hold(case, d, design):
    x, hist, word, phase0, h_rev = case
    got = core_emulation(x, hist, word, phase0, h_rev, d, *design)
    want = ff.fused_tune_decimate_plain(
        torch.as_tensor(x), torch.as_tensor(hist), torch.as_tensor(word),
        torch.as_tensor(phase0), torch.as_tensor(h_rev), d).numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * peak


def _front(cfg, C):
    fs = cfg.sample_rate
    tune = [-fs / 4 + (i + 0.5) * fs / 8 for i in range(C)]
    return RxChain.create(cfg, tune_hz=tune, mode=int(Mode.USB),
                          device="cpu").front


@pytest.mark.parametrize("design", DESIGNS, ids=str)
def test_core_matches_plain_at_flagship_taps(design):
    cfg = RxChainConfig(sample_rate=960e3, channels=2, audio_block=2048,
                        agc=True, fused_frontend=True)
    op = _front(cfg, 2)
    assert (op.block, op.ntaps, op.decim) == (40960, 1421, 20)
    rng = np.random.default_rng(1)
    x, hist, word, phase0, _ = _random_case(rng, 2, op.block, op.ntaps, 20)
    _hold((x, hist, op.word.numpy(), phase0, op.h_rev.numpy()), 20, design)


@pytest.mark.parametrize("design", DESIGNS[:4], ids=str)
def test_core_matches_plain_at_nfm_shape(design):
    cfg = RxChainConfig(sample_rate=192e3, channels=2, audio_block=2048,
                        agc=True, fm_squelch=True, fused_frontend=True)
    op = _front(cfg, 2)
    assert (op.block, op.ntaps, op.decim) == (8192, 133, 4)
    rng = np.random.default_rng(2)
    x, hist, word, phase0, _ = _random_case(rng, 2, op.block, op.ntaps, 4)
    _hold((x, hist, op.word.numpy(), phase0, op.h_rev.numpy()), 4, design)


def _odd_shapes(O, R):
    """(channels, block, taps, decim, words): the edges of the tile."""
    return {
        "N=1": (3, 2, 45, 2, None),
        "N=kR+1": (4, 3 * (37 * R + 1), 61, 3, None),
        "N=O-1": (2, 4 * (O - 1), 133, 4, None),
        "T=1": (3, 200, 1, 2, None),
        "T<d": (3, 500, 3, 5, None),
        "T=nq*d, nq=kR": (2, 6000, 9 * R * 20, 20, None),
        "T=nq*d": (2, 315, 9 * 5, 5, None),
        "d=1": (2, 700, 33, 1, None),
        "words": (2, 640, 45, 2, [0, 2 ** 31 + 12345]),
    }


@pytest.mark.parametrize("design", [DESIGNS[0], DESIGNS[2], DESIGNS[4]],
                         ids=str)
@pytest.mark.parametrize("shape", list(_odd_shapes(1024, R)))
def test_core_matches_plain_at_odd_shapes(shape, design):
    O = design[0]
    Cn, B, T, d, words = _odd_shapes(O, R)[shape]
    rng = np.random.default_rng(list(_odd_shapes(O, R)).index(shape))
    _hold(_random_case(rng, Cn, B, T, d, words), d, design)


def _bank_pairs(slots) -> int:
    """Distinct 8-byte bank pairs that float2 slots hit (32 banks of 4 B)."""
    return len({int(s) % 16 for s in slots})


@pytest.mark.parametrize("nqp", [8, 40, 72])
@pytest.mark.parametrize("P", [1, 2, 4])
def test_padded_row_reads_are_conflict_free(nqp, P):
    """Taps a phase padded to nqp: 8 (T < d), 40 (NFM), 72 (flagship)."""
    rs = row_stride(32 * R, nqp, R, P)
    for pp in range(P):
        for half in (range(16), range(16, 32)):
            t = np.asarray(half)
            base = pp * rs + t * (R + 1)
            steps = [base + r for r in range(R)]              # the ring fill
            steps += [base + (ch + 1) * (R + 1) + s            # each slide
                      for ch in range(nqp // R) for s in range(R)]
            for slots in steps:
                assert _bank_pairs(slots) == 16


def test_unpadded_row_would_conflict():
    """The layout matters: without the pad, lane t at R = 8 reads t*8 + s,
    and 16 lanes share 2 bank pairs (an 8-way conflict)."""
    t = np.arange(16)
    assert _bank_pairs(t * 8) == 2
    assert _bank_pairs(t * 9) == 16


@pytest.mark.parametrize("P", [1, 2, 4])
def test_staging_stores_spread_over_the_banks(P):
    """Consecutive threads take consecutive phases of one j (pp fastest):
    a half-warp stores 16 // P samples into each of P rows, at R = 8.  With
    P = 2 or 4 the row stride puts the rows' runs on distinct bank pairs;
    with P = 1 the run of 16 crosses one pad, and two stores share a pair."""
    O, nqp = 1024, 72
    rs = row_stride(O, nqp, R, P)
    for i0 in range(0, P * (O + nqp) - 16, 16):
        i = np.arange(i0, i0 + 16)
        j, pp = i // P, i % P
        assert _bank_pairs(pp * rs + j + j // R) == (15 if P == 1 else 16)


# (block, taps, decim, avg_win): the featured shape and the gain modes' odd
# shapes
GOUT_SHAPES = [(40960, 1421, 20, 64), (32, 9, 2, 16), (4800, 133, 5, 64),
               (1200, 61, 3, 32), (6000, 301, 20, 64), (640, 45, 2, 64)]


@pytest.mark.parametrize("O", [128, 256, 512, 1024, 2048])
@pytest.mark.parametrize("shape", GOUT_SHAPES, ids=str)
def test_gout_written_once_from_the_slab(shape, O):
    """The kernel's write rule: the tile at k0 writes x-groups m0 = k0*d/16
    to m0 + O*d/16 (at most B/16) from slab entry GH + m - g_lo, where the
    slab holds ng = (O*d + T - 1 + 14)//16 + 2 groups from g_lo =
    (k0*d + off)//16."""
    B, T, d, _ = shape
    N, GB = B // d, B // 16
    off, GH = ff.gain_grid(T)
    ng = (O * d + T - 1 + 14) // 16 + 2
    assert (O * d) % 16 == 0
    writes = np.zeros(GB, np.int64)
    for k0 in range(0, N, O):
        n0 = k0 * d
        g_lo = (n0 + off) >> 4
        m0 = n0 >> 4
        m = np.arange(m0, min(GB, m0 + (O * d >> 4)))
        np.add.at(writes, m, 1)
        slab = GH + m - g_lo
        assert ((slab >= 0) & (slab < ng)).all()
    assert (writes == 1).all()
