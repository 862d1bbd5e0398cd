"""The mixed-mode demodulator (ops/demod.py ``MixedDemod``) on the CPU: its
plain route against the JAX package's op over chained blocks, the audio
and every family's carried state, through a retune across families; the
recurrence algebra of the card's kernel (``csrc/mixed_demod.cu``) modelled
in numpy; the checks of the kernel's wrapper and its refusal of a device it
has no kernel for.  The kernel itself is held to the plain route on a card
by tests/test_torch_mixed_demod_card.py.

Tolerances: audio >= 100 dB a row against the JAX op (ROADMAP's floor for
an op against its reference; measured 120-145 dB here), the carried
envelope and samples within an ulp or two, the carried one-pole outputs
within 1e-6 (measured <= 2.7e-7; the two packages sum the recurrence in
other orders).  The kernel's recurrence model: >= 120 dB a row against the
float64 recurrence from the same carry; it reads 129.6-164 dB here, as the
serial float32 recurrence does (129.6-164), since each output is at most
8 float32 steps from a carry a few roundings off."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops import demod as jdemod

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import demod

CPU = "cpu"
FS = 48e3
CYCLING = [int(m) for m in (Mode.USB, Mode.LSB, Mode.AM, Mode.FM, Mode.EXT,
                            Mode.CWU, Mode.DGT_IQ, Mode.FM)]
ALL_EXT = [int(Mode.EXT)] * 8
EXT = "mixed_test_mag"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread (tests/test_torch_ops.py's reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class MagJ:
    """A custom EXT demod for the JAX package: |x| - 1."""

    def init_state(self, channels):
        return ()

    def __call__(self, state, x):
        return state, jnp.abs(x) - 1.0


class MagT:
    """The same for the port."""

    def init_state(self, channels):
        return ()

    def __call__(self, state, x):
        return state, torch.abs(x) - 1.0


jdemod.register_ext_demod(EXT, lambda fs, channels: MagJ())
demod.register_ext_demod(EXT, lambda fs, channels, device: MagT())


def signal(rng, C: int, B: int, n0: int) -> np.ndarray:
    """A carrier a row at its own offset, FM-swung 2 rad at 500 Hz and
    AM-swung 50% at 300 Hz, under noise 34 dB down: the discriminator far
    from its gate and from +-pi, the envelope far from zero."""
    t = (n0 + np.arange(B)) / FS
    f = rng.uniform(-3000.0, 3000.0, (C, 1))
    ph = 2 * np.pi * f * t + 2.0 * np.sin(2 * np.pi * 500.0 * t)
    amp = 0.5 * (1.0 + 0.5 * np.sin(2 * np.pi * 300.0 * t))
    x = amp * np.exp(1j * ph) + 0.01 * (rng.standard_normal((C, B))
                                        + 1j * rng.standard_normal((C, B)))
    return x.astype(np.complex64)


def row_db(ref, got) -> float:
    """The worst row's SNR of ``got`` against ``ref``, in dB."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float((10 * np.log10((ref ** 2).mean(-1)
                                / ((err ** 2).mean(-1) + 1e-300))).min())


def assert_states(jst, pst):
    """Every family's carried state: AM (envelope, DC blocker output), FM
    (previous sample, de-emphasis output)."""
    (jax_, jay), (jfp, jfy), _ = jst
    (pax, pay), (pfp, pfy), _ = pst
    assert np.allclose(pax.numpy(), np.asarray(jax_), rtol=0, atol=2.4e-7)
    assert np.allclose(pay.numpy(), np.asarray(jay), rtol=0, atol=1e-6)
    assert np.array_equal(pfp.numpy(), np.asarray(jfp))
    assert np.allclose(pfy.numpy(), np.asarray(jfy), rtol=0, atol=1e-6)


@pytest.mark.parametrize("modes,B", [(CYCLING, 2048), (ALL_EXT, 2048),
                                     (CYCLING, 1000)])
def test_plain_matches_jax_with_every_state(modes, B):
    """Four chained blocks on both sides: the audio, and the AM and FM
    states on every row, EXT rows included (the unused families advance
    there too, as in the JAX op)."""
    C = len(modes)
    jop = jdemod.MixedDemod.create(modes, FS, C, ext_demod=EXT)
    op = demod.MixedDemod.create(modes, FS, C, ext_demod=EXT, device=CPU)
    rng = np.random.default_rng(B + len(set(modes)))
    jst, pst = jop.init_state(C), op.init_state(C)
    for i in range(4):
        x = signal(rng, C, B, i * B)
        jst, jy = jop(jst, jnp.asarray(x))
        pst, py = op(pst, torch.from_numpy(x))
        assert row_db(jy, py.numpy()) >= 100.0
        assert_states(jst, pst)


def test_call_is_plain_on_cpu():
    op = demod.MixedDemod.create(CYCLING, FS, 8, ext_demod=EXT, device=CPU)
    st = op.init_state(8)
    x = torch.from_numpy(signal(np.random.default_rng(1), 8, 777, 0))
    n0 = demod.mixed_demod.launches
    (a1, f1, _), y1 = op(st, x)
    (a2, f2, _), y2 = op.plain(st, x)
    assert torch.equal(y1, y2)
    assert all(torch.equal(u, v) for u, v in zip(a1 + f1, a2 + f2))
    assert demod.mixed_demod.launches == n0


@pytest.mark.parametrize("before,after", [
    (int(Mode.EXT), int(Mode.AM)), (int(Mode.USB), int(Mode.FM)),
    (int(Mode.EXT), int(Mode.FM)), (int(Mode.LSB), int(Mode.AM))])
def test_retune_across_families_continues_warm(before, after):
    """Three blocks in one mode, a retune of every row, three more: the
    retuned family continues from the state it carried while unused, as
    the JAX op's does, and not from rest."""
    C, B = 4, 2048
    jop = jdemod.MixedDemod.create(before, FS, C, ext_demod=EXT)
    op = demod.MixedDemod.create(before, FS, C, ext_demod=EXT, device=CPU)
    rng = np.random.default_rng(10 * before + after)
    jst, pst = jop.init_state(C), op.init_state(C)
    xs = [signal(rng, C, B, i * B) for i in range(6)]
    for i, x in enumerate(xs):
        if i == 3:
            jop = jop.replace(mode=jnp.full((C,), after, jnp.int32))
            op = dataclasses.replace(op, mode=torch.full(
                (C,), after, dtype=torch.int32))
            cold = op.plain(op.init_state(C), torch.from_numpy(x))[1]
        jst, jy = jop(jst, jnp.asarray(x))
        pst, py = op(pst, torch.from_numpy(x))
        assert row_db(jy, py.numpy()) >= 100.0
        assert_states(jst, pst)
        if i == 3:                    # a cold start would read otherwise
            assert row_db(jy, cold.numpy()) < 60.0


def test_fm_gate_on_the_plain_route():
    """|x[n] conj(x[n-1])| below 1e-12 gives a zero discriminator: a row of
    1e-7 samples leaves the de-emphasis at rest."""
    op = demod.MixedDemod.create(int(Mode.FM), FS, 2, device=CPU)
    x = torch.full((2, 64), 1e-7 + 1e-7j, dtype=torch.complex64)
    x[1] = torch.from_numpy(signal(np.random.default_rng(2), 1, 64, 0)[0])
    _, y = op(op.init_state(2), x)
    assert torch.equal(y[0], torch.zeros(64))
    assert bool((y[1] != 0).any())


# ------------------------------------------- the kernel's algebra, in numpy
PER, THREADS = 8, 256                        # the kernel's kPer, a block


def fma32(a, b, c):
    """float32 fma: the float32 product is exact in float64."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def kernel_model(a: np.float32, u: np.ndarray, c: np.float32) -> np.ndarray:
    """The kernel's one-pole over a row of inputs ``u`` from carry ``c``:
    passes of THREADS chunks of PER samples; each chunk's sum from zero in
    float32 fma; the carries by the power scan in float32 (shuffle rounds
    d = 1 .. 16 with a^(8d) inside a warp, then warp by warp with a^256;
    a^8, a^(8 lane) and a^256 made in float64 and rounded once, a^(8d)
    squared in float32); each chunk stepped again in float32 from its
    carry."""
    B = u.shape[0]
    q = np.float64(a) ** PER
    lanes = (q ** np.arange(32)).astype(np.float32)
    wq = np.float32(q ** 32)
    y = np.empty(B, np.float32)
    carry = np.float32(c)
    for t0 in range(0, B, THREADS * PER):
        e = np.zeros(THREADS, np.float32)
        for t in range(THREADS):
            acc = np.float32(0)
            for n in range(t0 + t * PER, min(t0 + (t + 1) * PER, B)):
                acc = fma32(a, acc, u[n])
            e[t] = acc
        s = e.reshape(-1, 32)                          # [warps, lanes]
        qd, d = np.float32(q), 1
        while d < 32:
            s = np.concatenate([s[:, :d], fma32(qd, s[:, :-d], s[:, d:])],
                               -1)
            qd, d = np.float32(qd * qd), 2 * d
        excl = np.concatenate([np.zeros((s.shape[0], 1), np.float32),
                               s[:, :-1]], -1)
        for w in range(s.shape[0]):
            for lane in range(32):
                r = fma32(lanes[lane], carry, excl[w, lane])
                p0 = t0 + (32 * w + lane) * PER
                for n in range(p0, min(p0 + PER, B)):
                    r = fma32(a, r, u[n])
                    y[n] = r
            carry = fma32(wq, carry, s[w, -1])
    return y


@pytest.mark.parametrize("a", [0.995, 0.96149]) # the DC blocker, de-emphasis
@pytest.mark.parametrize("B", [2048, 4100, 1000, 9, 1])
def test_kernel_model_matches_recurrence(a, B):
    """Two passes with a ragged last chunk (4100), one short pass, a part of
    a warp, one sample: against the float64 recurrence from the carry."""
    rng = np.random.default_rng(B)
    a = np.float32(a)
    u = (rng.standard_normal(B) * 0.1).astype(np.float32)
    c = np.float32(0.3)
    y = kernel_model(a, u, c)
    ref = np.empty(B)
    r = np.float64(c)
    for n in range(B):
        r = np.float64(a) * r + u[n]
        ref[n] = r
    assert row_db(ref[None], y[None]) >= 120.0


# ------------------------------------------------------------- the checks
def _bad_calls():
    C, B = 3, 64
    op = demod.MixedDemod.create(CYCLING[:C], FS, C, device=CPU)
    am, fm, _ = op.init_state(C)
    x = torch.zeros((C, B), dtype=torch.complex64)
    f = torch.zeros((C, B))
    return [
        (TypeError, op, am, fm, x.to(torch.complex128), None),
        (TypeError, op, am, fm, x.real.contiguous(), None),
        (ValueError, op, am, fm, x[0], None),                  # rank 1
        (ValueError, op, am, fm, torch.zeros((C, 0),
                                             dtype=torch.complex64), None),
        (ValueError, op, am, fm, x[None], None),               # rank 3
        (TypeError, dataclasses.replace(op, mode=op.mode.long()), am, fm,
         x, None),
        (ValueError, dataclasses.replace(op, mode=op.mode[:2]), am, fm, x,
         None),
        (TypeError, op, (am[0].double(), am[1]), fm, x, None),
        (ValueError, op, am, (fm[0][:2], fm[1]), x, None),
        (TypeError, op, am, (fm[0].real.contiguous(), fm[1]), x, None),
        (TypeError, op, am, fm, x, f.double()),
        (ValueError, op, am, fm, x, f[:2]),
        (TypeError, dataclasses.replace(
            op, ssb=demod.SSBDemod(op.ssb.gain.double())), am, fm, x, None),
        (ValueError, dataclasses.replace(
            op, ssb=demod.SSBDemod(op.ssb.gain[None])), am, fm, x, None),
    ]


@pytest.mark.parametrize("case", range(14))
def test_checks(case):
    calls = _bad_calls()
    assert len(calls) == 14
    exc, op, am, fm, x, a_ext = calls[case]
    with pytest.raises(exc):
        demod.check(op, am, fm, x, a_ext)


def test_checks_pass_strided_rows():
    """Rows a slice of a wider block, time-major samples, the state the
    plain route's strided views: accepted, (C, B) returned (the wrapper
    copies samples that are not contiguous)."""
    op = demod.MixedDemod.create(CYCLING, FS, 8, device=CPU)
    wide = torch.from_numpy(signal(np.random.default_rng(3), 8, 300, 0))
    (am, fm, _), _ = op.plain(op.init_state(8), wide)
    assert am[0].stride(0) != 1 and fm[0].stride(0) != 1
    assert demod.check(op, am, fm, wide[:, 10:210], None) == (8, 200)
    assert demod.check(op, am, fm, wide.T.contiguous().T, None) == (8, 300)
    assert demod.check(op, am, fm, wide[:, 10:210],
                       torch.zeros((8, 200))) == (8, 200)


def test_cpu_tensor_has_no_kernel():
    op = demod.MixedDemod.create(CYCLING, FS, 8, device=CPU)
    am, fm, _ = op.init_state(8)
    n0 = demod.mixed_demod.launches
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        demod.mixed_demod(op, am, fm, torch.zeros((8, 64),
                                                  dtype=torch.complex64))
    assert demod.mixed_demod.launches == n0


def test_meta_tensor_raises():
    """A device that is neither the CPU nor a card raises: the torch ops,
    which would run on it, are not a fallback."""
    op = demod.MixedDemod.create(CYCLING, FS, 8, device="meta")
    st = op.init_state(8)
    n0 = demod.mixed_demod.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        op(st, torch.zeros((8, 64), dtype=torch.complex64, device="meta"))
    assert demod.mixed_demod.launches == n0
