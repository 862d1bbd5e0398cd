"""The transmit chain's last stage (``TxChain.place``: Spot, the TX tune NCO
and the I/Q trim) on the CPU: the uint32 phase arithmetic and the angle's
rounding that the card's kernel (``csrc/tx_place.cu``) relies on, modelled
in numpy against ``NCO.phasor``; the kernel's per-sample arithmetic against
``place_plain``; the CPU route; and the checks of the wrapper
(``ops/nco.py`` ``tx_place``).  The kernel itself is held to the plain
route on a card by tests/test_torch_tx_place_card.py."""

import dataclasses

import numpy as np
import pytest
import torch

from quisk_tpu_torch.ops import nco
from quisk_tpu_torch.ops.nco import NCO, TWO_PI_OVER_2_32, phase_tensor
from quisk_tpu_torch.tx import TxChain, TxChainConfig

CPU = "cpu"
WRAP = 2 ** 32
WORDS = [0, 1, 2 ** 31, WRAP - 1, WRAP - 2 ** 20 - 7, 123_456_789]
PHASES = [WRAP - 1, WRAP - 2, WRAP - 4097, 0, 2 ** 31 - 1, WRAP - 3]


def model_phase(phase: np.ndarray, word: np.ndarray, N: int):
    """The kernel's phase arithmetic in numpy uint32, which wraps mod 2^32
    as the card's does: (p [C, N], next phase [C])."""
    n = np.arange(N, dtype=np.uint32)
    p = phase[:, None] + word[:, None] * n[None, :]
    nxt = phase + word * np.full_like(word, N)
    return p, nxt


def model_angle(p: np.ndarray) -> np.ndarray:
    """The kernel's angle: the unsigned phase rounded to float32, times the
    float32 constant, the product rounded once."""
    return p.astype(np.float32) * np.float32(TWO_PI_OVER_2_32)


@pytest.mark.parametrize("N", [4096, 4094, 1])
def test_uint32_model_is_phasor(N):
    """Three chained blocks: the model's per-sample phase is the exact
    (phase + word n) mod 2^32, its next phase is ``NCO.phasor``'s int64
    masked one bit for bit, and its angle through torch's cos and sin is
    ``phasor``'s rotation bit for bit.  Words 0, 1, 2^31 and 2^32 - 1,
    phases just under the wrap."""
    word = np.array(WORDS, np.uint32)
    op = NCO(word=phase_tensor(word, CPU), block=N)
    ph_t = phase_tensor(np.array(PHASES, np.uint32), CPU)
    ph_m = np.array(PHASES, np.uint32)
    exact = np.array(PHASES, object)
    for _ in range(3):
        p, nxt_m = model_phase(ph_m, word, N)
        want = [[(int(exact[c]) + int(w) * n) % WRAP for n in range(N)]
                for c, w in enumerate(WORDS)]
        assert np.array_equal(p.astype(np.int64), np.array(want, np.int64))
        nxt_t, z = op.phasor(ph_t)
        assert nxt_t.dtype == torch.int64
        assert np.array_equal(nxt_t.numpy(), nxt_m.astype(np.int64))
        ang = torch.from_numpy(model_angle(p))
        assert torch.equal(z, torch.complex(torch.cos(ang), torch.sin(ang)))
        exact = [(int(e) + int(w) * N) % WRAP for e, w in zip(exact, WORDS)]
        ph_t, ph_m = nxt_t, nxt_m


def chain(C: int, N: int, spot_rows=(), trim_rows=()) -> TxChain:
    """A chain whose ``place`` takes [C, N] blocks, rows c tuned by
    ``WORDS[c % 6]``, Spot on ``spot_rows`` and a trim on ``trim_rows``."""
    tx = TxChain.create(TxChainConfig(channels=C, audio_block=256),
                        device=CPU)
    words = np.array([WORDS[c % len(WORDS)] for c in range(C)], np.uint32)
    tx = dataclasses.replace(tx, tune=NCO(word=phase_tensor(words, CPU),
                                          block=N))
    for r in spot_rows:
        tx = tx.set_spot(0.25 + 0.1 * r, channel=r)
    for r in trim_rows:
        tx = tx.set_ampl_phase(1.0 + 0.01 * r, 2.0 - r, channel=r)
    return tx


def iq_block(rng, C: int, N: int) -> torch.Tensor:
    x = rng.standard_normal((C, N)) + 1j * rng.standard_normal((C, N))
    return torch.from_numpy((0.5 * x).astype(np.complex64))


def model_place(tx: TxChain, phase: np.ndarray, iq: np.ndarray):
    """The kernel's per-sample arithmetic in numpy float32, each product
    and sum rounded alone: (next phase, out)."""
    C, N = iq.shape
    word = tx.tune.word.numpy().astype(np.uint32)
    p, nxt = model_phase(phase.astype(np.uint32), word, N)
    ang = torch.from_numpy(model_angle(p))
    co, s = torch.cos(ang).numpy(), torch.sin(ang).numpy()
    sp = tx.spot.numpy()
    on = sp >= 0
    xr = np.where(on, sp, iq.real).astype(np.float32)
    xi = np.where(on, np.float32(0), iq.imag).astype(np.float32)
    yr = xr * co - xi * s
    yi = xr * s + xi * co
    m00, m10, m11 = (t.numpy() for t in tx.trim)
    out = np.empty((C, N), np.complex64)
    out.real, out.imag = m00 * yr, m10 * yr + m11 * yi
    return nxt.astype(np.int64), out


@pytest.mark.parametrize("C,N", [(6, 4096), (7, 4094), (5, 1)])
def test_kernel_model_is_plain(C, N):
    """Four chained blocks: the model's next phase is ``place_plain``'s bit
    for bit, its output within 1e-6 of each row's peak (the card test's
    bound)."""
    tx = chain(C, N, spot_rows=(1,), trim_rows=(2, C - 1))
    rng = np.random.default_rng(40 + N)
    st = {"tune_phase": phase_tensor(
        np.array([PHASES[c % len(PHASES)] for c in range(C)], np.uint32),
        CPU)}
    ph = st["tune_phase"].numpy()
    for _ in range(4):
        iq = iq_block(rng, C, N)
        ref = tx.place_plain(st, iq).numpy()
        ph, out = model_place(tx, ph, iq.numpy())
        assert np.array_equal(ph, st["tune_phase"].numpy())
        peak = np.abs(ref).max(-1, keepdims=True)
        assert np.all(np.abs(out - ref) <= 1e-6 * peak)


def test_place_is_plain_on_cpu():
    """On CPU tensors ``place`` is ``place_plain`` bit for bit, the tune
    phase too, over three chained blocks; no kernel is launched."""
    C, N = 6, 512
    tx = chain(C, N, spot_rows=(0, 3), trim_rows=(1, 3))
    rng = np.random.default_rng(7)
    st_a = {"tune_phase": phase_tensor(np.array(PHASES, np.uint32), CPU)}
    st_b = dict(st_a)
    n0 = nco.tx_place.launches
    for _ in range(3):
        iq = iq_block(rng, C, N)
        a, b = tx.place(st_a, iq), tx.place_plain(st_b, iq)
        assert torch.equal(a, b)
        assert torch.equal(st_a["tune_phase"], st_b["tune_phase"])
    assert nco.tx_place.launches == n0


def test_step_runs_place_plain_on_cpu():
    """A whole ``TxChain.step`` on the CPU ends in ``place_plain``: the step
    equals its stages run by hand."""
    C = 3
    tx = TxChain.create(TxChainConfig(channels=C, audio_block=256,
                                      tx_rate=96000.0), device=CPU)
    tx = tx.set_tune(np.array([-1500.0, 0.0, 2400.0])).set_spot(0.5,
                                                                 channel=1)
    audio = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (C, 256)).astype(np.float32) * 0.1)
    st0 = tx.init_state()
    st, iq = tx.step(st0, audio)
    st2, iq2 = tx.pre_alc(st0, audio)
    st2["alc"], iq2 = tx.alc(st2["alc"], iq2)
    iq2 = tx.place_plain(st2, tx.post_alc(st2, iq2))
    assert torch.equal(iq, iq2)
    assert torch.equal(st["tune_phase"], st2["tune_phase"])


# ------------------------------------------------------------- the checks
def _bad_calls():
    C, N = 3, 64
    tx = chain(C, N)
    iq = torch.zeros((C, N), dtype=torch.complex64)
    ph = torch.zeros((C,), dtype=torch.int64)
    w, spot, trim = tx.tune.word, tx.spot, tx.trim
    m00, m10, m11 = trim
    wide = torch.zeros((C, 2 * N), dtype=torch.complex64)
    return [
        (TypeError, iq.to(torch.complex128), spot, w, ph, trim),
        (TypeError, iq, spot.double(), w, ph, trim),
        (TypeError, iq, spot, w.to(torch.int32), ph, trim),
        (TypeError, iq, spot, w, ph.to(torch.int32), trim),
        (TypeError, iq, spot, w, ph, (m00.double(), m10, m11)),
        (ValueError, wide[:, ::2], spot, w, ph, trim),        # strided
        (ValueError, iq.t().contiguous().t(), spot, w, ph, trim),
        (ValueError, iq[0], spot, w, ph, trim),               # rank 1
        (ValueError, torch.zeros((C, 0), dtype=torch.complex64), spot, w,
         ph, trim),                                           # no samples
        (ValueError, iq, spot[:2], w, ph, trim),              # rows
        (ValueError, iq, spot, w[:2], ph, trim),
        (ValueError, iq, spot, w, torch.zeros((C + 1,), dtype=torch.int64),
         trim),
        (ValueError, iq, spot, w, ph, (m00, m10[:, 0], m11)),  # [C] not [C, 1]
    ]


@pytest.mark.parametrize("case", range(13))
def test_checks(case):
    """The wrapper refuses a wrong dtype and a non-contiguous or wrongly
    shaped tensor; nothing is launched."""
    calls = _bad_calls()
    assert len(calls) == 13
    exc, *args = calls[case]
    n0 = nco.tx_place.launches
    with pytest.raises(exc):
        nco.tx_place(*args)
    assert nco.tx_place.launches == n0


def test_cpu_refused():
    """A CPU tensor that passes every check is refused: the torch ops are
    not the wrapper's fallback."""
    tx = chain(2, 16)
    iq = torch.zeros((2, 16), dtype=torch.complex64)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        nco.tx_place(iq, tx.spot, tx.tune.word,
                     torch.zeros((2,), dtype=torch.int64), tx.trim)


def test_meta_tensor_raises():
    """A device that is neither the CPU nor a card raises in ``place``."""
    tx = chain(2, 16)
    meta = dataclasses.replace(
        tx, spot=tx.spot.to("meta"), trim=tuple(t.to("meta") for t in tx.trim),
        tune=NCO(word=tx.tune.word.to("meta"), block=16))
    st = {"tune_phase": torch.zeros((2,), dtype=torch.int64, device="meta")}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        meta.place(st, torch.zeros((2, 16), dtype=torch.complex64,
                                   device="meta"))
