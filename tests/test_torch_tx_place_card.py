"""The transmit chain's place kernel (``csrc/tx_place.cu``, ops/nco.py
``tx_place``) on a card, held to the plain route (``TxChain.place_plain``,
the torch ops on the card).  Without a card every test here skips; on one,
from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_tx_place_card.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not need.)  Imports neither JAX nor the JAX package.

Each route carries its own tune phase over four chained blocks.  The next
phase must be the plain route's bit for bit (the same uint32 arithmetic);
the output must lie within 1e-6 of each row's peak magnitude (>= 120 dB a
row: the angle is the plain route's bits, so only the last rounding of
sincosf, of the complex product and of the trim can differ)."""

import dataclasses

import numpy as np
import pytest
import torch

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import nco
from quisk_tpu_torch.ops.nco import NCO, phase_tensor
from quisk_tpu_torch.tx import TxChain, TxChainConfig

pytestmark = pytest.mark.card
REL = 1e-6
EDGE_WORDS = [0, 2 ** 32 - 1, 2 ** 32 - 12_345, 1, 2 ** 31, 0]


@pytest.fixture
def dev():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def chain(C: int, N: int, dev, rng) -> TxChain:
    """A chain whose ``place`` takes [C, N] blocks: words 0 and near 2^32
    on the first rows, the rest drawn; Spot on every fifth row from row 1,
    a trim on every third row from row 2 (rows 11, 26, .. take both)."""
    tx = TxChain.create(TxChainConfig(channels=C, audio_block=256),
                        device=dev)
    words = rng.integers(0, 2 ** 32, C, dtype=np.uint64)
    words[:min(C, len(EDGE_WORDS))] = EDGE_WORDS[:C]
    tx = dataclasses.replace(tx, tune=NCO(word=phase_tensor(words, dev),
                                          block=N))
    spot = torch.where(torch.arange(C, device=dev)[:, None] % 5 == 1,
                       0.6, tx.spot)
    trim = tuple(t.clone() for t in tx.trim)
    rows = torch.arange(C, device=dev)
    rows = rows[rows % 3 == 2]
    trim[0][rows], trim[1][rows], trim[2][rows] = 1.03, -0.052, 0.9986
    return dataclasses.replace(tx, spot=spot, trim=trim)


def iq_block(rng, C: int, N: int, dev) -> torch.Tensor:
    x = rng.standard_normal((C, N)) + 1j * rng.standard_normal((C, N))
    return torch.as_tensor((0.5 * x).astype(np.complex64), device=dev)


def assert_close_rows(ref: torch.Tensor, got: torch.Tensor) -> None:
    peak = ref.abs().amax(-1, keepdim=True)
    err = (got - ref).abs()
    assert bool((err <= REL * peak).all()), float((err / peak).max())


@pytest.mark.parametrize("C,N", [(8192, 4096), (1, 4096), (7, 4094)])
def test_kernel_matches_plain(dev, C, N):
    """Four chained blocks, one launch each; phases start just under the
    wrap."""
    rng = np.random.default_rng(C + N)
    tx = chain(C, N, dev, rng)
    ph0 = phase_tensor(2 ** 32 - 1 - np.arange(C) % 4096, dev)
    st_k, st_p = {"tune_phase": ph0}, {"tune_phase": ph0.clone()}
    n0 = nco.tx_place.launches
    for _ in range(4):
        iq = iq_block(rng, C, N, dev)
        got = tx.place(st_k, iq)
        ref = tx.place_plain(st_p, iq)
        assert got.dtype == torch.complex64 and got.shape == (C, N)
        assert torch.equal(st_k["tune_phase"], st_p["tune_phase"])
        assert_close_rows(ref, got)
    torch.cuda.synchronize()
    assert nco.tx_place.launches == n0 + 4


def test_step_matches_plain_route(dev):
    """A whole ``TxChain.step`` at the cell's rates (48 kHz mic to 96 kS/s,
    modes cycling USB / LSB / AM / FM / DGT_U, a tune a row, Spot and a
    trim on one row each) against the same stages ending in
    ``place_plain``, each side carrying its own state."""
    C, B = 40, 2048
    modes = [int(m) for m in (Mode.USB, Mode.LSB, Mode.AM, Mode.FM,
                              Mode.DGT_U)]
    tx = TxChain.create(TxChainConfig(channels=C, audio_block=B,
                                      tx_rate=96000.0, compress_db=6.0,
                                      preemphasis=0.3, ctcss_hz=100.0,
                                      fm_deviation_hz=5000.0),
                        mode=[modes[c % 5] for c in range(C)], device=dev)
    tx = tx.set_tune(-24000.0 + 1200.0 * np.arange(C))
    tx = tx.set_spot(0.5, channel=3).set_ampl_phase(1.02, 2.0, channel=4)
    rng = np.random.default_rng(5)
    st_k = st_p = tx.init_state()
    n0 = nco.tx_place.launches
    for _ in range(4):
        audio = torch.as_tensor(
            (0.2 * rng.standard_normal((C, B))).astype(np.float32),
            device=dev)
        st_k, got = tx.step(st_k, audio)
        st_p, iq = tx.pre_alc(st_p, audio)
        st_p["alc"], iq = tx.alc(st_p["alc"], iq)
        ref = tx.place_plain(st_p, tx.post_alc(st_p, iq))
        assert torch.equal(st_k["tune_phase"], st_p["tune_phase"])
        assert_close_rows(ref, got)
    torch.cuda.synchronize()
    assert nco.tx_place.launches == n0 + 4


def test_graph_replay(dev):
    """Captured in a CUDA graph, a replay gives the eager launch's bits."""
    C, N = 64, 4096
    rng = np.random.default_rng(9)
    tx = chain(C, N, dev, rng)
    iq = iq_block(rng, C, N, dev)
    ph = phase_tensor(rng.integers(0, 2 ** 32, C, dtype=np.uint64), dev)
    want_ph, want = nco.tx_place(iq, tx.spot, tx.tune.word, ph, tx.trim)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        nco.tx_place(iq, tx.spot, tx.tune.word, ph, tx.trim)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got_ph, got = nco.tx_place(iq, tx.spot, tx.tune.word, ph, tx.trim)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_ph, want_ph)
