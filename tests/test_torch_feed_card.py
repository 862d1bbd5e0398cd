"""The receivers' steps and DeviceFeed (quisk_tpu_torch/io/feed.py) on a
card: no step waits on the card, and the feed alone bounds how far the
host runs ahead of it: a step is launched once the one before has
finished.  Without a
card every test here skips; on one, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_feed_card.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
does not need.)  Imports neither JAX nor the JAX package.

Each step is called once before it is checked: the first call builds the
kernels, and the PFB's demod reads its stage-2 basis to the host once to
check its form; what is checked is every call after that."""

import pytest
import torch

from quisk_tpu_torch.io.feed import DeviceFeed
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops.channelizer import PFBRxPipeline
from quisk_tpu_torch.rx.chain import RxChain, RxChainConfig

pytestmark = pytest.mark.card
MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]


@pytest.fixture
def dev():
    """The card, decided when a test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tunes(fs: float, C: int) -> list:
    """The rx cells' dials: -fs/4 + (c + 1/2) fs / (2 C)."""
    return [-fs / 4 + (c + 0.5) * fs / (2 * C) for c in range(C)]


def flagship(dev, C: int = 128):
    """The rx960k cells' plan at C = 128: (step, state, block)."""
    ch = RxChain.create(
        RxChainConfig(sample_rate=960e3, channels=C, audio_block=2048,
                      agc=True, fused_frontend=True),
        tune_hz=_tunes(960e3, C), mode=[MODES[c % 4] for c in range(C)],
        device=dev)
    return ch.step, ch.init_state(), _noise((C, ch.block_in), dev)


def nfm(dev, C: int = 128):
    """The pllnfm192k cell's plan (PLL FM, CTCSS notch, RF squelch)."""
    ch = RxChain.create(
        RxChainConfig(sample_rate=192e3, channels=C, audio_block=2048,
                      agc=True, fused_frontend=True, ext_demod="pll_fm",
                      fm_deviation_hz=5000.0, ctcss_hz=100.0,
                      fm_squelch=True, fm_squelch_db=-2.0),
        tune_hz=_tunes(192e3, C), mode=[int(Mode.EXT)] * C, device=dev)
    return ch.step, ch.init_state(), _noise((C, ch.block_in), dev)


def pfb(dev, K: int = 4096):
    """The pfb4096 cell's pipeline (kernels #4 and #6) at 2^20 samples."""
    pipe = PFBRxPipeline.create(
        K, K * 256, [MODES[4 * c // K] for c in range(K)],
        channel_rate=96000.0, pallas_poly=True, pallas_demod=True,
        device=dev)
    return pipe, pipe.init_state(1), _noise((1, K * 256), dev)


def _noise(shape, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(23)
    return torch.randn(shape, dtype=torch.complex64, device=dev,
                       generator=g)


@pytest.mark.parametrize("make", [flagship, nfm, pfb],
                         ids=["flagship", "nfm", "pfb"])
def test_step_waits_on_nothing(dev, make):
    """A step raises nothing under ``set_sync_debug_mode("error")``: no
    upload from pageable memory, no read back, no stream sync."""
    step, state, x = make(dev)
    state, _ = step(state, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            state, y = step(state, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = y[0] if isinstance(y, tuple) else y
    assert bool(torch.isfinite(out).all())


def _spin(state, x):
    """A step that keeps the card busy ~10 ms and never waits on it."""
    torch.cuda._sleep(20_000_000)
    return state, x


@pytest.mark.parametrize("prefetch", [0, 1])
@pytest.mark.parametrize("which", ["spin", "flagship"])
def test_feed_launches_a_step_once_the_last_finished(dev, which, prefetch):
    """When the feed calls the step of block N, block N-1's has finished
    on the card, and after each push every step but the newest has.
    Resident blocks with ``prefetch=0`` (the resident cells), pinned host
    blocks with ``prefetch=1`` (the fed cells)."""
    if which == "spin":
        inner, state, x = _spin, None, torch.zeros(1, device=dev)
    else:
        inner, state, x = flagship(dev)
        state, _ = inner(state, x)
    if prefetch:
        x = x.cpu().pin_memory()
    done = []

    def stepf(state, x):
        assert all(ev.query() for ev in done)
        state, y = inner(state, x)
        ev = torch.cuda.Event()
        ev.record()
        done.append(ev)
        return state, y

    feed = DeviceFeed(stepf, state, prefetch=prefetch, device=dev)
    for _ in range(6):
        feed.push(x)
        assert all(ev.query() for ev in done[:-1])
    feed.flush()
    assert len(done) == 6
    torch.cuda.synchronize()
