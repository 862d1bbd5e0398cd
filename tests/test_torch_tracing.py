"""The port's spans (quisk_tpu_torch/utils/profiling.py) on the CPU: with
no profiler a span is one shared null context and the receive paths give
the same outputs, bit for bit, as under a profiler; under a profiler each
step emits its stages' ``quisk.*`` ranges once each, nested inside its
``*.step`` range and in stage order, a stage that is absent emits none,
and every name emitted is in ``SPANS`` (the transmit chain's own cases
are in test_torch_tx_spans.py)."""

import numpy as np
import pytest
import torch

from quisk_tpu_torch.io.feed import DeviceFeed
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops.channelizer import PFBRxPipeline
from quisk_tpu_torch.rx import RxChain, RxChainConfig
from quisk_tpu_torch.tx import TxChain, TxChainConfig
from quisk_tpu_torch.utils.profiling import NULL_SPAN, PREFIX, SPANS, span

MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]
FEATURED = dict(noise_blanker=2, auto_notch=True, nr=True, anf=True,
                squelch=True, fm_squelch=True)


def _chain(**kw):
    """The flagship plan (fused front, OLS filter, mixed demod, AGC) at
    C=8, or with ``kw`` added to its configuration."""
    cfg = dict(sample_rate=960e3, channels=8, audio_block=256, agc=True,
               fused_frontend=True)
    cfg.update(kw)
    C = cfg["channels"]
    return RxChain.create(RxChainConfig(**cfg),
                          tune_hz=[-90e3 + 20e3 * c for c in range(C)],
                          mode=[MODES[c % 4] for c in range(C)],
                          device="cpu")


def _iq(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    return torch.as_tensor(x.astype(np.complex64))


def _pipe(kernels: bool, **kw):
    return PFBRxPipeline.create(256, 16384, [MODES[c % 4] for c in range(256)],
                                channel_rate=2 * 1.536e6 / 256,
                                pallas_poly=kernels, pallas_demod=kernels,
                                device="cpu", **kw)


def _profiled(fn):
    """fn()'s result and the ``quisk.*`` ranges it emitted, as sorted
    [(start, end, name)] with the prefix taken off."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    spans = sorted((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):])
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(PREFIX))
    return out, spans


def _equal(a, b):
    """Bit-equal nested tuples / dicts / tensors."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.contiguous().numpy().tobytes()
                == b.contiguous().numpy().tobytes())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def _assert_nested(spans, step, stages):
    """One ``step`` range holding each of ``stages`` once, in this order."""
    names = [n for _, _, n in spans]
    assert names.count(step) == 1
    s0, s1 = next((a, b) for a, b, n in spans if n == step)
    inner = [(a, b, n) for a, b, n in spans if n != step]
    assert [n for _, _, n in inner] == stages
    assert all(s0 <= a <= b <= s1 for a, b, _ in inner)
    assert all(b0 <= a1 for (_, b0, _), (a1, _, _) in zip(inner, inner[1:]))


def test_span_off_is_the_shared_null_context():
    assert not torch._C._autograd._profiler_enabled()
    for name in SPANS:
        assert span(name) is NULL_SPAN
    with span("rx.step"), span("rx.step"):   # reentrant, nothing recorded
        pass


def test_span_on_records_a_prefixed_range():
    def enter_all():
        for name in SPANS:
            with span(name):
                pass

    _, spans = _profiled(enter_all)
    assert [n for _, _, n in spans] == list(SPANS)
    assert len(set(SPANS)) == len(SPANS)


def test_rx_step_same_with_and_without_profiler():
    ch = _chain()
    x = _iq((ch.channels, ch.block_in))
    ref = ch.step(ch.init_state(), x)
    got, spans = _profiled(lambda: ch.step(ch.init_state(), x))
    assert spans and _equal(ref, got)


@pytest.mark.parametrize("kernels", [False, True], ids=["torch_ops",
                                                         "kernel_route"])
def test_pfb_same_with_and_without_profiler(kernels):
    pipe = _pipe(kernels)
    x = _iq((1, 16384), seed=1)
    ref = pipe(pipe.init_state(1), x)
    got, spans = _profiled(lambda: pipe(pipe.init_state(1), x))
    assert spans and _equal(ref, got)


def test_feed_same_with_and_without_profiler():
    ch = _chain()
    blocks = [_iq((ch.channels, ch.block_in), seed=s).numpy()
              for s in range(3)]

    def run():
        feed = DeviceFeed(ch.step, ch.init_state(), prefetch=1, device="cpu")
        outs = [y for b in blocks for y in feed.push(b)] + feed.flush()
        return outs, feed.state

    ref = run()
    got, spans = _profiled(run)
    assert _equal(ref, got)
    # three blocks, three steps; on the CPU the feed copies nothing
    assert [n for _, _, n in spans].count("rx.step") == 3
    assert not [n for _, _, n in spans if n.startswith("feed.")]


def test_rx_step_spans_nested_in_stage_order():
    ch = _chain()
    _, spans = _profiled(lambda: ch.step(ch.init_state(),
                                         _iq((ch.channels, ch.block_in))))
    _assert_nested(spans, "rx.step",
                   ["rx.front", "rx.filter", "rx.demod", "rx.agc"])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_featured_step_spans_every_audio_processor(fused):
    ch = _chain(sample_rate=192e3, channels=4, audio_block=512,
                fused_frontend=fused, **FEATURED)
    _, spans = _profiled(lambda: ch.step(ch.init_state(),
                                         _iq((ch.channels, ch.block_in))))
    _assert_nested(spans, "rx.step",
                   ["rx.front", "rx.filter", "rx.demod", "rx.notch",
                    "rx.anf", "rx.nr", "rx.agc", "rx.squelch", "rx.fm_sq"])


def test_absent_stages_emit_no_span():
    ch = _chain(agc=False)
    _, spans = _profiled(lambda: ch.step(ch.init_state(),
                                         _iq((ch.channels, ch.block_in))))
    _assert_nested(spans, "rx.step", ["rx.front", "rx.filter", "rx.demod"])
    for kernels in (False, True):
        pipe = _pipe(kernels, with_spectrum=False)
        _, spans = _profiled(lambda: pipe(pipe.init_state(1),
                                          _iq((1, 16384))))
        assert "pfb.power" not in [n for _, _, n in spans]


@pytest.mark.parametrize("kernels,stages", [
    (False, ["pfb.poly", "pfb.dft", "pfb.demod", "pfb.power"]),
    (True, ["pfb.poly", "pfb.stage1", "pfb.demod", "pfb.power"])],
    ids=["torch_ops", "kernel_route"])
def test_pfb_spans_nested_in_stage_order(kernels, stages):
    pipe = _pipe(kernels)
    _, spans = _profiled(lambda: pipe(pipe.init_state(1), _iq((1, 16384))))
    _assert_nested(spans, "pfb.step", stages)


class _DoneEvent:
    """Stands in for the CUDA event of the copy that last read a ring
    buffer."""

    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_feed_staging_spans():
    """The pinned ring's wait and the staging memcpy, driven on the CPU
    through a ring whose buffer is already there (pinning needs a card)."""
    feed = DeviceFeed(lambda s, x: (s, x), None, device="cpu")
    x = _iq((2, 64)).numpy()
    ev = _DoneEvent()
    feed._ring, feed._ring_ev, feed._slot = [torch.empty(x.shape,
                                                         dtype=torch.complex64)
                                             ], [ev], 0
    buf, spans = _profiled(lambda: feed._stage(x))
    assert ev.waited == 1 and feed._ring_ev == [None]
    assert torch.equal(buf, torch.as_tensor(x))
    assert feed.staged_bytes == x.nbytes
    assert [n for _, _, n in spans] == ["feed.ring_wait", "feed.stage"]


def test_every_emitted_name_is_listed():
    emitted = set()
    ch = _chain(sample_rate=192e3, channels=4, audio_block=512, **FEATURED)
    pll = _chain(sample_rate=192e3, channels=4, audio_block=512,
                 ext_demod="pll_fm", ctcss_hz=100.0)
    # the transmit chain with every stage it can have
    tx = TxChain.create(TxChainConfig(
        channels=4, tx_rate=96000.0, audio_block=256, compress_db=6.0,
        preemphasis=0.3, cessb=True, predistort=True, phase_rotator=True),
        mode=MODES, device="cpu")
    mic = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (4, 256)).astype(np.float32))
    for fn in (lambda: ch.step(ch.init_state(),
                               _iq((ch.channels, ch.block_in))),
               lambda: tx.step(tx.init_state(), mic),
               lambda: pll.step(pll.init_state(),
                                _iq((pll.channels, pll.block_in))),
               lambda: _pipe(False)(_pipe(False).init_state(1),
                                    _iq((1, 16384))),
               lambda: _pipe(True)(_pipe(True).init_state(1),
                                   _iq((1, 16384)))):
        _, spans = _profiled(fn)
        emitted |= {n for _, _, n in spans}
    assert emitted <= set(SPANS)
    # all but the feed's, which copy on the card only
    assert set(SPANS) - emitted == {"feed.copy", "feed.stage",
                                    "feed.ring_wait", "feed.step_wait"}
