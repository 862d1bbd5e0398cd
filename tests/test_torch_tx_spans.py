"""The transmit chain's spans (quisk_tpu_torch/utils/profiling.py) on the
CPU: under a profiler ``TxChain.step`` emits ``quisk.tx.step`` holding one
range for each stage it has, in stage order, each name in ``SPANS``; a
stage the chain lacks emits none; the step's outputs are the same, bit
for bit, with and without a profiler.  And ``TxChain.set_tune`` with a
``[C]`` array of offsets equals C calls of one channel each."""

import numpy as np
import pytest
import torch

from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.tx import TxChain, TxChainConfig
from quisk_tpu_torch.utils.profiling import PREFIX, SPANS

MODES = [int(m) for m in (Mode.USB, Mode.LSB, Mode.AM, Mode.FM,
                          Mode.DGT_U)]
STAGES = ["tx.condition", "tx.filter", "tx.modulate", "tx.alc", "tx.cessb",
          "tx.predist", "tx.interp", "tx.place"]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chain(C=5, **kw):
    cfg = dict(channels=C, audio_rate=48000.0, tx_rate=96000.0,
               audio_block=256, compress_db=6.0, preemphasis=0.3, alc=True,
               fm_deviation_hz=5000.0, ctcss_hz=100.0)
    cfg.update(kw)
    return TxChain.create(TxChainConfig(**cfg),
                          mode=[MODES[c % 5] for c in range(C)],
                          device="cpu")


def _mic(tx, seed=0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(0.5 * rng.standard_normal(
        (tx.channels, tx.block)).astype(np.float32))


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted((e.start_ns(), e.end_ns(), e.name()[len(PREFIX):])
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(PREFIX))
    return out, spans


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.contiguous().numpy().tobytes()
                == b.contiguous().numpy().tobytes())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


def _assert_nested(spans, stages):
    names = [n for _, _, n in spans]
    assert names.count("tx.step") == 1
    s0, s1 = next((a, b) for a, b, n in spans if n == "tx.step")
    inner = [(a, b, n) for a, b, n in spans if n != "tx.step"]
    assert [n for _, _, n in inner] == stages
    assert all(s0 <= a <= b <= s1 for a, b, _ in inner)
    assert all(b0 <= a1 for (_, b0, _), (a1, _, _) in zip(inner, inner[1:]))
    assert set(names) <= set(SPANS)


@pytest.mark.parametrize("kw,stages", [
    ({}, ["tx.condition", "tx.filter", "tx.modulate", "tx.alc", "tx.interp",
          "tx.place"]),
    ({"cessb": True, "predistort": True, "phase_rotator": True}, STAGES),
    ({"alc": False, "tx_rate": 48000.0},
     ["tx.condition", "tx.filter", "tx.modulate", "tx.place"])],
    ids=["cell", "every_stage", "no_alc_no_interp"])
def test_tx_step_spans_nested_in_stage_order(kw, stages):
    tx = _chain(**kw)
    _, spans = _profiled(lambda: tx.step(tx.init_state(), _mic(tx)))
    _assert_nested(spans, stages)


def test_tx_step_same_with_and_without_profiler():
    tx = _chain(cessb=True, predistort=True).set_tune(
        [-9000.0, -3000.0, 0.0, 3000.0, 9000.0])
    st = tx.init_state()
    ref, got = [], []
    for seed in range(3):       # the state carried over blocks too
        st, y = tx.step(st, _mic(tx, seed))
        ref.append((st, y))
    st = tx.init_state()
    for seed in range(3):
        (st, y), spans = _profiled(lambda: tx.step(st, _mic(tx, seed)))
        got.append((st, y))
        assert [n for _, _, n in spans].count("tx.step") == 1
    assert _equal(ref, got)


def test_set_tune_array_equals_one_channel_at_a_time():
    tx = _chain(C=7)
    off = np.array([-23997.0703125, -11.5, 0.0, 5.859375, 1234.5, 23997.0,
                    -0.25])
    each = tx
    for c, f in enumerate(off):
        each = each.set_tune(float(f), channel=c)
    whole = tx.set_tune(off)
    assert torch.equal(whole.tune.word, each.tune.word)
    assert whole.tune.word.dtype == torch.int64
    # one offset for every channel, as before
    assert torch.equal(tx.set_tune(700.0).tune.word,
                       tx.set_tune(np.full(7, 700.0)).tune.word)
    # the chains transmit the same I/Q
    st_w, y_w = whole.step(whole.init_state(), _mic(whole))
    st_e, y_e = each.step(each.init_state(), _mic(each))
    assert _equal(y_w, y_e) and _equal(st_w, st_e)
    # an array that is not one offset a channel is refused
    with pytest.raises(ValueError):
        tx.set_tune(off[:3])
