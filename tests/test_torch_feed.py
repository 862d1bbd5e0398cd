"""The port's DeviceFeed (quisk_tpu_torch/io/feed.py) against the serial
loop and the JAX package's DeviceFeed: the same outputs, in input order,
and the same state, for prefetch 0, 1 and 2, from numpy and tensor input
(after tests/test_pump.py::test_device_feed_matches_serial_loop).  On the
CPU the feed copies nothing; its pinned ring and copy stream run on the
card only (chip_smoke.py phase A)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quisk_tpu.io.feed import DeviceFeed as JDeviceFeed

from quisk_tpu_torch.io.feed import DeviceFeed
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.rx import RxChain, RxChainConfig


def _step(state, x):
    s = state + torch.sum(x)
    return s, x * 2.0 + s


def _blocks(n=5):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((4, 64)).astype(np.float32)
            for _ in range(n)]


def _serial(blocks):
    st = torch.tensor(0.0)
    outs = []
    for b in blocks:
        st, y = _step(st, torch.as_tensor(b))
        outs.append(y)
    return st, outs


@pytest.mark.parametrize("as_tensor", [False, True],
                         ids=["numpy", "tensor"])
@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_feed_matches_serial_loop(prefetch, as_tensor):
    blocks = _blocks()
    st_ref, ref = _serial(blocks)
    feed = DeviceFeed(_step, torch.tensor(0.0), prefetch=prefetch,
                      device="cpu")
    outs = []
    for b in blocks:
        outs += feed.push(torch.as_tensor(b) if as_tensor else b)
    outs += feed.flush()
    assert len(outs) == len(ref)
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)
    assert torch.equal(feed.state, st_ref)
    assert feed.staged_bytes == 0          # nothing staged off the card


@pytest.mark.parametrize("prefetch", [0, 1, 2])
def test_feed_equals_the_jax_feed(prefetch):
    @jax.jit
    def jstep(state, x):
        s = state + jnp.sum(x)
        return s, x * 2.0 + s

    blocks = _blocks()
    jfeed = JDeviceFeed(jstep, jnp.float32(0.0), prefetch=prefetch)
    feed = DeviceFeed(_step, torch.tensor(0.0), prefetch=prefetch,
                      device="cpu")
    jouts, outs = [], []
    for b in blocks:
        jouts += jfeed.push(b)
        outs += feed.push(b)
        assert len(outs) == len(jouts)     # the same outputs become due
    jouts += jfeed.flush()
    outs += feed.flush()
    # float32 sums of 256 values in two summation orders
    for a, b in zip(outs, jouts):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-5)
    np.testing.assert_allclose(float(feed.state), float(jfeed.state),
                               rtol=1e-6, atol=1e-5)


def test_flush_returns_the_blocks_in_flight_in_order():
    blocks = _blocks(6)
    feed = DeviceFeed(lambda s, x: (s + 1, (s, x)), 0, prefetch=2,
                      device="cpu")
    due = [feed.push(b) for b in blocks]
    assert [len(d) for d in due] == [0, 0, 1, 1, 1, 1]
    tail = feed.flush()
    assert len(tail) == 2 and feed.flush() == []
    outs = [o for d in due for o in d] + tail
    assert [s for s, _ in outs] == list(range(6))
    for (_, x), b in zip(outs, blocks):
        assert np.array_equal(x.numpy(), b)
    assert feed.state == 6


def test_feed_drives_a_receive_chain_as_its_step():
    cfg = RxChainConfig(sample_rate=48000.0, channels=2, audio_block=512,
                        agc=True)
    chain = RxChain.create(cfg, tune_hz=[1000.0, -2000.0],
                           mode=[int(Mode.USB), int(Mode.AM)], device="cpu")
    rng = np.random.default_rng(3)
    B = chain.block_in
    blocks = [(rng.standard_normal((2, B)) + 1j * rng.standard_normal(
        (2, B))).astype(np.complex64) for _ in range(4)]
    st = chain.init_state()
    ref = []
    for b in blocks:
        st, a = chain.step(st, torch.as_tensor(b))
        ref.append(a)
    feed = DeviceFeed(chain.step, chain.init_state(), prefetch=1,
                      device="cpu")
    outs = []
    for b in blocks:
        outs += feed.push(b)
    outs += feed.flush()
    for a, b in zip(outs, ref):
        assert torch.equal(a, b)


def test_feed_rejects_a_negative_prefetch():
    with pytest.raises(ValueError):
        DeviceFeed(_step, 0, prefetch=-1, device="cpu")


def test_feed_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceFeed(_step, 0)
