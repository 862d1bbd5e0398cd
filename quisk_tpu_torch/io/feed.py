"""Device feed: overlap the host->card copy of each block with compute.

A block of capture lives in host memory and must reach the card before the
step can read it.  Copied serially, the copy sits on the critical path
between steps.  :class:`DeviceFeed` keeps up to ``prefetch`` blocks in
flight ahead of compute: block N+1's copy runs on a copy stream of its own
while block N computes on the current stream.

A copy from host memory is asynchronous only from page-locked (pinned)
memory, so the feed copies from pinned buffers:

- a pinned CPU tensor that the caller passes is copied from as it is (the
  caller must not write it again until its output has come back);
- a numpy array or a pageable tensor is first staged, by a host memcpy,
  into a ring of ``prefetch + 1`` pinned buffers; a buffer is written
  again only after the event of the copy that last read it has completed;
- a tensor already on the card is stepped as it is;
- :meth:`DeviceFeed.push_into` lets a producer write the block straight
  into the ring's next pinned buffer (a pump's ``read_samples(n,
  out=buf)``), under the same guard and with no staging memcpy.

The step waits on each block's copy event before it reads the block, and
each device block is marked as used by the compute stream
(``record_stream``), so the allocator reuses its memory only after the
step is done with it.  Nothing falls back to a synchronous pageable copy:
where memory cannot be pinned, pinning raises.

Usage::

    feed = DeviceFeed(stepf, state, prefetch=1)
    for x in blocks:                 # host numpy or CPU tensors
        for y in feed.push(x):       # device outputs, un-synced
            consume(y)
    for y in feed.flush():
        consume(y)
    state = feed.state

    # or filled in place, e.g. from the native pump:
    outs = feed.push_into((1, n), torch.complex64,
                          lambda buf: hw.read_samples(n, out=buf))

On ``device="cpu"`` the blocks become CPU tensors and the same order of
steps runs with no copy.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device


class DeviceFeed:
    """Run ``(state, x) -> (state, y)`` over a stream of host blocks with up
    to ``prefetch`` host->card copies in flight ahead of compute.

    ``prefetch=0`` is the serial loop: copy a block, then step it.
    ``prefetch=1`` (default) double-buffers: one block's copy overlaps the
    step before it.  Outputs come back un-synced, in input order.
    ``staging_s`` and ``staged_bytes`` count the host memcpy into the
    pinned ring (numpy and pageable input only)."""

    def __init__(self, stepf, state, prefetch: int = 1, device=None):
        if prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {prefetch}")
        self.stepf = stepf
        self.state = state
        self.prefetch = int(prefetch)
        self.device = resolve_device(device)
        self._q: deque = deque()
        self.staging_s = 0.0
        self.staged_bytes = 0
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._ring: list = [None] * (self.prefetch + 1)
            self._ring_ev: list = [None] * (self.prefetch + 1)
            self._slot = 0

    def push(self, x_host) -> list:
        """Enqueue one host block; returns any outputs that became due."""
        self._q.append(self._put(x_host))
        outs = []
        while len(self._q) > self.prefetch:
            outs.append(self._run(*self._q.popleft()))
        return outs

    def push_into(self, shape, dtype, fill) -> list | None:
        """Enqueue one block that ``fill(buf)`` writes in place into a host
        buffer ``buf`` of ``shape`` and ``dtype``; returns any outputs that
        became due, or None when ``fill`` returned None (a starved source:
        nothing is enqueued and the buffer is taken again next call).

        On the card ``buf`` is the ring's next pinned buffer, handed out
        only after the event of the copy that last read it has completed,
        so a producer never writes a block still being copied; nothing is
        staged (``staged_bytes`` does not move).  On the CPU ``buf`` is a
        new tensor, stepped as it is."""
        buf = (self._ring_buffer(shape, dtype) if self.device.type == "cuda"
               else torch.empty(shape, dtype=dtype))
        if fill(buf) is None:
            return None
        self._q.append(self._put(buf))
        outs = []
        while len(self._q) > self.prefetch:
            outs.append(self._run(*self._q.popleft()))
        return outs

    def flush(self) -> list:
        """Drain the in-flight blocks; returns their outputs."""
        outs = []
        while self._q:
            outs.append(self._run(*self._q.popleft()))
        return outs

    # ------------------------------------------------------------ internals
    def _run(self, x, ev):
        if ev is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev)
            x.record_stream(stream)
        self.state, y = self.stepf(self.state, x)
        return y

    def _put(self, x_host):
        if self.device.type != "cuda":
            return torch.as_tensor(x_host), None
        src = x_host if isinstance(x_host, torch.Tensor) else None
        if src is not None and src.device.type == "cuda":
            return src, None                 # already on the card
        if src is None or not src.is_pinned():
            src = self._stage(x_host)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dev.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        if src is self._ring[self._slot]:
            self._ring_ev[self._slot] = ev
            self._slot = (self._slot + 1) % len(self._ring)
        return dev, ev

    def _stage(self, x_host) -> torch.Tensor:
        """Copy a numpy array or pageable tensor into the next pinned
        buffer of the ring, once the copy that last read it is done."""
        x = (x_host if isinstance(x_host, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(x_host)))
        buf = self._ring_buffer(x.shape, x.dtype)
        t0 = time.perf_counter()
        buf.copy_(x)
        self.staging_s += time.perf_counter() - t0
        self.staged_bytes += x.numel() * x.element_size()
        return buf

    def _ring_buffer(self, shape, dtype) -> torch.Tensor:
        """The ring's next pinned buffer, of ``shape`` and ``dtype``, once
        the copy that last read it is done."""
        i = self._slot
        if self._ring_ev[i] is not None:
            self._ring_ev[i].synchronize()
            self._ring_ev[i] = None
        buf = self._ring[i]
        if buf is None or buf.shape != tuple(shape) or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
            self._ring[i] = buf
        return buf
