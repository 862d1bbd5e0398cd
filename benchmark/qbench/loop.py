"""The closed loop: blocks handed to the program's ``DeviceFeed`` as soon
as fewer than ``in_flight`` are unfinished, each finished when its outputs
are in the harness's pinned host buffers.

The feed wraps the system's step.  A resident block is a tensor on the
card, which the feed steps as it is; a fed block is a pinned host tensor,
which the feed copies on its own copy stream.  Each output the feed
returns is copied to the host on a stream of the harness's own, after the
step's stream, and its event marks the block finished.  The harness adds
no synchronisation of its own beyond waiting for the oldest unfinished
block when ``in_flight`` are out.

With ``spans`` the loop marks its host work with ``record_function``
ranges named ``bench.<span>``: ``handoff`` (one block: the push and the
copy that follows), ``feed_push``, ``step_call`` (inside the push),
``output_copy`` and ``output_wait``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import torch


class Spans:
    """``record_function`` ranges, or nothing at all when off."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function("bench." + name)


class Loop:
    def __init__(self, system, ring: list, mix: dict, device, spans: Spans,
                 keep: int):
        from quisk_tpu_torch.io.feed import DeviceFeed
        if mix["in_flight"] <= mix["prefetch"]:
            raise ValueError("in_flight must exceed the feed's prefetch")
        self.system, self.ring, self.spans = system, ring, spans
        self.in_flight = mix["in_flight"]
        self.device = torch.device(device)
        self.feed = DeviceFeed(self._step, system.init_state(),
                               prefetch=mix["prefetch"], device=self.device)
        self.cuda = self.device.type == "cuda"
        self.out_stream = torch.cuda.Stream(self.device) if self.cuda else None
        self.pool = [self._buffers() for _ in range(self.in_flight + 1)]
        self.spare = [self._buffers() for _ in range(keep)]
        self.kept: dict = {}
        self.keep_more = 0               # also keep this many more blocks
        self.awaiting: deque = deque()   # (j, t0, keep): not yet stepped
        self.pending: deque = deque()    # (j, t0, event, bufs, keep)
        self.next_block = 0

    def _buffers(self) -> list:
        return [torch.empty(shape, dtype=dt, pin_memory=self.cuda)
                for shape, dt in self.system.out_shapes]

    def _step(self, state, x):
        with self.spans("step_call"):
            return self.system.step(state, x)

    def unfinished(self) -> int:
        return len(self.awaiting) + len(self.pending)

    def handoff(self, keep: bool = False) -> None:
        """Hand the next block of the ring to the feed."""
        j = self.next_block
        self.next_block += 1
        with self.spans("handoff"):
            x = self.ring[j % len(self.ring)]
            self.awaiting.append((j, time.perf_counter(), keep))
            with self.spans("feed_push"):
                outs = self.feed.push(x)
            for y in outs:
                self._copy_out(y)

    def flush(self) -> None:
        """Hand over what the feed still holds (after the window)."""
        for y in self.feed.flush():
            self._copy_out(y)

    def _copy_out(self, y) -> None:
        j, t0, keep = self.awaiting.popleft()
        with self.spans("output_copy"):
            bufs = self.spare.pop() if keep else self.pool.pop()
            if self.cuda:
                self.out_stream.wait_stream(torch.cuda.current_stream(
                    self.device))
                with torch.cuda.stream(self.out_stream):
                    for b, p in zip(bufs, self.system.outputs(y)):
                        b.copy_(p, non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(self.out_stream)
                for t in (y if isinstance(y, (tuple, list)) else (y,)):
                    t.record_stream(self.out_stream)
            else:
                for b, p in zip(bufs, self.system.outputs(y)):
                    b.copy_(p)
                ev = None
        self.pending.append((j, t0, ev, bufs, keep))

    def retire(self, wait: bool = False) -> list:
        """[(block, handed off, finished)] of the blocks whose outputs have
        landed, oldest first; with ``wait``, wait for the oldest first."""
        done = []
        while self.pending:
            j, t0, ev, bufs, keep = self.pending[0]
            if ev is not None and not ev.query():
                if not wait:
                    break
                with self.spans("output_wait"):
                    ev.synchronize()
            wait = False
            t1 = time.perf_counter()
            self.pending.popleft()
            if keep or self.keep_more:
                self.kept[j] = bufs
                self.keep_more -= not keep
            else:
                self.pool.append(bufs)
            done.append((j, t0, t1))
        return done

    def drain(self) -> list:
        """Finish every block handed off (after the window)."""
        self.flush()
        done = []
        while self.pending:
            done += self.retire(wait=True)
        return done
