"""Faults planted under the timed path, for the test that sees ``correct``
come out false: each wraps a system's step the way a broken program
would behave.  A step's output is a tensor or a tuple of tensors; the
system says which axis of each runs over channels and how to scale one
channel's audio."""

from __future__ import annotations


def _parts(y):
    return list(y) if isinstance(y, tuple) else [y]


def _pack(y, parts):
    return tuple(parts) if isinstance(y, tuple) else parts[0]


def stale_state(system):
    """A step that returns its state unchanged."""
    step = system.step

    def f(state, x):
        _, y = step(state, x)
        return state, y
    return f


def half_batch(system):
    """Half of the batch left out: the second half of the channels of
    every output comes back as zeros."""
    step = system.step

    def f(state, x):
        state, y = step(state, x)
        parts = []
        for t in _parts(y):
            t = t.clone()
            ax = system.channel_axis(t)
            n = t.shape[ax]
            t.narrow(ax, n // 2, n - n // 2).zero_()
            parts.append(t)
        return state, _pack(y, parts)
    return f


def altered_answer(system):
    """One answer altered where it is produced: the first compared
    channel's audio 1% loud."""
    step = system.step

    def f(state, x):
        state, y = step(state, x)
        parts = _parts(y)
        parts[0] = system.scale_first_channel(parts[0].clone(), 1.01)
        return state, _pack(y, parts)
    return f


FAULTS = {"stale_state": stale_state, "half_batch": half_batch,
          "altered_answer": altered_answer}


def plant(system, name: str):
    """``system`` with its step broken by fault ``name``."""
    system.step = FAULTS[name](system)
    return system
