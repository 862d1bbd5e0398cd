"""Channel-axis sharding: thousands of independent receivers across ranks.

Counterpart of ``quisk_tpu.parallel.shard``.  Channels are independent,
so each rank runs the whole chain on its own rows ``lo:hi`` of the channel
axis and the step makes no collective call, as the reference's
``shard_map`` step does.

Which leaves of a tree are per-channel is decided by the tree itself: the
caller builds it a second time at another channel count (its *twin*), and
a leaf whose leading dimension follows the count is cut to the rank's
rows, a leaf that does not change is kept whole, an int that follows the
count (``RxChain.channels``) becomes the rank's row count, and any other
change raises.  The reference decides by a global set of field names plus
the leading dimension, which replicated a per-channel leaf that happened
to carry a listed name (``taps``, ``window``) without a word; a shared
constant whose leading dimension merely equals the channel count (the
[32, 32] DFT basis at 32 channels that the reference once sharded) keeps
its shape in the twin and stays whole here.

Time-block sharding with halo exchange lives in
:mod:`quisk_tpu_torch.parallel.timeshard`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch.parallel.comm import Mesh, make_mesh  # noqa: F401

CHAN, SHARED, COUNT = "chan", "shared", "count"


def channel_rows(channels: int, rank: int, world: int) -> tuple[int, int]:
    """Rank ``rank``'s rows ``lo:hi`` of ``channels`` split ``world`` ways
    (``quisk_tpu/parallel/multihost.py:40-41``)."""
    return rank * channels // world, (rank + 1) * channels // world


def twin_count(channels: int) -> int:
    """A channel count other than ``channels`` to build a twin at (small,
    so the twin is cheap; at least 2, where every per-channel leaf keeps
    its [C, ...] form)."""
    return 2 if channels != 2 else 3


def _is_array(v) -> bool:
    return isinstance(v, (torch.Tensor, np.ndarray))


def _leaf_kind(leaf, other, channels: int, path: str) -> str:
    if _is_array(leaf) or _is_array(other):
        if type(leaf) is not type(other) or leaf.dtype != other.dtype:
            raise ValueError(f"{path}: {type(leaf).__name__} "
                             f"{getattr(leaf, 'dtype', '')} in the tree, "
                             f"{type(other).__name__} "
                             f"{getattr(other, 'dtype', '')} in the twin")
        s, o = tuple(leaf.shape), tuple(other.shape)
        if s == o:
            return SHARED
        if len(s) == len(o) and s and s[0] == channels and s[1:] == o[1:]:
            return CHAN
        raise ValueError(f"{path}: shape {s} at {channels} channels and {o} "
                         f"in the twin: neither [channels, ...] nor shared")
    if isinstance(leaf, int) and not isinstance(leaf, bool) \
            and isinstance(other, int) and leaf != other:
        if leaf == channels:
            return COUNT
        raise ValueError(f"{path}: {leaf} at {channels} channels, {other} "
                         f"in the twin")
    if leaf is other or type(leaf) is type(other) and leaf == other:
        return SHARED
    raise ValueError(f"{path}: {leaf!r} in the tree, {other!r} in the twin")


def _walk(tree, twin, channels: int, fn, path: str = ""):
    """Rebuild ``tree`` with ``fn(kind, leaf, path)`` at every leaf, the
    kind read against the same leaf of ``twin``."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        if type(twin) is not type(tree):
            raise ValueError(f"{path}: {type(tree).__name__} in the tree, "
                             f"{type(twin).__name__} in the twin")
        return dataclasses.replace(tree, **{
            f.name: _walk(getattr(tree, f.name), getattr(twin, f.name),
                          channels, fn, f"{path}.{f.name}".lstrip("."))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        if not isinstance(twin, dict) or set(tree) != set(twin):
            raise ValueError(f"{path}: keys differ from the twin's")
        return {k: _walk(v, twin[k], channels, fn, f"{path}.{k}".lstrip("."))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        if type(twin) is not type(tree) or len(twin) != len(tree):
            raise ValueError(f"{path}: length differs from the twin's")
        return type(tree)(_walk(v, w, channels, fn, f"{path}.{i}".lstrip("."))
                          for i, (v, w) in enumerate(zip(tree, twin)))
    return fn(_leaf_kind(tree, twin, channels, path), tree, path)


def channel_split(tree, twin, channels: int) -> dict:
    """{leaf path: "chan" | "shared" | "count"} for ``tree`` at
    ``channels`` channels against ``twin``, the same tree built at another
    count.  Raises on a leaf that changes any other way (e.g. a [2C]
    stack), or when the twin looks built at the same count."""
    kinds, leads = {}, []

    def note(kind, leaf, path):
        kinds[path] = kind
        if _is_array(leaf) and leaf.ndim and leaf.shape[0] == channels:
            leads.append(path)
        return leaf

    _walk(tree, twin, channels, note)
    if leads and CHAN not in kinds.values() and COUNT not in kinds.values():
        raise ValueError(f"nothing follows the channel count, but {leads[0]} "
                         f"leads with {channels}: build the twin at another "
                         f"count")
    return kinds


def shard_over_channels(tree, mesh: Mesh, channels: int, twin,
                        axis: str = "chan"):
    """This rank's copy of ``tree`` (a chain, demod, op or state tree of
    frozen dataclasses, dicts and tuples) on ``mesh.device``: per-channel
    leaves cut to its rows, shared leaves whole, the channel count set to
    its row count.  ``twin`` is the same tree built at another channel
    count (:func:`twin_count`)."""
    channel_split(tree, twin, channels)
    lo, hi = channel_rows(channels, mesh.index(axis), mesh.size(axis))
    dev = mesh.device

    def cut(kind, leaf, path):
        if kind == COUNT:
            return hi - lo
        if isinstance(leaf, np.ndarray):
            return leaf[lo:hi].copy() if kind == CHAN else leaf
        if isinstance(leaf, torch.Tensor):
            return (leaf[lo:hi] if kind == CHAN else leaf).to(dev, copy=True)
        return leaf

    return _walk(tree, twin, channels, cut)


def make_sharded_step(chain, mesh: Mesh, channels: int, axis: str = "chan"):
    """The channel-sharded receive step: ``step(chain_local, state_local,
    x_local)`` runs this rank's whole chain on its [C/n, block] rows (from
    :func:`shard_over_channels`) and makes no collective call."""
    if chain.channels != channels:
        raise ValueError(f"chain has {chain.channels} channels, not "
                         f"{channels}")
    lo, hi = channel_rows(channels, mesh.index(axis), mesh.size(axis))

    def step(chain_local, state_local, x_local):
        if x_local.shape[0] != hi - lo or chain_local.channels != hi - lo:
            raise ValueError(f"rank holds rows {lo}:{hi}, got a chain of "
                             f"{chain_local.channels} and x of "
                             f"{x_local.shape[0]} rows")
        return chain_local.step(state_local, x_local)

    return step
