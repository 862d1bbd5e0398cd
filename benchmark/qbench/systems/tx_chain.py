"""Quisk's transmit chain, ``quisk_tpu_torch.tx.chain.TxChain``: one step
turns a block [C, audio_block] of C transmitters' mic audio into [C,
audio_block L] I/Q at the TX rate (pre-emphasis, compressor, analytic
filter, the row's modulator, ALC, interpolation by L, the row's TX tune).
Modes cycle over the channels; each channel transmits at its own offset.
Every channel's I/Q goes to the host."""

from __future__ import annotations

import sys

import numpy as np
import torch

from qbench.tx_signals import mic_ring
from qref.design import next_pow2
from qref.spec import rx_modes, rx_tunes
from qref.tx import TxReference


class System:
    def __init__(self, cfg: dict, seed: int, device):
        from quisk_tpu_torch.modes import Mode
        from quisk_tpu_torch.tx.chain import TxChain, TxChainConfig
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        chain = TxChain.create(
            TxChainConfig(**cfg["chain"]),
            mode=[int(Mode[m]) for m in rx_modes(cfg)], device=self.device)
        self.chain = chain.set_tune(rx_tunes(cfg))
        C = self.chain.channels
        self.block_shape = (C, self.chain.block)
        self.samples_per_block = C * self.chain.block
        self.out_shapes = [((C, self.chain.block_tx), torch.complex64)]

    def init_state(self):
        return self.chain.init_state()

    def step(self, state, x):
        return self.chain.step(state, x)

    def make_ring(self, blocks: int, gen: torch.Generator):
        return ring(self.cfg, self.seed, blocks, self.device, gen)

    def outputs(self, y):
        """Device tensors to copy to the host, in ``out_shapes`` order."""
        return [y]

    def channel_axis(self, t) -> int:
        return 0

    def scale_first_channel(self, iq, gain: float):
        """The planted level fault, on the first FM channel: the rows whose
        ALC gain is pinned at the target from the first sample, so a 1%
        change there stands out of ``fm_iq_gap``; on the other rows it
        would lie inside the ALC's orbit spread (``check``)."""
        iq[rx_modes(self.cfg).index("FM")] *= gain
        return iq

    def shapes(self) -> dict:
        """The sizes the per-layer metrics count work from, as the
        configuration gives them (worked out by the reference's design,
        not read from the program)."""
        ref = TxReference.create(self.cfg)
        T = ref.taps.shape[-1]
        return {"channels": ref.channels, "block": ref.block,
                "block_tx": ref.block_tx, "interp": ref.L,
                "filter_taps": T, "nfft": next_pow2(ref.block + T - 1),
                "interp_taps": ref.h_up.size,
                "alc_delay": ref.alc.A if ref.alc else 0,
                "modes": {m: ref.modes.count(m) for m in set(ref.modes)}}


def ring(cfg: dict, seed: int, blocks: int, device, gen) -> list:
    """The cell's mic audio: ``blocks`` blocks [C, audio_block] from the
    seed."""
    return mic_ring(cfg, seed, blocks, device, gen)


def checked(cfg: dict, seed: int) -> np.ndarray:
    """The compared channels: every channel, or a draw from the seed of
    ``check_channels`` of them that takes each mode in its share (channels
    are independent, so a draw is exact for the channels it takes).
    Sorted."""
    C = cfg["chain"]["channels"]
    n = cfg.get("check_channels", C)
    if n >= C:
        return np.arange(C)
    modes = np.array(rx_modes(cfg))
    names = sorted(set(modes))
    quota = np.array([n * (modes == m).sum() / C for m in names])
    take = np.floor(quota).astype(int)
    # the draw's remainder to the modes with the largest fractions
    take[np.argsort(take - quota, kind="stable")[:n - take.sum()]] += 1
    rng = np.random.default_rng([seed, 5])
    picks = [rng.choice(np.flatnonzero(modes == m), k, replace=False)
             for m, k in zip(names, take)]
    return np.sort(np.concatenate(picks))


def gaps(got: np.ndarray, want: np.ndarray) -> dict:
    """Per row of one block's I/Q [R, N] complex128: ``iq``, the widest
    gap as a share of the row's largest reference sample, and ``phase``,
    the widest angle between a sample and the reference's, each weighted
    by the reference sample's share of that largest.  The ALC's gain is
    real, positive and slow beside the interpolator, so ``phase`` holds
    the filter, the modulator, the interpolator and the tune whatever the
    gain: a gain's error is along the sample, not across it."""
    aw = np.abs(want)
    top = np.maximum(aw.max(-1, keepdims=True), 1e-30)
    return {"iq": np.abs(got - want).max(-1) / top[:, 0],
            "phase": (np.abs(np.angle(got * want.conj())) * aw / top
                      ).max(-1)}


def check(cfg: dict, seed: int, get_block, ring_blocks: int, kept: dict,
          device, control: bool = False) -> dict:
    """{j: compared numbers} of the kept blocks {j: [I/Q]} over the
    checked channels (``gaps``): ``iq_gap``, the widest level gap of any
    row; ``fm_iq_gap``, the same over the FM rows; ``phase_gap``, the
    widest phase gap over the other rows.

    On the ring's periodic input the ALC of a voice or digital row settles
    into one of several orbits, and which one the float32 program reaches
    and the float64 reference reaches can differ: their gains then part by
    a ratio held through the block, up to what the gain recovers in one
    pass of the ring (0.2 a second) over the row's gain, ~6% on the
    loudest AM rows.  ``iq_gap``'s limit covers that, so it catches only
    gross faults; ``phase_gap`` does not see the gain and holds those rows
    to the program's rounding.  An FM row's envelope is
    1, above the target at the rest gain, so its ALC clips at the first
    sample and holds the target: its level and phase are the program's
    rounding alone (``fm_iq_gap``), the float32 CTCSS phase above all,
    which would set ``phase_gap``'s floor 30 times higher.  ``control``
    puts the reference computed with TF32 filters in the program's
    place."""
    ref = TxReference.create(cfg, device=device)
    rows = checked(cfg, seed)
    modes = np.array(ref.modes)[rows]
    fm = modes == "FM"
    ks = sorted(kept)
    want = ref.blocks(get_block, ks, rows, ring_blocks=ring_blocks)
    lowp = (TxReference.create(cfg, device=device).blocks(
        get_block, ks, rows, lowp=True, ring_blocks=ring_blocks)
        if control else None)
    out = {}
    worst = {m: [0.0, 0.0] for m in sorted(set(modes))}
    for j in ks:
        got = (lowp[j] if control
               else np.asarray(kept[j][0])[rows].astype(np.complex128))
        g = gaps(got, want[j])
        for m in worst:
            worst[m] = [max(worst[m][0], float(g["iq"][modes == m].max())),
                        max(worst[m][1],
                            float(g["phase"][modes == m].max()))]
        out[j] = {"iq_gap": float(g["iq"].max()),
                  "fm_iq_gap": float(g["iq"][fm].max()),
                  "phase_gap": float(g["phase"][~fm].max())}
    n = len(rows) * len(ks)
    print(f"iq_gap, phase_gap by mode over {len(rows)} channels x "
          f"{len(ks)} blocks: "
          + ", ".join(f"{m} {v[0]!r} {v[1]!r}" for m, v in worst.items())
          + f"; the ALC's gain moved in {ref.ramps} of {n} channel blocks "
          f"and clipped in {ref.clipped}; the longest replay from rest "
          f"{ref.replayed} blocks, from a start of the "
          f"{ref.period(ring_blocks)}-block period", file=sys.stderr,
          flush=True)
    return out
