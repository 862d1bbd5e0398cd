"""The narrowband-FM receiver with WDSP's FM demodulator,
``quisk_tpu_torch.rx.chain.RxChain`` with ``ext_demod="pll_fm"`` and every
channel ``Mode.EXT``: one step turns a block [C, block_in] of C independent
192 kS/s captures into [C, block_audio] audio (PLL discriminator,
de-emphasis, CTCSS notch, lookahead AGC, RF squelch).  Every channel's
audio goes to the host."""

from __future__ import annotations

import sys

import numpy as np
import torch

from qbench.nfm_signals import pllnfm_ring, stations
from qref.pllnfm import PllNfmReference
from qref.spec import rx_modes, rx_tunes


class System:
    def __init__(self, cfg: dict, seed: int, device):
        from quisk_tpu_torch.modes import Mode
        from quisk_tpu_torch.rx.chain import RxChain, RxChainConfig
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.chain = RxChain.create(
            RxChainConfig(**cfg["chain"]), tune_hz=rx_tunes(cfg),
            mode=[int(Mode[m]) for m in rx_modes(cfg)], device=self.device)
        C = self.chain.channels
        self.block_shape = (C, self.chain.block_in)
        self.samples_per_block = C * self.chain.block_in
        self.out_shapes = [((C, self.chain.block_audio), torch.float32)]

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

    def scale_first_channel(self, audio, gain: float):
        audio[0] *= gain
        return audio

    def shapes(self) -> dict:
        """The sizes the per-layer metrics count work from, as the
        configuration gives them (worked out by the reference's design,
        not read from the program)."""
        ref = PllNfmReference.create(self.cfg)
        return {"channels": ref.rx.channels, "block_in": ref.rx.block_in,
                "block_audio": ref.rx.block_audio, "decim": ref.rx.decim,
                "front_taps": len(ref.rx.h_front),
                "filter_taps": ref.rx.bp.shape[-1],
                "agc_lookahead": ref.rx.W, "notch": ref.notch is not None,
                "squelch": ref.squelch}


def ring(cfg: dict, seed: int, blocks: int, device, gen) -> list:
    """The cell's capture: ``blocks`` blocks [C, block_in] from the seed."""
    ref = PllNfmReference.create(cfg)
    return pllnfm_ring(cfg, seed, blocks, ref.rx.block_in, device, gen)


def checked(cfg: dict, seed: int) -> np.ndarray:
    """The compared channels: every channel, or a draw from the seed of
    ``check_channels`` of them that takes station and idle channels in
    their shares (channels are independent, so a draw is exact for the
    channels it takes).  Sorted."""
    C = cfg["chain"]["channels"]
    n = cfg.get("check_channels", C)
    if n >= C:
        return np.arange(C)
    on, _ = stations(cfg, seed)
    rng = np.random.default_rng([seed, 5])
    picks = []
    for group in (np.flatnonzero(on), np.flatnonzero(~on)):
        k = round(n * group.size / C)
        picks.append(rng.choice(group, k, replace=False))
    return np.sort(np.concatenate(picks))


def check(cfg: dict, seed: int, get_block, ring_blocks: int, kept: dict,
          device, control: bool = False) -> dict:
    """{j: compared numbers} of the kept blocks {j: [audio]}: the widest
    gap of any checked channel's audio to the reference, as a share of
    that channel's largest reference sample in the block (0 where both are
    silent).  A squelch decision the program and the reference do not
    share (one silent, the other not) reads 1 or more.  ``control`` puts
    the reference computed in TF32 in the program's place."""
    ref = PllNfmReference.create(cfg, device=device)
    rows = checked(cfg, seed)
    on, _ = stations(cfg, seed)
    ks = sorted(kept)
    want = ref.blocks(get_block, ks, rows)
    lowp = ref.blocks(get_block, ks, rows, lowp=True) if control else None
    out = {}
    stats = {"open": 0, "shut": 0, "disagree": 0}
    rf_idle, rf_on = -np.inf, np.inf
    for j in ks:
        w, rf = want[j]
        got = (lowp[j][0] if control
               else np.asarray(kept[j][0], np.float64)[rows])
        gap = np.abs(got - w).max(-1) / np.maximum(np.abs(w).max(-1), 1e-30)
        shut_ref, shut_got = (w == 0).all(-1), (got == 0).all(-1)
        stats["open"] += int((~shut_ref).sum())
        stats["shut"] += int(shut_ref.sum())
        stats["disagree"] += int((shut_ref != shut_got).sum())
        rf_idle = max(rf_idle, float(rf[~on[rows]].max(initial=-np.inf)))
        rf_on = min(rf_on, float(rf[on[rows]].min(initial=np.inf)))
        out[j] = {"audio_gap": float(gap.max())}
    print(f"squelch over {len(rows)} channels x {len(ks)} blocks: "
          f"{stats['open']} open, {stats['shut']} shut in the reference, "
          f"{stats['disagree']} decisions not shared; block RF dB: idle "
          f"channels up to {rf_idle!r}, stations from {rf_on!r}, threshold "
          f"{cfg['chain']['fm_squelch_db']!r}; AGC records doubled for "
          f"{ref.extended} channel blocks", file=sys.stderr, flush=True)
    return out
