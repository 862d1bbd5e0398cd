"""The per-channel receiver, ``quisk_tpu_torch.rx.chain.RxChain``: one
step turns a block [C, block_in] of C independent captures into
[C, block_audio] audio.  Every channel's audio goes to the host."""

from __future__ import annotations

import numpy as np
import torch

from qbench.signals import rx_ring
from qref.rx import RxReference
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
        ref = RxReference.create(self.cfg)
        return {"channels": ref.channels, "block_in": ref.block_in,
                "block_audio": ref.block_audio, "decim": ref.decim,
                "front_taps": len(ref.h_front),
                "filter_taps": ref.bp.shape[-1], "agc_lookahead": ref.W,
                "families": list(ref.family)}


def ring(cfg: dict, seed: int, blocks: int, device, gen) -> list:
    """The cell's capture: ``blocks`` blocks [C, block_in] from the seed."""
    return rx_ring(cfg, seed, blocks, RxReference.create(cfg).block_in,
                   device, gen)


def check(cfg: dict, seed: int, get_block, ring_blocks: int, kept: dict,
          device, control: bool = False) -> dict:
    """{j: compared numbers} of the kept blocks {j: [audio]}: the widest
    gap of any channel's audio to the reference, as a share of that
    channel's largest reference sample in the block.  ``control`` puts
    the reference computed in TF32 in the program's place."""
    ref = RxReference.create(cfg, device=device)
    xmax = torch.stack([get_block(j).abs().amax(-1).to(torch.float64)
                        .cpu() for j in range(ring_blocks)]).amax(0).numpy()
    out = {}
    for j, outs in sorted(kept.items()):
        want = ref.block(get_block, j, xmax)
        got = (ref.block(get_block, j, xmax, lowp=True) if control
               else np.asarray(outs[0], np.float64))
        gap = np.abs(got - want).max(-1) / np.maximum(np.abs(want).max(-1),
                                                     1e-30)
        out[j] = {"audio_gap": float(gap.max())}
    return out
