"""Delay-line (lookahead) AGC.

Parity: the reference AGC (quisk.c:2162 ``process_agc``) keeps a ~15 ms
lookahead buffer, tracks the max magnitude in it, drops gain at once on
clip and releases exponentially.  In the log domain the per-sample
recurrence is ``lg[n] = min(lg[n-1] + d, l[n])``, a composition of the
associative maps ``x -> min(x + d, l)``, evaluated over the block in
log-depth (Hillis-Steele doubling).  The lookahead envelope is a sliding
maximum by the van Herk two-pass cummax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device


def sliding_max(x: torch.Tensor, window: int) -> torch.Tensor:
    """max over x[..., n : n+window] for each n (right-looking), van Herk.

    x: [C, B].  Windows that run past the end use what exists.
    """
    C, B = x.shape
    W = window
    nblk = -(-B // W)
    pad = nblk * W - B
    neg = torch.finfo(x.dtype).min
    xp = torch.nn.functional.pad(x, (0, pad), value=neg)
    blocks = xp.reshape(C, nblk, W)
    pref = torch.cummax(blocks, dim=2).values.reshape(C, nblk * W)
    suff = torch.cummax(blocks.flip(2), dim=2).values.flip(2)
    suff = suff.reshape(C, nblk * W)
    # out[n] = max(suffix max of n's block, prefix max at n + W - 1)
    pref_ext = torch.nn.functional.pad(pref, (0, W), value=neg)
    return torch.maximum(suff[:, :B], pref_ext[:, W - 1:W - 1 + B])


def min_scan(limit: torch.Tensor, inc, lg0: torch.Tensor) -> torch.Tensor:
    """lg[n] = min(lg[n-1] + inc, limit[n]) for all n.

    The maps (i, m): x -> min(x + i, m) compose as
    (i1, m1) then (i2, m2) = (i1 + i2, min(m1 + i2, m2)); a log-step
    doubling scan over the block axis evaluates all prefixes.
    """
    I = torch.broadcast_to(torch.as_tensor(inc, dtype=limit.dtype,
                                           device=limit.device), limit.shape)
    M = limit
    n = limit.shape[-1]
    s = 1
    while s < n:
        M = torch.cat([M[..., :s],
                       torch.minimum(M[..., :-s] + I[..., s:], M[..., s:])],
                      dim=-1)
        I = torch.cat([I[..., :s], I[..., :-s] + I[..., s:]], dim=-1)
        s *= 2
    return torch.minimum(lg0[:, None] + I, M)


@dataclasses.dataclass(frozen=True)
class AGC:
    """Lookahead AGC on real audio ``[C, B]`` blocks.

    target: output peak level; max_lgain: log of the gain ceiling;
    release_inc: log-gain increase per sample; lookahead: delay-buffer
    length in samples (15 ms at 48 k = 720 in the reference).
    """

    target: torch.Tensor
    max_lgain: torch.Tensor
    release_inc: torch.Tensor
    lookahead: int

    @classmethod
    def create(cls, sample_rate: float, target: float = 0.9,
               max_gain_db: float = 80.0, release_db_per_s: float = 60.0,
               lookahead_ms: float = 15.0, device=None):
        device = resolve_device(device)
        W = max(1, int(round(lookahead_ms * 1e-3 * sample_rate)))
        inc = np.log(10.0) * release_db_per_s / 20.0 / sample_rate

        def f32(v):
            return torch.tensor(np.float32(v), device=device)
        return cls(target=f32(target),
                   max_lgain=f32(np.log(10.0) * max_gain_db / 20.0),
                   release_inc=f32(inc), lookahead=W)

    def init_state(self, channels: int):
        dev = self.target.device
        delay = torch.zeros((channels, self.lookahead), dtype=torch.float32,
                            device=dev)
        lg = torch.zeros((channels,), dtype=torch.float32, device=dev)
        return delay, lg

    def __call__(self, state, a: torch.Tensor):
        """a [C, B] float audio -> gain-controlled audio, same shape; output
        sample n is input sample n - lookahead."""
        delay, lg_prev = state
        W = self.lookahead
        B = a.shape[-1]
        ext = torch.cat([delay, a], dim=-1)               # [C, W+B]
        env = sliding_max(torch.abs(ext), W)[:, :B]
        limit = torch.minimum(
            torch.log(self.target / torch.clamp(env, min=1e-9)),
            self.max_lgain)
        lg = min_scan(limit, self.release_inc, lg_prev)
        out = ext[:, :B] * torch.exp(lg)
        return (ext[:, ext.shape[-1] - W:], lg[:, -1]), out
