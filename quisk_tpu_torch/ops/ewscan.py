"""Exponentially-weighted cumulative sum as blocked triangular matmuls.

``ew_cumsum`` evaluates the first-order recurrence

    y[n] = alpha * y[n-1] + x[n],      y[-1] = y0

for every n of a [C, B] block, at the raw IQ rate (B is tens of thousands
of samples), exactly to float32 rounding in two fp32 matmul levels, as
``quisk_tpu.ops.ewscan.ew_cumsum`` does:

1. B is split into J sub-blocks of L = 128; within a sub-block the prefix
   states are ``P = x_sub @ W^T`` with the lower-triangular Toeplitz
   weight ``W[i, k] = alpha^(i-k)``;
2. the J sub-block carry-ins follow the same recurrence at ratio alpha^L
   over the sub-blocks' end states (one [J, J] triangular matmul) and are
   blended back as ``alpha^(i+1) * carry``.

The weights are built in float64 and rounded once.
``ops/iir._first_order_chunked`` is the sibling that takes its
coefficient as a tensor.
"""

from __future__ import annotations

import numpy as np
import torch

_L = 128  # sub-block width


def ew_cumsum(x: torch.Tensor, alpha: float, y0: torch.Tensor
              ) -> torch.Tensor:
    """All states of ``y[n] = alpha*y[n-1] + x[n]``.

    x [C, B] real; alpha a Python float; y0 [C] the carried state y[-1].
    Returns y [C, B]; the next block's carry is y[:, -1]."""
    C, B = x.shape
    a = float(alpha)
    L = min(_L, B) if B % _L else _L
    Bp = -(-B // L) * L
    if Bp != B:
        x = torch.nn.functional.pad(x, (0, Bp - B))
    J = Bp // L

    i = np.arange(L)
    W = np.tril(np.power(a, np.maximum(i[:, None] - i[None, :], 0),
                         dtype=np.float64)).astype(np.float32)
    aL = a ** L
    j = np.arange(J)
    V = np.tril(np.power(aL, np.maximum(j[:, None] - j[None, :], 0),
                         dtype=np.float64)).astype(np.float32)
    ramp = np.power(a, i + 1.0).astype(np.float32)        # alpha^(i+1)
    ramp_j = np.power(aL, j + 1.0).astype(np.float32)     # alpha^(L(j+1))

    def dev(v):
        return torch.as_tensor(v, device=x.device)

    # P[c, j, i] = sum_{k<=i} alpha^(i-k) x[c, j, k]
    P = torch.matmul(x.reshape(C, J, L), dev(W).T)
    T = P[:, :, -1]                                        # sub-block sums
    # dcend[c, j] = T[c, j] + aL*dcend[c, j-1], dcend[-1] = y0
    dcend = torch.matmul(T, dev(V).T) + dev(ramp_j)[None, :] * y0[:, None]
    carry_in = torch.cat([y0[:, None], dcend[:, :-1]], dim=1)
    y = P + dev(ramp)[None, None, :] * carry_in[:, :, None]
    return y.reshape(C, Bp)[:, :B]
