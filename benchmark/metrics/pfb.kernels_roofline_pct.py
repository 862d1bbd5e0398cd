"""pfb.kernels_roofline_pct: the least time the channelizer receive
function needs for one block at the cell's shapes, as a share of
pfb.step_busy_ms.  The count is of the function, not of the kernels that
run it (kernel #4, the stage-1 product, kernel #6), so it reads the same
when stage 1 is fused into #6 or the IDFT is split another way.

Least time: the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s (float32 outside the tensor cores; one H100 SXM at 700 W).

Bytes, each input byte read once and each output byte written once: the
block [1, B] complex64; every channel's audio [n_out, K] float32 and the
power row [K] float32; the carried state read and written (the history
P K - K/2 complex64, five float32 a channel for the demodulators); the
prototype's P K float32 taps.

Operations, from the algorithm: the polyphase sums 4 a tap an output
(real taps on complex data: n_out K P taps); the K-point DFT of every
frame at 5 K log2 K; the commutator's phases are signs (none); the
demodulators a channel sample (SSB 1, AM 8, FM 12); the power 4 a channel
sample.  Counted as in rx.kernels_roofline_pct.

At the cell's shapes (K 4096, B 2^25, P 8, n_out 16384, modes by quarters)
the bytes bound it: 537.7 MB = 0.1605 ms against 6.81 GFLOP = 0.1017 ms.
"""

import math

from qbench import peaks
from qbench.trace import step_busy_ms

OPS_DEMOD = {"ssb": 1, "am": 8, "fm": 12}
OPS_POWER = 4


def counts(s: dict) -> dict:
    """Bytes and operations of one block at shapes ``s``."""
    K, B, P, n_out = s["n_chan"], s["block_in"], s["taps_per_branch"], \
        s["n_out"]
    parts = {
        "input_bytes": B * 8,
        "audio_bytes": n_out * K * 4,
        "power_bytes": K * 4,
        "state_bytes": 2 * ((P * K - K // 2) * 8 + 5 * K * 4),
        "taps_bytes": P * K * 4,
        "poly_ops": 4 * P * K * n_out,
        "dft_ops": n_out * 5 * K * int(math.log2(K)),
        "demod_ops": n_out * sum(OPS_DEMOD[f] for f in s["families"]),
        "power_ops": OPS_POWER * n_out * K,
    }
    parts["bytes"] = sum(v for k, v in parts.items() if k.endswith("_bytes"))
    parts["ops"] = sum(v for k, v in parts.items() if k.endswith("_ops"))
    return parts


def read(ctx):
    if ctx.cfg["system"] != "pfb_rx":
        return None
    busy = step_busy_ms(ctx.trace)
    if not busy:
        return None
    c = counts(ctx.shapes)
    least, _ = peaks.least_ms(c["bytes"], c["ops"])
    return 100.0 * least / busy
