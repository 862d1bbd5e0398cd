"""nfm.kernels_roofline_pct: the least time the narrowband-FM receive
function needs for one block at the cell's shapes, as a share of
nfm.step_busy_ms.  The count is of the function, not of the kernels that
run it, so it reads the same whatever implements the function; it counts
the EXT path alone (the SSB, AM and FM families that MixedDemod computes
and discards are not the function's).

Least time: the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s (float32 outside the tensor cores; one H100 SXM at 700 W).

Bytes, each input byte read once and each output byte written once: the
block [C, B_in] complex64; the audio [C, Ba] float32; the carried state
read and written (the front's history C (T-1) and the channel filter's
C (Tbp-1) complex64, the AGC's delay line C W float32, a few values a
channel for the NCO, the PLL, the de-emphasis, the notch, the gain and
the squelch); the taps (T float32, C Tbp complex64).

Operations, from the algorithm: the mix 8 an input sample (the complex
product 6, the oscillator's sine and cosine 2); the decimating FIR 4 a
tap an output sample (real taps on complex data); the channel filter as
overlap-save at nfft = next power of two >= Ba + Tbp - 1, two
nfft-point complex FFTs at 5 nfft log2 nfft and 6 a bin for the product;
then a sample: the PLL 19 (the phasor's sine and cosine 2, the complex
rotation 6, the arc tangent 1, the frequency's update and clamp 4, the
phase's update and wrap 4, the audio 2), the de-emphasis 3, the notch 9
(5 products, 4 sums), the AGC 11, the squelch 7 (the power 4, the ramp 2,
the gain 1).  Each add, multiply, divide, compare, square root,
logarithm, exponential, sine, cosine and arc tangent counts as one.

At the cell's shapes (C 8192, B_in 8192, T 133, Ba 2048, Tbp 1025, W 720)
the bytes bound it: 870.4 MB = 0.2598 ms against 14.51 GFLOP =
0.2166 ms.
"""

import math

from qbench import peaks
from qbench.trace import step_busy_ms

OPS_MIX = 8
OPS_A_SAMPLE = {"pll": 19, "deemph": 3, "notch": 9, "agc": 11,
                "squelch": 7}


def counts(s: dict) -> dict:
    """Bytes and operations of one block at shapes ``s``."""
    C, B, Ba = s["channels"], s["block_in"], s["block_audio"]
    T, Tbp, W = s["front_taps"], s["filter_taps"], s["agc_lookahead"]
    nfft = 1 << math.ceil(math.log2(Ba + Tbp - 1))
    state = C * ((T - 1) * 8 + (Tbp - 1) * 8 + W * 4 + 32)
    parts = {
        "input_bytes": C * B * 8,
        "audio_bytes": C * Ba * 4,
        "state_bytes": 2 * state,
        "taps_bytes": T * 4 + C * Tbp * 8,
        "mix_ops": OPS_MIX * C * B,
        "fir_ops": 4 * T * C * Ba,
        "filter_ops": C * (2 * 5 * nfft * int(math.log2(nfft)) + 6 * nfft),
    }
    for stage, n in OPS_A_SAMPLE.items():
        on = s.get(stage, True)
        parts[stage + "_ops"] = n * C * Ba if on else 0
    parts["bytes"] = sum(v for k, v in parts.items() if k.endswith("_bytes"))
    parts["ops"] = sum(v for k, v in parts.items() if k.endswith("_ops"))
    return parts


def read(ctx):
    if ctx.cfg["system"] != "rx_pllnfm":
        return None
    busy = step_busy_ms(ctx.trace)
    if not busy:
        return None
    c = counts(ctx.shapes)
    least, _ = peaks.least_ms(c["bytes"], c["ops"])
    return 100.0 * least / busy
