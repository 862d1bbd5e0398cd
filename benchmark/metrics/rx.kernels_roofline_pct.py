"""rx.kernels_roofline_pct: the least time the per-channel receive
function needs for one block at the cell's shapes, as a share of
rx.step_busy_ms.  The count is of the function, not of the kernels that
run it, so it reads the same whatever implements the function (the OLS
filter fused into the front, a CUDA graph, a new kernel #1).

Least time: the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s (float32 outside the tensor cores; one H100 SXM at 700 W).

Bytes, each input byte read once and each output byte written once: the
block [C, B_in] complex64; the audio [C, Ba] float32; the carried state
read and written (the front's history C (T-1) and the channel filter's
C (Tbp-1) complex64, the AGC's delay line C W float32, a few values a
channel for the NCO, demodulators and gain); the taps (T float32, C Tbp
complex64).

Operations, from the algorithm: the mix 8 an input sample (the complex
product 6, the oscillator's sine and cosine 2); the decimating FIR 4 a tap
an output sample (real taps on complex data); the channel filter as
overlap-save at nfft = next power of two >= Ba + Tbp - 1, two nfft-point
complex FFTs at 5 nfft log2 nfft and 6 a bin for the product; the
demodulators a sample (SSB 1, AM 8, FM 12); the AGC 11 a sample.  Each
add, multiply, divide, compare, square root, logarithm, exponential and
arc tangent counts as one.

At the flagship's shapes (C 1024, B_in 40960, T 1421, Ba 2048, Tbp 1025)
the operations bound it: 12.82 GFLOP = 0.1913 ms against 398 MB =
0.1190 ms.  Moving fp32-exact products onto the tensor cores (3xTF32)
changes which peak bounds them: that needs this count redone, in a change
to the benchmark.
"""

import math

from qbench import peaks
from qbench.trace import step_busy_ms

OPS_DEMOD = {"ssb": 1, "am": 8, "fm": 12}
OPS_AGC = 11
OPS_MIX = 8


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
        "demod_ops": Ba * sum(OPS_DEMOD[f] for f in s["families"]),
        "agc_ops": OPS_AGC * C * Ba,
    }
    parts["bytes"] = sum(v for k, v in parts.items() if k.endswith("_bytes"))
    parts["ops"] = sum(v for k, v in parts.items() if k.endswith("_ops"))
    return parts


def read(ctx):
    if ctx.cfg["system"] != "rx_chain":
        return None
    busy = step_busy_ms(ctx.trace)
    if not busy:
        return None
    c = counts(ctx.shapes)
    least, _ = peaks.least_ms(c["bytes"], c["ops"])
    return 100.0 * least / busy
