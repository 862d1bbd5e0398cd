"""tx.kernels_roofline_pct: the least time the transmit function needs for
one block at the cell's shapes, as a share of tx.step_busy_ms.  The count
is of the function, not of the kernels that run it, so it reads the same
whatever implements the function.

Least time: the larger of bytes over 3.35 TB/s and operations over
67 TFLOP/s (float32 outside the tensor cores; one H100 SXM at 700 W).

Bytes, each input byte read once and each output byte written once: the
mic block [C, B] float32; the I/Q [C, B L] complex64; the carried state
read and written (the analytic filter's history C (T-1) float32, the
ALC's delay line C A complex64, the interpolator's history C ceil(Tu / L)
complex64, a few values a channel for the pre-emphasis, the ALC, the
CTCSS tone and the NCO); the taps (C T complex64, Tu float32).

Operations, from the algorithm, a mic sample: pre-emphasis 2, the
compressor 12; the analytic filter as overlap-save at nfft = next power
of two >= B + T - 1, two nfft-point complex FFTs at 5 nfft log2 nfft and
6 a bin for the product; the modulator by the row's mode (USB and DGT_U
0, LSB 1, AM 2, FM 8: the tone's phase 2, its sine 1, the scale and sum
3, the cosine and sine 2); the ALC 22 (the magnitude 4, the target's
ratio 1, the recurrence 15, the gain's product 2).  A TX sample: the
interpolator 4 a phase tap (ceil(Tu / L) taps on two rails, a multiply
and an add each), the tune 10 (the phase 2, its sine and cosine 2, the
complex product 6), the trim 4.  Each add, multiply, divide, compare,
square root, sine and cosine counts as one.

At the cell's shapes (C 8192, B 2048, L 2, T 513, nfft 4096, A 960, Tu
117, modes in fifths) the operations bound it: 13.26 GFLOP = 0.1979 ms
against 537.1 MB = 0.1603 ms.
"""

import math

from qbench import peaks
from qbench.trace import step_busy_ms

OPS_A_MIC_SAMPLE = {"preemph": 2, "compress": 12, "alc": 22}
OPS_MODULATOR = {"USB": 0, "DGT_U": 0, "LSB": 1, "AM": 2, "FM": 8}
OPS_A_TX_SAMPLE = {"tune": 10, "trim": 4}


def counts(s: dict) -> dict:
    """Bytes and operations of one block at shapes ``s``."""
    C, B, L = s["channels"], s["block"], s["interp"]
    T, nfft, A, Tu = s["filter_taps"], s["nfft"], s["alc_delay"], \
        s["interp_taps"]
    Bt = B * L
    up = -(-Tu // L) if L > 1 else 0
    state = C * ((T - 1) * 4 + A * 8 + up * 8 + 48)
    parts = {
        "mic_bytes": C * B * 4,
        "iq_bytes": C * Bt * 8,
        "state_bytes": 2 * state,
        "taps_bytes": C * T * 8 + Tu * 4,
        "filter_ops": C * (2 * 5 * nfft * int(math.log2(nfft)) + 6 * nfft),
        "modulate_ops": B * sum(OPS_MODULATOR[m] * n
                                for m, n in s["modes"].items()),
        "interp_ops": 4 * up * C * Bt,
    }
    for stage, n in OPS_A_MIC_SAMPLE.items():
        on = stage != "alc" or A > 0
        parts[stage + "_ops"] = n * C * B if on else 0
    for stage, n in OPS_A_TX_SAMPLE.items():
        parts[stage + "_ops"] = n * C * Bt
    parts["bytes"] = sum(v for k, v in parts.items() if k.endswith("_bytes"))
    parts["ops"] = sum(v for k, v in parts.items() if k.endswith("_ops"))
    return parts


def read(ctx):
    if ctx.cfg["system"] != "tx_chain":
        return None
    busy = step_busy_ms(ctx.trace)
    if not busy:
        return None
    c = counts(ctx.shapes)
    least, _ = peaks.least_ms(c["bytes"], c["ops"])
    return 100.0 * least / busy
