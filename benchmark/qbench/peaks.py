"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense):
float32 outside the tensor cores and HBM3 bandwidth, at the full 700 W
power limit."""

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations": the larger bound)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / FP32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
