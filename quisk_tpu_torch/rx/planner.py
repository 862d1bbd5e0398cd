"""Decimation planner: factor any input rate down to the audio rate.

Parity: the reference searches /2^a /3^b /5^c factorisations to bring any
input rate to >= 48 k (quisk.c:1633-1657 ``PlanDecimation``) with a special
fractional stage for the remainder (quisk.c:1658, 2654-2659 ``cFracDecim``)
and hardcoded chains for the SDR-IQ family rates (quisk.c:1731-1768).  This
planner generalises: the largest 2^a 3^b 5^c divisor D with fs_in/D >= fs_out
becomes integer stages (half-bands for the 2s, Kaiser FIR decimators for
3s/5s), and the residual ratio in [1, 2) becomes a rational fractional
(Lagrange) stage.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction


@dataclasses.dataclass(frozen=True)
class DecimPlan:
    fs_in: float
    fs_out_nominal: float        # requested audio rate (e.g. 48000)
    fs_out: float                # achieved rate (== nominal up to frac approx)
    stages: tuple[int, ...]      # integer stage factors in execution order
    frac: Fraction | None        # residual fs_mid / fs_out ratio, or None
    fs_mid: float                # rate after integer stages (before frac)

    @property
    def int_decim(self) -> int:
        d = 1
        for s in self.stages:
            d *= s
        return d

    def stage_rates(self) -> list[float]:
        """Input rate of each integer stage, in execution order."""
        rates, fs = [], self.fs_in
        for s in self.stages:
            rates.append(fs)
            fs /= s
        return rates


def _best_235_divisor(ratio: float) -> int:
    """Largest 2^a 3^b 5^c <= ratio."""
    best = 1
    p2 = 1
    while p2 <= ratio:
        p23 = p2
        while p23 <= ratio:
            p235 = p23
            while p235 <= ratio:
                best = max(best, p235)
                p235 *= 5
            p23 *= 3
        p2 *= 2
    return best


def plan_decimation(fs_in: float, fs_out: float = 48000.0,
                    max_frac_den: int = 4096) -> DecimPlan:
    if fs_in < fs_out:
        raise ValueError(f"input rate {fs_in} below audio rate {fs_out}")
    ratio = fs_in / fs_out
    D = _best_235_divisor(ratio + 1e-9)
    fs_mid = fs_in / D

    # order stages: halfbands (2s) first at high rate, then 5s, then 3s —
    # the reference's chains use the same shape (HB45 cascade + FIR /3 /5,
    # quisk.c:1731-1843)
    stages = []
    d = D
    for p in (2, 5, 3):
        while d % p == 0:
            stages.append(p)
            d //= p
    assert d == 1

    frac = None
    fs_achieved = fs_mid
    if abs(fs_mid - fs_out) > 1e-6:
        frac = Fraction(fs_mid / fs_out).limit_denominator(max_frac_den)
        fs_achieved = fs_mid * frac.denominator / frac.numerator
    return DecimPlan(fs_in=fs_in, fs_out_nominal=fs_out, fs_out=fs_achieved,
                     stages=tuple(stages), frac=frac, fs_mid=fs_mid)


def plan_block_sizes(plan: DecimPlan, audio_block: int = 2048) -> dict:
    """Pick static block sizes for every stage of a plan.

    Returns {"input": B_in, "mid": B_mid, "audio": B_audio} such that every
    stage's divisibility constraints hold and B_audio is close to the
    request.
    """
    if plan.frac is not None:
        M, L = plan.frac.numerator, plan.frac.denominator
        # B_mid must make B_mid * L divisible by M
        import math
        g = math.gcd(L, M)
        step = M // g
        B_mid = step * max(1, round(audio_block * M / (L * step)))
        B_audio = B_mid * L // M
    else:
        B_mid = audio_block
        B_audio = audio_block
    B_in = B_mid * plan.int_decim
    return {"input": B_in, "mid": B_mid, "audio": B_audio}
