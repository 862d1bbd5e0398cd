"""Float64 oracles for the WDSP AGC and the TX ALC.

A conformance model written from the published algorithm ``xwcpagc``
(wdsp/wcpAGC.c:161-342: lookahead ring, sliding attack-window max,
fast/hang back-averages, 5-state attack/fast-decay/hang/decay/hang-decay
machine, log-slope gain law), in numpy only.  ``ops.agc.WcpAGC`` takes its
constants from :class:`WcpParams` and must match the oracle's trajectory.
:func:`alc_oracle` models quisk's ``process_alc`` (microphone.c:270-358)
for ``ops.agc.TxALC``.  The port keeps its own copy of
``quisk_tpu.oracle.wcpagc`` (parameters, ``derived()`` and both oracles)
because it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WcpParams:
    """create_wcpagc parameters with the RXA defaults (wdsp/RXA.c:335-358,
    agcMED: hang_thresh=1.0, hangtime=0, tau_decay=0.25 per
    SetRXAAGCMode mode 3; the create-time row is mode MED with hang on)."""

    sample_rate: float = 48000.0
    tau_attack: float = 0.001
    tau_decay: float = 0.250
    n_tau: int = 4
    max_gain: float = 10000.0
    var_gain: float = 1.5
    max_input: float = 1.0
    out_targ: float = 1.0
    tau_fast_backaverage: float = 0.250
    tau_fast_decay: float = 0.005
    pop_ratio: float = 5.0
    hang_enable: bool = True
    tau_hang_backmult: float = 0.500
    hangtime: float = 0.250
    hang_thresh: float = 0.250
    tau_hang_decay: float = 0.100

    # ---- derived (loadWcpAGC, wcpAGC.c:115-146) --------------------------
    @property
    def attack_buffsize(self) -> int:
        return int(np.ceil(self.sample_rate * self.n_tau * self.tau_attack))

    def derived(self) -> dict:
        fs = self.sample_rate
        att = 1.0 - np.exp(-1.0 / (fs * self.tau_attack))
        dec = 1.0 - np.exp(-1.0 / (fs * self.tau_decay))
        fdec = 1.0 - np.exp(-1.0 / (fs * self.tau_fast_decay))
        fback = 1.0 - np.exp(-1.0 / (fs * self.tau_fast_backaverage))
        hback = 1.0 - np.exp(-1.0 / (fs * self.tau_hang_backmult))
        hdec = 1.0 - np.exp(-1.0 / (fs * self.tau_hang_decay))
        out_target = self.out_targ * (1.0 - np.exp(-float(self.n_tau))) * 0.9999
        min_volts = out_target / (self.var_gain * self.max_gain)
        tmp = np.log10(out_target / (self.max_input * self.var_gain
                                     * self.max_gain))
        slope = (out_target * (1.0 - 1.0 / self.var_gain)) / tmp
        t2 = 10.0 ** ((self.hang_thresh - 1.0) / 0.125)
        hang_level = (self.max_input * t2 + min_volts * (1.0 - t2)) * 0.637
        return dict(attack_mult=att, decay_mult=dec, fast_decay_mult=fdec,
                    fast_backmult=fback, hang_backmult=hback,
                    hang_decay_mult=hdec, out_target=out_target,
                    min_volts=min_volts, slope_constant=slope,
                    hang_level=hang_level,
                    hangtime_samples=int(self.hangtime * fs))


def wcpagc_oracle(x: np.ndarray, p: WcpParams | None = None
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the 5-state AGC over real audio x [N] -> (out [N], volts [N],
    states [N] int: 0 attack / 1 fast-decay / 2 hang / 3 decay /
    4 hang-decay).

    Sample-exact float64 model of xwcpagc (wcpAGC.c:161-342) with
    pmode=envelope on a real signal (abs), including the output delay of
    attack_buffsize samples.  The volts and state traces exist so
    conformance tests can pin the op to the machine's internal
    trajectory, not just its output.
    """
    p = p or WcpParams()
    d = p.derived()
    A = p.attack_buffsize
    N = len(x)
    env = np.abs(x)
    out = np.zeros(N)
    volts_trace = np.zeros(N)
    state_trace = np.zeros(N, np.int64)

    # lookahead window max: at step i the delayed output sample is x[i-A],
    # and the window holds env[i-A+1 .. i]
    volts = 0.0
    save_volts = 0.0
    fast_ba = 0.0
    hang_ba = 0.0
    hang_counter = 0
    state = 0
    decay_type = 0
    for i in range(N):
        out_sample = x[i - A] if i >= A else 0.0
        abs_out = env[i - A] if i >= A else 0.0
        lo = max(0, i - A + 1)
        ring_max = env[lo:i + 1].max() if i + 1 > lo else 0.0

        fast_ba = d["fast_backmult"] * abs_out + (1 - d["fast_backmult"]) * fast_ba
        hang_ba = d["hang_backmult"] * abs_out + (1 - d["hang_backmult"]) * hang_ba
        if hang_counter > 0:
            hang_counter -= 1

        if state == 0:
            if ring_max >= volts:
                volts += (ring_max - volts) * d["attack_mult"]
            elif volts > p.pop_ratio * fast_ba:
                state = 1
                volts += (ring_max - volts) * d["fast_decay_mult"]
            elif p.hang_enable and hang_ba > d["hang_level"]:
                state = 2
                hang_counter = d["hangtime_samples"]
                decay_type = 1
            else:
                state = 3
                volts += (ring_max - volts) * d["decay_mult"]
                decay_type = 0
        elif state == 1:
            if ring_max >= volts:
                state = 0
                volts += (ring_max - volts) * d["attack_mult"]
            elif volts > save_volts:
                volts += (ring_max - volts) * d["fast_decay_mult"]
            elif hang_counter > 0:
                state = 2
            elif decay_type == 0:
                state = 3
                volts += (ring_max - volts) * d["decay_mult"]
            else:
                state = 4
                volts += (ring_max - volts) * d["hang_decay_mult"]
        elif state == 2:
            if ring_max >= volts:
                state = 0
                save_volts = volts
                volts += (ring_max - volts) * d["attack_mult"]
            elif hang_counter == 0:
                state = 4
                volts += (ring_max - volts) * d["hang_decay_mult"]
        elif state == 3:
            if ring_max >= volts:
                state = 0
                save_volts = volts
                volts += (ring_max - volts) * d["attack_mult"]
            else:
                volts += (ring_max - volts) * d["decay_mult"]
        else:  # state 4
            if ring_max >= volts:
                state = 0
                save_volts = volts
                volts += (ring_max - volts) * d["attack_mult"]
            else:
                volts += (ring_max - volts) * d["hang_decay_mult"]

        volts = max(volts, d["min_volts"])
        mult = (d["out_target"] - d["slope_constant"]
                * min(0.0, np.log10(volts / p.max_input))) / volts
        out[i] = out_sample * mult
        volts_trace[i] = volts
        state_trace[i] = state
    return out, volts_trace, state_trace


def alc_oracle(x: np.ndarray, modes: np.ndarray,
               sample_rate: float = 48000.0, buf_ms: float = 20.0,
               clip_level: float = 1.0, gain_max: float = 3.0,
               gain_min: float = 0.1, double_secs: float = 5.0,
               n_modes: int = 14, min_magn: float = 100.0 / 32758.0
               ) -> tuple[np.ndarray, np.ndarray]:
    """process_alc (microphone.c:270-358) on real/complex audio x [N] with
    a per-sample mode id [N] -> (out [N], gain_now trace [N]).

    Levels are normalized to 1.0 full scale (the reference works at
    CLIP16=32767 with a 10-count margin and a 100-count silence floor).
    """
    A = int(sample_rate * buf_ms / 1000.0)
    target = clip_level * (32767.0 - 10.0) / 32767.0
    N = len(x)
    buffer = np.zeros(A, dtype=np.asarray(x).dtype)
    gain_now = np.ones(n_modes)
    gain_change = 0.0
    final_gain = 0.0
    next_change = 1e10
    counter = 0
    fault = 0
    index = 0
    block_index = 0
    out = np.zeros(N, dtype=np.asarray(x).dtype)
    gtrace = np.zeros(N)
    d_limit = 1.0 / (48000.0 * double_secs)
    for i in range(N):
        m = int(modes[i])
        csamp = x[i]
        out[i] = buffer[index] * gain_now[m]
        buffer[index] = csamp
        magn = abs(csamp)
        if magn * (gain_now[m] + gain_change * A) > target:
            gain_change = (target / magn - gain_now[m]) / A
            final_gain = np.clip(gain_now[m] + gain_change * A,
                                 gain_min, gain_max)
            gain_change = (final_gain - gain_now[m]) / A
            block_index = index
            counter = 0
            fault = 0
            next_change = 1e10
        elif index == block_index:
            if next_change > d_limit:
                next_change = d_limit
            if next_change != 1e10 and fault < A - 10:
                gain_change = next_change
            final_gain = np.clip(gain_now[m] + gain_change * A,
                                 gain_min, gain_max)
            gain_change = (final_gain - gain_now[m]) / A
            fault = 0
            counter = 0
            next_change = 1e10
        else:
            if magn < min_magn:
                fault += 1
            else:
                counter += 1
                d = (target / magn - final_gain) / counter
                if next_change > d:
                    next_change = d
        gain_now[m] += gain_change
        gtrace[i] = gain_now[m]
        index += 1
        if index >= A:
            index = 0
    return out, gtrace
