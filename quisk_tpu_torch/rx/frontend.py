"""Raw-IQ front-end conditioning: channel delay, I/Q balance, DC removal,
spectrum inversion.

The reference's capture-side sample correction, applied to the raw IQ
stream ahead of the noise blanker and the tuner:

- one-sample I-or-Q rail delay ``delay_sample`` (sound.c:143-169) for
  sound cards that skew the two rails by one frame;
- amplitude/phase balance ``correct_sample`` (sound.c:171-186):
  ``re' = A*re;  im' = C*re + D*im`` with ``A = 1/(1+ampl)``,
  ``C = -A*tan(phi)``, ``D = 1/cos(phi)`` from the GUI's ampl fraction and
  phase in degrees (sound.c:1565-1581), the image-reject trim;
- DC removal ``DCremove`` (sound.c:188-253): bw == 1 averages the samples
  over 2 s windows (gated off for 1 s after key-down) and subtracts the
  average; bw > 1 is the Lyons one-pole DC blocker
  ``c = x + alpha*dc; y = c - dc; dc = c`` with alpha from the reference's
  half-power formula;
- spectrum inversion (quisk.c:2442-2446): ``x = conj(x)``.

The trim is per-channel data; the DC mode and bandwidth are fixed at
``create``.  The balance matrix and the inversion compose into one 2x2 per
channel (inversion negates the second row; the real per-rail DC filter
commutes with both).  The bw > 1 blocker runs as the blocked-matmul
``ew_cumsum`` (ops/ewscan.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.ewscan import ew_cumsum


def dc_alpha(bw_hz: int, sample_rate: float) -> float:
    """The reference's DC-blocker pole (sound.c:202-215)."""
    omega = np.pi * bw_hz / (sample_rate / 2.0)
    qsin, qcos = np.sin(omega), np.cos(omega)
    h0 = 1.0 / np.sqrt(2.0)
    x = ((qcos - 1.0) ** 2 + qsin ** 2) / h0 ** 2 - qsin ** 2
    return float(qcos - np.sqrt(x))


def balance_matrix(ampl: float, phase_deg: float, invert: bool):
    """(m00, m10, m11): the rows of the composed balance + inversion 2x2."""
    if ampl == 0.0 and phase_deg == 0.0:
        a, c, d = 1.0, 0.0, 1.0
    else:
        g = 1.0 + ampl                       # factor 0.01 -> 1.01
        phi = np.deg2rad(phase_deg)
        a = 1.0 / g
        c = -a * np.tan(phi)
        d = 1.0 / np.cos(phi)
    s = -1.0 if invert else 1.0
    return a, s * c, s * d


@dataclasses.dataclass(frozen=True)
class FrontConditioner:
    """delay -> balance (+ inversion) -> DC removal on raw [C, B] IQ.

    State: ``last_i`` / ``last_q`` [C]; in ``hp`` mode ``dc_re`` / ``dc_im``
    [C]; in ``avg`` mode ``avg_*`` / ``sum_*`` [C] and the 0-dim int32
    counters ``count`` and ``key_delay``."""

    channels: int
    dc_mode: str               # off | avg | hp
    sample_rate: float
    dc_a: float                # hp-mode pole
    m00: torch.Tensor          # [C, 1]
    m10: torch.Tensor
    m11: torch.Tensor
    delay_sel: torch.Tensor    # [C, 1] int32: 0 none, 1 I, 2 Q

    @classmethod
    def create(cls, channels: int, sample_rate: float, ampl: float = 0.0,
               phase_deg: float = 0.0, invert: bool = False, delay: int = 0,
               dc_bw: int = 0, device=None):
        device = resolve_device(device)
        mode = "off" if dc_bw <= 0 else ("avg" if dc_bw == 1 else "hp")
        a = dc_alpha(dc_bw, sample_rate) if mode == "hp" else 0.0
        one = torch.ones((channels, 1), dtype=torch.float32, device=device)
        new = cls(channels=channels, dc_mode=mode, sample_rate=sample_rate,
                  dc_a=a, m00=one, m10=torch.zeros_like(one), m11=one,
                  delay_sel=torch.full((channels, 1), int(delay),
                                       dtype=torch.int32, device=device))
        return new.with_balance(ampl, phase_deg, invert)

    def with_balance(self, ampl, phase_deg, invert=False, channel=None):
        """Data-only update of the trim (all channels, or one)."""
        vals = balance_matrix(ampl, phase_deg, invert)
        new = {}
        for name, v in zip(("m00", "m10", "m11"), vals):
            old = getattr(self, name)
            if channel is None:
                new[name] = torch.full_like(old, v)
            else:
                new[name] = old.clone()
                new[name][channel, 0] = v
        return dataclasses.replace(self, **new)

    # --------------------------------------------------------------- state
    def init_state(self, channels: int):
        dev = self.m00.device

        def z():
            return torch.zeros((channels,), dtype=torch.float32, device=dev)

        st = {"last_i": z(), "last_q": z()}
        if self.dc_mode == "hp":
            st.update(dc_re=z(), dc_im=z())
        elif self.dc_mode == "avg":
            st.update(avg_re=z(), avg_im=z(), sum_re=z(), sum_im=z(),
                      count=torch.zeros((), dtype=torch.int32, device=dev),
                      key_delay=torch.zeros((), dtype=torch.int32,
                                            device=dev))
        return st

    # ---------------------------------------------------------------- step
    def __call__(self, state, x: torch.Tensor, key_down=False):
        st = dict(state)
        re, im = x.real, x.imag
        B = x.shape[-1]

        # one-sample rail delay (sound.c:143): shift the selected rail
        re_d = torch.cat([st["last_i"][:, None], re[:, :-1]], dim=-1)
        im_d = torch.cat([st["last_q"][:, None], im[:, :-1]], dim=-1)
        st["last_i"] = re[:, -1]
        st["last_q"] = im[:, -1]
        re = torch.where(self.delay_sel == 1, re_d, re)
        im = torch.where(self.delay_sel == 2, im_d, im)

        # balance + inversion as one per-channel 2x2 (sound.c:180)
        re, im = self.m00 * re, self.m10 * re + self.m11 * im

        if self.dc_mode == "hp":
            # dc[n] = x[n] + alpha*dc[n-1]; y[n] = dc[n] - dc[n-1]
            dre = ew_cumsum(re, self.dc_a, st["dc_re"])
            dim = ew_cumsum(im, self.dc_a, st["dc_im"])
            re = dre - torch.cat([st["dc_re"][:, None], dre[:, :-1]], dim=-1)
            im = dim - torch.cat([st["dc_im"][:, None], dim[:, :-1]], dim=-1)
            st["dc_re"] = dre[:, -1]
            st["dc_im"] = dim[:, -1]
        elif self.dc_mode == "avg":
            # (sound.c:221-244) freeze and reset while the key is down,
            # hold 1 s, then average 2 s windows; always subtract the
            # current average.  The counters stay int32 tensors, so the
            # step reads nothing back from the device.
            dev = x.device
            key = torch.as_tensor(key_down, dtype=torch.bool, device=dev)
            rate = int(self.sample_rate)
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            izero = torch.zeros((), dtype=torch.int32, device=dev)
            settling = st["key_delay"] < rate
            st["key_delay"] = torch.where(
                key, izero, torch.where(settling, st["key_delay"] + B,
                                        st["key_delay"]))
            acc = ~key & ~settling
            sum_re = st["sum_re"] + torch.where(acc, re.sum(-1), zero)
            sum_im = st["sum_im"] + torch.where(acc, im.sum(-1), zero)
            count = st["count"] + torch.where(acc, izero + B, izero)
            full = count > 2 * rate
            st["avg_re"] = torch.where(full, sum_re / count, st["avg_re"])
            st["avg_im"] = torch.where(full, sum_im / count, st["avg_im"])
            reset = key | full
            st["sum_re"] = torch.where(reset, zero, sum_re)
            st["sum_im"] = torch.where(reset, zero, sum_im)
            st["count"] = torch.where(reset, izero, count)
            re = re - st["avg_re"][:, None]
            im = im - st["avg_im"][:, None]

        return st, torch.complex(re, im)
