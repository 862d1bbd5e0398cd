"""Diversity reception: phase/gain-weighted combining of receiver pairs.

Counterpart of ``quisk_tpu.ops.diversity``.  Parity: wdsp/div.c — a
"phase rotator" that combines two coherent RX streams with a complex
weight set from gain/phase knobs, used to steer a null onto local
interference.  The weight estimators (max-SNR principal eigenvector,
null-steering minimum eigenvector of the 2x2 spatial covariance) are host
numpy, called now and then, not per block; the combine is two complex
products a sample, elementwise on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DiversityCombiner:
    """Combine ``[C, 2, B]`` coherent stream pairs into ``[C, B]``.

    Weights are data (``set_weights`` returns a new combiner).  Weight
    convention: y = w0*x0 + w1*x1 with |w0|^2 + |w1|^2 = 1 (noise-power
    preserving).  The weights are kept as (re, im) float32 planes [C, 2],
    as in the reference."""

    w_re: torch.Tensor
    w_im: torch.Tensor

    @classmethod
    def create(cls, channels: int, gain: float = 1.0, phase_deg: float = 0.0,
               device=None):
        device = resolve_device(device)
        w = np.stack([np.ones(channels, np.complex64),
                      (gain * np.exp(1j * np.deg2rad(phase_deg))
                       * np.ones(channels)).astype(np.complex64)], axis=1)
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        return cls(w_re=torch.as_tensor(w.real.astype(np.float32),
                                        device=device),
                   w_im=torch.as_tensor(w.imag.astype(np.float32),
                                        device=device))

    def set_weights(self, w: np.ndarray) -> "DiversityCombiner":
        w = np.asarray(w, np.complex128)
        w = w / np.linalg.norm(w, axis=1, keepdims=True)
        dev = self.w_re.device
        return dataclasses.replace(
            self, w_re=torch.as_tensor(w.real.astype(np.float32), device=dev),
            w_im=torch.as_tensor(w.imag.astype(np.float32), device=dev))

    def init_state(self, channels: int):
        return ()

    def __call__(self, state, x: torch.Tensor):
        """x [C, 2, B] complex -> (state, y [C, B])."""
        w = torch.complex(self.w_re, self.w_im)[:, :, None]      # [C, 2, 1]
        return state, w[:, 0] * x[:, 0] + w[:, 1] * x[:, 1]


def _covariance(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x)
    return np.einsum("cpb,cqb->cpq", x, np.conj(x)) / x.shape[-1]


def _w0_real(w: np.ndarray) -> np.ndarray:
    """Fix the eigenvector's arbitrary phase: w0 real and positive."""
    ph = w[:, :1] / np.maximum(np.abs(w[:, :1]), 1e-12)
    return (w * np.conj(ph)).astype(np.complex64)


def estimate_max_snr_weights(x: np.ndarray) -> np.ndarray:
    """[C, 2] combining weights maximising output power from a signal
    snapshot ``x [C, 2, B]``: the principal eigenvector of the 2x2 spatial
    covariance per channel (host numpy)."""
    _, vecs = np.linalg.eigh(_covariance(x))    # ascending eigenvalues
    return _w0_real(np.conj(vecs[:, :, -1]))    # conj of the steering vec


def null_steering_weights(x_interf: np.ndarray) -> np.ndarray:
    """[C, 2] weights placing a null on the interference captured in
    ``x_interf [C, 2, B]``: the minimum-power eigenvector (div.c's manual
    null steering, done adaptively; host numpy)."""
    _, vecs = np.linalg.eigh(_covariance(x_interf))
    return _w0_real(np.conj(vecs[:, :, 0]))
