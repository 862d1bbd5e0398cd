"""Streaming FIR filters for ``[channels, block]`` batches.

- :class:`OverlapSaveFIR`: frequency-domain FIR (FFT the block plus
  carried history, multiply by a mask, IFFT, drop the wrap-around
  prefix) — the channel filter (quisk.c:1182-1256, wdsp/firmin.c).  The
  mask is data: retuning is a tensor swap.
- :class:`MatmulFIR` / :class:`HalfbandFIR`: real-tap decimators as
  blocked-Toeplitz fp32 matmuls (patches of K = R*decim + T - 1 samples
  times a [K, R] tap matrix); the half-band form contracts only the odd
  phase and adds the center tap.
- :class:`ConvFIR`: a valid strided convolution as an unfold plus fp32
  matmul (no cuDNN, so no TF32 on the path).
- :class:`PartitionedOLS`: uniformly-partitioned overlap-save (WDSP
  FIRCORE, wdsp/firmin.c:128-435) — one 2*block FFT a block and a
  frequency-domain delay line, one block of latency for any tap count.

All carry the last ``ntaps-1`` input samples, so streaming a signal block
by block equals filtering it whole.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _mask(taps: np.ndarray, nfft: int) -> np.ndarray:
    mask = np.fft.fft(taps.astype(np.complex128), n=nfft, axis=-1
                      ).astype(np.complex64)
    return mask[0] if mask.shape[0] == 1 else mask


def _stack_iq(xe: torch.Tensor) -> torch.Tensor:
    """[C, L] complex -> [C, 2, L] float32 (I/Q on a new axis 1)."""
    return torch.stack([xe.real, xe.imag], dim=1).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class OverlapSaveFIR:
    """Overlap-save frequency-domain FIR, optionally decimating.

    The mask is ``[nfft]`` (shared) or ``[channels, nfft]`` (per channel).
    """

    mask: torch.Tensor                                  # complex64
    ntaps: int
    block: int
    nfft: int
    decim: int = 1

    @classmethod
    def create(cls, taps, block: int, decim: int = 1, nfft: int | None = None,
               device=None):
        device = resolve_device(device)
        taps = np.atleast_2d(np.asarray(taps))          # [F, T]
        ntaps = taps.shape[-1]
        if block % decim:
            raise ValueError(f"block {block} not divisible by decim {decim}")
        if nfft is None:
            nfft = _next_pow2(block + ntaps - 1)
        if nfft < block + ntaps - 1:
            raise ValueError("nfft too small for overlap-save validity")
        return cls(mask=torch.as_tensor(_mask(taps, nfft), device=device),
                   ntaps=ntaps, block=block, nfft=nfft, decim=decim)

    def retuned(self, taps) -> "OverlapSaveFIR":
        """Same engine, new taps — a tensor swap, shapes unchanged."""
        taps = np.atleast_2d(np.asarray(taps))
        if taps.shape[-1] != self.ntaps:
            raise ValueError("retune must keep tap count (shapes are static)")
        return dataclasses.replace(self, mask=torch.as_tensor(
            _mask(taps, self.nfft), device=self.mask.device))

    def retune_crossfade(self, taps, nblocks: int = 4):
        """Click-free retune: ``nblocks`` ops whose masks blend linearly
        from the current response to the new one (the output is linear in
        the mask, so this crossfades the audio; wdsp/firmin.c:322-346)."""
        new = self.retuned(taps)
        old_m = self.mask.cpu().numpy()
        new_m = new.mask.cpu().numpy()
        out = []
        for k in range(1, nblocks + 1):
            a = k / nblocks
            m = ((1.0 - a) * old_m + a * new_m).astype(np.complex64)
            out.append(dataclasses.replace(
                self, mask=torch.as_tensor(m, device=self.mask.device)))
        return out

    def init_state(self, channels: int):
        return torch.zeros((channels, self.ntaps - 1), dtype=torch.complex64,
                           device=self.mask.device)

    def __call__(self, hist: torch.Tensor, x: torch.Tensor):
        """hist [C, ntaps-1], x [C, block] -> (hist', y [C, block/decim])."""
        xe = torch.cat([hist, x.to(torch.complex64)], dim=-1)
        X = torch.fft.fft(xe, n=self.nfft, dim=-1)
        y = torch.fft.ifft(X * self.mask, dim=-1)
        y = y[..., self.ntaps - 1:self.ntaps - 1 + self.block]
        if self.decim > 1:
            y = y[..., ::self.decim]
        return xe[..., xe.shape[-1] - (self.ntaps - 1):], y


@dataclasses.dataclass(frozen=True)
class PartitionedOLS:
    """Uniformly-partitioned overlap-save FIR (WDSP FIRCORE parity:
    wdsp/firmin.c:128-286 and 290-435).

    The impulse response is split into P block-sized partitions.  Each
    step FFTs one 2*block segment ([previous block | current block]),
    pushes its spectrum into a frequency-domain delay line (FDL) and sums
    FDL[p] * H[p] over the partitions, so a 10001-tap filter at a
    512-sample block costs a 1024-point FFT a block where
    :class:`OverlapSaveFIR` takes one 16384-point FFT, and the output
    latency is one block for any filter length.  The partition spectra are
    data ([P, nfft], or [C, P, nfft] per channel): retuning is a tensor
    swap.  Streaming output equals OverlapSaveFIR's with the same taps, up
    to float association.

    State: (previous input block [C, block], FDL [C, P, nfft] newest
    first), complex64 tensors on the op's device."""

    H: torch.Tensor                  # [P, nfft] or [C, P, nfft] complex64
    ntaps: int
    block: int
    nfft: int
    P: int
    decim: int = 1

    @classmethod
    def create(cls, taps, block: int, decim: int = 1, device=None):
        device = resolve_device(device)
        taps = np.atleast_2d(np.asarray(taps))           # [F, T]
        F, ntaps = taps.shape
        if block % decim:
            raise ValueError(f"block {block} not divisible by decim {decim}")
        P = -(-ntaps // block)
        nfft = 2 * block
        padded = np.zeros((F, P * block), np.complex128)
        padded[:, :ntaps] = taps
        H = np.fft.fft(padded.reshape(F, P, block), n=nfft,
                       axis=-1).astype(np.complex64)
        if F == 1:
            H = H[0]                                     # [P, nfft]
        return cls(H=torch.as_tensor(H, device=device), ntaps=ntaps,
                   block=block, nfft=nfft, P=P, decim=decim)

    def retuned(self, taps) -> "PartitionedOLS":
        """Same engine, new taps — a tensor swap, shapes unchanged."""
        taps = np.atleast_2d(np.asarray(taps))
        if taps.shape[-1] != self.ntaps:
            raise ValueError("retune must keep tap count (shapes are static)")
        new = PartitionedOLS.create(taps, self.block, self.decim,
                                    device=self.H.device)
        return dataclasses.replace(self, H=new.H)

    def init_state(self, channels: int):
        dev = self.H.device
        return (torch.zeros((channels, self.block), dtype=torch.complex64,
                            device=dev),
                torch.zeros((channels, self.P, self.nfft),
                            dtype=torch.complex64, device=dev))

    def __call__(self, state, x: torch.Tensor):
        """state, x [C, block] -> (state', y [C, block/decim])."""
        prev, fdl = state
        seg = torch.cat([prev, x.to(torch.complex64)], dim=-1)
        X = torch.fft.fft(seg, n=self.nfft, dim=-1)      # [C, nfft]
        fdl = torch.cat([X[:, None, :], fdl[:, :-1, :]], dim=1)
        Y = torch.sum(fdl * self.H, dim=-2)              # [C, nfft]
        y = torch.fft.ifft(Y, dim=-1)[..., self.block:]
        if self.decim > 1:
            y = y[..., ::self.decim]
        return (seg[..., self.block:], fdl), y


@dataclasses.dataclass(frozen=True)
class ConvFIR:
    """Time-domain streaming FIR with integer output stride (decimation):
    y[n] = sum_k taps[k] * xe[n*decim + T-1 - k], valid positions only."""

    h_rev: torch.Tensor                                # [T] f32 or c64
    ntaps: int
    block: int
    decim: int = 1
    complex_state: bool = True      # False: real float32 history and I/O

    @classmethod
    def create(cls, taps, block: int, decim: int = 1,
               complex_state: bool = True, device=None):
        device = resolve_device(device)
        taps = np.asarray(taps)
        if block % decim:
            raise ValueError(f"block {block} not divisible by decim {decim}")
        dt = np.complex64 if np.iscomplexobj(taps) else np.float32
        h_rev = np.ascontiguousarray(taps[::-1]).astype(dt)
        return cls(h_rev=torch.as_tensor(h_rev, device=device),
                   ntaps=taps.shape[-1], block=block, decim=decim,
                   complex_state=complex_state)

    def init_state(self, channels: int):
        dt = torch.complex64 if self.complex_state else torch.float32
        return torch.zeros((channels, self.ntaps - 1), dtype=dt,
                           device=self.h_rev.device)

    def __call__(self, hist: torch.Tensor, x: torch.Tensor):
        xe = torch.cat([hist, x.to(hist.dtype)], dim=-1)
        new_hist = xe[..., xe.shape[-1] - (self.ntaps - 1):]
        h = self.h_rev
        if h.is_complex():
            y = torch.matmul(xe.to(h.dtype).unfold(-1, self.ntaps,
                                                   self.decim), h)
        elif not xe.is_complex():
            y = torch.matmul(xe.unfold(-1, self.ntaps, self.decim), h)
        else:
            y = torch.matmul(_stack_iq(xe).unfold(-1, self.ntaps, self.decim),
                             h)
            y = torch.complex(y[:, 0], y[:, 1])
        return new_hist, y


def banded_taps(h_rev: torch.Tensor, R: int, step: int) -> torch.Tensor:
    """[R*step + T - 1, R] band: column r holds h_rev at row offset r*step
    (the blocked-Toeplitz tap matrix of a decimating FIR)."""
    T = h_rev.shape[0]
    dev = h_rev.device
    M = torch.zeros((R * step + T - 1, R), dtype=h_rev.dtype, device=dev)
    rows = (torch.arange(T, device=dev)[:, None]
            + step * torch.arange(R, device=dev)[None, :])
    M[rows, torch.arange(R, device=dev)[None, :]] = h_rev[:, None]
    return M


def _h32(taps: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(taps).astype(np.float32),
                           device=device)


@dataclasses.dataclass(frozen=True)
class MatmulFIR:
    """Decimating FIR as a blocked-Toeplitz matmul: overlapping patches of
    K = R*decim + T - 1 samples times the [K, R] matrix
    ``M[k, r] = h_rev[k - r*decim]``.  Real taps; I/Q ride as two rows."""

    M: torch.Tensor                                      # [K, R] float32
    ntaps: int
    block: int
    decim: int
    R: int

    @classmethod
    def create(cls, taps, block: int, decim: int = 1, R: int = 128,
               device=None):
        device = resolve_device(device)
        taps = np.asarray(taps)
        if np.iscomplexobj(taps):
            raise ValueError("MatmulFIR takes real taps (use OLS for complex)")
        taps = taps.astype(np.float64)
        n_out = block // decim
        while n_out % R:
            R //= 2
        M = banded_taps(_h32(taps[::-1], device), R, decim)
        return cls(M=M, ntaps=taps.shape[-1],
                   block=block, decim=decim, R=R)

    def init_state(self, channels: int):
        return torch.zeros((channels, self.ntaps - 1), dtype=torch.complex64,
                           device=self.M.device)

    def __call__(self, hist: torch.Tensor, x: torch.Tensor):
        """hist [C, T-1], x [C, B] -> (hist', y [C, B/decim])."""
        xe = torch.cat([hist, x], dim=-1)
        new_hist = xe[..., xe.shape[-1] - (self.ntaps - 1):]
        C = x.shape[0]
        K = self.M.shape[0]
        patches = _stack_iq(xe).unfold(-1, K, self.R * self.decim)
        y = torch.matmul(patches, self.M).reshape(C, 2, -1)
        return new_hist, torch.complex(y[:, 0], y[:, 1])


@dataclasses.dataclass(frozen=True)
class HalfbandFIR:
    """Decimate-by-2 half-band FIR as a polyphase matmul: only the odd
    taps and the center are nonzero (filter.c:377-417), so

        y[j] = sum_m h[2m+1] * xe[2j + 2c - 2m - 1]  +  h[c] * xe[2j + c]

    with c = T // 2 — half the work of the dense MatmulFIR."""

    Mg: torch.Tensor                     # [R + c - 1, R] odd-phase taps
    center: torch.Tensor                 # 0-dim center tap
    ntaps: int
    block: int
    R: int
    decim: int = 2

    @staticmethod
    def is_halfband(taps: np.ndarray) -> bool:
        taps = np.asarray(taps)
        T = taps.shape[-1]
        if taps.ndim != 1 or T % 4 != 1 or np.iscomplexobj(taps):
            return False
        c = T // 2
        even = taps[::2]
        return bool(np.all(even[np.arange(even.shape[0]) != c // 2] == 0.0)
                    and taps[c] != 0.0)

    @classmethod
    def create(cls, taps, block: int, R: int = 128, device=None):
        device = resolve_device(device)
        taps = np.asarray(taps, np.float64)
        T = taps.shape[-1]
        c = T // 2
        n_out = block // 2
        while n_out % R:
            R //= 2
        Mg = banded_taps(_h32(taps[1::2][::-1], device), R, 1)
        return cls(Mg=Mg,
                   center=torch.tensor(np.float32(taps[c]), device=device),
                   ntaps=T, block=block, R=R)

    def init_state(self, channels: int):
        return torch.zeros((channels, self.ntaps - 1), dtype=torch.complex64,
                           device=self.Mg.device)

    def __call__(self, hist: torch.Tensor, x: torch.Tensor):
        xe = torch.cat([hist, x], dim=-1)
        new_hist = xe[..., xe.shape[-1] - (self.ntaps - 1):]
        C = x.shape[0]
        c = self.ntaps // 2
        n_out = self.block // 2
        lhs = _stack_iq(xe)
        even = lhs[..., ::2]                             # e[p] = xe[2p]
        odd = lhs[..., 1::2]                             # o[p] = xe[2p+1]
        patches = odd.unfold(-1, self.Mg.shape[0], self.R)
        y = torch.matmul(patches, self.Mg).reshape(C, 2, -1)
        y = y + self.center * even[..., c // 2: c // 2 + n_out]
        return new_hist, torch.complex(y[:, 0], y[:, 1])


def make_fir(taps, block: int, decim: int = 1, method: str = "auto",
             device=None):
    """Pick the FIR engine: polyphase matmul for half-band /2 stages,
    Toeplitz matmul for other real-tap decimators, a strided valid
    convolution for short kernels, overlap-save for long complex ones."""
    taps = np.asarray(taps)
    if method == "auto":
        if decim == 2 and HalfbandFIR.is_halfband(taps):
            method = "halfband"
        elif not np.iscomplexobj(taps) and decim > 1:
            method = "matmul"
        else:
            method = "conv" if taps.shape[-1] <= 192 or decim > 4 else "ols"
    if method == "halfband":
        return HalfbandFIR.create(taps, block, device=device)
    if method == "matmul":
        return MatmulFIR.create(taps, block, decim, device=device)
    if method == "conv":
        return ConvFIR.create(taps, block, decim, device=device)
    if method == "ols":
        return OverlapSaveFIR.create(taps, block, decim, device=device)
    raise ValueError(f"unknown FIR method {method!r}")
