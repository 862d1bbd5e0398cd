"""Carry parameters and state across from ``quisk_tpu`` as numpy arrays.

The JAX package's objects are flattened by the caller (``np.asarray`` of
their leaves) into plain dictionaries of numpy arrays; this module turns
those into the port's objects and converts chain state both ways, so both
packages compute the same thing from the same numbers.  It imports
neither JAX nor the JAX package.

Phases: uint32 arrays on the numpy side, int64 tensors holding the same
values in the port.  Every int64 tensor in the port's chain state is such
a phase; the counters of the squelches, of the hang AGCs and of the raw-IQ
conditioner are int32 on both sides and pass unchanged.

The PFB channelizers' states need no function of their own:
:func:`state_from_numpy` / :func:`state_to_numpy` carry the complex64
history, the grouped demod's per-run tuples (empty for SSB runs) and the
kernel route's [S, 5*K1, K2] carry (rows zr, zi, y_de, env, y_dc on both
sides) as they are.

TX state: the reference keeps three complex leaves as host numpy
complex64 at init, because complex64 cannot cross its device boundary:
the ALC's delay line (``alc["buffer"]``), the interpolator's history
(``interp``) and the EER splitter's delay line.  In the port all three are
complex64 tensors on the chain's device from the start; here they cross
as numpy complex64 arrays both ways, like every other leaf, and the TX
tune phase as uint32 <-> int64.  The spectrum analyzer's overlapped mode
carries its trailing samples as (re, im) float32 planes in the reference
and as one complex64 tensor in the port
(:func:`spectrum_state_from_numpy`).

The remaining DSP ops (:func:`sync_am_from_numpy`,
:func:`pll_fm_from_numpy`, :func:`snb_from_numpy`,
:func:`partitioned_ols_from_numpy`, :func:`diversity_from_numpy`) keep the
reference's state layouts, so :func:`state_from_numpy` carries their
states: the PLLs' float32 vectors (and PLLFMDemod's notch tuple, empty
without the notch), the spectral blanker's six float32 arrays, and
PartitionedOLS's previous block and FDL, which the reference keeps as
host numpy complex64 and the port as complex64 tensors.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from quisk_tpu_torch._device import resolve_device
from quisk_tpu_torch.ops.agc import AGC, TxALC, WcpAGC
from quisk_tpu_torch.ops.channelizer import (OversampledPFB, PFBChannelizer,
                                             PFBRxPipeline)
from quisk_tpu_torch.ops.demod import (AMDemod, FMDemod, GroupedDemod,
                                       GroupedDemodTM, MixedDemod, PLLFMDemod,
                                       SSBDemod)
from quisk_tpu_torch.ops.diversity import DiversityCombiner
from quisk_tpu_torch.ops.compress import OvershootControl, SoftCompressor
from quisk_tpu_torch.ops.fir import (ConvFIR, OverlapSaveFIR, PartitionedOLS,
                                     make_fir)
from quisk_tpu_torch.ops.fused_front import FusedTuneDecimate
from quisk_tpu_torch.ops.iir import (Biquad, DCBlock, OnePole, PhaseRotator,
                                     Preemphasis)
from quisk_tpu_torch.ops.nco import NCO, phase_tensor
from quisk_tpu_torch.ops.noise import (AutoNotch, NoiseBlanker,
                                      SpectralNoiseBlanker)
from quisk_tpu_torch.ops.nr import BlockLMS, SpectralNR, SyncAMDemod
from quisk_tpu_torch.ops.resample import FracDecim, Interpolator
from quisk_tpu_torch.ops.spectrum import SpectrumAnalyzer
from quisk_tpu_torch.ops.squelch import FMSquelch, SSBSquelch
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.rx.chain import RxChain
from quisk_tpu_torch.rx.frontend import FrontConditioner
from quisk_tpu_torch.tx.chain import TxChain
from quisk_tpu_torch.tx.puresignal import Predistorter


def state_from_numpy(tree, device=None):
    """Nested tuples/lists/dicts of numpy arrays -> the same of tensors
    (uint32 phases become int64)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_from_numpy(v, device) for v in tree)
    a = np.asarray(tree)
    if a.dtype == np.uint32:
        return phase_tensor(a, device)
    return torch.as_tensor(a.copy(), device=device)


def state_to_numpy(tree):
    """Inverse of :func:`state_from_numpy` (int64 phases become uint32)."""
    if isinstance(tree, dict):
        return {k: state_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(state_to_numpy(v) for v in tree)
    a = tree.detach().cpu().numpy()
    return a.astype(np.uint32) if a.dtype == np.int64 else a


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(np.asarray(v)), device=device)


def _f32_vec(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32).copy(), device=device)


def fused_front_from_numpy(p: dict, device=None) -> FusedTuneDecimate:
    """{"taps" [T] (forward order), "word" [C] uint32, "decim", "block"}
    and, optionally, "nb_detect" ({"avg_win", "kwidth"})."""
    device = resolve_device(device)
    taps = np.asarray(p["taps"], np.float64)
    op = FusedTuneDecimate.create(taps, 0.0, 1.0, int(p["block"]),
                                  int(p["decim"]), len(p["word"]),
                                  nb_detect=p.get("nb_detect"),
                                  device=device)
    return op.with_word(p["word"])


def _demods_from_numpy(d: dict, device):
    """(SSBDemod, AMDemod, FMDemod) from {"ssb_gain", "am_gain", "am_pole",
    "fm_gain", "fm_a", "fm_b"}."""
    return (SSBDemod(gain=_f32(d["ssb_gain"], device)),
            AMDemod(dc=DCBlock(a=_f32(d["am_pole"], device)),
                    gain=_f32(d["am_gain"], device)),
            FMDemod(deemph=OnePole(a=_f32(d["fm_a"], device),
                                   b=_f32(d["fm_b"], device)),
                    gain=_f32(d["fm_gain"], device)))


def _runs(runs) -> tuple:
    return tuple((str(f), int(lo), int(hi)) for f, lo, hi in runs)


def grouped_demod_from_numpy(d: dict, device=None) -> GroupedDemod:
    """{"runs": ((family, lo, hi), ...)} and the keys of
    :func:`_demods_from_numpy`."""
    device = resolve_device(device)
    ssb, am, fm = _demods_from_numpy(d, device)
    return GroupedDemod(ssb=ssb, am=am, fm=fm, runs=_runs(d["runs"]))


def grouped_demod_tm_from_numpy(d: dict, device=None) -> GroupedDemodTM:
    """The keys of :func:`grouped_demod_from_numpy` (``am_dc.a`` as
    "am_pole", ``fm_deemph.a/b`` as "fm_a" / "fm_b")."""
    device = resolve_device(device)
    ssb, am, fm = _demods_from_numpy(d, device)
    return GroupedDemodTM(am_dc=am.dc, fm_deemph=fm.deemph,
                          ssb_gain=ssb.gain, am_gain=am.gain,
                          fm_gain=fm.gain, runs=_runs(d["runs"]))


def pfb_from_numpy(p: dict, device=None):
    """A PFBChannelizer ("oversampled" false or absent) or OversampledPFB
    from {"h_poly" [P, K], "block", "pallas_poly", "oversampled"}."""
    device = resolve_device(device)
    h = np.asarray(p["h_poly"], np.float32)
    cls = OversampledPFB if p.get("oversampled") else PFBChannelizer
    return cls(h_poly=torch.as_tensor(h.copy(), device=device),
               n_chan=h.shape[1], P=h.shape[0], block=int(p["block"]),
               pallas_poly=bool(p.get("pallas_poly", False)))


def pfb_pipeline_from_numpy(p: dict, device=None) -> PFBRxPipeline:
    """A PFBRxPipeline from {"pfb" (:func:`pfb_from_numpy`), "demod"
    (:func:`grouped_demod_tm_from_numpy`), "with_spectrum"} and, for the
    kernel route, "kd": the JAX pipeline's tuple (w1x, (twr, twi), (w2r,
    w2i, w2s), am mask, fm mask, tdc, tde, dec) as numpy arrays.  The
    one-pole coefficients are read from ``dec`` (its first row holds a_dc
    and a_de); the triangular matrices and ``w2s`` are not carried."""
    device = resolve_device(device)
    pfb = pfb_from_numpy({**p["pfb"], "oversampled": True}, device)
    demod = grouped_demod_tm_from_numpy(p["demod"], device)
    spectrum = bool(p.get("with_spectrum", True))
    if p.get("kd") is None:
        return PFBRxPipeline(pfb=pfb, demod=demod, with_spectrum=spectrum)
    w1x, (twr, twi), (w2r, w2i, _), am_m, fm_m, _, _, dec = p["kd"]
    dec = np.asarray(dec, np.float32)
    kd = (_f32_vec(w1x, device), (_f32_vec(twr, device),
                                  _f32_vec(twi, device)),
          (_f32_vec(w2r, device), _f32_vec(w2i, device)),
          _f32_vec(am_m, device), _f32_vec(fm_m, device))
    return PFBRxPipeline(
        pfb=pfb, demod=demod, kd=kd, with_spectrum=spectrum,
        pallas_demod=True, K1=np.asarray(twr).shape[0],
        g_ssb=float(demod.ssb_gain), g_am=float(demod.am_gain),
        g_fm=float(demod.fm_gain), a_dc=float(dec[0, 0]),
        a_de=float(dec[0, 1]), b_de=float(demod.fm_deemph.b))


def front_conditioner_from_numpy(p: dict, device=None) -> FrontConditioner:
    """{"channels", "dc_mode", "sample_rate", "dc_a", "m00", "m10", "m11"
    [C, 1] float32, "delay_sel" [C, 1] int32}: the JAX op's fields."""
    device = resolve_device(device)
    return FrontConditioner(
        channels=int(p["channels"]), dc_mode=str(p["dc_mode"]),
        sample_rate=float(p["sample_rate"]), dc_a=float(p["dc_a"]),
        m00=_f32_vec(p["m00"], device), m10=_f32_vec(p["m10"], device),
        m11=_f32_vec(p["m11"], device),
        delay_sel=torch.as_tensor(np.asarray(p["delay_sel"], np.int32).copy(),
                                  device=device))


def _agc_from_numpy(a: dict, device):
    if "attack_mult" not in a:
        return AGC(target=_f32(a["target"], device),
                   max_lgain=_f32(a["max_lgain"], device),
                   release_inc=_f32(a["release_inc"], device),
                   lookahead=int(a["lookahead"]))
    ints = ("hang_samples", "hang_enable", "lookahead")
    return WcpAGC(k={n: _f32(v, device) for n, v in a.items()
                     if n not in ints},
                  hang_samples=int(a["hang_samples"]),
                  hang_enable=bool(a["hang_enable"]),
                  lookahead=int(a["lookahead"]))


def _featured_from_numpy(p: dict, device) -> dict:
    """The optional stages of an RxChain, each None where its key is."""
    out = dict.fromkeys(("nb", "notch", "nr", "anf", "squelch", "fm_sq"))
    if p.get("nb") is not None:
        a = p["nb"]
        out["nb"] = NoiseBlanker(limit=_f32(a["limit"], device),
                                 avg_win=int(a["avg_win"]),
                                 kwidth=int(a["kwidth"]), pool=int(a["pool"]))
    if p.get("notch") is not None:
        a = p["notch"]
        out["notch"] = AutoNotch(
            window=_f32_vec(a["window"], device),
            depth_bins=int(a["depth_bins"]), n_notch=int(a["n_notch"]),
            block=int(a["block"]), nfft=int(a["nfft"]),
            ntaps=int(a["ntaps"]), ema=float(a["ema"]),
            snr_open=float(a["snr_open"]))
    if p.get("nr") is not None:
        a = p["nr"]
        out["nr"] = SpectralNR(
            window=_f32_vec(a["window"], device), fft=int(a["fft"]),
            block=int(a["block"]), alpha=float(a["alpha"]),
            noise_up=float(a["noise_up"]), noise_down=float(a["noise_down"]),
            gain_floor=float(a["gain_floor"]))
    if p.get("anf") is not None:
        a = p["anf"]
        out["anf"] = BlockLMS(
            mu=_f32(a["mu"], device), taps=int(a["taps"]),
            delay=int(a["delay"]), block=int(a["block"]), sub=int(a["sub"]),
            notch=bool(a["notch"]), leak=float(a["leak"]),
            fdaf=bool(a["fdaf"]))
    if p.get("squelch") is not None:
        a = p["squelch"]
        out["squelch"] = SSBSquelch(
            threshold=_f32(a["threshold"], device),
            hold_blocks=int(a["hold_blocks"]), block=int(a["block"]),
            fft_size=int(a["fft_size"]), ramp=int(a["ramp"]),
            f_lo_bin=int(a["f_lo_bin"]), f_hi_bin=int(a["f_hi_bin"]))
    if p.get("fm_sq") is not None:
        a = p["fm_sq"]
        out["fm_sq"] = FMSquelch(
            threshold_db=_f32(a["threshold_db"], device),
            hold_blocks=int(a["hold_blocks"]), ramp=int(a["ramp"]))
    return out


def _ols_from_numpy(d: dict, device) -> OverlapSaveFIR:
    mask = np.asarray(d["mask"]).astype(np.complex64)
    return OverlapSaveFIR(mask=torch.as_tensor(mask, device=device),
                          ntaps=int(d["ntaps"]), block=int(d["block"]),
                          nfft=mask.shape[-1])


def rx_chain_from_numpy(p: dict, device=None) -> RxChain:
    """An RxChain from the arrays of a ``quisk_tpu`` RxChain.

    Keys: ``channels``, ``block_in``, ``block_audio``, ``fs_audio``,
    ``tune_base`` [C]; ``nco_word`` [C] uint32 or None; ``front`` (see
    :func:`fused_front_from_numpy`) or None; ``stages``: [{"taps",
    "decim", "block"}]; ``bp``: {"mask" complex [nfft] or [C, nfft],
    "ntaps", "block"}; ``frac``: {"ratio" (num, den), "block"} or None;
    ``demod``: {"mode" [C], "ssb_gain", "am_gain", "am_pole", "fm_gain",
    "fm_a", "fm_b"}; ``agc``: {"target", "max_lgain", "release_inc",
    "lookahead"}, or the WcpAGC's constants by name with "hang_samples",
    "hang_enable" and "lookahead", or None; ``ons``: {name: [C, 1]};
    ``cond`` (see :func:`front_conditioner_from_numpy`) or None/absent.
    Optional stages, each a dict of the JAX op's fields by name or
    None/absent: ``nb`` (limit, avg_win, kwidth, pool), ``notch`` (window,
    depth_bins, n_notch, block, nfft, ntaps, ema, snr_open), ``nr``
    (window, fft, block, alpha, noise_up, noise_down, gain_floor), ``anf``
    (mu, taps, delay, block, sub, notch, leak, fdaf), ``squelch``
    (threshold, hold_blocks, block, fft_size, ramp, f_lo_bin, f_hi_bin),
    ``fm_sq`` (threshold_db, hold_blocks, ramp).  An EXT demod plugin is
    not carried across.
    """
    device = resolve_device(device)
    C = int(p["channels"])
    nco = front = None
    if p.get("front") is not None:
        front = fused_front_from_numpy(p["front"], device)
    else:
        nco = NCO(word=phase_tensor(p["nco_word"], device),
                  block=int(p["block_in"]))
    stages = tuple(make_fir(np.asarray(s["taps"]), int(s["block"]),
                            decim=int(s["decim"]), device=device)
                   for s in p["stages"])
    bp = _ols_from_numpy(p["bp"], device)
    frac = None
    if p.get("frac") is not None:
        num, den = p["frac"]["ratio"]
        frac = FracDecim.create(Fraction(int(num), int(den)),
                                int(p["frac"]["block"]), device=device)
    d = p["demod"]
    modes = np.asarray(d["mode"], np.int32)
    ssb, am, fm = _demods_from_numpy(d, device)
    demod = MixedDemod(
        ssb=ssb, am=am, fm=fm, ext=None,
        mode=torch.as_tensor(modes.copy(), device=device),
        iq_out=bool(np.any(modes == int(Mode.DGT_IQ))))
    agc = (_agc_from_numpy(p["agc"], device)
           if p.get("agc") is not None else None)
    ons = {k: torch.as_tensor(np.asarray(v, np.float32).copy(), device=device)
           for k, v in p.get("ons", {}).items()}
    cond = (front_conditioner_from_numpy(p["cond"], device)
            if p.get("cond") is not None else None)
    return RxChain(nco=nco, front=front, stages=stages, bp=bp, frac=frac,
                   demod=demod, agc=agc, ons=ons,
                   **_featured_from_numpy(p, device),
                   tune_base=torch.as_tensor(
                       np.asarray(p["tune_base"], np.float32).copy(),
                       device=device),
                   channels=C, block_in=int(p["block_in"]),
                   block_audio=int(p["block_audio"]),
                   fs_audio=float(p["fs_audio"]), cond=cond)


_STATE_KEYS = ("nbg", "nco", "cond", "front", "stages", "bp", "frac", "demod",
               "agc", "nb", "notch", "nr", "anf", "squelch", "fm_sq")


def rx_state_from_numpy(s: dict, device=None) -> dict:
    """Chain state from the numpy leaves of a ``quisk_tpu`` chain state:
    front (phase0 uint32, hist), nco phase, stage and bp histories, frac
    history, demod ((AM x_prev, y_prev), (FM prev, y_prev), ext), AGC
    ((delay, lg), or the WcpAGC's dict), the carried blanker gain ``nbg``
    and the states of nb, notch, nr, anf, squelch and fm_sq (empty tuples
    for stages the chain lacks); ``cond`` is the raw-IQ conditioner's dict
    (its ``count`` and ``key_delay`` int32)."""
    return state_from_numpy({k: s[k] for k in _STATE_KEYS}, device)


def rx_state_to_numpy(state: dict) -> dict:
    """Chain state as numpy arrays, phases as uint32 (the layout
    :func:`rx_state_from_numpy` reads)."""
    return state_to_numpy({k: state[k] for k in _STATE_KEYS})


def tx_chain_from_numpy(p: dict, device=None) -> TxChain:
    """A TxChain from the arrays of a ``quisk_tpu`` TxChain.

    Keys: ``channels``, ``block``, ``block_tx``, ``audio_rate``, ``mode``
    [C]; ``analytic``: {"mask" complex [nfft] or [C, nfft], "ntaps",
    "block"}; ``preemph``: {"c"}; ``comp``: {"knee", "ceiling", "gain"};
    ``trim``: (m00, m10, m11) [C, 1] each; ``spot`` [C, 1]; ``tune``:
    {"word" [C] uint32, "block"}; ``pm_gain``, ``ctcss_word``,
    ``ctcss_amp``, ``am_carrier``; and, each None or absent when the chain
    lacks the stage, ``phrot``: {"b0", "nstages"}; ``alc``: {"target",
    "gain_max", "gain_min", "d_limit", "min_magn", "mode" [C], "buf",
    "n_modes"}; ``cessb``: {"taps1", "taps2" (ConvFIR taps, forward
    order), "block", "ceiling"}; ``predist``: {"c_re", "c_im",
    "env_max"}; ``interp``: {"M", "interp", "ntaps", "block", "R"}."""
    device = resolve_device(device)

    def vec(v):
        return _f32_vec(v, device)
    phrot = alc = cessb = predist = interp = None
    if p.get("phrot") is not None:
        phrot = PhaseRotator(b0=_f32(p["phrot"]["b0"], device),
                             nstages=int(p["phrot"]["nstages"]))
    if p.get("alc") is not None:
        a = p["alc"]
        alc = TxALC(**{k: _f32(a[k], device) for k in (
            "target", "gain_max", "gain_min", "d_limit", "min_magn")},
            mode=torch.as_tensor(np.asarray(a["mode"], np.int64).copy(),
                                 device=device),
            buf=int(a["buf"]), n_modes=int(a["n_modes"]))
    if p.get("cessb") is not None:
        a = p["cessb"]
        cessb = OvershootControl(
            fir1=ConvFIR.create(np.asarray(a["taps1"]), int(a["block"]),
                                device=device),
            fir2=ConvFIR.create(np.asarray(a["taps2"]), int(a["block"]),
                                device=device),
            ceiling=_f32(a["ceiling"], device))
    if p.get("predist") is not None:
        a = p["predist"]
        predist = Predistorter(c_re=vec(a["c_re"]), c_im=vec(a["c_im"]),
                               env_max=_f32(a["env_max"], device))
    if p.get("interp") is not None:
        a = p["interp"]
        interp = Interpolator(M=vec(a["M"]), interp=int(a["interp"]),
                              ntaps=int(a["ntaps"]), block=int(a["block"]),
                              R=int(a["R"]))
    c = p["comp"]
    return TxChain(
        analytic=_ols_from_numpy(p["analytic"], device), phrot=phrot,
        preemph=Preemphasis(c=vec(p["preemph"]["c"])),
        comp=SoftCompressor(knee=_f32(c["knee"], device),
                            ceiling=_f32(c["ceiling"], device),
                            gain=vec(c["gain"])),
        alc=alc, cessb=cessb, predist=predist, interp=interp,
        mode=torch.as_tensor(np.asarray(p["mode"], np.int64).copy(),
                             device=device),
        trim=tuple(vec(t) for t in p["trim"]), spot=vec(p["spot"]),
        tune=NCO(word=phase_tensor(p["tune"]["word"], device),
                 block=int(p["tune"]["block"])),
        pm_gain=_f32(p["pm_gain"], device),
        ctcss_word=_f32(p["ctcss_word"], device),
        ctcss_amp=_f32(p["ctcss_amp"], device),
        am_carrier=_f32(p["am_carrier"], device),
        channels=int(p["channels"]), block=int(p["block"]),
        block_tx=int(p["block_tx"]), audio_rate=float(p["audio_rate"]))


_TX_STATE_KEYS = ("imd_phase", "analytic", "phrot", "preemph", "alc",
                  "ctcss_phase", "tune_phase", "interp", "cessb")


def tx_state_from_numpy(s: dict, device=None) -> dict:
    """TX chain state from the numpy leaves of a ``quisk_tpu`` TxChain
    state: the IMD and CTCSS phases (float32), the analytic filter's
    history, the phase rotator's (x1, y1), the pre-emphasis x_prev, the
    ALC's dict (its buffer, per-mode ``gain_now`` [C, n_modes], the float
    carries, ``block_index`` and ``index`` int32), the tune phase (uint32),
    the interpolator's history and CESSB's two FIR histories; empty tuples
    for stages the chain lacks."""
    return state_from_numpy({k: s[k] for k in _TX_STATE_KEYS}, device)


def tx_state_to_numpy(state: dict) -> dict:
    """TX chain state as numpy arrays, the tune phase as uint32 (the layout
    :func:`tx_state_from_numpy` reads)."""
    return state_to_numpy({k: state[k] for k in _TX_STATE_KEYS})


def spectrum_from_numpy(p: dict, device=None) -> SpectrumAnalyzer:
    """A SpectrumAnalyzer from {"window" [fft_size] (normalised, as the
    reference holds it), "enbw_bins", "block", "hop"}."""
    device = resolve_device(device)
    w = np.asarray(p["window"], np.float32)
    return SpectrumAnalyzer(window=torch.as_tensor(w.copy(), device=device),
                            enbw_bins=_f32(p["enbw_bins"], device),
                            fft_size=w.shape[-1], block=int(p["block"]),
                            hop=int(p["hop"]))


def spectrum_state_from_numpy(s: tuple, device=None) -> tuple:
    """An analyzer's state from the reference's (psum, count) or, when
    overlapped, (psum, count, hist_re, hist_im)."""
    out = state_from_numpy(tuple(s[:2]), device)
    if len(s) == 4:
        h = np.asarray(s[2], np.float32) + 1j * np.asarray(s[3], np.float32)
        out += state_from_numpy((h.astype(np.complex64),), device)
    return out


def spectrum_state_to_numpy(state: tuple) -> tuple:
    """Inverse of :func:`spectrum_state_from_numpy`."""
    out = state_to_numpy(tuple(state[:2]))
    if len(state) == 3:
        h = state[2].detach().cpu().numpy()
        out += (h.real.astype(np.float32), h.imag.astype(np.float32))
    return out


# ------------------------------------------------------- the remaining DSP
def sync_am_from_numpy(p: dict, device=None) -> SyncAMDemod:
    """A SyncAMDemod from the JAX op's {"alpha", "beta", "dc_pole",
    "max_freq"}."""
    device = resolve_device(device)
    return SyncAMDemod(**{k: _f32(p[k], device)
                          for k in ("alpha", "beta", "dc_pole", "max_freq")})


def pll_fm_from_numpy(p: dict, device=None) -> PLLFMDemod:
    """A PLLFMDemod from {"alpha", "beta", "gain", "max_freq", "deemph_a",
    "deemph_b", "notch"}: the de-emphasis one-pole's a, b and the CTCSS
    notch as {"b0", "b1", "b2", "a1", "a2"}, or None without it."""
    device = resolve_device(device)
    n = p.get("notch")
    notch = (Biquad(*(_f32(n[k], device) for k in ("b0", "b1", "b2", "a1",
                                                   "a2")))
             if n is not None else None)
    return PLLFMDemod(deemph=OnePole(a=_f32(p["deemph_a"], device),
                                     b=_f32(p["deemph_b"], device)),
                      notch=notch,
                      **{k: _f32(p[k], device)
                         for k in ("alpha", "beta", "gain", "max_freq")})


def snb_from_numpy(p: dict, device=None) -> SpectralNoiseBlanker:
    """A SpectralNoiseBlanker from {"window" [fft], "block", "k_detect",
    "bg_rate"}."""
    device = resolve_device(device)
    w = np.asarray(p["window"], np.float32)
    return SpectralNoiseBlanker(
        window=torch.as_tensor(w.copy(), device=device), fft=w.shape[-1],
        block=int(p["block"]), k_detect=float(p["k_detect"]),
        bg_rate=float(p["bg_rate"]))


def partitioned_ols_from_numpy(p: dict, device=None) -> PartitionedOLS:
    """A PartitionedOLS from {"H" [P, nfft] or [C, P, nfft] complex64,
    "ntaps", "block", "decim"}."""
    device = resolve_device(device)
    H = np.asarray(p["H"]).astype(np.complex64)
    return PartitionedOLS(H=torch.as_tensor(H, device=device),
                          ntaps=int(p["ntaps"]), block=int(p["block"]),
                          nfft=H.shape[-1], P=H.shape[-2],
                          decim=int(p.get("decim", 1)))


def diversity_from_numpy(p: dict, device=None) -> DiversityCombiner:
    """A DiversityCombiner from {"w_re", "w_im"} [C, 2] float32."""
    device = resolve_device(device)
    return DiversityCombiner(w_re=_f32_vec(p["w_re"], device),
                             w_im=_f32_vec(p["w_im"], device))
