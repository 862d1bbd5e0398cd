"""The slice end to end: the port's RxChain against the JAX package's on
the flagship configuration (960 kS/s, /20, 1025-tap channel filter,
mixed demod, lookahead AGC) cut to C=128 channels and audio_block=512,
modes cycling USB/LSB/AM/FM, fused and unfused, on the same numpy input.

The first 2 blocks are skipped (the AGC's lookahead makes them nearly
silent).  Non-FM channels must match sample by sample at > 90 dB, the
fused-vs-unfused floor of tests/test_pallas_fused.py.  FM channels are
held the same way where they clear it; otherwise by RMS within 0.1 dB:
while the filter histories fill, FM input is ~0 and the discriminator's
branch is chaotic under one-ulp differences, and the AGC seeds its state
from it (the same reason
tests/test_featured_chain.py::test_featured_chain_sharded_matches_unsharded
holds FM channels by RMS).

The featured receiver (noise blanker 2 fused into the front kernel,
auto-notch, LMS notch, spectral NR, both squelches) and the NFM receiver
(192 kS/s, FM squelch) are held the same way at C=128, with parameters and
state carried across by ``convert`` in both directions mid-stream; their
floors are stated at the tests.
"""

import dataclasses

import numpy as np
import pytest
import torch

from quisk_tpu.rx import RxChain as JRxChain
from quisk_tpu.rx import RxChainConfig as JRxChainConfig

from quisk_tpu_torch import convert
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.rx import RxChain, RxChainConfig

FS = 960000.0
C = 128
NBLK = 4
MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]
MODE = [MODES[i % 4] for i in range(C)]
TUNE = [(-FS / 4 + (i + 0.5) * FS / (2 * C)) for i in range(C)]
FM_ROWS = [i for i in range(C) if MODE[i] == int(Mode.FM)]
OTHER_ROWS = [i for i in range(C) if MODE[i] != int(Mode.FM)]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """Run the port's CPU ops on one thread: on some CPU hosts torch's
    intra-op worker threads have returned elementwise transcendentals
    (cos) off by ~1e-4 for a whole worker's chunk, intermittently, which
    these SNR floors would catch as a port fault."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(cls, fused):
    return cls(sample_rate=FS, channels=C, audio_block=512, agc=True,
               fused_frontend=fused)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_np(v) for v in tree)
    return np.asarray(tree)


def _jax_chain_arrays(ch) -> dict:
    """The JAX chain's parameters as numpy arrays (convert's layout)."""
    def stage(s):
        T = s.ntaps
        if hasattr(s, "Mg"):                 # half-band: odd taps + center
            taps = np.zeros(T)
            taps[1::2] = np.asarray(s.Mg)[:T // 2, 0][::-1]
            taps[T // 2] = float(s.center)
        else:
            taps = np.asarray(s.M)[:T, 0][::-1]
        return {"taps": taps, "decim": s.decim, "block": s.block}

    front = None
    if ch.front is not None:
        T = ch.front.ntaps
        front = {"taps": np.asarray(ch.front.M)[:T, 0][::-1],
                 "word": np.asarray(ch.front.word),
                 "decim": ch.front.decim, "block": ch.front.block,
                 "nb_detect": ({"avg_win": ch.nb.avg_win,
                                "kwidth": ch.nb.kwidth}
                               if ch.front.nbspec is not None else None)}
    d = ch.demod

    def fields(op, names):
        if op is None:
            return None
        return {n: (np.asarray(getattr(op, n))
                    if hasattr(getattr(op, n), "shape") else getattr(op, n))
                for n in names}

    if ch.agc is None:
        agc = None
    elif hasattr(ch.agc, "attack_mult"):
        agc = fields(ch.agc, ("attack_mult", "decay_mult", "fast_decay_mult",
                              "fast_backmult", "hang_backmult",
                              "hang_decay_mult", "out_target", "min_volts",
                              "slope_constant", "hang_level", "pop_ratio",
                              "inv_max_input", "hang_samples", "hang_enable",
                              "lookahead"))
    else:
        agc = fields(ch.agc, ("target", "max_lgain", "release_inc",
                              "lookahead"))
    return {
        "channels": ch.channels, "block_in": ch.block_in,
        "block_audio": ch.block_audio, "fs_audio": ch.fs_audio,
        "tune_base": np.asarray(ch.tune_base),
        "nco_word": np.asarray(ch.nco.word) if ch.front is None else None,
        "front": front,
        "stages": [stage(s) for s in ch.stages],
        "bp": {"mask": np.asarray(ch.bp.mask), "ntaps": ch.bp.ntaps,
               "block": ch.bp.block},
        "frac": ({"ratio": (ch.frac.ratio_num, ch.frac.ratio_den),
                  "block": ch.frac.block} if ch.frac is not None else None),
        "demod": {"mode": np.asarray(d.mode), "ssb_gain": d.ssb.gain,
                  "am_gain": d.am.gain, "am_pole": d.am.dc.a,
                  "fm_gain": d.fm.gain, "fm_a": d.fm.deemph.a,
                  "fm_b": d.fm.deemph.b},
        "agc": agc,
        "ons": {k: np.asarray(v) for k, v in ch.ons.items()},
        "nb": fields(ch.nb, ("limit", "avg_win", "kwidth", "pool")),
        "notch": fields(ch.notch, ("window", "depth_bins", "n_notch",
                                   "block", "nfft", "ntaps", "ema",
                                   "snr_open")),
        "nr": fields(ch.nr, ("window", "fft", "block", "alpha", "noise_up",
                             "noise_down", "gain_floor")),
        "anf": fields(ch.anf, ("mu", "taps", "delay", "block", "sub",
                               "notch", "leak", "fdaf")),
        "squelch": fields(ch.squelch, ("threshold", "hold_blocks", "block",
                                       "fft_size", "ramp", "f_lo_bin",
                                       "f_hi_bin")),
        "fm_sq": fields(ch.fm_sq, ("threshold_db", "hold_blocks", "ramp")),
    }


def _input(block_in):
    rng = np.random.default_rng(30)
    return (rng.standard_normal((C, NBLK * block_in))
            + 1j * rng.standard_normal((C, NBLK * block_in))
            ).astype(np.complex64)


@pytest.fixture(scope="module", params=[False, True], ids=["unfused",
                                                            "fused"])
def jax_run(request):
    """4 blocks through the JAX chain, its audio and its state after 2."""
    fused = request.param
    ch = JRxChain.create(_cfg(JRxChainConfig, fused), tune_hz=TUNE,
                         mode=MODE)
    assert (ch.front is not None) == fused
    x = _input(ch.block_in)
    st = ch.init_state()
    outs, mid_state = [], None
    for i in range(NBLK):
        st, a = ch.step(st, x[:, i * ch.block_in:(i + 1) * ch.block_in])
        outs.append(np.asarray(a))
        if i == 1:
            mid_state = _tree_np(st)
    return dict(fused=fused, x=x, outs=outs, mid_state=mid_state,
                arrays=_jax_chain_arrays(ch), block_in=ch.block_in)


def snr_rows(ref, got):
    err = np.mean((got - ref) ** 2, axis=-1)
    return 10 * np.log10(np.mean(ref ** 2, axis=-1) / (err + 1e-30))


def _assert_block_matches(ref, got):
    assert got.shape == ref.shape == (C, 512)
    assert np.all(np.isfinite(got))
    s = snr_rows(ref, got)
    assert s[OTHER_ROWS].min() > 90.0, s[OTHER_ROWS].min()
    for r in FM_ROWS:
        if s[r] <= 90.0:
            db = 20 * np.log10(np.sqrt(np.mean(got[r] ** 2))
                               / np.sqrt(np.mean(ref[r] ** 2)))
            assert abs(db) < 0.1, (r, s[r], db)


def test_chain_matches_jax(jax_run):
    ch = RxChain.create(_cfg(RxChainConfig, jax_run["fused"]), tune_hz=TUNE,
                        mode=MODE, device="cpu")
    assert (ch.front is not None) == jax_run["fused"]
    if ch.front is not None:
        assert ch.front.decim == 20 and ch.front.ntaps == 1421
        assert not ch.stages
    x = torch.as_tensor(jax_run["x"])
    st = ch.init_state()
    for i in range(NBLK):
        st, a = ch.step(st, x[:, i * ch.block_in:(i + 1) * ch.block_in])
        if i >= 2:
            _assert_block_matches(jax_run["outs"][i], a.numpy())


def test_converted_params_equal_created(jax_run):
    made = RxChain.create(_cfg(RxChainConfig, jax_run["fused"]),
                          tune_hz=TUNE, mode=MODE, device="cpu")
    conv = convert.rx_chain_from_numpy(jax_run["arrays"], "cpu")
    if made.front is not None:
        assert torch.equal(made.front.h_rev, conv.front.h_rev)
        assert torch.equal(made.front.word, conv.front.word)
    else:
        assert torch.equal(made.nco.word, conv.nco.word)
        for a, b in zip(made.stages, conv.stages):
            assert type(a) is type(b)
            assert all(torch.equal(getattr(a, f), getattr(b, f))
                       for f in ("M", "Mg", "center") if hasattr(a, f))
    assert torch.equal(made.bp.mask, conv.bp.mask)
    assert torch.equal(made.demod.mode, conv.demod.mode)
    assert torch.equal(made.tune_base, conv.tune_base)
    for f in ("target", "max_lgain", "release_inc"):
        assert torch.equal(getattr(made.agc, f), getattr(conv.agc, f))
    assert torch.equal(made.demod.fm.deemph.a, conv.demod.fm.deemph.a)
    assert torch.equal(made.demod.fm.gain, conv.demod.fm.gain)


def test_process_continues_from_jax_state(jax_run):
    """2 blocks in JAX, the state carried across, 2 more in the port."""
    ch = convert.rx_chain_from_numpy(jax_run["arrays"], "cpu")
    st = convert.rx_state_from_numpy(jax_run["mid_state"], "cpu")
    B = jax_run["block_in"]
    x = torch.as_tensor(jax_run["x"][:, 2 * B:])
    st, audio = ch.process(st, x)
    audio = audio.numpy()
    for i in (2, 3):
        _assert_block_matches(jax_run["outs"][i],
                              audio[:, (i - 2) * 512:(i - 1) * 512])
    back = convert.rx_state_to_numpy(st)
    if jax_run["fused"]:
        assert back["front"][0].dtype == np.uint32


def test_frac_chain_matches_jax():
    """250 kHz: one /5 stage then FracDecim 25/24."""
    fs, c = 250000.0, 4
    modes = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.CWU)]
    tune = [-50e3, -10e3, 20e3, 60e3]
    jch = JRxChain.create(JRxChainConfig(sample_rate=fs, channels=c,
                                         audio_block=512), tune, modes)
    ch = RxChain.create(RxChainConfig(sample_rate=fs, channels=c,
                                      audio_block=512), tune, modes,
                        device="cpu")
    assert ch.frac is not None and ch.block_in == jch.block_in
    rng = np.random.default_rng(31)
    x = (rng.standard_normal((c, 4 * ch.block_in))
         + 1j * rng.standard_normal((c, 4 * ch.block_in))
         ).astype(np.complex64)
    js, ps = jch.init_state(), ch.init_state()
    for i in range(4):
        blk = x[:, i * ch.block_in:(i + 1) * ch.block_in]
        js, ja = jch.step(js, blk)
        ps, pa = ch.step(ps, torch.as_tensor(blk))
        if i >= 2:
            assert snr_rows(np.asarray(ja), pa.numpy()).min() > 90.0


def test_retune_matches_jax():
    cfg_kw = dict(sample_rate=FS, channels=8, audio_block=512)
    modes = [MODES[i % 4] for i in range(8)]
    jch = JRxChain.create(JRxChainConfig(**cfg_kw), 0.0, modes)
    ch = RxChain.create(RxChainConfig(**cfg_kw), 0.0, modes, device="cpu")
    new_modes = [int(Mode.CWU), int(Mode.CWL)] * 4
    kw = dict(tune_hz=[1000.0 * i for i in range(8)], mode=new_modes,
              bandwidth_hz=[2400.0] * 8,
              notches_hz=[[(700.0, 50.0)]] * 8)
    j2 = jch.retune(JRxChainConfig(**cfg_kw), **kw)
    p2 = ch.retune(RxChainConfig(**cfg_kw), **kw)
    assert np.array_equal(p2.nco.word.numpy().astype(np.uint32),
                          np.asarray(j2.nco.word))
    assert np.array_equal(p2.bp.mask.numpy(), np.asarray(j2.bp.mask))
    assert np.array_equal(p2.demod.mode.numpy(), np.asarray(j2.demod.mode))
    assert np.array_equal(p2.tune_base.numpy(), np.asarray(j2.tune_base))


def test_fused_retune_sets_front_word():
    cfg = RxChainConfig(sample_rate=FS, channels=4, audio_block=512,
                        fused_frontend=True)
    jcfg = JRxChainConfig(sample_rate=FS, channels=128, audio_block=512,
                          fused_frontend=True)
    ch = RxChain.create(cfg, 0.0, int(Mode.USB), device="cpu")
    new = ch.retune(cfg, tune_hz=[-100e3, 5e3, 7e3, 200e3])
    jch = JRxChain.create(jcfg, 0.0, int(Mode.USB)).retune(
        jcfg, tune_hz=[-100e3, 5e3, 7e3, 200e3] * 32)
    assert np.array_equal(new.front.word.numpy().astype(np.uint32),
                          np.asarray(jch.front.word)[:4])


def test_agc_toggle_is_exact_pass_through():
    kw = dict(sample_rate=FS, channels=4, audio_block=512)
    on = RxChain.create(RxChainConfig(**kw), 1e3, MODES, device="cpu")
    off = on.set_stage("agc", False)
    assert on.stage_on("agc") and not off.stage_on("agc")
    plain = RxChain.create(RxChainConfig(**kw, agc=False), 1e3, MODES,
                           device="cpu")
    x = torch.as_tensor(_input(on.block_in)[:4, :on.block_in])
    _, a = off.step(off.init_state(), x)
    _, b = plain.step(plain.init_state(), x)
    assert torch.equal(a, b)
    one = on.set_stage("agc", False, channel=2)
    assert one.ons["agc"][:, 0].tolist() == [1.0, 1.0, 0.0, 1.0]
    with pytest.raises(KeyError):
        on.set_stage("nr", True)


def test_dgt_iq_rows_carry_filtered_iq():
    kw = dict(sample_rate=FS, channels=2, audio_block=512, agc=False)
    ch = RxChain.create(RxChainConfig(**kw), 0.0,
                        [int(Mode.DGT_IQ), int(Mode.USB)], device="cpu")
    x = torch.as_tensor(_input(ch.block_in)[:2, :ch.block_in])
    _, a = ch.step(ch.init_state(), x)
    assert a.dtype == torch.complex64
    assert torch.all(a[1].imag == 0)
    assert torch.any(a[0].imag != 0)


@pytest.mark.parametrize("opt", [{"front_cond": True}, {"dc_remove_bw": 1}])
def test_conditioned_chain_matches_jax(opt):
    """``front_cond`` / ``dc_remove_bw`` put the raw-IQ conditioner ahead
    of the chain (rx/frontend.py): 4 channels, unfused, the trim set on
    both sides, 4 blocks; audio > 90 dB from block 2 on and the
    conditioner's state equal (tests/test_torch_frontend.py holds the
    conditioner itself and the fused chain at C=128)."""
    c, modes = 4, [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.CWU)]
    tune = [-200e3, -50e3, 30e3, 180e3]
    kw = dict(sample_rate=FS, channels=c, audio_block=512, **opt)
    jch = JRxChain.create(JRxChainConfig(**kw), tune, modes)
    ch = RxChain.create(RxChainConfig(**kw), tune, modes, device="cpu")
    assert ch.cond is not None
    assert ch.cond.dc_mode == jch.cond.dc_mode == (
        "avg" if opt.get("dc_remove_bw") else "off")
    jch = jch.replace(cond=jch.cond.with_balance(0.03, -2.0, True))
    ch = dataclasses.replace(ch, cond=ch.cond.with_balance(0.03, -2.0, True))
    x = _input(ch.block_in)[:c] + np.complex64(0.2 + 0.1j)
    js, ps = jch.init_state(), ch.init_state()
    for i in range(NBLK):
        blk = x[:, i * ch.block_in:(i + 1) * ch.block_in]
        js, ja = jch.step(js, blk, key_down=(i == 1))
        ps, pa = ch.step(ps, torch.as_tensor(blk), key_down=(i == 1))
        if i >= 2:
            assert snr_rows(np.asarray(ja), pa.numpy()).min() > 90.0
    assert sorted(ps["cond"]) == sorted(js["cond"])
    for k, v in js["cond"].items():
        assert np.allclose(np.asarray(v), ps["cond"][k].numpy(), atol=1e-5)
        assert np.asarray(v).dtype == ps["cond"][k].numpy().dtype, k


def test_unknown_agc_profile_raises():
    with pytest.raises(ValueError, match="agc_profile"):
        RxChain.create(RxChainConfig(sample_rate=FS, channels=4,
                                     agc_profile="fast"), device="cpu")


def test_config_refuses_tpu_only_field():
    """mxu_stft picks the MXU DFT form on the TPU; the port has no such
    choice, so the field is refused rather than silently ignored."""
    with pytest.raises(TypeError):
        RxChainConfig(sample_rate=FS, channels=4, mxu_stft=False)


def test_create_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RxChain.create(RxChainConfig(sample_rate=FS, channels=4))


# ------------------------------------------------ featured and NFM receivers
FEATURED = dict(noise_blanker=2, auto_notch=True, nr=True, anf=True,
                squelch=True, fm_squelch=True)
STAGE_FLAGS = {"nb": {"noise_blanker": 2}, "notch": {"auto_notch": True},
               "nr": {"nr": True}, "anf": {"anf": True}, "agc": {"agc": True},
               "squelch": {"squelch": True}, "fm_sq": {"fm_squelch": True}}


def _featured_cfg(cls, **extra):
    kw = dict(sample_rate=FS, channels=C, audio_block=512, agc=True,
              fused_frontend=True, **FEATURED)
    kw.update(extra)
    return cls(**kw)


def _featured_input(block_in, nblk, channels=C, seed=32):
    """Noise, a carrier 1 kHz above channel 0's dial, a strong carrier on
    the FM channel 3 (opens its RF squelch) and impulses on every 7th
    channel."""
    rng = np.random.default_rng(seed)
    n = nblk * block_in
    x = 0.05 * (rng.standard_normal((channels, n))
                + 1j * rng.standard_normal((channels, n)))
    t = np.arange(n) / FS
    x[0] += 0.5 * np.exp(2j * np.pi * (TUNE[0] + 1000.0) * t)
    x[3] += 0.5 * np.exp(2j * np.pi * (TUNE[3] + 300.0 * np.sin(
        2 * np.pi * 400.0 * t)) * t)
    for c in range(0, channels, 7):
        for p in rng.integers(0, n, 3 * nblk):
            x[c, p] += 30.0 * np.exp(1j * rng.uniform(0, 2 * np.pi))
    return x.astype(np.complex64)


NBLK_F = 6          # featured runs: blocks 0-2 warm up, 3-5 are compared


@pytest.fixture(scope="module")
def jax_featured():
    """6 blocks through the JAX featured chain (true FFTs: mxu_stft off),
    its audio, and its state after 3 blocks."""
    ch = JRxChain.create(_featured_cfg(JRxChainConfig, mxu_stft=False),
                         tune_hz=TUNE, mode=MODE)
    assert ch._nb_fused and not ch.stages
    x = _featured_input(ch.block_in, NBLK_F)
    st = ch.init_state()
    outs, mid_state = [], None
    for i in range(NBLK_F):
        st, a = ch.step(st, x[:, i * ch.block_in:(i + 1) * ch.block_in])
        outs.append(np.asarray(a))
        if i == 2:
            mid_state = _tree_np(st)
    return dict(chain=ch, x=x, outs=outs, mid_state=mid_state,
                arrays=_jax_chain_arrays(ch), block_in=ch.block_in)


# The featured stages adapt from their own output (LMS weights, the
# decision-directed SNR, the notch's peak decisions), so float32 rounding
# differences between the two packages feed back: the floor for non-FM
# channels is 60 dB sample by sample, FM by RMS within 0.5 dB.  Blocks 0-2
# are not compared: while the filter histories fill, the audio stages run
# on residue near 1e-7, where the two FFT libraries agree to ~60 dB only,
# the NR's gain follows that residue, and the AGC (80 dB of gain, 1.4
# blocks of lookahead) lifts it into blocks 1-2 (measured: 33 dB on the
# carrier channel in block 2, 84 dB in block 3, with each op alone
# agreeing >= 100 dB on equal input).
FEATURED_DB = 60.0
FEATURED_FM_DB = 0.5
# FM channels: while the histories fill the discriminator turns residue
# into full-scale garbage that differs between the packages (module
# docstring), and the voice squelch may open on one side's garbage and not
# on the other's, for its 1 s hold.  Such rows are counted, not compared:
# at most 4 of the 32 FM rows (measured here: 1).
FM_SQUELCH_SPLIT_MAX = 4


def _assert_featured_block(ref, got, split=None):
    """Hold one block to the JAX chain's.  ``split`` collects the FM rows
    whose voice squelch was open on one side only; once in it a row is no
    longer compared (its squelch ramps and holds at other times)."""
    assert got.shape == ref.shape == (C, 512)
    assert np.all(np.isfinite(got))
    s = snr_rows(ref, got)
    split = set() if split is None else split
    compared = 0
    for r in range(C):
        if r in split:
            continue
        p_ref, p_got = np.mean(ref[r] ** 2), np.mean(got[r] ** 2)
        fm = MODE[r] == int(Mode.FM)
        if p_ref == 0.0 or p_got == 0.0:             # a closed squelch
            if fm and p_ref != p_got:
                split.add(r)
            else:
                assert p_ref == p_got == 0.0, r
        elif fm and s[r] <= FEATURED_DB:
            db = 10 * np.log10(p_got / p_ref)
            assert abs(db) < FEATURED_FM_DB, (r, s[r], db)
        else:
            assert s[r] > FEATURED_DB, (r, s[r])
            compared += 1
    assert compared >= 8                          # open channels were held
    assert len(split) <= FM_SQUELCH_SPLIT_MAX, sorted(split)


def test_featured_chain_matches_jax(jax_featured):
    ch = RxChain.create(_featured_cfg(RxChainConfig), tune_hz=TUNE,
                        mode=MODE, device="cpu")
    assert ch._nb_fused and not ch._nb_gained and not ch.stages
    assert ch.front.nb_detect == {"avg_win": 64, "kwidth": 961}
    assert sorted(ch.ons) == sorted(jax_featured["chain"].ons)
    x = torch.as_tensor(jax_featured["x"])
    st = ch.init_state()
    assert set(st) == set(jax_featured["mid_state"])
    split = set()
    for i in range(NBLK_F):
        st, a = ch.step(st, x[:, i * ch.block_in:(i + 1) * ch.block_in])
        assert a.dtype == torch.float32
        if i >= 3:
            _assert_featured_block(jax_featured["outs"][i], a.numpy(), split)
    # the carried blanker gain has the JAX chain's shape
    assert st["nbg"].shape == (C, ch.front.gain_hist_groups)
    assert jax_featured["mid_state"]["nbg"].shape == st["nbg"].shape


def test_featured_converted_params_equal_created(jax_featured):
    made = RxChain.create(_featured_cfg(RxChainConfig), tune_hz=TUNE,
                          mode=MODE, device="cpu")
    conv = convert.rx_chain_from_numpy(jax_featured["arrays"], "cpu")
    assert conv._nb_fused
    assert torch.equal(made.front.h_rev, conv.front.h_rev)
    assert torch.equal(made.front.rc, conv.front.rc)
    assert made.front.nb_detect == conv.front.nb_detect
    for name in ("nb", "notch", "nr", "anf", "squelch", "fm_sq", "agc"):
        a, b = getattr(made, name), getattr(conv, name)
        assert type(a) is type(b), name
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, torch.Tensor):
                assert torch.equal(va, vb), (name, f.name)
            else:
                assert va == vb, (name, f.name)
    assert sorted(made.ons) == sorted(conv.ons)


def test_featured_state_crosses_both_ways(jax_featured):
    """3 blocks in JAX, state to the port, block 3 in the port, state back
    to JAX, block 4 in JAX: both equal the JAX chain's own blocks."""
    ch = convert.rx_chain_from_numpy(jax_featured["arrays"], "cpu")
    st = convert.rx_state_from_numpy(jax_featured["mid_state"], "cpu")
    assert st["squelch"][0].dtype == torch.int32
    assert st["fm_sq"][0].dtype == torch.int32
    assert st["front"][0].dtype == torch.int64
    B = jax_featured["block_in"]
    x = jax_featured["x"]
    st, a = ch.step(st, torch.as_tensor(x[:, 3 * B:4 * B]))
    _assert_featured_block(jax_featured["outs"][3], a.numpy())
    back = convert.rx_state_to_numpy(st)
    assert back["front"][0].dtype == np.uint32
    assert back["squelch"][0].dtype == back["fm_sq"][0].dtype == np.int32
    for key, ref in jax_featured["mid_state"].items():
        flat_ref, flat_got = _leaves(ref), _leaves(back[key])
        assert len(flat_ref) == len(flat_got), key
        for r, g in zip(flat_ref, flat_got):
            assert r.shape == g.shape and r.dtype == g.dtype, key
    jch = jax_featured["chain"]
    _, ja = jch.step(back, x[:, 4 * B:5 * B])
    _assert_featured_block(jax_featured["outs"][4], np.asarray(ja))


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [v for t in tree for v in _leaves(t)]
    return [np.asarray(tree)]


@pytest.fixture(scope="module")
def small_featured():
    """The featured chain at 8 channels with its input (port only)."""
    cfg = _featured_cfg(RxChainConfig, channels=8)
    ch = RxChain.create(cfg, tune_hz=TUNE[:8], mode=MODE[:8], device="cpu")
    x = torch.as_tensor(_featured_input(ch.block_in, 3, channels=8))
    return cfg, ch, x


def _run(ch, x, nblk=3):
    st = ch.init_state()
    outs = []
    for i in range(nblk):
        st, a = ch.step(st, x[:, i * ch.block_in:(i + 1) * ch.block_in])
        outs.append(a)
    return st, torch.cat(outs, dim=-1)


@pytest.mark.parametrize("name", sorted(STAGE_FLAGS))
def test_stage_off_equals_chain_without_it(small_featured, name):
    cfg, ch, x = small_featured
    off = ch.set_stage(name, False)
    assert ch.stage_on(name) and not off.stage_on(name)
    (flag, _), = STAGE_FLAGS[name].items()
    without = RxChain.create(
        dataclasses.replace(cfg, **{flag: 0 if name == "nb" else False}),
        tune_hz=TUNE[:8], mode=MODE[:8], device="cpu")
    assert name not in without.ons
    _, a = _run(off, x)
    _, b = _run(without, x)
    assert torch.equal(a, b)
    _, on = _run(ch, x)
    assert not torch.equal(on, a)            # the stage did something


@pytest.mark.parametrize("opt", [{"noise_blanker": 1}, {"auto_notch": True},
                                 {"nr": True}, {"anf": True},
                                 {"squelch": True}, {"fm_squelch": True},
                                 {"agc_profile": "wcp"}])
def test_featured_flags_build_and_step(opt):
    cfg = RxChainConfig(sample_rate=48e3, channels=4, audio_block=512, **opt)
    ch = RxChain.create(cfg, 1000.0, MODES, device="cpu")
    rng = np.random.default_rng(33)
    x = (rng.standard_normal((4, ch.block_in))
         + 1j * rng.standard_normal((4, ch.block_in))).astype(np.complex64)
    st, a = ch.step(ch.init_state(), torch.as_tensor(x))
    st, a = ch.step(st, torch.as_tensor(x))
    assert a.shape == (4, 512) and bool(torch.isfinite(a).all())


def test_set_nb_level(small_featured):
    _, ch, x = small_featured
    assert float(ch.nb.limit) == 4.0
    lv = {lvl: ch.set_nb_level(lvl) for lvl in (1, 2, 3)}
    assert [float(lv[k].nb.limit) for k in (1, 2, 3)] == [6.0, 4.0, 2.5]
    blk = x[:, :ch.block_in]
    gains = {}
    for k, c in lv.items():
        _, _, gout = c.front.call_nb(c.init_state()["front"], blk,
                                     c.init_state()["nbg"], c.ons["nb"],
                                     c.nb.limit)
        gains[k] = float(gout.mean())
    assert gains[1] >= gains[2] > gains[3]     # lower limit blanks more
    plain = RxChain.create(RxChainConfig(sample_rate=FS, channels=2),
                           device="cpu")
    with pytest.raises(KeyError):
        plain.set_nb_level(2)


def test_fused_nb_equals_standalone_and_host_detect_routes(small_featured):
    """As tests/test_pallas_fused.py::test_chain_fused_nb_gain_equals_
    standalone_apply (> 45 dB): detection in the front kernel, detection
    by torch ops with the gain in the kernel, and the standalone
    full-rate blanker give the same audio."""
    cfg = RxChainConfig(sample_rate=FS, channels=8, audio_block=512,
                        agc=False, noise_blanker=2, fused_frontend=True)
    ch = RxChain.create(cfg, tune_hz=TUNE[:8], mode=int(Mode.USB),
                        device="cpu")
    host = ch.with_host_nb_detect()
    sep = dataclasses.replace(ch, front=dataclasses.replace(ch.front,
                                                            rc=None))
    assert ch._nb_fused and host._nb_gained
    assert not (sep._nb_fused or sep._nb_gained)
    rng = np.random.default_rng(34)
    x = 0.05 * (rng.standard_normal((8, 3 * ch.block_in))
                + 1j * rng.standard_normal((8, 3 * ch.block_in)))
    x[:, 12000:12006] += 30.0
    x = torch.as_tensor(x.astype(np.complex64))
    _, a = _run(ch, x)
    _, b = _run(host, x)
    _, c = _run(sep, x)
    plain = RxChain.create(dataclasses.replace(cfg, noise_blanker=0),
                           tune_hz=TUNE[:8], mode=int(Mode.USB), device="cpu")
    _, d = _run(plain, x)
    assert snr_rows(c.numpy(), a.numpy()).min() > 45.0
    assert snr_rows(c.numpy(), b.numpy()).min() > 45.0
    assert snr_rows(a.numpy(), b.numpy()).min() > 90.0
    assert snr_rows(c.numpy(), d.numpy()).min() < 20.0   # blanking mattered
    with pytest.raises(ValueError):
        sep.with_host_nb_detect()


def test_nfm_chain_matches_jax():
    """The NFM receiver: 192 kS/s, all FM, FM squelch, the /4 cascade
    fused into the plain front kernel.  FM audio by RMS (0.5 dB) where it
    misses the sample-by-sample floor; the squelch's hold and gain state
    equal."""
    fs = 192000.0
    kw = dict(sample_rate=fs, channels=C, audio_block=512, agc=True,
              fm_squelch=True, fused_frontend=True)
    tune = [(-fs / 4 + (i + 0.5) * fs / (2 * C)) for i in range(C)]
    jch = JRxChain.create(JRxChainConfig(**kw), tune, int(Mode.FM))
    ch = RxChain.create(RxChainConfig(**kw), tune, int(Mode.FM),
                        device="cpu")
    assert ch.front.decim == jch.front.decim == 4 and not ch.stages
    assert ch.front.nb_detect is None and ch.block_in == jch.block_in
    rng = np.random.default_rng(35)
    n = NBLK * ch.block_in
    t = np.arange(n) / fs
    # the default threshold is -60 dB: noise at 1e-4 stays closed, the
    # carriers on every 4th channel open
    x = 1e-4 * (rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n)))
    for c in range(0, C, 4):
        x[c] += 0.3 * np.exp(2j * np.pi * (tune[c] * t + 3.0 * np.sin(
            2 * np.pi * 700.0 * t)))
    x = x.astype(np.complex64)
    js, ps = jch.init_state(), ch.init_state()
    for i in range(NBLK):
        blk = x[:, i * ch.block_in:(i + 1) * ch.block_in]
        js, ja = jch.step(js, blk)
        ps, pa = ch.step(ps, torch.as_tensor(blk))
        ja, pa = np.asarray(ja), pa.numpy()
        assert np.array_equal(ps["fm_sq"][0].numpy(), np.asarray(js["fm_sq"][0]))
        assert np.allclose(ps["fm_sq"][1].numpy(), np.asarray(js["fm_sq"][1]),
                           atol=1e-6)
        closed = ps["fm_sq"][0].numpy() == 0
        assert closed[1] and not closed[0]
        if i >= 2:
            assert np.all(pa[closed] == 0) and np.all(ja[closed] == 0)
            s = snr_rows(ja[~closed], pa[~closed])
            for r in np.nonzero(s <= 90.0)[0]:
                db = 10 * np.log10(np.mean(pa[~closed][r] ** 2)
                                   / np.mean(ja[~closed][r] ** 2))
                assert abs(db) < 0.5, (r, s[r], db)


def test_wcp_chain_converts_and_matches_jax():
    """agc_profile="wcp": the WcpAGC's constants and its state dict (int32
    counters) cross through ``convert``; 2 blocks in JAX, then 2 in the
    port from the carried state.  Non-FM rows > 80 dB (the state machine
    decides per sample on float32 values)."""
    kw = dict(sample_rate=48e3, channels=4, audio_block=512, agc=True,
              agc_profile="wcp")
    tune = [1000.0, -2000.0, 3000.0, 500.0]
    jch = JRxChain.create(JRxChainConfig(**kw), tune, MODES)
    made = RxChain.create(RxChainConfig(**kw), tune, MODES, device="cpu")
    conv = convert.rx_chain_from_numpy(_jax_chain_arrays(jch), "cpu")
    assert type(conv.agc) is type(made.agc)
    assert (conv.agc.hang_samples, conv.agc.hang_enable,
            conv.agc.lookahead) == (made.agc.hang_samples,
                                    made.agc.hang_enable, made.agc.lookahead)
    assert sorted(conv.agc.k) == sorted(made.agc.k)
    for name, v in made.agc.k.items():
        assert torch.equal(v, conv.agc.k[name]), name
    rng = np.random.default_rng(36)
    n = 4 * jch.block_in
    x = (0.1 * (rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n)))
         * (1.0 + (np.arange(n) % 700 < 350))).astype(np.complex64)
    js = jch.init_state()
    outs = []
    for i in range(4):
        js, ja = jch.step(js, x[:, i * jch.block_in:(i + 1) * jch.block_in])
        outs.append(np.asarray(ja))
        if i == 1:
            mid = _tree_np(js)
    st = convert.rx_state_from_numpy(mid, "cpu")
    for name in ("hang_counter", "state", "decay_type"):
        assert st["agc"][name].dtype == torch.int32
    for i in (2, 3):
        st, a = conv.step(st, torch.as_tensor(
            x[:, i * jch.block_in:(i + 1) * jch.block_in]))
        assert snr_rows(outs[i][:3], a.numpy()[:3]).min() > 80.0
    back = convert.rx_state_to_numpy(st)
    for name in ("hang_counter", "state", "decay_type"):
        assert back["agc"][name].dtype == np.int32
        assert np.array_equal(back["agc"][name], np.asarray(js["agc"][name]))
