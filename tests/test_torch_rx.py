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
"""

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
                 "decim": ch.front.decim, "block": ch.front.block}
    d = ch.demod
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
        "agc": ({"target": ch.agc.target, "max_lgain": ch.agc.max_lgain,
                 "release_inc": ch.agc.release_inc,
                 "lookahead": ch.agc.lookahead}
                if ch.agc is not None else None),
        "ons": {k: np.asarray(v) for k, v in ch.ons.items()},
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


@pytest.mark.parametrize("opt", [{"noise_blanker": 1}, {"auto_notch": True},
                                 {"nr": True}, {"anf": True},
                                 {"squelch": True}, {"fm_squelch": True},
                                 {"front_cond": True}, {"dc_remove_bw": 1},
                                 {"agc_profile": "wcp"}])
def test_later_slice_stages_raise(opt):
    cfg = RxChainConfig(sample_rate=FS, channels=4, **opt)
    with pytest.raises(NotImplementedError, match="slice"):
        RxChain.create(cfg, device="cpu")


def test_config_refuses_tpu_only_field():
    """mxu_stft picks the MXU DFT form on the TPU; the port has no such
    choice, so the field is refused rather than silently ignored."""
    with pytest.raises(TypeError):
        RxChainConfig(sample_rate=FS, channels=4, mxu_stft=False)


def test_create_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RxChain.create(RxChainConfig(sample_rate=FS, channels=4))
