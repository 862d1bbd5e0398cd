"""The port's TxChain against the JAX package's TxChain on the same numpy
audio (float32 on the CPU, torch on one thread), and the behaviour the JAX
package's own TX tests check, run on the port.

Every row of every configuration must reach >= 80 dB against the JAX
chain over 4 blocks: ALC on and off, every mode (USB, LSB, AM, FM with and
without CTCSS, CWU, IMD, DGT_U), the options (CESSB, predistortion slot,
phase rotator, pre-emphasis, compression, interpolation to 96 and 192 kS/s)
and the setters.  ``convert`` carries a JAX chain's parameters and its
state after block 2 into the port, which then matches the JAX chain.  The
TX->RX loopback runs through the port's own RxChain."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from quisk_tpu.io import sources
from quisk_tpu.modes import Mode
from quisk_tpu.oracle import dsp
from quisk_tpu.tx import TxChain as JTxChain
from quisk_tpu.tx import TxChainConfig as JTxChainConfig

from quisk_tpu_torch import convert
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.rx import RxChain, RxChainConfig
from quisk_tpu_torch.tx import TxChain, TxChainConfig
from quisk_tpu_torch.tx.ptt import PttController, VoxControl

CPU = "cpu"
FS = 48000.0
B = 1024
TX_FLOOR_DB = 80.0
ALL_MODES = [int(m) for m in (Mode.USB, Mode.LSB, Mode.AM, Mode.FM,
                              Mode.CWU, Mode.IMD, Mode.DGT_U, Mode.FM)]
# CESSB's in-band filter is the upper band (300-2700 Hz above the carrier)
# in both packages, so it leaves a lower-sideband row at its stopband
# (~1e-5 RMS): with CESSB on the LSB row becomes a second USB row
CESSB_MODES = [int(Mode.USB) if m == int(Mode.LSB) else m for m in ALL_MODES]


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The port's CPU ops on one thread (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_rows(ref, got):
    ref = np.asarray(ref).astype(np.complex128)
    err = np.asarray(got).astype(np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2, axis=-1)
                         / (np.mean(np.abs(err) ** 2, axis=-1) + 1e-300))


def mic_audio(modes, n, seed, amp=0.7):
    """Voice-like audio on every row; CW rows a keyed 5 ms-edged envelope."""
    rng = np.random.default_rng(seed)
    out = np.empty((len(modes), n), np.float32)
    key = (np.arange(n) // 1500) % 2 == 0
    ramp = np.convolve(key.astype(np.float64), np.hanning(241) / np.hanning(
        241).sum(), "same")
    for c, m in enumerate(modes):
        if m in (int(Mode.CWU), int(Mode.CWL)):
            out[c] = ramp
        else:
            v = sources.voice_like(FS, n, seed=int(rng.integers(1 << 30)))
            out[c] = amp * v / np.max(np.abs(v))
    return out


def jax_tx_arrays(ch) -> dict:
    """The JAX TxChain's parameters as the numpy dict convert reads."""
    def a(v):
        return np.asarray(v)
    p = {"channels": ch.channels, "block": ch.block, "block_tx": ch.block_tx,
         "audio_rate": ch.audio_rate, "mode": a(ch.mode),
         "analytic": {"mask": a(ch.analytic.mask),
                      "ntaps": ch.analytic.ntaps,
                      "block": ch.analytic.block},
         "preemph": {"c": a(ch.preemph.c)},
         "comp": {"knee": a(ch.comp.knee), "ceiling": a(ch.comp.ceiling),
                  "gain": a(ch.comp.gain)},
         "trim": tuple(a(t) for t in ch.trim), "spot": a(ch.spot),
         "tune": {"word": a(ch.tune.word), "block": ch.tune.block},
         "pm_gain": a(ch.pm_gain), "ctcss_word": a(ch.ctcss_word),
         "ctcss_amp": a(ch.ctcss_amp), "am_carrier": a(ch.am_carrier)}
    if ch.phrot is not None:
        p["phrot"] = {"b0": a(ch.phrot.b0), "nstages": ch.phrot.nstages}
    if ch.alc is not None:
        p["alc"] = {k: a(getattr(ch.alc, k)) for k in (
            "target", "gain_max", "gain_min", "d_limit", "min_magn", "mode")}
        p["alc"].update(buf=ch.alc.buf, n_modes=ch.alc.n_modes)
    if ch.cessb is not None:
        p["cessb"] = {"taps1": a(ch.cessb.fir1.taps),
                      "taps2": a(ch.cessb.fir2.taps),
                      "block": ch.cessb.fir1.block,
                      "ceiling": a(ch.cessb.ceiling)}
    if ch.predist is not None:
        p["predist"] = {"c_re": a(ch.predist.c_re), "c_im": a(ch.predist.c_im),
                        "env_max": a(ch.predist.env_max)}
    if ch.interp is not None:
        p["interp"] = {"M": a(ch.interp.M), "interp": ch.interp.interp,
                       "ntaps": ch.interp.ntaps, "block": ch.interp.block,
                       "R": ch.interp.R}
    return p


_jstep = jax.jit(lambda ch, st, a: ch.step(st, a))


def run_both(jtx, tx, audio, jst=None, pst=None):
    """Both chains over ``audio`` block by block: (jax iq, port iq, states)."""
    jst = jtx.init_state() if jst is None else jst
    pst = tx.init_state() if pst is None else pst
    jy, py = [], []
    for i in range(audio.shape[-1] // tx.block):
        a = np.ascontiguousarray(audio[:, i * tx.block:(i + 1) * tx.block])
        jst, y = _jstep(jtx, jst, jnp.asarray(a))
        jy.append(np.asarray(y))
        pst, y = tx.step(pst, torch.as_tensor(a))
        py.append(y.numpy())
    return (np.concatenate(jy, axis=-1), np.concatenate(py, axis=-1),
            jst, pst)


def both(cfg: dict, modes):
    jtx = JTxChain.create(JTxChainConfig(**cfg), mode=modes)
    tx = TxChain.create(TxChainConfig(**cfg), mode=modes, device=CPU)
    return jtx, tx


CONFIGS = {
    "alc": dict(alc=True),
    "no-alc": dict(alc=False),
    "bench-192k-ctcss": dict(alc=True, tx_rate=192000.0, compress_db=6.0,
                             preemphasis=0.3, ctcss_hz=100.0),
    "options-96k": dict(alc=True, tx_rate=96000.0, cessb=True,
                        predistort=True, phase_rotator=True,
                        compress_db=10.0, preemphasis=0.5),
    "options-no-alc": dict(alc=False, cessb=True, phase_rotator=True,
                           ctcss_hz=88.5, compress_db=14.0),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tx_chain_matches_jax(name):
    cfg = dict(channels=len(ALL_MODES), audio_block=B, **CONFIGS[name])
    modes = CESSB_MODES if cfg.get("cessb") else ALL_MODES
    jtx, tx = both(cfg, modes)
    audio = mic_audio(modes, 4 * B, 1)
    jy, py, _, pst = run_both(jtx, tx, audio)
    assert py.shape == (len(modes), 4 * tx.block_tx)
    assert np.all(np.isfinite(py))
    snr = snr_rows(jy, py)
    assert np.all(snr >= TX_FLOOR_DB), (name, np.round(snr, 1))
    if cfg["alc"]:
        assert pst["alc"]["buffer"].dtype == torch.complex64


def test_tx_setters_match_jax():
    cfg = dict(channels=len(ALL_MODES), audio_block=B, alc=False,
               tx_rate=96000.0)
    jtx, tx = both(cfg, ALL_MODES)
    spot0 = tx.spot.clone()
    word0 = tx.tune.word.clone()
    trim0 = tuple(t.clone() for t in tx.trim)
    edits = [
        lambda c: c.set_tune(1500.0),
        lambda c: c.set_tune(-700.0, channel=2),
        lambda c: c.set_spot(0.4, channel=1),
        lambda c: c.set_ampl_phase(0.02, 3.0),
        lambda c: c.set_ampl_phase(-0.01, -2.0, channel=3),
        lambda c: c.set_audio_settings(
            clip_db=[12.0, 0.0, 6.0, 3.0, 0.0, 9.0, 1.0, 20.0],
            preemph=[0.5, 0.0, 0.3, 0.9, 0.0, 0.1, 0.2, 0.7]),
        lambda c: c.set_ctcss(88.5, 2500.0, 2700.0),
    ]
    for e in edits:
        jtx, tx = e(jtx), e(tx)
    audio = mic_audio(ALL_MODES, 3 * B, 2)
    jy, py, _, _ = run_both(jtx, tx, audio)
    snr = snr_rows(jy, py)
    assert np.all(snr >= TX_FLOOR_DB), np.round(snr, 1)
    # the spot row is one carrier at the TX tune offset
    f = np.fft.fftfreq(py.shape[-1], 1 / 96000.0)
    assert abs(f[np.argmax(np.abs(np.fft.fft(py[1])))] - 1500.0) < 50.0
    # the setters left the first chain's tensors as they were
    first = TxChain.create(TxChainConfig(**cfg), mode=ALL_MODES, device=CPU)
    assert torch.equal(first.spot, spot0)
    assert torch.equal(first.tune.word, word0)
    assert all(torch.equal(a, b) for a, b in zip(first.trim, trim0))
    tx2 = first.set_spot(0.3, channel=0).set_tune(900.0, channel=1) \
        .set_ampl_phase(0.05, 1.0, channel=2)
    assert torch.equal(first.spot, spot0) and torch.equal(
        first.tune.word, word0)
    assert all(torch.equal(a, b) for a, b in zip(first.trim, trim0))
    assert float(tx2.spot[0, 0]) == pytest.approx(0.3)


@pytest.mark.parametrize("alc", [True, False])
def test_convert_continues_the_jax_chain(alc):
    cfg = dict(channels=len(ALL_MODES), audio_block=B, alc=alc,
               tx_rate=192000.0, compress_db=6.0, preemphasis=0.3,
               cessb=True, predistort=True, phase_rotator=True)
    jtx = JTxChain.create(JTxChainConfig(**cfg), mode=CESSB_MODES)
    jtx = jtx.set_tune(1200.0).set_spot(0.2, channel=5)
    audio = mic_audio(CESSB_MODES, 4 * B, 3)
    jst = jtx.init_state()
    for i in range(2):
        jst, _ = _jstep(jtx, jst, jnp.asarray(audio[:, i * B:(i + 1) * B]))
    tx = convert.tx_chain_from_numpy(jax_tx_arrays(jtx), device=CPU)
    s_np = jax.device_get(jst)
    pst = convert.tx_state_from_numpy(s_np, device=CPU)
    assert pst["tune_phase"].dtype == torch.int64
    if alc:
        assert pst["alc"]["buffer"].dtype == torch.complex64
        assert pst["alc"]["block_index"].dtype == torch.int32
    back = convert.tx_state_to_numpy(pst)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(s_np)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(a, b)
    jy, py, _, _ = run_both(jtx, tx, audio[:, 2 * B:], jst, pst)
    snr = snr_rows(jy, py)
    assert np.all(snr >= TX_FLOOR_DB), np.round(snr, 1)


def test_create_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TxChain.create(TxChainConfig(channels=2))
    tx = TxChain.create(TxChainConfig(channels=2), device="cpu")
    assert tx.device.type == "cpu"


def test_state_lies_on_the_chain_device():
    """Every state leaf of a chain, complex histories included, lies on
    the chain's device."""
    tx = TxChain.create(TxChainConfig(channels=2, tx_rate=192000.0,
                                      cessb=True, predistort=True,
                                      phase_rotator=True), device=CPU)
    leaves = [v for v in jax.tree_util.tree_leaves(
        tx.init_state(), is_leaf=lambda x: isinstance(x, torch.Tensor))
        if isinstance(v, torch.Tensor)]
    assert leaves and all(v.device.type == "cpu" for v in leaves)


# --------------------------------------------------------------- behaviour
def _stream(tx, audio2d):
    st = tx.init_state()
    outs = []
    for i in range(audio2d.shape[1] // tx.block):
        st, iq = tx.step(st, torch.as_tensor(np.ascontiguousarray(
            audio2d[:, i * tx.block:(i + 1) * tx.block])))
        outs.append(iq.numpy())
    return np.concatenate(outs, axis=-1)


def test_tx_ssb_spectrum_one_sided():
    voice = sources.voice_like(FS, 8 * 2048).astype(np.float32)
    tx = TxChain.create(TxChainConfig(channels=2, alc=False),
                        mode=[int(Mode.USB), int(Mode.LSB)], device=CPU)
    iq = _stream(tx, np.broadcast_to(voice, (2, len(voice))))
    F = np.fft.fftfreq(4 * 2048, 1 / FS)
    for c, sign in ((0, 1), (1, -1)):
        X = np.abs(np.fft.fft(iq[c][4 * 2048:]))
        want = X[(sign * F > 300) & (sign * F < 2700)]
        image = X[(-sign * F > 300) & (-sign * F < 2700)]
        assert 20 * np.log10(want.mean() / (image.mean() + 1e-12)) > 40


def test_tx_fm_deviation_and_ctcss():
    f_tone = 1000.0
    n = 8 * 2048
    tone = np.sin(2 * np.pi * f_tone / FS * np.arange(n)).astype(np.float32)
    tx = TxChain.create(TxChainConfig(channels=1, alc=False,
                                      fm_deviation_hz=2500.0),
                        mode=int(Mode.FM), device=CPU)
    iq = _stream(tx, tone[None])[0]
    assert np.max(np.abs(np.abs(iq[2048:]) - 1.0)) < 1e-3
    want = 2500.0 * f_tone / 2700.0
    finst = np.angle(iq[1:] * np.conj(iq[:-1])) * FS / (2 * np.pi)
    assert abs(np.max(finst[2048:]) - want) < 0.1 * want
    # CTCSS alone: a 100 Hz tone at 15% of the deviation
    tx = TxChain.create(TxChainConfig(channels=1, alc=False,
                                      fm_deviation_hz=2500.0,
                                      ctcss_hz=100.0),
                        mode=int(Mode.FM), device=CPU)
    iq = _stream(tx, np.zeros((1, n), np.float32))[0]
    finst = np.angle(iq[1:] * np.conj(iq[:-1])) * FS / (2 * np.pi)
    assert abs(np.max(np.abs(finst[2048:])) - 375.0) < 125.0
    X = np.abs(np.fft.rfft(finst[2048:2048 + 4 * 2048]))
    f = np.fft.rfftfreq(4 * 2048, 1 / FS)
    assert abs(f[np.argmax(X[1:]) + 1] - 100.0) < 15.0


def test_tx_am_envelope():
    voice = 0.5 * sources.voice_like(FS, 4 * 2048).astype(np.float32)
    voice /= np.max(np.abs(voice))
    tx = TxChain.create(TxChainConfig(channels=1, alc=False),
                        mode=int(Mode.AM), device=CPU)
    env = np.abs(_stream(tx, voice[None])[0])
    assert env.min() > -0.01 and env.max() < 1.05


def _loopback_oracle(voice, mode):
    """What the RX should hear (tests/test_tx.py:101-117): the TX's own
    bandpassed audio, for FM differentiated and de-emphasised."""
    taps = design.bandpass_analytic(513, 300.0, 2700.0, FS)
    _, bp = dsp.fir_stream(voice.astype(np.float64), np.real(taps) * 2.0)
    if mode == Mode.FM:
        a = np.exp(-2 * np.pi * 300.0 / FS)
        return dsp.one_pole(np.diff(bp, prepend=0.0), a, 1 - a)
    return bp


@pytest.mark.parametrize("mode", [Mode.USB, Mode.LSB, Mode.AM, Mode.FM])
def test_tx_rx_loopback_through_the_port(mode):
    nblk = 16
    voice = sources.voice_like(FS, nblk * 2048,
                               band=(400.0, 2400.0)).astype(np.float32)
    voice *= 0.4 / np.max(np.abs(voice))
    tx = TxChain.create(TxChainConfig(channels=1, alc=False,
                                      fm_deviation_hz=2500.0),
                        mode=int(mode), device=CPU)
    iq = _stream(tx, voice[None]).astype(np.complex64)
    rx = RxChain.create(RxChainConfig(sample_rate=FS, channels=1, agc=False,
                                      fm_deviation_hz=2500.0),
                        tune_hz=[0.0], mode=int(mode), device=CPU)
    _, audio = rx.process(rx.init_state(), torch.as_tensor(iq))
    snr = dsp.frac_align_snr(_loopback_oracle(voice, mode), audio.numpy()[0],
                             skip=4 * 2048)
    assert snr > 18, (mode, snr)


def test_cessb_bounds_the_envelope():
    tx = TxChain.create(TxChainConfig(channels=1, compress_db=14.0,
                                      cessb=True, alc=False),
                        mode=int(Mode.USB), device=CPU)
    voice = sources.voice_like(FS, 16 * tx.block).astype(np.float32)
    env = np.abs(_stream(tx, (2.5 * voice / np.max(np.abs(voice)))[None])[0])
    env = env[4 * tx.block:]
    assert np.max(env) < 1.15, np.max(env)
    assert np.sqrt(np.mean(env ** 2)) > 0.05


def test_identity_predistorter_slot_changes_nothing():
    cfg = dict(channels=1, audio_block=B)
    tx = TxChain.create(TxChainConfig(predistort=True, **cfg),
                        mode=int(Mode.USB), device=CPU)
    tx0 = TxChain.create(TxChainConfig(**cfg), mode=int(Mode.USB),
                         device=CPU)
    voice = 0.3 * sources.voice_like(FS, 4 * B).astype(np.float32)[None]
    assert np.allclose(_stream(tx, voice), _stream(tx0, voice), atol=1e-6)


def test_vox_and_ptt_timeout():
    vox = VoxControl(FS, 2048, threshold=0.05, hold_secs=0.2)
    assert vox.process(0.3 * np.ones(2048)) is True
    hold = 0
    while vox.process(0.001 * np.ones(2048)):
        hold += 1
    assert 3 <= hold <= 6
    ptt = PttController(FS, 2048, max_tx_secs=0.2, repeater_hold_secs=0.1)
    on = [ptt.process(ptt=True) for _ in range(10)]
    assert on[0] and not on[-1]
    assert ptt.process(ptt=True) is False           # still latched
    ptt.process(ptt=False)                          # release clears it
    assert ptt.process(ptt=True) is True
    ptt2 = PttController(FS, 2048)
    ptt2.tx_inhibit = True
    assert ptt2.process(ptt=True, cw_key=True, vox=True) is False
    ptt3 = PttController(FS, 2048, repeater_hold_secs=0.1)
    ptt3.process(ptt=True)
    tail = 0
    while ptt3.process(ptt=False):
        tail += 1
    assert 1 <= tail <= 4


def test_ptt_copies_agree_with_the_jax_package():
    from quisk_tpu.tx import ptt as jptt
    rng = np.random.default_rng(4)
    v, jv = VoxControl(FS, 2048, 0.05, 0.3), jptt.VoxControl(FS, 2048,
                                                               0.05, 0.3)
    p = PttController(FS, 2048, max_tx_secs=0.5, repeater_hold_secs=0.2)
    jp = jptt.PttController(FS, 2048, max_tx_secs=0.5,
                            repeater_hold_secs=0.2)
    for _ in range(200):
        blk = rng.uniform(0, 0.12) * rng.standard_normal(2048)
        keys = dict(ptt=bool(rng.random() < 0.3),
                    cw_key=bool(rng.random() < 0.1))
        assert v.process(blk) == jv.process(blk)
        assert p.process(vox=v.level > 0.5, **keys) == jp.process(
            vox=jv.level > 0.5, **keys)


def test_cw_keyed_carrier_is_click_free():
    from quisk_tpu.app.cw import KeyEnvelope, text_to_key_samples
    tx = TxChain.create(TxChainConfig(channels=1, alc=False),
                        mode=int(Mode.CWU), device=CPU)
    key = text_to_key_samples("paris", 25.0, FS)
    n = (len(key) // tx.block + 1) * tx.block
    env = KeyEnvelope(FS, rise_ms=5.0).process(np.resize(key, n))
    iq = _stream(tx, env[None].astype(np.float32))[0]
    assert 0.9 < np.max(np.abs(iq)) <= 1.01
    S = np.abs(np.fft.fft(iq * np.hanning(len(iq)))) ** 2
    f = np.fft.fftfreq(len(iq), 1 / FS)
    carrier = S[np.abs(f) < 100.0].sum()
    splatter = S[np.abs(f) > 250.0].sum()
    assert 10 * np.log10(carrier / (splatter + 1e-12)) > 35.0


def test_spot_transmits_a_plain_carrier():
    tx = TxChain.create(TxChainConfig(channels=2, alc=False), mode=2,
                        device=CPU)
    a = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 2048)).astype(np.float32) * 0.3)
    st = tx.init_state()
    _, iq_mod = tx.step(st, a)
    _, iq_spot = tx.set_spot(0.5).step(st, a)
    assert torch.allclose(iq_spot, torch.full_like(iq_spot, 0.5), atol=1e-6)
    assert not torch.allclose(iq_mod, torch.full_like(iq_mod, 0.5),
                              atol=1e-3)
    _, iq_one = tx.set_spot(0.3, channel=1).step(st, a)
    assert torch.allclose(iq_one[1], torch.full_like(iq_one[1], 0.3),
                          atol=1e-6)
    assert not torch.allclose(iq_one[0], torch.full_like(iq_one[0], 0.3),
                              atol=1e-3)


def test_dgt_rows_get_the_wide_filter_beside_a_voice_row():
    t = np.arange(16 * 2048) / FS
    tone = (0.5 * np.sin(2 * np.pi * 2900.0 * t)).astype(np.float32)
    tx = TxChain.create(TxChainConfig(channels=2, alc=False),
                        mode=[int(Mode.DGT_U), int(Mode.USB)], device=CPU)
    assert tx.analytic.mask.shape[0] == 2
    iq = _stream(tx, np.stack([tone, tone]))[:, 8 * 2048:]
    p = np.mean(np.abs(iq) ** 2, axis=-1)
    assert p[0] > 10.0 * p[1], p


def test_imd_mode_generates_two_tone():
    tx = TxChain.create(TxChainConfig(channels=1, alc=False),
                        mode=int(Mode.IMD), device=CPU)
    iq = _stream(tx, np.zeros((1, 8 * 2048), np.float32))[0][2 * 2048:]
    S = np.abs(np.fft.fft(iq * np.hanning(len(iq))))
    f = np.fft.fftfreq(len(iq), 1 / FS)
    floor = np.median(S)
    for f0 in (700.0, 1900.0):
        k = np.argmin(np.abs(f - f0))
        assert S[k - 2:k + 3].max() > 100 * floor


def test_audio_settings_zero_rows_pass_through():
    tx = TxChain.create(TxChainConfig(channels=2, alc=False),
                        mode=[int(Mode.USB)] * 2, device=CPU)
    a = torch.as_tensor((0.9 * np.random.default_rng(3).standard_normal(
        (2, 2048))).astype(np.float32))
    _, iq0 = tx.step(tx.init_state(), a)
    hot = tx.set_audio_settings(clip_db=[12.0, 0.0], preemph=[0.5, 0.0])
    _, iq1 = hot.step(tx.init_state(), a)
    assert torch.equal(iq1[1], iq0[1])
    assert float((iq1[0] - iq0[0]).abs().max()) > 1e-3
    assert dataclasses.fields(hot) == dataclasses.fields(tx)
