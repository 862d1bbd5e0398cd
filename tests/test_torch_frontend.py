"""The raw-IQ conditioner of the port (ops/ewscan.py, rx/frontend.py and its
place in RxChain) against the JAX package's on equal numpy inputs.

``ew_cumsum`` is two float32 triangular matmuls on both sides, built from
the same float64 weights: held to >= 100 dB against a float64 sequential
recurrence and against the JAX function.  The conditioner is elementwise
around it: >= 100 dB, its int32 counters equal.  The chain with the
conditioner ahead of the fused front end is held like the flagship chain
(tests/test_torch_rx.py): non-FM channels > 90 dB from block 2 on, FM by
RMS within 0.1 dB where they do not clear that.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from quisk_tpu.ops.ewscan import ew_cumsum as j_ew_cumsum
from quisk_tpu.rx import RxChain as JRxChain
from quisk_tpu.rx import RxChainConfig as JRxChainConfig
from quisk_tpu.rx import frontend as jfrontend

from quisk_tpu_torch import convert
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops.ewscan import ew_cumsum
from quisk_tpu_torch.rx import RxChain, RxChainConfig, frontend

FS = 960000.0


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """torch on one thread, as the other parity files run it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / (np.mean(np.abs(err) ** 2) + 1e-300))


def cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def t(a):
    return torch.as_tensor(np.asarray(a).copy())


# ---------------------------------------------------------------- ew_cumsum
@pytest.mark.parametrize("B,alpha", [(10240, 0.9995), (1000, 0.97),
                                     (100, -0.5), (128, 0.999)])
def test_ew_cumsum_matches_float64_and_jax(B, alpha):
    C = 6
    rng = np.random.default_rng(60)
    x = (rng.standard_normal((C, B)) + 0.3).astype(np.float32)
    y0 = rng.standard_normal(C).astype(np.float32)
    ref = np.empty((C, B))
    acc = y0.astype(np.float64)
    for n in range(B):
        acc = alpha * acc + x[:, n]
        ref[:, n] = acc
    got = ew_cumsum(t(x), alpha, t(y0)).numpy()
    jy = np.asarray(j_ew_cumsum(jnp.asarray(x), alpha, jnp.asarray(y0)))
    assert got.shape == (C, B) and got.dtype == np.float32
    assert snr_db(ref, got) > 100.0
    assert snr_db(jy, got) > 100.0


def test_dc_alpha_and_balance_matrix_equal():
    for bw, fs in ((2, 48e3), (300, 960e3), (50, 192e3)):
        assert frontend.dc_alpha(bw, fs) == jfrontend.dc_alpha(bw, fs)
    for args in ((0.0, 0.0, False), (0.01, 2.0, False), (-0.02, -1.5, True),
                 (0.0, 0.0, True)):
        assert frontend.balance_matrix(*args) == jfrontend.balance_matrix(
            *args)


# -------------------------------------------------------------- conditioner
def _cond_arrays(jc):
    return {"channels": jc.channels, "dc_mode": jc.dc_mode,
            "sample_rate": jc.sample_rate, "dc_a": jc.dc_a,
            "m00": np.asarray(jc.m00), "m10": np.asarray(jc.m10),
            "m11": np.asarray(jc.m11), "delay_sel": np.asarray(jc.delay_sel)}


def _tree_np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("dc_bw,delay,invert", [(0, 1, False), (0, 2, True),
                                                (300, 0, False),
                                                (300, 2, True)])
def test_conditioner_off_and_hp_match_jax(dc_bw, delay, invert):
    C, B = 8, 4096
    kw = dict(ampl=0.02, phase_deg=1.5, invert=invert, delay=delay,
              dc_bw=dc_bw)
    jc = jfrontend.FrontConditioner.create(C, FS, **kw)
    jc = jc.with_balance(-0.01, 0.7, invert, channel=3)
    pc = frontend.FrontConditioner.create(C, FS, device="cpu", **kw)
    pc = pc.with_balance(-0.01, 0.7, invert, channel=3)
    conv = convert.front_conditioner_from_numpy(_cond_arrays(jc), "cpu")
    assert pc.dc_mode == jc.dc_mode == ("hp" if dc_bw else "off")
    for f in ("m00", "m10", "m11", "delay_sel"):
        assert np.array_equal(np.asarray(getattr(jc, f)),
                              getattr(pc, f).numpy()), f
        assert torch.equal(getattr(pc, f), getattr(conv, f))
        assert getattr(pc, f).dtype == getattr(conv, f).dtype
    assert (conv.dc_a, conv.dc_mode) == (pc.dc_a, pc.dc_mode)
    rng = np.random.default_rng(61)
    js, ps = jc.init_state(C), pc.init_state(C)
    assert sorted(ps) == sorted(js)
    for blk in range(3):
        x = cnoise(rng, (C, B)) + np.complex64(0.4 - 0.2j)
        js, jy = jc(js, jnp.asarray(x))
        if blk == 1:         # the JAX state carried across mid-stream
            ps = convert.state_from_numpy(_tree_np(js), "cpu")
            continue
        ps, py = pc(ps, t(x))
        assert py.dtype == torch.complex64
        assert snr_db(jy, py.numpy()) > 100.0
        for k in js:
            assert np.allclose(np.asarray(js[k]), ps[k].numpy(), atol=1e-4)
    if dc_bw:                # the blocker has removed the offset by now
        assert abs(np.mean(py.numpy())) < 0.02


def test_conditioner_avg_mode_matches_jax_with_key_down():
    """The window average at a rate where the 1 s hold and the 2 s window
    pass within a few blocks; the key goes down for two blocks."""
    C, B, fs = 4, 1000, 2000.0
    jc = jfrontend.FrontConditioner.create(C, fs, dc_bw=1, delay=1)
    pc = frontend.FrontConditioner.create(C, fs, dc_bw=1, delay=1,
                                          device="cpu")
    assert pc.dc_mode == jc.dc_mode == "avg"
    rng = np.random.default_rng(62)
    js, ps = jc.init_state(C), pc.init_state(C)
    assert ps["count"].dtype == ps["key_delay"].dtype == torch.int32
    keys = [False] * 8 + [True, True] + [False] * 8
    averaged = 0
    for blk, key in enumerate(keys):
        x = cnoise(rng, (C, B)) + np.complex64(1.5 + 0.5j)
        js, jy = jc(js, jnp.asarray(x), key_down=key)
        ps, py = pc(ps, t(x), key_down=key)
        assert snr_db(jy, py.numpy()) > 100.0
        assert int(ps["count"]) == int(js["count"])
        assert int(ps["key_delay"]) == int(js["key_delay"])
        assert ps["count"].dtype == torch.int32
        assert np.allclose(np.asarray(js["avg_re"]), ps["avg_re"].numpy(),
                           atol=1e-5)
        averaged += bool(np.any(ps["avg_re"].numpy() != 0))
        if blk == 9:         # through convert and back, int32 kept
            back = convert.state_to_numpy(ps)
            assert back["count"].dtype == back["key_delay"].dtype == np.int32
            ps = convert.state_from_numpy(back, "cpu")
    assert averaged > 4 and abs(float(ps["avg_re"][0]) - 1.5) < 0.2


# ------------------------------------------------------------------ in chain
C = 128
MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]
MODE = [MODES[i % 4] for i in range(C)]
TUNE = [(-FS / 4 + (i + 0.5) * FS / (2 * C)) for i in range(C)]
FM_ROWS = [i for i in range(C) if MODE[i] == int(Mode.FM)]
OTHER_ROWS = [i for i in range(C) if MODE[i] != int(Mode.FM)]


def _cfg(cls):
    return cls(sample_rate=FS, channels=C, audio_block=512, agc=True,
               fused_frontend=True, front_cond=True, dc_remove_bw=300)


def snr_rows(ref, got):
    err = np.mean((got - ref) ** 2, axis=-1)
    return 10 * np.log10(np.mean(ref ** 2, axis=-1) / (err + 1e-30))


def _assert_block(ref, got):
    assert got.shape == ref.shape == (C, 512) and np.all(np.isfinite(got))
    s = snr_rows(ref, got)
    assert s[OTHER_ROWS].min() > 90.0, s[OTHER_ROWS].min()
    for r in FM_ROWS:
        if s[r] <= 90.0:
            db = 20 * np.log10(np.sqrt(np.mean(got[r] ** 2))
                               / np.sqrt(np.mean(ref[r] ** 2)))
            assert abs(db) < 0.1, (r, s[r], db)


def test_chain_with_conditioner_matches_jax():
    """front_cond=True, dc_remove_bw=300 at C=128: the trim set through
    ``cond.with_balance``, a DC offset on the input; 4 blocks, the JAX
    state carried into the port after 2 and the port's back after 3."""
    jch = JRxChain.create(_cfg(JRxChainConfig), tune_hz=TUNE, mode=MODE)
    pch = RxChain.create(_cfg(RxChainConfig), tune_hz=TUNE, mode=MODE,
                         device="cpu")
    assert pch.cond is not None and pch.cond.dc_mode == "hp"
    assert pch.front is not None and jch.front is not None
    jch = jch.replace(cond=jch.cond.with_balance(0.02, 1.5))
    pch = dataclasses.replace(pch, cond=pch.cond.with_balance(0.02, 1.5))
    assert pch.cond.dc_a == jch.cond.dc_a
    B = jch.block_in
    rng = np.random.default_rng(63)
    x = cnoise(rng, (C, 4 * B)) + np.complex64(0.5 + 0.25j)
    js, ps = jch.init_state(), pch.init_state()
    assert sorted(ps["cond"]) == sorted(js["cond"])
    for i in range(4):
        blk = x[:, i * B:(i + 1) * B]
        js, ja = jch.step(js, jnp.asarray(blk))
        ps, pa = pch.step(ps, t(blk))
        if i >= 2:
            _assert_block(np.asarray(ja), pa.numpy())
        if i == 1:
            np_state = {k: (_tree_np(v) if k == "cond" else
                            _leaves_np(v)) for k, v in js.items()}
            ps = convert.rx_state_from_numpy(np_state, "cpu")
        if i == 2:
            back = convert.rx_state_to_numpy(ps)
            assert sorted(back["cond"]) == sorted(js["cond"])
            js = {**js, "cond": back["cond"]}


def _leaves_np(tree):
    if isinstance(tree, dict):
        return {k: _leaves_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_leaves_np(v) for v in tree)
    return np.asarray(tree)


def test_conditioner_restores_an_imbalanced_source():
    """An image from a gain/phase-imbalanced source, trimmed away: the
    conditioner's correction inverts the imbalance."""
    C2, B = 2, 8192
    n = np.arange(B)
    s = np.exp(2j * np.pi * 0.05 * n)
    ampl, ph = 0.05, 3.0
    bad = (s.real * (1 + ampl)
           + 1j * (s.imag * np.cos(np.deg2rad(ph))
                   + s.real * np.sin(np.deg2rad(ph))))
    x = np.broadcast_to(bad.astype(np.complex64), (C2, B))
    pc = frontend.FrontConditioner.create(C2, 48e3, device="cpu")
    pc = pc.with_balance(ampl, ph, channel=1)
    _, y = pc(pc.init_state(C2), t(x))
    spec = np.abs(np.fft.fft(y.numpy() * np.hanning(B), axis=-1))
    k = int(round(0.05 * B))
    image_db = 20 * np.log10(spec[:, B - k] / spec[:, k])
    assert image_db[0] > -40.0 and image_db[1] < -80.0, image_db
