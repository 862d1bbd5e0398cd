"""The port's PLL demodulators (ops/pll.py and the ops around it) against
the JAX package, on the CPU, where the PLL kernel's wrappers take their
plain version.

- ``SyncAMDemod`` and ``PLLFMDemod`` (CTCSS notch on and off, de-emphasis
  at 300 Hz and at 20 kHz, i.e. off) against the JAX ops on the same numpy
  input, parameters carried by ``convert``: >= 100 dB per row over 8
  blocks of 2048, on rows with a station (clean, at two noise levels) and
  on noise alone.  Both packages run the same float32 step; they differ
  only in their libraries' cos / sin / atan2 and the loop is damped, so
  the difference stays at rounding level.  With the CTCSS notch the
  reference is the JAX op's loop and de-emphasis followed by the notch in
  float64: the JAX op's own float32 notch is 25-35 dB from that here.
- Streaming: a block split into two calls at an odd point equals one call
  (the same ops on the same numbers: bit for bit).
- The behaviour tests of tests/test_audio_shaping.py:116-143 and
  tests/test_nr.py:94-106 on the port.
- An RxChain at C=128 with each PLL demod registered as its EXT demod,
  against the JAX chain with the same factory registered, per row (the
  PLL-FM factory without the CTCSS notch, whose JAX op is off as above).
"""

import jax
import numpy as np
import pytest
import torch
from scipy import signal as sig

from quisk_tpu.io import sources
from quisk_tpu.oracle import dsp
from quisk_tpu.ops.demod import PLLFMDemod as JPLLFMDemod
from quisk_tpu.ops.demod import register_ext_demod as j_register
from quisk_tpu.ops.nr import SyncAMDemod as JSyncAMDemod
from quisk_tpu.rx import RxChain as JRxChain
from quisk_tpu.rx import RxChainConfig as JRxChainConfig

from quisk_tpu_torch import convert
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import pll
from quisk_tpu_torch.ops.demod import PLLFMDemod, register_ext_demod
from quisk_tpu_torch.ops.nr import SyncAMDemod
from quisk_tpu_torch.rx import RxChain, RxChainConfig

FS = 48000.0
B = 2048
NBLK = 8
PLL_DB = 100.0


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """One torch thread: on some CPU hosts torch's intra-op workers have
    returned cos/sin ~1e-4 off for a whole worker chunk."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _voice(n, seed):
    a = sources.voice_like(FS, n, seed=seed, band=(300.0, 2500.0))
    return 0.8 * a / np.max(np.abs(a))


def _rows(clean: np.ndarray, seed: int) -> np.ndarray:
    """[4, n]: the station clean, at 20 dB and at 6 dB SNR, noise alone."""
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(clean.size)
             + 1j * rng.standard_normal(clean.size)) / np.sqrt(2.0)
    return np.stack([clean, sources.awgn(clean, 20.0, seed=seed + 1),
                     sources.awgn(clean, 6.0, seed=seed + 2),
                     noise]).astype(np.complex64)


@pytest.fixture(scope="module")
def am_rows():
    n = NBLK * B
    return _rows(sources.am_signal(_voice(n, 1), FS, carrier_hz=40.0,
                                   depth=0.5), 10)


@pytest.fixture(scope="module")
def fm_rows():
    n = NBLK * B
    t = np.arange(n) / FS
    audio = 0.6 * _voice(n, 2) + 0.15 * np.sin(2 * np.pi * 100.0 * t)
    return _rows(sources.fm_signal(audio, FS, deviation_hz=5000.0,
                                   carrier_hz=300.0), 20)


def _stream(op, x, nblk=NBLK, state=None):
    """Stream nblk blocks through op (a JAX op under jit, or the port's)."""
    st = op.init_state(x.shape[0]) if state is None else state
    step = op if isinstance(x, torch.Tensor) else jax.jit(op.__call__)
    outs = []
    for i in range(nblk):
        st, y = step(st, x[:, i * B:(i + 1) * B])
        outs.append(np.asarray(y))
    return st, np.concatenate(outs, axis=-1)


def snr_rows(ref, got):
    err = np.mean((got.astype(np.float64) - ref) ** 2, axis=-1)
    return 10 * np.log10(np.mean(ref.astype(np.float64) ** 2, axis=-1)
                         / (err + 1e-30))


def _f(op, names):
    return {n: np.asarray(getattr(op, n)) for n in names}


def sync_am_arrays(j) -> dict:
    return _f(j, ("alpha", "beta", "dc_pole", "max_freq"))


def pll_fm_arrays(j) -> dict:
    d = _f(j, ("alpha", "beta", "gain", "max_freq"))
    d["deemph_a"], d["deemph_b"] = np.asarray(j.deemph.a), np.asarray(
        j.deemph.b)
    d["notch"] = (_f(j.notch, ("b0", "b1", "b2", "a1", "a2"))
                  if j.notch is not None else None)
    return d


# ------------------------------------------------------ parity with the JAX ops
def test_sync_am_matches_jax(am_rows):
    j = JSyncAMDemod.create(FS, bw_hz=150.0)
    made = SyncAMDemod.create(FS, bw_hz=150.0, device="cpu")
    op = convert.sync_am_from_numpy(sync_am_arrays(j), "cpu")
    for f in ("alpha", "beta", "dc_pole", "max_freq"):
        assert torch.equal(getattr(made, f), getattr(op, f)), f
    jst, jy = _stream(j, am_rows)
    pst, py = _stream(op, torch.as_tensor(am_rows))
    s = snr_rows(jy, py)
    assert np.all(np.isfinite(py)) and s.min() >= PLL_DB, s
    for a, b in zip(jst, pst):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < 1e-4


@pytest.mark.parametrize("ctcss_hz,deemph_hz", [(0.0, 300.0), (100.0, 300.0),
                                                (0.0, 20000.0),
                                                (100.0, 20000.0)])
def test_pll_fm_matches_jax(fm_rows, ctcss_hz, deemph_hz):
    j = JPLLFMDemod.create(FS, deviation_hz=5000.0, deemph_hz=deemph_hz,
                           ctcss_hz=ctcss_hz)
    made = PLLFMDemod.create(FS, deviation_hz=5000.0, deemph_hz=deemph_hz,
                             ctcss_hz=ctcss_hz, device="cpu")
    op = convert.pll_fm_from_numpy(pll_fm_arrays(j), "cpu")
    for f in ("alpha", "beta", "gain", "max_freq"):
        assert torch.equal(getattr(made, f), getattr(op, f)), f
    assert torch.equal(made.deemph.a, op.deemph.a)
    assert (made.notch is None) == (op.notch is None) == (ctcss_hz == 0.0)
    if op.notch is not None:
        assert torch.equal(made.notch.b1, op.notch.b1)
    _, jy = _stream(j, fm_rows)
    _, py = _stream(op, torch.as_tensor(fm_rows))
    assert np.all(np.isfinite(py))
    if j.notch is None:
        s = snr_rows(jy, py)
        assert s.min() >= PLL_DB, s
        return
    # The JAX op's notch is a float32 associative scan that lands 25-35 dB
    # from the float64 recurrence on this pole pair (r = 0.9987); the
    # port's Biquad scans in float64.  So the port is held to the JAX op's
    # loop and de-emphasis followed by the float64 notch, and must come
    # nearer to that than the JAX op does.
    _, jpre = _stream(j.replace(notch=None), fm_rows)
    ref = _notch_f64(j.notch, jpre)
    s = snr_rows(ref, py)
    assert s.min() >= PLL_DB, s
    assert np.all(snr_rows(ref, jy) < s - 20.0), (snr_rows(ref, jy), s)


def _notch_f64(notch, x):
    """The biquad recurrence in float64 from zero state, with the JAX op's
    float32 coefficients."""
    b = [float(np.asarray(getattr(notch, k))) for k in ("b0", "b1", "b2")]
    a = [1.0] + [float(np.asarray(getattr(notch, k))) for k in ("a1", "a2")]
    return sig.lfilter(b, a, x.astype(np.float64), axis=-1)


def test_state_carries_from_jax(fm_rows):
    """4 blocks in JAX, the state carried across by convert, 4 more in the
    port, against 8 in JAX."""
    j = JPLLFMDemod.create(FS)
    op = convert.pll_fm_from_numpy(pll_fm_arrays(j), "cpu")
    _, jy = _stream(j, fm_rows)
    jst, _ = _stream(j, fm_rows, nblk=4)
    pst = convert.state_from_numpy(
        tuple(tuple(np.asarray(v) for v in s) if isinstance(s, tuple)
              else np.asarray(s) for s in jst), "cpu")
    _, py = _stream(op, torch.as_tensor(fm_rows[:, 4 * B:]), nblk=4,
                    state=pst)
    assert snr_rows(jy[:, 4 * B:], py).min() >= PLL_DB


# ------------------------------------------------------------------ streaming
@pytest.mark.parametrize("mode", ["sync_am", "pll_fm"])
def test_split_block_equals_one_call(am_rows, mode):
    x = torch.as_tensor(am_rows[:, :B])
    op = (SyncAMDemod.create(FS, bw_hz=150.0, device="cpu")
          if mode == "sync_am" else PLLFMDemod.create(FS, device="cpu"))
    coef = op.coef()
    st0 = op.init_state(4)[:3 if mode == "sync_am" else 2]
    st1, y1 = pll.pll_demod_plain(mode, x, st0, coef)
    cut = 777
    sa, ya = pll.pll_demod_plain(mode, x[:, :cut], st0, coef)
    sb, yb = pll.pll_demod_plain(mode, x[:, cut:], sa, coef)
    assert torch.equal(torch.cat([ya, yb], dim=-1), y1)
    for a, b in zip(st1, sb):
        assert torch.equal(a, b)
    # the wrappers take the plain version on the CPU and count nothing
    n = (pll.pll_sync_am.launches, pll.pll_fm.launches)
    fn = pll.pll_sync_am if mode == "sync_am" else pll.pll_fm
    s2, y2 = fn(x, st0, coef)
    assert torch.equal(y2, y1)
    assert (pll.pll_sync_am.launches, pll.pll_fm.launches) == n


def test_wrapper_checks_its_inputs():
    x = torch.zeros((3, 8), dtype=torch.complex64)
    z = torch.zeros(3)
    coef = torch.zeros(4)
    with pytest.raises(ValueError):
        pll.pll_demod_plain("pll_fm", x, (z, z, z), coef)
    with pytest.raises(ValueError):
        pll.pll_demod_plain("sync_am", x, (z, torch.zeros(4), z), coef)
    with pytest.raises(TypeError):
        pll.pll_demod_plain("pll_fm", x.real.contiguous(), (z, z), coef)
    with pytest.raises(ValueError):
        pll.pll_demod_plain("am", x, (z, z), coef)


# ------------------------------------------------------------------ behaviour
def test_pll_fm_demod_recovers_audio():
    n = 16 * B
    audio = _voice(n, 0)
    iq = sources.fm_signal(audio, deviation_hz=5000.0, fs=FS)
    # de-emphasis off to compare against the raw modulating audio
    dem = PLLFMDemod.create(FS, deviation_hz=5000.0, deemph_hz=20000.0,
                            device="cpu")
    _, y = _stream(dem, torch.as_tensor(iq[None].astype(np.complex64)), 16)
    seg = slice(8 * B, 16 * B)
    snr = dsp.frac_align_snr(audio[seg], y[0][seg], max_lag=256)
    assert snr > 15.0, snr


def test_pll_fm_ctcss_notch():
    n = 16 * B
    t = np.arange(n) / FS
    audio = np.sin(2 * np.pi * 1000.0 * t)
    ctcss = 0.3 * np.sin(2 * np.pi * 100.0 * t)
    iq = sources.fm_signal(audio + ctcss, deviation_hz=5000.0, fs=FS)
    dem = PLLFMDemod.create(FS, deviation_hz=5000.0, ctcss_hz=100.0,
                            device="cpu")
    _, y = _stream(dem, torch.as_tensor(iq[None].astype(np.complex64)), 16)
    seg = slice(8 * B, 16 * B)
    f = np.fft.rfftfreq(8 * B, 1 / FS)
    Y = np.abs(np.fft.rfft(y[0][seg]))
    kc = np.argmin(np.abs(f - 100.0))
    kv = np.argmin(np.abs(f - 1000.0))
    assert Y[kc] / Y[kv] < 0.05, Y[kc] / Y[kv]


def test_sync_am_locks_and_demodulates():
    n = 16 * B
    audio = _voice(n, 0)
    # AM with a 40 Hz carrier offset: sync AM must lock and track
    iq = sources.am_signal(audio, FS, carrier_hz=40.0, depth=0.5)
    dem = SyncAMDemod.create(FS, bw_hz=150.0, device="cpu")
    _, y = _stream(dem, torch.as_tensor(iq[None].astype(np.complex64)), 16)
    seg = slice(8 * B, 16 * B)
    snr = dsp.frac_align_snr(audio[seg], y[0][seg], max_lag=64)
    assert snr > 20, snr


# ---------------------------------------------------------------- the chains
C = 128
CHAIN_BLOCKS = 4
CARRY_AT = 2                 # the port takes over the JAX chain's state here
CHAIN_DB = 90.0


def _register(name):
    if name == "pll_fm":
        j_register(name, lambda fs, ch: JPLLFMDemod.create(
            fs, deviation_hz=5000.0))
        register_ext_demod(name, lambda fs, ch, dev: PLLFMDemod.create(
            fs, deviation_hz=5000.0, device=dev))
    else:
        j_register(name, lambda fs, ch: JSyncAMDemod.create(fs, bw_hz=150.0))
        register_ext_demod(name, lambda fs, ch, dev: SyncAMDemod.create(
            fs, bw_hz=150.0, device=dev))


def _chain_case(name):
    """(config kwargs, modes, tune, input [C, n] with one input stream a
    channel): the NFM receiver (192 kS/s, FM squelch) with every row EXT,
    an FM station on each even row and 1e-4 of noise on each odd row (its
    squelch closes); or the 48 kS/s receiver with modes cycling
    USB/LSB/EXT/FM over noise, an AM station 40 Hz off its carrier on each
    EXT row."""
    rng = np.random.default_rng(40)
    if name == "pll_fm":
        fs = 192000.0
        cfg = dict(sample_rate=fs, channels=C, audio_block=B, agc=True,
                   fm_squelch=True, ext_demod=name)
        modes = [int(Mode.EXT)] * C
    else:
        fs = FS
        cfg = dict(sample_rate=fs, channels=C, audio_block=B, agc=True,
                   ext_demod=name)
        cyc = [int(Mode.USB), int(Mode.LSB), int(Mode.EXT), int(Mode.FM)]
        modes = [cyc[i % 4] for i in range(C)]
    tune = [(-fs / 4 + (i + 0.5) * fs / (2 * C)) for i in range(C)]
    n = CHAIN_BLOCKS * int(B * fs / 48000.0)
    x = (rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n)))
    if name == "pll_fm":
        x *= np.where(np.arange(C) % 2 == 0, 1.0, 1e-4)[:, None]
        t = np.arange(n) / fs
        audio = (0.5 * sources.voice_like(fs, n, seed=3, band=(300.0, 2500.0))
                 + 0.15 * np.sin(2 * np.pi * 100.0 * t))
        for c in range(0, C, 2):
            x[c] += 3.0 * sources.fm_signal(audio, fs, deviation_hz=2500.0,
                                            carrier_hz=tune[c])
    else:
        x *= 0.1
        voice = _voice(n, 4)
        for c in range(2, C, 4):
            x[c] += 3.0 * sources.am_signal(voice, fs,
                                            carrier_hz=tune[c] + 40.0,
                                            depth=0.5)
    return cfg, modes, tune, x.astype(np.complex64)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_np(v) for v in tree)
    return np.asarray(tree)


@pytest.mark.parametrize("name", ["sync_am", "pll_fm"])
def test_chain_with_pll_ext_matches_jax(name):
    """The JAX chain runs every block; the port's chain takes over its
    state (``convert.rx_state_from_numpy``, the EXT demod's state with
    it) at block CARRY_AT and runs the rest.  Per row: the EXT and SSB
    rows sample by sample, the FM rows by RMS (the discriminator on noise
    wraps at +-pi under rounding, tests/test_torch_rx.py), closed rows
    silent on both sides.  From the chains' start the loops acquire on the
    filters' first, tiny outputs, where the two FFT libraries differ in
    relative terms, and the sync-AM DC tracker (pole 0.9995) keeps that
    difference for thousands of samples; from a common state they agree
    to rounding."""
    _register(name)
    cfg, modes, tune, x = _chain_case(name)
    jch = JRxChain.create(JRxChainConfig(**cfg), tune_hz=tune, mode=modes)
    ch = RxChain.create(RxChainConfig(**cfg), tune_hz=tune, mode=modes,
                        device="cpu")
    assert ch.block_in == jch.block_in and ch.demod.ext is not None
    js = jch.init_state()
    ja, pa = [], []
    Bi = ch.block_in
    for i in range(CHAIN_BLOCKS):
        if i == CARRY_AT:
            ps = convert.rx_state_from_numpy(_tree_np(js), "cpu")
        blk = x[:, i * Bi:(i + 1) * Bi]
        js, a = jch.step(js, blk)
        if i >= CARRY_AT:
            ja.append(np.asarray(a))
            ps, a = ch.step(ps, torch.as_tensor(blk))
            pa.append(a.numpy())
    ja = np.concatenate(ja, axis=-1).astype(np.float64)
    pa = np.concatenate(pa, axis=-1).astype(np.float64)
    assert np.all(np.isfinite(pa))
    fm = np.asarray(modes) == int(Mode.FM)
    pj, pp = np.mean(ja ** 2, axis=-1), np.mean(pa ** 2, axis=-1)
    silent = (pj == 0) & (pp == 0)                 # closed squelch, both
    s = np.full(C, np.inf)
    s[~silent] = snr_rows(ja[~silent], pa[~silent])
    strict = ~fm & ~silent
    assert s[strict].min() > CHAIN_DB, np.sort(s[strict])[:4]
    db = 10 * np.log10(pp[fm] / pj[fm])
    assert np.all(np.abs(db) < 0.1), db
    ext = np.asarray(modes) == int(Mode.EXT)
    assert (ext & strict).sum() >= C // 4 and silent.sum() <= C // 2


# ------------------------------------------- the loop's edges against JAX's
# The inputs that the PLL kernel's own edge checks use on the card (its
# plain version here, the JAX op's loop beside it): a NaN sample, a start
# state with |ph| ~ 2e5 (sincosf's large-argument path on the card), rows
# of exact zeros and of constants (atan2 on a +-0 operand), and block
# lengths at the edges of the kernel's 16-sample register tile.
EDGE_STATE_TOL = 1e-4            # relative, as chip_smoke.check_pll holds it
# At |ph| ~ 2e5 a float32 phase is a grid of 2^-6 rad, and the two packages'
# cos / sin / atan2 (each within an ulp, differing by one on a few percent
# of samples, as at small |ph|) then move it by a whole grid step now and
# then: the rows from such a state are held to this floor (96.6 dB the
# least measured over these rows), the others to PLL_DB.
LARGE_PH_DB = 80.0
LARGE_PH_ROWS = (1, 6)


def _edge_case(mode: str, B: int, seed: int):
    """[8, B] rows: 0 and 1 a carrier in noise (1 from |ph| ~ 2e5), 2 a
    NaN sample at B // 3, 3 exact zeros, 4 constant 1 and 5 constant 1j
    from ph = fr = 0, 6 noise from |ph| ~ 1.9e5 with fr far past max_freq,
    7 the first half zero; states as numpy float32."""
    rng = np.random.default_rng(seed)
    t = np.arange(B) / FS
    x = 0.1 * (rng.standard_normal((8, B)) + 1j * rng.standard_normal((8, B)))
    x[:2] += np.exp(2j * np.pi * 40.0 * t)
    x[2, B // 3] = np.nan
    x[3] = 0.0
    x[4], x[5] = 1.0, 1j
    x[7, :B // 2] = 0.0
    ph = rng.uniform(-0.5, 0.5, 8)
    fr = np.zeros(8)
    ph[1], ph[6], fr[6] = 2.0e5 + rng.uniform(), -1.9e5, 3.0e6
    ph[4] = ph[5] = 0.0
    dc = np.full(8, 0.9)
    st = (ph, fr, dc) if mode == "sync_am" else (ph, fr)
    return x.astype(np.complex64), tuple(s.astype(np.float32) for s in st)


def _edge_ops(mode: str):
    if mode == "sync_am":
        return (JSyncAMDemod.create(FS, bw_hz=150.0),
                SyncAMDemod.create(FS, bw_hz=150.0, device="cpu"))
    return (JPLLFMDemod.create(FS, deviation_hz=5000.0),
            PLLFMDemod.create(FS, deviation_hz=5000.0, device="cpu"))


def _edge_run(mode: str, x: np.ndarray, st: tuple):
    """The JAX op and the port's (its loop the kernel's plain version on
    the CPU) from the same state: (JAX state, JAX audio, port state, port
    audio), the states' loop part only, as numpy."""
    j, op = _edge_ops(mode)
    if mode == "sync_am":
        jst, jy = jax.jit(j.__call__)(st, x)
        pst, py = op(tuple(torch.as_tensor(s) for s in st), torch.as_tensor(x))
    else:
        jst, jy = jax.jit(j.__call__)(st + tuple(j.init_state(len(x))[2:]), x)
        rest = op.init_state(len(x))[2:]
        pst, py = op(tuple(torch.as_tensor(s) for s in st) + tuple(rest),
                     torch.as_tensor(x))
    n = len(st)
    return ([np.asarray(s) for s in jst[:n]], np.asarray(jy),
            [s.numpy() for s in pst[:n]], py.numpy())


def _assert_edge_match(jst, jy, pst, py):
    """NaN in the same places; finite audio >= PLL_DB a row (LARGE_PH_DB on
    LARGE_PH_ROWS; or both rows silent, exactly); finite states within
    EDGE_STATE_TOL, relative."""
    assert np.array_equal(np.isnan(jy), np.isnan(py))
    fin = np.isfinite(jy)
    assert np.array_equal(fin, np.isfinite(py))
    for r in range(jy.shape[0]):
        a = jy[r][fin[r]].astype(np.float64)
        b = py[r][fin[r]].astype(np.float64)
        if not np.any(a):
            assert not np.any(b), r
            continue
        s = snr_rows(a[None], b[None])[0]
        assert s >= (LARGE_PH_DB if r in LARGE_PH_ROWS else PLL_DB), (r, s)
    for a, b in zip(jst, pst):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(a)
        assert np.all(np.abs(a[ok] - b[ok])
                      <= EDGE_STATE_TOL * (1 + np.abs(a[ok]))), (a, b)


@pytest.mark.parametrize("mode", ["sync_am", "pll_fm"])
def test_nan_sample_carries_nan_as_jax(mode):
    """After a NaN sample the loop's ph and fr are NaN in both packages
    (torch.clamp and jnp.clip keep a NaN; fminf / fmaxf would carry
    -max_freq), and the other rows are untouched."""
    x, st = _edge_case(mode, 300, 61)
    jst, jy, pst, py = _edge_run(mode, x, st)
    for s in (jst, pst):
        assert np.isnan(s[0][2]) and np.isnan(s[1][2])
        assert np.all(np.isfinite(s[1][np.arange(8) != 2]))
    assert np.all(np.isnan(py[2, 300 // 3:]))
    assert np.all(np.isfinite(py[2, :300 // 3]))
    _assert_edge_match(jst, jy, pst, py)


@pytest.mark.parametrize("mode", ["sync_am", "pll_fm"])
def test_large_phase_state_matches_jax(mode):
    """A start state with |ph| ~ 2e5: the wrap takes off 2 pi a sample, so
    the whole block runs at |ph| > 1.7e5."""
    x, st = _edge_case(mode, 512, 62)
    jst, jy, pst, py = _edge_run(mode, x, st)
    assert np.all(np.abs(pst[0][[1, 6]]) > 1.0e5)
    _assert_edge_match(jst, jy, pst, py)


@pytest.mark.parametrize("mode", ["sync_am", "pll_fm"])
def test_zero_and_constant_rows_match_jax(mode):
    """Rows of exact zeros (atan2 of two zeros), half a row of zeros (the
    first samples after an empty history) and constants from ph = 0 (one
    operand of atan2 exactly zero, sample after sample)."""
    x, st = _edge_case(mode, 256, 63)
    jst, jy, pst, py = _edge_run(mode, x, st)
    # constant 1 from ph = fr = 0: vi is exactly +0 at every sample, so the
    # loop never moves; constant 1j: atan2(1, +0) = pi/2 on the first
    assert pst[0][4] == 0.0 and pst[1][4] == 0.0
    _assert_edge_match(jst, jy, pst, py)


@pytest.mark.parametrize("B", [15, 16, 17])
@pytest.mark.parametrize("mode", ["sync_am", "pll_fm"])
def test_tile_edge_lengths_match_jax(mode, B):
    """Block lengths one short of the kernel's register tile, the tile and
    one past it, with every edge row."""
    assert pll.TILE == 16
    x, st = _edge_case(mode, B, 64 + B)
    _assert_edge_match(*_edge_run(mode, x, st))
