"""The per-sample AGC / ALC recurrences of ops/agc_scan.py (the plain
versions the CPU runs, to which csrc/agc_scan.cu is held bit for bit on a
card) against the JAX package's ops on the same numpy inputs (float32 on the
CPU, torch on one thread), at shapes off the paths': one channel and one
past a 32-channel block (C = 1, 33), blocks of 1, 7 and 2048 samples, and
blocks at the edges of the kernel's register tile (one short of
``agc_scan.TILE`` samples, the tile, one past it).

Tolerances are those of tests/test_torch_agc.py and
tests/test_torch_tx_ops.py: ``TxALC`` gains within 1e-5 relative and its
clip decisions equal at every sample (the JAX op's read from its state
stepped one sample at a time); ``WcpAGC`` float states within rtol 1e-4
and its output >= 80 dB; ``HangAGC`` log-gain within 1e-5 and its output
>= 100 dB; every integer state equal.  A block cut in two calls at an odd
sample equals one call bit for bit; a state converted from the JAX op
continues its run; each wrapper rejects what its kernel cannot take."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from quisk_tpu.ops import agc as jagc

from quisk_tpu_torch import convert
from quisk_tpu_torch.ops import agc, agc_scan
from quisk_tpu_torch.oracle import wcpagc as oracle

CPU = "cpu"
FS = 48e3
SHAPES = [(1, 1), (1, 7), (1, 2048), (33, 1), (33, 7), (33, 2048)] + [
    (33, agc_scan.TILE + d) for d in (-1, 0, 1)]   # the kernel tile's edges
# short time constants, so that pop, hang and hang decay all occur
WCP_KW = dict(hangtime=0.01, tau_decay=0.02, tau_hang_decay=0.01,
              tau_fast_backaverage=0.02, tau_hang_backmult=0.05,
              hang_thresh=0.1)
HANG_KW = dict(hang_ms=5.0, release_db_per_s=600.0)
ALC_MODES = (3, 5, 4)              # cycled over the rows: per-mode memory


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """The port's CPU ops on one thread (ROADMAP Queue 3: multi-threaded
    cos/sin on some hosts)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def snr_db(ref, got):
    ref = np.asarray(ref).astype(np.complex128)
    err = np.asarray(got).astype(np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / (np.mean(np.abs(err) ** 2) + 1e-300))


def n_samples(B):
    """Long enough to wrap the ALC's 960-sample ring twice and cross every
    state of the WDSP machine on every row; a whole number of blocks."""
    return 2 * B if B >= 1024 else B * -(-2100 // B)


def bursts(C, n, seed):
    """Tone bursts (6 ms in 12 ms) at per-row levels, a quiet tail: attack,
    pop, hang and decay all occur."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / FS
    x = 0.5 * np.sin(2 * np.pi * 700.0 * t) * ((t % 0.012) < 0.006)
    x = x[None] * np.array([1.0, 0.1, 2.0, 0.01])[np.arange(C) % 4, None]
    x = x + 1e-4 * rng.standard_normal((C, n))
    x[:, int(0.8 * n):] *= 0.05
    return x.astype(np.float32)


def alc_input(C, n, seed):
    """Modulated-IQ-like rows: voice-band envelopes at per-row levels (most
    rows clip), a constant-envelope row (as FM, at the clip threshold), a
    row of silence under min_magn, and a silent stretch on every row.  The
    samples lie on the axes, so both packages compute |x| exactly: the JAX
    op's complex abs and the port's sqrt(re^2 + im^2) differ by an ulp on
    about a quarter of other samples, which at the threshold and at
    block-complete samples sends the two down different branches."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((C, n + 64)) + 1j * rng.standard_normal(
        (C, n + 64))
    k = np.hanning(33)
    env = np.abs(np.stack([np.convolve(r, k, "same") for r in w]))[:, 64:]
    env = env / np.max(env, axis=-1, keepdims=True)
    t = np.arange(n)
    env = env * ((t // 300) % 3 != 2)                      # bursts + gaps
    env = env * np.array([1.6, 0.4, 2.5, 0.9])[np.arange(C) % 4, None]
    if C > 2:
        env[1] = 1.3                                       # constant envelope
        env[2] *= 1e-5                                     # silent row
    env[:, int(0.55 * n):int(0.62 * n)] *= 1e-4            # silence
    return (env * np.array([1, 1j, -1, -1j])[t % 4]).astype(np.complex64)


def blocks(x, B):
    return [np.ascontiguousarray(x[:, i:i + B])
            for i in range(0, x.shape[-1], B)]


def jit_op(jop):
    """The JAX op jitted, its state brought back to numpy after each call
    (a weakly typed leaf in the op's output state would compile it twice)."""
    f = jax.jit(lambda st, a: jop(st, a))

    def call(st, a):
        st, y = f(st, a)
        return jax.device_get(st), y
    return call


# ------------------------------------------------------------------ TxALC
def jax_alc_per_sample(jop, x, st=None):
    """The JAX op stepped one sample at a time: after each sample the active
    mode's gain, counter, fault and block_index; the index before each
    sample; the output sample; and the final state."""
    m = jnp.asarray(np.asarray(jop.mode))

    def one(st, xx):
        idx = st["index"]
        st, y = jop(st, xx)
        g = st["gain_now"][jnp.arange(m.shape[0]), m]
        return st, (g, st["counter"], st["fault"], st["block_index"], idx,
                    y[:, 0])
    f = jax.jit(one)
    st = jop.init_state(x.shape[0]) if st is None else st
    cols = []
    for n in range(x.shape[-1]):
        st, s = f(st, jnp.asarray(x[:, n:n + 1]))
        cols.append(jax.device_get(s))
    out = {k: np.stack([c[i] for c in cols], axis=-1) for i, k in
           enumerate(("g", "counter", "fault", "block_index", "index_pre",
                      "y"))}
    return out, st


def jax_clips(ref, bi0):
    """The JAX op's clip decisions from its per-sample states (a clip resets
    the counters and sets block_index to the index); where block_index
    already equals the index (block complete) the reset does not say which
    branch ran: ``known`` is False there and the gains decide."""
    bi_pre = np.concatenate([bi0[:, None], ref["block_index"][:, :-1]], -1)
    idx = ref["index_pre"][None, :]
    reset = (ref["counter"] == 0) & (ref["fault"] == 0)
    return reset & (ref["block_index"] == idx), bi_pre != idx


def alc_ops(C):
    modes = [ALC_MODES[c % 3] for c in range(C)]
    return (jagc.TxALC.create(FS, mode=modes, channels=C),
            agc.TxALC.create(FS, mode=modes, channels=C, device=CPU))


def run_port_alc(op, x, B, st=None):
    """The port's TxALC over blocks of B: outputs, clips, state at each
    block end, final state."""
    st = op.init_state(x.shape[0]) if st is None else st
    outs, clips, ends = [], [], []
    for a in blocks(x, B):
        st, y, cl = op.trace(st, torch.as_tensor(a))
        outs.append(y.numpy())
        clips.append(cl.numpy())
        ends.append({k: v.numpy() for k, v in st.items() if k != "buffer"})
    return np.concatenate(outs, -1), np.concatenate(clips, -1), ends, st


def check_alc(ref, jop, out, clips, ends, B, bi0):
    C, n = out.shape
    j_clip, known = jax_clips(ref, bi0)
    assert int(np.sum((clips != j_clip) & known)) == 0
    gy = np.abs(ref["y"])
    live = gy > 1e-6
    rel = np.abs(np.abs(out) - gy)[live] / gy[live]
    assert rel.max() < 1e-5, rel.max()
    m = np.asarray(jop.mode)
    for i, e in enumerate(ends):
        s = min((i + 1) * B, n) - 1
        for k in ("counter", "fault", "block_index"):
            assert np.array_equal(e[k], ref[k][:, s]), (k, s)
        assert int(e["index"]) == (s + 1 + int(ref["index_pre"][0])) % 960
        g = e["gain_now"][np.arange(C), m]
        assert np.allclose(g, ref["g"][:, s], rtol=1e-5, atol=0), s
    return int(clips.sum()), int((~known).sum())


@pytest.mark.parametrize("C,B", SHAPES)
def test_tx_alc_plain_matches_jax(C, B):
    jop, op = alc_ops(C)
    assert op.buf == jop.buf == 960
    x = alc_input(C, n_samples(B), 20 + C + B)
    ref, _ = jax_alc_per_sample(jop, x)
    out, clips, ends, _ = run_port_alc(op, x, B)
    n_clips, n_blk = check_alc(ref, jop, out, clips, ends, B,
                               np.zeros(C, np.int32))
    assert n_clips > 5 and n_blk > 0                  # clips and blocks
    assert (ref["index_pre"] == 0).sum() >= 2         # the ring wrapped
    if C > 2:
        assert clips[2].sum() == 0                    # the silent row
        assert clips[1].sum() > 0                     # at the threshold


# ----------------------------------------------------------------- WcpAGC
def wcp_ops(hang_enable):
    kw = dict(WCP_KW, hang_enable=hang_enable)
    return (jagc.WcpAGC.create(FS, **kw),
            agc.WcpAGC.create(FS, device=CPU, **kw))


def run_wcp(jop, op, x, B, jst=None, pst=None):
    C = x.shape[0]
    jf = jit_op(jop)
    jst = jop.init_state(C) if jst is None else jst
    pst = op.init_state(C) if pst is None else pst
    jy, py = [], []
    for a in blocks(x, B):
        jst, j = jf(jst, jnp.asarray(a))
        pst, p = op(pst, torch.as_tensor(a))
        for name in ("hang_counter", "state", "decay_type"):
            assert pst[name].dtype == torch.int32
            assert np.array_equal(pst[name].numpy(), np.asarray(jst[name]))
        for name in ("volts", "save_volts", "fast_ba", "hang_ba"):
            assert np.allclose(pst[name].numpy(), np.asarray(jst[name]),
                               rtol=1e-4, atol=1e-9), name
        jy.append(np.asarray(j))
        py.append(p.numpy())
    return np.concatenate(jy, -1), np.concatenate(py, -1), jst, pst


@pytest.mark.parametrize("hang_enable", [True, False])
@pytest.mark.parametrize("C,B", SHAPES)
def test_wcp_plain_matches_jax(C, B, hang_enable):
    jop, op = wcp_ops(hang_enable)
    x = bursts(C, n_samples(B), 30 + C + B)
    jy, py, _, _ = run_wcp(jop, op, x, B)
    assert snr_db(jy[:, 512:], py[:, 512:]) > 80.0
    # the input crosses pop (1) and, with hang on, hang (2) and hang decay
    # (4), by the float64 oracle
    states = set()
    for c in range(min(C, 4)):
        _, _, tr = oracle.wcpagc_oracle(x[c].astype(np.float64),
                                        oracle.WcpParams(
                                            sample_rate=FS, hang_enable=
                                            hang_enable, **WCP_KW))
        states |= set(tr.tolist())
    assert states >= ({0, 1, 2, 4} if hang_enable else {0, 1, 3})


# ---------------------------------------------------------------- HangAGC
def run_hang(jop, op, x, B, jst=None, pst=None):
    C = x.shape[0]
    jf = jit_op(jop)
    jst = jop.init_state(C) if jst is None else jst
    pst = op.init_state(C) if pst is None else pst
    jy, py, hang_max = [], [], 0
    for a in blocks(x, B):
        jst, j = jf(jst, jnp.asarray(a))
        pst, p = op(pst, torch.as_tensor(a))
        assert pst[2].dtype == torch.int32
        assert np.array_equal(pst[2].numpy(), np.asarray(jst[2]))
        assert np.allclose(pst[1].numpy(), np.asarray(jst[1]), atol=1e-5)
        hang_max = max(hang_max, int(pst[2].numpy().max()))
        jy.append(np.asarray(j))
        py.append(p.numpy())
    return np.concatenate(jy, -1), np.concatenate(py, -1), hang_max


@pytest.mark.parametrize("C,B", SHAPES)
def test_hang_plain_matches_jax(C, B):
    jop = jagc.HangAGC.create(FS, **HANG_KW)
    op = agc.HangAGC.create(FS, device=CPU, **HANG_KW)
    x = bursts(C, n_samples(B), 40 + C + B)
    jy, py, hang_max = run_hang(jop, op, x, B)
    assert snr_db(jy[:, 1024:], py[:, 1024:]) > 100.0
    # a hang was running at a join (one row and two blocks has one join, at
    # a quiet moment of its row)
    assert hang_max > 0 or (C, B) == (1, 2048)


# ------------------------------------------------ split calls, convert
def plain_inputs(mode, C, B, seed):
    """Each plain version's arguments for one block of seeded signal, as
    its op makes them (``scan_inputs``) from the op's initial state."""
    if mode == "tx_alc":
        op, x = alc_ops(C)[1], alc_input(C, B, seed)
    elif mode == "wcp":
        op, x = wcp_ops(True)[1], bursts(C, B, seed)
    else:
        op = agc.HangAGC.create(FS, device=CPU, **HANG_KW)
        x = bursts(C, B, seed)
    _, args = op.scan_inputs(op.init_state(C), torch.as_tensor(x))
    return args


PLAIN = {"tx_alc": agc_scan.tx_alc_plain, "wcp": agc_scan.wcp_plain,
         "hang": agc_scan.hang_plain}
WRAPPER = {"tx_alc": agc_scan.tx_alc_scan, "wcp": agc_scan.wcp_scan,
           "hang": agc_scan.hang_scan}


def as_list(out):
    """(state', outputs...) flattened to a list of tensors."""
    st, *ys = out
    return list(st) + [y for y in ys if y is not None]


@pytest.mark.parametrize("mode", sorted(PLAIN))
def test_split_at_odd_sample_equals_one_call(mode):
    C, B, cut = 33, 2048, 777
    xs, st, coef, kw = plain_inputs(mode, C, B, 50)
    whole = as_list(PLAIN[mode](*xs, st, coef, **kw))
    a = PLAIN[mode](*(x[:, :cut] for x in xs), st, coef, **kw)
    b = PLAIN[mode](*(x[:, cut:] for x in xs), a[0], coef, **kw)
    n_st = len(st)
    joined = list(b[0]) + [torch.cat([p, q], -1)
                           for p, q in zip(a[1:], b[1:])]
    assert len(joined) == len(whole)
    for i, (w, j) in enumerate(zip(whole, joined)):
        assert w.dtype == j.dtype and torch.equal(w, j), (
            "state" if i < n_st else "output", i)
    # the CPU wrapper is the plain version
    assert all(torch.equal(p, q) for p, q in zip(
        whole, as_list(WRAPPER[mode](*xs, st, coef, **kw))))


def test_tx_alc_state_from_jax_continues_the_jax_run():
    C, B = 33, 512
    jop, op = alc_ops(C)
    x = alc_input(C, 5 * B, 60)
    jf = jit_op(jop)
    jst = jop.init_state(C)
    for a in blocks(x[:, :3 * B], B):
        jst, _ = jf(jst, jnp.asarray(a))
    jst = jax.device_get(jst)
    pst = convert.state_from_numpy(jst, device=CPU)
    assert pst["index"].dtype == torch.int32 and pst["index"].dim() == 0
    ref, _ = jax_alc_per_sample(jop, x[:, 3 * B:], st=jst)
    out, clips, ends, _ = run_port_alc(op, x[:, 3 * B:], B, st=pst)
    check_alc(ref, jop, out, clips, ends, B, np.asarray(jst["block_index"]))


def test_wcp_state_from_jax_continues_the_jax_run():
    C, B = 33, 512
    jop, op = wcp_ops(True)
    x = bursts(C, 6 * B, 61)
    jf = jit_op(jop)
    jst = jop.init_state(C)
    for a in blocks(x[:, :3 * B], B):
        jst, _ = jf(jst, jnp.asarray(a))
    pst = convert.state_from_numpy(jax.device_get(jst), device=CPU)
    jy, py, _, _ = run_wcp(jop, op, x[:, 3 * B:], B, jst=jst, pst=pst)
    assert snr_db(jy, py) > 80.0


def test_hang_state_from_jax_continues_the_jax_run():
    C, B = 33, 512
    jop = jagc.HangAGC.create(FS, **HANG_KW)
    op = agc.HangAGC.create(FS, device=CPU, **HANG_KW)
    x = bursts(C, 6 * B, 62)
    jf = jit_op(jop)
    jst = jop.init_state(C)
    for a in blocks(x[:, :3 * B], B):
        jst, _ = jf(jst, jnp.asarray(a))
    pst = convert.state_from_numpy(jax.device_get(jst), device=CPU)
    jy, py, _ = run_hang(jop, op, x[:, 3 * B:], B, jst=jst, pst=pst)
    assert snr_db(jy, py) > 100.0


# ------------------------------------------------------------- rejections
def _bad(mode, what):
    xs, st, coef, kw = plain_inputs(mode, 5, 16, 70)
    xs, st = list(xs), list(st)
    if what == "input dtype":
        xs[0] = xs[0].double()
    elif what == "input samples strided":
        xs[0] = torch.zeros(5, 32)[:, ::2]
    elif what == "state dtype":
        st[0] = st[0].double()
    elif what == "state shape":
        st[0] = torch.zeros(6)
    elif what == "state not contiguous":
        st[0] = torch.zeros(10)[::2]
    elif what == "int state dtype":
        st[-1] = st[-1].to(torch.int64)
    elif what == "coef shape":
        coef = torch.cat([coef, coef])
    elif what == "state count":
        st = st[:-1]
    return xs, tuple(st), coef, kw


BAD = {"input dtype": TypeError, "input samples strided": ValueError,
       "state dtype": TypeError, "state shape": ValueError,
       "state not contiguous": ValueError, "int state dtype": TypeError,
       "coef shape": ValueError, "state count": ValueError}


@pytest.mark.parametrize("what", sorted(BAD))
@pytest.mark.parametrize("mode", sorted(PLAIN))
def test_wrapper_rejects(mode, what):
    xs, st, coef, kw = _bad(mode, what)
    with pytest.raises(BAD[what]):
        WRAPPER[mode](*xs, st, coef, **kw)


def test_unknown_mode_rejected():
    xs, st, coef, _ = plain_inputs("hang", 5, 16, 71)
    with pytest.raises(ValueError, match="mode"):
        agc_scan.check("agc", xs, st, coef)
    with pytest.raises(ValueError, match="inputs"):
        agc_scan.check("wcp", xs, st, coef)


@pytest.mark.parametrize("mode", sorted(PLAIN))
def test_meta_tensor_raises_instead_of_falling_back(mode):
    xs, st, coef, kw = plain_inputs(mode, 5, 16, 72)

    def meta(t):
        return t.to("meta")
    fn = WRAPPER[mode]
    n0 = fn.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fn(*map(meta, xs), tuple(map(meta, st)), meta(coef), **kw)
    assert fn.launches == n0
