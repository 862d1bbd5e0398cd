"""The port's fused tune+decimate front (its plain PyTorch version, which
CPU tensors take) against the JAX package's Pallas ``FusedTuneDecimate``
run in interpret mode, as tests/test_pallas_fused.py runs it: the
half-band /2 front at C=128, B=2048, and the flagship's whole /20 cascade
folded into one 1421-tap filter.  Same numpy inputs to both; > 100 dB
(the floor of tests/test_pallas_fused.py) over 2 streamed blocks, and
across a state handed from JAX to the port through ``convert``."""

import numpy as np
import pytest
import torch

from quisk_tpu.ops import design as jdesign
from quisk_tpu.ops.pallas_kernels import FusedTuneDecimate as JFused

from quisk_tpu_torch import convert
from quisk_tpu_torch.ops import fused_front
from quisk_tpu_torch.rx.chain import fuse_cascade

C = 128
CONFIGS = {
    "hb45_d2": dict(fs=384000.0, block=2048),
    "cascade_d20": dict(fs=960000.0, block=10240),
}


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


def snr_db(ref, got):
    ref = np.asarray(ref, np.complex128)
    err = np.asarray(got, np.complex128) - ref
    return 10 * np.log10(np.mean(np.abs(ref) ** 2)
                         / np.mean(np.abs(err) ** 2))


def _taps(name, fs):
    if name == "hb45_d2":
        return jdesign.halfband(45), 2
    specs = [(jdesign.halfband(45), 2), (jdesign.halfband(45), 2),
             (jdesign.decimator(5, fs / 4, atten_db=100.0), 5)]
    return fuse_cascade(specs)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX op, its 2-block stream and its float64 references."""
    name = request.param
    fs, B = CONFIGS[name]["fs"], CONFIGS[name]["block"]
    taps, d = _taps(name, fs)
    # channel 3's tune puts bit 31 of the word set (negative frequency)
    tune = [(-fs / 4 + (i + 0.5) * fs / (2 * C)) for i in range(C)]
    op = JFused.create(taps, tune, fs, B, d, C, TN=2)
    rng = np.random.default_rng(20)
    xs = [(rng.standard_normal((C, B)) + 1j * rng.standard_normal((C, B))
           ).astype(np.complex64) for _ in range(2)]
    st = op.init_state(C)
    states, ys, refs = [_np_state(st)], [], []
    for x in xs:
        refs.append(op.reference(st, x))
        st, y = op(st, x)
        ys.append(np.asarray(y))
        states.append(_np_state(st))
    T = op.ntaps
    params = {"taps": np.asarray(op.M)[:T, 0][::-1], "word":
              np.asarray(op.word), "decim": op.decim, "block": op.block}
    return dict(name=name, xs=xs, ys=ys, refs=refs, states=states,
                params=params)


def _np_state(st):
    return (np.asarray(st[0]), np.asarray(st[1]))


def test_params_and_init_state(jax_run):
    op = convert.fused_front_from_numpy(jax_run["params"], "cpu")
    assert np.array_equal(op.word.numpy().astype(np.uint32),
                          jax_run["params"]["word"])
    assert np.any(jax_run["params"]["word"] >= 1 << 31)
    ph, hist = convert.state_to_numpy(op.init_state(C))
    assert ph.dtype == np.uint32
    assert np.array_equal(ph, jax_run["states"][0][0])
    assert np.array_equal(hist, jax_run["states"][0][1])


def test_plain_matches_pallas_over_two_blocks(jax_run):
    op = convert.fused_front_from_numpy(jax_run["params"], "cpu")
    st = op.init_state(C)
    for i, x in enumerate(jax_run["xs"]):
        st, y = op(st, torch.as_tensor(x))
        assert snr_db(jax_run["ys"][i], y.numpy()) > 100.0
        assert snr_db(jax_run["refs"][i], y.numpy()) > 100.0
        ph, hist = convert.state_to_numpy(st)
        assert np.array_equal(ph, jax_run["states"][i + 1][0])
        assert np.array_equal(hist, jax_run["states"][i + 1][1])


def test_continues_from_jax_state(jax_run):
    """Block 2 from the JAX op's state after block 1, carried across."""
    op = convert.fused_front_from_numpy(jax_run["params"], "cpu")
    st = convert.state_from_numpy(jax_run["states"][1], "cpu")
    _, y = op(st, torch.as_tensor(jax_run["xs"][1]))
    assert snr_db(jax_run["ys"][1], y.numpy()) > 100.0


def test_float64_reference_matches_jax_reference(jax_run):
    op = convert.fused_front_from_numpy(jax_run["params"], "cpu")
    st = convert.state_from_numpy(jax_run["states"][1], "cpu")
    ref = op.reference(st, torch.as_tensor(jax_run["xs"][1])).numpy()
    assert ref.dtype == np.complex128
    assert snr_db(jax_run["refs"][1], ref) > 250.0


def _args(C_=4, B=64, T=9, d=2):
    return (torch.zeros((C_, B), dtype=torch.complex64),
            torch.zeros((C_, T - 1), dtype=torch.complex64),
            torch.zeros(C_, dtype=torch.int64),
            torch.zeros(C_, dtype=torch.int64),
            torch.ones(T, dtype=torch.float32), d)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contig", "decim",
                                 "device"])
def test_wrapper_rejects_bad_inputs(bad):
    x, hist, word, ph, h, d = _args()
    if bad == "dtype":
        word = word.to(torch.int32)
    elif bad == "shape":
        hist = hist[:, :-1].contiguous()
    elif bad == "contig":
        x = torch.zeros((64, 4), dtype=torch.complex64).T
    elif bad == "decim":
        d = 3
    else:
        x = x.to("meta")
    with pytest.raises((ValueError, TypeError)):
        fused_front.fused_tune_decimate(x, hist, word, ph, h, d)


def test_cpu_tensors_take_plain_version_without_counting():
    before = fused_front.fused_tune_decimate.launches
    x, hist, word, ph, h, d = _args()
    x = torch.randn(4, 64, dtype=torch.complex64)
    y = fused_front.fused_tune_decimate(x, hist, word, ph, h, d)
    assert torch.equal(y, fused_front.fused_tune_decimate_plain(
        x, hist, word, ph, h, d))
    assert fused_front.fused_tune_decimate.launches == before



# ------------------------------------------------- gained and NB-detect modes
FS_HB = 384000.0
B_HB = 2048
NB_DETECT = {"avg_win": 64, "kwidth": 97}
HC = (NB_DETECT["kwidth"] // 2) // 16
NEAR_MAX = 2           # near-threshold groups tolerated over a 3-block run


def _hb_ops(**kw):
    taps = jdesign.halfband(45)          # T=45 -> off=4, 3 history groups
    tune = [(-FS_HB / 4 + (i + 0.5) * FS_HB / (2 * C)) for i in range(C)]
    jop = JFused.create(taps, tune, FS_HB, B_HB, 2, C, TN=2, **kw)
    op = fused_front.FusedTuneDecimate.create(taps, tune, FS_HB, B_HB, 2, C,
                                              device="cpu", **kw)
    return jop, op


def _impulsive(rng, end_pulse=False):
    x = (rng.standard_normal((C, B_HB)) + 1j * rng.standard_normal((C, B_HB))
         ).astype(np.complex64)
    for c in range(0, C, 7):
        for p in rng.integers(0, B_HB, 5):
            x[c, p] += 40.0 * np.exp(1j * rng.uniform(0, 2 * np.pi))
    if end_pulse:                 # 2 groups before the block's end (HC=3)
        x[3, B_HB - 2 * 16 + 2] += 60.0
    return x


def test_gain_grid_equals_jax():
    jop, op = _hb_ops(with_gain=True)
    assert (op.gain_off, op.gain_hist_groups) == (jop.gain_off,
                                                  jop.gain_hist_groups)
    assert (op.gain_off, op.gain_hist_groups) == (4, 3)
    assert fused_front.gain_grid(1421) == (4, 89)       # the flagship's
    _, opn = _hb_ops(nb_detect=NB_DETECT)
    jn, _ = _hb_ops(nb_detect=NB_DETECT)
    assert np.array_equal(opn.rc.numpy(), np.float32(jn.nbspec.rc))
    assert opn.nb_detect == NB_DETECT and op.nb_detect is None


def test_gained_mode_matches_pallas_and_float64():
    """As tests/test_pallas_fused.py::test_fused_gain_matches_manual_apply:
    a random gain in [0, 1] on the coarse grid."""
    jop, op = _hb_ops(with_gain=True)
    rng = np.random.default_rng(21)
    GH = op.gain_hist_groups
    jst, st = jop.init_state(C), op.init_state(C)
    for _ in range(2):
        x = _impulsive(rng)
        g16 = rng.uniform(0.0, 1.0, (C, GH + B_HB // 16)).astype(np.float32)
        ph, hist = st
        ref = fused_front.fused_tune_decimate_gained_reference(
            torch.as_tensor(x), hist, op.word, ph, op.h_rev, 2,
            torch.as_tensor(g16))
        jst, jy = jop(jst, x, gain16=g16)
        st, y = op(st, torch.as_tensor(x), gain16=torch.as_tensor(g16))
        assert snr_db(jy, y.numpy()) > 100.0
        assert snr_db(ref.numpy(), y.numpy()) > 100.0
    with pytest.raises(ValueError):          # gain16 must cover ext
        op(st, torch.as_tensor(x), gain16=torch.as_tensor(g16[:, 1:]))
    plain = fused_front.FusedTuneDecimate.create(
        jdesign.halfband(45), 0.0, FS_HB, B_HB, 2, C, device="cpu")
    with pytest.raises(ValueError):          # create(with_gain=True) needed
        plain(plain.init_state(C), torch.as_tensor(x),
              gain16=torch.as_tensor(g16))


@pytest.fixture(scope="module")
def nb_run():
    """3 streamed blocks through the JAX op's call_nb (interpret mode) and
    the port's, each carrying its own gain; block 1 has a pulse 2 groups
    before its end."""
    jop, op = _hb_ops(nb_detect=NB_DETECT)
    rng = np.random.default_rng(22)
    GH = op.gain_hist_groups
    on = np.ones((C, 1), np.float32)
    limit = np.float32(4.0)
    jst, st = jop.init_state(C), op.init_state(C)
    jg = np.ones((C, GH), np.float32)
    g = torch.ones((C, GH))
    blocks = []
    for i in range(3):
        x = _impulsive(rng, end_pulse=(i == 1))
        ph, hist = st
        args = (torch.as_tensor(x), hist, op.word, ph, op.h_rev, 2)
        ref, gref, near = fused_front.fused_tune_decimate_nb_reference(
            *args, g, torch.as_tensor(on), torch.tensor(limit), op.rc, 64)
        jst, jy, jgo = jop.call_nb(jst, x, jg, on, limit)
        st, y, go = op.call_nb(st, torch.as_tensor(x), g,
                               torch.as_tensor(on), torch.tensor(limit))
        blocks.append(dict(x=x, args=args, g_in=g, jy=np.asarray(jy),
                           jgo=np.asarray(jgo), y=y, go=go, ref=ref,
                           gref=gref, near=near))
        jg, g = np.asarray(jgo)[:, -GH:], go[:, -GH:].contiguous()
    return dict(op=op, jop=jop, blocks=blocks, state=st)


def test_nb_detect_matches_pallas_and_float64(nb_run):
    near_total = 0
    for b in nb_run["blocks"]:
        assert b["go"].shape == (C, B_HB // 16)
        differ, near = fused_front.gains_differ(
            b["go"], torch.as_tensor(b["jgo"].copy()), b["near"], HC)
        assert differ == 0
        near_total += near
        # against float64: decisions equal, values within float32 rounding
        ok = ~_within_hc(b["near"])
        assert float((b["go"].double() - b["gref"]).abs()[ok].max()) < 1e-6
        assert b["go"].min() == 0.0 and b["go"].max() == 1.0
        rows = ~b["near"].any(-1).numpy()
        assert snr_db(b["jy"][rows], b["y"].numpy()[rows]) > 100.0
        assert snr_db(b["ref"].numpy()[rows], b["y"].numpy()[rows]) > 100.0
    assert near_total <= NEAR_MAX


def _within_hc(near):
    pad = torch.nn.functional.pad(near.float(), (HC, HC))
    return pad.unfold(-1, 2 * HC + 1, 1).sum(-1) > 0


def test_nb_detect_toggle_off_is_gain_one(nb_run):
    op, b = nb_run["op"], nb_run["blocks"][2]
    x = torch.as_tensor(b["x"])
    off = torch.zeros((C, 1))
    ones = torch.ones((C, op.gain_hist_groups))
    st = (b["args"][3], b["args"][1])
    _, y, go = op.call_nb(st, x, ones, off, torch.tensor(4.0))
    assert bool((go == 1.0).all())
    _, y_plain = op(st, x)
    assert torch.equal(y, y_plain)
    # one channel on, the rest off
    mixed = off.clone()
    mixed[7] = 1.0
    _, _, go = op.call_nb(st, x, ones, mixed, torch.tensor(4.0))
    assert go[7].min() == 0.0 and bool((go[:7] == 1.0).all())


def test_nb_detect_equals_gained_fed_by_host_detect(nb_run):
    """tests/test_pallas_fused.py::test_in_kernel_nb_detect_equals_host_
    detect for the port: the NB-detect mode equals the gained mode fed with
    [carried gain | NoiseBlanker.detect].  Streamed with T-1 >= avg_win
    (the standalone blanker keeps avg_win samples of history; a shorter
    front history starts the averages on zeros instead)."""
    from quisk_tpu_torch.ops.noise import NoiseBlanker
    Cs, B, d = 8, 4096, 4
    taps = fuse_cascade([(jdesign.halfband(45), 2),
                         (jdesign.halfband(45), 2)])[0]
    assert len(taps) - 1 >= 64
    kw = dict(avg_win=64, kwidth=97)
    op = fused_front.FusedTuneDecimate.create(taps, 1000.0, FS_HB, B, d, Cs,
                                              nb_detect=kw, device="cpu")
    nb = NoiseBlanker(limit=torch.tensor(4.0), pool=16, **kw)
    GH = op.gain_hist_groups
    rng = np.random.default_rng(23)
    st, nbst = op.init_state(Cs), nb.init_state(Cs)
    g = torch.ones((Cs, GH))
    on = torch.ones((Cs, 1))
    for i in range(3):
        x = (rng.standard_normal((Cs, B)) + 1j * rng.standard_normal((Cs, B))
             ).astype(np.complex64)
        x[::3, rng.integers(0, B - 200, 4)] += 40.0
        x = torch.as_tensor(x)
        nbst, gc = nb.detect(nbst, x)
        _, y_host = op(st, x, gain16=torch.cat([g, gc], dim=-1))
        _, y_new, gout = op.call_nb(st, x, g, on, nb.limit)
        st, y_own = op(st, x, gain16=torch.cat([g, gout], dim=-1))
        # the same decisions; the widening sums round differently
        assert float((gout - gc).abs().max()) < 1e-6
        # the group one past the end: repeated (gained) vs computed
        # (NB-detect) differ only in the last 15 input samples
        tail = -(-15 // d)
        assert torch.equal(y_new[:, :-tail], y_own[:, :-tail])
        assert snr_db(y_host.numpy()[:, :-tail],
                      y_new.numpy()[:, :-tail]) > 120.0
        g = gout[:, -GH:].contiguous()


def test_nb_detect_end_of_block_pulse(nb_run):
    """A pulse 2 groups before the block's end: the gain one past the end
    is the widening's own value, not the last group's repeated.  Pinned
    against the JAX kernel on the block's last outputs."""
    b = nb_run["blocks"][1]
    assert b["go"][3, -1] < 1.0                       # blanking reaches the end
    last = slice(B_HB // 2 - 8, None)                 # outputs fed by the tail
    assert snr_db(b["jy"][3, last], b["y"].numpy()[3, last]) > 100.0
    x, hist, word, ph, h_rev, d = b["args"]
    y_rep = fused_front.fused_tune_decimate_gained_plain(
        x, hist, word, ph, h_rev, d, torch.cat([b["g_in"], b["go"]], dim=-1))
    assert torch.equal(y_rep[:, :-8], b["y"][:, :-8])
    assert not torch.equal(y_rep[3, -8:], b["y"][3, -8:])


def test_first_block_average_hits_the_floor():
    """History of zeros: the averages of the first groups start from 0 and
    take the 1e-12 floor, so a first sample of any size is a pulse."""
    _, op = _hb_ops(nb_detect=NB_DETECT)
    x = torch.zeros((C, B_HB), dtype=torch.complex64)
    x[0, 0] = 1e-6
    st = op.init_state(C)
    _, _, go = op.call_nb(st, x, torch.ones((C, op.gain_hist_groups)),
                          torch.ones((C, 1)), torch.tensor(4.0))
    assert go[0, 0] == 0.0 and bool((go[1:] == 1.0).all())


@pytest.mark.parametrize("bad", ["block", "avg_win", "hist_gain", "on",
                                 "limit"])
def test_gain_wrappers_reject_bad_inputs(bad):
    x, hist, word, ph, h, d = _args(C_=4, B=64, T=9, d=2)
    GH = fused_front.gain_grid(9)[1]
    hg, on = torch.ones((4, GH)), torch.ones((4, 1))
    lim, rc, avg = torch.tensor(4.0), torch.ones(3), 16
    if bad == "block":
        x = torch.zeros((4, 40), dtype=torch.complex64)
    elif bad == "avg_win":
        avg = 24
    elif bad == "hist_gain":
        hg = torch.ones((4, GH + 1))
    elif bad == "on":
        on = torch.ones((4,))
    else:
        lim = torch.tensor([4.0])
    with pytest.raises((ValueError, TypeError)):
        fused_front.fused_tune_decimate_nb(x, hist, word, ph, h, d, hg, on,
                                           lim, rc, avg)


def test_cpu_tensors_take_gain_plain_versions_without_counting():
    x, hist, word, ph, h, d = _args(C_=4, B=64, T=9, d=2)
    x = torch.randn(4, 64, dtype=torch.complex64)
    GH = fused_front.gain_grid(9)[1]
    g16 = torch.rand((4, GH + 4))
    before = (fused_front.fused_tune_decimate_gained.launches,
              fused_front.fused_tune_decimate_nb.launches)
    y = fused_front.fused_tune_decimate_gained(x, hist, word, ph, h, d, g16)
    assert torch.equal(y, fused_front.fused_tune_decimate_gained_plain(
        x, hist, word, ph, h, d, g16))
    nb_args = (torch.ones((4, GH)), torch.ones((4, 1)), torch.tensor(4.0),
               torch.as_tensor(fused_front.coarse_rc(97)), 16)
    y, go = fused_front.fused_tune_decimate_nb(x, hist, word, ph, h, d,
                                               *nb_args)
    yp, gp = fused_front.fused_tune_decimate_nb_plain(x, hist, word, ph, h,
                                                      d, *nb_args)
    assert torch.equal(y, yp) and torch.equal(go, gp)
    assert before == (fused_front.fused_tune_decimate_gained.launches,
                      fused_front.fused_tune_decimate_nb.launches)
