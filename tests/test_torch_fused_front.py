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

