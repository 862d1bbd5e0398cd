"""The port's ``parallel`` package against the JAX package.

Worlds of 1, 2 and 4 ranks over gloo on the CPU (tests/torch_parallel_ranks.py,
one process a rank, a ``file://`` store under tmp_path, a timeout on every
rank and on the run) run every case once for the whole module, each world
started when a test first asks for it; each test stitches the ranks'
outputs by their rows / time slices and holds them, on the same
numpy-seeded inputs, to:

- the channel-sharded flagship (16 channels, 192 kS/s): the port's
  unsharded chain within 1e-6 of the peak (the same chain on fewer rows)
  and the JAX ``__graft_entry__._flagship`` chain at the ROADMAP's floors
  (> 90 dB a row, FM rows by RMS within 0.1 dB) from block 4, the first
  past the 1025-tap channel filter's warm-up at 256-sample blocks; no
  collective call;
- 256 channels through the fused front at 128 a rank (the JAX fused
  front's tile), against the JAX fused chain (> 90 dB) and the port's;
- the featured chain at 32 channels, the reference's [32, 32] collision
  case, against the port's unsharded chain (1e-6 of the peak) and the JAX
  chain (tests/test_torch_rx.py's featured floors, from block 3);
- the time-sharded FIR (plain > 100 dB, decimating > 100 dB), one-pole
  (> 80 dB, one all_gather a call), NCO (phase continuous across shard
  edges) and ``timeshard_rx`` (SSB > 90 dB, FM > 60 dB from sample 512,
  see there, AM > 80 dB) against the JAX package's float64 oracle, as
  tests/test_timeshard.py builds it, and in AM against the JAX
  ``timeshard_rx`` on a (1, 2) mesh (> 80 dB);
- the time-sharded PFB over two blocks against the JAX unsharded
  OversampledPFB + MixedDemod (audio within 1e-3, spectra rtol 1e-3, as
  tests/test_scaling.py:165-222), with one ring message and one
  all_to_all a block and nothing else;
- the scaling harness (weak and strong, the timeshard point, the table).

In this process: the split rule (a per-channel leaf named ``taps``, a
shared [C, C] leaf, a [2C] leaf that raises, the port's own collision of
``nr.window`` at 512 channels) and a JAX chain carried across by
``convert`` sharding to the same rank trees as the port's own chain.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__
from quisk_tpu.oracle import dsp
from quisk_tpu.rx import RxChain as JRxChain
from quisk_tpu.rx import RxChainConfig as JRxChainConfig

import torch_parallel_ranks as ranks
from quisk_tpu_torch import convert
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.parallel.comm import Mesh
from quisk_tpu_torch.parallel.scaling import (ScalePoint,
                                              efficiency_within_bound,
                                              flagship, format_table,
                                              quotable)
from quisk_tpu_torch.parallel.shard import (channel_rows, channel_split,
                                            shard_over_channels, twin_count)
from quisk_tpu_torch.rx import RxChain, RxChainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
RUN_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def _torch_one_thread():
    """One torch thread (tests/test_torch_rx.py: a worker thread's cos has
    been off by ~1e-4 on some CPU hosts)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Worlds:
    """The worlds of 1, 2 and 4 ranks; ``result(n)`` starts world n the
    first time a test asks for it and waits for it, so a process runs only
    the worlds its tests use."""

    def __init__(self, tmp):
        self.tmp, self.procs, self.done = tmp, {}, {}

    def start(self, n) -> None:
        d = self.tmp / f"w{n}"
        d.mkdir()
        self.procs[n] = [subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests",
                                          "torch_parallel_ranks.py"),
             "--rank", str(r), "--world", str(n),
             "--init", f"file://{d}/store", "--out", str(d)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n)]

    def result(self, n) -> list[dict]:
        if n not in self.done:
            if n not in self.procs:
                self.start(n)
            outs = []
            try:
                for p in self.procs[n]:
                    outs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0])
            finally:
                self.kill(n)
            for r, (p, out) in enumerate(zip(self.procs[n], outs)):
                assert p.returncode == 0, f"world {n} rank {r}:\n{out}"
            d = self.tmp / f"w{n}"
            self.done[n] = [dict(np.load(d / f"w{n}_r{r}.npz"))
                            for r in range(n)]
        return self.done[n]

    def kill(self, n=None) -> None:
        for m in (list(self.procs) if n is None else (n,)):
            for p in self.procs[m]:
                p.kill()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("parallel"))
    yield w
    w.kill()


def stitch_rows(parts, name):
    by = sorted(parts, key=lambda z: int(z[f"{name}.rows"][0]))
    spans = [tuple(int(v) for v in z[f"{name}.rows"]) for z in by]
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    return np.concatenate([z[f"{name}.audio"] for z in by], axis=0), spans


def stitch_grid(parts, name):
    """Reassemble a [C, N] output from (lo, hi, t0, t1) blocks (the time
    positions in input samples, scaled to the output's rate)."""
    pos = [tuple(int(v) for v in z[f"{name}.pos"]) for z in parts]
    C = max(p[1] for p in pos)
    N = max(p[3] for p in pos)
    ys = [z[f"{name}.y"] for z in parts]
    D = (pos[0][3] - pos[0][2]) // ys[0].shape[-1]
    out = np.zeros((C, N // D), ys[0].dtype)
    for (lo, hi, t0, t1), y in zip(pos, ys):
        out[lo:hi, t0 // D:t1 // D] = y
    return out


def counts(z, name) -> dict:
    return dict(zip(ranks.COUNT_KINDS, z[f"{name}.counts"].tolist()))


def snr_rows(ref, got):
    """Row SNR in dB (-inf on a silent reference row: a closed squelch,
    which the featured comparison handles before reading it)."""
    err = np.mean((got - ref) ** 2, axis=-1)
    with np.errstate(divide="ignore"):
        return 10 * np.log10(np.mean(ref ** 2, axis=-1) / (err + 1e-30))


def peak_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


# ------------------------------------------------------- channel sharding
@pytest.fixture(scope="module")
def flagship_refs():
    """The JAX flagship and the port's, unsharded, on the ranks' input."""
    jch = __graft_entry__._flagship(channels=ranks.CHAIN_C,
                                    sample_rate=ranks.FS, audio_block=256)
    x = ranks.chain_input(ranks.CHAIN_C, ranks.CHAIN_BLOCKS * jch.block_in,
                          30)
    _, ja = jch.process(jch.init_state(), x)
    ch = flagship(ranks.CHAIN_C, sample_rate=ranks.FS, audio_block=256,
                  fused=False, device="cpu")
    with torch.no_grad():
        _, a = ch.process(ch.init_state(), torch.as_tensor(x))
    return np.asarray(ja), a.numpy(), np.asarray(jch.demod.mode)


# blocks of 256 audio samples that the 1025-tap channel filter's history
# takes to fill: compared from the first block past it
WARM_BLOCKS = 4


def assert_blocks_match(ref, got, modes, block, from_block):
    """> 90 dB a row from ``from_block`` on, FM rows by RMS within 0.1 dB
    where they do not clear it (tests/test_torch_rx.py's floors)."""
    for b in range(from_block, ref.shape[-1] // block):
        r = ref[:, b * block:(b + 1) * block]
        g = got[:, b * block:(b + 1) * block]
        s = snr_rows(r, g)
        for c in range(ref.shape[0]):
            if s[c] > 90.0:
                continue
            assert modes[c] == int(Mode.FM), (b, c, s[c])
            db = 20 * np.log10(np.sqrt(np.mean(g[c] ** 2))
                               / np.sqrt(np.mean(r[c] ** 2)))
            assert abs(db) < 0.1, (b, c, s[c], db)


@pytest.mark.parametrize("n", WORLDS)
def test_channel_sharded_flagship(worlds, flagship_refs, n):
    parts = worlds.result(n)
    audio, spans = stitch_rows(parts, "chain")
    assert spans == [channel_rows(ranks.CHAIN_C, r, n) for r in range(n)]
    for z in parts:
        assert counts(z, "chain") == dict.fromkeys(ranks.COUNT_KINDS, 0)
    ja, pa, modes = flagship_refs
    assert audio.shape == pa.shape == ja.shape
    assert np.all(np.isfinite(audio))
    assert peak_err(audio, pa) < 1e-6
    assert_blocks_match(ja, audio, modes, 256, WARM_BLOCKS)


def test_fused_front_at_128_a_rank(worlds):
    """256 channels over 2 ranks: 128 a rank, the JAX fused front's tile,
    so the JAX chain runs its fused front too."""
    parts = worlds.result(2)
    audio, spans = stitch_rows(parts, "fused")
    assert spans == [(0, 128), (128, 256)]
    C = ranks.FUSED_C
    jch = JRxChain.create(JRxChainConfig(**ranks.fused_kw(C)),
                          tune_hz=ranks.tune(C), mode=int(Mode.USB))
    assert jch.front is not None
    x = ranks.chain_input(C, ranks.FUSED_BLOCKS * jch.block_in, 5)
    _, ja = jch.process(jch.init_state(), x)
    ch = RxChain.create(RxChainConfig(**ranks.fused_kw(C)),
                        tune_hz=ranks.tune(C),
                        mode=int(Mode.USB), device="cpu")
    with torch.no_grad():
        _, pa = ch.process(ch.init_state(), torch.as_tensor(x))
    assert peak_err(audio, pa.numpy()) < 1e-6
    assert_blocks_match(np.asarray(ja), audio, [int(Mode.USB)] * C, 256, 1)


# featured floors of tests/test_torch_rx.py: the adaptive stages feed back
# float32 differences between the packages (60 dB a row, FM by RMS within
# 0.5 dB; an FM row whose squelch opened on one side only is counted)
FEATURED_DB = 60.0
FEATURED_FM_DB = 0.5
FM_SQUELCH_SPLIT_MAX = 4


@pytest.fixture(scope="module")
def featured_refs():
    C = ranks.FEAT_C
    mode = [ranks.MODES[i % 4] for i in range(C)]
    jch = JRxChain.create(JRxChainConfig(**ranks.featured_kw(C),
                                         mxu_stft=False),
                          tune_hz=ranks.tune(C), mode=mode)
    x = ranks.featured_input(C, ranks.FEAT_BLOCKS * jch.block_in)
    _, ja = jch.process(jch.init_state(), x)
    ch = RxChain.create(RxChainConfig(**ranks.featured_kw(C)),
                        tune_hz=ranks.tune(C), mode=mode, device="cpu")
    with torch.no_grad():
        _, pa = ch.process(ch.init_state(), torch.as_tensor(x))
    return np.asarray(ja), pa.numpy(), mode


@pytest.mark.parametrize("n", WORLDS)
def test_featured_chain_at_32_channels(worlds, featured_refs, n):
    """The reference's collision case: at 32 channels its name-set rule
    once sharded a [32, 32] DFT basis.  Sharded here by the twin rule."""
    audio, spans = stitch_rows(worlds.result(n), "featured")
    assert spans == [channel_rows(ranks.FEAT_C, r, n) for r in range(n)]
    ja, pa, mode = featured_refs
    assert peak_err(audio, pa) < 1e-6
    split, compared = set(), 0
    for b in range(3, ranks.FEAT_BLOCKS):
        r = ja[:, b * 512:(b + 1) * 512]
        g = audio[:, b * 512:(b + 1) * 512]
        s = snr_rows(r, g)
        for c in range(ranks.FEAT_C):
            fm = mode[c] == int(Mode.FM)
            p_r, p_g = np.mean(r[c] ** 2), np.mean(g[c] ** 2)
            if c in split:
                continue
            if p_r == 0.0 or p_g == 0.0:             # a closed squelch
                if fm and p_r != p_g:
                    split.add(c)
                else:
                    assert p_r == p_g == 0.0, (b, c)
            elif fm and s[c] <= FEATURED_DB:
                assert abs(10 * np.log10(p_g / p_r)) < FEATURED_FM_DB, (b, c)
            else:
                assert s[c] > FEATURED_DB, (b, c, s[c])
                compared += 1
    assert compared >= 8 * 3
    assert len(split) <= FM_SQUELCH_SPLIT_MAX


# ------------------------------------------------------------ time sharding
@pytest.mark.parametrize("n", WORLDS)
def test_shard_fir_plain_and_decimating(worlds, n):
    parts = worlds.result(n)
    xs = ranks.timeshard_inputs()
    for name, taps, decim in (("fir", design.lowpass(201, 3000.0, 48000.0),
                               1),
                              ("fir_d2", design.halfband(45), 2)):
        y = stitch_grid(parts, name)
        assert y.shape == (2, 8192 // decim)
        for c in range(2):
            _, ref = dsp.fir_stream(xs[name][c].astype(np.complex128), taps,
                                    decim=decim)
            assert dsp.snr_db(ref, y[c]) > 100, (name, c)


@pytest.mark.parametrize("n", WORLDS)
def test_shard_one_pole(worlds, n):
    parts = worlds.result(n)
    x = ranks.timeshard_inputs()["one_pole"]
    y = stitch_grid(parts, "one_pole")
    for c in range(2):
        ref = dsp.one_pole(x[c].astype(np.float64), 0.97, 0.03)
        assert dsp.snr_db(ref, y[c]) > 80
    for z in parts:
        c = counts(z, "one_pole")
        assert c["all_gather"] == 1 and c["send"] == c["all_to_all"] == 0, c


@pytest.mark.parametrize("n", WORLDS)
def test_shard_nco_phase_continuity(worlds, n):
    """Mixing a tone down by its own frequency gives DC with no phase jump
    at the shard edges."""
    y = stitch_grid(worlds.result(n), "nco")
    for c in range(2):
        ang = np.unwrap(np.angle(y[c]))
        assert np.max(np.abs(np.diff(ang))) < 1e-2
        assert np.std(np.abs(y[c])) < 1e-3


def _timeshard_oracle(iq, f0, band, mode):
    bb = dsp.mix_down(iq.astype(np.complex128), f0, 192000.0)
    for taps in (design.halfband(45), design.halfband(45)):
        _, bb = dsp.fir_stream(bb, taps, decim=2)
    _, bb = dsp.fir_stream(bb, design.bandpass_analytic(1025, *band,
                                                        48000.0))
    if mode == "ssb":
        return 2.0 * np.real(bb)
    if mode == "am":
        # timeshard_rx's AM: the envelope's difference through the 0.995
        # one-pole, unit gain
        return dsp.am_demod(bb, pole=0.995, gain=1.0)
    return dsp.fm_demod(bb, 48000.0, 2500.0)


# FM: while the channel filter's history fills, x[n] * conj(x[n-1]) is
# ~1e-51, below float32's range, so the product is a signed zero and the
# discriminator reads +pi or -pi by the sign of a zero (the port reads +pi
# at sample 2 where the float64 oracle reads -pi); the de-emphasis carries
# that for a few hundred samples (3.5e-5 at sample 256, 1e-7 from 512).
# Compared from sample 512, half the 1025-tap filter, where the signal has
# filled it.  SSB and AM have no such branch: from sample 64, as the
# reference's.
AM_DB = 80.0
TS_CASES = {"ssb": (40000.0, (300.0, 3100.0), 90.0, 64),
            "fm": (-30000.0, (-6250.0, 6250.0), 60.0, 512),
            "am": (ranks.AM_TUNE_HZ, ranks.AM_BAND, AM_DB, 64)}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode,f0,band,floor,skip", [
    (m, *case) for m, case in TS_CASES.items()])
def test_timeshard_rx(worlds, n, mode, f0, band, floor, skip):
    parts = worlds.result(n)
    audio = stitch_grid(parts, mode)
    iq = ranks.timeshard_inputs()[mode]
    assert audio.shape == (2, 16384 // 4)
    ref = _timeshard_oracle(iq[0], f0, band, mode)
    for c in range(2):
        assert dsp.snr_db(ref, audio[c], skip=skip) > floor, (mode, c)
    for z in parts:
        c = counts(z, mode)
        # FIR halos; in FM and AM the one-pole's gather and the one-sample
        # halo of the discriminator or the envelope difference; no corner
        # turn
        assert c["all_to_all"] == 0
        assert c["all_gather"] == (0 if mode == "ssb" else 1), c
        nt = 1 if n == 1 else 2
        assert c["send"] == (0 if nt == 1 else 3 + (mode != "ssb")), c


@pytest.fixture(scope="module")
def jax_timeshard_am():
    """The JAX package's timeshard_rx in AM on a (chan, time) = (1, 2)
    mesh over the ranks' AM input."""
    import jax
    from jax.sharding import Mesh as JMesh
    from jax.sharding import NamedSharding, PartitionSpec
    from quisk_tpu.ops import design as jdesign
    from quisk_tpu.parallel import timeshard as jts

    mesh = JMesh(np.array(jax.devices()[:2]).reshape(1, 2), ("chan", "time"))
    x = jax.device_put(ranks.timeshard_inputs()["am"],
                       NamedSharding(mesh, PartitionSpec("chan", "time")))
    stages = [(jdesign.halfband(45), 2), (jdesign.halfband(45), 2)]
    return np.asarray(jts.timeshard_rx(
        x, mesh, sample_rate=192000.0, tune_hz=ranks.AM_TUNE_HZ,
        stages=stages, bp_taps=jdesign.bandpass_analytic(
            1025, *ranks.AM_BAND, 48000.0), mode="am"))


@pytest.mark.parametrize("n", WORLDS)
def test_timeshard_rx_am_against_the_jax_package(worlds, jax_timeshard_am,
                                                 n):
    audio = stitch_grid(worlds.result(n), "am")
    assert audio.shape == jax_timeshard_am.shape == (2, 16384 // 4)
    for c in range(2):
        assert dsp.snr_db(jax_timeshard_am[c], audio[c]) > AM_DB, c


# --------------------------------------------------------------------- PFB
@pytest.mark.parametrize("n", WORLDS)
def test_sharded_pfb_two_blocks(worlds, n):
    import jax.numpy as jnp
    from quisk_tpu.ops.channelizer import OversampledPFB as JPFB
    from quisk_tpu.ops.demod import MixedDemod as JMixed

    parts = worlds.result(n)
    for z in parts:
        c = counts(z, "pfb")
        assert c == {"send": ranks.PFB_BLOCKS if n > 1 else 0,
                     "recv": ranks.PFB_BLOCKS if n > 1 else 0,
                     "all_gather": 0, "all_to_all": ranks.PFB_BLOCKS,
                     "all_reduce": 0, "host_bytes": 0}, c
    audio, _ = stitch_rows(parts, "pfb")
    spec = np.concatenate([z["pfb.spec"] for z in sorted(
        parts, key=lambda z: int(z["pfb.rows"][0]))])
    K, B = 16 * n, 16 * n * 8 * n
    fam = [int(Mode.USB), int(Mode.AM), int(Mode.FM)]
    pfb = JPFB.create(K, B, taps_per_branch=8, mxu_dft=True)
    dm = JMixed.create([fam[(3 * i) // K] for i in range(K)],
                       sample_rate=96000.0, channels=K)
    rng = np.random.default_rng(7)
    h, st = pfb.init_state(1), dm.init_state(K)
    for _ in range(ranks.PFB_BLOCKS):
        xh = (rng.standard_normal((1, B)) + 1j * rng.standard_normal((1, B))
              ).astype(np.complex64)
        h, ch = pfb(h, jnp.asarray(xh))
        st, ref = dm(st, ch.reshape(K, -1))
    assert audio.shape == ref.shape
    assert float(np.max(np.abs(audio - np.asarray(ref)))) < 1e-3
    sp_ref = np.mean(np.abs(np.asarray(ch).reshape(K, -1)) ** 2, axis=-1)
    assert np.allclose(spec, sp_ref, rtol=1e-3, atol=1e-6)


# ----------------------------------------------------------------- scaling
@pytest.mark.parametrize("n", WORLDS)
def test_scaling_harness(worlds, n):
    out = json.loads(str(worlds.result(n)[0]["scaling.json"]))
    devices = [d for d in (1, 2, 4) if d <= n]
    weak = [ScalePoint(**p) for p in out["weak"]]
    assert [p.devices for p in weak] == devices
    assert weak[0].efficiency == 1.0                 # the anchor
    for pts in (weak, [ScalePoint(**p) for p in out["timed"]]):
        for p in pts:
            assert p.channels == 8 * p.devices       # weak: per rank fixed
            assert p.samples_per_s > 0 and p.step_ms > 0
            # CPU ranks share one host's cores (shared silicon): of-ideal
            # is efficiency * n, and no bound is put on the efficiency
            # itself, which load on the host moves either way
            assert abs(p.eff_of_ideal - p.efficiency * p.devices) < 1e-9
            assert p.shared
    timed = [ScalePoint(**p) for p in out["timed"]]
    assert all(np.isfinite(p.noise_pct) for p in timed)
    # every point here shares the host's cores: none is held to a bound
    assert all(efficiency_within_bound(p) for p in timed)
    table = format_table(weak)
    assert "of-ideal" in table and "NOT a quotable efficiency" in table
    assert table.count("*") >= len(weak)             # iters=1: all flagged
    strong = [ScalePoint(**p) for p in out["strong"]]
    assert [p.channels for p in strong] == [4 * max(devices)] * len(devices)
    sps, ms = out["timeshard"]
    assert sps > 0 and ms > 0


def test_quotable_points_and_their_bound():
    """A point is quotable only with a spread estimate of at most 25%; the
    1.5 efficiency bound applies to quotable points on silicon of their
    own, never to smoke points or shared silicon."""
    def pt(eff, noise, n=2, shared=False):
        return ScalePoint(devices=n, channels=8 * n, samples_per_s=1.0,
                          efficiency=eff, eff_of_ideal=eff * (n if shared
                                                              else 1),
                          step_ms=1.0, noise_pct=noise, shared=shared)

    assert quotable(pt(0.9, 0.1)) and quotable(pt(0.9, 0.25))
    assert not quotable(pt(0.9, 0.26)) and not quotable(pt(0.9, np.nan))
    assert efficiency_within_bound(pt(1.5, 0.1))
    assert not efficiency_within_bound(pt(1.6, 0.1))
    assert efficiency_within_bound(pt(1.6, 0.4))                 # smoke
    assert efficiency_within_bound(pt(3.0, 0.1, shared=True))
    table = format_table([pt(1.0, 0.05, n=1), pt(0.95, 0.1)])
    assert "*" not in table and "NOT a quotable" not in table
    assert "NOT a quotable" in format_table([pt(1.0, 0.05, 1), pt(3.0, 0.4)])


# ------------------------------------------------------------- split rule
@dataclasses.dataclass(frozen=True)
class _Op:
    taps: torch.Tensor      # [C, T] per channel, under a name the
    window: np.ndarray      # reference replicates; [C, L] per channel
    basis: torch.Tensor     # [16, 16] shared: leads with C at C=16
    scale: torch.Tensor     # 0-dim shared
    channels: int
    block: int


def _op(C, basis_n=16, stack=False, square=False):
    return _Op(taps=torch.arange(C * 5, dtype=torch.float32).reshape(C, 5),
               window=np.arange(C * 3.0).reshape(C, 3),
               basis=(torch.ones((2 * C,)) if stack
                      else torch.eye(C) if square
                      else torch.eye(basis_n)),
               scale=torch.tensor(2.0), channels=C, block=64)


def _rank_mesh(r, n):
    return Mesh(axes=("chan",), shape=(n,), coords=(r,), groups=(None,),
                group=None, rank=r, device=torch.device("cpu"),
                backend="gloo")


def test_split_rule_follows_the_channel_count():
    C = 16
    tree, twin = _op(C), _op(twin_count(C))
    assert channel_split(tree, twin, C) == {
        "taps": "chan", "window": "chan", "basis": "shared",
        "scale": "shared", "channels": "count", "block": "shared"}
    for r in range(4):
        lo, hi = channel_rows(C, r, 4)
        loc = shard_over_channels(tree, _rank_mesh(r, 4), C, twin)
        assert torch.equal(loc.taps, tree.taps[lo:hi])
        assert np.array_equal(loc.window, tree.window[lo:hi])
        assert torch.equal(loc.basis, tree.basis)       # [16, 16] whole
        assert loc.channels == hi - lo and loc.block == 64
    with pytest.raises(ValueError, match="basis"):      # a [2C] stack
        channel_split(_op(C, stack=True), _op(2, stack=True), C)
    with pytest.raises(ValueError, match="basis"):      # [C, C] follows both
        channel_split(_op(C, square=True), _op(2, square=True), C)
    with pytest.raises(ValueError, match="another count"):
        channel_split(tree, _op(C), C)                  # twin at the same C


def test_split_keeps_the_featured_chains_shared_leaves():
    """The port's featured chain at 512 channels carries a [512] NR window:
    it keeps its shape in the twin and stays whole on every rank."""
    def featured(C):
        return RxChain.create(RxChainConfig(**ranks.featured_kw(C)),
                              tune_hz=ranks.tune(C),
                              mode=[ranks.MODES[i % 4] for i in range(C)],
                              device="cpu")
    C = 512
    ch, twin = featured(C), featured(twin_count(C))
    kinds = channel_split(ch, twin, C)
    assert ch.nr.window.shape == (C,) and kinds["nr.window"] == "shared"
    assert kinds["demod.mode"] == kinds["bp.mask"] == "chan"
    assert kinds["channels"] == "count"
    loc = shard_over_channels(ch, _rank_mesh(1, 4), C, twin)
    assert torch.equal(loc.nr.window, ch.nr.window)
    assert loc.channels == 128 and loc.demod.mode.shape == (128,)


def _leaves(tree, out, path=""):
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out, f"{path}.{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _leaves(v, out, f"{path}.{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _leaves(v, out, f"{path}.{i}")
    else:
        out[path] = tree
    return out


def test_jax_weights_and_state_shard_like_the_ports_own():
    from test_torch_rx import _jax_chain_arrays, _tree_np

    C = ranks.CHAIN_C
    jch = __graft_entry__._flagship(channels=C, sample_rate=ranks.FS,
                                    audio_block=256)
    conv = convert.rx_chain_from_numpy(_jax_chain_arrays(jch), "cpu")
    conv_st = convert.rx_state_from_numpy(_tree_np(jch.init_state()), "cpu")
    own = flagship(C, sample_rate=ranks.FS, audio_block=256, fused=False,
                   device="cpu")
    twin = flagship(twin_count(C), sample_rate=ranks.FS, audio_block=256,
                    fused=False, device="cpu")
    for r in range(4):
        mesh = _rank_mesh(r, 4)
        for a, b in ((shard_over_channels(conv, mesh, C, twin),
                      shard_over_channels(own, mesh, C, twin)),
                     (shard_over_channels(conv_st, mesh, C,
                                          twin.init_state()),
                      shard_over_channels(own.init_state(), mesh, C,
                                          twin.init_state()))):
            la, lb = _leaves(a, {}), _leaves(b, {})
            assert la.keys() == lb.keys()
            for k in la:
                if isinstance(la[k], torch.Tensor):
                    assert la[k].dtype == lb[k].dtype, k
                    assert torch.equal(la[k], lb[k]), k
                else:
                    assert la[k] == lb[k], k


def test_entry_points_default_to_the_card():
    """Without ``device`` the world, the mesh and the builders take the
    card, and raise on a host without one; the backend is never chosen for
    the caller."""
    import inspect

    from quisk_tpu_torch.parallel import comm
    from quisk_tpu_torch.parallel.scaling import measure_scaling

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults would take it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        comm.init_world("file:///nonexistent/store", 0, 1, "gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship(4)
    assert inspect.signature(comm.init_world).parameters[
        "backend"].default is inspect.Parameter.empty
    for fn in (comm.make_mesh, measure_scaling):
        assert inspect.signature(fn).parameters["device"].default is None
