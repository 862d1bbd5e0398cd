"""Multi-process jobs of the port: ``python -m
quisk_tpu_torch.parallel.dcn_worker`` as two ranks of one gloo world on the
CPU (a ``file://`` store under the test's tmp_path, a timeout on every
rank), each job's rows stitched by their ``lo:hi`` and held to the
unsharded port and to the JAX package on the same seeded capture:

- the flagship chain job against the JAX ``__graft_entry__._flagship``
  chain run unsharded (within 1e-4 of the peak after SKIP, as
  tests/test_multiprocess.py holds the reference's job) and against the
  port's own chain run unsharded (within 1e-6 of the peak);
- the PFB job against the JAX unsharded OversampledPFB + MixedDemod
  (within 1e-3, spectra rtol 1e-3, as tests/test_scaling.py:165-222) and
  the port's unsharded pipeline (within 1e-5 of the peak);
- the time-sharded receive job against the JAX ``timeshard_rx`` on a
  (chan=1, time=2) mesh of the JAX package's CPU devices (> 90 dB).

Each job also reports its collective counts: the chain step none, the PFB
step two ring messages and one all_to_all a block, the halo receive its
ring messages and no gather.
"""

import os
import subprocess
import sys

import numpy as np
import torch

from quisk_tpu_torch.parallel.dcn_worker import COUNT_KINDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
CHANNELS = 16
BLOCKS = 6
# the 1025-tap channel filter's group delay makes the first ~3 audio
# blocks warm-up; the FM discriminator on that near-zero signal is
# numerically chaotic, so the comparison starts after it
SKIP = 1024


def run_world(tmp_path, *job, nproc=NPROC, timeout=300):
    """Start ``nproc`` ranks of dcn_worker on one file store; return the
    npz files' contents by pid."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    init = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "quisk_tpu_torch.parallel.dcn_worker",
         "--pid", str(pid), "--nproc", str(nproc), "--init", init,
         "--backend", "gloo", "--device", "cpu", "--outdir", str(tmp_path),
         "--timeout", "120", *job],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{out}"
        assert f"process_count={nproc}" in out, out
    return outs


def load(tmp_path, name, nproc=NPROC):
    out = []
    for pid in range(nproc):
        z = np.load(tmp_path / f"{name}_p{pid}.npz")
        assert int(z["process_count"]) == nproc
        out.append({k: z[k] for k in z.files})
    return out


def counts(z) -> dict:
    return dict(zip(COUNT_KINDS, z["counts"].tolist()))


def stitch(parts, total):
    rows = {(int(z["lo"]), int(z["hi"])): z["audio"] for z in parts}
    spans = sorted(rows)
    assert spans[0][0] == 0 and spans[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    return np.concatenate([rows[s] for s in spans], axis=0)


def peak_err(got, ref):
    return float(np.max(np.abs(got - ref)) / (np.max(np.abs(ref)) + 1e-12))


def test_two_rank_chain_job_matches_jax_and_unsharded(tmp_path):
    outs = run_world(tmp_path, "--channels", str(CHANNELS), "--blocks",
                     str(BLOCKS))
    assert all("rows [" in o for o in outs)
    parts = load(tmp_path, "audio")
    for z in parts:
        assert counts(z) == dict.fromkeys(COUNT_KINDS, 0)   # no collective
    audio = stitch(parts, CHANNELS)

    import __graft_entry__
    from quisk_tpu.io import sources as jsources

    jchain = __graft_entry__._flagship(channels=CHANNELS,
                                       sample_rate=192000.0,
                                       audio_block=256, agc=False)
    n = BLOCKS * jchain.block_in
    tunes = np.asarray(jchain.tune_base)
    modes = np.asarray(jchain.demod.mode)
    iq = np.stack([jsources.station_iq(modes[c], 192000.0, n,
                                       float(tunes[c]), seed=c)
                   for c in range(CHANNELS)])
    _, ref = jchain.process(jchain.init_state(), iq)
    ref = np.asarray(ref)
    assert audio.shape == ref.shape
    # the port's front runs the /4 cascade fused, the JAX chain unfused:
    # 1e-4 of the peak, tests/test_multiprocess.py's bound
    assert peak_err(audio[:, SKIP:], ref[:, SKIP:]) < 1e-4

    from quisk_tpu_torch.parallel.scaling import flagship

    with torch.no_grad():
        chain = flagship(CHANNELS, sample_rate=192000.0, audio_block=256,
                         agc=False, device="cpu")
        _, own = chain.process(chain.init_state(), torch.as_tensor(iq))
    # the same chain on fewer rows: equal up to row-blocking of the sums
    assert peak_err(audio, own.numpy()) < 1e-6


def _pfb_reference(K, B, blocks):
    """The JAX unsharded pipeline and the port's, on the worker's capture:
    (jax audio, jax spec, port audio, port spec) of the last block."""
    import jax.numpy as jnp
    from quisk_tpu.modes import Mode as JMode
    from quisk_tpu.ops.channelizer import OversampledPFB as JPFB
    from quisk_tpu.ops.demod import MixedDemod as JMixed

    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.ops.channelizer import OversampledPFB
    from quisk_tpu_torch.ops.demod import MixedDemod

    jm = [int(JMode.USB), int(JMode.AM), int(JMode.FM)]
    jpfb = JPFB.create(K, B, taps_per_branch=8)
    jdm = JMixed.create([jm[(3 * i) // K] for i in range(K)],
                        sample_rate=96000.0, channels=K)
    m = [int(Mode.USB), int(Mode.AM), int(Mode.FM)]
    pfb = OversampledPFB.create(K, B, taps_per_branch=8, device="cpu")
    dm = MixedDemod.create([m[(3 * i) // K] for i in range(K)],
                           sample_rate=96000.0, channels=K, device="cpu")
    rng = np.random.default_rng(7)
    jh, jst = jpfb.init_state(1), jdm.init_state(K)
    h, st = pfb.init_state(1), dm.init_state(K)
    for _ in range(blocks):
        xh = (rng.standard_normal((1, B)) + 1j * rng.standard_normal((1, B))
              ).astype(np.complex64)
        jh, jch = jpfb(jh, jnp.asarray(xh))
        jst, ja = jdm(jst, jch.reshape(K, -1))
        h, ch = pfb(h, torch.as_tensor(xh))
        st, a = dm(st, ch.reshape(K, -1))
    jspec = np.mean(np.abs(np.asarray(jch).reshape(K, -1)) ** 2, axis=-1)
    spec = (ch.reshape(K, -1).abs() ** 2).mean(dim=-1).numpy()
    return np.asarray(ja), jspec, a.numpy(), spec


def test_two_rank_pfb_job_matches_unsharded(tmp_path):
    blocks = 2                               # the carried history is used
    run_world(tmp_path, "--pfb", "--blocks", str(blocks))
    parts = load(tmp_path, "pfb")
    K = 16 * NPROC
    B = K * 8 * NPROC
    for z in parts:
        c = counts(z)
        # a block: one ring message each way and one all_to_all, nothing
        # else; the gloo CPU mesh stages nothing
        assert c == {"send": blocks, "recv": blocks, "all_gather": 0,
                     "all_to_all": blocks, "all_reduce": 0,
                     "host_bytes": 0}, c
    audio = stitch(parts, K)
    spec = np.concatenate([z["spec"] for z in sorted(
        parts, key=lambda z: int(z["lo"]))])
    ja, jspec, pa, pspec = _pfb_reference(K, B, blocks)
    assert audio.shape == ja.shape
    assert np.max(np.abs(audio - ja)) < 1e-3
    assert np.allclose(spec, jspec, rtol=1e-3, atol=1e-6)
    assert peak_err(audio, pa) < 1e-5
    assert np.allclose(spec, pspec, rtol=1e-5, atol=1e-9)


def test_two_rank_timeshard_job_matches_jax(tmp_path):
    C, N = 4, 8192
    run_world(tmp_path, "--timeshard", "--channels", str(C), "--block",
              str(N), "--blocks", "1")
    parts = load(tmp_path, "ts")
    for z in parts:
        c = counts(z)
        # SSB: one ring message each way for each of its three FIRs' halos
        # (the NCO needs none), no gather, no corner turn
        assert c["send"] == c["recv"] == 3 and c["all_gather"] == 0 \
            and c["all_to_all"] == 0, c
    parts = sorted(parts, key=lambda z: int(z["t0"]))
    assert [int(z["t0"]) for z in parts] == [0, N // 8]
    audio = np.concatenate([z["audio"] for z in parts], axis=-1)

    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from quisk_tpu.parallel.timeshard import timeshard_rx as jtimeshard_rx

    from quisk_tpu_torch.parallel.scaling import (seeded_capture,
                                                  timeshard_filters)

    iq = seeded_capture(C, N, torch.device("cpu")).numpy()
    stages, bp = timeshard_filters()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("chan", "time"))
    ref = np.asarray(jtimeshard_rx(
        jax.device_put(iq, NamedSharding(mesh, P("chan", "time"))), mesh,
        sample_rate=192000.0, tune_hz=10000.0, stages=stages, bp_taps=bp,
        mode="ssb"))
    assert audio.shape == ref.shape == (C, N // 4)
    err = np.mean((audio - ref) ** 2, axis=-1)
    snr = 10 * np.log10(np.mean(ref ** 2, axis=-1) / err)
    assert snr.min() > 90.0, snr
