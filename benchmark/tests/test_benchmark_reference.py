"""The plain reference agrees with the port at a small size on the CPU
(where the port runs its kernels' plain versions), in the steady state of
a stream, for both receivers and both of the AGC reference's paths."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from qbench import signals
from qref.pfb import PfbReference
from qref.rx import RxReference
from qref.spec import listened, pfb_modes, rx_modes, rx_tunes

RX_CFG = {
    "chain": {"sample_rate": 960000.0, "channels": 4, "audio_block": 2048,
              "agc": True, "fused_frontend": True},
    "tune": {"first_hz": -180000.0, "step_hz": 120000.0},
    "modes": {"cycle": ["USB", "LSB", "AM", "FM"]},
    "signal": {"noise_rms": 1.0, "level_db": [0.0, 12.0],
               "ssb_tone_hz": [400.0, 2600.0], "am_tone_hz": 1000.0,
               "am_depth": 0.5, "fm_tone_hz": 1000.0,
               "fm_deviation_hz": 3000.0},
}
PFB_CFG = {
    "pipeline": {"n_chan": 256, "block": 16384, "channel_rate": 96000.0,
                 "taps_per_branch": 8, "atten_db": 90.0},
    "input_rate": 12288000.0,
    "modes": {"by_run": ["USB", "LSB", "AM", "FM"]},
    "listen_channels": 16,
    "signal": RX_CFG["signal"],
}


def _gap(got, want):
    return float((np.abs(got - want).max(-1)
                  / np.abs(want).max(-1)).max())


@pytest.fixture(scope="module")
def rx_stream():
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.rx.chain import RxChain, RxChainConfig
    chain = RxChain.create(RxChainConfig(**RX_CFG["chain"]),
                           tune_hz=rx_tunes(RX_CFG),
                           mode=[int(Mode[m]) for m in rx_modes(RX_CFG)],
                           device="cpu")
    gen = torch.Generator().manual_seed(9)
    ring = signals.rx_ring(RX_CFG, 9, 5, chain.block_in, "cpu", gen)
    st, outs = chain.init_state(), []
    for j in range(31):
        st, a = chain.step(st, ring[j % 5])
        outs.append(a.numpy())
    xmax = torch.stack([b.abs().amax(-1) for b in ring]).amax(0).double()
    return ring, outs, xmax.numpy()


@pytest.mark.parametrize("k", [12, 30])     # from the start; certified AGC
def test_rx_reference_matches_port(rx_stream, k):
    ring, outs, xmax = rx_stream
    ref = RxReference.create(RX_CFG)
    want = ref.block(lambda j: ring[j % 5], k, xmax)
    assert _gap(outs[k], want) < 2e-5
    assert ref.extended <= RX_CFG["chain"]["channels"]


@pytest.mark.parametrize("kernel_route", [True, False])
def test_pfb_reference_matches_port(kernel_route):
    from quisk_tpu_torch.modes import Mode
    from quisk_tpu_torch.ops.channelizer import PFBRxPipeline
    p = PFB_CFG["pipeline"]
    K, B = p["n_chan"], p["block"]
    pipe = PFBRxPipeline.create(
        K, B, [int(Mode[m]) for m in pfb_modes(PFB_CFG)], channel_rate=96000.0,
        pallas_poly=kernel_route, pallas_demod=kernel_route, device="cpu")
    gen = torch.Generator().manual_seed(4)
    ring = signals.pfb_ring(PFB_CFG, 4, 3, "cpu", gen)
    lis = listened(PFB_CFG, 4)
    pos = pipe.chan_pos if kernel_route else np.arange(K)
    st = pipe.init_state(1)
    ref = PfbReference.create(PFB_CFG)
    n_out = 2 * B // K
    for j in range(60):
        st, (audio, power) = pipe(st, ring[j % 3])
        if j in (0, 59):
            got = audio.reshape(n_out, K)[:, pos[lis]].T.numpy()
            want, want_p = ref.block(lambda i: ring[i % 3], j, lis)
            assert _gap(got, want) < 5e-5
            assert float((np.abs(power[0].numpy() - want_p)
                          / want_p).max()) < 5e-5
