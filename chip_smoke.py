#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (quisk_tpu_torch).

Drives the port's main paths on one CUDA card.  The per-channel receivers,
each at 1024 channels and 2048-sample audio blocks: the flagship receiver
(960 kS/s in, channels cycling USB/LSB/AM/FM, the whole /20 cascade fused into the hand-written
front kernel, 1025-tap overlap-save channel filter, mixed demod, lookahead
AGC), the featured receiver (the flagship plus noise blanker, auto-notch,
LMS notch, spectral NR and both squelches, the blanker detected and applied
inside the front kernel), the same through its verification route (the
blanker detected by torch ops and applied by the kernel's gained mode),
the NFM receiver (192 kS/s, all
FM, FM squelch), the flagship on the WDSP-exact AGC and the featured
receiver behind the raw-IQ conditioner.  And the 4096-channel PFB
channelizer receiver (2x-oversampled polyphase filterbank, 33.5 M input
samples a block, mode quarters USB/LSB/AM/FM, polyphase sums, stage-2 IDFT
and demodulators in hand-written kernels) with the critically-sampled
channelizer beside it.  Then the 1024-channel transmit chain, the TX->RX
loopback over the front kernel, PureSignal and the spectrum services.
Then the two PLL demodulators on their hand-written kernel, each through
the receive chain's EXT slot at 1024 channels, and the remaining DSP ops.
Then the host edge: the flagship fed from host memory through DeviceFeed,
the PFB receiver fed by the ingest plane (a live wideband UDP stream
through the native pump straight into DeviceFeed's pinned slot) and a
live HiQSDR Radio, the Radio session (a 48 kS/s user's session, 1024
channels at 960 kS/s on one capture, and a keyed TX->RX loopback session)
and the CLI.  Then the
AGC / ALC recurrence kernel that the TX chain and the WDSP AGC run on,
and the Radio through every user surface.  Then the parallel paths on
torch.distributed: the channel-sharded flagship, the halo-exchange
receiver and the time-sharded PFB step in a world of one over NCCL, and
dcn_worker's jobs as two ranks sharing the card.  Last, the five example
programs a user runs first (examples/torch_*.py).
Phases, each fatal on failure:

1. environment: the card's name and power limit; build every kernel in
   quisk_tpu_torch/csrc/ (one nvcc each, started together) and, beside
   them, the ingest library quisk_tpu_torch/native/ingest.cpp (g++);
   fails without a C++ compiler;
2. the fused tune+decimate kernel at a small half-band shape whose tile
   N does not fill (>= 100 dB against the float64 reference; taps too
   long for shared memory must raise), at the ragged edges of its
   register-blocked tile (N = 1, N one more than a multiple of the outputs
   a thread R, N one less than a block's outputs O, T = 1, T < d, T a
   whole number of taps a phase, d = 1, two channels with different
   words: each >= 100 dB against float64, within 1e-4 of the peak of the
   plain version, one launch each), then at the flagship shape
   (C=1024, B=40960, T=1421, d=20) over 2 streamed blocks: >= 100 dB
   against the float64 reference, max abs difference to the plain
   PyTorch version within 1e-4 of the output's peak;
3. the flagship RxChain on the card for 8 blocks of seeded noise with a
   carrier 1 kHz above channel 0's dial (USB): finite [1024, 2048]
   audio per block, the 1 kHz beat recovered, one front kernel launch,
   one mixed-demod launch and one lookahead AGC kernel launch per block,
   and channels 0-7 equal
   (> 90 dB from block 2 on, FM by RMS) to the same chain run on the CPU;
4. timing with CUDA events after warm-up: ms per block, input Msps, the
   real-time factor, per-stage times, the device idle share of 10 steps
   traced by torch.profiler (1 - busy/span, busy the union of kernel and
   copy intervals; and 1 - busy/untraced step, without the profiler's
   host cost) with the front kernel's share of busy time, and per
   kernel its ms, the plain version's ms, the bound and a one-call
   PyTorch yardstick; then the lookahead AGC's kernel (csrc/agc_delay.cu,
   from an RNG stream of its own, SEED + 13) against its plain route
   (torch ops on the card) over 3 chained blocks at [1024, 2048] and
   [8192, 2048] (output within 2e-5 of each row's peak, log gain within
   5e-6, delay line bit for bit), timed at both beside the plain route
   and its byte bound; then the mixed demodulator's kernel
   (csrc/mixed_demod.cu, from a stream of its own, SEED + 15) against its
   plain route over 3 chained blocks at the flagship's modes and the
   PLL-NFM plan's (every row EXT through the PLL) at [1024, 2048] and
   [8192, 2048], and at the sync-AM flagship's at [1024, 2048] (AM and FM
   rows >= 100 dB a row, the others and the carried samples bit for bit,
   one launch a call), timed from a CUDA graph and call by call beside its
   byte bound and the plain route;
5. the front kernel's gained and NB-detect modes at a small half-band
   shape (C=8, T=45, d=2, a block whose tile is not filled, kwidth 97) and
   at the flagship shape (avg_win 64, kwidth 961) over 3 streamed blocks
   with seeded impulses on every 7th channel: y >= 100 dB against the
   float64 reference and within 1e-4 of the peak of the plain version,
   the coarse gain equal to the plain version's except within HC groups
   of a group whose max lies within 1e-5 of its threshold (counted, at
   most 4 a block), all ones with the stage off, the carried gain fed to
   the next block, the NB-detect output equal to the gained mode's fed
   with the same gain except in the outputs the last 15 samples reach,
   each launch counter rising by the calls made; and one block of both
   modes at five odd shapes (tile 32, partial last tiles, decimations 3
   and 5, HC 1, W4 1) against the plain versions;
6. the featured RxChain for 8 blocks (noise, the carrier on channel 0,
   five-tone signals on the other non-FM channels of 0-7, an FM station
   on channel 3, impulses on every 7th channel): finite audio, one
   NB-detect launch per block and no other front launch, blanking on the
   impulse channels and none with the stage off, channels 0-7 against
   the CPU chain with an FM row among those compared and at most one FM
   row dropped; then the same 8 blocks through the host-detect
   verification route (one gained launch per block), held to the
   NB-detect route on every block from 3 on;
7. the NFM RxChain for 4 blocks: one plain launch per block, the FM
   squelch's hold and gain equal to the CPU chain's on channels 0-7, the
   carrier-bearing channels sample by sample and the other open ones by
   RMS, closed channels silent; then the front kernel at this path's
   shape (C=1024, B=8192, T=133, d=4) on the path's input over 2
   streamed blocks against its plain version and float64 reference, as
   in phase 2, and timed with its plain version, yardstick and bound;
8. the flagship with agc_profile="wcp" (the WDSP AGC's state machine on
   csrc/agc_scan.cu) for 8 blocks against the CPU chain on channels 0-7
   (>= 40 dB, the AGC's integer states equal after the last block, one
   front and one AGC kernel launch a block), timed like the
   flagship (events, host clock, idle share), the AGC stage alone by
   events with its CUDA launches; then HangAGC over the same blocks' demod
   audio, one launch a block;
9. timing of the featured and NFM steps with their idle shares, the
   featured stages, and the gained and NB-detect kernels with their plain
   versions and bounds;
10. the featured RxChain with front_cond=True, dc_remove_bw=300 (the
    one-pole DC blocker), a trim set and a DC offset on the input, for 5
    blocks: one NB-detect launch per block, the offset gone after the
    blocker, channels 0-7 against the CPU chain from block 3 on;
11. the PFB kernels against their plain versions at shapes off the main
    path's: both polyphase sums over 3 streamed blocks (K 10 to 4096, tap
    counts 3, 5 and 8, frame counts no tile divides, 2 streams; within
    1e-5 of the peak); the fused stage-2 IDFT + demod over 3 streamed
    calls from non-zero carries (K 256 and 512, frame counts 3 to 805, odd
    ones among them, up to four of the kernel's 256-frame chunks with a
    ragged last one, 2 streams, mixed / all-AM / all-FM masks: non-FM
    within 1e-4 of the peak, FM on noise by RMS) and on planes that put a
    carrier on every channel (FM sample by sample); launch counters rise
    by the calls made; what the kernels refuse raises, a stage-2 basis
    that is not the inverse DFT times a rotation among it;
12. the PFB receiver at full width, PFBRxPipeline.create(4096, 4096*8192,
    quarters, channel_rate=96000, pallas_poly=True, pallas_demod=True),
    for 3 blocks of seeded noise with a carrier 1 kHz off a USB channel,
    an AM carrier with a 1 kHz tone and an FM carrier with a 1 kHz tone:
    finite audio [1, n_out*K1, K2], one polyphase and one demod launch per
    block, the 1 kHz tone in each of the three channels' columns and the
    three channels on top of the power spectrum; the kernel route against
    the torch-op route on the card block by block; each kernel against its
    plain version on the path's own tensors; and the card against the
    same pipeline on the CPU at 256 frames;
13. the critically-sampled PFBChannelizer at K=4096, 8192 frames a block:
    one launch per block, y equal (>= 100 dB) to the torch-op route, the
    carriers in their channels, the kernel against its plain version;
14. timing of the PFB receiver (both routes), its stages, and kernels #4-#6
    with their plain versions and bounds;
15. the TX chain of bench.py:681-688 (1024 channels, 2048-sample mic
    blocks, 192 kS/s out, 6 dB compression, pre-emphasis 0.3, ALC on, rows
    USB/FM alternating) for 4 blocks of seeded voice-like audio: finite
    complex64 [1024, 8192] per block, rows 0-7 >= 80 dB against the same
    chain on the CPU, the ALC's per-sample clip decisions on rows 0-7 equal
    to the CPU's on identical inputs (those on each side's own modulated IQ
    counted), the USB rows' image band <= -40 dB against the wanted band
    through the card's SpectrumAnalyzer; one launch of csrc/tx_place.cu
    (Spot, the tune NCO and the trim) a step;
16. timing of the TX step (events and host clock, output Msps, real-time
    factor), its stages on one block's real intermediates, the CUDA
    launches of TxALC (at most 40) and of the whole step (at most 200),
    and its device idle share; the place kernel at the benchmark's [8192,
    4096] from a CUDA graph beside its byte bound and place_plain;
17. the TX->RX loopback: the TX chain with ALC, compression and
    pre-emphasis off into the 192 kS/s RxChain (kernel #1 at T=133, d=4)
    for 16 blocks: one front launch a block, the voice recovered at > 18 dB
    on rows 0-7 against the oracle of tests/test_tx.py:101-117, kernel #1
    on the loopback's own input against its plain version;
18. PureSignal: the IMD two-tone from a TxChain on the card through
    SimulatedPA, calibrated and refined once in the chain's predistortion
    slot: IMD better by > 12 dB by two_tone_imd_db and by the card's
    SpectrumAnalyzer;
19. the spectrum services at 1024 channels against the CPU: the analyzer
    (fft 2048, disjoint and 50% overlap) within rtol 1e-4 of the CPU's
    power, the S-meter and measure_frequency, ZoomSpectrum (16x) in its
    passband; and their times;
20. the PLL kernel (csrc/pll_demod.cu) in both modes, sync AM and PLL FM,
    against its plain version at shapes off the paths' (C not a multiple
    of its 32-channel block, B = 1, odd B, a short last tile; rows with a
    carrier >= 100 dB or within 1e-4 of the peak, rows of noise alone by
    RMS; and every output and carried state bit-equal, asserted), and a
    block cut in two calls at an odd sample equal to one call, bit for
    bit; after phase 22 (from a stream of its own, SEED + 7) its edges,
    each bit-equal in every output and state (a NaN matching a NaN): B one
    short of its 16-sample register tile, the tile and one past it, C = 1,
    C = 1025 (one channel past a full grid of 32-channel blocks), rows cut
    777 and 2 samples in and rows of stride B + 1 (not all 16-byte
    aligned), rows with a NaN sample (the carried ph and fr NaN in both),
    a state |ph| ~ 2e5 (sincosf's large-argument path), exact zeros and
    constants (atan2f on a +-0 operand), [1024, 2048] of exact zeros, and
    the kernel's sine and cosine against torch's cos and sin at 2 M angles
    and its atan2 against torch's at 2 M operand pairs over the whole
    float32 range; and
    each mode's time at C = 1, at C = 32 on 32 distinct rows and on 32
    copies of one row and on the zeros, beside its [1024, 2048] time, the
    earlier design's, the byte bound and the estimates of its tile loop's
    dependent chain and in-order issue from the kernel's SASS, with the
    branches a sample left on its hot path;
21. the PLL-NFM receiver (nfm_config with ext_demod="pll_fm": deviation 5
    kHz, CTCSS notch at 100 Hz; every row EXT; an FM station with voice
    and a 100 Hz tone on the even rows, 1e-4 noise on the odd rows) and
    the sync-AM flagship (flagship_config with ext_demod="sync_am", bw
    150 Hz; modes USB/LSB/EXT/FM; an AM station 40 Hz off its carrier on
    every EXT row) for 6 blocks each: one front, one PLL and one mixed
    demodulator launch a block, and on the PLL-NFM path one launch of the
    CTCSS notch's kernel
    (csrc/biquad.cu) a block, rows 0-7 against the CPU chain started from
    the card chain's state at block 2 (> 90 dB, FM rows by RMS), the
    squelch open on the
    station rows only, the CTCSS line under the voice on row 0, the voice
    recovered on row 2 (> 6 dB); the kernel against its plain version on
    each path's own [1024, 2048] demod input (bit-equal, asserted), with
    the exact zeros in it and in the first block from an empty history;
22. timing of both paths (events, host clock, idle share), the PLL-NFM
    step's stages by CUDA events, and the kernel in both modes
    with its plain version and bound; then the CTCSS notch's kernel
    (csrc/biquad.cu, from a stream of its own, SEED + 14) against its
    plain route (the float64 log-step scan as torch ops) over 3 chained
    blocks at [1024, 2048] and [8192, 2048], both from the kernel's state
    each block (output within 2e-7 of each row's peak and >= 130 dB, the
    carried samples bit for bit), timed at both (replayed from a CUDA
    graph, the device's time, and call by call through the wrapper) beside
    the plain route and its byte bound;
23. the spectral noise blanker ([1024, 2048] audio with impulses, fft
    256), PartitionedOLS (10001 taps, block 512, C=1024: the FDL is 168
    MB) and the diversity combiner ([1024, 2, 2048], null-steering
    weights) against the CPU (SNB >= 90 dB, OLS within 1e-4, also of
    OverlapSaveFIR on the card), and their times.

24. the flagship fed from host memory (bench.py:97-114): 16 blocks of
    [1024, 40960] complex64, four distinct pinned blocks cycled, through
    DeviceFeed(prefetch=1), DeviceFeed(prefetch=0), and the step on the
    same blocks already on the card: bit-equal audio, one kernel #1
    launch a block; the same 16 blocks as pageable numpy through
    DeviceFeed(prefetch=1) bit-equal too; kernel #1 on the path's input
    against its plain version; ms a block of each run (events and host
    clock), the pinned H2D copy's ms and GB/s, the share of the copy
    hidden under compute (1 - (prefetch-1 ms - resident ms) / copy ms),
    the staging memcpy of the pageable run, the real-time factor;
24b. the ingest plane (slice 7b-1), on a capture of its own: pfb_signal's
    noise and USB / AM / FM carriers from a torch generator seeded SEED +
    8, times 0.08 (under iq24's full scale), 12 337 wideband packets of
    8160 samples (3 blocks and a part).  (a) WidebandHardware(n_streams=1,
    sample_rate=196.608e6).start_pump(block=2^25) (the native pump, its
    ring two blocks deep) fed from a thread by PacketSender with the
    port's WidebandStream.build, paced at 48 MS/s (24 on a retry if the
    pump lost any); each block read straight into DeviceFeed's next
    pinned slot (push_into -> read_samples(n, out=slot)) and stepped
    through the 4096-channel PFB receiver (kernel route): the native pump,
    no sequence error, no ring overrun, every packet parsed, no byte
    staged, one launch each of kernels #4 and #6 a block, audio and spec
    bit-equal to the same blocks stepped from card-resident copies of
    unpack_iq24 of the packets sent, the three signals out of their
    channels, both kernels within their tolerances of their plain
    versions on block 2; (b) the same packets on a full ring (four blocks
    deep), through the pinned route and through read_samples -> numpy ->
    push (a staging memcpy): bit-equal to (a), host ms a block, the
    staging a block, the slot's H2D copy and the step by events, the
    real-time factor; the unpaced native blast into one socket and
    blast_striped over two (blocks of 16 * 2 * 8160): drained MS/s,
    losses, sequence errors (reported, not gated); (c) a HiQSDR Radio
    (48 kS/s, USB) on the card and one on the CPU, each fed the same
    1442-byte packets over loopback by PacketSender at 4x real time:
    native pump, no sequence error, audio a block > 90 dB apart from
    block 2;
25. a Quisk user's Radio session (RadioConfig(sample_rate=48000,
    mode="USB", tune_hz=10000, agc=True), sim hardware, the tone at 11
    kHz, 12 blocks): the 1 kHz beat; after set_frequency(13000) with the
    tone at 14 kHz the beat again, the chain retuned in place (its
    decimators and carried state the same objects); the audio and IQ
    record taps written and read back; waterfall rows and a finite
    S-meter; audio > 90 dB against the same session on the CPU from
    block 2;
26. the wide Radio (RadioConfig(sample_rate=960000, channels=1024,
    audio_block=2048), the unfused NCO and decimators, sim hardware):
    every channel on the one [1, 40960] capture, which crosses to the card
    as one row (the host->device copies of a run_once, from the
    profiler's memcpy records: the largest one row of capture, all of
    them under two rows) and is expanded there; channel 0 USB 1 kHz
    below the tone, channels 1-7 LSB / USB at beats of 1100-1700 Hz; rows
    0-7 > 90 dB against a CPU Radio with channels=8 from block 2; the
    beat on channel 0; run_once ms (host clock), the real-time factor,
    the idle share of run_once (device_idle), graph.feed and the chain
    step by events;
27. the live TX->RX loopback session of tests/test_tx_runtime.py:124-156
    (loopback hardware, enable_tx, tx_monitor, PTT held, seeded
    voice-like mic audio) for 16 keyed blocks: the first 2 blocks' TX IQ
    >= 80 dB against the CPU Radio on the same mic input, the TxALC clip
    decisions of both on identical inputs equal (the mic as sent, and 8
    times louder, where the ALC clips), the demodulated audio against the
    mic rho > 0.7 by the reference test's lag scan, the S-meter above -40
    dB; a keyed block's ms and CUDA launches, the TX step's alone (at most
    200) and its TxALC's (at most 40);
28. the CLI (README "Quick start"): a 5 s, 192 kS/s IQ WAV holding a USB
    station through rx, its first 4 blocks of audio through tx (--interp
    4) and the capture through spectrum, each on the card and with --cpu:
    rx and tx within 1 LSB of their 16-bit samples, the spectrum peak at
    the same bin; the wall time of each command;
29. the AGC / ALC kernel (csrc/agc_scan.cu) in its three modes, TxALC,
    WcpAGC and HangAGC, against its plain versions at shapes off the paths'
    (C = 1 and 33, B = 1, 7 and 2048, from random mid-run states; the ALC
    with a row at its clip threshold and a silent row, WcpAGC with hang on
    and off): every state bit-equal, the ALC's clip decisions equal at
    every sample, the outputs bit-equal (WcpAGC's gain within 2 ulp where
    log10f and torch's log10 differ, the samples counted), one launch a
    call; a block cut in two calls at an odd sample equal to one call bit
    for bit; each mode on its path's own [1024, 2048] arguments, timed with
    its plain version and bound; then (from a stream of its own, SEED + 6)
    the kernel's edges held the same way: B one short of its register tile,
    the tile and one past it, C = 1025 (one channel past a full grid of
    32-channel blocks), rows cut 2 samples in and rows of stride B + 1 (not
    16-byte aligned); and each mode's time at C = 1, and at C = 32 on 32
    distinct rows and on 32 copies of one row, beside its [1024, 2048]
    time, the earlier design's, the byte bound and the estimate of its
    dependent chain read from the kernel's SASS;
30. the wide Radio of phase 26 with every user surface attached, at full
    width (1024 channels, 960 kS/s, playback_rate 96000 so the play path's
    x2 Interpolator runs on the card): enable_audio_out into a WAV sink,
    a TCI client (audio_stream_channels:1, audio_start:0), the K4 server,
    the ZZ pty, the web UI with a /ws client, and a RemoteRadioServer with
    an HMAC-authenticated ControlHeadClient and the sound and graph UDP
    streams; 16 blocks paced at the block clock, one retune through each
    of TCI vfo, K4 FA, ZZFA and a web UI freq command: each lands in
    freq_hz and the shared CAT state (read back over K4 and the head),
    channel 0's beat moves to 10000 - dial Hz; the played blocks (the mono
    mix through the card's Interpolator) bit-equal to a second
    Interpolator on the same blocks and > 90 dB against a CPU Radio
    (channels=8) given the same commands at the same blocks from block 2;
    the TCI RX stream equal to the mono mix, the remote sound within 1 LSB
    of 16 bits, the web UI's spectrum rows equal to the graph's, the
    remote's within its centi-dB, the graph's against the CPU's within
    1e-4 of the peak power; what the player took from its servo reached
    the sink and the WAV, no overrun; run_once ms with every surface
    (host clock) beside phase 26's, the Interpolator by events, mix_stereo
    at 1024 channels, the player's fill and underruns;
31. the keyed Radio of phase 27 from its live sources (from a stream of
    its own, SEED + 10): enable_mic of a 48 kHz voice WAV through
    AudioCapture (the loop paced by the capture's fill), keyed in turn by
    set_ptt (16 blocks), play_cq of a 44.1 kHz WAV through
    VarRateResampler (one repeat, then stop_cq), a TCI client's trx with
    its TX_AUDIO_STREAM (then tci_transmit_once), a MIDI PTT note, the
    serial key and a repeater favourite (the TX dial shifted and the
    CTCSS tone on key-down, both restored on key-up): no mic starvation;
    each keyed block's TX IQ >= 80 dB against a CPU Radio fed the same mic
    blocks and commands; kTxAlc once a keyed block and never unkeyed, and
    bit-equal to its plain version on one PTT block's ALC input; voice rho
    > 0.7 over the PTT leg; each source's ms a keyed block, kTxAlc's at
    [1, 2048] with its plain version and bound.

32. the parallel paths (slice 6) in a world of one over NCCL
    (init_world on a file store, make_mesh), at full width: the flagship
    (RxChainConfig(sample_rate=960000, channels=1024, audio_block=2048,
    agc=True, fused_frontend=True), parallel.scaling.flagship) through
    shard_over_channels (its twin at 2 channels) and make_sharded_step for
    8 blocks of seeded noise: equal to the unsharded RxChain.step on the
    same blocks (bit for bit, else within 1e-6 of the peak), one kernel #1
    launch a block, no collective call, the kernel against its plain
    version on the path's input; both steps timed in turns; timeshard_rx
    (SSB) of 1024 channels x 2^17 samples at 192 kS/s on a (chan, time) =
    (1, 1) mesh: no collective call, > 90 dB a row against the unsharded
    route (the port's NCO and FIR ops streamed in 4 blocks) and on rows 0-1
    against the float64 oracle, timed (Msps); the same in FM on an FM
    station (the discriminator's halo, the de-emphasis one-pole's
    all_gather over NCCL): one all_gather, > 60 dB on rows 0 and 1023
    against the float64 oracle from sample 512; and in AM on an AM station
    25 kHz up (the envelope difference's halo, the 0.995 one-pole's
    all_gather): one all_gather, > 80 dB on rows 0 and 1023 against the
    float64 oracle from sample 64; the time-sharded PFB step at
    K=4096, B=4096*8192 (kernel #4, MixedDemod over mode quarters) for 3
    blocks of pfb_signal: one kernel #4 launch and one all_to_all a block
    and nothing else, equal to the unsharded OversampledPFB + MixedDemod
    (within 1e-5 of the peak; spectra rtol 1e-5), kernel #4 against its
    plain version, timed in turns with the unsharded pipeline and the PFB
    receiver's kernel route, its stages split; measure_scaling (weak and
    strong) and measure_timeshard at one rank; the unsharded flagship
    step timed before init_world, with the group and after
    destroy_process_group (what the process group costs the step);
33. the rehearsal across ranks: python -m quisk_tpu_torch.parallel.
    dcn_worker as 2 processes over gloo, both on this card (NCCL refuses
    two ranks on one card; the exchanged tensors go through the host):
    the flagship job (192 kS/s, 256, AGC off, fused) at 1024 channels, 512
    a rank, stitched and held to the unsharded card chain within 1e-4 of
    the peak after the first 1024 samples, one kernel #1 launch a block on
    each rank, no collective, and kernel #1 at the job's (B, T, d) against
    its plain version on the job's input; timeshard_rx over 2 ranks in time against
    phase 32's world of one (within 1e-5 of the peak); the PFB job at the
    receiver's width (K=4096, 33 554 432 samples a block, 3 blocks) against
    the unsharded card pipeline on its last block (audio within 1e-4 of the
    peak, spectra rtol 1e-3), one kernel #4 launch, one ring message and
    one all_to_all a block on each rank; each rank's ms a step, its
    collectives and the bytes it staged through the host.
34. the five example programs (examples/torch_*.py), each through its
    ``run`` at its default size on the card, every launch counter from 0
    before it and read after it, with its wall time, its ms a block on the
    host clock where it has blocks, and its own checks: the receiver (4
    channels at 960 kS/s, unfused: no front kernel, the lookahead AGC's
    kernel once a block) against the same
    program on the CPU, its WAV rows read back (SSB, AM, CW >= 60 dB from
    block 3, NFM by RMS within 0.5 dB); the channelizer (K=256, 8 blocks
    of 262 144 samples: kernels #4 and #6 8 launches each, the stations on
    their channels) against the CPU program (audio >= 80 dB overall and on
    the three station channels), both kernels against their plain versions
    on its second block and timed there; the transceiver (loopback SSB and
    FM with CTCSS, PureSignal, the live Radio session): kTxAlc once a TX
    step and the lookahead AGC's kernel once a loopback RX step, IMD better by > 12 dB, the live session's S-meter above -40 dB
    and rho > 0.7 against the mic blocks it took, a 1 kHz tone through its
    SSB loopback at 1 kHz, kTxAlc bit-equal to its plain version on the
    SSB loopback's block-3 ALC input and timed at [1, 2048]; the wideband
    survey (K=128, 6 blocks through a paced UDP stream and the wideband
    plugin): no sequence error, the three stations on top, kernel #4 6
    launches, held to its plain version on the first block and timed
    there; station automation: the plugin's fan-out counters; then the
    zoom engaged on the card (tpu_zoom_smoke.py's check): a 192 kHz Radio,
    tones 80 Hz apart, set_zoom(64, vfo + 40040), the re-capture engaged
    on the card and its row resolving both tones within two of its bins.

Phases 15-19 draw from an RNG stream of their own (SEED + 2), phases
20-23 from another (SEED + 3) and phase 20's edges from another (SEED +
7), phases 24-28 from another (SEED + 4), phase 24b's capture from
another (SEED + 8), phase 29 from another (SEED + 5) and its edges from
another (SEED + 6), phase 31 from another (SEED + 10), phase 32's
flagship from another (SEED + 11) and its PFB input from another (SEED +
12), phase 4's lookahead AGC from another (SEED + 13) and its mixed
demodulator from another (SEED + 15), phase 22's CTCSS notch from another
(SEED + 14).  Phase 34 draws
from none: each program makes its input from its own
seeds, as a user running it gets.

Every check of the front kernel prints the launcher's tile for its shape
(O, R, P) on a line of its own.  Prints, before the last line, the card's
name and power limit and one
JSON object of kernels (one entry per kernel and path shape: the front
kernel's plain mode has one for the flagship, one for the NFM path and one
for the flagship fed through DeviceFeed, kernels #4 and #6 one for the PFB
receiver and one for it fed by the ingest plane, the lookahead AGC kernel
one for the flagship and one at [8192, 2048], the PLL kernel and the
AGC / ALC kernel one for each mode and one more for TxALC on the keyed
Radio's live sources, kernels #1 and #4 one more each for the
channel-sharded flagship and the time-sharded PFB step of phase 32, and
one for each kernel on each example program's path: #4 and #6 on the
channelizer, #4 on the survey, kTxAlc on the transceiver);
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
``--out FILE`` also writes every number measured to FILE as JSON.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
from scipy import signal as sig

from quisk_tpu_torch import _kernels
from quisk_tpu_torch.app import cli, remote, tci
from quisk_tpu_torch.app.config import RadioConfig
from quisk_tpu_torch.app.radio import Radio
from quisk_tpu_torch.hw.wideband import WidebandHardware
from quisk_tpu_torch.io import native, pump, sources, wav
from quisk_tpu_torch.io.feed import DeviceFeed
from quisk_tpu_torch.modes import Mode
from quisk_tpu_torch.ops import design
from quisk_tpu_torch.ops import fused_front as ff
from quisk_tpu_torch.ops.fused_front import (fused_tune_decimate,
                                             fused_tune_decimate_gained,
                                             fused_tune_decimate_nb,
                                             fused_tune_decimate_plain,
                                             fused_tune_decimate_reference)
from quisk_tpu_torch.ops import pfb_kernels as pk
from quisk_tpu_torch.ops import agc_scan, diversity, pll
from quisk_tpu_torch.ops.channelizer import PFBChannelizer, PFBRxPipeline
from quisk_tpu_torch.ops.agc import AGC, HangAGC, TxALC, WcpAGC, agc_delay
from quisk_tpu_torch.ops.demod import (MixedDemod, PLLFMDemod,
                                       mixed_demod, register_ext_demod)
from quisk_tpu_torch.ops.fir import OverlapSaveFIR, PartitionedOLS
from quisk_tpu_torch.ops.iir import Biquad, biquad_df1
from quisk_tpu_torch.ops.nco import tx_place
from quisk_tpu_torch.ops.noise import SpectralNoiseBlanker
from quisk_tpu_torch.ops.nr import SyncAMDemod
from quisk_tpu_torch.ops.spectrum import (SpectrumAnalyzer, ZoomSpectrum,
                                          measure_frequency)
from quisk_tpu_torch.rx import RxChain, RxChainConfig
from quisk_tpu_torch.tx import TxChain, TxChainConfig
from quisk_tpu_torch.tx.puresignal import (Predistorter, SimulatedPA,
                                           two_tone_imd_db)
from quisk_tpu_torch.oracle import dsp

FS = 960000.0
C = 1024
AUDIO_BLOCK = 2048
MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.AM), int(Mode.FM)]
MODE = [MODES[i % 4] for i in range(C)]
TUNE = [(-FS / 4 + (i + 0.5) * FS / (2 * C)) for i in range(C)]
BEAT_HZ = 1000.0
N_BLOCKS = 8
SEED = 0
DEVICE = "cuda"
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, fp32 non-tensor
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
KERNEL_TOL = 1e-4          # max |kernel - plain| relative to max |plain|
KERNEL_SNR_DB = 100.0      # kernel vs float64 reference
CPU_MATCH_DB = 90.0        # card chain vs CPU chain, non-FM rows
# The featured chain's adaptive stages (LMS weights, decision-directed SNR,
# notch peak decisions, squelch holds) feed rounding differences back, and
# cuFFT and the CPU's FFT round differently: 60 dB from block 3 on (the CPU
# parity tests hold the port to the JAX package at the same floor).  Blocks
# 0-2 carry start-up residue lifted by the AGC.
FEATURED_MATCH_DB = 60.0
FEATURED_FROM_BLOCK = 3
FM_RMS_DB = 0.5            # FM audio, card vs CPU, by RMS
# WcpAGC decides per sample (attack / hang / decay) on float32 values, so a
# rounding difference can move a state change by a sample: 40 dB on block 1.
WCP_MATCH_DB = 40.0
WCP_BLOCKS = 8
NEAR_MAX = 4               # near-threshold blanker groups tolerated a block
FS_NFM = 192000.0
# PFB receiver (bench.py:404-414): 4096 channels, 2x oversampled, 8192
# input frames a block, mode quarters USB/LSB/AM/FM, 96 kHz a channel
PFB_K = 4096
PFB_MULT = 8192
PFB_RATE = 96000.0
PFB_BLOCKS = 3
PFB_CPU_MULT = 256         # depth of the CPU comparison
PFB_USB, PFB_AM, PFB_FM = 300, 2500, 3500     # channels that get a signal
# The polyphase kernels add P (or 2P) products per output in the plain
# version's order, fused: within 1e-5 of the peak.  The demod kernel
# computes its 128-point transform as an FFT where the plain version calls
# four matmuls, and runs its one-poles from zero in each 256-frame chunk,
# the carries folded across chunks afterwards, where the plain version
# scans: non-FM positions within 1e-4 of the peak, spec within 1e-4
# relative.  FM audio
# on noise wraps at +-pi, where a rounding difference flips a sample by
# 2 pi: held by RMS within 0.1 dB; FM with a carrier is held sample by
# sample.
POLY_TOL = 1e-5
DEMOD_TOL = 1e-4
SPEC_RTOL = 1e-4
FM_NOISE_RMS_DB = 0.1
# The two routes of the receiver differ in the IDFT (cuFFT against the two
# stage products) and in the commutator's rotation: the torch-op route
# computes its angle 2 pi c (M-1)/K in float32, as the JAX package's route
# does (quisk_tpu/ops/channelizer.py:264), thousands of radians at K=4096,
# so each channel carries a constant phase error of up to half an ulp of
# that angle (2.4e-4 rad below channel 2048); the kernel route folds the
# rotation into constants made in float64.  A constant phase shows on SSB
# audio (2 Re z) and on neither envelope nor discriminator.  So: SSB
# channels together >= 70 dB, AM channels together >= 90 dB, non-FM audio
# within 1e-4 of the peak sample by sample, the carrier-bearing FM channel
# >= 80 dB, other FM by RMS.
PFB_ROUTE_TOL = 1e-4
PFB_ROUTE_DB = {"SSB": 70.0, "AM": 90.0, "FM carrier": 80.0}
PFB_SPEC_RTOL = 1e-3


def snr_db(ref, got) -> float:
    ref = ref.to(torch.complex128)
    err = got.to(torch.complex128) - ref
    return float(10 * torch.log10(torch.mean(torch.abs(ref) ** 2)
                                  / torch.mean(torch.abs(err) ** 2)))


def worst_row_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    """The worst row's SNR of ``got`` against ``ref`` [rows, n], in dB."""
    ref = ref.double()
    err = got.double() - ref
    return float((10 * torch.log10(ref.pow(2).mean(-1)
                                   / err.pow(2).mean(-1).clamp_min(1e-300))
                  ).min())


def graph_ms(fn, iters: int = 20) -> float:
    """ms a call of ``fn`` replayed from a CUDA graph of ``iters`` calls:
    the device's time without the host's cost of each launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over iters calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def noise_blocks(rng, n: int, B: int, channels: int = C
                 ) -> list[np.ndarray]:
    out = []
    for _ in range(n):
        x = np.empty((channels, B), np.complex64)
        x.real = rng.standard_normal((channels, B), dtype=np.float32)
        x.imag = rng.standard_normal((channels, B), dtype=np.float32)
        out.append(x)
    return out


def add_impulses(rng, x: np.ndarray, every: int = 7, n: int = 5,
                 amp: float = 40.0) -> None:
    """Seeded impulses on every 7th channel, as
    tests/test_pallas_fused.py:168-173 places them."""
    for c in range(0, x.shape[0], every):
        for p in rng.integers(0, x.shape[1], n):
            x[c, p] += amp * np.exp(1j * rng.uniform(0, 2 * np.pi))


def wrappers() -> tuple:
    """Every kernel wrapper with a launch counter."""
    return (fused_tune_decimate, fused_tune_decimate_gained,
            fused_tune_decimate_nb, pk.pfb_poly_oversampled,
            pk.pfb_poly_critical, pk.pfb_demod_call, pll.pll_sync_am,
            pll.pll_fm, agc_scan.tx_alc_scan, agc_scan.wcp_scan,
            agc_scan.hang_scan, agc_delay, biquad_df1, mixed_demod,
            tx_place)


def reset_launches() -> None:
    for fn in wrappers():
        fn.launches = 0


def all_launches() -> dict:
    """Each wrapper's count, by name."""
    return {fn.__name__: fn.launches for fn in wrappers()}


def launches() -> dict:
    return {"plain": fused_tune_decimate.launches,
            "gained": fused_tune_decimate_gained.launches,
            "nb": fused_tune_decimate_nb.launches}


def pfb_launches() -> dict:
    return {"poly_os": pk.pfb_poly_oversampled.launches,
            "poly_crit": pk.pfb_poly_critical.launches,
            "demod": pk.pfb_demod_call.launches}


def one_thread(fn):
    """Run fn() with torch on one CPU thread: torch's intra-op workers have
    been seen to return cos/sin ~1e-4 off for a whole chunk on some hosts."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def run_chain(chain, blocks, rows=None) -> tuple[dict, list]:
    """Step ``chain`` over numpy blocks (their first ``rows`` channels) on
    its own device; returns (state, audio per block)."""
    st = chain.init_state()
    audio = []
    for x in blocks:
        x = x if rows is None else x[:rows]
        st, a = chain.step(st, torch.as_tensor(x, device=chain.device))
        audio.append(a)
    return st, audio


def phase_environment(report: dict) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    # the host's ingest library (g++) builds beside the kernels (nvcc)
    ingest: dict = {}
    gxx = threading.Thread(target=lambda: ingest.update(
        lib=native.build(), s=time.perf_counter() - t0))
    gxx.start()
    built = _kernels.build()
    secs = time.perf_counter() - t0
    gxx.join()
    for name, info in built.items():
        for line in info["log"].splitlines():
            if ("registers" in line or "spill" in line
                    or "entry function" in line):
                print(f"  ptxas {name}: {line.strip()}")
    print(f"kernels built: {sorted(built) or 'cached'} in {secs:.2f} s; "
          f"ingest library {ingest.get('lib')} in "
          f"{ingest.get('s', 0.0):.2f} s", flush=True)
    assert ingest.get("lib") is not None, "no C++ compiler for the ingest"
    report.update(card=smi, build_s=secs, ingest_build_s=ingest["s"])
    return smi


def check_tile_choice(dev, rng) -> None:
    """The launcher's tile rule off the flagship shape: a half-band /2 with
    N=100 outputs (a tile below 256 that N does not fill), and taps too
    long for one block's shared memory, which must raise."""
    h_rev = torch.as_tensor(design.halfband(45)[::-1].astype(np.float32),
                            device=dev)
    Cs, B, T, d = 8, 200, 45, 2
    x = torch.as_tensor(noise_blocks(rng, 1, B)[0][:Cs], device=dev)
    hist = torch.as_tensor(noise_blocks(rng, 1, T - 1)[0][:Cs], device=dev)
    word = torch.as_tensor(rng.integers(0, 2 ** 32, Cs), device=dev)
    phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, Cs), device=dev)
    y = fused_tune_decimate(x, hist, word, phase0, h_rev, d)
    y_ref = fused_tune_decimate_reference(x, hist, word, phase0, h_rev, d)
    snr = snr_db(y_ref, y)
    print(f"  kernel at C={Cs}, B={B}, T={T}, d={d}: {snr:.2f} dB vs "
          f"float64", flush=True)
    assert y.shape == (Cs, B // d) and snr >= KERNEL_SNR_DB, snr
    T, B = 200001, 40
    try:
        fused_tune_decimate(x[:1, :B].contiguous(), torch.zeros(
            (1, T - 1), dtype=torch.complex64, device=dev), word[:1],
            phase0[:1], torch.ones(T, device=dev), 20)
    except ValueError as e:
        print(f"  {T} taps at d=20 refused: {e}", flush=True)
    else:
        raise AssertionError(f"{T} taps at d=20 launched")


def print_plan(label: str, mode: str, B: int, T: int, d: int, HC: int = 0,
               avg_win: int = 0) -> dict:
    """Print the front launcher's tile for one call shape on a line of its
    own: outputs a block O, outputs a thread R, phases a staging group P."""
    pl = ff.launch_plan(mode, B, T, d, HC, avg_win, device=DEVICE)
    print(f"  front launcher plan, {label} (B={B}, T={T}, d={d}, {mode}): "
          f"O={pl['O']} R={pl['R']} P={pl['P']} threads={pl['threads']} "
          f"shared memory {pl['smem_bytes']} B", flush=True)
    return pl


def plain_odd_shapes() -> list[tuple]:
    """(label, channels, block, taps, decim, words) at the ragged edges of
    the plain mode's tile, sized from the launcher's full tile; words None
    draws them at random."""
    full = ff.launch_plan("plain", 40960, 1421, 20, device=DEVICE)
    O, R = full["O"], full["R"]
    return [
        ("N = 1", 3, 2, 45, 2, None),
        ("N one more than a multiple of R", 4, 3 * (37 * R + 1), 61, 3,
         None),
        ("N one less than a block's O", 2, 4 * (O - 1), 133, 4, None),
        ("T = 1", 3, 200, 1, 2, None),
        ("T < d", 3, 500, 3, 5, None),
        ("T = nq*d, nq a multiple of R", 2, 6000, 9 * R * 20, 20, None),
        ("T = nq*d, nq not a multiple of R", 2, 315, 9 * 5, 5, None),
        ("d = 1", 2, 700, 33, 1, None),
        ("two channels, different words", 2, 640, 45, 2,
         [0, 2 ** 31 + 12345]),
    ]


def check_plain_odd_shapes(dev, rng) -> dict:
    """The plain mode at each shape of :func:`plain_odd_shapes`, random
    taps, history, phase: >= 100 dB against the float64 reference, within
    1e-4 of the peak of the plain version, the launch counter up by one."""
    worst = {"snr_db": np.inf, "rel_err": 0.0}
    for label, Cn, B, T, d, words in plain_odd_shapes():
        pl = print_plan(label, "plain", B, T, d)
        if label.startswith("N one less"):
            assert pl["O"] == B // d + 1, pl
        h_rev = torch.as_tensor((rng.standard_normal(T) / np.sqrt(T)).astype(
            np.float32), device=dev)
        x = torch.as_tensor(noise_blocks(rng, 1, B, Cn)[0], device=dev)
        hist = torch.as_tensor(noise_blocks(rng, 1, T - 1, Cn)[0], device=dev)
        word = torch.as_tensor(rng.integers(0, 2 ** 32, Cn) if words is None
                               else words, dtype=torch.int64, device=dev)
        phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, Cn), device=dev)
        n0 = fused_tune_decimate.launches
        y = fused_tune_decimate(x, hist, word, phase0, h_rev, d)
        assert fused_tune_decimate.launches == n0 + 1
        y_p = fused_tune_decimate_plain(x, hist, word, phase0, h_rev, d)
        y_r = fused_tune_decimate_reference(x, hist, word, phase0, h_rev, d)
        torch.cuda.synchronize()
        snr = snr_db(y_r, y)
        err = float((y - y_p).abs().max())
        peak = float(y_p.abs().max())
        print(f"  plain mode, {label}: C={Cn} N={B // d} T={T} d={d}: "
              f"{snr:.2f} dB vs float64, max|kernel-plain| {err:.2e} (peak "
              f"{peak:.3f})", flush=True)
        assert y.shape == (Cn, B // d) and snr >= KERNEL_SNR_DB, snr
        assert err <= KERNEL_TOL * peak, (err, peak)
        worst = {"snr_db": min(worst["snr_db"], snr),
                 "rel_err": max(worst["rel_err"], err / peak)}
    return worst


def check_plain_mode(op, blocks) -> dict:
    """Hold the plain-mode kernel to its plain version and float64
    reference over streamed [C, B] blocks at ``op``'s shape."""
    dev = op.word.device
    B, d = op.block, op.decim
    print_plan(f"C={C}", "plain", B, op.ntaps, d)
    st = op.init_state(C)
    count0 = fused_tune_decimate.launches
    max_err, snrs = 0.0, []
    for x_np in blocks:
        x = torch.as_tensor(x_np, device=dev)
        phase0, hist = st
        st, y = op(st, x)
        y_plain = fused_tune_decimate_plain(x, hist, op.word, phase0,
                                            op.h_rev, d)
        y_ref = fused_tune_decimate_reference(x, hist, op.word, phase0,
                                              op.h_rev, d)
        torch.cuda.synchronize()
        assert y.shape == (C, B // d) and bool(torch.isfinite(
            torch.view_as_real(y)).all())
        snr = snr_db(y_ref, y)
        err = float(torch.max(torch.abs(y - y_plain)))
        peak = float(torch.max(torch.abs(y_plain)))
        print(f"  kernel at C={C}, B={B}, T={op.ntaps}, d={d}: {snr:.2f} dB "
              f"vs float64, plain vs float64 {snr_db(y_ref, y_plain):.2f} "
              f"dB, max|kernel-plain| {err:.3e} (peak {peak:.3f})",
              flush=True)
        assert snr >= KERNEL_SNR_DB, f"kernel SNR {snr} dB"
        assert err <= KERNEL_TOL * peak, f"kernel vs plain {err}"
        max_err = max(max_err, err)
        snrs.append(snr)
    rose = fused_tune_decimate.launches - count0
    assert rose == len(blocks), f"launch counter rose by {rose}"
    return {"op": op, "x": x, "st": st, "max_abs_err": max_err,
            "snr_db": snrs}


def phase_kernel(report: dict, rng) -> dict:
    dev = torch.device(DEVICE)
    check_tile_choice(dev, rng)
    # a stream of its own, so that the paths' inputs stay as they were
    odd = check_plain_odd_shapes(dev, np.random.default_rng(SEED + 1))
    op = RxChain.create(flagship_config(), tune_hz=TUNE, mode=MODE,
                        device=dev).front
    assert (op.block, op.ntaps, op.decim) == (40960, 1421, 20)
    kern = check_plain_mode(op, noise_blocks(rng, 2, op.block))
    report["kernel_check"] = {"snr_db": kern["snr_db"],
                              "max_abs_err": kern["max_abs_err"],
                              "odd_shapes": odd}
    return kern


def flagship_config() -> RxChainConfig:
    return RxChainConfig(sample_rate=FS, channels=C, audio_block=AUDIO_BLOCK,
                         agc=True, fused_frontend=True)


def phase_main_path(report: dict, rng):
    dev = torch.device(DEVICE)
    chain = RxChain.create(flagship_config(), tune_hz=TUNE, mode=MODE,
                           device=dev)
    assert chain.front is not None and chain.front.decim == 20
    assert not chain.stages and chain.device.type == dev.type
    B = chain.block_in
    blocks = noise_blocks(rng, N_BLOCKS, B)
    n = np.arange(N_BLOCKS * B, dtype=np.float64)
    carrier = np.exp(2j * np.pi * (TUNE[0] + BEAT_HZ) * n / FS)
    for i, x in enumerate(blocks):
        x[0] += carrier[i * B:(i + 1) * B].astype(np.complex64)

    reset_launches()
    st, audio = run_chain(chain, blocks)
    torch.cuda.synchronize()
    n = launches()
    print(f"  main path: {N_BLOCKS} blocks, front launches {n}, mixed demod "
          f"launches {mixed_demod.launches}, lookahead AGC launches "
          f"{agc_delay.launches}", flush=True)
    assert n == {"plain": N_BLOCKS, "gained": 0, "nb": 0}, n
    assert mixed_demod.launches == N_BLOCKS, mixed_demod.launches
    assert agc_delay.launches == N_BLOCKS, agc_delay.launches
    for a in audio:
        assert a.shape == (C, AUDIO_BLOCK) and a.dtype == torch.float32
        assert bool(torch.isfinite(a).all())

    a0 = torch.cat([a[0] for a in audio[2:]]).cpu().numpy().astype(
        np.float64)
    spec = np.abs(np.fft.rfft(a0 * np.hanning(a0.size)))
    freqs = np.fft.rfftfreq(a0.size, 1.0 / chain.fs_audio)
    f_peak = float(freqs[np.argmax(spec)])
    contrast = float(20 * np.log10(spec.max() / np.median(spec)))
    print(f"  channel 0 (USB) beat note at {f_peak:.1f} Hz, "
          f"{contrast:.1f} dB over the median bin", flush=True)
    assert abs(f_peak - BEAT_HZ) <= 30.0, f_peak
    assert contrast > 20.0, contrast

    # the same chain on the CPU for channels 0-7 (channels are independent)
    cpu_cfg = RxChainConfig(sample_rate=FS, channels=8,
                            audio_block=AUDIO_BLOCK, agc=True,
                            fused_frontend=True)
    cpu = RxChain.create(cpu_cfg, tune_hz=TUNE[:8], mode=MODE[:8],
                         device="cpu")
    _, cpu_out = one_thread(lambda: run_chain(cpu, blocks[:4], rows=8))
    worst = []
    for i, ca in enumerate(cpu_out):
        if i < 2:
            continue               # AGC lookahead: first blocks near silent
        ga = audio[i][:8].cpu().to(torch.float64)
        ca = ca.to(torch.float64)
        for r in range(8):
            s = snr_db(ca[r], ga[r])
            if MODE[r] == int(Mode.FM) and s <= CPU_MATCH_DB:
                db = 20 * np.log10(float(ga[r].pow(2).mean().sqrt()
                                         / ca[r].pow(2).mean().sqrt()))
                assert abs(db) < 0.1, (i, r, s, db)
            else:
                assert s > CPU_MATCH_DB, (i, r, s)
            worst.append(s)
    print(f"  card vs CPU chain, channels 0-7, blocks 2-3: min "
          f"{min(worst):.1f} dB", flush=True)
    report["main_path"] = {"blocks": N_BLOCKS, "launches": n,
                           "agc_delay_launches": agc_delay.launches,
                           "mixed_demod_launches": mixed_demod.launches,
                           "beat_hz": f_peak, "beat_contrast_db": contrast,
                           "cpu_match_min_db": min(worst)}
    return chain, blocks, n["plain"]


def time_plain_kernel(kern: dict) -> dict:
    """Device time of the plain-mode kernel on the tensors of
    :func:`check_plain_mode`, of its plain version and of a one-call
    PyTorch yardstick, beside the bound for this shape."""
    op, xk, (phase0, hist) = kern["op"], kern["x"], kern["st"]
    dev = xk.device
    T, d = op.ntaps, op.decim
    N = op.block // d
    args = (xk, hist, op.word, phase0, op.h_rev, d)
    k_ms = cuda_ms(lambda: fused_tune_decimate(*args), 20)
    p_ms = cuda_ms(lambda: fused_tune_decimate_plain(*args), 5)

    # yardstick, never called by the port: torch mix + cuDNN strided
    # conv1d in full fp32 (TF32 off for the call)
    w = op.h_rev.view(1, 1, T)             # conv1d correlates: h reversed

    def library():
        ext = torch.cat([hist, xk], dim=-1)
        nn = torch.arange(ext.shape[-1], device=dev)
        ph = (phase0[:, None] + op.word[:, None] * nn) & 0xFFFFFFFF
        ph = ph - (ph >= (1 << 31)).long() * (1 << 32)
        ang = ph.float() * float(np.float32(2 * np.pi / 2 ** 32))
        tuned = ext * torch.polar(torch.ones_like(ang), -ang)
        iq = torch.view_as_real(tuned).permute(0, 2, 1).reshape(2 * C, 1, -1)
        return torch.nn.functional.conv1d(iq, w, stride=d)

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_ms = cuda_ms(library, 5)
        lib_y = library().view(C, 2, N)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    lib_err = float(torch.max(torch.abs(
        torch.complex(lib_y[:, 0], lib_y[:, 1])
        - fused_tune_decimate_plain(*args))))

    nbytes = (C * (op.block + T - 1) * 8 + C * N * 8 + T * 4 + 2 * C * 8)
    flops = C * N * T * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  fused_tune_decimate at B={op.block}, T={T}, d={d}: "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"library {lib_ms:.4f} ms (max|lib-plain| {lib_err:.2e}), "
          f"bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_timing(report: dict, smi: str, chain, blocks, kern: dict):
    dev = torch.device(DEVICE)
    B = chain.block_in
    xs = [torch.as_tensor(blocks[i], device=dev) for i in range(2)]
    state = {"st": chain.init_state(), "i": 0}

    def step():
        state["st"], _ = chain.step(state["st"], xs[state["i"] % 2])
        state["i"] += 1

    ms_block = cuda_ms(step, iters=20, warmup=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    budget_ms = B / FS * 1e3
    msps = C * B / (ms_block * 1e-3) / 1e6

    # per-stage device times on this block's real intermediates
    st = chain.init_state()
    x = xs[0]
    _, y_front = chain.front(st["front"], x)
    _, y_bp = chain.bp(st["bp"], y_front)
    _, aud = chain.demod(st["demod"], y_bp)
    stages = {
        "front": cuda_ms(lambda: chain.front(st["front"], x), 10),
        "channel_filter": cuda_ms(lambda: chain.bp(st["bp"], y_front), 10),
        "demod": cuda_ms(lambda: chain.demod(st["demod"], y_bp), 10),
        "agc": cuda_ms(lambda: chain.agc(st["agc"], aud), 10),
    }

    print(f"timing [{smi}]:", flush=True)
    print(f"  flagship step {ms_block:.4f} ms/block (device events), "
          f"{host_ms:.4f} ms/block (host clock), {msps:.1f} Msps in, "
          f"real-time factor {budget_ms / ms_block:.2f}x of "
          f"{budget_ms:.2f} ms", flush=True)
    print("  stages (ms): " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in stages.items()))
    idle = device_idle("flagship", chain, blocks, ms_block)
    times = time_plain_kernel(kern)
    report["timing"] = {"ms_per_block": ms_block,
                        "host_ms_per_block": host_ms, "msps": msps,
                        "budget_ms": budget_ms,
                        "realtime_factor": budget_ms / ms_block,
                        "stages_ms": stages, "idle": idle}
    return times


AGC_DELAY_SHAPES = ((1024, AUDIO_BLOCK), (8192, AUDIO_BLOCK))


def agc_delay_bound(rows: int, B: int, W: int) -> dict:
    """The lookahead AGC's block: the audio and the delay line read and
    the output and the new delay line written (4 B a sample), the log gain
    read and written; operations ~15 a sample (|x|, the two window-max
    passes and their max, clamp, divide, log, min, the fma of u, the
    prefix min, two fma and a min for lg, exp, the product)."""
    nbytes = rows * (2 * B + 2 * W + 2) * 4
    return bound(nbytes, rows * B * 15)


def phase_agc_delay(report: dict, smi: str) -> dict:
    """csrc/agc_delay.cu against AGC.plain on the card at the flagship's
    [1024, 2048] and [8192, 2048] over 3 chained blocks, and timed there
    beside the plain route and its byte bound."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 13)
    op = AGC.create(48000.0, device=dev)
    scales = torch.tensor([1e-3, 0.1, 1.0, 30.0], device=dev)
    print(f"the lookahead AGC kernel [{smi}]:", flush=True)
    out = {}
    for rows, B in AGC_DELAY_SHAPES:
        sk = sp = op.init_state(rows)
        worst = {"out": 0.0, "lg": 0.0, "abs": 0.0}
        n0 = agc_delay.launches
        for _ in range(3):
            a = torch.as_tensor(rng.standard_normal((rows, B),
                                                    dtype=np.float32),
                                device=dev) * scales.repeat(rows // 4)[:, None]
            (dk, lk), yk = op(sk, a)
            (dp, lp), yp = op.plain(sp, a)
            assert torch.equal(dk, dp)
            peak = yp.abs().amax(-1, keepdim=True)
            worst["out"] = max(worst["out"],
                               float(((yk - yp).abs() / peak).max()))
            worst["lg"] = max(worst["lg"], float((lk - lp).abs().max()))
            worst["abs"] = max(worst["abs"], float((yk - yp).abs().max()))
            sk, sp = (dk, lk), (dp, lp)
        torch.cuda.synchronize()
        assert agc_delay.launches == n0 + 3
        assert worst["out"] <= 2e-5 and worst["lg"] <= 5e-6, worst
        t = {"ms": cuda_ms(lambda: op(sk, a), 20),
             "plain_ms": cuda_ms(lambda: op.plain(sp, a), 5),
             **agc_delay_bound(rows, B, op.lookahead), "library_ms": None}
        print(f"  agc_delay at [{rows}, {B}]: output within "
              f"{worst['out']:.3e} of the row peak, log gain within "
              f"{worst['lg']:.3e} of the plain route over 3 blocks; "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"none, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['mbytes']:.1f} MB, {t['gflop']:.3f} GFLOP)", flush=True)
        out[f"{rows}x{B}"] = {"max_rel_err": worst["out"],
                              "max_lg_err": worst["lg"],
                              "max_abs_err": worst["abs"], **t}
    report["agc_delay"] = out
    return out


MIXED_SHAPES = ((1024, AUDIO_BLOCK), (8192, AUDIO_BLOCK))


def mixed_demod_bound(rows: int, B: int, ext_rows: int) -> dict:
    """The mixed demodulator's block: the complex samples read (8 B), the
    audio written (4 B) and, on EXT rows, the EXT op's audio read (4 B), a
    sample; the state read and written (5 floats a row each way);
    operations ~70 a sample (two hypotf, an atan2f, the discriminator's
    products, the four recurrence fma, the gains and the selection)."""
    return bound(rows * (12 * B + 40) + ext_rows * 4 * B, rows * B * 70)


def mixed_signal(rng, rows: int, B: int, blk: int, dev) -> torch.Tensor:
    """Block ``blk`` of a carrier a row at its own offset, FM-swung 2 rad
    at 500 Hz and AM-swung 50% at 300 Hz, under noise 34 dB down (the
    discriminator away from its gate and from +-pi)."""
    t = torch.arange(blk * B, (blk + 1) * B, device=dev,
                     dtype=torch.float64) / 48000.0
    f = torch.as_tensor(rng.uniform(-3000.0, 3000.0, (rows, 1)), device=dev)
    ph = 2 * np.pi * f * t + 2.0 * torch.sin(2 * np.pi * 500.0 * t)
    amp = 0.5 * (1.0 + 0.5 * torch.sin(2 * np.pi * 300.0 * t))
    noise = torch.as_tensor(rng.standard_normal((2, rows, B),
                                                dtype=np.float32), device=dev)
    return (torch.polar(amp.expand(rows, B), ph).to(torch.complex64)
            + 0.01 * torch.complex(noise[0], noise[1]))


def phase_mixed_demod(report: dict, smi: str) -> dict:
    """csrc/mixed_demod.cu against MixedDemod.plain on the card over 3
    chained blocks, each route carrying its own state: the flagship's modes
    (cycling USB / LSB / AM / FM) and the PLL-NFM plan's (every row EXT
    through the PLL, the CTCSS notch at 100 Hz) at [1024, 2048] and [8192,
    2048], and the sync-AM flagship's (cycling USB / LSB / EXT / FM, EXT
    through sync AM) at [1024, 2048]; AM and FM rows >= 100 dB a row, the
    other rows and the carried samples bit for bit; one launch a call.
    Then each timed from a CUDA graph and call by call beside its byte
    bound and the plain route's families (where rows are EXT, with their
    selection: what the kernel replaces)."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 15)
    register_pll_demods()
    print(f"the mixed demodulator's kernel [{smi}]:", flush=True)
    cases = []
    for rows, B in MIXED_SHAPES:
        cases += [("flagship", rows, B, [MODES[i % 4] for i in range(rows)],
                   {}),
                  ("PLL-NFM", rows, B, int(Mode.EXT),
                   dict(ext_demod="pll_fm", ctcss_hz=100.0))]
    cases.append(("sync-AM", *MIXED_SHAPES[0],
                  [SYNC_MODES[i % 4] for i in range(MIXED_SHAPES[0][0])],
                  dict(ext_demod="sync_am")))
    out = {}
    for label, rows, B, modes, ext in cases:
        op = MixedDemod.create(modes, 48000.0, rows, device=dev, **ext)
        m = op.mode[:, None]
        fam = (m == int(Mode.AM)) | (m == int(Mode.FM))
        sk = sp = op.init_state(rows)
        worst = {"db": np.inf, "rel": 0.0, "abs": 0.0}
        n0 = mixed_demod.launches
        for blk in range(3):
            x = mixed_signal(rng, rows, B, blk, dev)
            (sk, yk), (sp, yp) = op(sk, x), op.plain(sp, x)
            assert torch.equal(torch.where(fam, 0.0, yk),
                               torch.where(fam, 0.0, yp))
            assert torch.equal(sk[1][0], sp[1][0])
            rows_f = fam[:, 0].nonzero().flatten()
            if len(rows_f):
                worst["db"] = min(worst["db"], worst_row_db(yp[rows_f],
                                                            yk[rows_f]))
            peak = yp.abs().amax(-1, keepdim=True)
            worst["rel"] = max(worst["rel"],
                               float(((yk - yp).abs() / peak).max()))
            worst["abs"] = max(worst["abs"], float((yk - yp).abs().max()))
        torch.cuda.synchronize()
        assert mixed_demod.launches == n0 + 3
        assert worst["db"] >= 100.0, worst
        (am, fm, ext_st) = sk
        a_ext = op.ext(ext_st, x)[1] if op.ext is not None else None
        bare = dataclasses.replace(op, ext=None)
        is_ext = m == int(Mode.EXT)

        def plain_families():
            a = bare.plain(sp, x)[1]
            return a if a_ext is None else torch.where(is_ext, a_ext, a)

        t = {"ms": graph_ms(lambda: mixed_demod(op, am, fm, x, a_ext)),
             "call_ms": cuda_ms(lambda: mixed_demod(op, am, fm, x, a_ext),
                                20),
             "plain_ms": cuda_ms(plain_families, 5),
             **mixed_demod_bound(rows, B, int(is_ext.sum())),
             "library_ms": None}
        db = "n/a (no AM or FM row)" if worst["db"] == np.inf else \
            f"{worst['db']:.1f} dB"
        print(f"  mixed_demod, {label} modes at [{rows}, {B}]: AM / FM rows "
              f"{db} from the plain route over 3 blocks, the rest bit for "
              f"bit; {t['ms']:.4f} ms (from a CUDA graph; "
              f"{t['call_ms']:.4f} call by call), plain "
              f"{t['plain_ms']:.4f} ms, library none, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['mbytes']:.1f} MB, {t['gflop']:.3f} GFLOP)", flush=True)
        out[f"{label} {rows}x{B}"] = {"snr_db": worst["db"],
                                      "max_rel_err": worst["rel"],
                                      "max_abs_err": worst["abs"], **t}
    report["mixed_demod"] = out
    return out


# ------------------------------------------------ gained / NB-detect kernels
def check_gain_modes(dev, rng, op, channels: int, nblk: int) -> dict:
    """Hold the gained and NB-detect kernels to their plain versions and
    float64 references over ``nblk`` streamed blocks with impulses."""
    B, d = op.block, op.decim
    GH = op.gain_hist_groups
    HC = (op.rc.shape[0] - 1) // 2
    tail = -(-15 // d)           # outputs that the last 15 samples reach
    imp = torch.arange(0, channels, 7, device=dev)
    st = op.init_state(channels)
    g = torch.ones((channels, GH), device=dev)
    on = torch.ones((channels, 1), device=dev)
    lim = torch.tensor(4.0, device=dev)
    n0 = launches()
    out = {"nb_err": 0.0, "gained_err": 0.0, "near": 0, "nb_snr": [],
           "gained_snr": []}
    for blk in range(nblk):
        x_np = noise_blocks(rng, 1, B, channels)[0]
        add_impulses(rng, x_np)
        if blk == 1:             # a pulse within HC groups of the end
            x_np[0, B - 16 * min(5, HC - 1) + 2] += 60.0
        x = torch.as_tensor(x_np, device=dev)
        phase0, hist = st
        args = (x, hist, op.word, phase0, op.h_rev, d)
        nb_args = (g, on, lim, op.rc, op.avg_win)
        st_next, y, go = op.call_nb(st, x, g, on, lim)
        gext = torch.cat([g, go], dim=-1)
        _, y2 = op(st, x, gain16=gext)
        y_p, go_p = ff.fused_tune_decimate_nb_plain(*args, *nb_args)
        y_r, go_r, near = ff.fused_tune_decimate_nb_reference(*args,
                                                              *nb_args)
        y2_p = ff.fused_tune_decimate_gained_plain(*args, gext)
        y2_r = ff.fused_tune_decimate_gained_reference(*args, gext)
        torch.cuda.synchronize()
        assert go.shape == (channels, B // 16) and y.shape == y_p.shape
        differ, n_near = ff.gains_differ(go, go_p, near, HC)
        rows = ~near.any(-1)     # channels free of near-threshold groups
        ref_err = float((go[rows].double() - go_r[rows]).abs().max())
        peak = float(y_p.abs().max())
        nb_err = float((y[rows] - y_p[rows]).abs().max())
        g_err = float((y2 - y2_p).abs().max())
        nb_snr, g_snr = snr_db(y_r[rows], y[rows]), snr_db(y2_r, y2)
        blanked = int((go < 1).sum())
        print(f"  C={channels} B={B} d={d} block {blk}: NB-detect "
              f"{nb_snr:.2f} dB vs float64, max|kernel-plain| {nb_err:.3e}; "
              f"gained {g_snr:.2f} dB, {g_err:.3e} (peak {peak:.3f}); "
              f"gain groups differing from plain {differ}, near-threshold "
              f"{n_near}, vs float64 {ref_err:.1e}, blanked {blanked}",
              flush=True)
        assert differ == 0 and n_near <= NEAR_MAX, (differ, n_near)
        assert ref_err < 1e-6, ref_err
        assert nb_snr >= KERNEL_SNR_DB and g_snr >= KERNEL_SNR_DB
        assert nb_err <= KERNEL_TOL * peak and g_err <= KERNEL_TOL * peak
        assert bool((go[imp].min(dim=-1).values < 1).all())
        # same gain in, same output out, but for the group past the end
        assert torch.equal(y[:, :-tail], y2[:, :-tail])
        out["nb_err"] = max(out["nb_err"], nb_err)
        out["gained_err"] = max(out["gained_err"], g_err)
        out["near"] += n_near
        out["nb_snr"].append(nb_snr)
        out["gained_snr"].append(g_snr)
        last = (args, nb_args, gext)
        st, g = st_next, go[:, -GH:].contiguous()    # the carried gain
    args, nb_args, gext = last
    y_off, go_off = fused_tune_decimate_nb(*args,
                                           torch.ones_like(nb_args[0]),
                                           torch.zeros_like(on),
                                           *nb_args[2:])
    assert bool((go_off == 1).all()), "stage off must give gain 1"
    assert torch.equal(y_off, fused_tune_decimate(*args))
    rose = {k: v - n0[k] for k, v in launches().items()}
    assert rose == {"plain": 1, "gained": nblk, "nb": nblk + 1}, rose
    out.update(op=op, args=args, nb_args=nb_args, gext=gext)
    return out


# (channels, block, taps, decim, kwidth, avg_win): tile 32 with one tile;
# several tiles with a partial last one at decimations that do not divide
# 16; a widening wider than the tile's groups; HC = 1; W4 = 1
ODD_SHAPES = ((3, 32, 9, 2, 97, 16), (5, 4800, 133, 5, 225, 64),
              (4, 1200, 61, 3, 161, 32), (2, 6000, 301, 20, 961, 64),
              (7, 640, 45, 2, 33, 64))


def check_odd_shapes(dev, rng) -> None:
    """One block of each gain mode at shapes off the main path's, with a
    random history, carried gain and per-channel toggle: kernel against
    plain version under the same rules as :func:`check_gain_modes`."""
    for Cn, B, T, d, kwidth, avg_win in ODD_SHAPES:
        op = ff.FusedTuneDecimate.create(
            rng.standard_normal(T) / np.sqrt(T), [3000.0 * i for i in
                                                  range(Cn)],
            384000.0, B, d, Cn, nb_detect={"avg_win": avg_win,
                                           "kwidth": kwidth}, device=dev)
        HC = (op.rc.shape[0] - 1) // 2
        x_np = noise_blocks(rng, 1, B, Cn)[0]
        add_impulses(rng, x_np, every=2, n=3)
        x = torch.as_tensor(x_np, device=dev)
        hist = torch.as_tensor(noise_blocks(rng, 1, T - 1, Cn)[0],
                               device=dev)
        phase0 = torch.as_tensor(rng.integers(0, 2 ** 32, Cn), device=dev)
        g = torch.as_tensor(rng.uniform(0, 1, (Cn, op.gain_hist_groups)
                                        ).astype(np.float32), device=dev)
        on = torch.as_tensor((rng.uniform(0, 1, (Cn, 1)) < 0.7).astype(
            np.float32), device=dev)
        args = (x, hist, op.word, phase0, op.h_rev, d)
        nb_args = (g, on, torch.tensor(2.5, device=dev), op.rc, avg_win)
        y, go = fused_tune_decimate_nb(*args, *nb_args)
        gext = torch.cat([g, go], dim=-1)
        y2 = fused_tune_decimate_gained(*args, gext)
        y_p, go_p = ff.fused_tune_decimate_nb_plain(*args, *nb_args)
        _, _, near = ff.fused_tune_decimate_nb_reference(*args, *nb_args)
        y2_p = ff.fused_tune_decimate_gained_plain(*args, gext)
        torch.cuda.synchronize()
        differ, n_near = ff.gains_differ(go, go_p, near, HC)
        rows = ~near.any(-1)
        peak = float(y_p.abs().max())
        nb_err = float((y[rows] - y_p[rows]).abs().max())
        g_err = float((y2 - y2_p).abs().max())
        tail = -(-15 // d)
        print(f"  C={Cn} B={B} T={T} d={d} kwidth={kwidth} avg_win="
              f"{avg_win}: max|kernel-plain| NB-detect {nb_err:.2e}, gained "
              f"{g_err:.2e} (peak {peak:.2f}), gain groups differing "
              f"{differ}, near-threshold {n_near}, blanked "
              f"{int((go < 1).sum())} of {go.numel()}", flush=True)
        assert differ == 0 and n_near <= NEAR_MAX, (differ, n_near)
        assert nb_err <= KERNEL_TOL * peak and g_err <= KERNEL_TOL * peak
        assert torch.equal(y[:, :-tail], y2[:, :-tail])
        assert bool((go[on[:, 0] == 0] == 1).all())


def phase_gain_kernels(report: dict, rng) -> dict:
    dev = torch.device(DEVICE)
    check_odd_shapes(dev, rng)
    fs = 384000.0
    small = ff.FusedTuneDecimate.create(
        design.halfband(45), [1000.0 * i for i in range(8)], fs, 208, 2, 8,
        nb_detect={"avg_win": 64, "kwidth": 97}, device=dev)
    check_gain_modes(dev, rng, small, 8, 3)
    op = RxChain.create(featured_config(), tune_hz=TUNE, mode=MODE,
                        device=dev).front
    assert (op.block, op.ntaps, op.decim) == (40960, 1421, 20)
    assert op.nb_detect == {"avg_win": 64, "kwidth": 961}
    HC = (op.rc.shape[0] - 1) // 2
    for mode in ("gained", "nb"):
        print_plan(f"featured C={C}", mode, op.block, op.ntaps, op.decim, HC,
                   op.avg_win)
    res = check_gain_modes(dev, rng, op, C, 3)
    report["gain_kernel_check"] = {
        k: res[k] for k in ("nb_err", "gained_err", "near", "nb_snr",
                            "gained_snr")}
    return res


# ------------------------------------------------------------ featured path
TONES_HZ = (500.0, 900.0, 1300.0, 1900.0, 2500.0)
TONE_ROWS = (1, 2, 4, 5, 6)      # the non-FM channels of 0-7 but channel 0
FM_ROW = 3                       # an FM channel of 0-7 that gets a station


def featured_config() -> RxChainConfig:
    return dataclasses.replace(flagship_config(), noise_blanker=2,
                               auto_notch=True, nr=True, anf=True,
                               squelch=True, fm_squelch=True)


def featured_blocks(rng, n_blocks: int, B: int) -> list[np.ndarray]:
    """Seeded noise; the carrier 1 kHz above channel 0's dial; five tones
    in the passband of channels 1, 2, 4, 5, 6 (more than the auto-notch
    takes, so their voice squelch opens; the AM channels get a carrier);
    a carrier on channel 3 frequency-modulated by the same five tones, so
    that an FM row is open and compared; impulses on every 7th channel."""
    blocks = noise_blocks(rng, n_blocks, B)
    t = np.arange(n_blocks * B, dtype=np.float64) / FS
    sig = {0: np.exp(2j * np.pi * (TUNE[0] + BEAT_HZ) * t)}
    for r in TONE_ROWS:
        sign = -1.0 if MODE[r] == int(Mode.LSB) else 1.0
        s = sum(0.3 * np.exp(2j * np.pi * (TUNE[r] + sign * f) * t + 1j * k)
                for k, f in enumerate(TONES_HZ))
        if MODE[r] == int(Mode.AM):
            s = s + np.exp(2j * np.pi * TUNE[r] * t)
        sig[r] = s
    dev_hz = 600.0               # per tone: 3 kHz peak, inside the channel
    sig[FM_ROW] = np.exp(2j * np.pi * TUNE[FM_ROW] * t + 1j * sum(
        dev_hz / f * np.sin(2 * np.pi * f * t + k)
        for k, f in enumerate(TONES_HZ)))
    for i, x in enumerate(blocks):
        for r, s in sig.items():
            x[r] += s[i * B:(i + 1) * B].astype(np.complex64)
        add_impulses(rng, x)
    return blocks


def compare_with_cpu(card, cpu, modes, from_block: int, floor_db: float,
                     label: str, strict_rows=()) -> dict:
    """Card audio [>= 8, n] per block against the CPU chain's [8, n].
    A row silent on both sides (a closed squelch) is equal; an open row
    must clear ``floor_db`` sample by sample, an FM row not in
    ``strict_rows`` else by RMS (noise through a discriminator wraps at
    +-pi, where a rounding difference flips a sample).  An FM row open on
    one side only is counted, not failed: while the histories fill, its
    discriminator turns residue into garbage that the voice squelch may
    take for speech on one side."""
    worst, compared, fm_compared, split = {}, 0, 0, set()
    for i in range(from_block, len(cpu)):
        ga = card[i][:8].cpu().to(torch.float64)
        ca = cpu[i].to(torch.float64)
        for r in range(8):
            pg, pc = float(ga[r].pow(2).mean()), float(ca[r].pow(2).mean())
            fm = modes[r] == int(Mode.FM)
            if r in split:
                continue
            if pg == 0.0 or pc == 0.0:
                if fm and pg != pc:
                    split.add(r)
                else:
                    assert pg == pc == 0.0, (label, i, r, pg, pc)
                continue
            s = snr_db(ca[r], ga[r])
            if fm and r not in strict_rows and s <= floor_db:
                db = 10 * np.log10(pg / pc)
                assert abs(db) < FM_RMS_DB, (label, i, r, s, db)
            else:
                assert s > floor_db, (label, i, r, s)
                worst.setdefault(r, []).append(s)
            compared += 1
            fm_compared += fm
    row_min = {r: min(v) for r, v in sorted(worst.items())}
    by_sample = sum(len(v) for v in worst.values())
    print(f"  {label}: card vs CPU chain, channels 0-7, blocks "
          f"{from_block}-{len(cpu) - 1}: {compared} open rows compared "
          f"({fm_compared} of them FM), {by_sample} sample by sample, min "
          "dB per channel " + ", ".join(f"{r}: {v:.1f}" for r, v in
                                        row_min.items())
          + f"; FM rows open on one side only {sorted(split)}", flush=True)
    return {"compared": compared, "fm_compared": fm_compared,
            "sample_by_sample": by_sample, "row_min_db": row_min,
            "min_db": min(row_min.values()) if row_min else None,
            "fm_split": sorted(split)}


def phase_featured(report: dict, rng):
    dev = torch.device(DEVICE)
    chain = RxChain.create(featured_config(), tune_hz=TUNE, mode=MODE,
                           device=dev)
    assert chain._nb_fused and not chain.stages
    assert sorted(chain.ons) == ["agc", "anf", "fm_sq", "nb", "notch", "nr",
                                 "squelch"]
    blocks = featured_blocks(rng, N_BLOCKS, chain.block_in)

    reset_launches()
    st, audio = run_chain(chain, blocks)
    torch.cuda.synchronize()
    n = launches()
    print(f"  featured path: {N_BLOCKS} blocks, front launches {n}",
          flush=True)
    assert n == {"plain": 0, "gained": 0, "nb": N_BLOCKS}, n
    for a in audio:
        assert a.shape == (C, AUDIO_BLOCK) and a.dtype == torch.float32
        assert bool(torch.isfinite(a).all())
    open_rows = int((audio[-1].pow(2).mean(-1) > 0).sum())
    assert st["nbg"].shape == (C, chain.front.gain_hist_groups)

    # the blanker blanks the impulse channels, and nothing with the stage off
    x0 = torch.as_tensor(blocks[0], device=dev)
    st0 = chain.init_state()
    imp = torch.arange(0, C, 7, device=dev)
    _, _, gout = chain.front.call_nb(st0["front"], x0, st0["nbg"],
                                     chain.ons["nb"], chain.nb.limit)
    assert bool((gout[imp].min(dim=-1).values < 1).all())
    off = chain.set_stage("nb", False)
    _, _, gout_off = off.front.call_nb(st0["front"], x0, st0["nbg"],
                                       off.ons["nb"], off.nb.limit)
    assert bool((gout_off == 1).all())
    blanked = float((gout < 1).float().mean())

    cpu = RxChain.create(dataclasses.replace(featured_config(), channels=8),
                         tune_hz=TUNE[:8], mode=MODE[:8], device="cpu")
    _, cpu_audio = one_thread(lambda: run_chain(cpu, blocks, rows=8))
    match = compare_with_cpu(audio, cpu_audio, MODE, FEATURED_FROM_BLOCK,
                             FEATURED_MATCH_DB, "featured")
    # the comparison must have had open channels to compare, an FM one
    # among them, and at most one of the two FM rows may drop out of it
    assert match["compared"] >= 3 * (N_BLOCKS - FEATURED_FROM_BLOCK), match
    assert match["fm_compared"] >= 1 and len(match["fm_split"]) <= 1, match
    print(f"  featured: {open_rows} of {C} channels open in the last block, "
          f"{100 * blanked:.2f}% of block 0's gain groups blanked",
          flush=True)

    # the verification route for the gained mode: NoiseBlanker.detect as
    # torch ops, the gain applied by the kernel's gained mode
    host = chain.with_host_nb_detect()
    assert host._nb_gained
    reset_launches()
    _, host_audio = run_chain(host, blocks)
    torch.cuda.synchronize()
    nh = launches()
    assert nh == {"plain": 0, "gained": N_BLOCKS, "nb": 0}, nh
    # equal but for the repeated group past each block's end and for
    # group sums taken in another order: held on the open channels of
    # every block from the first compared one on
    shares = []
    for i in range(FEATURED_FROM_BLOCK, N_BLOCKS):
        a, b = audio[i].double(), host_audio[i].double()
        both = (a.pow(2).mean(-1) > 0) & (b.pow(2).mean(-1) > 0)
        err = (a[both] - b[both]).pow(2).mean(-1)
        s = 10 * torch.log10(a[both].pow(2).mean(-1) / (err + 1e-30))
        share = float((s > FEATURED_MATCH_DB).float().mean())
        print(f"  host-detect route, block {i}: {int(both.sum())} open "
              f"channels, {100 * share:.1f}% within "
              f"{FEATURED_MATCH_DB:.0f} dB of the NB-detect route, median "
              f"{float(s.median()):.1f} dB", flush=True)
        assert int(both.sum()) >= 8 and share >= 0.95, (i, int(both.sum()),
                                                        share)
        shares.append(share)
    print(f"  host-detect route: {N_BLOCKS} blocks, front launches {nh}",
          flush=True)
    report["featured_path"] = {"blocks": N_BLOCKS, "launches": n,
                               "cpu_match": match, "open_rows": open_rows,
                               "host_route_launches": nh,
                               "host_route_shares": shares}
    return chain, blocks, n["nb"], nh["gained"]


# ----------------------------------------------------------------- NFM path
def nfm_config() -> RxChainConfig:
    return RxChainConfig(sample_rate=FS_NFM, channels=C,
                         audio_block=AUDIO_BLOCK, agc=True, fm_squelch=True,
                         fused_frontend=True)


NFM_CARRIER_ROWS = (0, 4)        # channels of 0-7 with an FM carrier


def phase_nfm(report: dict, smi: str, rng):
    dev = torch.device(DEVICE)
    tune = [(-FS_NFM / 4 + (i + 0.5) * FS_NFM / (2 * C)) for i in range(C)]
    chain = RxChain.create(nfm_config(), tune_hz=tune, mode=int(Mode.FM),
                           device=dev)
    assert chain.front.decim == 4 and chain.front.nb_detect is None
    assert not chain.stages and chain.block_in == 4 * AUDIO_BLOCK
    B, nblk = chain.block_in, 4
    # full-level noise on even channels (squelch open), 1e-4 of it on odd
    # ones (RF power under the -60 dB threshold: closed), an FM carrier
    # (700 Hz tone, 2.1 kHz deviation) on every 4th
    blocks = noise_blocks(rng, nblk, B)
    t = np.arange(nblk * B, dtype=np.float64) / FS_NFM
    level = np.where(np.arange(C) % 2 == 0, 1.0, 1e-4).astype(np.float32)
    for i, x in enumerate(blocks):
        x *= level[:, None]
        tt = t[i * B:(i + 1) * B]
        for c in range(0, C, 4):
            x[c] += (0.3 * np.exp(2j * np.pi * tune[c] * tt + 3j * np.sin(
                2 * np.pi * 700.0 * tt))).astype(np.complex64)
    reset_launches()
    st, audio = run_chain(chain, blocks)
    torch.cuda.synchronize()
    n = launches()
    print(f"  NFM path: {nblk} blocks, front launches {n}, mixed demod "
          f"launches {mixed_demod.launches}", flush=True)
    assert n == {"plain": nblk, "gained": 0, "nb": 0}, n
    assert mixed_demod.launches == nblk, mixed_demod.launches
    for a in audio:
        assert a.shape == (C, AUDIO_BLOCK) and bool(torch.isfinite(a).all())
    hold, gain = st["fm_sq"]
    assert hold.dtype == torch.int32
    assert bool((hold[0::2] > 0).all()) and bool((hold[1::2] == 0).all())
    assert bool((audio[-1][1::2] == 0).all())

    cpu = RxChain.create(dataclasses.replace(nfm_config(), channels=8),
                         tune_hz=tune[:8], mode=int(Mode.FM), device="cpu")
    cst, cpu_audio = one_thread(lambda: run_chain(cpu, blocks, rows=8))
    assert torch.equal(hold[:8].cpu(), cst["fm_sq"][0])
    assert float((gain[:8].cpu() - cst["fm_sq"][1]).abs().max()) < 1e-6
    # the carrier-bearing rows must hold sample by sample
    match = compare_with_cpu(audio, cpu_audio, [int(Mode.FM)] * 8, 2,
                             CPU_MATCH_DB, "NFM",
                             strict_rows=NFM_CARRIER_ROWS)
    assert match["compared"] >= 8 and not match["fm_split"], match
    assert match["sample_by_sample"] >= 2 * len(NFM_CARRIER_ROWS), match

    # the front kernel at this path's shape (all 1024 channels, T=133,
    # d=4), on the path's own input: against its plain version and the
    # float64 reference over 2 streamed blocks, then timed
    op = chain.front
    assert (op.block, op.ntaps, op.decim) == (8192, 133, 4)
    kern = check_plain_mode(op, blocks[:2])
    print(f"timing of the front kernel at the NFM shape [{smi}]:",
          flush=True)
    times = time_plain_kernel(kern)
    report["nfm_path"] = {"blocks": nblk, "launches": n, "cpu_match": match,
                          "kernel_check": {"snr_db": kern["snr_db"],
                                           "max_abs_err":
                                               kern["max_abs_err"]}}
    return chain, blocks, {"launches": n["plain"],
                           "max_abs_err": kern["max_abs_err"], **times}


# ----------------------------------------------------------------- WDSP AGC
def phase_wcp(report: dict, smi: str, blocks) -> dict:
    """The flagship with agc_profile="wcp" (the WDSP AGC's state machine on
    csrc/agc_scan.cu) for WCP_BLOCKS blocks against the CPU chain on rows
    0-7 (the audio, and the AGC's integer states equal after the last
    block), timed like the flagship; the stage alone by events and its
    launches; then HangAGC over the same blocks' demod audio (no chain
    selects it; its op is the entry point).  Returns the [1024, 2048]
    arguments both recurrences took on their last block."""
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(flagship_config(), agc_profile="wcp")
    chain = RxChain.create(cfg, tune_hz=TUNE, mode=MODE, device=dev)
    blocks = blocks[:WCP_BLOCKS]
    st = chain.init_state()
    audio, ms = [], []
    reset_launches()
    for x in blocks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, a = chain.step(st, torch.as_tensor(x, device=dev))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        audio.append(a)
    n_wcp = agc_scan.wcp_scan.launches
    n_front = fused_tune_decimate.launches
    assert all(bool(torch.isfinite(a).all()) for a in audio)
    assert n_wcp == len(blocks) and n_front == len(blocks), (n_wcp, n_front)
    cpu = RxChain.create(dataclasses.replace(cfg, channels=8),
                         tune_hz=TUNE[:8], mode=MODE[:8], device="cpu")
    cst, cpu_audio = one_thread(lambda: run_chain(cpu, blocks, rows=8))
    match = compare_with_cpu(audio, cpu_audio, MODE, 1, WCP_MATCH_DB,
                             "WcpAGC")
    same = [k for k in ("state", "hang_counter", "decay_type")
            if torch.equal(st["agc"][k][:8].cpu(), cst["agc"][k])]
    assert match["compared"] >= 6, match
    assert len(same) == 3, same
    # the demod audio of every block (the AGC's input), from a fresh state
    fst, auds = chain.init_state(), []
    for x in blocks:
        xt = torch.as_tensor(x, device=dev)
        fst["front"], y = chain.front(fst["front"], xt)
        fst["bp"], y = chain.bp(fst["bp"], y)
        fst["demod"], aud = chain.demod(fst["demod"], y)
        auds.append(aud)
    wst = st["agc"]
    agc_ms = cuda_ms(lambda: chain.agc(wst, auds[-1]), 20)
    agc_launches = count_launches(lambda: chain.agc(wst, auds[-1]))
    ev_ms, host_ms = step_ms(chain, blocks, WCP_BLOCKS, warmup=2)
    budget = chain.block_in / FS * 1e3
    idle = device_idle("WcpAGC chain", chain, blocks, ev_ms)
    print(f"timing of the WcpAGC chain [{smi}]:", flush=True)
    print(f"  WcpAGC chain {ev_ms:.4f} ms/block (device events), "
          f"{host_ms:.4f} ms/block (host clock), real-time factor "
          f"{budget / ev_ms:.2f}x of {budget:.2f} ms; its {len(blocks)} "
          f"checked blocks by the host clock, each with its upload from "
          f"numpy: " + ", ".join(f"{v:.3f}" for v in ms), flush=True)
    print(f"  WcpAGC stage alone {agc_ms:.4f} ms (CUDA events), "
          f"{agc_launches} CUDA launches and copies; {n_wcp} kernel "
          f"launches in {len(blocks)} blocks; integer states equal to the "
          f"CPU chain's after {len(blocks)} blocks: {same}", flush=True)
    # HangAGC over the same demod audio
    hang = HangAGC.create(48000.0, device=dev)
    hst = hang.init_state(C)
    reset_launches()
    for aud in auds:
        hst, h = hang(hst, aud)
    n_hang = agc_scan.hang_scan.launches
    torch.cuda.synchronize()
    assert n_hang == len(auds) and bool(torch.isfinite(h).all()), n_hang
    hst_last = hst
    hang_ms = cuda_ms(lambda: hang(hst_last, auds[-1]), 20)
    print(f"  HangAGC over the chain's demod audio: {n_hang} kernel "
          f"launches in {len(auds)} blocks, {hang_ms:.4f} ms a block (CUDA "
          f"events)", flush=True)
    report["wcp"] = {"blocks": len(blocks), "checked_host_ms": ms,
                     "ms_per_block": ev_ms, "host_ms_per_block": host_ms,
                     "realtime_factor": budget / ev_ms, "idle": idle,
                     "agc_ms": agc_ms, "agc_launches": agc_launches,
                     "cpu_match": match, "equal_int_states": same,
                     "hang_ms": hang_ms}
    return {"launches": {"wcp": n_wcp, "hang": n_hang},
            "path_args": {"wcp": chain.agc.scan_inputs(wst, auds[-1])[1],
                          "hang": hang.scan_inputs(hst, auds[-1])[1]}}


# ------------------------------------------- timing of the new paths/kernels
def step_ms(chain, blocks, iters: int, warmup: int = 5
            ) -> tuple[float, float]:
    """(device ms by events, host ms with a synchronise) per step of
    ``chain`` in a running stream, both over the same ``iters`` steps."""
    dev = torch.device(DEVICE)
    xs = [torch.as_tensor(b, device=dev) for b in blocks[:2]]
    st = chain.init_state()
    for i in range(warmup):
        st, _ = chain.step(st, xs[i % 2])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in range(iters):
        st, _ = chain.step(st, xs[i % 2])
    stop.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters * 1e3
    return start.elapsed_time(stop) / iters, host


def device_idle(label: str, chain, blocks, untraced_ms: float,
                n: int = 10, warmup: int = 5, front_kernel: bool = True,
                step=None) -> dict:
    """Device idle share of ``chain``'s step in a running stream: 10
    steps after warm-up traced by torch.profiler (CUDA activity); busy is
    the union of the device intervals of kernels and copies, the span runs
    from the first device start to the last device end, idle share = 1 -
    busy/span.  The traced steps run slower than untraced ones (the
    profiler's host cost), so the share is also given against the untraced
    step ``untraced_ms``: 1 - busy/untraced.  And the front kernel's share
    of busy time (a path without the front kernel: ``front_kernel``
    False).  ``step``, a call that runs one step, takes the place of
    ``chain``'s step over ``blocks``."""
    if step is None:
        dev = torch.device(DEVICE)
        xs = [torch.as_tensor(b, device=dev) for b in blocks[:2]]
        run = {"st": chain.init_state(), "i": 0}

        def step():
            run["st"], _ = chain.step(run["st"], xs[run["i"] % 2])
            run["i"] += 1
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    ivs, front = [], 0.0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        ivs.append((e.time_range.start, e.time_range.end))
        if "fused_tune_decimate_kernel" in e.name:
            front += e.time_range.end - e.time_range.start
    assert ivs, f"{label}: the trace holds no device activity"
    ivs.sort()
    busy, (a0, b0) = 0.0, ivs[0]
    for a, b in ivs[1:]:
        if a > b0:
            busy += b0 - a0
            a0, b0 = a, b
        else:
            b0 = max(b0, b)
    busy += b0 - a0
    span = max(b for _, b in ivs) - ivs[0][0]
    busy_ms = busy / n / 1e3
    out = {"idle_share": 1.0 - busy / span, "busy_ms": busy_ms,
           "span_ms": span / n / 1e3, "front_share": front / busy,
           "device_activities": len(ivs), "untraced_ms": untraced_ms,
           "idle_share_untraced": 1.0 - busy_ms / untraced_ms}
    print(f"  {label} idle share = {out['idle_share']:.4f} (1 - busy/span "
          f"over {n} traced steps: device busy {busy_ms:.4f} of a "
          f"{out['span_ms']:.4f} ms span a step; front kernel "
          f"{out['front_share']:.4f} of busy; {len(ivs)} device activities)",
          flush=True)
    print(f"  {label} idle share against the untraced step = "
          f"{out['idle_share_untraced']:.4f} (1 - busy/untraced, untraced "
          f"step {untraced_ms:.4f} ms)", flush=True)
    assert front > 0 or not front_kernel, f"{label}: no front kernel"
    return out


def gain_kernel_bound(op, mode: str) -> dict:
    """The least time the card could take for one gained or NB-detect
    call: each input read once, each output written once, against the
    FIR's FMAs plus the per-sample work ahead of the mix (gain interp and
    scale: 5 operations; NB-detect adds |x|, group sum and max: 10)."""
    T, d, B = op.ntaps, op.decim, op.block
    N, L = B // d, B + T - 1
    GH, GB = op.gain_hist_groups, B // 16
    nbytes = C * L * 8 + C * N * 8 + T * 4 + 2 * C * 8
    if mode == "gained":
        nbytes += C * (GH + GB) * 4
        per_sample = 5
    else:
        nbytes += C * GH * 4 + C * GB * 4 + C * 4 + op.rc.numel() * 4 + 4
        per_sample = 10
    flops = C * N * T * 4 + C * L * per_sample
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "mbytes": nbytes / 1e6, "gflop": flops / 1e9}


def phase_timing_featured(report: dict, smi: str, featured, f_blocks, nfm,
                          n_blocks, gk: dict) -> dict:
    f_ms, f_host = step_ms(featured, f_blocks, 20)
    n_ms, n_host = step_ms(nfm, n_blocks, 20)
    f_budget = featured.block_in / FS * 1e3
    n_budget = nfm.block_in / FS_NFM * 1e3

    # per-stage device times of the featured step on one block's real
    # intermediates
    dev = torch.device(DEVICE)
    st = featured.init_state()
    x = torch.as_tensor(f_blocks[0], device=dev)
    front = lambda: featured.front.call_nb(           # noqa: E731
        st["front"], x, st["nbg"], featured.ons["nb"], featured.nb.limit)
    _, y, _ = front()
    _, y = featured.bp(st["bp"], y)
    rf_db = featured.fm_sq.measure(y)
    _, aud = featured.demod(st["demod"], y)
    stages = {"nb-front": cuda_ms(front, 10)}
    for name in ("notch", "anf", "nr", "agc", "squelch"):
        op = getattr(featured, name)
        a_in = aud
        stages[name] = cuda_ms(lambda: op(st[name], a_in), 10)
        _, aud = op(st[name], aud)
    stages["fm_sq"] = cuda_ms(
        lambda: (featured.fm_sq.measure(y),
                 featured.fm_sq(st["fm_sq"], aud, rf_db)), 10)

    op, args, nb_args, gext = gk["op"], gk["args"], gk["nb_args"], gk["gext"]
    times = {
        "gained": {
            "ms": cuda_ms(lambda: fused_tune_decimate_gained(*args, gext),
                          20),
            "plain_ms": cuda_ms(
                lambda: ff.fused_tune_decimate_gained_plain(*args, gext), 5),
            **gain_kernel_bound(op, "gained"), "library_ms": None},
        "nb": {
            "ms": cuda_ms(lambda: fused_tune_decimate_nb(*args, *nb_args),
                          20),
            "plain_ms": cuda_ms(
                lambda: ff.fused_tune_decimate_nb_plain(*args, *nb_args), 5),
            **gain_kernel_bound(op, "nb"), "library_ms": None},
    }
    print(f"timing of the featured and NFM paths [{smi}]:", flush=True)
    for label, ms, host, budget, chain, blocks in (
            ("featured", f_ms, f_host, f_budget, featured, f_blocks),
            ("NFM", n_ms, n_host, n_budget, nfm, n_blocks)):
        msps = C * chain.block_in / (ms * 1e-3) / 1e6
        print(f"  {label} step {ms:.4f} ms/block (device events), "
              f"{host:.4f} ms/block (host clock), {msps:.1f} Msps in, "
              f"real-time factor {budget / ms:.2f}x of {budget:.2f} ms",
              flush=True)
        report[f"timing_{label.lower()}"] = {
            "ms_per_block": ms, "host_ms_per_block": host, "msps": msps,
            "budget_ms": budget, "realtime_factor": budget / ms,
            "idle": device_idle(label, chain, blocks, ms)}
    print("  featured stages (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    report["timing_featured"]["stages_ms"] = stages
    for name, t in times.items():
        print(f"  fused_tune_decimate_{name} {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library none, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['mbytes']:.1f} MB, {t['gflop']:.2f} GFLOP)", flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {name: {k: t[k] for k in keys} for name, t in times.items()}


# -------------------------------------------------------------- PFB kernels
# (hop, K, P, frames out, streams): tiles that no frame count fills, K below
# one thread block, tap counts off the register-ring path, two streams
POLY_SHAPES = ((2, 256, 8, 32, 2), (2, 512, 8, 100, 1), (2, 4096, 8, 200, 1),
               (2, 12, 3, 7, 2), (1, 256, 8, 24, 2), (1, 512, 8, 77, 1),
               (1, 10, 5, 9, 2))
# (K, frames, streams, masks): frame counts that leave a warp, a tile and
# the last tile partly filled, odd ones among them; the kernel splits time
# into chunks of 256 frames, one block each: shapes over 2 to 4 chunks with
# a ragged last one, and one shorter than a warp's run of 4 frames
DEMOD_SHAPES = ((256, 32, 2, "mixed"), (512, 101, 2, "mixed"),
                (256, 300, 1, "all_am"), (512, 44, 2, "all_fm"),
                (256, 131, 1, "mixed"), (256, 3 * 256 + 37, 2, "mixed"),
                (512, 2 * 256 + 1, 1, "all_am"), (256, 256 + 5, 1, "all_fm"),
                (512, 3, 2, "mixed"))


def quarters(K: int) -> list[int]:
    """Mode quarters USB / LSB / AM / FM over K channels."""
    return [MODES[(4 * i) // K] for i in range(K)]


def rms_db(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float(10 * torch.log10(got.double().pow(2).mean()
                                  / ref.double().pow(2).mean()))


def check_poly_kernels(dev, rng) -> None:
    """Kernels #4 and #5 against their plain versions over 3 streamed
    blocks, the history fed on, at shapes off the main path's."""
    for hop, K, P, n_out, S in POLY_SHAPES:
        fn, plain = ((pk.pfb_poly_oversampled, pk.pfb_poly_oversampled_plain)
                     if hop == 2 else
                     (pk.pfb_poly_critical, pk.pfb_poly_critical_plain))
        Mf = K // hop
        h = torch.as_tensor(rng.standard_normal((P, K)).astype(np.float32),
                            device=dev)
        hist = torch.as_tensor(noise_blocks(rng, 1, (hop * P - 1) * Mf, S)[0],
                               device=dev)
        n0, worst = fn.launches, 0.0
        for _ in range(3):
            x = torch.as_tensor(noise_blocks(rng, 1, n_out * Mf, S)[0],
                                device=dev)
            v, vp = fn(hist, x, h), plain(hist, x, h)
            torch.cuda.synchronize()
            assert v.shape == vp.shape == (S, n_out, 2, K)
            err = float((v - vp).abs().max()) / float(vp.abs().max())
            assert err <= POLY_TOL, (hop, K, P, n_out, err)
            worst = max(worst, err)
            hist = torch.cat([hist, x], dim=-1)[:, x.shape[-1]:].contiguous()
        assert fn.launches - n0 == 3
        print(f"  {fn.__name__} K={K} P={P} n_out={n_out} S={S}: max|kernel-"
              f"plain| {worst:.2e} of the peak over 3 blocks (tolerance "
              f"{POLY_TOL:.0e})", flush=True)


def demod_args(pipe) -> tuple[tuple, dict]:
    """The constant arguments of the fused demod kernel for ``pipe``."""
    _, (twr, twi), (w2r, w2i), am_m, fm_m = pipe.kd
    return ((twr, twi, w2r, w2i, am_m, fm_m),
            dict(g_ssb=pipe.g_ssb, g_am=pipe.g_am, g_fm=pipe.g_fm,
                 a_dc=pipe.a_dc, a_de=pipe.a_de, b_de=pipe.b_de))


def compare_demod(pipe, got, want, label: str, fm_strict: bool = False
                  ) -> float:
    """Hold (audio, spec, st') of the fused demod kernel to the plain
    version's.  Non-FM positions sample by sample within DEMOD_TOL of the
    peak; FM positions by RMS, or sample by sample with ``fm_strict`` (a
    carrier on every channel); spec within SPEC_RTOL; the carries zr, zi,
    env, y_dc (and y_de with ``fm_strict``) within DEMOD_TOL of their
    peak.  Returns the non-FM (with ``fm_strict`` the overall) max error."""
    (a, sp, st), (ap, spp, stp) = got, want
    S, K1, K = a.shape[0], pipe.K1, pipe.K1 * pipe.K2
    assert a.shape == ap.shape and sp.shape == spp.shape == (S, K1, pipe.K2)
    assert st.shape == stp.shape == (S, 5 * K1, pipe.K2)
    assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(st).all())
    fm = pipe.kd[4].reshape(-1) > 0
    a, ap = a.reshape(S, -1, K), ap.reshape(S, -1, K)
    peak = float(ap.abs().max())
    strict = torch.ones_like(fm) if fm_strict else ~fm
    err, note = 0.0, ""
    if bool(strict.any()):
        err = float((a[..., strict] - ap[..., strict]).abs().max())
        assert err <= DEMOD_TOL * peak, (label, err, peak)
    if bool(fm.any()) and not fm_strict:
        db = rms_db(ap[..., fm], a[..., fm])
        share = float(((a[..., fm] - ap[..., fm]).abs()
                       <= DEMOD_TOL * peak).float().mean())
        assert abs(db) < FM_NOISE_RMS_DB, (label, db)
        note = (f", FM on noise {db:+.4f} dB by RMS, {100 * share:.2f}% of "
                f"its samples within the tolerance")
    assert torch.allclose(sp, spp, rtol=SPEC_RTOL, atol=0.0), label
    rows = (0, 1, 2, 3, 4) if fm_strict else (0, 1, 3, 4)
    s5, s5p = st.reshape(S, 5, -1), stp.reshape(S, 5, -1)
    st_err = max(float((s5[:, r] - s5p[:, r]).abs().max()) for r in rows)
    assert st_err <= DEMOD_TOL * max(1.0, float(s5p.abs().max())), (label,
                                                                     st_err)
    print(f"  {label}: max|kernel-plain| {err:.2e} (peak {peak:.3f}, "
          f"tolerance {DEMOD_TOL:.0e} of it), carries {st_err:.2e}{note}",
          flush=True)
    return err


def check_demod_kernel(dev, rng) -> None:
    """Kernel #6 against its plain version over 3 streamed calls on noise
    planes, the state fed on from non-zero entering carries; then on planes
    that put a frequency-modulated carrier on every channel."""
    n0 = pk.pfb_demod_call.launches
    calls = 0
    for K, n_out, S, masks in DEMOD_SHAPES:
        mode_vec = {"mixed": quarters(K), "all_am": [int(Mode.AM)] * K,
                    "all_fm": [int(Mode.FM)] * K}[masks]
        pipe = PFBRxPipeline.create(K, 2 * K, mode_vec, PFB_RATE,
                                    pallas_demod=True, device=dev)
        consts, kw = demod_args(pipe)
        K1 = pipe.K1
        st = (0.1 * rng.standard_normal((S, 5, K1, 128))).astype(np.float32)
        st[:, 3] = np.abs(st[:, 3])                      # an envelope
        st = torch.as_tensor(st.reshape(S, 5 * K1, 128), device=dev)
        for blk in range(3):
            bb = torch.as_tensor((rng.standard_normal(
                (S, n_out * 2 * K1, 128)) / np.sqrt(K)).astype(np.float32),
                device=dev)
            got = pk.pfb_demod_call(bb, st, *consts, **kw)
            want = pk.pfb_demod_plain(bb, st, *consts, **kw)
            torch.cuda.synchronize()
            compare_demod(pipe, got, want, f"pfb_demod K={K} n_out={n_out} "
                          f"S={S} {masks} block {blk}")
            st = got[2]
            calls += 1
    # a carrier on every channel: z[t, c] = exp(j phi_c[t]) plus a little
    # noise, carried back through the stage-2 basis, sign and twiddle
    K, n_out = 256, 300
    pipe = PFBRxPipeline.create(K, 2 * K, int(Mode.FM), PFB_RATE,
                                pallas_demod=True, device=dev)
    consts, kw = demod_args(pipe)
    K1 = pipe.K1
    t = np.arange(n_out)[:, None]
    dev_c = rng.uniform(0.05, 0.6, K)[None, :]
    z = np.exp(1j * (dev_c * t + 0.8 * np.sin(0.3 * t + dev_c)))
    z = z + 0.01 * noise_blocks(rng, 1, K, n_out)[0]
    W2 = (consts[2].cpu().numpy().astype(np.complex128)
          + 1j * consts[3].cpu().numpy())
    tw = (consts[0].cpu().numpy().astype(np.complex128)
          + 1j * consts[1].cpu().numpy())
    c = z.reshape(n_out, K1, 128) @ np.linalg.inv(W2)
    sgn = 1 - 2 * ((t % 2)[:, :, None] * (np.arange(K1) % 2)[None, :, None])
    b = c * sgn / tw[None]
    bb = torch.as_tensor(np.stack([b.real, b.imag], axis=1).reshape(
        1, n_out * 2 * K1, 128).astype(np.float32), device=dev)
    st = torch.zeros((1, 5 * K1, 128), device=dev)
    got = pk.pfb_demod_call(bb, st, *consts, **kw)
    want = pk.pfb_demod_plain(bb, st, *consts, **kw)
    torch.cuda.synchronize()
    # the first frame has no carrier before it: compare from frame 1 on
    cut = lambda r: (r[0][:, K1:], r[1], r[2])           # noqa: E731
    compare_demod(pipe, cut(got), cut(want), f"pfb_demod K={K} n_out={n_out}"
                  f" all_fm, a carrier on every channel", fm_strict=True)
    assert float(got[0].pow(2).mean().sqrt()) > 0.05
    assert pk.pfb_demod_call.launches - n0 == calls + 1


def phase_pfb_kernels(report: dict, rng) -> None:
    dev = torch.device(DEVICE)
    n0 = pfb_launches()
    check_poly_kernels(dev, rng)
    check_demod_kernel(dev, rng)
    rose = {k: v - n0[k] for k, v in pfb_launches().items()}
    n_os = 3 * sum(1 for s in POLY_SHAPES if s[0] == 2)
    n_cr = 3 * sum(1 for s in POLY_SHAPES if s[0] == 1)
    assert rose == {"poly_os": n_os, "poly_crit": n_cr,
                    "demod": 3 * len(DEMOD_SHAPES) + 1}, rose
    # what the kernels refuse must raise, not launch
    for bad in (lambda: pk.pfb_poly_oversampled(
                    torch.zeros((1, 14 * 64), dtype=torch.complex64,
                                device=dev),
                    torch.zeros((1, 128), dtype=torch.complex64, device=dev),
                    torch.zeros((8, 128), device=dev)),
                lambda: pk.pfb_demod_call(
                    torch.zeros((1, 64, 64), device=dev),
                    *[torch.zeros((1, 1), device=dev)] * 7, g_ssb=2.0,
                    g_am=2.0, g_fm=1.0, a_dc=0.9, a_de=0.9, b_de=0.1)):
        try:
            bad()
        except ValueError as e:
            print(f"  refused: {e}", flush=True)
        else:
            raise AssertionError("a bad call launched")
    # a stage-2 basis that is not the inverse DFT times a rotation: the
    # kernel computes an FFT, so the wrapper must refuse it, not launch
    pipe = PFBRxPipeline.create(256, 512, quarters(256), PFB_RATE,
                                pallas_demod=True, device=dev)
    (twr, twi, w2r, w2i, am_m, fm_m), kw = demod_args(pipe)
    w2_bad = w2r.clone()
    w2_bad[5, 7] += 1e-3
    n0 = pk.pfb_demod_call.launches
    try:
        pk.pfb_demod_call(torch.zeros((1, 4 * pipe.K1, 128), device=dev),
                          torch.zeros((1, 5 * pipe.K1, 128), device=dev),
                          twr, twi, w2_bad, w2i, am_m, fm_m, **kw)
    except ValueError as e:
        print(f"  refused: {e}", flush=True)
    else:
        raise AssertionError("a non-DFT stage-2 basis launched")
    assert pk.pfb_demod_call.launches == n0
    report["pfb_kernel_check"] = {"launches": rose}


# ------------------------------------------------------------- PFB receiver
def pfb_signal(dev, gen, K: int, B: int, blk: int) -> torch.Tensor:
    """Block ``blk`` of the receiver's wideband input [1, B], made on the
    card from a seeded generator: complex noise (unit variance a rail); a
    carrier 1 kHz above the centre of USB channel PFB_USB; a carrier with
    a 1 kHz tone at 50% depth on AM channel PFB_AM; a carrier frequency-
    modulated by a 1 kHz tone (3 kHz deviation) on FM channel PFB_FM.
    Channel c is centred on c/K of the input rate, kept exact in integers."""
    x = torch.view_as_complex(torch.randn((1, B, 2), generator=gen,
                                          device=dev))
    n = torch.arange(blk * B, (blk + 1) * B, device=dev)
    tone = (2 * np.pi * BEAT_HZ / (K * PFB_RATE / 2)) * n.to(torch.float64)

    def centre(c):
        return (2 * np.pi / K) * ((c * n) % K).to(torch.float64)

    unit = torch.ones_like(tone)
    sig = (torch.polar(unit, centre(PFB_USB) + tone)
           + torch.polar(1.0 + 0.5 * torch.cos(tone), centre(PFB_AM))
           + torch.polar(unit, centre(PFB_FM) + 3.0 * torch.sin(tone)))
    return x + sig.to(torch.complex64)[None]


def tone_peak(audio: np.ndarray, fs: float) -> tuple[float, float]:
    """(frequency of the largest bin, its dB over the median bin)."""
    a = audio.astype(np.float64)
    spec = np.abs(np.fft.rfft((a - a.mean()) * np.hanning(a.size)))
    freqs = np.fft.rfftfreq(a.size, 1.0 / fs)
    return (float(freqs[np.argmax(spec)]),
            float(20 * np.log10(spec.max() / np.median(spec))))


def compare_routes(a, sp, a_ref, sp_ref, modes, carrier: int, label: str,
                   fm_too: bool = True) -> dict:
    """Audio [.., K] and spec of one route against another's, both in the
    order of ``modes`` (the mode of each column).  SSB and AM columns
    together by SNR (PFB_ROUTE_DB) and sample by sample within
    PFB_ROUTE_TOL of the peak, the FM column ``carrier`` by SNR, other FM
    columns by RMS."""
    fm = modes == int(Mode.FM)
    am = modes == int(Mode.AM)
    peak = float(a_ref.abs().max())
    err = float((a[..., ~fm] - a_ref[..., ~fm]).abs().max())
    assert err <= PFB_ROUTE_TOL * peak, (label, err, peak)
    out = {"non_fm_max_abs": err, "peak": peak}
    for name, cols in (("SSB", ~fm & ~am), ("AM", am)):
        out[name] = snr_db(a_ref[..., cols], a[..., cols])
        assert out[name] >= PFB_ROUTE_DB[name], (label, name, out[name])
    note = ""
    if fm_too:
        rest = fm.clone()
        rest[carrier] = False
        out["FM carrier"] = snr_db(a_ref[..., carrier], a[..., carrier])
        out["fm_noise_rms_db"] = rms_db(a_ref[..., rest], a[..., rest])
        assert out["FM carrier"] >= PFB_ROUTE_DB["FM carrier"], (label, out)
        assert abs(out["fm_noise_rms_db"]) < FM_NOISE_RMS_DB, (label, out)
        note = (f", FM carrier channel {out['FM carrier']:.1f} dB, other FM "
                f"{out['fm_noise_rms_db']:+.4f} dB by RMS")
    assert torch.allclose(sp, sp_ref, rtol=PFB_SPEC_RTOL, atol=0.0), label
    print(f"  {label}: non-FM max abs {err:.2e} of a peak of {peak:.3f}, SSB "
          f"{out['SSB']:.1f} dB, AM {out['AM']:.1f} dB{note}, spec within "
          f"rtol {PFB_SPEC_RTOL:.0e}", flush=True)
    return out


def channel_beats(outs, pos, n_out: int, K: int) -> tuple[dict, list]:
    """The three signals of ``pfb_signal`` out of their channels' columns
    of the kernel route's audio (blocks 1 on), each a 1 kHz tone 20 dB over
    the median bin, and the three strongest channels of the last spec."""
    beats = {}
    for name, c in (("USB", PFB_USB), ("AM", PFB_AM), ("FM", PFB_FM)):
        col = torch.cat([a.view(n_out, K)[:, int(pos[c])]
                         for a, _ in outs[1:]]).cpu().numpy()
        f_peak, contrast = tone_peak(col, PFB_RATE)
        print(f"  channel {c} ({name}): tone at {f_peak:.1f} Hz, "
              f"{contrast:.1f} dB over the median bin", flush=True)
        # within 10 Hz, or one bin of a short rehearsal
        assert abs(f_peak - BEAT_HZ) <= max(10.0, PFB_RATE / col.size), (
            name, f_peak)
        assert contrast > 20.0, (name, contrast)
        beats[name] = (f_peak, contrast)
    spec = outs[-1][1][0]
    top = sorted(int(i) for i in torch.topk(spec, 3).indices)
    ratio = float(10 * torch.log10(spec[PFB_USB] / spec.median()))
    print(f"  spec: the 3 strongest channels {top}, channel {PFB_USB} "
          f"{ratio:.1f} dB over the median channel", flush=True)
    assert top == [PFB_USB, PFB_AM, PFB_FM] and ratio > 20.0
    return beats, top


def pfb_kernel_errors(pipe, state, x) -> tuple:
    """Kernels #4 and #6 against their plain versions on one block of a
    path (its entering ``state`` and input ``x``): (poly max abs error,
    demod max abs error, the polyphase output v, the stage-1 output bb)."""
    hist, dm = state
    K = pipe.K1 * pipe.K2
    n_out = 2 * x.shape[-1] // K
    v = pk.pfb_poly_oversampled(hist, x, pipe.pfb.h_poly)
    vp = pk.pfb_poly_oversampled_plain(hist, x, pipe.pfb.h_poly)
    torch.cuda.synchronize()
    poly_err = float((v - vp).abs().max())
    poly_peak = float(vp.abs().max())
    print(f"  pfb_poly_oversampled at K={K}, n_out={n_out}: "
          f"max|kernel-plain| {poly_err:.2e} (peak {poly_peak:.3e}, "
          f"tolerance {POLY_TOL:.0e} of it)", flush=True)
    assert poly_err <= POLY_TOL * poly_peak
    del vp
    bb = pipe.stage1(v)
    consts, kw = demod_args(pipe)
    got = pk.pfb_demod_call(bb, dm, *consts, **kw)
    want = pk.pfb_demod_plain(bb, dm, *consts, **kw)
    torch.cuda.synchronize()
    demod_err = compare_demod(pipe, got, want,
                              f"pfb_demod at K1={pipe.K1}, n_out={n_out}")
    return poly_err, demod_err, v, bb


def pfb_pipeline(dev, mult: int, kernels: bool) -> PFBRxPipeline:
    return PFBRxPipeline.create(PFB_K, PFB_K * mult, quarters(PFB_K),
                                channel_rate=PFB_RATE, pallas_poly=kernels,
                                pallas_demod=kernels, device=dev)


def phase_pfb_receiver(report: dict) -> dict:
    dev = torch.device(DEVICE)
    K, B = PFB_K, PFB_K * PFB_MULT
    n_out = 2 * PFB_MULT
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pipe = pfb_pipeline(dev, PFB_MULT, True)
    assert pipe.pallas_demod and pipe.pfb.pallas_poly
    assert (pipe.K1, pipe.K2) == (K // 128, 128)
    pos = torch.as_tensor(pipe.chan_pos, device=dev)
    xs = [pfb_signal(dev, gen, K, B, blk) for blk in range(PFB_BLOCKS)]

    reset_launches()
    st = pipe.init_state(1)
    states, outs = [st], []
    for x in xs:
        st, out = pipe(st, x)
        states.append(st)
        outs.append(out)
    torch.cuda.synchronize()
    n = pfb_launches()
    print(f"  PFB receiver: {PFB_BLOCKS} blocks of {B} samples, launches {n}",
          flush=True)
    assert n == {"poly_os": PFB_BLOCKS, "poly_crit": 0,
                 "demod": PFB_BLOCKS}, n
    assert launches() == {"plain": 0, "gained": 0, "nb": 0}
    for a, sp in outs:
        assert a.shape == (1, n_out * pipe.K1, pipe.K2)
        assert a.dtype == torch.float32 and sp.shape == (1, K)
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(sp).all())

    beats, top = channel_beats(outs, pos, n_out, K)

    # the torch-op route on the card, block by block
    ref = pfb_pipeline(dev, PFB_MULT, False)
    modes = torch.as_tensor(quarters(K), device=dev)
    st_r = ref.init_state(1)
    routes = []
    for i, x in enumerate(xs):
        st_r, (ar, spr) = ref(st_r, x)
        assert ar.shape == (1, n_out, K)
        ak = outs[i][0].view(1, n_out, K)[:, :, pos]
        routes.append(compare_routes(
            ak, outs[i][1], ar, spr, modes, PFB_FM,
            f"kernel route vs torch-op route, block {i}", fm_too=i >= 1))
        del ar, ak
    assert pfb_launches() == n           # the torch-op route launched none

    # each kernel at the path's shape against its plain version, on the
    # path's own tensors (block 2, entering state non-zero)
    poly_err, demod_err, v, bb = pfb_kernel_errors(pipe, states[2], xs[2])

    # the same pipeline on the CPU (one thread), PFB_CPU_MULT frames deep
    small, cpu = (pfb_pipeline(d, PFB_CPU_MULT, True) for d in (dev, "cpu"))
    modes_pos = modes[torch.as_tensor(small.chan_perm, device=dev)]
    car = int(small.chan_pos[PFB_FM])
    st_s, st_c = small.init_state(1), cpu.init_state(1)
    cpu_match = []
    for blk in range(2):
        xb = pfb_signal(dev, gen, K, K * PFB_CPU_MULT, blk)
        st_s, (a_s, sp_s) = small(st_s, xb)
        xc = xb.cpu()
        st_c, (a_c, sp_c) = one_thread(lambda: cpu(st_c, xc))
        cpu_match.append(compare_routes(
            a_s.view(1, -1, K), sp_s, a_c.view(1, -1, K).to(dev),
            sp_c.to(dev), modes_pos, car,
            f"card vs CPU pipeline at {PFB_CPU_MULT} frames, block {blk}",
            fm_too=blk >= 1))
    report["pfb_receiver"] = {
        "blocks": PFB_BLOCKS, "launches": n, "beats": beats,
        "spec_top": top, "routes": routes, "cpu_match": cpu_match,
        "poly_max_abs_err": poly_err, "demod_max_abs_err": demod_err}
    return {"pipe": pipe, "ref": ref, "xs": xs, "state": states[2], "v": v,
            "bb": bb, "launches": n, "poly_err": poly_err,
            "demod_err": demod_err}


def phase_pfb_critical(report: dict, xs) -> dict:
    """The critically-sampled channelizer at K=4096, 8192 frames a block, on
    the receiver's input (its USB carrier lies 1 kHz off channel 300)."""
    dev = torch.device(DEVICE)
    K, B = PFB_K, PFB_K * PFB_MULT
    op = PFBChannelizer.create(K, B, pallas_poly=True, device=dev)
    ref = PFBChannelizer.create(K, B, pallas_poly=False, device=dev)
    reset_launches()
    st, st_r = op.init_state(1), ref.init_state(1)
    snrs = []
    for x in xs[:2]:
        hist = st
        st, y = op(st, x)
        st_r, y_r = ref(st_r, x)
        assert y.shape == (1, K, PFB_MULT) and y.dtype == torch.complex64
        assert bool(torch.isfinite(torch.view_as_real(y)).all())
        assert torch.equal(st, st_r)
        snrs.append(snr_db(y_r, y))
        assert snrs[-1] >= KERNEL_SNR_DB, snrs
    n = pfb_launches()
    assert n == {"poly_os": 0, "poly_crit": 2, "demod": 0}, n
    power = (y[0].abs() ** 2).mean(-1)
    top = sorted(int(i) for i in torch.topk(power, 3).indices)
    ratio = float(10 * torch.log10(power[PFB_USB] / power.median()))
    print(f"  PFBChannelizer: 2 blocks, launches {n}, kernel route vs "
          f"torch-op route {min(snrs):.1f} dB; the 3 strongest channels "
          f"{top}, channel {PFB_USB} {ratio:.1f} dB over the median",
          flush=True)
    assert top == [PFB_USB, PFB_AM, PFB_FM] and ratio > 20.0
    del y, y_r
    v = pk.pfb_poly_critical(hist, x, op.h_poly)
    vp = pk.pfb_poly_critical_plain(hist, x, op.h_poly)
    torch.cuda.synchronize()
    err, peak = float((v - vp).abs().max()), float(vp.abs().max())
    print(f"  pfb_poly_critical at K={K}, n_out={PFB_MULT}: max|kernel-plain|"
          f" {err:.2e} (peak {peak:.3f})", flush=True)
    assert err <= POLY_TOL * peak
    report["pfb_critical"] = {"launches": n, "route_snr_db": snrs,
                              "max_abs_err": err}
    return {"op": op, "hist": hist, "x": x, "launches": n["poly_crit"],
            "err": err}


def phase_front_cond(report: dict, blocks) -> None:
    """The featured chain with the raw-IQ conditioner ahead of it (hp mode,
    a trim set, a DC offset on the input) for 5 blocks against the CPU
    chain on channels 0-7."""
    dev = torch.device(DEVICE)
    nblk = 5
    cfg = dataclasses.replace(featured_config(), front_cond=True,
                              dc_remove_bw=300)
    blocks = [b + np.complex64(0.3 + 0.2j) for b in blocks[:nblk]]
    chain = RxChain.create(cfg, tune_hz=TUNE, mode=MODE, device=dev)
    cpu = RxChain.create(dataclasses.replace(cfg, channels=8),
                         tune_hz=TUNE[:8], mode=MODE[:8], device="cpu")
    assert chain.cond.dc_mode == "hp" and chain._nb_fused
    chain, cpu = (dataclasses.replace(c, cond=c.cond.with_balance(0.02, 1.5))
                  for c in (chain, cpu))
    reset_launches()
    st, audio = run_chain(chain, blocks)
    torch.cuda.synchronize()
    n = launches()
    assert n == {"plain": 0, "gained": 0, "nb": nblk}, n
    assert all(bool(torch.isfinite(a).all()) for a in audio)
    # the blocker has taken the offset out of what the front end sees
    _, y = chain.cond(chain.init_state()["cond"],
                      torch.as_tensor(blocks[0], device=dev))
    dc = float(y[:, y.shape[-1] // 2:].mean(-1).abs().max())
    assert dc < 0.08, dc
    _, cpu_audio = one_thread(lambda: run_chain(cpu, blocks, rows=8))
    match = compare_with_cpu(audio, cpu_audio, MODE, FEATURED_FROM_BLOCK,
                             FEATURED_MATCH_DB, "featured + conditioner")
    assert match["compared"] >= 3 * (nblk - FEATURED_FROM_BLOCK), match
    print(f"  conditioner: {nblk} blocks, front launches {n}, residual DC "
          f"after the blocker {dc:.4f} of an offset of 0.36", flush=True)
    report["front_cond"] = {"blocks": nblk, "launches": n,
                            "cpu_match": match, "residual_dc": dc}


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "mbytes": nbytes / 1e6,
            "gflop": flops / 1e9}


def poly_os_bound(pfb, hist, x) -> dict:
    """Kernel #4's bound: hist and x read, the taps read, v written; two
    operations a tap, an output and a plane."""
    K, P = pfb.n_chan, pfb.P
    n_out = x.numel() * 2 // K
    return bound((hist.numel() + x.numel()) * 8 + P * K * 4
                 + n_out * 2 * K * 4, n_out * K * 2 * P * 2)


def demod_bound(pipe, bb, dm) -> dict:
    """Kernel #6's bound: bytes as they are (bb and the carry read, the
    carry written, twiddles, basis and masks, audio and power written);
    operations as the function needs them (a 128-point FFT per row, 5 N
    log2 N, plus ~50 per sample for twiddle, demodulators and power)."""
    K = pipe.K1 * pipe.K2
    rows = bb.numel() // (2 * 128)
    nbytes = (bb.numel() + 2 * dm.numel() + 4 * K + 2 * 128 * 128
              + rows * 128 + K) * 4
    return bound(nbytes, rows * (5 * 128 * 7 + 128 * 50))


def phase_timing_pfb(report: dict, smi: str, rx: dict, crit: dict) -> dict:
    pipe, ref, xs = rx["pipe"], rx["ref"], rx["xs"]
    K, P = PFB_K, pipe.pfb.P
    B, n_out, K1 = K * PFB_MULT, 2 * PFB_MULT, pipe.K1

    def stepper(p):
        state = {"st": p.init_state(1), "i": 0}

        def step():
            state["st"], _ = p(state["st"], xs[state["i"] % len(xs)])
            state["i"] += 1
        return step

    k_ms = cuda_ms(stepper(pipe), iters=6, warmup=2)
    r_ms = cuda_ms(stepper(ref), iters=3, warmup=1)
    hist, dm = rx["state"]
    x, v, bb = xs[2], rx["v"], rx["bb"]
    consts, kw = demod_args(pipe)
    h = pipe.pfb.h_poly
    stages = {
        "poly (kernel #4)": cuda_ms(
            lambda: pk.pfb_poly_oversampled(hist, x, h), 10),
        "stage-1 product": cuda_ms(lambda: pipe.stage1(v), 10),
        "stage 2 + demod (kernel #6)": cuda_ms(
            lambda: pk.pfb_demod_call(bb, dm, *consts, **kw), 10),
    }
    times = {
        "poly_os": {
            "ms": stages["poly (kernel #4)"],
            "plain_ms": cuda_ms(
                lambda: pk.pfb_poly_oversampled_plain(hist, x, h), 3, 1),
            **poly_os_bound(pipe.pfb, hist, x)},
        "poly_crit": {
            "ms": cuda_ms(lambda: pk.pfb_poly_critical(
                crit["hist"], crit["x"], crit["op"].h_poly), 10),
            "plain_ms": cuda_ms(lambda: pk.pfb_poly_critical_plain(
                crit["hist"], crit["x"], crit["op"].h_poly), 3, 1),
            **bound((crit["hist"].shape[-1] + B) * 8 + P * K * 4
                    + PFB_MULT * 2 * K * 4, PFB_MULT * K * 2 * P * 2)},
    }
    # kernel #6 beside its bound: the bytes its two launches move (the
    # fix-up rereads and rewrites the AM and FM positions' audio), and
    # torch.fft.ifft over the same complex rows, the transform alone: not
    # the same function, and the port never calls it
    rows = n_out * K1
    dbound = demod_bound(pipe, bb, dm)
    nbytes = dbound["mbytes"] * 1e6
    am_fm = int(((consts[4] + consts[5]) > 0).sum())
    b4 = bb.view(n_out, 2, K1, 128)
    zc = torch.complex(b4[:, 0], b4[:, 1]).reshape(rows, 128)
    fft_ms = cuda_ms(lambda: torch.fft.ifft(zc, dim=-1), 10)
    del zc, b4
    # the two CUDA launches of one call, by the profiler's device times
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            pk.pfb_demod_call(bb, dm, *consts, **kw)
        torch.cuda.synchronize()
    launch_ms = {name: sum(e.device_time_total for e in prof.key_averages()
                           if f"pfb_demod_{name}" in e.key) / 5e3
                 for name in ("chunk", "carry")}
    times["demod"] = {
        "ms": stages["stage 2 + demod (kernel #6)"],
        "launch_ms": launch_ms,
        "plain_ms": cuda_ms(
            lambda: pk.pfb_demod_plain(bb, dm, *consts, **kw), 3, 1),
        **dbound,
        "moved_mb": (nbytes + 2 * n_out * am_fm * 4) / 1e6,
        "ifft_ms": fft_ms}
    print(f"timing of the PFB receiver [{smi}]:", flush=True)
    for label, ms in (("kernel route", k_ms), ("torch-op route", r_ms)):
        print(f"  {label}: {ms:.4f} ms/block (device events), "
              f"{B / (ms * 1e-3) / 1e6:.1f} Msps in, real-time factor "
              f"{n_out / PFB_RATE * 1e3 / ms:.2f}x of "
              f"{n_out / PFB_RATE * 1e3:.2f} ms", flush=True)
    print("  kernel-route stages (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    for name, t in times.items():
        extra = (f"; two CUDA launches a call moving {t['moved_mb']:.1f} MB "
                 f"= {t['moved_mb'] / PEAK_BYTES_PER_S * 1e9:.4f} ms (by the "
                 f"profiler: chunks {t['launch_ms']['chunk']:.4f} ms, "
                 f"carries {t['launch_ms']['carry']:.4f} ms); "
                 f"torch.fft.ifft over the same {rows} x 128 complex rows "
                 f"(the transform alone, not the same function, never "
                 f"called by the port) {t['ifft_ms']:.4f} ms"
                 if "ifft_ms" in t else "")
        print(f"  {name}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"library none, bound {t['bound_ms']:.4f} ms by "
              f"{t['bound_by']} ({t['mbytes']:.1f} MB = {t['bytes_ms']:.4f} "
              f"ms, {t['gflop']:.2f} GFLOP = {t['ops_ms']:.4f} ms){extra}",
              flush=True)
    report["timing_pfb"] = {
        "kernel_route_ms": k_ms, "torch_route_ms": r_ms,
        "msps": B / (k_ms * 1e-3) / 1e6, "budget_ms": n_out / PFB_RATE * 1e3,
        "stages_ms": stages, "kernels": times}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    # library_ms: no one PyTorch call computes any of the three (the
    # nearest, a grouped conv1d, wants transposed planes and gives neither
    # the lane reversal nor the stacked layout; nothing fuses an IDFT
    # stage with three demodulators)
    return {name: {**{k: t[k] for k in keys}, "library_ms": None}
            for name, t in times.items()}

# ------------------------------------------------------------- TX path
TX_MODES = [int(Mode.USB) if i % 2 == 0 else int(Mode.FM) for i in range(C)]
TX_BLOCKS = 4
TX_MATCH_DB = 80.0         # card vs CPU chain, every row of 0-7
TX_IMAGE_DB = -40.0        # SSB image band against the wanted band
TX_AUDIO_MS = AUDIO_BLOCK / 48000.0 * 1e3
LOOP_BLOCKS = 16
LOOP_SNR_DB = 18.0         # tests/test_tx.py:117
IMD_GAIN_DB = 12.0         # tests/test_puresignal.py:52
SPEC_POWER_RTOL = 1e-4
ALC_LAUNCHES_MAX = 40      # TxALC's CUDA launches a block (kernel + torch)
TX_STEP_LAUNCHES_MAX = 200
TX_PLACE_SHAPE = (8192, 4096)  # tx96k_8192ch.resident's I/Q block


def tx_config() -> TxChainConfig:
    """The TX chain of bench.py:681-688 (ALC on by default)."""
    return TxChainConfig(channels=C, audio_block=AUDIO_BLOCK,
                         tx_rate=192000.0, compress_db=6.0, preemphasis=0.3)


def voice_like(rng, n: int, rows: int, band=(300.0, 2700.0),
               fs: float = 48000.0) -> np.ndarray:
    """Band-limited noise standing in for speech, unit RMS per row: seeded
    white noise through a 6th-order Butterworth bandpass (the recipe of
    quisk_tpu/io/sources.py:28)."""
    w = rng.standard_normal((rows, n + 4096))
    sos = sig.butter(6, band, btype="bandpass", fs=fs, output="sos")
    a = sig.sosfilt(sos, w, axis=-1)[:, 4096:]
    return a / np.sqrt(np.mean(a ** 2, axis=-1, keepdims=True))


def alc_rows(st: dict, rows: int, dev) -> dict:
    """The first ``rows`` channels of a TxALC state, on ``dev``."""
    return {k: (v if v.ndim == 0 else v[:rows]).to(dev)
            for k, v in st.items()}


def band_db(p: np.ndarray, f: np.ndarray, lo: float, hi: float) -> float:
    return float(10 * np.log10(np.mean(p[(f > lo) & (f < hi)])))


def phase_tx(report: dict, rng) -> dict:
    """The TX chain at full width for TX_BLOCKS blocks on the card, rows
    0-7 against the same chain on the CPU, the ALC's clip decisions, and
    the USB rows' image band through the card's SpectrumAnalyzer."""
    dev = torch.device(DEVICE)
    tx = TxChain.create(tx_config(), mode=TX_MODES, device=dev)
    assert tx.block_tx == 4 * AUDIO_BLOCK and tx.alc is not None
    n = TX_BLOCKS * AUDIO_BLOCK
    audio = (0.3 * voice_like(rng, n, C)).astype(np.float32)
    blocks = [np.ascontiguousarray(audio[:, i * AUDIO_BLOCK:
                                         (i + 1) * AUDIO_BLOCK])
              for i in range(TX_BLOCKS)]
    st = tx.init_state()
    states, out = [], []
    reset_launches()
    for b in blocks:
        states.append(st)
        st, iq = tx.step(st, torch.as_tensor(b, device=dev))
        out.append(iq)
    torch.cuda.synchronize()
    n_alc = agc_scan.tx_alc_scan.launches
    assert n_alc == TX_BLOCKS, n_alc
    n_place = tx_place.launches
    assert n_place == TX_BLOCKS, n_place
    for iq in out:
        assert iq.shape == (C, tx.block_tx) and iq.dtype == torch.complex64
        assert bool(torch.isfinite(torch.view_as_real(iq)).all())

    cpu = TxChain.create(dataclasses.replace(tx_config(), channels=8),
                         mode=TX_MODES[:8], device="cpu")

    def run_cpu():
        cst, c_out, c_states = cpu.init_state(), [], []
        for b in blocks:
            c_states.append(cst)
            cst, iq = cpu.step(cst, torch.as_tensor(b[:8]))
            c_out.append(iq)
        return c_out, c_states
    cpu_out, cpu_states = one_thread(run_cpu)
    card8 = torch.cat([o[:8].cpu() for o in out], dim=-1)
    cpu8 = torch.cat(cpu_out, dim=-1)
    snr = np.array([snr_db(cpu8[r], card8[r]) for r in range(8)])
    print("  TX path: card vs CPU chain, rows 0-7 over "
          f"{TX_BLOCKS} blocks, dB: "
          + ", ".join(f"{v:.1f}" for v in snr), flush=True)
    assert bool(np.all(snr >= TX_MATCH_DB)), snr

    # the ALC's clip decisions, rows 0-7, block by block from the states
    # each side entered it with: the card's ALC on the CPU's own modulated
    # IQ and state (identical inputs: must decide the same at every
    # sample), and each side on its own IQ (counted and printed)
    alc8 = TxALC.create(48000.0, mode=TX_MODES[:8], channels=8, device=dev)
    flips_same = flips_own = clips = 0
    worst_same = 0.0
    for b, s_card, s_cpu in zip(blocks, states, cpu_states):
        xb = torch.as_tensor(b, device=dev)
        _, iq_g = tx.pre_alc(s_card, xb)
        _, _, c_g = alc8.trace(alc_rows(s_card["alc"], 8, dev), iq_g[:8])

        def cpu_side():
            _, iq_c = cpu.pre_alc(s_cpu, torch.as_tensor(b[:8]))
            _, o_c, c_c = cpu.alc.trace(s_cpu["alc"], iq_c)
            return iq_c, o_c, c_c
        iq_c, o_c, c_c = one_thread(cpu_side)
        _, o_s, c_s = alc8.trace(alc_rows(s_cpu["alc"], 8, dev),
                                 iq_c.to(dev))
        flips_same += int((c_s.cpu() != c_c).sum())
        flips_own += int((c_g.cpu() != c_c).sum())
        clips += int(c_c.sum())
        worst_same = max(worst_same, float((o_s.cpu() - o_c).abs().max()))
    print(f"  TxALC clip decisions, rows 0-7, {TX_BLOCKS} blocks: {clips} "
          f"clips on the CPU; flipped on identical inputs {flips_same} "
          f"(max |card - CPU| of the ALC output {worst_same:.3e}); flipped "
          f"on each side's own modulated IQ {flips_own}", flush=True)
    assert clips > 0 and flips_same == 0, (clips, flips_same)

    # the USB rows' spectrum on the card: image band against wanted band
    an = SpectrumAnalyzer.create(2048, tx.block_tx, device=dev)
    ast = an.init_state(C)
    for iq in out[1:]:
        ast, _ = an.accumulate(ast, iq)
    p = an.power(ast)[0::2].cpu().numpy().astype(np.float64)
    f = an.freqs(192000.0)
    image = np.array([band_db(r, f, -2700.0, -300.0)
                      - band_db(r, f, 300.0, 2700.0) for r in p])
    print(f"  TX USB rows ({len(p)}): image band vs wanted band, worst "
          f"{image.max():.1f} dB, median {np.median(image):.1f} dB "
          "(SpectrumAnalyzer on the card, blocks 1-3)", flush=True)
    assert image.max() <= TX_IMAGE_DB, image.max()
    report["tx_path"] = {"blocks": TX_BLOCKS, "cpu_match_db": snr.tolist(),
                         "alc_clips": clips, "alc_flips_same": flips_same,
                         "alc_flips_own": flips_own,
                         "alc_max_abs_err_same": worst_same,
                         "image_db_worst": float(image.max()),
                         "alc_launches": n_alc, "place_launches": n_place}
    return {"tx": tx, "blocks": blocks, "state": states[1],
            "alc_launches": n_alc}


def count_launches(fn) -> int:
    """CUDA kernels and copies that one call of fn() puts on the device,
    counted in a torch.profiler trace."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False))


def place_timing(dev) -> dict:
    """csrc/tx_place.cu at the benchmark cell's [8192, 4096] (a chain at
    96 kS/s, a tune a row), from a CUDA graph and call by call, beside its
    byte bound (one read and one write of the block) and place_plain's ms,
    the kernel within 1e-6 of place_plain's row peaks."""
    rows, B = TX_PLACE_SHAPE
    tx = TxChain.create(TxChainConfig(channels=rows, audio_block=B // 2,
                                      tx_rate=96000.0, alc=False),
                        device=dev)
    tx = tx.set_tune(-24000.0 + 48000.0 * (np.arange(rows) + 0.5) / rows)
    rng = np.random.default_rng(SEED + 27)
    x = rng.standard_normal((rows, B), dtype=np.float32)
    iq = torch.complex(torch.as_tensor(x, device=dev),
                       torch.as_tensor(x[::-1].copy(), device=dev))
    st = {"tune_phase": tx.tune.init_state(rows)}
    ref = tx.place_plain(dict(st), iq)
    got = tx.place(dict(st), iq)
    rel = float(((got - ref).abs()
                 / ref.abs().amax(-1, keepdim=True)).max())
    assert rel <= 1e-6, rel
    mbytes = 2 * rows * B * 8 / 1e6
    return {"shape": [rows, B], "max_rel_err": rel,
            "ms": graph_ms(lambda: tx.place(dict(st), iq)),
            "call_ms": cuda_ms(lambda: tx.place(dict(st), iq), 20),
            "plain_ms": cuda_ms(lambda: tx.place_plain(dict(st), iq), 10),
            "bound_ms": mbytes * 1e6 / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "mbytes": mbytes, "library_ms": None}


def phase_timing_tx(report: dict, smi: str, txr: dict) -> tuple:
    """The TX step (events, host clock, idle share), its stages on one
    block's real intermediates, the CUDA launches of TxALC (<= 40) and of
    the whole step (<= 200), and the place kernel at [8192, 4096].
    Returns the ALC's [1024, 2048] arguments on that block."""
    tx, blocks, st = txr["tx"], txr["blocks"], txr["state"]
    dev = torch.device(DEVICE)
    ev_ms, host_ms = step_ms(tx, blocks, iters=20, warmup=3)
    msps = C * tx.block_tx / (ev_ms * 1e-3) / 1e6
    # per stage on one block's real intermediates
    x = torch.as_tensor(blocks[1], device=dev)
    s = dict(st)
    a = tx.condition(s, x)
    ac = a.to(torch.complex64)
    _, z = tx.analytic(st["analytic"], ac)
    iq = tx.modulators(dict(st), x, z)
    _, iq_alc = tx.alc(st["alc"], iq)
    _, iq_up = tx.interp(st["interp"], iq_alc)

    def pre_comp():
        _, y = tx.preemph(st["preemph"], x)
        return tx.comp((), y)

    stages = {
        "analytic_fir": cuda_ms(lambda: tx.analytic(st["analytic"], ac), 10),
        "preemphasis_compressor": cuda_ms(pre_comp, 10),
        "modulators": cuda_ms(lambda: tx.modulators(dict(st), x, z), 10),
        "tx_alc": cuda_ms(lambda: tx.alc(st["alc"], iq), 20),
        "interpolator": cuda_ms(lambda: tx.interp(st["interp"], iq_alc), 10),
        "tune_trim": cuda_ms(lambda: tx.place(dict(st), iq_up), 10),
    }
    alc_launches = count_launches(lambda: tx.alc(st["alc"], iq))
    step_launches = count_launches(lambda: tx.step(st, x))
    print(f"timing of the TX path [{smi}]:", flush=True)
    print(f"  TX step {ev_ms:.4f} ms/block (device events), {host_ms:.4f} "
          f"ms/block (host clock), {msps:.1f} Msps out, real-time factor "
          f"{TX_AUDIO_MS / ev_ms:.4f}x of {TX_AUDIO_MS:.2f} ms", flush=True)
    print("  TX stages (ms): " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in stages.items()))
    print(f"  CUDA launches a block: TxALC {alc_launches} (at most "
          f"{ALC_LAUNCHES_MAX}), whole step {step_launches} (at most "
          f"{TX_STEP_LAUNCHES_MAX})", flush=True)
    assert alc_launches <= ALC_LAUNCHES_MAX, alc_launches
    assert step_launches <= TX_STEP_LAUNCHES_MAX, step_launches
    place = place_timing(dev)
    print(f"  tx_place at {place['shape']}: {place['ms']:.4f} ms (from a "
          f"CUDA graph; {place['call_ms']:.4f} call by call), plain "
          f"{place['plain_ms']:.4f} ms, library none, bound "
          f"{place['bound_ms']:.4f} ms by bytes ({place['mbytes']:.1f} MB); "
          f"max |kernel - plain| / row peak {place['max_rel_err']:.3e}",
          flush=True)
    idle = device_idle("TX", tx, blocks, ev_ms, front_kernel=False)
    report["tx_timing"] = {"ms_per_block": ev_ms, "host_ms_per_block":
                           host_ms, "msps_out": msps,
                           "realtime_factor": TX_AUDIO_MS / ev_ms,
                           "stages_ms": stages,
                           "launches_alc": alc_launches,
                           "launches_step": step_launches, "idle": idle,
                           "tx_place": place}
    return tx.alc.scan_inputs(st["alc"], iq)[1]


def loopback_oracle(voice: np.ndarray, fm: bool) -> np.ndarray:
    """What the RX should hear (tests/test_tx.py:101-117): the TX's own
    bandpassed audio; for FM its difference through the 300 Hz
    de-emphasis one-pole."""
    taps = design.bandpass_analytic(513, 300.0, 2700.0, 48000.0)
    _, bp = dsp.fir_stream(voice.astype(np.float64), np.real(taps) * 2.0)
    if not fm:
        return bp
    a = np.exp(-2 * np.pi * 300.0 / 48000.0)
    return sig.lfilter([1 - a], [1.0, -a], np.diff(bp, prepend=0.0))


def phase_loopback(report: dict, rng) -> dict:
    """TX at 192 kS/s (ALC off, as tests/test_tx.py:89) on all 1024 rows,
    USB/FM alternating, into the port's RxChain at 192 kS/s with the front
    kernel at the NFM shape; the voice recovered on rows 0-7."""
    dev = torch.device(DEVICE)
    tx = TxChain.create(dataclasses.replace(tx_config(), alc=False,
                                            compress_db=0.0,
                                            preemphasis=0.0),
                        mode=TX_MODES, device=dev)
    rx = RxChain.create(RxChainConfig(sample_rate=192e3, channels=C,
                                      audio_block=AUDIO_BLOCK, agc=False,
                                      fused_frontend=True,
                                      fm_deviation_hz=2500.0),
                        tune_hz=[0.0] * C, mode=TX_MODES, device=dev)
    assert rx.front is not None and (rx.front.ntaps, rx.front.decim) == (
        133, 4) and rx.block_in == tx.block_tx
    n = LOOP_BLOCKS * AUDIO_BLOCK
    voice = voice_like(rng, n, C, band=(400.0, 2400.0))
    voice = (0.4 * voice / np.max(np.abs(voice), axis=-1, keepdims=True)
             ).astype(np.float32)
    tst, rst = tx.init_state(), rx.init_state()
    iqs, audio = [], []
    reset_launches()
    for i in range(LOOP_BLOCKS):
        tst, iq = tx.step(tst, torch.as_tensor(
            voice[:, i * AUDIO_BLOCK:(i + 1) * AUDIO_BLOCK], device=dev))
        rst, a = rx.step(rst, iq)
        audio.append(a[:8].cpu())
        if i < 2:
            iqs.append(iq.cpu().numpy())
    torch.cuda.synchronize()
    nl = launches()
    print(f"  loopback: {LOOP_BLOCKS} blocks, front launches {nl}",
          flush=True)
    assert nl == {"plain": LOOP_BLOCKS, "gained": 0, "nb": 0}, nl
    aud = torch.cat(audio, dim=-1).numpy()
    assert np.all(np.isfinite(aud))
    snr = [dsp.frac_align_snr(loopback_oracle(voice[r], TX_MODES[r] ==
                                          int(Mode.FM)), aud[r],
                          skip=4 * AUDIO_BLOCK) for r in range(8)]
    print("  loopback voice SNR, rows 0-7 (USB, FM, ...), dB: "
          + ", ".join(f"{v:.1f}" for v in snr), flush=True)
    assert min(snr) > LOOP_SNR_DB, snr
    # kernel #1 on the loopback's own input against its plain version
    kern = check_plain_mode(rx.front, iqs)
    print(f"  loopback kernel #1: launches {nl['plain']}, max |kernel - "
          f"plain| {kern['max_abs_err']:.3e}", flush=True)
    report["loopback"] = {"blocks": LOOP_BLOCKS, "launches": nl,
                          "snr_db": snr,
                          "kernel_max_abs_err": kern["max_abs_err"]}
    return report["loopback"]


def imd_db_of_power(p: np.ndarray, f: np.ndarray) -> float:
    """Third-order IMD (dBc) from a power spectrum: the larger of the
    2f1-f2 / 2f2-f1 peaks against the larger tone (+-3 bins)."""
    def peak(f0):
        k = int(np.argmin(np.abs(f - f0)))
        return float(np.max(p[max(k - 3, 0):k + 4]))
    return float(10 * np.log10(max(peak(-500.0), peak(3100.0))
                               / max(peak(700.0), peak(1900.0))))


def phase_puresignal(report: dict) -> None:
    """The IMD two-tone from a TxChain on the card through SimulatedPA,
    then Predistorter.from_measurement in the chain's slot, then one
    refine: the IMD must fall by > IMD_GAIN_DB, by two_tone_imd_db and by
    the card's SpectrumAnalyzer."""
    dev = torch.device(DEVICE)
    tx = TxChain.create(TxChainConfig(channels=1, alc=False,
                                      predistort=True),
                        mode=int(Mode.IMD), device=dev)
    pa = SimulatedPA()
    an = SpectrumAnalyzer.create(2048, AUDIO_BLOCK, device=dev)
    f = an.freqs(48000.0)

    def on_air(chain, nblk: int = 8):
        st, out = chain.init_state(), []
        silent = torch.zeros((1, AUDIO_BLOCK), device=dev)
        for _ in range(nblk):
            st, iq = chain.step(st, silent)
            out.append(iq)
        return torch.cat(out[2:], dim=-1).cpu().numpy()[0].astype(
            np.complex128)

    def imd(x):
        y = pa(x)
        ast = an.init_state(1)
        for i in range(len(y) // AUDIO_BLOCK):
            ast, _ = an.accumulate(ast, torch.as_tensor(
                y[None, i * AUDIO_BLOCK:(i + 1) * AUDIO_BLOCK], device=dev))
        p = an.power(ast)[0].cpu().numpy().astype(np.float64)
        return two_tone_imd_db(y, 48000.0, 700.0, 1900.0), imd_db_of_power(
            p, f)

    x = on_air(tx)
    before = imd(x)
    pd = Predistorter.from_measurement(x, pa(x), device=dev)
    x1 = on_air(dataclasses.replace(tx, predist=pd))
    first = imd(x1)
    pd2 = pd.refine(x, pa(x1))
    after = imd(on_air(dataclasses.replace(tx, predist=pd2)))
    print(f"  PureSignal IMD through SimulatedPA, dBc (two_tone_imd_db / "
          f"card SpectrumAnalyzer): before {before[0]:.1f} / "
          f"{before[1]:.1f}, calibrated {first[0]:.1f} / {first[1]:.1f}, "
          f"refined {after[0]:.1f} / {after[1]:.1f}", flush=True)
    for k in range(2):
        assert after[k] < before[k] - IMD_GAIN_DB, (before, after)
    report["puresignal"] = {"before": before, "calibrated": first,
                            "refined": after}


def phase_spectrum(report: dict, smi: str, rng) -> None:
    """SpectrumAnalyzer at 1024 channels x 2048 (disjoint and 50%
    overlap) and ZoomSpectrum on the card against the CPU."""
    dev = torch.device(DEVICE)
    n = 3 * AUDIO_BLOCK
    t = np.arange(n) / 48000.0
    f0 = rng.uniform(-20000.0, 20000.0, C)
    x = (np.exp(2j * np.pi * f0[:, None] * t) + 0.1 * (
        rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n)))
         ).astype(np.complex64)
    blocks = [torch.as_tensor(x[:, i * AUDIO_BLOCK:(i + 1) * AUDIO_BLOCK])
              for i in range(3)]
    out, times = {}, {}
    for ov in (0.0, 0.5):
        an = SpectrumAnalyzer.create(2048, AUDIO_BLOCK, window=
                                     "blackman-harris", overlap=ov,
                                     device=dev)
        can = SpectrumAnalyzer.create(2048, AUDIO_BLOCK, window=
                                      "blackman-harris", overlap=ov,
                                      device="cpu")
        st, cst = an.init_state(C), can.init_state(C)
        for b in blocks:
            st, _ = an.accumulate(st, b.to(dev))
            cst, _ = one_thread(lambda: can.accumulate(cst, b))
        p, cp = an.power(st).cpu(), can.power(cst)
        rel = float(((p - cp).abs() / cp.abs()).max())
        sm = an.smeter_power(st, 48000.0, f0 - 500.0, f0 + 500.0).cpu()
        csm = can.smeter_power(cst, 48000.0, f0 - 500.0, f0 + 500.0)
        sm_rel = float(((sm - csm).abs() / csm).max())
        xd = blocks[0].to(dev)
        mf = measure_frequency(xd, 48000.0).cpu()
        cmf = one_thread(lambda: measure_frequency(blocks[0], 48000.0))
        mf_err = float((mf - cmf).abs().max())
        times[f"analyzer_overlap_{ov}"] = cuda_ms(
            lambda: an.accumulate(st, xd), 10)
        print(f"  SpectrumAnalyzer C={C}, fft 2048, overlap {ov}: power max "
              f"rel diff to CPU {rel:.2e}, smeter {sm_rel:.2e}, "
              f"measure_frequency max diff {mf_err:.2e} Hz", flush=True)
        assert rel <= SPEC_POWER_RTOL and sm_rel <= 1e-5, (rel, sm_rel)
        assert mf_err <= 1e-3, mf_err
        assert np.allclose(cmf.numpy(), f0, atol=3.0)
        out[f"overlap_{ov}"] = {"power_rel": rel, "smeter_rel": sm_rel,
                                "freq_diff_hz": mf_err}
    times["measure_frequency"] = cuda_ms(
        lambda: measure_frequency(blocks[0].to(dev), 48000.0), 10)
    # zoom: 16x re-capture around 5 kHz on every row; rows 0-7 vs the CPU
    # in the zoomed passband (|f| <= 0.4 fs/D: the lowpass's flat part)
    zkw = dict(fft_size=256, block=4096, center_hz=5000.0,
               sample_rate=48000.0, decim=16, overlap=0.5)
    zx = (np.exp(2j * np.pi * (5000.0 + rng.uniform(-600, 600, C))[:, None]
                 * np.arange(2 * 4096) / 48000.0)
          + 0.05 * (rng.standard_normal((C, 2 * 4096)) + 1j *
                    rng.standard_normal((C, 2 * 4096)))).astype(np.complex64)
    zm = ZoomSpectrum.create(device=dev, **zkw)
    czm = ZoomSpectrum.create(device="cpu", **zkw)
    zs, czs = zm.init_state(C), czm.init_state(8)
    for i in range(2):
        zb = torch.as_tensor(zx[:, i * 4096:(i + 1) * 4096])
        zs, _ = zm.accumulate(zs, zb.to(dev))
        czs, _ = one_thread(lambda: czm.accumulate(czs, zb[:8]))
    zp, czp = zm.power(zs)[:8].cpu(), czm.power(czs)
    pas = np.abs(zm.freqs(48000.0)) <= 0.4 * 48000.0 / 16
    zrel = float(((zp - czp).abs() / czp.abs())[:, pas].max())
    print(f"  ZoomSpectrum C={C}, 16x at 5 kHz: power max rel diff to CPU "
          f"{zrel:.2e} in the passband ({int(pas.sum())} bins), "
          f"{float(((zp - czp).abs() / czp.abs()).max()):.2e} over all",
          flush=True)
    assert zrel <= SPEC_POWER_RTOL, zrel
    zb = torch.as_tensor(zx[:, :4096], device=dev)
    times["zoom"] = cuda_ms(lambda: zm.accumulate(zs, zb), 10)
    print(f"timing of the spectrum services [{smi}] (ms a block): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    out["zoom_power_rel"] = zrel
    report["spectrum"] = {**out, "ms": times}


# ------------------------------------------------------------------ slice 5
# The PLL demods ride the receive chain's EXT slot (RxChainConfig.ext_demod).
# The chain builds "pll_fm" itself from its configuration (fm_deviation_hz,
# ctcss_hz), as the benchmark's pllnfm192k cell does; sync AM is a factory
# this script registers (MixedDemod.create calls it with (sample_rate,
# channels, device)).
PLL_FM_KW = dict(deviation_hz=5000.0, ctcss_hz=100.0)
SYNC_AM_BW_HZ = 150.0
SYNC_MODES = [int(Mode.USB), int(Mode.LSB), int(Mode.EXT), int(Mode.FM)]
SYNC_MODE = [SYNC_MODES[i % 4] for i in range(C)]
PLL_BLOCKS = 6
# Both chains start from empty histories, and the loops acquire on the
# filters' first, tiny outputs, where cuFFT and the CPU's FFT differ in
# relative terms; the sync-AM DC tracker (pole 0.9995) keeps that for
# thousands of samples.  So the CPU chain starts from the card chain's
# state of rows 0-7 at block PLL_CARRY_AT and runs the rest.
PLL_CARRY_AT = 2
# The kernel against its plain version (the same float32 operations in the
# same order, full-precision cosf / sinf / atan2f): rows with a carrier
# >= 100 dB or within 1e-4 of the peak; a loop on noise alone wraps at
# +-pi, where a one-ulp difference slips a cycle: by RMS within 0.1 dB.
PLL_DB = 100.0
PLL_TOL = 1e-4
# (C, B): C off the kernel's 32-channel block, B = 1, odd B, a tile tail
PLL_SHAPES = ((37, 1), (37, 777), (33, 2048), (70, 64))
PLL_SPLIT = (37, 777, 301)       # one call against two, cut at sample 301
PLL_SRC = "quisk_tpu_torch/csrc/pll_demod.cu"
PLL_WRAPPERS = {"sync_am": pll.pll_sync_am, "pll_fm": pll.pll_fm}
# the edges of the kernel's register tile (B one short of it, it, one past
# it), one channel alone, and one channel past a full grid of its
# 32-channel blocks
PLL_EDGE_SHAPES = ((33, pll.TILE - 1), (33, pll.TILE), (33, pll.TILE + 1),
                   (1, 2048), (1025, 333))
# the earlier design of the kernel (shared-memory tiles of 64 samples
# copied by the whole warp, a block barrier pair a tile, cosf and sinf
# apart, a wrap and clamp that branch) at the paths' [1024, 2048],
# chip_smoke.py on an H100 80GB HBM3 at 700.00 W
PLL_EARLIER_MS = {"sync_am": 0.831, "pll_fm": 0.838}
SYNC_VOICE_DB = 6.0             # sync-AM row 2 against the voice sent
SNB_DB = 90.0
POLS_TAPS, POLS_BLOCK, POLS_BLOCKS = 10001, 512, 4
POLS_TOL = 1e-4
DIV_RTOL = 1e-5


def register_pll_demods() -> None:
    register_ext_demod("sync_am", lambda fs, ch, dev: SyncAMDemod.create(
        fs, bw_hz=SYNC_AM_BW_HZ, device=dev))


def pll_launches() -> dict:
    return {"sync_am": pll.pll_sync_am.launches, "pll_fm": pll.pll_fm.launches}


def rows_state(tree, rows: int, dev):
    """The first ``rows`` channels of a chain state, on ``dev``."""
    if isinstance(tree, dict):
        return {k: rows_state(v, rows, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(rows_state(v, rows, dev) for v in tree)
    return tree[:rows].to(dev)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a and b bit for bit, a NaN matching a NaN in the same place
    (whatever its payload)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32)))


def check_pll(mode: str, x, st, coef, carrier) -> dict:
    """The kernel against its plain version on the same tensors: rows in
    ``carrier`` sample by sample, the others by RMS; the carried states
    alike; then every output and state bit for bit, asserted.  One
    launch."""
    fn = PLL_WRAPPERS[mode]
    n0 = fn.launches
    ks, ky = fn(x, st, coef)
    ps, py = pll.pll_demod_plain(mode, x, st, coef)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1, (mode, fn.launches, n0)
    assert bool(torch.isfinite(ky).all())
    peak = float(py.abs().max())
    err = float((ky - py).abs().max())
    kd, pd = ky.double(), py.double()
    e2 = (kd - pd).pow(2).mean(-1)
    row_db = 10 * torch.log10(pd.pow(2).mean(-1) / e2.clamp_min(1e-300))
    row_err = (kd - pd).abs().max(-1).values
    carrier = torch.as_tensor(carrier, device=x.device)
    ok = (row_db >= PLL_DB) | (row_err <= PLL_TOL * peak)
    assert bool(ok[carrier].all()), (mode, tuple(x.shape),
                                     float(row_db[carrier].min()))
    rms_db = 10 * torch.log10(kd.pow(2).mean(-1) / pd.pow(2).mean(-1))
    noise = ~carrier
    slips = int((noise & ~ok).sum())
    assert bool((rms_db[noise & ~ok].abs() < FM_NOISE_RMS_DB).all()), (
        mode, float(rms_db[noise & ~ok].abs().max()))
    for a, b, c in zip(ks, ps, ("ph", "fr", "dc")):
        d = (a - b).abs()
        assert bool((d[carrier] <= 1e-4 * (1 + b[carrier].abs())).all()), c
    bits = same_bits(ky, py) and all(same_bits(a, b)
                                     for a, b in zip(ks, ps))
    assert bits, (mode, tuple(x.shape), "kernel not bit-equal to plain")
    return {"max_abs_err": err, "peak": peak, "bit_equal": bits,
            "carrier_min_db": float(row_db[carrier].min().clamp(max=999.0)),
            "noise_rows_split": slips}


def pll_test_input(rng, C: int, B: int, mode: str, dev):
    """Noise on every row, a carrier on the even rows (AM, 40 Hz off, or
    FM with a 700 Hz tone), a non-zero state."""
    t = np.arange(B) / 48000.0
    x = 0.1 * (rng.standard_normal((C, B)) + 1j * rng.standard_normal((C, B)))
    if mode == "sync_am":
        car = (1 + 0.5 * np.sin(2 * np.pi * 700 * t)) * np.exp(
            2j * np.pi * 40.0 * t)
    else:
        car = np.exp(1j * 2 * np.pi * 3000.0 / 48000.0 * np.cumsum(
            np.sin(2 * np.pi * 700 * t)))
    x[0::2] += car
    carrier = np.arange(C) % 2 == 0
    ph = rng.uniform(-0.5, 0.5, C)
    st = [torch.as_tensor(ph.astype(np.float32), device=dev),
          torch.zeros(C, dtype=torch.float32, device=dev)]
    if mode == "sync_am":
        st.append(torch.full((C,), 0.9, dtype=torch.float32, device=dev))
    return (torch.as_tensor(x.astype(np.complex64), device=dev), tuple(st),
            carrier)


def pll_ops(dev) -> dict:
    return {"sync_am": SyncAMDemod.create(48000.0, bw_hz=SYNC_AM_BW_HZ,
                                          device=dev),
            "pll_fm": PLLFMDemod.create(48000.0, device=dev, **PLL_FM_KW)}


def phase_pll_kernel(report: dict, rng) -> None:
    """csrc/pll_demod.cu in both modes against its plain version at shapes
    off the paths': C not a multiple of the 32-channel block, B = 1, odd
    B, a last tile of 64; and a block cut in two calls at an odd sample
    equal to one call, bit for bit."""
    dev = torch.device(DEVICE)
    out = {}
    for mode, op in pll_ops(dev).items():
        coef = op.coef()
        fn = PLL_WRAPPERS[mode]
        res = []
        for Cs, Bs in PLL_SHAPES:
            x, st, car = pll_test_input(rng, Cs, Bs, mode, dev)
            r = check_pll(mode, x, st, coef, car)
            print(f"  PLL kernel {mode} C={Cs} B={Bs}: max|kernel-plain| "
                  f"{r['max_abs_err']:.2e} (peak {r['peak']:.3f}), carrier "
                  f"rows >= {r['carrier_min_db']:.1f} dB, bit-equal "
                  f"{r['bit_equal']}, noise rows split "
                  f"{r['noise_rows_split']}", flush=True)
            res.append({"C": Cs, "B": Bs, **r})
        Cs, Bs, cut = PLL_SPLIT
        x, st, _ = pll_test_input(rng, Cs, Bs, mode, dev)
        n0 = fn.launches
        s1, y1 = fn(x, st, coef)
        sa, ya = fn(x[:, :cut], st, coef)
        sb, yb = fn(x[:, cut:], sa, coef)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 3
        assert torch.equal(torch.cat([ya, yb], dim=-1), y1), mode
        assert all(torch.equal(a, b) for a, b in zip(s1, sb)), mode
        print(f"  PLL kernel {mode} C={Cs} B={Bs}: two calls cut at {cut} "
              f"equal one call bit for bit", flush=True)
        out[mode] = res
    report["pll_kernel"] = out


def pll_nfm_config() -> RxChainConfig:
    return dataclasses.replace(nfm_config(), ext_demod="pll_fm",
                               fm_deviation_hz=PLL_FM_KW["deviation_hz"],
                               ctcss_hz=PLL_FM_KW["ctcss_hz"])


def sync_am_config() -> RxChainConfig:
    return dataclasses.replace(flagship_config(), ext_demod="sync_am")


def pll_nfm_blocks(rng, tune, nblk: int, B: int):
    """Every row noise, 1e-4 of it on odd rows (RF under the squelch's -60
    dB: closed); on every even row an FM station (2.5 kHz deviation) of
    seeded voice with a 100 Hz CTCSS tone at 0.15."""
    n = nblk * B
    t = np.arange(n, dtype=np.float64) / FS_NFM
    voice = voice_like(rng, n, 1, band=(300.0, 2500.0), fs=FS_NFM)[0]
    mod = 0.5 * voice + 0.15 * np.sin(2 * np.pi * 100.0 * t)
    dphi = 2 * np.pi * 2500.0 * np.cumsum(mod) / FS_NFM
    blocks = noise_blocks(rng, nblk, B)
    level = np.where(np.arange(C) % 2 == 0, 1.0, 1e-4).astype(np.float32)
    tn = np.asarray(tune)[0::2, None]
    for i, x in enumerate(blocks):
        x *= level[:, None]
        sl = slice(i * B, (i + 1) * B)
        x[0::2] += (3.0 * np.exp(1j * (2 * np.pi * tn * t[sl] + dphi[sl]))
                    ).astype(np.complex64)
    return blocks, voice


def sync_am_blocks(rng, nblk: int, B: int):
    """Noise on every row; on every EXT row an AM station (depth 0.5,
    amplitude 3) of seeded voice, its carrier 40 Hz off the channel's
    dial."""
    n = nblk * B
    voice = voice_like(rng, n, 1, band=(300.0, 2500.0), fs=FS)[0]
    voice = voice / np.abs(voice).max()
    blocks = noise_blocks(rng, nblk, B)
    rows = np.flatnonzero(np.asarray(SYNC_MODE) == int(Mode.EXT))
    f = np.asarray(TUNE)[rows, None] + 40.0
    for i, x in enumerate(blocks):
        t = np.arange(i * B, (i + 1) * B, dtype=np.float64) / FS
        env = 3.0 * (1.0 + 0.5 * voice[i * B:(i + 1) * B])
        ang = np.mod(2 * np.pi * f * t, 2 * np.pi)
        x[rows] += (env * np.exp(1j * ang)).astype(np.complex64)
    return blocks, voice


def run_pll_path(label: str, chain, cpu, blocks, modes, strict_rows):
    """The path on the card for every block (one front, one PLL and one
    mixed demodulator launch a block, and one notch launch on the PLL-NFM
    path), then the CPU chain from the card's rows 0-7 state at block
    PLL_CARRY_AT, compared on rows 0-7."""
    reset_launches()
    st = chain.init_state()
    audio, mid = [], None
    for i, x in enumerate(blocks):
        if i == PLL_CARRY_AT:
            mid = rows_state(st, 8, torch.device("cpu"))
        st, a = chain.step(st, torch.as_tensor(x, device=chain.device))
        audio.append(a)
    torch.cuda.synchronize()
    n, npll = launches(), pll_launches()
    print(f"  {label}: {len(blocks)} blocks, front launches {n}, PLL "
          f"launches {npll}, mixed demod launches {mixed_demod.launches}",
          flush=True)
    mode = "pll_fm" if isinstance(chain.demod.ext, PLLFMDemod) else "sync_am"
    assert n == {"plain": len(blocks), "gained": 0, "nb": 0}, n
    assert npll == {"sync_am": 0, "pll_fm": 0, mode: len(blocks)}, npll
    assert mixed_demod.launches == len(blocks), mixed_demod.launches
    # the CTCSS notch: one biquad launch a block where the path has one
    notched = mode == "pll_fm" and chain.demod.ext.notch is not None
    assert biquad_df1.launches == (len(blocks) if notched else 0), \
        biquad_df1.launches
    for a in audio:
        assert a.shape == (C, AUDIO_BLOCK) and bool(torch.isfinite(a).all())

    def cpu_run():
        s, out = mid, []
        for x in blocks[PLL_CARRY_AT:]:
            s, a = cpu.step(s, torch.as_tensor(x[:8]))
            out.append(a)
        return out

    cpu_audio = one_thread(cpu_run)
    match = compare_with_cpu(audio[PLL_CARRY_AT:], cpu_audio, modes[:8], 0,
                             CPU_MATCH_DB, label, strict_rows=strict_rows)
    return st, audio, {"launches": n, "pll_launches": npll,
                       "biquad_launches": biquad_df1.launches,
                       "mixed_demod_launches": mixed_demod.launches,
                       "cpu_match": match}


def phase_pll_paths(report: dict, rng) -> dict:
    """The PLL-NFM receiver (nfm_config, every row EXT with pll_fm) and the
    sync-AM flagship (flagship_config, modes USB/LSB/EXT/FM with sync_am)
    at 1024 channels against the CPU chain on rows 0-7, what they hear,
    and the PLL kernel against its plain version on each path's own
    [1024, 2048] demod input."""
    dev = torch.device(DEVICE)
    register_pll_demods()
    tune_nfm = [(-FS_NFM / 4 + (i + 0.5) * FS_NFM / (2 * C))
                for i in range(C)]
    nfm = RxChain.create(pll_nfm_config(), tune_hz=tune_nfm,
                         mode=int(Mode.EXT), device=dev)
    assert isinstance(nfm.demod.ext, PLLFMDemod) and nfm.front.decim == 4
    assert nfm.demod.ext.notch is not None
    n_blocks, voice = pll_nfm_blocks(rng, tune_nfm, PLL_BLOCKS,
                                     nfm.block_in)
    cpu = RxChain.create(dataclasses.replace(pll_nfm_config(), channels=8),
                         tune_hz=tune_nfm[:8], mode=int(Mode.EXT),
                         device="cpu")
    nst, naudio, nres = run_pll_path("PLL-NFM", nfm, cpu, n_blocks,
                                     [int(Mode.EXT)] * C, ())
    m = nres["cpu_match"]
    assert m["sample_by_sample"] >= 4 * (PLL_BLOCKS - PLL_CARRY_AT), m
    hold = nst["fm_sq"][0]
    assert bool((hold[0::2] > 0).all()) and bool((hold[1::2] == 0).all())
    assert bool((naudio[-1][1::2] == 0).all())
    # what row 0 hears: the CTCSS tone notched under the voice
    a0 = torch.cat([a[0] for a in naudio[2:]]).cpu().numpy()
    f = np.fft.rfftfreq(a0.size, 1.0 / nfm.fs_audio)
    A = np.abs(np.fft.rfft(a0 * np.hanning(a0.size)))
    ctcss = A[np.abs(f - 100.0) < 3.0].max()
    voice_band = A[(f > 300.0) & (f < 2500.0)].mean()
    print(f"  PLL-NFM row 0: CTCSS line {20 * np.log10(ctcss / voice_band):.1f}"
          f" dB against the mean voice-band bin", flush=True)
    assert ctcss < voice_band, (ctcss, voice_band)
    nres["ctcss_vs_voice_db"] = float(20 * np.log10(ctcss / voice_band))

    sync = RxChain.create(sync_am_config(), tune_hz=TUNE, mode=SYNC_MODE,
                          device=dev)
    assert isinstance(sync.demod.ext, SyncAMDemod)
    s_blocks, s_voice = sync_am_blocks(rng, PLL_BLOCKS, sync.block_in)
    cpu = RxChain.create(dataclasses.replace(sync_am_config(), channels=8),
                         tune_hz=TUNE[:8], mode=SYNC_MODE[:8], device="cpu")
    sst, saudio, sres = run_pll_path("sync-AM flagship", sync, cpu, s_blocks,
                                     SYNC_MODE, ())
    m = sres["cpu_match"]
    assert m["sample_by_sample"] >= 6 * (PLL_BLOCKS - PLL_CARRY_AT), m
    # what row 2 hears: the voice (300-2500 Hz on both sides, the audio
    # ~1270 samples late; the AGC's varying gain bounds the figure)
    sos = sig.butter(4, (300.0, 2500.0), btype="bandpass", fs=48000.0,
                     output="sos")
    a2 = sig.sosfiltfilt(sos, torch.cat([a[2] for a in saudio]).cpu().numpy())
    v = sig.sosfiltfilt(sos, s_voice.reshape(-1, 20).mean(-1))
    snr = dsp.frac_align_snr(v, a2, max_lag=2048, skip=2 * AUDIO_BLOCK)
    print(f"  sync-AM row 2: voice recovered at {snr:.1f} dB", flush=True)
    assert snr > SYNC_VOICE_DB, snr
    sres["voice_snr_db"] = snr

    # the kernel on each path's own demod input (the block after the run)
    kern = {}
    for label, chain, st, x in (("pll_fm", nfm, nst, n_blocks[0]),
                                ("sync_am", sync, sst, s_blocks[0])):
        xd = torch.as_tensor(x, device=dev)
        _, y = chain.front(st["front"], xd)
        _, y = chain.bp(st["bp"], y)
        ext_st = tuple(st["demod"][2][:3 if label == "sync_am" else 2])
        carrier = (np.arange(C) % 2 == 0 if label == "pll_fm" else
                   np.asarray(SYNC_MODE) == int(Mode.EXT))
        t0 = time.perf_counter()
        r = check_pll(label, y, ext_st, chain.demod.ext.coef(), carrier)
        # exact zeros reach atan2f's divide where x is 0: count them here
        # and on the first block after an empty history
        st0 = chain.init_state()
        _, y0 = chain.front(st0["front"], xd)
        _, y0 = chain.bp(st0["bp"], y0)
        r["zero_samples"] = int((y == 0).sum())
        r["zero_samples_first_block"] = int((y0 == 0).sum())
        print(f"  PLL kernel {label} on the path's input [{C}, "
              f"{y.shape[1]}]: max|kernel-plain| {r['max_abs_err']:.2e} "
              f"(peak {r['peak']:.3f}), carrier rows >= "
              f"{r['carrier_min_db']:.1f} dB, bit-equal {r['bit_equal']}, "
              f"noise rows split {r['noise_rows_split']}; exact-zero "
              f"samples {r['zero_samples']} (from an empty history "
              f"{r['zero_samples_first_block']}) (check "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        kern[label] = {**r, "x": y, "st": ext_st,
                       "coef": chain.demod.ext.coef()}
    report["pll_nfm_path"] = nres
    report["sync_am_path"] = sres
    return {"nfm": nfm, "nfm_blocks": n_blocks, "sync": sync,
            "sync_blocks": s_blocks, "kern": kern,
            "launches": {"pll_fm": nres["pll_launches"]["pll_fm"],
                         "sync_am": sres["pll_launches"]["sync_am"],
                         "biquad": nres["biquad_launches"],
                         "mixed_demod": {
                             "PLL-NFM": nres["mixed_demod_launches"],
                             "sync-AM": sres["mixed_demod_launches"]}}}


def pll_bound(C_: int, B: int, mode: str) -> dict:
    """x read once (8 B a sample), y written once (4 B), the state read
    and written, coef; operations: the step's float32 arithmetic (complex
    product 6, loop update 7, wrap 2, output 4 for sync AM and 2 for FM)
    plus cos, sin and atan2 counted one each."""
    n_state = 3 if mode == "sync_am" else 2
    nbytes = C_ * B * 12 + 2 * n_state * C_ * 4 + 16
    flops = C_ * B * (3 + 6 + 7 + 2 + (4 if mode == "sync_am" else 2))
    return bound(nbytes, flops)


def phase_timing_pll(report: dict, smi: str, paths: dict) -> dict:
    """Both paths' steps (events, host clock, idle share), the PLL-NFM
    step's stages by CUDA events, and the kernel in both modes at the
    paths' shape with its plain version and bound."""
    dev = torch.device(DEVICE)
    out = {}
    for label, chain, blocks, budget in (
            ("PLL-NFM", paths["nfm"], paths["nfm_blocks"], 
             paths["nfm"].block_in / FS_NFM * 1e3),
            ("sync-AM flagship", paths["sync"], paths["sync_blocks"],
             paths["sync"].block_in / FS * 1e3)):
        ms, host = step_ms(chain, blocks, 20)
        idle = device_idle(label, chain, blocks, ms)
        print(f"  {label} step {ms:.4f} ms/block (device events), "
              f"{host:.4f} ms/block (host clock), real-time factor "
              f"{budget / ms:.2f}x of {budget:.2f} ms", flush=True)
        out[label] = {"ms_per_block": ms, "host_ms_per_block": host,
                      "realtime_factor": budget / ms, "idle": idle}
    # the PLL-NFM step's stages by CUDA events, each on this block's real
    # intermediates (as phase_main_path times the flagship's)
    nfm = paths["nfm"]
    x = torch.as_tensor(paths["nfm_blocks"][0], device=dev)
    st = nfm.init_state()
    _, y_front = nfm.front(st["front"], x)
    _, y_bp = nfm.bp(st["bp"], y_front)
    rf = nfm.fm_sq.measure(y_bp)
    _, aud = nfm.demod(st["demod"], y_bp)
    _, a_agc = nfm.agc(st["agc"], aud)
    stages = {
        "front kernel": cuda_ms(lambda: nfm.front(st["front"], x), 10),
        "channel filter": cuda_ms(lambda: nfm.bp(st["bp"], y_front), 10),
        "demod (PLL FM kernel)": cuda_ms(
            lambda: (nfm.fm_sq.measure(y_bp),
                     nfm.demod(st["demod"], y_bp)), 10),
        "agc": cuda_ms(lambda: nfm.agc(st["agc"], aud), 10),
        "fm squelch": cuda_ms(lambda: nfm.fm_sq(st["fm_sq"], a_agc, rf), 10),
    }
    print("  PLL-NFM stages by CUDA events:\n    " + "\n    ".join(
        f"{k:24s} {v:8.3f} ms/block" for k, v in stages.items()), flush=True)
    out["PLL-NFM"]["stages_ms"] = stages
    # the EXT demod's parts and the whole mixed demod, by CUDA events
    k = paths["kern"]["pll_fm"]
    ext, x = nfm.demod.ext, k["x"]
    est = ext.init_state(C)
    _, w = pll.pll_fm(x, k["st"], k["coef"])
    dst = nfm.init_state()["demod"]
    parts = {"pll kernel": cuda_ms(lambda: pll.pll_fm(x, k["st"], k["coef"]),
                                   10),
             "de-emphasis": cuda_ms(lambda: ext.deemph(est[2], w), 10),
             "ctcss notch": cuda_ms(lambda: ext.notch(est[3], w), 10),
             "mixed demod": cuda_ms(lambda: nfm.demod(dst, x), 10)}
    print("  PLL-NFM demod parts by CUDA events (ms): " + ", ".join(
        f"{n} {v:.4f}" for n, v in parts.items()), flush=True)
    out["PLL-NFM"]["demod_parts_ms"] = parts
    times = {}
    for mode, k in paths["kern"].items():
        fn = PLL_WRAPPERS[mode]
        x, s, coef = k["x"], k["st"], k["coef"]
        t = {"ms": cuda_ms(lambda: fn(x, s, coef), 20),
             "plain_ms": cuda_ms(lambda: pll.pll_demod_plain(mode, x, s,
                                                              coef),
                                 2, warmup=1),
             **pll_bound(x.shape[0], x.shape[1], mode), "library_ms": None}
        print(f"  pll_demod {mode} [{x.shape[0]}, {x.shape[1]}]: "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.1f} ms, library "
              f"none, bound {t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['mbytes']:.1f} MB, {t['gflop']:.3f} GFLOP)", flush=True)
        times[mode] = t
    out["kernel"] = times
    report["timing_pll"] = out
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {m: {k: t[k] for k in keys} for m, t in times.items()}


BIQUAD_SHAPES = ((1024, AUDIO_BLOCK), (8192, AUDIO_BLOCK))


def biquad_bound(rows: int, B: int) -> dict:
    """The notch's block: the audio read and the output written (4 B a
    sample each), the state read and written; operations 9 a sample (the
    feedforward product and two fma, the two fma of the feedback, the two
    conversions), float64, counted at the float32 peak like the others
    (the bytes bind either way: at float64's 34 TFLOP/s, 0.0044 ms at
    [8192, 2048])."""
    return bound(rows * (2 * B + 8) * 4, rows * B * 9)


def phase_biquad(report: dict, smi: str) -> dict:
    """csrc/biquad.cu (the PLL-NFM path's CTCSS notch) against Biquad.plain
    on the card at [1024, 2048] and [8192, 2048] over 3 chained blocks,
    both routes from the kernel's state each block (a float32 state an ulp
    apart rings through this pole pair's next ~800 samples), and timed
    there beside the plain route and its byte bound."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 14)
    op = Biquad.notch(100.0, 48000.0, dev, q=5.0)
    print(f"the CTCSS notch's kernel [{smi}]:", flush=True)
    out = {}
    for rows, B in BIQUAD_SHAPES:
        t = torch.arange(B, device=dev) / 48000.0
        st = op.init_state(rows)
        worst = {"rel": 0.0, "abs": 0.0, "db": np.inf}
        n0 = biquad_df1.launches
        for _ in range(3):
            x = (0.5 * torch.sin(2 * np.pi * 100.0 * t)
                 + 0.3 * torch.as_tensor(rng.standard_normal(
                     (rows, B), dtype=np.float32), device=dev))
            (sk, yk), (sp, yp) = op(st, x), op.plain(st, x)
            assert torch.equal(sk[0], sp[0]) and torch.equal(sk[1], sp[1])
            peak = yp.abs().amax(-1, keepdim=True)
            worst["rel"] = max(worst["rel"],
                               float(((yk - yp).abs() / peak).max()))
            worst["abs"] = max(worst["abs"], float((yk - yp).abs().max()))
            worst["db"] = min(worst["db"], snr_db(yp, yk))
            st = sk
        torch.cuda.synchronize()
        assert biquad_df1.launches == n0 + 3
        assert worst["rel"] <= 2e-7 and worst["db"] >= 130.0, worst
        t = {"ms": graph_ms(lambda: op(st, x)),
             "call_ms": cuda_ms(lambda: op(st, x), 20),
             "plain_ms": cuda_ms(lambda: op.plain(st, x), 5),
             **biquad_bound(rows, B), "library_ms": None}
        print(f"  biquad_df1 at [{rows}, {B}]: output within "
              f"{worst['rel']:.3e} of the row peak ({worst['db']:.1f} dB) "
              f"of the plain route over 3 blocks; {t['ms']:.4f} ms "
              f"(from a CUDA graph; {t['call_ms']:.4f} call by call), plain "
              f"{t['plain_ms']:.4f} ms, library none, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['mbytes']:.1f} MB, {t['gflop']:.3f} GFLOP)", flush=True)
        out[f"{rows}x{B}"] = {"max_rel_err": worst["rel"],
                              "max_abs_err": worst["abs"],
                              "snr_db": worst["db"], **t}
    report["biquad"] = out
    return out


def check_pll_bits(mode: str, x, st, coef) -> dict:
    """The kernel against its plain version on the same tensors: every
    output and carried state bit for bit (a NaN where the plain version
    has one), asserted.  One launch."""
    fn = PLL_WRAPPERS[mode]
    n0 = fn.launches
    ks, ky = fn(x, st, coef)
    ps, py = pll.pll_demod_plain(mode, x, st, coef)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1, (mode, fn.launches, n0)
    assert same_bits(ky, py), (mode, tuple(x.shape), "audio")
    for a, b, name in zip(ks, ps, ("ph", "fr", "dc")):
        assert same_bits(a, b), (mode, tuple(x.shape), name)
    fin = torch.isfinite(py)
    err = float((ky - py)[fin].abs().max()) if bool(fin.any()) else 0.0
    return {"max_abs_err": err, "bit_equal": True,
            "nan_samples": int((~fin).sum())}


def pll_views(x: torch.Tensor) -> dict:
    """x's samples in rows that are not all 16-byte aligned (the kernel's
    16-byte copies then give way to one a sample): rows 777 samples into
    rows of B + 780 (every row 8 bytes off 16 at B = 2048), rows 2 samples
    into rows of B + 3 (every other row 8 bytes off), and rows of stride
    B + 1."""
    B = x.shape[1]
    pad = torch.nn.functional.pad
    return {"cut 777": pad(x, (777, 3))[:, 777:777 + B],
            "cut 2": pad(x, (2, 1))[:, 2:2 + B],
            "stride B+1": pad(x, (0, 1))[:, :B]}


def pll_special_case(rng, mode: str, dev, C_: int = 70, B: int = 777):
    """pll_test_input's rows with, on the first warp's rows: a NaN sample
    (row 1, at B//3), exact zeros (row 7), the first 100 samples zero as
    after an empty history (row 9), constant 1, 1j and -1 from ph = fr = 0
    (rows 11, 13, 15: vi, vr or both exact zeros sample after sample), an
    infinite first sample from ph = 0 (row 17: one operand of atan2 NaN),
    (0, -inf) at sample 5 (row 19), and magnitudes over the whole float32
    range (row 21: the divide off its fast range); on the second warp's: a
    state with |ph| ~ 2e5 (row 33: sincosf's large-argument path) and |ph|
    ~ 1.9e5 with fr far past max_freq (row 35); and a NaN sample on the
    last, partial warp (row 65)."""
    x, st, _ = pll_test_input(rng, C_, B, mode, dev)
    ph, fr = st[0].clone(), st[1].clone()
    for r in (1, 65):
        x[r, B // 3] = float("nan")
    x[7] = 0
    x[9, :100] = 0
    for r, v in ((11, 1.0), (13, 1j), (15, -1.0), (17, 1.0)):
        x[r] = v
        ph[r] = fr[r] = 0.0
    x[17, 0] = float("inf")
    x[19, 5] = complex(0.0, float("-inf"))
    mag = 10 ** rng.uniform(-44.0, 38.0, (2, B)) * rng.choice([-1.0, 1.0],
                                                               (2, B))
    x[21] = torch.as_tensor((mag[0] + 1j * mag[1]).astype(np.complex64))
    ph[33] = 2.0e5 + float(rng.uniform(0.0, 1.0))
    ph[35], fr[35] = -1.9e5, 3.0e6
    return x, (ph, fr) + tuple(st[2:])


def pll_atan2_case(rng, C_: int, B: int, dev):
    """PLL-FM arguments under which the audio is err = atan2(vi, vr) itself
    (alpha 1, beta 0, max_freq 0, gain 1, from ph = fr = 0): rows whose
    real and imaginary parts are drawn apart over the whole float32 range
    (1e-44 .. 1e38, denormals among them), rows nearly real and rows
    nearly imaginary (the other part 1e-45 .. 0.1 of it: the loop's ph
    then stays near 0 and vi / vr spans every ratio down to a denormal
    quotient), so the kernel's atan2 is held to torch's, its divide on and
    off its fast range."""
    kind = np.arange(C_) % 3
    big = 10 ** rng.uniform(-44.0, 38.0, (C_, B))
    tiny = 10 ** rng.uniform(-45.0, -1.0, (C_, B))
    unit = 1.0 + np.abs(rng.standard_normal((C_, B)))
    re = np.where(kind[:, None] == 0, big, np.where(kind[:, None] == 1, unit,
                                                     tiny * unit))
    im = np.where(kind[:, None] == 0, 10 ** rng.uniform(-44.0, 38.0, (C_, B)),
                  np.where(kind[:, None] == 1, tiny * unit, unit))
    sign = rng.choice([-1.0, 1.0], (2, C_, B))
    x = (sign[0] * re + 1j * sign[1] * im).astype(np.complex64)
    st = tuple(torch.zeros(C_, dtype=torch.float32, device=dev)
               for _ in range(2))
    coef = torch.tensor([1.0, 0.0, 0.0, 1.0], dtype=torch.float32,
                        device=dev)
    return torch.as_tensor(x, device=dev), st, coef


def pll_trig_case(rng, C_: int, B: int, dev):
    """Sync-AM arguments under which the audio is cos(ph) (rows of x = 1)
    or -sin(ph) (x = -1j), ph stepping by its row's fr (alpha = beta = 0,
    max_freq pi, dc_pole 1, dc 0): the first half of the rows from |ph| <
    pi, the second from |ph| in 1e5 .. 1e7 (sincosf's large-argument
    path), so the kernel's sincosf is held to torch's cos and sin at C_*B
    angles."""
    x = torch.ones((C_, B), dtype=torch.complex64, device=dev)
    x[1::2] = -1j
    ph = rng.uniform(-np.pi, np.pi, C_)
    half = C_ // 2
    ph[half:] = (rng.choice([-1.0, 1.0], C_ - half)
                 * 10 ** rng.uniform(5.0, 7.0, C_ - half))
    st = tuple(torch.as_tensor(v.astype(np.float32), device=dev)
               for v in (ph, rng.uniform(-np.pi, np.pi, C_), np.zeros(C_)))
    coef = torch.tensor([0.0, 0.0, pll.PI32, 1.0], dtype=torch.float32,
                        device=dev)
    return x, st, coef


def sm_clock_mhz() -> float:
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def pll_edges(report: dict, smi: str) -> None:
    """The PLL kernel's own edges, from an RNG stream of their own (SEED +
    7): the tile's edges, C = 1 and one channel past a full grid
    (PLL_EDGE_SHAPES), rows not 16-byte aligned (pll_views), the special
    rows of pll_special_case (the NaN row's carried ph and fr NaN in the
    plain version, and so in the kernel), the kernel's sine and cosine
    against torch's cos and sin (pll_trig_case) and its atan2 against
    torch's (pll_atan2_case), and [1024, 2048] of exact zeros, each
    bit-equal as
    check_pll_bits holds it; then each mode's time at C = 1, at C = 32 on
    32 distinct rows and on 32 copies of one row, and on the zeros, beside
    its time on the path's [1024, 2048] (phase 22), the earlier design's,
    the byte bound and the estimates of its tile loop's dependent chain and
    in-order issue from the kernel's SASS."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 7)
    mhz = sm_clock_mhz()
    from probe_pll import sass_functions
    cycles = pll_tile_estimates(
        sass_functions(_kernels._target("pll_demod"))[1])
    timing = report["timing_pll"]["kernel"]
    print(f"the PLL kernel's edges [{smi}]:", flush=True)
    sweeps = {"trig sweep": check_pll_bits(
        "sync_am", *pll_trig_case(rng, C, AUDIO_BLOCK, dev)),
              "atan2 sweep": check_pll_bits(
        "pll_fm", *pll_atan2_case(rng, C, AUDIO_BLOCK, dev))}
    print(f"  sincosf against torch's cos and sin at {C * AUDIO_BLOCK} "
          f"angles (half of them past 1e5), and atan2 against torch's at "
          f"{C * AUDIO_BLOCK} operand pairs over the whole float32 range: "
          f"bit-equal", flush=True)
    for mode, fn in PLL_WRAPPERS.items():
        coef = pll_ops(dev)[mode].coef()
        res = dict(sweeps)
        for Cs, Bs in PLL_EDGE_SHAPES:
            x, st, _ = pll_test_input(rng, Cs, Bs, mode, dev)
            res[f"({Cs}, {Bs})"] = check_pll_bits(mode, x, st, coef)
        x, st, _ = pll_test_input(rng, 33, AUDIO_BLOCK, mode, dev)
        for label, xv in pll_views(x).items():
            res[label] = check_pll_bits(mode, xv, st, coef)
        x, st = pll_special_case(rng, mode, dev)
        res["special rows"] = check_pll_bits(mode, x, st, coef)
        ps, _ = pll.pll_demod_plain(mode, x, st, coef)
        assert bool(torch.isnan(ps[0][1]) & torch.isnan(ps[1][1])), mode
        x, st, _ = pll_test_input(rng, C, AUDIO_BLOCK, mode, dev)
        zeros = (torch.zeros_like(x), st)
        res["zeros"] = check_pll_bits(mode, *zeros, coef)
        print(f"  pll_demod {mode} at (C, B) "
              + ", ".join(k for k in res if k.startswith("("))
              + ", on rows cut 777 and 2 samples in and of stride B+1, on "
              f"the special rows (NaN, |ph| ~ 2e5, zeros, constants, "
              f"infinities, every magnitude) and "
              f"on [{C}, {AUDIO_BLOCK}] of zeros: every output and state "
              f"bit-equal (the NaN row's ph and fr NaN in both), max "
              f"|kernel - plain| "
              f"{max(r['max_abs_err'] for r in res.values()):.3e}",
              flush=True)
        x32, s32, _ = pll_test_input(rng, 32, AUDIO_BLOCK, mode, dev)
        runs = {"C=1": pll_test_input(rng, 1, AUDIO_BLOCK, mode, dev)[:2],
                "C=32 distinct": (x32, s32),
                "C=32 identical": (x32[:1].repeat(32, 1),
                                   tuple(s[:1].repeat(32) for s in s32)),
                f"zeros [{C}, {AUDIO_BLOCK}]": zeros}
        ms = {label: cuda_ms(lambda: fn(xr, sr, coef), 20)
              for label, (xr, sr) in runs.items()}
        keys = ("chain_cycles_a_sample", "in_order_cycles_a_sample")
        est = {k: cycles[mode][k] * AUDIO_BLOCK / (mhz * 1e3) for k in keys}
        o = timing[mode]
        print(f"  pll_demod {mode}: [{C}, {AUDIO_BLOCK}] {o['ms']:.4f} ms "
              f"(earlier design {PLL_EARLIER_MS[mode]:.4f}), byte bound "
              f"{o['bytes_ms']:.4f} ms, SASS chain "
              f"{est['chain_cycles_a_sample']:.4f} ms "
              f"({cycles[mode]['chain_cycles_a_sample']:.2f} cycles a "
              f"sample; in-order {est['in_order_cycles_a_sample']:.4f} ms, "
              f"{cycles[mode]['in_order_cycles_a_sample']:.2f} cycles, at "
              f"{mhz:.0f} MHz; branches a sample on the hot path "
              f"{cycles[mode]['branches_a_sample']}); " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
        o.update(edges=res, ms_by_rows=ms, earlier_ms=PLL_EARLIER_MS[mode],
                 sass_cycles=cycles[mode], sass_ms=est, sm_clock_mhz=mhz)


def phase_slice5_ops(report: dict, smi: str, rng) -> None:
    """The spectral blanker, the partitioned OLS filter and the diversity
    combiner at 1024 channels against the CPU (rows 0-7, or all), timed."""
    dev = torch.device(DEVICE)
    out, times = {}, {}
    # SNB: tones + noise, impulses on every 7th row, 3 blocks
    snb = SpectralNoiseBlanker.create(AUDIO_BLOCK, device=dev)
    csnb = SpectralNoiseBlanker.create(AUDIO_BLOCK, device="cpu")
    n = 3 * AUDIO_BLOCK
    t = np.arange(n) / 48000.0
    a = (np.sin(2 * np.pi * rng.uniform(300, 3000, (C, 1)) * t)
         + 0.1 * rng.standard_normal((C, n))).astype(np.float32)
    imp = np.arange(0, C, 7)
    for r in imp:
        for h in rng.integers(0, n - 8, 6):
            a[r, h:h + 8] += 30.0 * rng.standard_normal(8)
    st, cst = snb.init_state(C), csnb.init_state(8)
    worst, left = [], np.zeros(8, bool)
    for i in range(3):
        blk = torch.as_tensor(a[:, i * AUDIO_BLOCK:(i + 1) * AUDIO_BLOCK])
        ratio = snb.frame_ratio(st, blk.to(dev))[:8].cpu()
        left |= ((ratio - 1).abs() < 1e-4).any(-1).numpy()
        st, y = snb(st, blk.to(dev))
        cst, cy = one_thread(lambda: csnb(cst, blk[:8]))
        for r in np.flatnonzero(~left):
            worst.append(snr_db(cy[r].double(), y[r].cpu().double()))
        assert bool(torch.isfinite(y).all())
    yl = y[imp].abs().max(-1).values.cpu()
    print(f"  SpectralNoiseBlanker C={C}, fft 256: rows 0-7 against the CPU "
          f">= {min(worst):.1f} dB ({int(left.sum())} rows with a frame at "
          f"the threshold left out), impulse rows' last-block peak "
          f"{float(yl.max()):.2f}", flush=True)
    assert min(worst) >= SNB_DB and left.sum() <= 1, (min(worst), left)
    assert float(yl.max()) < 3.0
    xb = torch.as_tensor(a[:, :AUDIO_BLOCK], device=dev)
    times["snb"] = cuda_ms(lambda: snb(st, xb), 10)
    out["snb"] = {"cpu_min_db": min(worst), "rows_left_out": int(left.sum())}
    # PartitionedOLS: 10001 taps at a 512-sample block (20 partitions, FDL
    # [1024, 20, 1024] complex64 = 168 MB) against OverlapSaveFIR on the
    # card and the CPU on rows 0-7
    taps = design.bandpass_analytic(POLS_TAPS, 300.0, 2800.0, 48000.0)
    po = PartitionedOLS.create(taps, POLS_BLOCK, device=dev)
    ols = OverlapSaveFIR.create(taps, POLS_BLOCK, device=dev)
    cpo = PartitionedOLS.create(taps, POLS_BLOCK, device="cpu")
    nb = POLS_BLOCKS * POLS_BLOCK
    x = (rng.standard_normal((C, nb)) + 1j * rng.standard_normal((C, nb))
         ).astype(np.complex64)
    ps, os_, cs = po.init_state(C), ols.init_state(C), cpo.init_state(8)
    e_ols = e_cpu = 0.0
    for i in range(POLS_BLOCKS):
        xb = torch.as_tensor(x[:, i * POLS_BLOCK:(i + 1) * POLS_BLOCK])
        ps, yp = po(ps, xb.to(dev))
        os_, yo = ols(os_, xb.to(dev))
        cs, yc = one_thread(lambda: cpo(cs, xb[:8]))
        e_ols = max(e_ols, float((yp - yo).abs().max()))
        e_cpu = max(e_cpu, float((yp[:8].cpu() - yc).abs().max()))
    print(f"  PartitionedOLS C={C}, {POLS_TAPS} taps, block {POLS_BLOCK} "
          f"({po.P} partitions, FDL {ps[1].numel() * 8 / 1e6:.0f} MB): "
          f"max|diff| to OverlapSaveFIR {e_ols:.2e}, to the CPU (rows 0-7) "
          f"{e_cpu:.2e}", flush=True)
    assert e_ols < POLS_TOL and e_cpu < POLS_TOL, (e_ols, e_cpu)
    xb = torch.as_tensor(x[:, :POLS_BLOCK], device=dev)
    times["partitioned_ols"] = cuda_ms(lambda: po(ps, xb), 10)
    times["overlap_save_same_taps"] = cuda_ms(lambda: ols(os_, xb), 10)
    out["partitioned_ols"] = {"max_diff_ols": e_ols, "max_diff_cpu": e_cpu}
    # diversity: a signal and a 5x interferer on two coherent streams per
    # row, null-steering weights from an interferer-only snapshot
    nd = AUDIO_BLOCK
    tt = np.arange(nd)
    ph = rng.uniform(0, 2 * np.pi, (C, 1))
    sig_ = np.exp(2j * np.pi * 0.01 * tt)
    itf = 5.0 * np.exp(2j * np.pi * 0.07 * tt)
    noise = 0.05 * (rng.standard_normal((C, 2, nd))
                    + 1j * rng.standard_normal((C, 2, nd)))
    xd = np.stack([sig_ + itf + 0 * ph, 0.8 * np.exp(0.4j) * sig_
                   + itf * np.exp(1j * ph)], axis=1) + noise
    xd = xd.astype(np.complex64)
    w = diversity.null_steering_weights(
        np.stack([np.broadcast_to(itf, (C, nd)), itf * np.exp(1j * ph)],
                 axis=1).astype(np.complex64))
    div = diversity.DiversityCombiner.create(C, device=dev).set_weights(w)
    cdiv = diversity.DiversityCombiner.create(C, device="cpu").set_weights(w)
    xt = torch.as_tensor(xd)
    _, yd = div((), xt.to(dev))
    _, cyd = cdiv((), xt)
    rel = float((yd.cpu() - cyd).abs().max() / cyd.abs().max())
    Y = np.abs(np.fft.fft(yd[0].cpu().numpy()))
    f = np.fft.fftfreq(nd)
    supp = float(Y[np.argmin(np.abs(f - 0.07))]
                 / Y[np.argmin(np.abs(f - 0.01))])
    print(f"  DiversityCombiner [{C}, 2, {nd}]: max rel diff to the CPU "
          f"{rel:.2e}; row 0 interferer/signal after the null {supp:.4f}",
          flush=True)
    assert rel < DIV_RTOL and supp < 0.1, (rel, supp)
    xdd = xt.to(dev)
    times["diversity"] = cuda_ms(lambda: div((), xdd), 20)
    out["diversity"] = {"max_rel_diff": rel, "interferer_over_signal": supp}
    print(f"timing of the slice-5 ops [{smi}] (ms a call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()), flush=True)
    report["slice5_ops"] = {**out, "ms": times}


# ------------------------------------------------ slice 7a: the host edge
FEED_BLOCKS = 16
FEED_DISTINCT = 4          # distinct pinned blocks, cycled
USER_BLOCKS = 12
USER_RETUNE_AT = 6
RADIO_CPU_DB = 90.0        # card Radio vs CPU Radio, audio a block
WIDE_BLOCKS = 8
WIDE_TONE_HZ = 10000.0     # the sim hardware's tone
RADIO_TX_BLOCKS = 16
RADIO_TX_DB = 80.0         # card TX IQ vs CPU Radio, first 2 keyed blocks
RADIO_RHO = 0.7            # tests/test_tx_runtime.py:157
RADIO_SMETER_DB = -40.0
CLI_SECONDS = 5.0
CLI_FS = 192000.0
CLI_TX_SAMPLES = 4 * AUDIO_BLOCK   # tx input: the first 4 blocks of rx's
CLI_LSB = 1                # 16-bit samples, card vs --cpu


class ArrayMic:
    """A microphone that hands out an array block by block, then silence:
    the mic the Radio polls (its live capture device is slice 7b)."""

    def __init__(self, data):
        self.data = np.asarray(data, np.float32)
        self.pos = 0

    def get(self, n):
        out = np.zeros(n, np.float32)
        seg = self.data[self.pos:self.pos + n]
        out[:len(seg)] = seg
        self.pos += n
        return out


def run_feed(chain, inputs, prefetch: int, dev) -> tuple[list, float,
                                                          float, DeviceFeed]:
    """The chain's step over ``inputs`` through a DeviceFeed: (outputs, ms a
    block by CUDA events, ms a block by the host clock, the feed)."""
    feed = DeviceFeed(chain.step, chain.init_state(), prefetch=prefetch,
                      device=dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    outs = []
    for x in inputs:
        outs += feed.push(x)
    outs += feed.flush()
    stop.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / len(inputs) * 1e3
    return outs, start.elapsed_time(stop) / len(inputs), host, feed


def phase_feed(report: dict, smi: str, rng) -> dict:
    """The flagship fed from host memory through DeviceFeed: prefetch 1,
    prefetch 0 and blocks already on the card give the same bits, one
    kernel #1 launch a block; pageable numpy input too; the copy, the
    overlap and the staging memcpy timed."""
    dev = torch.device(DEVICE)
    chain = RxChain.create(flagship_config(), tune_hz=TUNE, mode=MODE,
                           device=dev)
    B = chain.block_in
    pageable = noise_blocks(rng, FEED_DISTINCT, B)
    pinned = [torch.from_numpy(x).pin_memory() for x in pageable]
    assert all(p.is_pinned() for p in pinned)
    resident = [p.to(dev) for p in pinned]
    idx = [i % FEED_DISTINCT for i in range(FEED_BLOCKS)]
    run_feed(chain, pinned[:2], 1, dev)                 # warm-up

    reset_launches()
    out1, ms1, host1, _ = run_feed(chain, [pinned[i] for i in idx], 1, dev)
    n_feed = launches()
    print(f"  feed path: {FEED_BLOCKS} blocks via DeviceFeed(prefetch=1), "
          f"front launches {n_feed}", flush=True)
    assert n_feed == {"plain": FEED_BLOCKS, "gained": 0, "nb": 0}, n_feed
    out0, ms0, host0, _ = run_feed(chain, [pinned[i] for i in idx], 0, dev)

    st, out_r = chain.init_state(), []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for i in idx:
        st, a = chain.step(st, resident[i])
        out_r.append(a)
    stop.record()
    torch.cuda.synchronize()
    host_r = (time.perf_counter() - t0) / FEED_BLOCKS * 1e3
    ms_r = start.elapsed_time(stop) / FEED_BLOCKS
    out_p, ms_p, host_p, fp = run_feed(chain, [pageable[i] for i in idx], 1,
                                       dev)
    for name, outs in (("prefetch 0", out0), ("resident", out_r),
                       ("pageable numpy", out_p)):
        assert len(outs) == FEED_BLOCKS
        same = all(torch.equal(a, b) for a, b in zip(out1, outs))
        print(f"  feed prefetch 1 vs {name}: bit-equal {same}", flush=True)
        assert same, name
    for a in out1:
        assert a.shape == (C, AUDIO_BLOCK) and bool(torch.isfinite(a).all())
    staged_ms = fp.staging_s / FEED_BLOCKS * 1e3
    assert fp.staged_bytes == FEED_BLOCKS * C * B * 8, fp.staged_bytes

    dst = torch.empty_like(resident[0])
    copy_ms = cuda_ms(lambda: dst.copy_(pinned[0], non_blocking=True), 10)
    nbytes = C * B * 8
    budget_ms = B / FS * 1e3
    hidden = 1.0 - (ms1 - ms_r) / copy_ms
    kern = check_plain_mode(chain.front, [pageable[0], pageable[1]])
    out = {"blocks": FEED_BLOCKS, "launches": n_feed,
           "ms_per_block": {"prefetch1": ms1, "prefetch0": ms0,
                            "resident": ms_r, "pageable": ms_p},
           "host_ms_per_block": {"prefetch1": host1, "prefetch0": host0,
                                 "resident": host_r, "pageable": host_p},
           "copy_ms": copy_ms, "copy_gb_s": nbytes / copy_ms / 1e6,
           "copy_hidden_share": hidden, "staging_ms": staged_ms,
           "realtime_factor": budget_ms / ms1,
           "max_abs_err": kern["max_abs_err"]}
    print(f"feed timing [{smi}] (ms a block, events / host): prefetch 1 "
          f"{ms1:.4f} / {host1:.4f}, prefetch 0 {ms0:.4f} / {host0:.4f}, "
          f"resident {ms_r:.4f} / {host_r:.4f}, pageable numpy "
          f"{ms_p:.4f} / {host_p:.4f}", flush=True)
    print(f"  H2D copy of one block ({nbytes / 1e6:.1f} MB, pinned): "
          f"{copy_ms:.4f} ms = {out['copy_gb_s']:.2f} GB/s; copy hidden "
          f"under compute 1 - (prefetch1 - resident) / copy = {hidden:.4f}; "
          f"staging memcpy (pageable) {staged_ms:.4f} ms a block; real-time "
          f"factor {out['realtime_factor']:.2f}x of {budget_ms:.2f} ms",
          flush=True)
    report["feed"] = out
    return out


# ------------------------------------------- slice 7b-1: the ingest plane
WB_RATE = PFB_K * PFB_RATE / 2   # 196.608 MS/s, the PFB receiver's input
WB_PKT = native.WIDEBAND_PAIRS   # samples a wideband datagram (8160)
WB_SCALE = 0.08            # the capture under iq24's full scale (1 - 2^-23)
WB_BLOCKS = 3
WB_PACE = 48e6             # samples/s of the paced sender; half on a retry
WB_BLAST_PACKETS = 24000   # each unpaced blast: 195.8 M samples
WB_BLAST_BLOCK = 16 * 2 * WB_PKT     # a block the striped pump accepts
HIQ_BLOCKS = 8
HIQ_FROM_BLOCK = 2         # as phase 25


def wideband_capture(dev) -> np.ndarray:
    """The ingest phase's capture [n] complex64 on the host: pfb_signal's
    blocks (noise, the USB / AM / FM carriers) from a torch generator of
    their own (SEED + 8) scaled by WB_SCALE, cut to the whole packets that
    cover WB_BLOCKS blocks."""
    B = PFB_K * PFB_MULT
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 8)
    n = -(-WB_BLOCKS * B // WB_PKT) * WB_PKT
    blocks = [(pfb_signal(dev, gen, PFB_K, B, blk) * WB_SCALE).cpu()
              .numpy()[0] for blk in range(-(-n // B))]
    return np.concatenate(blocks)[:n]


def wait_for_samples(src, n: int, sender: threading.Thread | None,
                     timeout: float = 60.0) -> bool:
    """True once ``src`` holds ``n`` samples; False when the sender has
    ended and the pump has parsed nothing new for 0.5 s, or on timeout."""
    t0, last, still = time.time(), -1, 0
    while src.available() < n:
        if sender is None or not sender.is_alive():
            got = src.stats()["samples"]
            still = still + 1 if got == last else 0
            last = got
            if still > 50:
                return False
        if time.time() - t0 > timeout:
            return False
        time.sleep(0.01)
    return True


def paced_sender(iq: np.ndarray, addr, pace: float):
    """A thread that streams ``iq`` to ``addr`` as wideband packets built by
    the port's WidebandStream, through PacketSender paced at ``pace``
    samples/s; (thread, the packets in the order sent, the sender)."""
    tx = native.WidebandStream()
    sent: list = []

    def build(chunk):
        pkt = tx.build(chunk)
        sent.append(pkt)
        return pkt
    sender = pump.PacketSender(build, addr, WB_PKT)
    th = threading.Thread(target=sender.send_stream, args=(iq,),
                          kwargs={"rate_hz": pace}, name="wideband-sender")
    return th, sent, sender


def send_counted(pkts: list, addr, src, chunk: int) -> None:
    """Send ``pkts`` to ``addr`` ``chunk`` at a time, each chunk once the
    pump has counted the one before (no loss from a full socket buffer)."""
    sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    base = src.stats()["packets"]
    try:
        for k in range(0, len(pkts), chunk):
            for p in pkts[k:k + chunk]:
                sk.sendto(p, addr)
            want = base + min(len(pkts), k + chunk)
            t0 = time.time()
            while src.stats()["packets"] < want:
                assert time.time() - t0 < 10.0, "pump stopped counting"
                time.sleep(0.0005)
    finally:
        sk.close()


def ingest_fed_run(dev, pipe, iq: np.ndarray, pace: float) -> dict:
    """Leg (a): WidebandHardware's native pump fed live by the paced
    sender, each block read straight into DeviceFeed's next pinned slot
    (push_into) and stepped through ``pipe`` on the card."""
    B = PFB_K * PFB_MULT
    hw = WidebandHardware(n_streams=1, sample_rate=WB_RATE)
    hw.open()
    (addr,) = hw.start_pump(block=B)
    th, sent, sender = paced_sender(iq, addr, pace)
    read_ms: list = []

    def fill(buf):
        t0 = time.perf_counter()
        got = hw.read_samples(B, out=buf)
        read_ms.append((time.perf_counter() - t0) * 1e3)
        return got
    try:
        native_pump = hw.pump.stats()["native"]
        feed = DeviceFeed(pipe, pipe.init_state(1), prefetch=1, device=dev)
        reset_launches()
        outs: list = []
        t0 = time.perf_counter()
        th.start()
        for _ in range(WB_BLOCKS):
            if not wait_for_samples(hw.pump, B, th):
                break
            got = feed.push_into((1, B), torch.complex64, fill)
            assert got is not None, "the pump had the block but read none"
            outs += got
        outs += feed.flush()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        th.join(timeout=120.0)
        assert not th.is_alive(), "the sender did not end"
        wait_for_samples(hw.pump, 1 << 62, None)      # let the pump settle
        st = hw.pump.stats()
    finally:
        sender.close()
        hw.close()
    return {"native": native_pump, "stats": st, "outs": outs, "sent": sent,
            "launches": pfb_launches(), "staged_bytes": feed.staged_bytes,
            "read_ms": read_ms, "wall_s": wall_s, "pace": pace}


def ingest_routes(dev, pipe, sent: list, want: list, chunk: int) -> dict:
    """Leg (b), the PFB route on a full ring: the same packets into a new
    pump (a ring of four blocks), then WB_BLOCKS blocks stepped through
    DeviceFeed read straight into its pinned slot (push_into) and, on
    another pump, through read_samples -> numpy -> push (a staging
    memcpy).  Host ms a block from block 1 on (to the last step's end),
    each block's push (the read included), the staging a block; both
    bit-equal to leg (a)."""
    B = PFB_K * PFB_MULT
    out = {}
    for route in ("pinned", "numpy"):
        hw = WidebandHardware(n_streams=1, sample_rate=WB_RATE)
        hw.open()
        (addr,) = hw.start_pump(block=2 * B)
        try:
            send_counted(sent, addr, hw.pump, chunk)
            feed = DeviceFeed(pipe, pipe.init_state(1), prefetch=1,
                              device=dev)
            push_ms, outs, t1 = [], [], 0.0
            torch.cuda.synchronize()
            for blk in range(WB_BLOCKS):
                t0 = time.perf_counter()
                if blk == 1:
                    t1 = t0
                if route == "pinned":
                    outs += feed.push_into(
                        (1, B), torch.complex64,
                        lambda buf: hw.read_samples(B, out=buf))
                else:
                    outs += feed.push(hw.read_samples(B))
                push_ms.append((time.perf_counter() - t0) * 1e3)
            outs += feed.flush()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) / (WB_BLOCKS - 1) * 1e3
            same = len(outs) == len(want) and all(
                torch.equal(a, b) and torch.equal(sa, sb)
                for (a, sa), (b, sb) in zip(outs, want))
            out[route] = {"ms_per_block": ms, "push_ms": push_ms,
                          "staging_ms": feed.staging_s / WB_BLOCKS * 1e3,
                          "staged_bytes": feed.staged_bytes,
                          "bit_equal": same}
            del outs
        finally:
            hw.close()
    return out


def drain_rate(send, src, block: int) -> dict:
    """Run ``send()`` (a blast; returns packets sent) in a thread while this
    thread drains ``src`` in blocks into one buffer; drained Msps (block
    samples read over the time to the last block), losses, errors."""
    result = {}
    th = threading.Thread(target=lambda: result.update(sent=send()))
    buf = np.empty((1, block), np.complex64)
    drained, desynced, t_last = 0, False, 0.0
    t0 = time.perf_counter()
    th.start()
    last, still = -1, 0
    while True:
        try:
            got = src.read_samples(block, out=buf)
        except RuntimeError:
            desynced = True
            break
        if got is not None:
            drained += block
            t_last = time.perf_counter()
            continue
        if not th.is_alive():
            n = src.stats()["samples"]
            still = still + 1 if n == last else 0
            last = n
            if still > 200:
                break
        time.sleep(0.0002)
    th.join(timeout=60.0)
    st = src.stats()
    sent = result.get("sent", 0)
    return {"packets_sent": sent, "packets_parsed": st["packets"],
            "lost_packets": sent - st["packets"],
            "seq_errors": st["seq_errors"],
            "ring_overruns": st["ring_overruns"], "desynced": desynced,
            "drained_samples": drained,
            "drained_msps": drained / max(t_last - t0, 1e-9) / 1e6}


def blast_rates() -> dict:
    """Leg (b): the unpaced native blaster into one wideband socket, and
    striped over two sockets (blocks of WB_BLAST_BLOCK, a multiple of
    2 * 8160)."""
    one = pump.NativePump("wideband", ring_samples=1 << 24)
    one.start()
    try:
        single = drain_rate(lambda: pump.blast(
            one.local_addr, codec="wideband", n_packets=WB_BLAST_PACKETS),
            one, WB_BLAST_BLOCK)
        single["rcvbuf_bytes"] = one.stats()["rcvbuf_bytes"]
    finally:
        one.stop()
        one.close()
    sp = pump.StripedPump(2, ring_samples=1 << 24)
    sp.start()
    try:
        striped = drain_rate(lambda: pump.blast_striped(
            sp.local_addrs, WB_BLAST_PACKETS), sp, WB_BLAST_BLOCK)
    finally:
        sp.close()
    return {"one_socket": single, "striped_two": striped}


def rmem_max() -> int:
    try:
        with open("/proc/sys/net/core/rmem_max") as f:
            return int(f.read())
    except OSError:
        return 212992


def phase_ingest(report: dict, smi: str) -> dict:
    """The PFB receiver fed by the ingest plane (slice 7b-1), from a stream
    of its own (SEED + 8)."""
    dev = torch.device(DEVICE)
    K, B = PFB_K, PFB_K * PFB_MULT
    n_out = 2 * PFB_MULT
    budget_ms = n_out / PFB_RATE * 1e3
    pipe = pfb_pipeline(dev, PFB_MULT, True)
    iq = wideband_capture(dev)
    print(f"  capture: {iq.size} samples = {iq.size // WB_PKT} wideband "
          f"packets of {WB_PKT}, peak {float(np.abs(iq.view(np.float32)).max()):.3f}"
          f" a rail", flush=True)

    # (a) live, paced; once more at half the rate if the pump lost any
    for pace in (WB_PACE, WB_PACE / 2):
        run = ingest_fed_run(dev, pipe, iq, pace)
        st = run["stats"]
        lossless = (len(run["outs"]) == WB_BLOCKS and st["seq_errors"] == 0
                    and st["ring_overruns"] == 0
                    and st["packets"] == len(run["sent"]))
        print(f"  paced at {pace / 1e6:.1f} MS/s: {len(run['sent'])} packets "
              f"sent, {st['packets']} parsed, seq errors "
              f"{st['seq_errors']}, ring overruns {st['ring_overruns']}, "
              f"{len(run['outs'])} blocks in {run['wall_s']:.3f} s",
              flush=True)
        if lossless:
            break
        del run
    assert lossless, "the pump lost packets at both pacing rates"
    assert run["native"] is True, "not the native pump"
    assert run["staged_bytes"] == 0, run["staged_bytes"]
    n = run["launches"]
    assert n == {"poly_os": WB_BLOCKS, "poly_crit": 0, "demod": WB_BLOCKS}, n
    outs, sent = run["outs"], run["sent"]
    for a, sp in outs:
        assert a.shape == (1, n_out * pipe.K1, pipe.K2) and sp.shape == (1, K)
        assert bool(torch.isfinite(a).all()) and bool(torch.isfinite(sp).all())

    # the same blocks stepped from card-resident copies of the packets sent
    ref = np.empty(len(sent) * WB_PKT, np.complex64)
    for i, p in enumerate(sent):
        ref[i * WB_PKT:(i + 1) * WB_PKT] = native.unpack_iq24(p[8:])
    st_r = pipe.init_state(1)
    states, xs = [st_r], []
    for k, (a, sp) in enumerate(outs):
        x = torch.from_numpy(ref[k * B:(k + 1) * B]).view(1, B).to(dev)
        st_r, (ar, spr) = pipe(st_r, x)
        states.append(st_r)
        xs.append(x)
        assert torch.equal(a, ar) and torch.equal(sp, spr), k
        del ar, spr
    print(f"  ingest-fed PFB receiver: {WB_BLOCKS} blocks of {B} samples, "
          f"launches {n}, staged bytes 0, audio and spec bit-equal to the "
          f"resident step of the unpacked packets", flush=True)
    pos = torch.as_tensor(pipe.chan_pos, device=dev)
    beats, top = channel_beats(outs, pos, n_out, K)
    poly_err, demod_err, _, _ = pfb_kernel_errors(pipe, states[2], xs[2])
    x2 = xs[2]
    del xs, states

    # (b) host rates: the PFB routes on a full ring, then the blasters
    chunk = max(1, min(64, rmem_max() // (2 * len(sent[0]))))
    routes = ingest_routes(dev, pipe, sent, outs, chunk)
    for r in routes.values():
        assert r["bit_equal"], routes
    assert routes["pinned"]["staged_bytes"] == 0
    slot = torch.empty((1, B), dtype=torch.complex64, pin_memory=True)
    dst = torch.empty((1, B), dtype=torch.complex64, device=dev)
    copy_ms = cuda_ms(lambda: dst.copy_(slot, non_blocking=True), 10)
    state = {"st": pipe.init_state(1)}

    def step():
        state["st"], _ = pipe(state["st"], x2)
    step_ms = cuda_ms(step, 6, 2)
    del slot, dst, x2
    rates = blast_rates()
    pinned, numpy_r = routes["pinned"], routes["numpy"]
    out = {
        "pace_msps": run["pace"] / 1e6, "packets": len(sent),
        "packet_samples": WB_PKT, "sockets": 1, "blocks": WB_BLOCKS,
        "stats": run["stats"],
        "launches": n, "beats": beats, "spec_top": top,
        "paced_read_ms": run["read_ms"], "routes": routes,
        "copy_ms": copy_ms, "step_ms": step_ms,
        "staging_saved_ms": numpy_r["staging_ms"],
        "realtime_factor": budget_ms / pinned["ms_per_block"],
        "blast": rates, "poly_err": poly_err, "demod_err": demod_err,
        "socket_rmem_max": rmem_max()}
    print(f"ingest timing [{smi}] (host clock, ms a block of {B} samples, "
          f"blocks 1-{WB_BLOCKS - 1} on a full ring): pump -> pinned slot "
          f"(push_into) {pinned['ms_per_block']:.4f} (each push, the read "
          f"in it, {', '.join(f'{t:.4f}' for t in pinned['push_ms'])}), "
          f"pump -> numpy -> staged (push) {numpy_r['ms_per_block']:.4f} "
          f"(each read + push "
          f"{', '.join(f'{t:.4f}' for t in numpy_r['push_ms'])}, staging "
          f"memcpy {numpy_r['staging_ms']:.4f} a block); H2D copy of a "
          f"slot {copy_ms:.4f} ms (events), PFB step {step_ms:.4f} ms "
          f"(events); real-time factor of the ingest-fed receiver "
          f"{out['realtime_factor']:.2f}x of {budget_ms:.2f} ms; leg (a) "
          f"paced at {out['pace_msps']:.1f} MS/s, its reads into the slot "
          f"{', '.join(f'{t:.4f}' for t in run['read_ms'])} ms", flush=True)
    for name, r in rates.items():
        print(f"  unpaced blast, {name.replace('_', ' ')} [{smi}]: drained "
              f"{r['drained_msps']:.1f} MS/s ({r['drained_samples']} "
              f"samples), packets sent {r['packets_sent']}, parsed "
              f"{r['packets_parsed']}, lost {r['lost_packets']}, seq errors "
              f"{r['seq_errors']}, ring overruns {r['ring_overruns']}, "
              f"desynced {r['desynced']}", flush=True)
    print(f"  a pump's socket receive buffer {rates['one_socket']['rcvbuf_bytes']}"
          f" bytes (net.core.rmem_max {out['socket_rmem_max']})", flush=True)
    report["ingest"] = out
    del run, outs, pipe
    torch.cuda.empty_cache()
    return out


def phase_hiqsdr_radio(report: dict) -> None:
    """A live HiQSDR Radio on the card (tests/test_pump.py:193-229): the
    same 1442-byte packets over loopback into a card Radio and a CPU
    Radio; zero sequence errors, audio a block > RADIO_CPU_DB apart."""
    fs = 48000.0
    radios = {d: Radio(RadioConfig(sample_rate=fs, mode="USB",
                                   tune_hz=7000.0), hardware="hiqsdr",
                       device=d) for d in ("cuda", "cpu")}
    addrs = {d: r.hw.start_pump() for d, r in radios.items()}
    for r in radios.values():
        r.open()
    n = (HIQ_BLOCKS * radios["cuda"].chain.block_in // native.HIQSDR_PAIRS
         + 1) * native.HIQSDR_PAIRS
    voice = sources.voice_like(fs, n, band=(300.0, 2400.0))
    voice *= 0.3 / np.abs(voice).max()
    iq = sources.ssb_signal(voice, fs, carrier_hz=7000.0).astype(
        np.complex64)
    sent = {}
    try:
        for d, r in radios.items():
            tx, sent[d] = native.HiqsdrStream(), []

            def build(chunk, tx=tx, log=sent[d]):
                log.append(tx.build(chunk))
                return log[-1]
            sender = pump.PacketSender(build, addrs[d], native.HIQSDR_PAIRS)
            sender.send_stream(iq, rate_hz=4 * fs)      # 4x real time
            sender.close()
            assert wait_for_samples(r.hw.pump, n, None)
        assert sent["cuda"] == sent["cpu"]
        t0 = time.perf_counter()
        audio = radios["cuda"].run(blocks=HIQ_BLOCKS)
        card_s = time.perf_counter() - t0
        cpu = one_thread(lambda: radios["cpu"].run(blocks=HIQ_BLOCKS))
        st = radios["cuda"].hw.pump.stats()
    finally:
        for r in radios.values():
            r.close()
    assert st["native"] is True
    assert st["seq_errors"] == 0 and st["ring_overruns"] == 0, st
    B = AUDIO_BLOCK
    assert audio.shape == cpu.shape == (1, HIQ_BLOCKS * B), audio.shape
    assert np.sqrt(np.mean(audio[0, HIQ_FROM_BLOCK * B:] ** 2)) > 0.01
    snr = [snr_db(torch.as_tensor(cpu[0, k * B:(k + 1) * B],
                                  dtype=torch.float64),
                  torch.as_tensor(audio[0, k * B:(k + 1) * B],
                                  dtype=torch.float64))
           for k in range(HIQ_FROM_BLOCK, HIQ_BLOCKS)]
    print(f"  HiQSDR Radio (48 kS/s, {len(sent['cuda'])} packets at 4x real "
          f"time over loopback, native pump): seq errors 0, card vs CPU "
          f"Radio blocks {HIQ_FROM_BLOCK}-{HIQ_BLOCKS - 1} min "
          f"{min(snr):.1f} dB; {HIQ_BLOCKS} blocks in {card_s:.2f} s",
          flush=True)
    assert min(snr) > RADIO_CPU_DB, snr
    report["hiqsdr_radio"] = {"cpu_match_min_db": min(snr),
                              "packets": len(sent["cuda"]),
                              "seconds": card_s}


def user_session(device, tmp: str | None = None) -> dict:
    """A Quisk user's session (RadioConfig defaults at 48 kS/s, sim
    hardware): USER_BLOCKS blocks, the tone 1 kHz above the USB dial, a
    retune at block USER_RETUNE_AT, the audio and IQ record taps."""
    r = Radio(RadioConfig(sample_rate=48000.0, mode="USB", tune_hz=10000.0,
                          agc=True), hardware="sim", device=device)
    r.hw.tone_hz = 11000.0
    r.open()
    audio, retuned = [], {}
    for k in range(USER_BLOCKS):
        if tmp is not None and k == 2:
            r.start_record(os.path.join(tmp, "spk.wav"), kind="audio")
        if tmp is not None and k == 4:
            retuned["spk"] = r.stop_record()
            r.start_record(os.path.join(tmp, "raw.wav"), kind="iq")
        if k == USER_RETUNE_AT:
            if tmp is not None:
                retuned["iq"] = r.stop_record()
            stages, state = r.chain.stages, r._state
            r.hw.tone_hz = 14000.0
            r.set_frequency(13000.0)
            retuned["same_objects"] = (r.chain.stages is stages
                                       and r._state is state)
        audio.append(r.run_once()[0])
    out = {"audio": audio, "smeter": r.smeter_db(),
           "waterfall_rows": int(r.waterfall.pixels().shape[0]),
           "fs": r.chain.fs_audio, **retuned}
    r.close()
    return out


def beat_hz(a: np.ndarray, fs: float) -> float:
    a = np.asarray(a, np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    return float(np.fft.rfftfreq(a.size, 1.0 / fs)[np.argmax(spec)])


def phase_radio_user(report: dict) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        s = user_session(None, tmp)
        card_s = time.perf_counter() - t0
        spk, fs_a = wav.read_audio_wav(s["spk"])
        iq, fs_iq = wav.read_iq_wav(s["iq"])
    cpu = one_thread(lambda: user_session("cpu"))
    fs = s["fs"]
    f_before = beat_hz(np.concatenate(s["audio"][USER_RETUNE_AT - 2:
                                                 USER_RETUNE_AT]), fs)
    f_after = beat_hz(np.concatenate(s["audio"][-2:]), fs)
    snr = [snr_db(torch.as_tensor(c, dtype=torch.float64),
                  torch.as_tensor(a, dtype=torch.float64))
           for a, c in zip(s["audio"][2:], cpu["audio"][2:])]
    print(f"  Radio session (48 kS/s, sim): beat {f_before:.1f} Hz, after "
          f"set_frequency(13000) {f_after:.1f} Hz, retuned in place "
          f"{s['same_objects']}, S-meter {s['smeter']:.2f} dB, waterfall rows "
          f"{s['waterfall_rows']}, card vs CPU Radio blocks 2-"
          f"{USER_BLOCKS - 1} min {min(snr):.1f} dB; {USER_BLOCKS} blocks "
          f"in {card_s:.2f} s", flush=True)
    assert abs(f_before - BEAT_HZ) <= 30.0 and abs(f_after - BEAT_HZ) <= 30.0
    assert s["same_objects"]
    assert spk.shape == (2 * AUDIO_BLOCK,) and fs_a == 48000.0
    assert np.max(np.abs(spk - np.clip(np.concatenate(s["audio"][2:4]),
                                       -1, 1))) <= 2.0 / 32767
    assert iq.shape == (2 * AUDIO_BLOCK,) and fs_iq == 48000.0
    assert abs(float(np.mean(np.abs(iq))) - 0.5) < 0.01
    assert s["waterfall_rows"] >= 1 and np.isfinite(s["smeter"])
    assert min(snr) > RADIO_CPU_DB, snr
    report["radio_user"] = {"beat_hz": [f_before, f_after],
                            "cpu_match_min_db": min(snr),
                            "smeter_db": s["smeter"]}


def wide_radio(device, channels: int, **cfg):
    """The Radio at 960 kS/s, every channel on the one sim capture: channel
    0 USB 1 kHz below the tone, sub-receivers 1-7 alternately LSB above it
    and USB below it, each at its own beat (1000 + 100 c Hz); the others
    as channel 0.  ``cfg``: more RadioConfig fields."""
    r = Radio(RadioConfig(sample_rate=FS, channels=channels,
                          audio_block=AUDIO_BLOCK, mode="USB",
                          tune_hz=WIDE_TONE_HZ - BEAT_HZ, **cfg),
              hardware="sim", device=device)
    for c in range(1, 8):
        lsb = c % 2 == 1
        beat = BEAT_HZ + 100.0 * c
        r.set_sub_rx(c, freq_hz=WIDE_TONE_HZ + (beat if lsb else -beat),
                     mode="LSB" if lsb else "USB")
    r.open()
    return r


def h2d_bytes(fn, n: int = 3) -> list[int]:
    """Bytes of every host->device copy that n calls of fn() make, from the
    memcpy records of a torch.profiler trace.  One call ahead of them is
    the profiler's warm-up step, whose records are dropped: a trace that
    starts cold has been seen to miss the first copy."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=n),
                on_trace_ready=lambda p: p.export_chrome_trace(path)
        ) as prof:
            for _ in range(n + 1):
                fn()
                torch.cuda.synchronize()
                prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    sizes = [int(e["args"]["bytes"]) for e in events
             if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    assert sizes, "the trace holds no host->device copy"
    return sizes


def phase_radio_wide(report: dict, smi: str) -> None:
    """The Radio at 1024 channels, 960 kS/s, every channel on the one sim
    capture: the capture crosses as [1, n], rows 0-7 against a CPU Radio
    with channels=8, the beat on channel 0, timing and idle share."""
    r = wide_radio(None, C)
    assert r.chain.front is None and r.chain.stages, "unfused decimators"
    B = r.chain.block_in
    audio = [r.run_once()]
    n_prof = 3
    sizes = h2d_bytes(lambda: audio.append(r.run_once()), n_prof)
    per_block = sum(sizes) / n_prof
    print(f"  wide Radio: host->device copies of {n_prof} run_once: "
          f"{len(sizes)}, {per_block:.0f} bytes a block, largest "
          f"{max(sizes)} (one [1, {B}] capture = {B * 8} bytes; broadcast on "
          f"the host it would be {C * B * 8})", flush=True)
    assert sizes.count(B * 8) == n_prof and max(sizes) == B * 8, sizes
    assert per_block < 2 * B * 8, sizes
    audio += [r.run_once() for _ in range(WIDE_BLOCKS - len(audio))]
    cpu = one_thread(lambda: wide_radio("cpu", 8))
    cpu_audio = one_thread(lambda: [cpu.run_once()
                                    for _ in range(WIDE_BLOCKS)])
    worst = []
    for k in range(2, WIDE_BLOCKS):
        for row in range(8):
            ref = torch.as_tensor(cpu_audio[k][row], dtype=torch.float64)
            got = torch.as_tensor(audio[k][row], dtype=torch.float64)
            s = snr_db(ref, got)
            assert s > RADIO_CPU_DB, (k, row, s)
            worst.append(s)
    f0 = beat_hz(np.concatenate([a[0] for a in audio[-3:]]), 48000.0)
    print(f"  wide Radio: card vs CPU Radio (channels=8), rows 0-7, blocks "
          f"2-{WIDE_BLOCKS - 1}: min {min(worst):.1f} dB; channel 0 beat "
          f"{f0:.1f} Hz", flush=True)
    assert abs(f0 - BEAT_HZ) <= 30.0, f0
    assert all(a.shape == (C, AUDIO_BLOCK) and np.all(np.isfinite(a))
               for a in audio)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(6):
        r.run_once()
    host_ms = (time.perf_counter() - t0) / 6 * 1e3
    budget_ms = B / FS * 1e3
    xd = torch.as_tensor(r.hw.read_samples(B), device=DEVICE).expand(C, B)
    feed_ms = cuda_ms(lambda: r.graph.feed(xd), 6)
    step_ms_, _ = step_ms(r.chain, [xd, xd], iters=5, warmup=2)
    idle = device_idle("wide Radio run_once", r.chain, [], host_ms,
                       warmup=2, front_kernel=False, step=r.run_once)
    print(f"wide Radio timing [{smi}]: run_once {host_ms:.4f} ms/block (host "
          f"clock, returns numpy), real-time factor "
          f"{budget_ms / host_ms:.2f}x of {budget_ms:.2f} ms; graph.feed "
          f"{feed_ms:.4f} ms, chain step "
          f"{step_ms_:.4f} ms (events)", flush=True)
    r.close()
    report["radio_wide"] = {"h2d_bytes_a_block": per_block,
                            "cpu_match_min_db": min(worst), "beat_hz": f0,
                            "run_once_ms": host_ms,
                            "realtime_factor": budget_ms / host_ms,
                            "graph_feed_ms": feed_ms, "step_ms": step_ms_,
                            "idle": idle}


def loopback_radio(device, voice):
    """The live loopback session of tests/test_tx_runtime.py:124-156 (the
    flow of examples/demo_transceiver.py live_session) up to PTT."""
    r = Radio(RadioConfig(sample_rate=48000.0, audio_block=AUDIO_BLOCK,
                          mode="USB", tune_hz=9000.0, agc=False),
              hardware="loopback", device=device)
    r.open()
    r.enable_tx()
    r.tx_monitor = True
    r.run_once()
    r.transmit(np.zeros(r.tx.block, np.float32), ptt=True)
    r.mic = ArrayMic(voice)
    r.set_ptt(True)
    return r


def keyed_blocks(r, n: int) -> tuple[list, list, list]:
    """n keyed run_once blocks: (audio row 0, TX IQ, TX state entering)."""
    audio, iqs, states = [], [], []
    for _ in range(n):
        states.append(r._tx_state)
        audio.append(r.run_once()[0])
        iqs.append(r.tx_iq_last)
    return audio, iqs, states


def alc_flips(tx_card, tx_cpu, states, mic_blocks, scale: float
              ) -> tuple[int, int]:
    """The card's and the CPU's TxALC on identical inputs (the CPU chain's
    pre-ALC IQ and state for ``scale`` times the mic): (clips, flips)."""
    dev = tx_card.device
    clips = flips = 0
    for st, m in zip(states, mic_blocks):
        a = torch.as_tensor(scale * m[None])
        _, iq = tx_cpu.pre_alc(st, a)
        _, _, c_cpu = tx_cpu.alc.trace(st["alc"], iq)
        _, _, c_card = tx_card.alc.trace(alc_rows(st["alc"], 1, dev),
                                         iq.to(dev))
        clips += int(c_cpu.sum())
        flips += int((c_card.cpu() != c_cpu).sum())
    return clips, flips


def phase_radio_tx(report: dict, smi: str, rng) -> None:
    n = (RADIO_TX_BLOCKS + 1) * AUDIO_BLOCK
    voice = voice_like(rng, n, 1, band=(400.0, 2300.0))[0]
    voice = (0.5 * voice / np.max(np.abs(voice))).astype(np.float32)
    r = loopback_radio(None, voice)
    t0 = time.perf_counter()
    audio, iqs, _ = keyed_blocks(r, RADIO_TX_BLOCKS)
    keyed_ms = (time.perf_counter() - t0) / RADIO_TX_BLOCKS * 1e3
    smeter = r.smeter_db()
    n_launch = count_launches(r.run_once)
    # the TX step and its ALC on a keyed block, alone
    mic = torch.as_tensor(voice[None, :AUDIO_BLOCK], device=r.device)
    tst = r._tx_state
    _, iq_pre = r.tx.pre_alc(tst, mic)
    tx_launches = count_launches(lambda: r.tx.step(tst, mic))
    alc_launches = count_launches(lambda: r.tx.alc(tst["alc"], iq_pre))
    r.set_ptt(False)
    r.run_once()
    r.close()
    cpu = one_thread(lambda: loopback_radio("cpu", voice))
    _, cpu_iqs, cpu_states = one_thread(lambda: keyed_blocks(cpu, 2))
    snr = [snr_db(torch.as_tensor(c), torch.as_tensor(g))
           for g, c in zip(iqs[:2], cpu_iqs)]
    mic_blocks = [voice[k * AUDIO_BLOCK:(k + 1) * AUDIO_BLOCK]
                  for k in range(2)]
    clip_check = {s: one_thread(lambda s=s: alc_flips(r.tx, cpu.tx,
                                                      cpu_states,
                                                      mic_blocks, s))
                  for s in (1.0, 8.0)}
    aud = np.concatenate(audio)
    rho, lag = voice_correlation(voice, aud)
    print(f"  Radio TX (loopback, {RADIO_TX_BLOCKS} keyed blocks): TX IQ card "
          f"vs CPU Radio, first 2 blocks: "
          + ", ".join(f"{v:.1f}" for v in snr) + " dB; TxALC clips / flips on "
          f"identical inputs: mic x1 {clip_check[1.0]}, mic x8 "
          f"{clip_check[8.0]}; voice rho {rho:.4f} at lag {lag}; S-meter "
          f"{smeter:.2f} dB", flush=True)
    print(f"Radio TX timing [{smi}]: a keyed run_once {keyed_ms:.4f} ms "
          f"(host clock), {n_launch} CUDA launches and copies a block; the "
          f"TX step alone {tx_launches} (at most {TX_STEP_LAUNCHES_MAX}), "
          f"its TxALC {alc_launches} (at most {ALC_LAUNCHES_MAX})",
          flush=True)
    assert tx_launches <= TX_STEP_LAUNCHES_MAX, tx_launches
    assert alc_launches <= ALC_LAUNCHES_MAX, alc_launches
    assert min(snr) >= RADIO_TX_DB, snr
    assert all(f == 0 for _, f in clip_check.values()), clip_check
    assert clip_check[8.0][0] > 0, clip_check
    assert rho > RADIO_RHO, (rho, lag)
    assert smeter > RADIO_SMETER_DB, smeter
    report["radio_tx"] = {"cpu_match_db": snr, "alc": {
        str(k): v for k, v in clip_check.items()}, "rho": rho,
        "smeter_db": smeter, "keyed_ms": keyed_ms, "launches": n_launch,
        "launches_tx_step": tx_launches, "launches_alc": alc_launches}


def voice_correlation(voice: np.ndarray, audio: np.ndarray
                      ) -> tuple[float, int]:
    """tests/test_tx_runtime.py:136-153: the mic against the demodulated
    audio over blocks 6-13, analytic signals, a lag scan over the chain's
    group delay."""
    seg = slice(6 * AUDIO_BLOCK, 14 * AUDIO_BLOCK)
    core = sig.firwin(257, [500.0, 2200.0], fs=48000.0, pass_zero=False)
    av = sig.hilbert(np.convolve(voice[seg], core, "same"))
    aa = sig.hilbert(np.convolve(audio[seg], core, "same"))
    m = len(av) - 4000
    c = np.array([np.abs(np.vdot(av[:m], aa[lag:lag + m]))
                  for lag in range(4000)])
    best = int(np.argmax(c))
    a2, v2 = aa[best:best + m], av[:m]
    rho = float(np.abs(np.vdot(v2, a2))
                / (np.linalg.norm(v2) * np.linalg.norm(a2)))
    return rho, best


def run_cli(argv: list[str]) -> tuple[str, float]:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    assert rc == 0, (argv, rc, buf.getvalue())
    return buf.getvalue(), secs


def phase_cli(report: dict, smi: str) -> None:
    """The CLI (README "Quick start") on the card and with --cpu: rx, tx,
    spectrum of a 5 s, 192 kS/s capture holding a USB station."""
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)   # noqa: E731
        n = int(CLI_SECONDS * CLI_FS)
        wav.write_iq_wav(p("iq.wav"), 0.5 * sources.station_iq(
            Mode.USB, CLI_FS, n, carrier_hz=12000.0, seed=SEED), CLI_FS)
        for side, extra in (("card", []), ("cpu", ["--cpu"])):
            _, walls[f"rx_{side}"] = run_cli([
                "rx", "--in", p("iq.wav"), "--out", p(f"rx_{side}.wav"),
                "--mode", "USB", "--tune", "12000", *extra])
        a, fs = wav.read_audio_wav(p("rx_card.wav"))
        b, _ = wav.read_audio_wav(p("rx_cpu.wav"))
        rx_lsb = float(np.max(np.abs(a - b)) * 32768.0)
        wav.write_audio_wav(p("mic.wav"), a[:CLI_TX_SAMPLES], fs)
        peaks = {}
        for side, extra in (("card", []), ("cpu", ["--cpu"])):
            _, walls[f"tx_{side}"] = run_cli([
                "tx", "--in", p("mic.wav"), "--out", p(f"tx_{side}.wav"),
                "--mode", "USB", "--interp", "4", *extra])
            text, walls[f"spectrum_{side}"] = run_cli([
                "spectrum", "--in", p("iq.wav"), *extra])
            peaks[side] = text.splitlines()[-1]
        x, fs_tx = wav.read_iq_wav(p("tx_card.wav"))
        y, _ = wav.read_iq_wav(p("tx_cpu.wav"))
    tx_lsb = float(max(np.max(np.abs(x.real - y.real)),
                       np.max(np.abs(x.imag - y.imag))) * 32768.0)
    print(f"  CLI: rx {a.size} samples at {fs:.0f} Hz, card vs --cpu max "
          f"{rx_lsb:.0f} LSB; tx {x.size} IQ samples at {fs_tx:.0f} Hz, max "
          f"{tx_lsb:.0f} LSB; spectrum card '{peaks['card']}', --cpu "
          f"'{peaks['cpu']}'", flush=True)
    print(f"CLI timing [{smi}] (s, wall): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()), flush=True)
    assert a.size == n // (4 * AUDIO_BLOCK) * AUDIO_BLOCK, a.size
    assert fs == 48000.0
    assert rx_lsb <= CLI_LSB and tx_lsb <= CLI_LSB, (rx_lsb, tx_lsb)
    assert x.size == 4 * CLI_TX_SAMPLES and fs_tx == 4 * fs
    bins = {k: v.split(" at ")[1] for k, v in peaks.items()}
    assert bins["card"] == bins["cpu"], peaks
    report["cli"] = {"rx_lsb": rx_lsb, "tx_lsb": tx_lsb, "peak": peaks,
                     "wall_s": walls}



# ------------------------------- slice 7c: the AGC / ALC recurrence kernel
AGC_SRC = "quisk_tpu_torch/csrc/agc_scan.cu"
AGC_SHAPES = ((1, 1), (1, 7), (1, 2048), (33, 1), (33, 7), (33, 2048))
AGC_SPLIT = (33, 2048, 777)       # one call against two, cut at sample 777
# the edges of the kernel's register tile (B one short of it, it, one past
# it) and one channel past a full grid of its 32-channel blocks at the
# paths' width
AGC_EDGE_SHAPES = ((33, agc_scan.TILE - 1), (33, agc_scan.TILE),
                   (33, agc_scan.TILE + 1), (1025, 333))
# the earlier design of the kernel (shared-memory tiles, steps that
# branch) at the paths' [1024, 2048], chip_smoke.py on an H100 80GB HBM3 at
# 700.00 W
AGC_EARLIER_MS = {"tx_alc": 0.9078, "wcp": 0.9075, "hang": 0.4204}
AGC_ULP = 2                       # WcpAGC's gain where log10f and torch's
#                                   log10 differ on the card
# short WDSP time constants (tests/test_torch_agc.py), so that every state
# of the machine occurs within a short call
WCP_SHORT = dict(hangtime=0.01, tau_decay=0.02, tau_hang_decay=0.01,
                 tau_fast_backaverage=0.02, tau_hang_backmult=0.05,
                 hang_thresh=0.1)
AGC_WRAPPERS = {"tx_alc": agc_scan.tx_alc_scan, "wcp": agc_scan.wcp_scan,
                "hang": agc_scan.hang_scan}
AGC_PLAIN = {"tx_alc": agc_scan.tx_alc_plain, "wcp": agc_scan.wcp_plain,
             "hang": agc_scan.hang_plain}
# the JAX package's per-sample scans the modes replace (no Pallas kernel)
AGC_REPLACES = {"tx_alc": "quisk_tpu/ops/agc.py:447",
                "wcp": "quisk_tpu/ops/agc.py:318",
                "hang": "quisk_tpu/ops/agc.py:166"}
AGC_PATHS = {"tx_alc": "TX", "wcp": "WcpAGC chain",
             "hang": "HangAGC over the WcpAGC chain's demod audio"}


def agc_signal(rng, rows: int, n: int) -> np.ndarray:
    """Tone bursts (6 ms in 12 ms) at per-row levels over noise, a quiet
    tail: every branch of the three recurrences occurs."""
    t = np.arange(n) / 48000.0
    f = rng.uniform(300.0, 2500.0, (rows, 1))
    x = np.sin(2 * np.pi * f * t) * ((t % 0.012) < 0.006)
    x = (x * rng.choice([2.0, 1.0, 0.1, 0.01], (rows, 1))
         + 1e-4 * rng.standard_normal((rows, n)))
    x[:, int(0.8 * n):] *= 0.05
    return x.astype(np.float32)


def agc_case(mode: str, rng, rows: int, B: int, dev,
             hang_enable: bool = True) -> tuple:
    """One block's arguments of ``mode``'s wrapper on the card: seeded
    signal through its op's ``scan_inputs``, from a random mid-run state.
    The ALC's rows: bursts (most clip), a constant-envelope row at the clip
    threshold (row 1) and a silent one (row 2)."""
    def u(lo, hi, shape=(rows,)):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(
            np.float32), device=dev)

    def ints(hi, shape=(rows,)):
        return torch.as_tensor(rng.integers(0, hi, shape).astype(np.int32),
                               device=dev)
    if mode == "tx_alc":
        op = TxALC.create(48000.0, channels=rows, device=dev, mode=[
            TX_MODES[c % 2] for c in range(rows)])
        A = op.buf
        x = 2.0 * (agc_signal(rng, rows, B) + 1j * agc_signal(rng, rows, B))
        if rows > 2:
            x[1] = 1.3 * np.exp(0.05j * np.arange(B))
            x[2] *= 1e-5
        st = op.init_state(rows)
        st.update(gain_now=u(0.3, 1.5, (rows, op.n_modes)),
                  gain_change=u(-2e-4, 2e-4), final_gain=u(0.3, 1.5),
                  next_change=torch.where(u(0, 1) < 0.5, u(0, 1e-4),
                                          torch.full_like(u(0, 1), 1e10)),
                  counter=torch.floor(u(0, 400)),
                  fault=torch.floor(u(0, 960)), block_index=ints(A),
                  index=ints(A, ()))
        return op.scan_inputs(st, torch.as_tensor(x.astype(np.complex64),
                                                  device=dev))[1]
    x = torch.as_tensor(agc_signal(rng, rows, B), device=dev)
    if mode == "wcp":
        op = WcpAGC.create(48000.0, device=dev, hang_enable=hang_enable,
                           **WCP_SHORT)
        st = op.init_state(rows)
        st.update(delay=torch.as_tensor(agc_signal(rng, rows, op.lookahead),
                                        device=dev),
                  volts=u(1e-3, 1.0), save_volts=u(1e-3, 1.0),
                  fast_ba=u(0.0, 0.5), hang_ba=u(0.0, 0.5),
                  hang_counter=ints(op.hang_samples + 1), state=ints(5),
                  decay_type=ints(2))
        return op.scan_inputs(st, x)[1]
    op = HangAGC.create(48000.0, device=dev, hang_ms=5.0,
                        release_db_per_s=600.0)
    st = (torch.as_tensor(agc_signal(rng, rows, op.lookahead), device=dev),
          u(-2.0, 2.0), ints(op.hang_samples + 1))
    return op.scan_inputs(st, x)[1]


def same_rows(args: tuple) -> tuple:
    """The same wrapper arguments with every row (input and state) a copy
    of row 0: the lanes of a warp then take the same path at every
    sample."""
    xs, st, coef, kw = args
    C = xs[0].shape[0]
    return (tuple(x[:1].repeat(C, 1) for x in xs),
            tuple(s[:1].repeat(C) if s.dim() else s.clone() for s in st),
            coef, kw)


def check_agc(mode: str, args: tuple) -> dict:
    """The kernel against its plain version on the same tensors: every
    state bit-equal (integer and float), TxALC's clip decisions equal, the
    outputs bit-equal, but WcpAGC's gain within AGC_ULP ulp (log10f against
    torch's log10; the samples off are counted).  One launch."""
    xs, st, coef, kw = args
    fn = AGC_WRAPPERS[mode]
    n0 = fn.launches
    k = fn(*xs, st, coef, **kw)
    p = AGC_PLAIN[mode](*xs, st, coef, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1, (mode, fn.launches, n0)
    for i, (a, b) in enumerate(zip(k[0], p[0])):
        assert a.dtype == b.dtype and torch.equal(a, b), (mode, "state", i)
    ky, py = k[1], p[1]
    assert bool(torch.isfinite(ky).all()), mode
    out = {"max_abs_err": float((ky - py).abs().max()),
           "bit_equal": bool(torch.equal(ky, py))}
    if mode == "tx_alc":
        assert torch.equal(k[2], p[2]), (mode, int((k[2] != p[2]).sum()))
        out["clips"] = int(k[2].sum())
    if mode == "wcp":
        ulp = (ky.view(torch.int32) - py.view(torch.int32)).abs()
        out["samples_off"] = int((ulp > 0).sum())
        out["ulp_max"] = int(ulp.max())
        assert out["ulp_max"] <= AGC_ULP, (mode, out)
    else:
        assert out["bit_equal"], (mode, out)
    return out


def agc_views(args: tuple) -> dict:
    """The same call on inputs whose rows are not 16-byte aligned (the
    kernel's vector loads then give way to one load a sample): rows 2
    samples into rows of B + 4 (8 bytes off, every row alike at B = 2048),
    and rows of stride B + 1 (each row off by another amount)."""
    xs, st, coef, kw = args
    cut = tuple(torch.nn.functional.pad(x, (2, 2))[:, 2:2 + x.shape[1]]
                for x in xs)
    wide = tuple(torch.nn.functional.pad(x, (0, 1))[:, :x.shape[1]]
                 for x in xs)
    return {"cut 2": (cut, st, coef, kw), "stride B+1": (wide, st, coef, kw)}


# what the tile loop's hot path leaves out: the division's slow-path call,
# local memory, the scan's global loads and its copies of the next tile in
AGC_SLOW = ("CALL", "LDL", "STL", "LDG.", "LDGSTS")


def mark_bra_div(body: list) -> list:
    """A SASS body with BRA.DIV (taken only by a diverged warp) marked as
    the conditional branch it is."""
    return [(a, op, o, o.split(",")[0]) if op.startswith("BRA.DIV")
            else (a, op, o, g) for a, op, o, g in body]


def agc_scan_role(body: list) -> list:
    """The scan warp's part of a tile loop's SASS body: BRA.DIV marked
    (mark_bra_div), and where the helper warp's part is laid out first (it
    ends in a jump over the scan's wait for its copies, DEPBAR), that part
    dropped."""
    from probe_pll import _target
    body = mark_bra_div(body)
    dep = next(a for a, op, _, _ in body if op.startswith("DEPBAR"))
    jumps = [a for a, op, o, g in body
             if op == "BRA" and not g and a < dep < (_target(o) or 0)]
    if not jumps:
        return body
    jump = max(jumps)
    start = next(a for a, op, o, g in body
                 if op.startswith("BRA") and g and _target(o) == jump + 16)
    return [i for i in body if not start < i[0] <= jump]


def tile_estimates(funcs: dict, modes: dict, tile: int, role) -> dict:
    """Each mode's tile loop in a kernel's SASS (``funcs`` as
    probe_pll.sass_functions returns it; ``modes`` maps a part of the
    function's name, the template's instantiation, to the mode): the
    shortest loop that copies the next tile in (LDGSTS) and waits for it
    (DEPBAR), ``tile`` samples a pass; per sample, the scanning warp's part
    of it (``role``) by its longest dependent chain and in-order issue by
    probe_pll's latency table, and the branches and convergence barriers
    on its hot path."""
    from probe_pll import chain_estimate, hot_path, sample_loop
    out = {}
    for name, ins in funcs.items():
        mode = next(m for k, m in modes.items() if k in name)
        body = sample_loop(ins, need=("LDGSTS", "DEPBAR"))
        assert body is not None, (mode, "no tile loop in the SASS")
        body = role(body)
        res = chain_estimate(body, tile, AGC_SLOW)
        hot = hot_path(body, AGC_SLOW)
        res["branches_a_sample"] = {
            op: sum(1 for i in hot if i[1].startswith(op)) / tile
            for op in ("BRA", "BSSY", "BSYNC")}
        out[mode] = res
    return out


def agc_tile_estimates(funcs: dict) -> dict:
    """tile_estimates of csrc/agc_scan.cu's modes (agc_scan_kernel<0|1|2>),
    agc_scan.TILE samples a pass, the scan warp's part (agc_scan_role);
    TxALC's with its clip / block-complete ramps, which it takes only when
    a lane of the warp needs one."""
    return tile_estimates(funcs, {"ILi0E": "tx_alc", "ILi1E": "wcp",
                                  "ILi2E": "hang"}, agc_scan.TILE,
                          agc_scan_role)


def pll_tile_estimates(funcs: dict) -> dict:
    """tile_estimates of csrc/pll_demod.cu's modes (pll_demod_kernel<0|1>),
    pll.TILE samples a pass; one warp, so its role is its whole loop but
    BRA.DIV, which only a diverged warp takes; the hot path is the tile of
    unrolled steps (the one-sample-at-a-time loop of a partial tile or a
    large |ph| is cut with the other rare paths)."""
    return tile_estimates(funcs, {"ILi0E": "sync_am", "ILi1E": "pll_fm"},
                          pll.TILE, mark_bra_div)


def agc_bound(mode: str, rows: int, B: int) -> dict:
    """Each input read once and each output written once (4 B a sample
    each: TxALC magn in and gain out, WcpAGC rm and ao in and mult out,
    HangAGC the limit in and the log-gain out), the state read and
    written, coef; operations: a step's float32 arithmetic on its common
    path (TxALC's observing step 17, WcpAGC's 34 with log10 counted one,
    HangAGC's 8)."""
    b_in, b_out, words, n_coef, ops = {"tx_alc": (4, 4, 7, 5, 17),
                                       "wcp": (8, 4, 7, 12, 34),
                                       "hang": (4, 4, 2, 1, 8)}[mode]
    nbytes = rows * B * (b_in + b_out) + 2 * rows * words * 4 + n_coef * 4
    return bound(nbytes, rows * B * ops)


def phase_agc_kernel(report: dict, smi: str, rng, path_args: dict) -> dict:
    """csrc/agc_scan.cu in its three modes against the plain versions on the
    card at shapes off the paths' (C = 1 and 33, one past its 32-channel
    block; B = 1, 7 and 2048; WcpAGC with hang on and off by turns), a block
    cut in two calls at an odd sample equal to one call bit for bit, and
    the paths' own [1024, 2048] arguments, with the time of each mode, its
    plain version and its bound."""
    dev = torch.device(DEVICE)
    out = {}
    print(f"the AGC / ALC kernel [{smi}]:", flush=True)
    for mode, fn in AGC_WRAPPERS.items():
        res = []
        for i, (Cs, Bs) in enumerate(AGC_SHAPES):
            r = check_agc(mode, agc_case(mode, rng, Cs, Bs, dev,
                                         hang_enable=i % 2 == 0))
            res.append({"C": Cs, "B": Bs, **r})
        print(f"  agc_scan {mode} at (C, B) " + ", ".join(
            f"({r['C']}, {r['B']})" for r in res) + ": states bit-equal, "
            f"outputs bit-equal {[r['bit_equal'] for r in res]}, max "
            f"|kernel - plain| {max(r['max_abs_err'] for r in res):.3e}"
            + (f", samples off {[r['samples_off'] for r in res]} (at most "
               f"{max(r['ulp_max'] for r in res)} ulp)" if mode == "wcp"
               else "")
            + (f", clips {[r['clips'] for r in res]}" if mode == "tx_alc"
               else ""), flush=True)
        Cs, Bs, cut = AGC_SPLIT
        xs, st, coef, kw = agc_case(mode, rng, Cs, Bs, dev)
        n0 = fn.launches
        one = fn(*xs, st, coef, **kw)
        a = fn(*(x[:, :cut] for x in xs), st, coef, **kw)
        b = fn(*(x[:, cut:] for x in xs), a[0], coef, **kw)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 3, mode
        assert all(torch.equal(p, q) for p, q in zip(one[0], b[0])), mode
        assert all(torch.equal(one[i], torch.cat([a[i], b[i]], -1))
                   for i in range(1, len(one))), mode
        print(f"  agc_scan {mode} C={Cs} B={Bs}: two calls cut at {cut} "
              f"equal one call bit for bit", flush=True)
        args = path_args[mode]
        xs, st, coef, kw = args
        pr = check_agc(mode, args)
        run = dict(kw, clips=False) if mode == "tx_alc" else kw
        t = {"ms": cuda_ms(lambda: fn(*xs, st, coef, **run), 20),
             "plain_ms": cuda_ms(lambda: AGC_PLAIN[mode](*xs, st, coef, **kw),
                                 1, warmup=0),
             **agc_bound(mode, *xs[0].shape), "library_ms": None}
        print(f"  agc_scan {mode} on the {AGC_PATHS[mode]} path's "
              f"{list(xs[0].shape)}: {pr}; {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.1f} ms, library none, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']} "
              f"({t['mbytes']:.1f} MB, {t['gflop']:.3f} GFLOP)", flush=True)
        out[mode] = {"shapes": res, "path": pr, **t}
    agc_edges(out, smi)
    report["agc_kernel"] = out
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {m: {"max_abs_err": o["path"]["max_abs_err"],
                **{k: o[k] for k in keys}} for m, o in out.items()}


def agc_edges(out: dict, smi: str) -> None:
    """The kernel's own edges, from an RNG stream of their own (SEED + 6):
    the tile's edges and one channel past a full grid (AGC_EDGE_SHAPES)
    and rows that are not 16-byte aligned (agc_views), each bit-equal as
    check_agc holds it; then each mode's time at C = 1, at C = 32 on 32
    distinct rows and on 32 copies of one row (what lanes in different
    states cost), beside its time on the path's [1024, 2048] (out), the
    earlier design's, its byte bound and its SASS chain estimate."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(SEED + 6)
    mhz = sm_clock_mhz()
    from probe_pll import sass_functions
    cycles = agc_tile_estimates(
        sass_functions(_kernels._target("agc_scan"))[1])
    print(f"the AGC / ALC kernel's edges [{smi}]:", flush=True)
    for mode, fn in AGC_WRAPPERS.items():
        res = {}
        for i, (Cs, Bs) in enumerate(AGC_EDGE_SHAPES):
            res[f"({Cs}, {Bs})"] = check_agc(mode, agc_case(
                mode, rng, Cs, Bs, dev, hang_enable=i % 2 == 0))
        for label, args in agc_views(agc_case(mode, rng, 33, 2048,
                                              dev)).items():
            res[label] = check_agc(mode, args)
        print(f"  agc_scan {mode} at (C, B) "
              + ", ".join(k for k in res if k.startswith("("))
              + " and on rows cut 2 samples in and of stride B+1: states "
              f"bit-equal, outputs bit-equal "
              f"{[r['bit_equal'] for r in res.values()]}, max |kernel - "
              f"plain| {max(r['max_abs_err'] for r in res.values()):.3e}",
              flush=True)
        runs = {"C=1": agc_case(mode, rng, 1, 2048, dev)}
        runs["C=32 distinct"] = agc_case(mode, rng, 32, 2048, dev)
        runs["C=32 identical"] = same_rows(runs["C=32 distinct"])
        ms = {}
        for label, (xs, st, coef, kw) in runs.items():
            run = dict(kw, clips=False) if mode == "tx_alc" else kw
            ms[label] = cuda_ms(lambda: fn(*xs, st, coef, **run), 20)
        B = 2048
        keys = ("chain_cycles_a_sample", "in_order_cycles_a_sample")
        est = {k: cycles[mode][k] * B / (mhz * 1e3) for k in keys}
        o = out[mode]
        print(f"  agc_scan {mode}: [1024, 2048] {o['ms']:.4f} ms (earlier "
              f"design {AGC_EARLIER_MS[mode]:.4f}), byte bound "
              f"{o['bytes_ms']:.4f} ms, SASS chain "
              f"{est['chain_cycles_a_sample']:.4f} ms "
              f"({cycles[mode]['chain_cycles_a_sample']:.2f} cycles a "
              f"sample; in-order {est['in_order_cycles_a_sample']:.4f} ms, "
              f"{cycles[mode]['in_order_cycles_a_sample']:.2f} cycles, at "
              f"{mhz:.0f} MHz); " + ", ".join(
                  f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
        o.update(edges=res, ms_by_rows=ms, earlier_ms=AGC_EARLIER_MS[mode],
                 sass_cycles=cycles[mode], sass_ms=est, sm_clock_mhz=mhz)


# ------------------------- slice 7b-2: the Radio through every user surface
SURF_BLOCKS = 16
SURF_PLAYBACK = 96000.0            # the playback device: x2 from 48 kHz
# (after block, surface, new dial): one retune through each CAT / TCI /
# web surface, channel 0's beat 10000 - dial Hz
SURF_RETUNES = ((3, "tci", 8800), (6, "k4", 8500), (9, "zz", 8200),
                (12, "webui", 9300))
SURF_FROM_BLOCK = 2                # as phase 26
SURF_DB = 90.0                     # played audio, card vs CPU Radio
SURF_SPEC_RTOL = 1e-4              # spectrum rows' power, card vs CPU
SURF_SECRET = "chip-smoke"
REMOTE_LSB = 1.0 / 32767.0         # the remote sound stream's 16 bits
REMOTE_CDB = 0.01                  # the remote graph stream's centi-dB
BLOCK_S = AUDIO_BLOCK / 48000.0    # the block clock
KEY_TX_DB = 80.0                   # keyed TX IQ, card vs CPU Radio
KEY_PTT_BLOCKS = 16                # the PTT leg: phase 27's length
CQ_RATE = 44100.0                  # the CQ message's WAV rate
CQ_SAMPLES = 2 * AUDIO_BLOCK       # 2 blocks at 44.1 kHz: 3 at 48 kHz
CQ_PATTERN = [True, True, True, False, True, True, True]
TCI_TX_BLOCKS = 3                  # 2 through run_once, 1 tci_transmit_once
RPTR_OFFSET_KHZ = 600.0
RPTR_TONE_HZ = 88.5
WAIT_S = 10.0


def wait_until(pred, what: str, timeout: float = WAIT_S) -> None:
    t0 = time.monotonic()
    while not pred():
        assert time.monotonic() - t0 < timeout, f"timed out: {what}"
        time.sleep(0.002)


class WsClient:
    """A masked RFC 6455 client, the role of a TCI program or a browser
    page: the upgrade, text and binary frames out, and a reader thread that
    keeps every frame the server sends."""

    def __init__(self, port: int, path: str = "/"):
        self.s = socket.create_connection(("127.0.0.1", port), timeout=WAIT_S)
        key = base64.b64encode(os.urandom(16)).decode()
        self.s.sendall((f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: "
                        f"websocket\r\nConnection: Upgrade\r\n"
                        f"Sec-WebSocket-Key: {key}\r\n"
                        f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            chunk = self.s.recv(4096)
            assert chunk, "the server closed during the upgrade"
            resp += chunk
        head, rest = resp.split(b"\r\n\r\n", 1)
        assert b" 101 " in head.split(b"\r\n")[0], head
        assert tci._ws_accept_key(key).encode() in head, head
        self.dec = tci.WsDecoder()
        self.frames: list = []
        self.lock = threading.Lock()
        self.frames += self.dec.feed(rest)
        self.stop_ = threading.Event()
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self) -> None:
        self.s.settimeout(0.1)
        while not self.stop_.is_set():
            try:
                data = self.s.recv(1 << 20)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                return
            got = self.dec.feed(data)
            with self.lock:
                self.frames += got

    def send(self, op: int, data: bytes) -> None:
        mask = os.urandom(4)
        n = len(data)
        head = bytes([0x80 | op])
        if n < 126:
            head += bytes([0x80 | n])
        elif n < 65536:
            head += bytes([0x80 | 126]) + n.to_bytes(2, "big")
        else:
            head += bytes([0x80 | 127]) + n.to_bytes(8, "big")
        m = np.frombuffer((mask * (n // 4 + 1))[:n], np.uint8)
        body = (np.frombuffer(data, np.uint8) ^ m).tobytes()
        self.s.sendall(head + mask + body)

    def text(self, msg: str) -> None:
        self.send(0x1, msg.encode())

    def taken(self, op: int) -> list:
        with self.lock:
            return [p for o, p in self.frames if o == op]

    def texts(self) -> list:
        return [p.decode() for p in self.taken(0x1)]

    def close(self) -> None:
        self.stop_.set()
        self.thread.join(timeout=WAIT_S)
        self.s.close()


def record_calls(obj, name: str) -> list:
    """Wrap obj.name so that each call's arguments and result are kept
    (copies), and return the list they go to."""
    log, fn = [], getattr(obj, name)

    def wrapped(*a, **k):
        out = fn(*a, **k)
        log.append(([np.array(x) if isinstance(x, np.ndarray) else x
                     for x in a], k, np.array(out)))
        return out
    setattr(obj, name, wrapped)
    return log


def mono_mix(r, audio: np.ndarray) -> np.ndarray:
    """The block as Radio.play and the TCI stream mix it: the stereo
    routing, then the mean of the pair (float32)."""
    st = r.mix_stereo(audio)
    return 0.5 * (st[0] + st[1])


def surface_session(r, tmp: str, side: str, card: bool) -> dict:
    """The wide Radio through every surface: the player into a WAV sink,
    TCI (RX audio, a vfo retune), K4 (FA), the ZZ pty (ZZFA), the web UI
    (/ws: spectrum rows, a freq command), and a remote control head
    (HMAC link, sound and graph over UDP); SURF_BLOCKS blocks paced at the
    block clock, one retune through each surface at SURF_RETUNES.  The
    CPU side (card=False) takes the same commands at the same blocks as
    plain calls."""
    r.enable_audio_out(f"wav:{os.path.join(tmp, side + '.wav')}")
    pushes = record_calls(r.player, "push")
    servo_out = record_calls(r.player.servo.rs, "process")
    reads, servo_read = [], r.player.servo.read

    def read(n):
        # the player's read of the servo, and how much of it was audio
        # (the rest is an underrun's zero padding)
        have = min(n, len(r.player.servo.buf))
        blk = servo_read(n)
        reads.append((have, np.array(blk)))
        return blk
    r.player.servo.read = read
    out = {"audio": [], "ms": [], "rows": [], "refreshed": []}
    if card:
        tport = r.enable_tci(0)
        kport = r.enable_k4(0)
        zz = r.enable_cat_serial("")
        wport = r.enable_webui(0)
        tcl = WsClient(tport)
        wait_until(lambda: "start;" in tcl.texts(), "TCI preamble")
        tcl.text("audio_stream_channels:1;audio_start:0;")
        wait_until(lambda: "audio_start:0;" in tcl.texts(), "audio_start")
        wcl = WsClient(wport, "/ws")
        wait_until(lambda: r.webui.n_clients == 1, "web UI client")
        k4 = socket.create_connection(("127.0.0.1", kport), timeout=WAIT_S)
        zfd = os.open(zz.slave_name, os.O_RDWR | os.O_NOCTTY)
        rsrv = remote.RemoteRadioServer(SURF_SECRET)
        rport = rsrv.start()
        head = remote.ControlHeadClient(SURF_SECRET, "127.0.0.1", rport)
        urx = remote.UdpStreamRx(timeout=WAIT_S)
        utx = remote.UdpStreamTx(("127.0.0.1", urx.port))
        out["cat_reads"] = []
    t_next = time.perf_counter()
    try:
        for k in range(SURF_BLOCKS):
            retune = [(s_, f) for b, s_, f in SURF_RETUNES if b == k]
            if card and retune and retune[0][0] == "zz":
                os.write(zfd, f"ZZFA{retune[0][1]:011d};".encode())
            n_rows = len(r.graph.waterfall)
            t0 = time.perf_counter()
            a = r.run_once()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["audio"].append(a)
            out["refreshed"].append(len(r.graph.waterfall) > n_rows)
            if out["refreshed"][-1]:
                out["rows"].append(np.array(r.graph.waterfall[-1][0]))
            if card:
                utx.send_sound(mono_mix(r, a))
                if len(r.graph.waterfall) > n_rows:
                    utx.send_graph(out["rows"][-1])
            if retune:
                surf, f = retune[0]
                if not card:
                    r.set_frequency(float(f))
                elif surf == "tci":
                    tcl.text(f"vfo:0,0,{f};")
                elif surf == "k4":
                    k4.sendall(f"FA{f:011d};".encode())
                elif surf == "webui":
                    wcl.text(json.dumps({"cmd": "freq", "value": f}))
                # set_frequency writes the shared CAT state last: the
                # retune has finished when it holds the new dial
                wait_until(lambda: r._cat_state().freq == f,
                           f"{surf} retune")
                if card:
                    # read the dial back through the K4 link and the
                    # control head: both see the one shared state
                    k4.sendall(b"FA;")
                    buf = b""
                    while not buf.endswith(b";"):
                        buf += k4.recv(64)
                    rsrv.state["freq"] = int(r.freq_hz)
                    out["cat_reads"].append(
                        (surf, f, r.freq_hz, r._cat_state().freq,
                         buf.decode(), head.command("freq")))
            if card:
                t_next += BLOCK_S
                time.sleep(max(0.0, t_next - time.perf_counter()))
        wait_until(lambda: len(r.player.servo.buf) == 0, "player drain")
        out["player"] = r.player.stats()
        if card:
            n_s = len(out["rows"])
            wait_until(lambda: sum(p[:1] == b"S" for p in wcl.taken(0x2))
                       >= n_s, "web UI spectrum rows")
            out["webui_rows"] = [np.frombuffer(p[24:], np.float32)
                                 for p in wcl.taken(0x2) if p[:1] == b"S"]
            out["webui_m"] = sum(p[:1] == b"M" for p in wcl.taken(0x2))
            got = [urx.recv() for _ in range(SURF_BLOCKS + n_s)]
            out["remote"] = got
            out["remote_lost"] = urx.lost
            out["head_ptt"] = head.command("ptt 0")
            n_tci = SURF_BLOCKS * AUDIO_BLOCK
            wait_until(lambda: sum(u[-1].size for u in (
                tci.unpack_stream(p) for p in tcl.taken(0x2))) >= n_tci,
                "TCI RX audio")
            out["tci_mono"] = np.concatenate([
                u[-1] for u in (tci.unpack_stream(p)
                                for p in tcl.taken(0x2))
                if u[4] == tci.RX_AUDIO_STREAM])
    finally:
        if card:
            head.close()
            rsrv.stop()
            urx.sock.close()
            utx.sock.close()
            os.close(zfd)
            k4.close()
            tcl.close()
            wcl.close()
        chunks = r.player.sink._chunks
        r.close()
    out["pushes"] = [p[0][0] for p in pushes]
    out["servo"] = np.concatenate([o for _, _, o in servo_out])
    out["sink_chunks"] = [np.array(c) for c in chunks]
    out["reads"] = reads
    out["wav"], out["wav_fs"] = wav.read_audio_wav(
        os.path.join(tmp, side + ".wav"))
    return out


def phase_radio_surfaces(report: dict, smi: str) -> None:
    """Phase 30: the 1024-channel Radio with every user surface attached,
    at full width, against a CPU Radio (channels=8) given the same commands
    at the same blocks."""
    with tempfile.TemporaryDirectory() as tmp:
        r = wide_radio(None, C, playback_rate=SURF_PLAYBACK)
        card = surface_session(r, tmp, "card", card=True)
        cpu = one_thread(lambda: surface_session(
            wide_radio("cpu", 8, playback_rate=SURF_PLAYBACK), tmp, "cpu",
            card=False))
    dev = torch.device(DEVICE)
    L = int(SURF_PLAYBACK / 48000.0)
    monos = [mono_mix(r, a) for a in card["audio"]]
    # the played blocks: the mono mix through a second Interpolator built as
    # enable_audio_out builds it, bit-equal to what the player was given
    from quisk_tpu_torch.ops.resample import Interpolator
    ip = Interpolator.create(L, AUDIO_BLOCK, fs_out=SURF_PLAYBACK,
                             complex_state=False, device=dev)
    st = ip.init_state(1)
    for k, m in enumerate(monos):
        st, up = ip(st, torch.as_tensor(m[None], device=dev))
        assert np.array_equal(up[0].cpu().numpy(), card["pushes"][k]), k
    # each retune landed, in freq_hz and the shared CAT state, and reads
    # back through K4 and the control head
    for surf, f, fr, cat_f, k4_read, head_read in card["cat_reads"]:
        assert fr == f and cat_f == f, (surf, f, fr, cat_f)
        assert k4_read == f"FA{f:011d};", (surf, k4_read)
        assert head_read == str(f), (surf, head_read)
    # channel 0's beat in each stretch between retunes (its last 2 blocks)
    edges = [0] + [b + 1 for b, _, _ in SURF_RETUNES] + [SURF_BLOCKS]
    dials = [WIDE_TONE_HZ - BEAT_HZ] + [f for _, _, f in SURF_RETUNES]
    beats = []
    for (lo, hi), d in zip(zip(edges[:-1], edges[1:]), dials):
        got = beat_hz(np.concatenate([a[0] for a in card["audio"][hi - 2:hi]]),
                      48000.0)
        beats.append((WIDE_TONE_HZ - d, got))
        assert abs(got - (WIDE_TONE_HZ - d)) <= 30.0, (lo, hi, d, got)
    # the played audio against the CPU Radio's
    snr = [snr_db(torch.as_tensor(c, dtype=torch.float64),
                  torch.as_tensor(g, dtype=torch.float64))
           for g, c in zip(card["pushes"][SURF_FROM_BLOCK:],
                           cpu["pushes"][SURF_FROM_BLOCK:])]
    assert min(snr) > SURF_DB, snr
    # the TCI RX stream is the mono mix, sample for sample; the remote
    # sound stream the same to 16 bits
    want = np.concatenate(monos)
    assert np.array_equal(card["tci_mono"][:want.size], want)
    sounds = [d for kind, d in card["remote"] if kind == "sound"]
    graphs = [d for kind, d in card["remote"] if kind == "graph"]
    assert len(sounds) == SURF_BLOCKS and card["remote_lost"] == 0
    remote_err = max(float(np.max(np.abs(s_ - m)))
                     for s_, m in zip(sounds, monos))
    assert remote_err <= REMOTE_LSB * (1 + 1e-6), remote_err
    # the spectrum rows: the web UI's and the remote head's equal the
    # graph's; the graph's match the CPU Radio's
    rows = card["rows"]
    assert rows and len(card["webui_rows"]) == len(rows), (
        len(card["webui_rows"]), len(rows))
    assert all(np.array_equal(w, g) for w, g in zip(card["webui_rows"], rows))
    assert len(graphs) == len(rows)
    graph_err = max(float(np.max(np.abs(g - w))) for g, w in zip(graphs, rows))
    assert graph_err < REMOTE_CDB + 1e-5, graph_err
    assert len(cpu["rows"]) == len(rows)
    spec_rel = max(float(np.max(np.abs(10 ** (a / 10) - 10 ** (b / 10)))
                         / np.max(10 ** (b / 10)))
                   for a, b in zip(rows, cpu["rows"]))
    assert spec_rel <= SURF_SPEC_RTOL, spec_rel
    # the player: what it took from the servo reached the sink and the WAV
    reads = card["reads"]
    assert len(reads) == len(card["sink_chunks"])
    assert all(np.array_equal(b.astype(np.float32), c) for (_, b), c in
               zip(reads, card["sink_chunks"]))
    stream = np.concatenate([b[:h] for h, b in reads])
    pads = sum(h < b.size for h, b in reads)
    assert np.array_equal(stream, card["servo"])
    q = (np.clip(np.concatenate(card["sink_chunks"]), -1, 1) * 32767.0
         ).astype("<i2")
    assert card["wav_fs"] == SURF_PLAYBACK
    assert np.array_equal(np.round(card["wav"] * 32768.0).astype("<i2"), q)
    pl = card["player"]
    assert pl["overruns"] == 0, pl
    # timing: run_once with the surfaces, the interpolator, mix_stereo
    run_ms = float(np.mean(card["ms"][SURF_FROM_BLOCK:]))
    # a block that refreshed the graph streams the rows (web UI, remote);
    # the ZZ pty's retune runs inside run_once, the other surfaces' on
    # their server threads between blocks
    zz = next(b for b, s_, _ in SURF_RETUNES if s_ == "zz")
    refr = [m for m, f in zip(card["ms"], card["refreshed"])
            if f][1:]
    other = [m for k, (m, f) in enumerate(zip(card["ms"], card["refreshed"]))
             if k >= SURF_FROM_BLOCK and not f and k != zz]
    x = torch.as_tensor(monos[0][None], device=dev)
    interp_ms = cuda_ms(lambda: ip(st, x), 20)
    t0 = time.perf_counter()
    for _ in range(10):
        r.mix_stereo(card["audio"][-1])
    mix_ms = (time.perf_counter() - t0) / 10 * 1e3
    bare = report["radio_wide"]["run_once_ms"]
    print(f"  wide Radio, every surface (player x{L} to "
          f"{SURF_PLAYBACK:.0f} Hz into a WAV, TCI, K4, ZZ pty, web UI, "
          f"remote head; {SURF_BLOCKS} blocks paced at the block clock): "
          f"retunes " + ", ".join(f"{s_} {f}" for _, s_, f in SURF_RETUNES)
          + " landed in freq_hz and the CAT state (read back over K4 and "
          f"the head); channel 0 beats " + ", ".join(
              f"{g:.1f}/{w:.0f}" for w, g in beats) + " Hz; played audio "
          f"card vs CPU Radio (channels=8), blocks {SURF_FROM_BLOCK}-"
          f"{SURF_BLOCKS - 1} min {min(snr):.1f} dB; TCI RX stream equal "
          f"({want.size} samples); remote sound max {remote_err:.3e} "
          f"(1 LSB {REMOTE_LSB:.3e}), graph max {graph_err:.4f} dB, lost "
          f"{card['remote_lost']}; web UI rows equal the graph's "
          f"({len(rows)} rows, {card['webui_m']} sub-RX rows), vs CPU "
          f"{spec_rel:.2e} of the peak power; sink = servo output "
          f"({stream.size} samples, {pads} underrun pads), WAV = sink",
          flush=True)
    print(f"wide Radio surfaces timing [{smi}]: run_once with every surface "
          f"{run_ms:.4f} ms/block (host clock, blocks {SURF_FROM_BLOCK}-"
          f"{SURF_BLOCKS - 1}, max {max(card['ms'][SURF_FROM_BLOCK:]):.4f}; "
          f"{np.mean(refr):.4f} on the {len(refr)} blocks after the first "
          f"that refreshed the graph and streamed its rows, "
          f"{card['ms'][zz]:.4f} on block {zz}, which retuned from the ZZ "
          f"pty inside it, {np.mean(other):.4f} on the {len(other)} "
          f"others), "
          f"bare (phase 26, this call) {bare:.4f}; Interpolator x{L} "
          f"{interp_ms:.4f} ms (events); mix_stereo at {C} channels "
          f"{mix_ms:.4f} ms (host); player fill {pl['fill']:.3f}, underruns "
          f"{pl['underruns']}, overruns {pl['overruns']}, blocks played "
          f"{pl['blocks_played']}", flush=True)
    report["radio_surfaces"] = {
        "run_once_ms": run_ms, "run_once_ms_blocks": card["ms"],
        "refreshed": card["refreshed"],
        "run_once_ms_refresh": float(np.mean(refr)),
        "run_once_ms_other": float(np.mean(other)),
        "run_once_ms_zz_retune": card["ms"][zz],
        "bare_run_once_ms": bare, "interp_ms": interp_ms, "mix_ms": mix_ms,
        "cpu_match_min_db": min(snr), "beats_hz": beats,
        "remote_sound_err": remote_err, "remote_graph_err_db": graph_err,
        "spec_rel": spec_rel, "player": pl, "underrun_pads": pads,
        "webui_rows": len(rows), "webui_subrx_rows": card["webui_m"]}


def keyed_radio(device, mic):
    """Phase 27's loopback session (tests/test_tx_runtime.py:124-156) up to
    the mic: ``mic`` a source for enable_mic (the card) or an object with
    get(n) (the CPU's replay of the card's mic blocks)."""
    r = Radio(RadioConfig(sample_rate=48000.0, audio_block=AUDIO_BLOCK,
                          mode="USB", tune_hz=9000.0, agc=False),
              hardware="loopback", device=device)
    r.open()
    r.enable_tx()
    r.tx_monitor = True
    r.run_once()
    r.transmit(np.zeros(r.tx.block, np.float32), ptt=True)
    if isinstance(mic, str):
        r.enable_mic(mic)
    else:
        r.mic = mic
    return r


def keyed_session(r, cq_path: str, tci_audio: np.ndarray, card: bool,
                  hook=None) -> list:
    """Key the loopback Radio from each live source in turn: PTT, the CQ
    keyer (one repeat, then stop_cq), a TCI client's trx with its TX audio
    stream (then tci_transmit_once), a MIDI PTT note, the serial key, and a
    repeater favourite.  Before each block the card waits for a block of
    mic in the capture (the mic clock paces the loop).  Returns one record
    a block: source, keyed, audio row 0, TX IQ, kTxAlc launches, ms."""
    recs = []
    B = AUDIO_BLOCK

    def step(source, fn=None):
        if card:
            wait_until(lambda: r.mic.fill >= B, "mic capture")
        r.tx_iq_last = None
        n0 = agc_scan.tx_alc_scan.launches
        t0 = time.perf_counter()
        a = (fn or r.run_once)()
        ms = (time.perf_counter() - t0) * 1e3
        recs.append({"source": source, "keyed": r.tx_iq_last is not None,
                     "audio": None if fn else a[0], "iq": r.tx_iq_last,
                     "launches": agc_scan.tx_alc_scan.launches - n0,
                     "ms": ms, "keyed_flag": r._keyed,
                     "tx_freq": r.hw.tx_frequency,
                     "ctcss": float(r.tx.ctcss_amp)})

    r.set_ptt(True)
    for _ in range(KEY_PTT_BLOCKS):
        step("ptt")
    if hook is not None:
        hook(r)
    r.set_ptt(False)
    step("idle")
    r.play_cq(cq_path, repeat_secs=B / 48000.0)
    for _ in CQ_PATTERN:
        step("cq")
    r.stop_cq()
    step("idle")
    r.enable_tci(0)
    cl = WsClient(r.tci.port)
    try:
        wait_until(lambda: "start;" in cl.texts(), "TCI preamble")
        cl.text("trx:0,true;")
        wait_until(lambda: r.tci.tx_client is not None, "TCI trx")
        for k in range(TCI_TX_BLOCKS):
            st_ = np.repeat(tci_audio[k * B:(k + 1) * B], 2)  # I = Q
            cl.send(0x2, tci.pack_stream(0, 48000, st_.astype(np.float32),
                                         tci.TX_AUDIO_STREAM))
        wait_until(lambda: r.tci.tx_pending() >= TCI_TX_BLOCKS * B,
                   "TCI TX audio")
        for _ in range(TCI_TX_BLOCKS - 1):
            step("tci")
        step("tci", r.tci_transmit_once)
        cl.text("trx:0,false;")
        wait_until(lambda: r.tci.tx_client is None, "TCI trx release")
        step("idle")
    finally:
        cl.close()
    r.enable_midi()
    r.midi_in.feed(bytes([0x90, 0x14, 100]))       # the PTT note
    step("midi")
    step("midi")
    r.midi_in.feed(bytes([0x80, 0x14, 0]))
    step("idle")
    bits = {"cts": 0}
    r.enable_serial_key(cts="PTT when high",
                        read_bits=lambda: (bits["cts"], 0))
    bits["cts"] = 1
    step("serial")
    step("serial")
    bits["cts"] = 0
    step("idle")
    fav = r.enable_favorites()
    fav.add("rptr", r.freq_hz, "FM", offset_khz=RPTR_OFFSET_KHZ,
            tone_hz=RPTR_TONE_HZ)
    r.tune_favorite(0)
    step("idle")
    r.set_ptt(True)
    step("favourite")
    step("favourite")
    r.set_ptt(False)
    step("idle")
    return recs


def phase_radio_keyed(report: dict, smi: str, rng) -> dict:
    """Phase 31: the keyed Radio from its live sources on the card, each
    keyed block against a CPU Radio fed the same mic blocks and commands;
    kTxAlc once a keyed block and bit-equal to its plain version on one."""
    n = (KEY_PTT_BLOCKS + 8) * AUDIO_BLOCK
    voice = voice_like(rng, n, 1, band=(400.0, 2300.0))[0]
    voice = (0.5 * voice / np.max(np.abs(voice))).astype(np.float32)
    t = np.arange(CQ_SAMPLES) / CQ_RATE
    cq = (0.3 * np.sin(2 * np.pi * 800.0 * t)).astype(np.float32)
    tci_audio = (0.3 * voice_like(rng, TCI_TX_BLOCKS * AUDIO_BLOCK, 1)[0]
                 / 4.0).astype(np.float32)
    alc = {}

    def alc_block(r):
        # one keyed block's ALC arguments: the TX chain's pre-ALC IQ of the
        # last mic block from the state the chain holds now
        m = torch.as_tensor(mic_log[-1][2][None], device=r.device)
        st = r._tx_state
        _, iq = r.tx.pre_alc(st, m)
        alc["args"] = r.tx.alc.scan_inputs(st["alc"], iq)[1]

    with tempfile.TemporaryDirectory() as tmp:
        vpath = os.path.join(tmp, "voice.wav")
        wav.write_audio_wav(vpath, voice, 48000.0)
        cq_path = os.path.join(tmp, "cq.wav")
        wav.write_audio_wav(cq_path, cq, CQ_RATE)
        r = keyed_radio(None, f"wav:{vpath}")
        mic_log = record_calls(r.mic, "get")
        try:
            recs = keyed_session(r, cq_path, tci_audio, card=True,
                                 hook=alc_block)
            mic = r.mic.stats()
        finally:
            r.close()
        mic_blocks = np.concatenate([o for _, _, o in mic_log])
        cpu = one_thread(lambda: keyed_radio("cpu", ArrayMic(mic_blocks)))
        try:
            cpu_recs = one_thread(lambda: keyed_session(
                cpu, cq_path, tci_audio, card=False))
        finally:
            cpu.close()
    assert mic["starved"] == 0, mic
    assert len(recs) == len(cpu_recs)
    by = {}
    for g, c in zip(recs, cpu_recs):
        assert g["source"] == c["source"] and g["keyed"] == c["keyed"], (g, c)
        src = g["source"]
        e = by.setdefault(src, {"keyed": 0, "db": [], "ms": [],
                                "launches": 0})
        e["launches"] += g["launches"]
        if g["keyed"]:
            e["keyed"] += 1
            e["ms"].append(g["ms"])
            e["db"].append(snr_db(torch.as_tensor(c["iq"]),
                                  torch.as_tensor(g["iq"])))
            assert g["launches"] == 1, (src, g["launches"])
        else:
            assert g["launches"] == 0, (src, g["launches"])
    sources = ("ptt", "cq", "tci", "midi", "serial", "favourite")
    for src in sources:
        e = by[src]
        assert e["keyed"] > 0 and min(e["db"]) >= KEY_TX_DB, (src, e["db"])
    assert not by["idle"]["keyed"], by["idle"]
    assert [g["keyed"] for g in recs if g["source"] == "cq"] == CQ_PATTERN
    assert by["tci"]["keyed"] == TCI_TX_BLOCKS
    fav = [g for g in recs if g["source"] == "favourite"]
    assert all(g["tx_freq"] == 9000 + RPTR_OFFSET_KHZ * 1000
               and g["ctcss"] > 0 for g in fav), fav
    assert recs[-1]["tx_freq"] == 9000 and recs[-1]["ctcss"] == 0.0
    ptt = [g for g in recs if g["source"] == "ptt"]
    ptt_mic = mic_blocks[:len(ptt) * AUDIO_BLOCK]
    rho, lag = voice_correlation(ptt_mic, np.concatenate(
        [g["audio"] for g in ptt]))
    assert rho > RADIO_RHO, (rho, lag)
    check = check_agc("tx_alc", alc["args"])
    xs, st, coef, kw = alc["args"]
    fn = agc_scan.tx_alc_scan
    t = {"ms": cuda_ms(lambda: fn(*xs, st, coef, **dict(kw, clips=False)),
                       20),
         "plain_ms": cuda_ms(lambda: agc_scan.tx_alc_plain(*xs, st, coef,
                                                           **kw),
                             1, warmup=0),
         **agc_bound("tx_alc", *xs[0].shape), "library_ms": None}
    launches = sum(e["launches"] for e in by.values())
    print(f"  keyed Radio from its live sources (loopback, C=1; the mic a "
          f"48 kHz WAV through AudioCapture, the loop paced by its fill): "
          f"mic captured {mic['captured']}, starved {mic['starved']}, "
          f"dropped {mic['dropped']}; TX IQ card vs CPU Radio, min dB a "
          f"source: " + ", ".join(f"{s_} {min(by[s_]['db']):.1f} "
                                  f"({by[s_]['keyed']} blocks)"
                                  for s_ in sources)
          + f"; CQ keyed {CQ_PATTERN}; repeater TX dial "
          f"{fav[0]['tx_freq']} Hz with CTCSS {RPTR_TONE_HZ} Hz, restored "
          f"on key-up; voice rho {rho:.4f} at lag {lag}; kTxAlc once a "
          f"keyed block ({launches} launches), bit-equal to the plain "
          f"version on one PTT block: {check}", flush=True)
    print(f"keyed Radio sources timing [{smi}]: ms a keyed block (host "
          f"clock, run_once or tci_transmit_once alone): " + ", ".join(
              f"{s_} {np.mean(by[s_]['ms']):.4f}" for s_ in sources)
          + f"; kTxAlc at [1, {AUDIO_BLOCK}] {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.6f} ms by "
          f"{t['bound_by']}", flush=True)
    report["radio_keyed"] = {
        "sources": {s_: {"keyed_blocks": by[s_]["keyed"],
                         "cpu_match_min_db": min(by[s_]["db"]),
                         "keyed_ms": float(np.mean(by[s_]["ms"]))}
                    for s_ in sources},
        "mic": mic, "rho": rho, "alc": check, **t}
    return {"launches": launches, "max_abs_err": check["max_abs_err"], **t}


# --------------------------------- slice 6: parallel/ on torch.distributed
PAR_BLOCKS = 8
PAR_TOL = 1e-6             # sharded vs unsharded flagship, of the peak, if
                           # not bit-equal
TS_SAMPLES = 1 << 17       # the halo-exchange receive path's capture
TS_FS = 192000.0
TS_TUNE_HZ = 10000.0
TS_STREAM = 4              # blocks of the unsharded streaming route
TS_TOL = 1e-5              # 2 ranks vs 1 rank, of the peak
TS_FM_TUNE_HZ = -30000.0   # the FM call: tests/test_torch_parallel.py's
TS_FM_BAND = (-6250.0, 6250.0)     # station, channel filter and floor
TS_FM_TAPS = 1025
TS_FM_DB = 60.0            # vs float64 from TS_FM_SKIP (the first nonzero
TS_FM_SKIP = 512           # x * conj(x) underflows float32 to a signed 0)
TS_AM_TUNE_HZ = 25000.0    # the AM call: tests/torch_parallel_ranks.py's
TS_AM_BAND = (-4000.0, 4000.0)     # station and channel filter, and
TS_AM_DB = 80.0            # tests/test_torch_parallel.py's floor
PAR_PFB_BLOCKS = 3
PAR_PFB_TOL = 1e-5         # sharded PFB step vs unsharded, of the peak
REH_BLOCKS = 6             # the rehearsal's flagship job (192 kS/s, 256)
REH_SKIP = 1024            # the 1025-tap filter's warm-up (FM on ~0 input)
REH_TOL = 1e-4             # rehearsal vs unsharded card chain, of the peak
REH_PFB_RATE = 96000.0     # the worker's PFB job (thirds USB/AM/FM)
REH_TIMEOUT_S = 300


def stepper(ch, s0, stepf, xs):
    """fn() for cuda_ms: one step of ``stepf(ch, state, x)``, the state
    carried, the blocks xs[0] and xs[1] in turn."""
    box = {"st": s0, "i": 0}

    def f():
        box["st"], _ = stepf(ch, box["st"], xs[box["i"] % 2])
        box["i"] += 1
    return f


def unsharded_ms(chain, xs) -> list[float]:
    """The unsharded RxChain.step's ms/block by events, two turns."""
    f = stepper(chain, chain.init_state(), lambda c, s, x: c.step(s, x), xs)
    return [cuda_ms(f, iters=20, warmup=2) for _ in range(2)]


def sharded_flagship(dev, smi: str, mesh, chain, xs) -> dict:
    """The flagship through make_sharded_step at full width against the
    unsharded RxChain.step on the same blocks xs."""
    from quisk_tpu_torch.parallel.scaling import flagship
    from quisk_tpu_torch.parallel.shard import (make_sharded_step,
                                                shard_over_channels,
                                                twin_count)

    twin = flagship(twin_count(C), sample_rate=FS, audio_block=AUDIO_BLOCK,
                    device=dev)
    step = make_sharded_step(chain, mesh, C)
    chain_l = shard_over_channels(chain, mesh, C, twin)
    st_l = shard_over_channels(chain.init_state(), mesh, C,
                               twin.init_state())
    st, ref = chain.init_state(), []
    for x in xs:
        st, a = chain.step(st, x)
        ref.append(a)
    reset_launches()
    mesh.counts.clear()
    got = []
    for x in xs:
        st_l, a = step(chain_l, st_l, x)
        got.append(a)
    torch.cuda.synchronize()
    n, calls = launches(), dict(mesh.counts)
    print(f"  sharded flagship, world of one over NCCL: {PAR_BLOCKS} "
          f"blocks, front launches {n}, collective calls {calls}",
          flush=True)
    assert n == {"plain": PAR_BLOCKS, "gained": 0, "nb": 0}, n
    assert not calls, calls
    for a in got:
        assert a.shape == (C, AUDIO_BLOCK) and bool(torch.isfinite(a).all())
    equal = all(torch.equal(a, b) for a, b in zip(got, ref))
    peak = max(float(b.abs().max()) for b in ref)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    print(f"  sharded vs unsharded RxChain.step: bit-equal {equal}, max "
          f"abs diff {err:.3e} (peak {peak:.3f})", flush=True)
    assert equal or err <= PAR_TOL * peak, err
    kern = check_plain_mode(chain_l.front, xs[:2])
    turns = {"unsharded": stepper(chain, chain.init_state(),
                                  lambda c, s, x: c.step(s, x), xs),
             "sharded": stepper(chain_l, st_l, step, xs)}
    ms = {"unsharded": [], "sharded": []}
    for which in ("unsharded", "sharded", "sharded", "unsharded"):
        ms[which].append(cuda_ms(turns[which], iters=20, warmup=2))
    print(f"  timing [{smi}] ms/block (events, in turns): unsharded "
          f"{ms['unsharded']}, sharded {ms['sharded']}", flush=True)
    return {"blocks": PAR_BLOCKS, "launches": n["plain"],
            "collectives": calls, "bit_equal": equal, "max_abs_diff": err,
            "max_abs_err": kern["max_abs_err"], "ms": ms}


def timeshard_stream(iq, stages, bp) -> torch.Tensor:
    """The unsharded route of timeshard_rx's SSB: the port's NCO and FIR
    ops streamed over the capture in TS_STREAM blocks (the channel filter
    by overlap-save), 2 * Re of the filter's output."""
    from quisk_tpu_torch.ops.fir import make_fir
    from quisk_tpu_torch.ops.nco import NCO

    Cn, N = iq.shape
    Bb = N // TS_STREAM
    nco = NCO.create(TS_TUNE_HZ, TS_FS, Bb, Cn, device=iq.device)
    ops, b = [], Bb
    for taps, d in stages:
        ops.append(make_fir(taps, b, decim=d, device=iq.device))
        b //= d
    ops.append(OverlapSaveFIR.create(bp, b, device=iq.device))
    states = [nco.init_state(Cn)] + [op.init_state(Cn) for op in ops]
    out = []
    for k in range(TS_STREAM):
        states[0], y = nco(states[0], iq[:, k * Bb:(k + 1) * Bb])
        for i, op in enumerate(ops):
            states[i + 1], y = op(states[i + 1], y)
        out.append(2.0 * y.real)
    return torch.cat(out, dim=-1)


def ts_oracle_db(iq_row: np.ndarray, audio_row: np.ndarray, stages,
                 bp) -> float:
    bb = dsp.mix_down(iq_row.astype(np.complex128), TS_TUNE_HZ, TS_FS)
    for taps, d in stages:
        _, bb = dsp.fir_stream(bb, taps, decim=d)
    _, bb = dsp.fir_stream(bb, bp)
    return float(dsp.snr_db(2.0 * np.real(bb), audio_row, skip=64))


def snr_rows_t(ref: torch.Tensor, got: torch.Tensor) -> float:
    """The lowest row SNR in dB of got against ref (float64)."""
    ref, got = ref.double(), got.double()
    err = (got - ref).pow(2).mean(dim=-1)
    return float((10 * torch.log10(ref.pow(2).mean(dim=-1) / err)).min())


def sharded_timeshard(dev, smi: str, mesh) -> dict:
    """timeshard_rx over a (chan, time) = (1, 1) mesh at full width against
    the unsharded streaming route and, on rows 0-1, the float64 oracle."""
    from quisk_tpu_torch.parallel.scaling import (seeded_capture,
                                                  timeshard_filters)
    from quisk_tpu_torch.parallel.timeshard import timeshard_rx

    stages, bp = timeshard_filters()
    iq = seeded_capture(C, TS_SAMPLES, dev)      # the rehearsal's capture

    def run():
        return timeshard_rx(iq, mesh, sample_rate=TS_FS, tune_hz=TS_TUNE_HZ,
                            stages=stages, bp_taps=bp, mode="ssb")

    mesh.counts.clear()
    audio = run()
    torch.cuda.synchronize()
    calls = dict(mesh.counts)
    assert audio.shape == (C, TS_SAMPLES // 4), audio.shape
    assert bool(torch.isfinite(audio).all()) and not calls, calls
    ref = timeshard_stream(iq, stages, bp)
    rows = snr_rows_t(ref, audio)
    oracle = [ts_oracle_db(iq[c].cpu().numpy(), audio[c].cpu().numpy(),
                           stages, bp) for c in (0, 1)]
    print(f"  timeshard_rx, world of one, {C} x {TS_SAMPLES} at "
          f"{TS_FS / 1e3:.0f} kS/s: vs the streaming route min row "
          f"{rows:.1f} dB; rows 0-1 vs float64 {oracle[0]:.1f}, "
          f"{oracle[1]:.1f} dB; collective calls {calls}", flush=True)
    assert rows > CPU_MATCH_DB and min(oracle) > CPU_MATCH_DB
    ms = cuda_ms(run, iters=5, warmup=1)
    msps = C * TS_SAMPLES / (ms * 1e-3) / 1e6
    ms_stream = cuda_ms(lambda: timeshard_stream(iq, stages, bp), iters=3,
                        warmup=1)
    print(f"  timing [{smi}]: timeshard_rx {ms:.4f} ms for "
          f"{TS_SAMPLES / TS_FS * 1e3:.1f} ms of signal = {msps:.1f} Msps "
          f"in; the streaming route {ms_stream:.4f} ms", flush=True)
    fm = timeshard_fm(dev, smi, mesh, stages)
    am = timeshard_am(dev, smi, mesh, stages)
    return {"audio": audio, "min_row_db": rows, "oracle_db": oracle,
            "ms": ms, "msps": msps, "stream_ms": ms_stream, "fm": fm,
            "am": am}


def timeshard_fm(dev, smi: str, mesh, stages) -> dict:
    """timeshard_rx in FM mode at full width on the same mesh (the
    discriminator's halo and the de-emphasis one-pole's all_gather over
    NCCL): an FM station on every row, rows 0 and C-1 against the float64
    oracle from TS_FM_SKIP."""
    from quisk_tpu_torch.parallel.timeshard import timeshard_rx

    voice = sources.voice_like(TS_FS, TS_SAMPLES, band=(300.0, 2700.0),
                               seed=6)
    row = sources.fm_signal(voice, TS_FS, deviation_hz=2500.0,
                            carrier_hz=TS_FM_TUNE_HZ)
    iq = torch.as_tensor(row.astype(np.complex64), device=dev).expand(
        C, TS_SAMPLES).contiguous()
    bp = design.bandpass_analytic(TS_FM_TAPS, *TS_FM_BAND, TS_FS / 4)

    def run():
        return timeshard_rx(iq, mesh, sample_rate=TS_FS,
                            tune_hz=TS_FM_TUNE_HZ, stages=stages, bp_taps=bp,
                            mode="fm", fm_deviation_hz=2500.0)

    mesh.counts.clear()
    audio = run()
    torch.cuda.synchronize()
    calls = dict(mesh.counts)
    assert audio.shape == (C, TS_SAMPLES // 4), audio.shape
    assert bool(torch.isfinite(audio).all())
    assert calls == {"all_gather": 1}, calls
    bb = dsp.mix_down(row.astype(np.complex128), TS_FM_TUNE_HZ, TS_FS)
    for taps, d in stages:
        _, bb = dsp.fir_stream(bb, taps, decim=d)
    _, bb = dsp.fir_stream(bb, bp)
    ref = dsp.fm_demod(bb, TS_FS / 4, 2500.0)
    db = [float(dsp.snr_db(ref, audio[c].cpu().numpy(), skip=TS_FM_SKIP))
          for c in (0, C - 1)]
    ms = cuda_ms(run, iters=3, warmup=1)
    print(f"  timeshard_rx FM, world of one, {C} x {TS_SAMPLES}: rows 0 and "
          f"{C - 1} vs float64 from sample {TS_FM_SKIP}: {db[0]:.1f}, "
          f"{db[1]:.1f} dB; collective calls {calls}; {ms:.4f} ms "
          f"[{smi}]", flush=True)
    assert min(db) > TS_FM_DB, db
    return {"oracle_db": db, "collectives": calls, "ms": ms}


def timeshard_am(dev, smi: str, mesh, stages) -> dict:
    """timeshard_rx in AM mode at full width on the same mesh (the
    envelope difference's one-sample halo and the 0.995 one-pole's
    all_gather over NCCL): an AM station on every row, rows 0 and C-1
    against the float64 oracle."""
    from quisk_tpu_torch.parallel.timeshard import timeshard_rx

    voice = sources.voice_like(TS_FS, TS_SAMPLES, band=(300.0, 2700.0),
                               seed=8)
    row = sources.am_signal(voice / np.max(np.abs(voice)), TS_FS,
                            carrier_hz=TS_AM_TUNE_HZ)
    iq = torch.as_tensor(row.astype(np.complex64), device=dev).expand(
        C, TS_SAMPLES).contiguous()
    bp = design.bandpass_analytic(TS_FM_TAPS, *TS_AM_BAND, TS_FS / 4)

    def run():
        return timeshard_rx(iq, mesh, sample_rate=TS_FS,
                            tune_hz=TS_AM_TUNE_HZ, stages=stages, bp_taps=bp,
                            mode="am")

    mesh.counts.clear()
    audio = run()
    torch.cuda.synchronize()
    calls = dict(mesh.counts)
    assert audio.shape == (C, TS_SAMPLES // 4), audio.shape
    assert bool(torch.isfinite(audio).all())
    assert calls == {"all_gather": 1}, calls
    bb = dsp.mix_down(row.astype(np.complex128), TS_AM_TUNE_HZ, TS_FS)
    for taps, d in stages:
        _, bb = dsp.fir_stream(bb, taps, decim=d)
    _, bb = dsp.fir_stream(bb, bp)
    ref = dsp.am_demod(bb, pole=0.995, gain=1.0)
    db = [float(dsp.snr_db(ref, audio[c].cpu().numpy(), skip=64))
          for c in (0, C - 1)]
    ms = cuda_ms(run, iters=3, warmup=1)
    print(f"  timeshard_rx AM, world of one, {C} x {TS_SAMPLES}: rows 0 and "
          f"{C - 1} vs float64 from sample 64: {db[0]:.1f}, {db[1]:.1f} dB; "
          f"collective calls {calls}; {ms:.4f} ms [{smi}]", flush=True)
    assert min(db) > TS_AM_DB, db
    return {"oracle_db": db, "collectives": calls, "ms": ms}


def sharded_pfb(dev, smi: str, mesh) -> dict:
    """The time-sharded PFB step at the PFB receiver's width (kernel #4)
    against the unsharded OversampledPFB + MixedDemod on the same blocks."""
    from quisk_tpu_torch.ops.channelizer import OversampledPFB
    from quisk_tpu_torch.ops.demod import MixedDemod
    from quisk_tpu_torch.parallel.comm import all_to_all
    from quisk_tpu_torch.parallel.pfbshard import (make_sharded_pfb_step,
                                                   shard_pfb_inputs)

    K, B = PFB_K, PFB_K * PFB_MULT
    pfb = OversampledPFB.create(K, B, pallas_poly=True, device=dev)

    def demod(k):
        return MixedDemod.create(quarters(k), sample_rate=PFB_RATE,
                                 channels=k, device=dev)

    dm = demod(K)
    step = make_sharded_pfb_step(pfb, dm, mesh)
    dm_l, st_l = shard_pfb_inputs(dm, mesh, K, demod(2))
    gen = torch.Generator(dev).manual_seed(SEED + 12)
    xs = [pfb_signal(dev, gen, K, B, b) for b in range(PAR_PFB_BLOCKS)]
    h, st, refs = pfb.init_state(1), dm.init_state(K), []
    for x in xs:
        h, ch = pfb(h, x)
        st, a = dm(st, ch.reshape(K, -1))
        refs.append((a, (ch.real * ch.real + ch.imag * ch.imag).mean(-1)[0]))
    del ch
    hist = pfb.init_state(1)
    reset_launches()
    mesh.counts.clear()
    outs = []
    for x in xs:
        st_l, hist, a, sp = step(dm_l, st_l, hist, x)
        outs.append((a[0], sp[0]))
    torch.cuda.synchronize()
    n, calls = pfb_launches()["poly_os"], dict(mesh.counts)
    print(f"  sharded PFB step, world of one over NCCL, K={K}, "
          f"B={B}: {PAR_PFB_BLOCKS} blocks, kernel #4 launches {n}, "
          f"collective calls {calls}", flush=True)
    assert n == PAR_PFB_BLOCKS and calls == {"all_to_all": PAR_PFB_BLOCKS}
    equal, worst = True, 0.0
    for (a, sp), (ra, rsp) in zip(outs, refs):
        assert a.shape == ra.shape and bool(torch.isfinite(a).all())
        equal = equal and torch.equal(a, ra) and torch.equal(sp, rsp)
        worst = max(worst, float((a - ra).abs().max() / ra.abs().max()))
        assert torch.allclose(sp, rsp, rtol=PAR_PFB_TOL, atol=0.0)
    print(f"  sharded vs unsharded: bit-equal {equal}, max abs diff "
          f"{worst:.3e} of the peak", flush=True)
    assert worst <= PAR_PFB_TOL, worst
    v = pk.pfb_poly_oversampled(pfb.init_state(1), xs[0], pfb.h_poly)
    vp = pk.pfb_poly_oversampled_plain(pfb.init_state(1), xs[0], pfb.h_poly)
    poly_err = float((v - vp).abs().max())
    assert poly_err <= POLY_TOL * float(vp.abs().max()), poly_err
    del v, vp

    # timing in turns: the sharded step, the unsharded torch-op pipeline
    # of the same ops, the PFB receiver's kernel route; then the stages
    rx = pfb_pipeline(dev, PFB_MULT, True)
    box = {"sh": (st_l, hist), "un": (pfb.init_state(1), dm.init_state(K)),
           "rx": rx.init_state(1)}

    def sharded():
        s, hh = box["sh"]
        s, hh, _, _ = step(dm_l, s, hh, xs[0])
        box["sh"] = (s, hh)

    def unsharded():
        hh, s = box["un"]
        hh, ch = pfb(hh, xs[0])
        s, _ = dm(s, ch.reshape(K, -1))
        box["un"] = (hh, s)

    def kernel_route():
        box["rx"], _ = rx(box["rx"], xs[0])

    runs = {"sharded": sharded, "unsharded": unsharded,
            "receiver kernel route": kernel_route}
    ms = {k: [] for k in runs}
    for which in ("sharded", "unsharded", "receiver kernel route",
                  "receiver kernel route", "unsharded", "sharded"):
        ms[which].append(cuda_ms(runs[which], iters=5, warmup=1))
    del rx, box
    hist0 = pfb.init_state(1)
    _, vv = pfb.poly_stacked(hist0, xs[0])
    yr, yi = pfb.idft_ri(vv[:, :, 0], vv[:, :, 1])
    zr, zi = pfb.rotate_tm(yr, yi)
    z = all_to_all(mesh, "dev", torch.complex(zr, zi), 2, 1)
    chm = z.transpose(1, 2).reshape(K, -1)
    stages = {
        "poly (kernel #4)": cuda_ms(
            lambda: pfb.poly_stacked(hist0, xs[0]), 5),
        "idft": cuda_ms(lambda: pfb.idft_ri(vv[:, :, 0], vv[:, :, 1]), 5),
        "rotate": cuda_ms(lambda: pfb.rotate_tm(yr, yi), 5),
        "corner turn (all_to_all)": cuda_ms(
            lambda: all_to_all(mesh, "dev", torch.complex(zr, zi), 2, 1), 5),
        "demod": cuda_ms(lambda: dm_l(dm_l.init_state(K), chm), 5),
        "spec": cuda_ms(lambda: (z.real * z.real + z.imag * z.imag
                                 ).mean(dim=1), 5),
    }
    print(f"  timing [{smi}] ms/block (events, in turns): "
          + "; ".join(f"{k} {v}" for k, v in ms.items()), flush=True)
    print("  sharded step's stages (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()), flush=True)
    return {"blocks": PAR_PFB_BLOCKS, "launches": n, "collectives": calls,
            "bit_equal": equal, "max_rel_diff": worst, "poly_err": poly_err,
            "ms": ms, "stages_ms": stages}


def phase_parallel_world1(report: dict, smi: str) -> dict:
    """Phase 32: the parallel paths in a world of one over NCCL at full
    width, and the scaling harness there."""
    import torch.distributed as dist
    from quisk_tpu_torch.parallel import comm, scaling

    dev = torch.device(DEVICE)
    chain = scaling.flagship(C, sample_rate=FS, audio_block=AUDIO_BLOCK,
                             device=dev)
    gen = torch.Generator(dev).manual_seed(SEED + 11)
    xs = [torch.randn((C, chain.block_in), dtype=torch.complex64,
                      generator=gen, device=dev) for _ in range(PAR_BLOCKS)]
    # the unsharded step before the process group exists, with it (the
    # sharded step's turns) and after it is destroyed: what the group
    # itself costs the step
    group_ms = {"before init_world": unsharded_ms(chain, xs)}
    tmp = tempfile.mkdtemp()
    dev = comm.init_world(f"file://{tmp}/store", 0, 1, "nccl",
                          device=DEVICE)
    try:
        out = {"flagship": sharded_flagship(dev, smi,
                                            comm.make_mesh(device=dev),
                                            chain, xs)}
        del xs[2:]
        torch.cuda.empty_cache()
        mesh2 = comm.make_mesh((1, 1), ("chan", "time"), device=dev)
        out["timeshard"] = sharded_timeshard(dev, smi, mesh2)
        torch.cuda.empty_cache()
        out["pfb"] = sharded_pfb(dev, smi, comm.make_mesh(axis="dev",
                                                          device=dev))
        torch.cuda.empty_cache()
        kw = dict(device_counts=(1,), channels_per_device=C, sample_rate=FS,
                  audio_block=AUDIO_BLOCK, iters=5, device=dev)
        weak = scaling.measure_scaling(**kw)
        strong = scaling.measure_scaling(weak=False, **kw)
        ts_sps, ts_ms = scaling.measure_timeshard(mesh2, C, TS_SAMPLES)
        # one rank on one card: silicon of its own
        assert not any(p.shared for p in weak + strong)
        assert all(scaling.efficiency_within_bound(p) for p in weak + strong)
        print(scaling.format_table(weak, f"weak, world of one over NCCL, "
                                         f"{smi}"), flush=True)
        print(scaling.format_table(strong, f"strong, world of one over "
                                           f"NCCL, {smi}"), flush=True)
        print(f"scaling (timeshard, world of one over NCCL, {smi}): "
              f"{C} ch x {TS_SAMPLES} samples  {ts_sps / 1e6:.1f} Msps  "
              f"{ts_ms:.4f} ms", flush=True)
        out["scaling"] = {"weak": [dataclasses.asdict(p) for p in weak],
                          "strong": [dataclasses.asdict(p) for p in strong],
                          "timeshard_msps": ts_sps / 1e6,
                          "timeshard_ms": ts_ms}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    group_ms["with the group"] = out["flagship"]["ms"]["unsharded"]
    group_ms["after destroy_process_group"] = unsharded_ms(chain, xs)
    del chain, xs
    print(f"  timing [{smi}] the unsharded flagship step, ms/block (events): "
          + "; ".join(f"{k} {v}" for k, v in group_ms.items()), flush=True)
    out["group_ms"] = group_ms
    report["parallel_world1"] = {k: ({kk: vv for kk, vv in v.items()
                                      if kk != "audio"}
                                     if isinstance(v, dict) else v)
                                 for k, v in out.items()}
    return out


def run_workers(outdir: str, job: list[str], nproc: int = 2) -> list[dict]:
    """``nproc`` ranks of dcn_worker over gloo, all on this card; their npz
    files by pid.  A rank that fails or outlasts REH_TIMEOUT_S is fatal."""
    os.makedirs(outdir)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "quisk_tpu_torch.parallel.dcn_worker",
         "--pid", str(pid), "--nproc", str(nproc),
         "--init", f"file://{outdir}/store", "--backend", "gloo",
         "--device", DEVICE, "--outdir", outdir, "--timeout", "240", *job],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=REH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} of {job}:\n{out}"
    name = {"--pfb": "pfb", "--timeshard": "ts"}.get(job[0], "audio")
    return [dict(np.load(os.path.join(outdir, f"{name}_p{pid}.npz")))
            for pid in range(nproc)]


def rehearsal_line(label: str, parts: list[dict]) -> dict:
    from quisk_tpu_torch.parallel.dcn_worker import COUNT_KINDS as kinds

    ranks = []
    for pid, z in enumerate(parts):
        ms = z["step_ms"].tolist()
        counts = dict(zip(kinds, z["counts"].tolist()))
        ranks.append({"step_ms": ms, "counts": counts,
                      "launches": dict(zip(("front", "pfb_poly"),
                                           z["launches"].tolist()))})
        print(f"  rehearsal {label}, rank {pid}: ms a step {ms} (the first "
              f"builds its kernels), collectives {counts}, launches "
              f"{ranks[-1]['launches']}", flush=True)
    return {"ranks": ranks}


def phase_parallel_rehearsal(report: dict, smi: str, ts_world1) -> dict:
    """Phase 33: dcn_worker as 2 processes over gloo, both on this card
    (NCCL refuses two ranks on one card), each job's rows stitched and
    held to the unsharded chain on the card.  A rehearsal of the
    multi-rank logic: the exchanged tensors go through the host, so its
    times are not scaling."""
    from quisk_tpu_torch.ops.channelizer import OversampledPFB
    from quisk_tpu_torch.ops.demod import MixedDemod
    from quisk_tpu_torch.parallel.scaling import flagship

    dev = torch.device(DEVICE)
    tmp = tempfile.mkdtemp()
    out = {}
    try:
        # the flagship chain job, 512 channels a rank
        t0 = time.perf_counter()
        parts = run_workers(os.path.join(tmp, "chain"),
                            ["--channels", str(C), "--blocks",
                             str(REH_BLOCKS)])
        wall = time.perf_counter() - t0
        chain = flagship(C, sample_rate=192000.0, audio_block=256,
                         agc=False, device=dev)
        n = REH_BLOCKS * chain.block_in
        tunes = chain.tune_base.cpu().numpy()
        modes = chain.demod.mode.cpu().numpy()
        iq = np.stack([sources.station_iq(int(modes[c]), 192000.0, n,
                                          float(tunes[c]), seed=c)
                       for c in range(C)])
        _, ref = chain.process(chain.init_state(), torch.as_tensor(
            iq, device=dev))
        ref = ref.cpu().numpy()
        # kernel #1 at the ranks' (B, T, d), against its plain version
        B = chain.block_in
        kern = check_plain_mode(chain.front, [
            iq[:, k * B:(k + 1) * B].astype(np.complex64) for k in (0, 1)])
        rows = sorted(parts, key=lambda z: int(z["lo"]))
        assert [(int(z["lo"]), int(z["hi"])) for z in rows] == [
            (0, C // 2), (C // 2, C)]
        got = np.concatenate([z["audio"] for z in rows])
        err = float(np.abs(got[:, REH_SKIP:] - ref[:, REH_SKIP:]).max()
                    / np.abs(ref[:, REH_SKIP:]).max())
        print(f"  rehearsal flagship job: {C} channels over 2 ranks on "
              f"{DEVICE} (gloo), {REH_BLOCKS} blocks; stitched vs the "
              f"unsharded card chain {err:.3e} of the peak after "
              f"{REH_SKIP} samples; {wall:.1f} s wall", flush=True)
        assert err <= REH_TOL, err
        out["flagship"] = {**rehearsal_line("flagship", parts),
                           "max_rel_err": err, "wall_s": wall,
                           "kernel_max_abs_err": kern["max_abs_err"],
                           "kernel_snr_db": kern["snr_db"]}
        assert all(r["launches"]["front"] == REH_BLOCKS
                   for r in out["flagship"]["ranks"])
        assert all(not any(r["counts"].values())
                   for r in out["flagship"]["ranks"])
        del chain, iq, ref, got, kern

        # timeshard_rx across 2 ranks in time
        t0 = time.perf_counter()
        parts = run_workers(os.path.join(tmp, "ts"),
                            ["--timeshard", "--channels", str(C), "--block",
                             str(TS_SAMPLES), "--blocks", "3"])
        wall = time.perf_counter() - t0
        rows = sorted(parts, key=lambda z: int(z["t0"]))
        got = torch.as_tensor(np.concatenate([z["audio"] for z in rows],
                                             axis=-1), device=dev)
        ref = ts_world1
        err = float((got - ref).abs().max() / ref.abs().max())
        print(f"  rehearsal timeshard_rx: {C} x {TS_SAMPLES} over 2 ranks "
              f"in time vs the world of one: {err:.3e} of the peak; "
              f"{wall:.1f} s wall", flush=True)
        assert err <= TS_TOL, err
        out["timeshard"] = {**rehearsal_line("timeshard", parts),
                            "max_rel_err": err, "wall_s": wall}
        del got

        # the PFB job at the receiver's width
        K, B = PFB_K, PFB_K * PFB_MULT
        t0 = time.perf_counter()
        parts = run_workers(os.path.join(tmp, "pfb"),
                            ["--pfb", "--channels", str(K), "--block",
                             str(B), "--blocks", str(PAR_PFB_BLOCKS)])
        wall = time.perf_counter() - t0
        fam = [int(Mode.USB), int(Mode.AM), int(Mode.FM)]
        pfb = OversampledPFB.create(K, B, pallas_poly=True, device=dev)
        dm = MixedDemod.create([fam[(3 * i) // K] for i in range(K)],
                               sample_rate=REH_PFB_RATE, channels=K,
                               device=dev)
        rng = np.random.default_rng(7)              # the worker's capture
        h, st = pfb.init_state(1), dm.init_state(K)
        for _ in range(PAR_PFB_BLOCKS):
            xh = (rng.standard_normal((1, B))
                  + 1j * rng.standard_normal((1, B))).astype(np.complex64)
            h, ch = pfb(h, torch.as_tensor(xh, device=dev))
            st, a = dm(st, ch.reshape(K, -1))
        sp = (ch.real * ch.real + ch.imag * ch.imag).mean(-1)[0]
        rows = sorted(parts, key=lambda z: int(z["lo"]))
        got = torch.as_tensor(np.concatenate([z["audio"] for z in rows]),
                              device=dev)
        got_sp = torch.as_tensor(np.concatenate([z["spec"] for z in rows]),
                                 device=dev)
        err = float((got - a).abs().max() / a.abs().max())
        sp_err = float(((got_sp - sp).abs() / sp).max())
        print(f"  rehearsal PFB job: K={K}, B={B} over 2 ranks in time, "
              f"{PAR_PFB_BLOCKS} blocks; last block vs the unsharded card "
              f"pipeline: audio {err:.3e} of the peak, spec {sp_err:.3e} "
              f"relative; {wall:.1f} s wall", flush=True)
        assert err <= REH_TOL and sp_err <= PFB_SPEC_RTOL, (err, sp_err)
        out["pfb"] = {**rehearsal_line("PFB", parts), "max_rel_err": err,
                      "spec_rel_err": sp_err, "wall_s": wall,
                      "width": {"K": K, "B": B}}
        for r in out["pfb"]["ranks"]:
            c = r["counts"]
            assert r["launches"]["pfb_poly"] == PAR_PFB_BLOCKS
            assert c["all_to_all"] == PAR_PFB_BLOCKS and c["send"] == \
                PAR_PFB_BLOCKS and not c["all_gather"] and \
                not c["all_reduce"], c
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"rehearsal [{smi}]: 2 gloo ranks on one card, the exchanged "
          f"tensors staged through the host; not scaling", flush=True)
    report["parallel_rehearsal"] = out
    return out


# ----------------------------------------- slice 8: the example programs
EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")
EX_RX_SECONDS = 1.0        # each program at its own default size
EX_PFB_K = 256
EX_SURVEY_K, EX_SURVEY_BLOCKS = 128, 6
EX_CH_DB = 80.0            # channelizer audio, card vs CPU program
EX_BEAT_BLOCKS = 6         # a 1 kHz tone through the SSB loopback
EX_ALC_CALL = 3            # the TX step whose ALC input is held: the SSB
                           # loopback's block 3
EX_FAN_OUT = {"tune_count": 4, "relay": 5, "heartbeats": 1,
              "interlock": False}
ZOOM_TONES_HZ = (40000.0, 40080.0)      # 80 Hz apart, tpu_zoom_smoke.py's
ZOOM_FACTOR = 64.0
ZOOM_BLOCKS = 6


def example(name: str):
    """examples/<name>.py as a module."""
    import importlib
    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


@contextlib.contextmanager
def logged_calls(cls, name: str, keep):
    """Patch cls.name so that each call appends keep(self, args, result) to
    the list this yields; restored on exit."""
    fn, log = getattr(cls, name), []

    def logged(self, *a, **kw):
        out = fn(self, *a, **kw)
        log.append(keep(self, a, out))
        return out
    setattr(cls, name, logged)
    try:
        yield log
    finally:
        setattr(cls, name, fn)


def quietly(fn):
    """fn() with its standard output dropped: a program's second run."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn()


def warm_ms(fn) -> float:
    """A program's ms a block on a second run on the card (host clock,
    its block loop), past the first run's one-time costs."""
    res = quietly(fn)
    return res["loop_s"] / res["blocks"] * 1e3


def timed_program(fn, label: str, smi: str):
    """fn() with every launch counter from 0: (result, wall s, counts)."""
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in all_launches().items() if v}
    print(f"  {label}: wall {wall:.3f} s [{smi}], kernel launches "
          f"{counts or 'none'}", flush=True)
    return out, wall, counts


def ex_receiver(tmp: str, smi: str) -> dict:
    """examples/torch_demo_receiver.py at its default size on the card and
    on the CPU: WAV rows as tests/test_torch_examples.py holds them."""
    trx = example("torch_demo_receiver")
    res, wall, counts = timed_program(
        lambda: trx.run(DEVICE, EX_RX_SECONDS, os.path.join(tmp, "rx")),
        "receiver (4 channels at 960 kS/s, unfused)", smi)
    # the reference's unfused front: no front kernel; the AGC's kernel
    assert counts == {"agc_delay": res["blocks"],
                      "mixed_demod": res["blocks"]}, counts
    assert bool(np.isfinite(res["audio"]).all())
    one_thread(lambda: quietly(lambda: trx.run(
        "cpu", EX_RX_SECONDS, os.path.join(tmp, "rx_cpu"))))
    tail = slice(FEATURED_FROM_BLOCK * AUDIO_BLOCK, None)
    rows = {}
    for name, _, mode in res["stations"]:
        got, _ = wav.read_audio_wav(os.path.join(tmp, "rx",
                                                 trx.wav_name(name)))
        ref, _ = wav.read_audio_wav(os.path.join(tmp, "rx_cpu",
                                                 trx.wav_name(name)))
        got, ref = torch.as_tensor(got[tail]), torch.as_tensor(ref[tail])
        if mode == "FM":
            rows[name] = ("rms dB", 20 * float(torch.log10(
                got.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())))
            assert abs(rows[name][1]) < FM_RMS_DB, (name, rows[name])
        else:
            rows[name] = ("dB", snr_db(ref, got))
            assert rows[name][1] >= FEATURED_MATCH_DB, (name, rows[name])
    ms = res["loop_s"] / res["blocks"] * 1e3
    warm = warm_ms(lambda: trx.run(DEVICE, EX_RX_SECONDS,
                                   os.path.join(tmp, "rx_warm")))
    print(f"  receiver: {res['blocks']} blocks, {ms:.4f} ms a block (host "
          f"clock, the loop; {warm:.4f} on a second run) [{smi}]; WAV rows "
          f"card vs CPU program from "
          f"block {FEATURED_FROM_BLOCK}: " + ", ".join(
              f"{k} {v[1]:.1f} {v[0]}" for k, v in rows.items()),
          flush=True)
    return {"wall_s": wall, "blocks": res["blocks"], "ms_block": ms,
            "warm_ms_block": warm, "cpu_rows": rows, "launches": counts}


def pfb_path_times(pipe, state, x, v=None, bb=None) -> dict:
    """Kernel #4 (and #6 where ``bb`` is given) at an example path's shape:
    ms, the plain version's ms and the bound."""
    hist, dm = state
    h = pipe.pfb.h_poly
    out = {"poly_os": {
        "ms": cuda_ms(lambda: pk.pfb_poly_oversampled(hist, x, h), 20),
        "plain_ms": cuda_ms(
            lambda: pk.pfb_poly_oversampled_plain(hist, x, h), 3, 1),
        **poly_os_bound(pipe.pfb, hist, x), "library_ms": None}}
    if bb is not None:
        consts, kw = demod_args(pipe)
        out["demod"] = {
            "ms": cuda_ms(lambda: pk.pfb_demod_call(bb, dm, *consts, **kw),
                          20),
            "plain_ms": cuda_ms(
                lambda: pk.pfb_demod_plain(bb, dm, *consts, **kw), 3, 1),
            **demod_bound(pipe, bb, dm), "library_ms": None}
    return out


def ex_channelizer(tmp: str, smi: str) -> dict:
    """examples/torch_demo_channelizer.py at K=256: 8 launches each of
    kernels #4 and #6, both held to their plain versions on the path's
    second block, the audio against the CPU program's."""
    tch = example("torch_demo_channelizer")
    res, wall, counts = timed_program(
        lambda: tch.run(DEVICE, EX_PFB_K, os.path.join(tmp, "ch")),
        f"channelizer (K={EX_PFB_K})", smi)
    n = res["blocks"]
    assert counts == {"pfb_poly_oversampled": n, "pfb_demod_call": n}, counts
    cpu = one_thread(lambda: quietly(lambda: tch.run(
        "cpu", EX_PFB_K, os.path.join(tmp, "ch_cpu"))))
    got, ref = torch.as_tensor(res["audio"]), torch.as_tensor(cpu["audio"])
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    db = {"all": snr_db(ref, got)}
    K = EX_PFB_K
    for c in (5, K - 9, 17):
        db[c] = snr_db(ref[c], got[c])
    print(f"  channelizer: audio {tuple(got.shape)} card vs CPU program: "
          + ", ".join(f"{k} {v:.1f} dB" for k, v in db.items()), flush=True)
    assert min(db.values()) >= EX_CH_DB, db
    pipe, x = res["pipe"], res["x"]
    blk = x.shape[-1] // n
    st, _ = pipe(pipe.init_state(1), x[:, :blk])
    xb = x[:, blk:2 * blk]
    poly_err, demod_err, v, bb = pfb_kernel_errors(pipe, st, xb)
    times = pfb_path_times(pipe, (st[0], st[1]), xb, v, bb)
    ms = res["loop_s"] / n * 1e3
    warm = warm_ms(lambda: tch.run(DEVICE, EX_PFB_K,
                                   os.path.join(tmp, "ch_warm")))
    print(f"  channelizer: {ms:.4f} ms a block (host clock, the loop; "
          f"{warm:.4f} on a second run) [{smi}]; kernel #4 "
          f"{times['poly_os']['ms']:.4f} ms (plain "
          f"{times['poly_os']['plain_ms']:.4f}, bound "
          f"{times['poly_os']['bound_ms']:.4f} by "
          f"{times['poly_os']['bound_by']}), kernel #6 "
          f"{times['demod']['ms']:.4f} ms (plain "
          f"{times['demod']['plain_ms']:.4f}, bound "
          f"{times['demod']['bound_ms']:.4f} by "
          f"{times['demod']['bound_by']})", flush=True)
    return {"wall_s": wall, "blocks": n, "ms_block": ms,
            "warm_ms_block": warm, "cpu_db": db,
            "launches": counts, "poly_err": poly_err,
            "demod_err": demod_err, "times": times}


def ex_transceiver(tmp: str, smi: str) -> dict:
    """examples/torch_demo_transceiver.py: kTxAlc and tx_place once a TX
    step, kTxAlc held to its plain version on the SSB loopback's block 3;
    the loopback's 1 kHz beat, IMD better after PureSignal, the live
    session's voice."""
    from quisk_tpu_torch.io.audio_in import AudioCapture
    ttx = example("torch_demo_transceiver")
    # each TX step's (chain, state, mic block); each mic block handed out
    with logged_calls(TxChain, "step", lambda c, a, _: (c, *a)) as steps, \
            logged_calls(AudioCapture, "get", lambda c, a, out: out) as mic, \
            logged_calls(RxChain, "step",
                         lambda c, a, _: isinstance(c.agc, AGC)) as rx_agc:
        res, wall, counts = timed_program(
            lambda: ttx.run(DEVICE, os.path.join(tmp, "tx")),
            "transceiver (loopback SSB and FM, PureSignal, live session)",
            smi)
    want = {"tx_alc_scan": len(steps), "tx_place": len(steps),
            "agc_delay": sum(rx_agc), "mixed_demod": len(rx_agc)}
    assert counts == {k: v for k, v in want.items() if v}, (counts, want)
    before, after = res["imd"]
    assert before - after > IMD_GAIN_DB, res["imd"]
    voice, audio, smeter = res["live"]
    keyed = len(audio) // AUDIO_BLOCK
    rho, lag = voice_correlation(np.concatenate(mic[:keyed]), audio)
    assert smeter > RADIO_SMETER_DB and rho > RADIO_RHO, (smeter, rho)
    for name in ("ssb", "fm"):
        assert bool(np.isfinite(res[name][1]).all()), name
    tone = 0.3 * np.sin(2 * np.pi * BEAT_HZ * np.arange(
        EX_BEAT_BLOCKS * AUDIO_BLOCK) / 48000.0)
    _, a = ttx.loopback("USB", "USB", blocks=EX_BEAT_BLOCKS, device=DEVICE,
                        voice=tone)
    beat = beat_hz(a[3 * AUDIO_BLOCK:], 48000.0)
    assert abs(beat - BEAT_HZ) < 30.0, beat
    chain, state, mic_block = steps[EX_ALC_CALL]
    st, iq = chain.pre_alc(state, mic_block)
    args = chain.alc.scan_inputs(st["alc"], iq)[1]
    check = check_agc("tx_alc", args)
    xs, ast, coef, kw = args
    t = {"ms": cuda_ms(lambda: agc_scan.tx_alc_scan(
             *xs, ast, coef, **dict(kw, clips=False)), 20),
         "plain_ms": cuda_ms(lambda: agc_scan.tx_alc_plain(*xs, ast, coef,
                                                           **kw), 1, 0),
         **agc_bound("tx_alc", *xs[0].shape), "library_ms": None}
    print(f"  transceiver: {len(steps)} TX steps, kTxAlc "
          f"{counts['tx_alc_scan']}; IMD {before:.1f} -> {after:.1f} dBc; "
          f"live session S-meter {smeter:.1f} dBFS, voice rho {rho:.4f} at "
          f"lag {lag}; SSB loopback beat {beat:.1f} Hz; kTxAlc on block "
          f"{EX_ALC_CALL}'s ALC input: {check}; parts (host s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in res["seconds"].items())
          + f"; kTxAlc at [1, {AUDIO_BLOCK}] {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.6f} by "
          f"{t['bound_by']} [{smi}]", flush=True)
    return {"wall_s": wall, "tx_steps": len(steps), "launches": counts,
            "imd": [before, after], "smeter": smeter, "rho": rho,
            "beat_hz": beat, "alc": check, "parts_s": res["seconds"],
            "max_abs_err": check["max_abs_err"], **t}


def ex_survey(tmp: str, smi: str) -> dict:
    """examples/torch_demo_wideband_survey.py at K=128: no sequence error,
    kernel #4 once a block, held to its plain version on the first."""
    tsv = example("torch_demo_wideband_survey")
    res, wall, counts = timed_program(
        lambda: tsv.run(DEVICE, EX_SURVEY_K, EX_SURVEY_BLOCKS,
                        os.path.join(tmp, "sv")),
        f"wideband survey (K={EX_SURVEY_K}, {EX_SURVEY_BLOCKS} blocks)", smi)
    stats = res["stats"]
    assert stats["seq_errors"] == 0 and res["blocks"] == EX_SURVEY_BLOCKS
    assert counts == {"pfb_poly_oversampled": EX_SURVEY_BLOCKS}, counts
    pipe, x = res["pipe"], res["x"]
    state = pipe.init_state(1)
    v = pk.pfb_poly_oversampled(state[0], x, pipe.pfb.h_poly)
    vp = pk.pfb_poly_oversampled_plain(state[0], x, pipe.pfb.h_poly)
    poly_err = float((v - vp).abs().max())
    assert poly_err <= POLY_TOL * float(vp.abs().max()), poly_err
    times = pfb_path_times(pipe, state, x)
    ms = res["loop_s"] / res["blocks"] * 1e3
    warm = warm_ms(lambda: tsv.run(DEVICE, EX_SURVEY_K, EX_SURVEY_BLOCKS,
                                   os.path.join(tmp, "sv_warm")))
    print(f"  survey: {stats['packets']} packets, {stats['seq_errors']} seq "
          f"errors, native {stats.get('native', False)}; stations on "
          f"{res['top']}; {ms:.4f} ms a block (host clock, the receive "
          f"loop, paced by the sender; {warm:.4f} on a second run) [{smi}]; "
          f"kernel #4 max|kernel-plain| "
          f"{poly_err:.2e}, {times['poly_os']['ms']:.4f} ms (plain "
          f"{times['poly_os']['plain_ms']:.4f}, bound "
          f"{times['poly_os']['bound_ms']:.4f} by "
          f"{times['poly_os']['bound_by']})", flush=True)
    return {"wall_s": wall, "blocks": res["blocks"], "ms_block": ms,
            "warm_ms_block": warm, "stats": stats, "launches": counts,
            "poly_err": poly_err,
            "times": times}


def ex_station(smi: str) -> dict:
    """examples/torch_station_automation.py: the plugin's fan-out
    counters after the program's session."""
    tsa = example("torch_station_automation")
    (hw, audio), wall, counts = timed_program(
        lambda: tsa.run(DEVICE), "station automation", smi)
    fan = {"tune_count": hw.anttuner.tune_count,
           "relay": hw.filterbox.relay,
           "heartbeats": hw.controlbox.heartbeat_count,
           "interlock": hw.controlbox.tx_enabled}
    assert fan == EX_FAN_OUT, fan
    assert audio.shape == (1, AUDIO_BLOCK) and np.isfinite(audio).all()
    print(f"  station automation: fan-out {fan}", flush=True)
    return {"wall_s": wall, "fan_out": fan, "launches": counts}


def zoom_on_card(smi: str) -> dict:
    """tpu_zoom_smoke.py's check on the card: a 192 kHz Radio, two tones
    80 Hz apart inside one base FFT bin, set_zoom(64, vfo + 40040): the
    re-capture engages and its row resolves both tones."""
    from quisk_tpu_torch.hw.base import SimHardware

    class TwoTone(SimHardware):
        def read_samples(self, n):
            t = (np.arange(n) + self._n0) / self.sample_rate
            self._n0 += n
            x = sum(0.5 * np.exp(2j * np.pi * f * t) for f in ZOOM_TONES_HZ)
            return x.astype(np.complex64)[None]

    cfg = RadioConfig(sample_rate=192000.0, mode="USB", tune_hz=10000.0,
                      audio_block=AUDIO_BLOCK)
    hw = TwoTone(cfg)
    hw._n0 = 0
    r = Radio(cfg, hardware=hw)
    try:
        r.open()
        base_bin = cfg.sample_rate / r.graph.sa.fft_size
        r.set_zoom(ZOOM_FACTOR, r.vfo_hz + sum(ZOOM_TONES_HZ) / 2)
        t0 = time.perf_counter()
        r.run(blocks=ZOOM_BLOCKS)
        secs = time.perf_counter() - t0
        assert r._zoomcap is not None, "zoom did not engage"
        zs = r._zoomcap[0]
        assert zs.an.window.device.type == torch.device(DEVICE).type
        lo, bin_hz, row = r._zoom_trace()
    finally:
        r.close()
    zres = cfg.sample_rate / (zs.decim * zs.an.fft_size)
    rr = row - row.min()
    peaks = [i for i in range(1, len(rr) - 1)
             if rr[i] >= rr[i - 1] and rr[i] >= rr[i + 1]
             and rr[i] > 0.7 * rr.max()]
    groups = []
    for i in peaks:
        if groups and i - groups[-1][-1] <= 2:
            groups[-1].append(i)
        else:
            groups.append([i])
    freqs = sorted(lo + bin_hz * (np.mean(g) + 0.5) for g in groups)
    want = [r.vfo_hz + f for f in ZOOM_TONES_HZ]
    print(f"  zoom on the card: engaged, decim {zs.decim}, resolution "
          f"{zres:.2f} Hz against the base bin {base_bin:.2f} Hz, row "
          f"{row.shape} from {lo:.0f} Hz at {bin_hz:.2f} Hz/px; peaks at "
          f"{[round(float(f), 1) for f in freqs]} Hz (tones {want}); "
          f"{ZOOM_BLOCKS} blocks in {secs:.3f} s [{smi}]", flush=True)
    assert zs.decim <= ZOOM_FACTOR and zres < base_bin / 2
    assert len(freqs) == 2, freqs
    assert all(abs(f - w) < 2 * zres for f, w in zip(freqs, want)), freqs
    return {"decim": zs.decim, "resolution_hz": zres, "peaks_hz": freqs,
            "run_s": secs}


def phase_examples(report: dict, smi: str) -> dict:
    """Phase 34: the five example programs on the card at their default
    sizes, each through its ``run``, and the zoom engaged on a Radio."""
    t0 = time.perf_counter()
    print("examples (phase 34):", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = {"receiver": ex_receiver(tmp, smi),
               "channelizer": ex_channelizer(tmp, smi),
               "transceiver": ex_transceiver(tmp, smi),
               "survey": ex_survey(tmp, smi),
               "station": ex_station(smi)}
    out["zoom"] = zoom_on_card(smi)
    out["phase_s"] = time.perf_counter() - t0
    print(f"  phase 34: {out['phase_s']:.1f} s [{smi}]", flush=True)
    report["examples"] = out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    report: dict = {"torch": torch.__version__, "cuda": torch.version.cuda}
    rng = np.random.default_rng(SEED)
    smi = phase_environment(report)
    kern = phase_kernel(report, rng)
    chain, blocks, n_plain = phase_main_path(report, rng)
    n_agc = report["main_path"]["agc_delay_launches"]
    times = phase_timing(report, smi, chain, blocks, kern)
    delay_times = phase_agc_delay(report, smi)
    mixed_times = phase_mixed_demod(report, smi)
    gk = phase_gain_kernels(report, rng)
    featured, f_blocks, n_nb, n_gained = phase_featured(report, rng)
    nfm, n_blocks, k_nfm = phase_nfm(report, smi, rng)
    wcp = phase_wcp(report, smi, blocks)
    gtimes = phase_timing_featured(report, smi, featured, f_blocks, nfm,
                                   n_blocks, gk)
    phase_front_cond(report, f_blocks)
    # one entry per kernel and path shape: the plain mode runs at two
    source = "quisk_tpu_torch/csrc/fused_tune_decimate.cu"
    plain = {"name": "fused_tune_decimate", "route": "cuda",
             "source": source,
             "replaces": "quisk_tpu/ops/pallas_kernels.py:137"}
    kernels = [
        {**plain, "path": "flagship", "launches": n_plain,
         "max_abs_err": kern["max_abs_err"], **times},
        {**plain, "path": "NFM", **k_nfm},
        {"name": "fused_tune_decimate_gained", "route": "cuda",
         "source": source,
         "replaces": "quisk_tpu/ops/pallas_kernels.py:168",
         "path": "featured, host-detect verification route",
         "launches": n_gained, "max_abs_err": gk["gained_err"],
         **gtimes["gained"]},
        {"name": "fused_tune_decimate_nb", "route": "cuda",
         "source": source,
         "replaces": "quisk_tpu/ops/pallas_kernels.py:77",
         "path": "featured", "launches": n_nb,
         "max_abs_err": gk["nb_err"], **gtimes["nb"]},
    ]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels += [
        {"name": "agc_delay", "route": "cuda",
         "source": "quisk_tpu_torch/csrc/agc_delay.cu",
         "replaces": "none (quisk_tpu/ops/agc.py AGC: torch ops)",
         "path": f"flagship at [{rows}, {B}]",
         "launches": n_agc if rows == C else 3,
         "max_abs_err": delay_times[f"{rows}x{B}"]["max_abs_err"],
         **{k: delay_times[f"{rows}x{B}"][k] for k in timed}}
        for rows, B in AGC_DELAY_SHAPES]
    del chain, featured, nfm, blocks, f_blocks, n_blocks, gk, kern
    torch.cuda.empty_cache()
    phase_pfb_kernels(report, rng)
    rx = phase_pfb_receiver(report)
    crit = phase_pfb_critical(report, rx["xs"])
    ptimes = phase_timing_pfb(report, smi, rx, crit)
    poly_src = "quisk_tpu_torch/csrc/pfb_poly.cu"
    poly_os = {"name": "pfb_poly_oversampled", "route": "cuda",
               "source": poly_src,
               "replaces": "quisk_tpu/ops/pallas_kernels.py:638"}
    demod = {"name": "pfb_demod_call", "route": "cuda",
             "source": "quisk_tpu_torch/csrc/pfb_demod.cu",
             "replaces": "quisk_tpu/ops/pallas_kernels.py:844"}
    kernels += [
        {**poly_os, "path": "PFB receiver",
         "launches": rx["launches"]["poly_os"],
         "max_abs_err": rx["poly_err"], **ptimes["poly_os"]},
        {"name": "pfb_poly_critical", "route": "cuda", "source": poly_src,
         "replaces": "quisk_tpu/ops/pallas_kernels.py:724",
         "path": "PFBChannelizer", "launches": crit["launches"],
         "max_abs_err": crit["err"], **ptimes["poly_crit"]},
        {**demod, "path": "PFB receiver",
         "launches": rx["launches"]["demod"],
         "max_abs_err": rx["demod_err"], **ptimes["demod"]},
    ]
    del rx, crit
    torch.cuda.empty_cache()
    # the TX path and the spectrum services draw from a stream of their own
    rng_tx = np.random.default_rng(SEED + 2)
    txr = phase_tx(report, rng_tx)
    alc_args = phase_timing_tx(report, smi, txr)
    n_alc = txr["alc_launches"]
    del txr
    phase_loopback(report, rng_tx)
    phase_puresignal(report)
    phase_spectrum(report, smi, rng_tx)
    # slice 5: the PLL demods and the remaining DSP ops, from a stream of
    # their own
    rng_s5 = np.random.default_rng(SEED + 3)
    phase_pll_kernel(report, rng_s5)
    paths = phase_pll_paths(report, rng_s5)
    pll_times = phase_timing_pll(report, smi, paths)
    biquad_times = phase_biquad(report, smi)
    # the PLL kernel's edges, from a stream of their own
    pll_edges(report, smi)
    kernels += [
        {"name": "pll_demod_sync_am", "route": "cuda", "source": PLL_SRC,
         "replaces": "quisk_tpu/ops/nr.py:368", "path": "sync-AM flagship",
         "launches": paths["launches"]["sync_am"],
         "max_abs_err": paths["kern"]["sync_am"]["max_abs_err"],
         **pll_times["sync_am"]},
        {"name": "pll_demod_pll_fm", "route": "cuda", "source": PLL_SRC,
         "replaces": "quisk_tpu/ops/demod.py:172", "path": "PLL-NFM",
         "launches": paths["launches"]["pll_fm"],
         "max_abs_err": paths["kern"]["pll_fm"]["max_abs_err"],
         **pll_times["pll_fm"]},
    ]
    kernels += [
        {"name": "biquad_df1", "route": "cuda",
         "source": "quisk_tpu_torch/csrc/biquad.cu",
         "replaces": "none (quisk_tpu/ops/iir.py Biquad: lax."
                     "associative_scan)",
         "path": f"PLL-NFM's CTCSS notch at [{rows}, {B}]",
         "launches": paths["launches"]["biquad"] if rows == C else 3,
         "max_abs_err": biquad_times[f"{rows}x{B}"]["max_abs_err"],
         **{k: biquad_times[f"{rows}x{B}"][k] for k in timed}}
        for rows, B in BIQUAD_SHAPES]
    # the mixed demodulator: launches from the path that runs each plan at
    # [C, 2048] (its counter set to 0), from the side check's 3 calls at
    # [8192, 2048]
    path_launches = {"flagship": report["main_path"]["mixed_demod_launches"],
                     **paths["launches"]["mixed_demod"]}
    kernels += [
        {"name": "mixed_demod", "route": "cuda",
         "source": "quisk_tpu_torch/csrc/mixed_demod.cu",
         "replaces": "none (quisk_tpu/ops/demod.py MixedDemod: jnp ops)",
         "path": (f"{plan} path at [{shape}]" if rows == C else
                  f"{plan} modes at [{shape}], side check of 3 calls"),
         "launches": path_launches[plan] if rows == C else 3,
         "max_abs_err": mixed_times[key]["max_abs_err"],
         **{k: mixed_times[key][k] for k in timed}}
        for key in mixed_times
        for plan, shape in [key.split()]
        for rows in [int(shape.split("x")[0])]]
    del paths
    torch.cuda.empty_cache()
    phase_slice5_ops(report, smi, rng_s5)
    # slice 7a: the host edge, from a stream of its own
    rng_he = np.random.default_rng(SEED + 4)
    feed = phase_feed(report, smi, rng_he)
    kernels.append({**plain, "path": "flagship via DeviceFeed",
                    "launches": feed["launches"]["plain"],
                    "max_abs_err": feed["max_abs_err"], **times})
    torch.cuda.empty_cache()
    # slice 7b-1: the PFB receiver fed by the ingest plane, and a live
    # HiQSDR Radio (the capture from a stream of its own, SEED + 8)
    ing = phase_ingest(report, smi)
    kernels += [
        {**poly_os, "path": "PFB receiver via wideband ingest",
         "launches": ing["launches"]["poly_os"],
         "max_abs_err": ing["poly_err"], **ptimes["poly_os"]},
        {**demod, "path": "PFB receiver via wideband ingest",
         "launches": ing["launches"]["demod"],
         "max_abs_err": ing["demod_err"], **ptimes["demod"]},
    ]
    phase_hiqsdr_radio(report)
    phase_radio_user(report)
    phase_radio_wide(report, smi)
    torch.cuda.empty_cache()
    phase_radio_tx(report, smi, rng_he)
    phase_cli(report, smi)
    # slice 7c: the AGC / ALC kernel, from a stream of its own
    rng_agc = np.random.default_rng(SEED + 5)
    agc_times = phase_agc_kernel(report, smi, rng_agc,
                                 {"tx_alc": alc_args, **wcp["path_args"]})
    launched = {"tx_alc": n_alc, **wcp["launches"]}
    kernels += [{"name": f"agc_scan_{m}", "route": "cuda", "source": AGC_SRC,
                 "replaces": AGC_REPLACES[m], "path": AGC_PATHS[m],
                 "launches": launched[m], **agc_times[m]}
                for m in AGC_WRAPPERS]
    torch.cuda.empty_cache()
    # slice 7b-2: the wide Radio through every user surface (phase 30; the
    # sim hardware makes its capture, nothing is drawn) and the keyed Radio
    # from its live sources (phase 31, from a stream of its own)
    phase_radio_surfaces(report, smi)
    keyed = phase_radio_keyed(report, smi, np.random.default_rng(SEED + 10))
    kernels.append({"name": "agc_scan_tx_alc", "route": "cuda",
                    "source": AGC_SRC, "replaces": AGC_REPLACES["tx_alc"],
                    "path": "keyed Radio from its live sources (mic, CQ "
                            "keyer, TCI TX, MIDI PTT, serial key, repeater "
                            "favourite), C=1",
                    **{k: keyed[k] for k in ("launches", "max_abs_err", "ms",
                                             "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")}})
    # slice 6: parallel/ on torch.distributed: phase 32 in a world of one
    # over NCCL at full width (its inputs from streams of their own, SEED +
    # 11 and + 12), phase 33 the rehearsal across 2 ranks on this card
    par = phase_parallel_world1(report, smi)
    kernels += [
        {**plain, "path": "channel-sharded flagship (make_sharded_step), "
                          "world of one over NCCL",
         "launches": par["flagship"]["launches"],
         "max_abs_err": par["flagship"]["max_abs_err"], **times},
        {**poly_os, "path": "time-sharded PFB step (make_sharded_pfb_step), "
                            "world of one over NCCL",
         "launches": par["pfb"]["launches"],
         "max_abs_err": par["pfb"]["poly_err"], **ptimes["poly_os"]},
    ]
    phase_parallel_rehearsal(report, smi, par["timeshard"]["audio"])
    del par
    torch.cuda.empty_cache()
    # slice 8: the five example programs at their default sizes (phase
    # 34; their inputs are the programs' own seeded draws)
    ex = phase_examples(report, smi)
    ch, sv, tx = ex["channelizer"], ex["survey"], ex["transceiver"]
    kernels += [
        {**poly_os, "path": f"examples/torch_demo_channelizer.py "
                            f"(K={EX_PFB_K}, B={EX_PFB_K * 1024})",
         "launches": ch["launches"]["pfb_poly_oversampled"],
         "max_abs_err": ch["poly_err"],
         **{k: ch["times"]["poly_os"][k] for k in timed}},
        {**demod, "path": f"examples/torch_demo_channelizer.py "
                          f"(K={EX_PFB_K}, K1=2, n_out=2048)",
         "launches": ch["launches"]["pfb_demod_call"],
         "max_abs_err": ch["demod_err"],
         **{k: ch["times"]["demod"][k] for k in timed}},
        {**poly_os, "path": f"examples/torch_demo_wideband_survey.py "
                            f"(K={EX_SURVEY_K}, B={EX_SURVEY_K * 256})",
         "launches": sv["launches"]["pfb_poly_oversampled"],
         "max_abs_err": sv["poly_err"],
         **{k: sv["times"]["poly_os"][k] for k in timed}},
        {"name": "agc_scan_tx_alc", "route": "cuda", "source": AGC_SRC,
         "replaces": AGC_REPLACES["tx_alc"],
         "path": "examples/torch_demo_transceiver.py (loopback SSB and FM, "
                 "PureSignal, the live Radio session), C=1",
         "launches": tx["launches"]["tx_alc_scan"],
         "max_abs_err": tx["max_abs_err"], **{k: tx[k] for k in timed}},
    ]
    report["kernels"] = kernels
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({**report, "device": device}, f, indent=1)
    print(f"card: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
