#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (qradiolink_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card and the repository around this file; it builds the
kernels from qradiolink_tpu_torch/csrc, so nvcc must be on PATH or under
/usr/local/cuda. It exits nonzero, printing no result, when CUDA is missing,
when the package cannot be imported, and when any phase fails:

 1. the card's name and power limit (nvidia-smi);
 2. build every kernel, all nvcc processes at once (ptxas must report no
    spills in csrc/fir_decim.cu, csrc/fir_long.cu, csrc/fir_cols.cu,
    csrc/fir_s1.cu, csrc/viterbi_bfly.cu, csrc/pfb_fft.cu,
    csrc/depthwise_run.cu, csrc/resample_poly.cu, csrc/resample_up.cu,
    csrc/agc2.cu, csrc/costas.cu, csrc/symbol_sync.cu,
    csrc/viterbi_stream.cu, csrc/viterbi_stream_warp.cu,
    csrc/viterbi_stream_redux.cu, csrc/fll_band_edge.cu,
    csrc/resample_x2.cu, csrc/resample_rat.cu and csrc/resample_dec.cu);
 3. each kernel against its plain PyTorch version on the card, at the shapes
    the main paths give it, with each one's time, its plain version's, the
    library yardstick's where one PyTorch call computes the same function,
    and its bound on this card:
    - the strided FIR (K1/K2) at the 4FSK path's resampler head (two
      chained blocks), channel low-pass and RRC (2048 channels x 200,000
      samples a step), and at the NBFM group's resampler head (2,239 taps,
      D 50), channel low-pass (133 taps) and audio low-pass (55 taps,
      real) of the mixed path (32 channels x 100,000 samples), within
      1e-5 (relative to the output's peak, and elementwise |k - p| <=
      1e-5 + 1e-5 |p|); F.conv1d is the yardstick. The head (419 taps,
      D 50) routes to fir_decim_f32, the stride-1 filters to fir_s1_f32,
      the NBFM head to resample_dec_f32 at L 1 (fir_long_f32, which took
      it before, in turns and bit-equal; so the SSB head K5597 D125 in 8
      below). Where the route picks a new
      kernel,
      fir_stream_f32, which served the shape before, is held against the
      plain version too and timed in turns with it (old, new, new, old),
      its row kept with "path": null; fir_s1_f32 must equal
      fir_stream_f32 bit for bit. At a shape the route gives
      fir_stream_f32, its first design fir_stream_v0_f32
      (csrc/fir_stream_v0.cu, on no path) takes that place: bit-equal to
      fir_stream_f32, timed in turns, its row with "path": null;
    - the NBFM audio resampler (L 2, M 5, 113 taps a phase, real, 32 x
      2,000 -> 800) on resample_poly_f32 over two chained blocks, its
      outputs and new state equal bit for bit to the two-launch route that
      served it before (fir_stream_f32 once a phase, the phases interleaved
      in PyTorch), the two timed in turns, beside an empty kernel's launch
      floor and one F.conv1d with L output channels;
    - the Viterbi (K3): viterbi_tiled_k7 on prebuilt windows (R 8,192)
      bit-exact on integer and non-integer chain-like soft; viterbi_bfly_k7,
      which TiledViterbi runs through decode_stream with the windows read
      in place, at the 4FSK shape (2048 channels x 400 pairs) and the mixed
      path's (32 x 200) over two chained blocks of both kinds, its bits and
      new tail equal to the plain version's and to the old route's (windows
      built in PyTorch, then viterbi_tiled_k7); 64 noisy CCSDS codewords
      decoded through TiledViterbi. At both shapes the two kernels and the
      two TiledViterbi routes are timed in turns (old, new, new, old), the
      routes also on the host clock; viterbi_tiled_k7's rows have
      "path": null;
    - the per-row depthwise FIR (K4) at the synthesizer's branch shape (64
      rows, kp 23, 2 planes, 100,000 outputs, the tails read in place) and
      the channelizer's (kp 24, complex input, VALID): depthwise_run_f32,
      which the route gives both, within the FIR's bound and equal bit for
      bit to depthwise_fir_f32 on the concatenation, the two timed in turns
      alone and (the synthesizer) as PfbSynthesizer._branches, a device
      copy of the same bytes beside them; F.conv1d(groups=C) is the
      yardstick;
    - the fused channelizer (K5) over two chained blocks of B = 1, M = 64,
      Tm = 100,000: pfb_fft_f32, which the route gives the shape, through
      PfbChannelizer, and pfb_channelize_f32, which served it before, on
      the same blocks, each within 1e-5 of the plain version's peak, the
      carried state bit-equal; the two kernels timed in turns (old, new,
      new, old), pfb_channelize_f32's row kept with "path": null; no
      single PyTorch call computes K5. Then the channelizer stage against
      the JAX package's default route (commutator in PyTorch, K4 branch
      FIRs, four real matrix products), which the port does not keep:
      output within 1e-5 of the peak, both routes timed;
 4. the 4FSK main path: Fsk4DemodFF(lead_shape=(2048,)) for 3 steps of
    200,000 samples with state carried, launch counters zeroed just before
    and read just after (fir_decim_f32, fir_s1_f32 and viterbi_bfly_k7 must
    launch on every step, nothing on a plain path); then one more
    step timed stage by stage, and one under torch.profiler (device ops,
    busy time, idle share);
 5. the mixed main path: MultichannelRx(64) on one wideband stream of
    6.4 M samples a step (64 x 100,000), channels 0-31 through
    Fsk4DemodFF and 32-63 through NbfmDemod, 3 steps with state carried,
    counters zeroed before and read after (K5 on pfb_fft_f32, fir_decim_f32,
    resample_dec_f32, fir_s1_f32, resample_poly_f32 and viterbi_bfly_k7 on every
    step, pfb_channelize_f32 and fir_stream_f32 never, nothing on a plain
    path); one more step
    stage by stage, and one (and its NBFM group) under torch.profiler;
 6. the frozen capture tests/fixtures/iq_4fsk2k_-6db.npz streamed in two
    blocks through Fsk4DemodFF on the card and on the CPU: the bits must
    be equal and the BER against the payload below 0.01;
 7. the round trip: the capture placed on channel 3 of 64 by the port's
    PfbSynthesizer on the card (K4 on depthwise_run_f32, depthwise_fir_f32
    never; counters zeroed before and read after), a seeded NBFM signal
    on channel 40, streamed through MultichannelRx(64) (FSK on [3], NBFM
    on [40]) in 8
    steps of 100,000 samples a channel on the card and on the CPU: FSK bits
    equal and BER below 0.01, NBFM audio within 1e-5 (the CPU tests'
    bound);
 8. the analog kernels at their shapes, 2048 rows, against their plain
    versions (45 taps a phase at the three resampler shapes):
    resample_dec_f32 at L 1 at the SSB head (K5597 D125, fir_long_f32's
    two column groups x three segments and sum order), timed in turns with
    fir_long_f32, which took it before, and fir_stream_f32 (both rows with
    "path": null) and bit-equal to fir_long_f32; fir_cols_f32 at the
    WBFM head (K225 D5) and audio resampler (K1121 D25, real, the tail read
    in place), each timed in turns with fir_stream_f32, which served the
    shapes before (its rows with "path": null); fir_s1_f32 with the
    SSB channel filter's 167 complex taps (two launches, one a tap plane,
    then the combine; one complex F.conv1d as the library call) and its
    audio band-pass (K97, real); AmMod's post filter, 963 complex taps
    over 200,000 samples, the same way (its row with "path": null: the
    path runs that filter as an FFT, 21 below); agc2_f32 (the AGC stage in one
    launch) bit-equal to its plain version (torch.abs, the loop, the
    products) at the SSB (1,600 complex), AM (4,000 real) and 4,000
    complex shapes over two chained blocks and at QPSK250K's (100,000
    complex) over one, each timed in turns with the stage as it ran before
    (torch.abs, agc2_gain_f32, the products) beside the recurrence's chain
    floor (scripts/loop_chain_floor.py), and agc2_gain_f32, which no path
    launches now, bit-equal to its plain loop and timed (rows with "path":
    null);
    resample_up_f32 at the TX interpolators (SsbMod's L125 M1 K45, 2
    planes; AmMod's, one plane; NbfmMod's L25 M4, real, and L20 M1),
    its outputs and new state equal bit for bit to resample_poly_f32's,
    which served the four shapes before, the two timed in turns (its rows
    with "path": null), one F.conv1d with L output channels beside each;
 9. the slice's main path: SsbDemod(usb=True) at 2048 channels x 200,000
    samples for 3 steps (counters zeroed before, read after: the head on
    resample_dec_f32, the channel band-pass 2 launches of fir_s1_f32, the
    audio band-pass 1, agc2_f32 1, a step; fir_stream_f32, fir_long_f32
    and agc2_gain_f32 never),
    Msamples/s and vs_baseline (above 10) beside the host's pace (the
    host-clock time of a tiny op, before and after), one step stage by
    stage and one under torch.profiler; then WbfmDemod at the same width
    (the head and the audio resampler on fir_cols_f32 once each a step,
    fir_stream_f32 never) and the TX side (SsbMod and NbfmMod on 1,600
    audio samples a channel a step; then AmMod alone, its post filter
    the FFT form once a step and fir_s1_f32 never at its shape), 3 steps
    each, their counts read the same way (the interpolators on
    resample_up_f32 once each a step, resample_poly_f32 never), one more
    step of each traced;
    then AmDemod at the same width, 3 steps, its AGC (2048 x 4,000 real)
    one launch of agc2_f32 a step, agc2_gain_f32 never;
10. SsbDemod, AmDemod and WbfmDemod at 4 channels x 2 blocks on the card
    against the port's CPU path: audio and state within 1e-5 of the peak,
    rssi within 1e-4 dB;
11. the frozen SSB capture tests/fixtures/iq_ssb_usb_-10db.npz streamed in
    two blocks through SsbDemod(usb=True) on the card (the head on
    resample_dec_f32, once a block; fir_long_f32 never) and on the CPU:
    audio and state within
    1e-5 of the peak, rssi within 1e-4 dB;
12. loopbacks on the card, torch only, 8 channels: TX -> ChannelModel at
    30 dB -> RX; the JAX tests' tone-SNR thresholds (NBFM > 15 dB, AM >
    12, USB and LSB > 10, the opposite sideband < 5, WBFM of a wide FM
    tone > 15) on every channel;
13. the PSK modems' kernels at 2048 rows: costas_loop_f32 (orders 4 and
    2), symbol_sync_mm_f32 and viterbi_stream_k7 bit-equal to their plain
    loops over two chained blocks of a real QPSK signal from the port's
    QpskMod (1 kHz off, noise, its first samples ~1e-20; 4,000 samples,
    1,000 symbols, 1,000 soft pairs with lag 64; viterbi_stream_k7 is
    the route of the CCSDS code); symbol_sync_mm_f32 on
    the stress ramps (omega held at its limits, |e| at its clip, so the
    positions run as far as its ring allows) over two chained blocks of
    2048 x 4,000, bit-equal to its plain loop; then timed at QPSK250K's
    full shapes (the PLL over 100,000 samples, the symbol-rate loop over
    25,000, the sync 100,000 -> 25,000, the Viterbi 25,000 pairs; the
    Viterbi also at BPSK2K's 4,096 rows x 200 pairs) beside one call of
    the plain loop, the bound and the latency floor, the
    Viterbi also in turns with viterbi_stream_warp_k7 (the one-warp design
    it replaced) and viterbi_stream_redux_k7 (a one-warp design with each
    step's minimum from the step before), both held bit-equal to it (their
    rows have "path": null); the
    QPSK250K head K83 D2 and QPSK20K/2K's K1045 D25 (no path here runs
    it) on fir_cols_f32, each in turns with fir_stream_f32, the RRC K45
    on fir_s1_f32, against the plain FIR and F.conv1d; the FLL's complex
    K32 band-edge filter on fir_s1_f32 (no path launches it there since
    fll_band_edge_f32 took the loop; its row has no path);
    fll_band_edge_f32 against the plain FllBandEdge loop over two chained
    blocks of 2048 x 4,000 with QpskDemod's and BpskDemod's loop
    parameters (y, phase, freq and tail elementwise within 2e-5 + 1e-5
    |plain|, the phase as a distance on the circle; one launch a block and
    no other kernel), then at QPSK250K's full shape (2048 x 100,000, 200
    sub-blocks) and BPSK2K's (2048 x 4,000) against one timed call of the
    plain loop, the max |diff| of each leaf printed;
14. the QPSK250K path (BASELINE configs[3]): QpskMod on the card, 3,125
    bytes a channel a step at 2048 channels, clean, through
    QpskDemod(125_000, 500_000) for 3 steps (counters zeroed before, read
    after: fir_cols_f32 for the head, fll_band_edge_f32, fir_s1_f32 for
    the RRC alone, agc2_f32, costas_loop_f32 twice, symbol_sync_mm_f32,
    viterbi_stream_k7, a step; fir_stream_f32, agc2_gain_f32 and
    viterbi_stream_warp_k7 never, fir_s1_f32 at no other shape), BER <
    0.01, step ms
    and vs_baseline (printed, not gated), one step stage by stage, one
    traced, and 3 steps at 10 dB with a 1 kHz offset (BER printed);
15. the BPSK2K path: BpskMod -> BpskDemod at 2048 channels for 8 steps,
    the same counts, the better of bits / bits_alt at BER < 0.01;
16. the frozen capture tests/fixtures/iq_qpsk250k_10db.npz in two blocks
    through QpskDemod on the card and on the CPU: bits equal, BER < 0.01;
17. the PSK TX path: QpskMod(125_000) + BpskMod at 2048 channels, 3
    steps, counters zeroed before and read after (QpskMod's RRC and
    BpskMod's two interpolators on resample_up_f32, QpskMod's x2 on
    resample_x2_f32, once each a step; resample_poly_f32 never), then the
    four interpolator shapes against their plain versions, each routed
    kernel bit-equal to resample_poly_f32 over two chained blocks and
    timed in turns with it; at the x2 (L 2 M 1 K 46, 2048 x 100,000 ->
    200,000) that is resample_x2_f32, F.conv1d with 2 output channels
    beside them;
18. the M17 and DMR kernels at 2048 rows against their plain versions:
    the 3/125 heads (M17's K349 a phase, DMR's K2091) on resample_dec_f32
    (cuda_resample.route's kernel for both; over two chained blocks), on
    resample_poly_f32 and on the per-phase route the JAX package takes
    (one launch of the strided FIR's routed kernel a phase, fir_stream_f32
    at M17's K349 D125 and fir_long_f32 at DMR's K2091, then the
    interleave), the three timed in turns, each within the FIR's bound of
    the plain version with its state equal, F.conv1d with L output
    channels beside them; fir_s1_f32 at
    M17's channel LP (K11, 2 planes) and RRC (K251) and DMR's RRC (K125),
    2048 x 4,800, in turns with fir_stream_f32 and bit-equal to it;
    symbol_sync_mm_f32 in levels mode with M17's and DMR's loop
    parameters, bit-equal to its plain loop over two chained blocks of
    2048 x 4,800 -> 960 and once more beside one timed call of it, and in
    turns with the hypotf levels code (symbol_sync_levels_v0), bit-equal,
    cycles a symbol beside the conj mode's;
    resample_up_f32 at the TX interpolators (the 5/1 shapers, one plane,
    960 -> 4,800, K51 and K25; the 125/3 interpolators, two planes, 4,800
    -> 200,000, K9 and K51), bit-equal to resample_poly_f32 and timed in
    turns with it;
19. the M17 and DMR RX paths (BASELINE configs[2]): each row's own
    transmission (M17: two preambles, the LSF, 11 stream frames of seeded
    payloads; DMR: idle dibits, a voice LC header, a voice superframe and
    the terminator) through the port's M17Mod / DmrMod on the card and
    ChannelModel at 10 dB with a 100 Hz offset, at 2048 channels x
    200,000 samples for 3 steps through M17Demod / DmrDemod (counters
    zeroed before, read after: the head on resample_dec_f32, fir_s1_f32
    for the RRC and M17's channel LP, symbol_sync_mm_f32 in levels mode,
    once a step; fir_stream_f32, resample_poly_f32 and fir_long_f32
    never), step ms and vs_baseline
    (printed, not gated), one step stage by stage, one traced; the frame
    layer on the host for 8 rows (M17: Deframer and FrameDecoder, the LSF
    and at least 10 of the 11 payloads; DMR: find_bursts and decode_burst,
    its block codes on the card, the LC's ids from the header or, where
    acquisition lost it, the terminator, and frame A's voice bits), host
    ms a row; 4 rows x 2 blocks on the card and on the port's
    CPU path (bits equal; symbols within 1e-3 of their peak, soft and every
    state leaf within 2e-5); then M17DemodFF / DmrDemodFF on the same
    input for 3 steps, step ms;
20. the M17/DMR TX path: M17Mod and DmrMod (its mask zeroing one
    720-sample slot in three at 24 ksps) at 2048 channels, 1,920 seeded
    bits a row a step, 3 steps (the 5/1 and 125/3 interpolators on
    resample_up_f32, M17's post filter on fir_s1_f32, once each a step;
    resample_poly_f32 and fir_stream_f32 never); a zeroed slot's power
    below 1e-3 of an open slot's;
21. the FFT form (ops/fir.py, torch.fft) against the direct kernels at
    every complex-tap filter of more than 96 taps at decimation 1, each at
    its path's shape, timed in turns: AmMod's post filter K963 at 2048 x
    200,000, SsbDemod's band-pass (IqPair) and SsbMod's analytic filter
    K167 at 2048 x 1,600, FreeDvDemod's K167 (IqPair) and FreeDvMod's K133
    at 256 x 8,000; the FFT within 1e-3 of the direct form's peak
    (tests/test_fir.py's bound), ops/fir.auto_impl taking the FFT only
    where it ran faster and AmMod's filter on the faster form; beside them
    the library call, one complex F.conv1d over the tail and the block
    (TF32 off), held to the same bound; the AM TX step with the post
    filter forced direct, beside the AM TX path's in 9;
22. the slice-6 full-width paths, every mode built through
    models/registry.py: 4FSK2KFB (Fsk4FbDemod) at 14 dB and GMSK2K at
    12 dB (the JAX tests' SNRs), 2048 channels x 200,000 samples, 3 steps,
    each row its own transmission from the registry's TX chain through
    ChannelModel (the modulator's launches counted too); every launch of
    the run, kernel and shape, exactly as the chains' stages give it
    (chain_launches: each FIR, resampler, symbol sync and streaming
    Viterbi at its count a step, and nothing else); BER below 0.02 on 8
    sampled rows (GMSK: the better of bits and bits_alt); step ms and
    vs_baseline; one step stage by stage and one traced; 4 rows x 2 steps
    on the card and the CPU (bits equal; GMSK2K's symbols within 1e-3 of
    their peak and state leaves within 1e-4, the filter bank's within 0.1
    and 3e-3, its discriminator flipping where two tone magnitudes tie
    within a rounding, CVC_TOLS); then each kernel shape of the run
    (call_capture, captured_rows): each FIR and resampler shape against
    its plain version on seeded inputs (fir_row, poly_row, with the kernel
    the route replaced in turns; at fir_stream_f32's shapes
    fir_stream_v0_f32, bit-equal; at the K2239 D50 and K5597 D125 heads,
    routed to resample_dec_f32 at L 1, fir_long_f32 in turns, bit-equal,
    its row with no path; at the 2/25 K561 head resample_dec_f32's
    taps-in-order form, bit-equal to resample_poly_f32), each loop (the
    conj-mode
    and levels-mode sync, the Viterbi) on the path's own inputs bit-equal
    to one timed call of its plain loop, the levels mode on real input
    also in turns with the hypotf levels code (symbol_sync_levels_v0,
    bit-equal, a row with no path), cycles a symbol beside the conj
    mode's;
23. MMDVMmulti at its real size: one site, 7 carriers, 250,000 samples a
    step at 250 ksps, 3 steps, the TX (MmdvmMultiTx, IqPair out) into the
    RX on IqPair planes, every launch as chain_launches gives it:
    pfb_fft_f32 at M 10, kp 56 and depthwise_run_f32 at the synthesizer's
    kp 53 once a step (pfb_channelize_f32 and depthwise_fir_f32, which
    served those shapes before, never); each carrier's tone SNR above 25
    dB, carrier 0's tone below 10 dB in carrier 3, a mask zeroing carrier
    1 of 3 below 1e-4 of the others' RF power (tests/test_chains_mmdvm.py);
    the two kernels at one site, and at a farm of 64 sites, against their
    plain versions and, in turns, the kernels they replaced (K5 within
    1e-5 of the plain version's peak, K4 bit-equal over two chained
    blocks), beside the launch floor and, for K4, F.conv1d; the 25/24 TX
    and 24/25 RX resamplers on resample_rat_f32 once a step each
    (resample_poly_f32 never), and, at the farm (448 rows, no chain runs
    it), the two against their plain versions and bit-equal to
    resample_poly_f32 over two chained blocks, in turns with it, beside
    F.conv1d and the launch floor (rows with no path);
24. the sweep: every other new mode at 256 rows x 2 steps through the
    registry's TX and RX chains, every launch as chain_launches gives it
    (the data modes each row's own payload, seeded on the CPU, long enough
    steps for 2,000 bits or more), the JAX tests' gates on 8 sampled rows:
    BER (4FSK2K, 4FSK1KFM, 4FSK10KFM, 4FSK100K, 2FSK2K, 2FSK1K, 2FSK10K,
    2FSK2KFB, 2FSK1KFB, GMSK1K, GMSK10K, clean or at their tests' SNR:
    each sampled row's decoding stream equal bit for bit to the port's CPU
    path's on the same IQ, and below the limit but for at most one row of
    4FSK1KFM, whose JAX chain fails such payloads too,
    tests/test_torch_fsk.py); BPSKDSSS8 (its four bit streams equal to the
    CPU path's on the sampled rows of the 256-row run, its symbols and
    state leaves within CVC_TOLS, then the JAX test's gate on 8 rows of
    24 s in one block); MMDVM's tone SNR above 30 dB; CW's key-down power
    above 100 times its key-up power; FreeDV1600USB and FreeDV700DLSB, the
    DSP ends only, a passband tone's SNR above 25 dB at 10 dB and the card
    against the CPU on 4 rows x 2 steps within 1e-5; then each kernel
    shape as in 22: the FIRs and resamplers against their plain versions,
    the loops (BPSKDSSS8's Costas loop of order 2 and Agc2 among them) on
    the run's own inputs bit-equal to their plain loops;
25. the application (slice 7) on the card through its entry points
    (app/cli.py, app/controller.py), one radio at 1 Msps: `modes` lists
    the registry's 41 modes; `tx --mode 4FSK2K --text` to a file, then
    `rx` of it prints the text; `loopback --mode 4FSK2K --snr 12` returns
    0; FM `tx --wav-in` (2 s of 800 Hz) then `rx --wav-out` keeps the
    tone within 40 Hz; tests/test_app.py's DMR call through
    RadioController.rx_block in 125,000-sample blocks gives a voice event
    (audio, or frame where codec2 is missing), receive_end and the
    source id. Each run's launches equal, kernel and shape, the calls the
    same run makes on the CPU (app_counted), counters zeroed just before
    and read just after. The median ms of a 125,000-sample block (125 ms
    of air) of 4FSK2K and of DMR RX, its part outside the chain call and
    the real-time factor are printed;
26. the DMR call layer at the DMR path's width: 2048 rows, each its own
    late-entry call (tests/test_dmr_call.py:162-174: slot 2 two
    superframes of AMBE-coded voice with the row's source id, no header,
    the terminator), through DmrMod, ChannelModel at 10 dB with 100 Hz
    and DmrDemod, 6 steps of 200,000 samples, every launch as
    chain_launches gives it; the call stack (DmrRxStream, DmrControl, AMBE
    regeneration) on 32 sampled rows with its block codes on the card
    and, in turns, on CPU tensors, the two giving the same events: each
    row its terminator with its own source and group (late entry through
    the embedded LC), at least 3/4 of the rows with 8 or more of their 12
    voice bursts recovered and 8 in 12 of all bursts (CALL_ROWS' comment
    says why the voice gate is over the rows); the stack's host ms a row
    and a second of air;
27. the headless service (slice 8), after two probe lines (whether
    `import zmq` can succeed, `g++ --version`): (a) the CLI's `headless
    --udp --start-trx --rx-mode 4FSK2K` (app/cli.HeadlessService, its loop
    in a thread, ephemeral ports) on the card and with `--device cpu`: the
    port's 4FSK2K TX of a text as cf32 datagrams in APP_BLOCK blocks, at
    most UDP_WINDOW datagrams ahead of the service's reads; telnet verbs
    (a status verb, a mode change and back, PTT on and off, shutdown); the
    card's replies and text events equal the CPU's, the text whole, its
    launches the CPU run's calls; then on the card with the sender in a
    process of its own, the same replies and texts; for each sender, ms a
    block from its first datagram to its events and from one block's
    events to the next's, the part in UdpIqSource.read_block and, of that,
    in its socket's recvfrom, the real-time factor; read_block's ms with
    every datagram at hand (no sender, no socket);
    (b) MMDVM and MMDVMmulti (7 carriers) through RadioController, 8 RX
    blocks of 30,000 samples at 250 ksps and 4 TX polls, on ZeroMQ ipc
    sockets under build/ where pyzmq is present, else on the port's
    publisher and poller with in-memory queues (the same wire bytes; a line
    says which): the slots within one int16 step and rssi within 1 of the
    CPU run's, the TX IQ within the parity tests' bound and the gated
    masks equal, the launches the CPU's calls; ms a block and the
    real-time factor for RX and TX; a row for each FIR and resampler shape
    and, for MMDVMmulti, K5 and K4 at the block's shape (pfb_fft_f32 and
    depthwise_run_f32 once a block, the kernels they replaced never, the
    two in turns); (c) IP-over-radio:
    NetPump(LoopbackNetDevice(), "QPSK250K") -> tx_net_poll -> the same
    controller's RX gives the three payloads back (no TUN/TAP device), on
    the card and on the CPU (in a spawned process while the card runs and
    its rows are built): the card's TX IQ within 1e-4 of the peak of
    the CPU's, its RX events the CPU's, its launches the CPU's calls; a
    row for each kernel shape of the first poll and RX block (the FIRs and
    interpolators on seeded inputs, the loops, the FLL's among them, on
    the path's own) that no earlier row has;
    (d) the C++ engine's conversions against the numpy forms (MS/s) and
    UdpRxEngine's datagrams a second on loopback.
28. the application's audio, FreeDV vocoder, video and VOIP (slice 9),
    after a probe line (libcodec2 and its FreeDV API, libopus, Pillow),
    each part on the card against the same work on CPU tensors: (a) FreeDV
    1600 USB and LSB: the stored utterance through FreeDvTx's band-pass
    (fir_s1_f32 K95 at one row), freedv_tx (without the FreeDV API the
    stored stream tests/fixtures/freedv1600_modem.npz), FreeDvMod,
    ChannelModel at 20 dB, FreeDvDemod, freedv_rx: the band-pass within
    1e-5 of the CPU's peak, FreeDvMod's IQ and FreeDvDemod's passband on
    the card's inputs within 1e-5, the int16 PCM for freedv_tx and
    freedv_rx within one LSB (the flips printed), with the API
    tests/test_freedv.py's gates; one RadioController in FreeDV1600USB RX
    through rx_block, its events the CPU's; (b) UdpAudioClient's
    resamplers (fir_cols_f32 K269 D6 and resample_poly_f32 L6 K45 at one
    row, the route's few-row rule) within 1e-5 of the CPU's peak over three reads and three writes,
    none a multiple of 6, then a 400 Hz UDP round trip within 20 Hz;
    (c) the TX audio processor through tx_audio_block (FM with the
    compressor, USB with the compressor and the denoiser, 4FSK2K's Codec2
    where libcodec2 loads): its PCM and state bit for bit the CPU's, the
    IQ held to the CPU's; (d) setaudiorecorder 1, FM RX of (c)'s IQ,
    setaudiorecorder 0: the FLAC decodes to the events' samples; (e) a
    video frame through tx_video_frame and QPSKVideo RX: one video event
    whose JPEG bytes are those sent and the CPU run's (its CPU twin in a
    spawned process); (f) VOIP through a local Mumble peer (plain TCP):
    connectserver, the card's FM RX audio through VoipForwarder (Opus
    packets where libopus loads), a private text command answered through
    the forwarder, mumblemsg, mutemumble, disconnectserver. Every counted
    run's launches equal the CPU run's calls; each new kernel shape gets a
    row against its plain version.
29. scale-out (slice 10): two ranks, processes of this script
    (--scale-out-rank), both on cuda:0 over gloo (NCCL refuses two ranks
    on one card; it fails, and says so, where the card's compute mode
    forbids two processes). Each rank runs the channel-sharded main path
    (Fsk4DemodFF at N_CH x T_STEP, N_CH / 2 rows a rank, 2 steps with state
    carried, each rank making the global block from the phase's seed and
    ingesting its rows: multihost.distribute_channels), MultichannelRx
    over the mesh (the mixed config), the time-sharded Fsk4DemodFF
    (sync_window 320, 2 x 768,000 samples, halo 64,000) and the
    time-sharded FIR (tests/test_time_sharded.py's taps). Held to the same
    work in this process: the main path's bits equal and symbols within
    1e-5, the mixed FSK bits equal and symbols within 1e-4 and its audio
    within 1e-5 of the peak, the chain's bits equal beyond the first shard
    with at most 16 differences in it, the FIR within 1e-4. Every rank's
    launch report must show kernels only; each rank's step ms (CUDA
    events, on a card the two share) is printed beside the single
    process's. The phase adds no kernel row.
30. the last parts (slice 10), each against the same call on CPU tensors:
    scan_stream of the main path over 3 blocks at 256 rows (the frozen
    capture, each row rolled) equal to run_stream and, on 8 rows, to the
    CPU's bits; step_timer, and annotate inside trace (the Chrome trace
    must hold the region); vv_carrier_correct at N_CH x T_STEP (64 rows on
    the CPU, within 1e-4); the complex-tap RationalResampler at L 3 M 2
    and L 1 M 5, a launch a tap plane a block, its launches the CPU's
    calls, its outputs within 1e-5 of the CPU's peak and its state equal.

The second-to-last line is a JSON object with one entry per kernel and
shape; the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import io
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
# the card's name and power limit (nvidia-smi), printed beside the numbers
CARD = ""
FIXTURE = HERE / "tests" / "fixtures" / "iq_4fsk2k_-6db.npz"
SSB_FIXTURE = HERE / "tests" / "fixtures" / "iq_ssb_usb_-10db.npz"

N_CH = 2048
T_STEP = 200_000
N_STEPS = 3
MIX_M = 64          # channels of the mixed config (bench.py:110-211)
MIX_T = 100_000     # samples a channel a step
RT_STEPS = 8        # round trip: 8 x 100,000 = the capture's length
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
FIR_TOL = 1e-5
# device cycles that each timed call waits behind (about 0.5 ms at the
# H100's clock)
SLEEP_CYCLES = 1_000_000


def cuda_times(fn, iters=10, warmup=2):
    """Device times of `iters` calls of fn() in ms, by CUDA events around
    each. A device-side sleep is queued ahead of the start event, so the
    host's work in fn before its first launch (a wrapper's checks and
    allocations, tens of microseconds) overlaps the sleep and is not
    timed."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, iters=10, warmup=2):
    """Median time of fn() in ms, by CUDA events around each call."""
    return statistics.median(cuda_times(fn, iters, warmup))


def turns_ms(fns):
    """Two versions timed in turns a, b, b, a (10 calls a turn): each one's
    median over its 20 calls, and the medians of the four turns."""
    order = list(fns) + list(fns)[::-1]
    times = {k: [] for k in fns}
    turns = []
    for k in order:
        t = cuda_times(fns[k])
        times[k] += t
        turns.append((k, statistics.median(t)))
    return {k: statistics.median(v) for k, v in times.items()}, turns


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    f32 operations over the f32 rate."""
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOPS * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def best_ber(decoded, sent, max_offset=400):
    """Min BER over bit alignments on the steady-state segment [n/2, 7n/8)
    (a copy of tests/test_chains_digital.best_ber)."""
    n = len(sent)
    lo, hi = n // 2, (7 * n) // 8
    seg_sent = sent[lo:hi]
    best = 1.0
    for off in range(max_offset):
        seg_dec = decoded[off + lo: off + hi]
        if len(seg_dec) < len(seg_sent):
            break
        best = min(best, float(np.mean(seg_dec != seg_sent)))
    return best


def check_fir(name, kern, plain):
    """Compare kernel planes with plain planes; returns max_abs_err."""
    err = 0.0
    for k, p in zip(kern, plain):
        diff = (k - p).abs()
        err = max(err, float(diff.max()))
        rel = float(diff.max() / p.abs().max())
        bad = int((diff > FIR_TOL + FIR_TOL * p.abs()).sum())
        if not (rel <= FIR_TOL and bad == 0 and torch.isfinite(k).all()):
            raise RuntimeError(f"{name}: kernel disagrees with plain "
                               f"(max rel {rel:.3e}, {bad} elements out)")
    return err


def peak_err(name, kern, plain, tol):
    """max |k - p| over the planes, which must be within tol of the plain
    output's peak; returns max_abs_err."""
    peak = max(float(p.abs().max()) for p in plain)
    err = max(float((k - p).abs().max()) for k, p in zip(kern, plain))
    if not (err <= tol * peak and all(bool(torch.isfinite(k).all())
                                      for k in kern)):
        raise RuntimeError(f"{name}: kernel disagrees with plain "
                           f"(max |diff| {err:.3e}, peak {peak:.3e})")
    return err


def row(name, source, replaces, err, ms, plain_ms, b, lib_ms, run, shape,
        routed=True):
    """One kernel entry. `run` names the path whose run gives the kernel
    this shape, `shape` the wrapper's key for it in that run's report: the
    count there fills in `launches`, which must be one a step. A
    kernel that the route does not give the shape (`routed` false, "path":
    null) must have launched there 0 times."""
    print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  library "
          f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}  "
          f"bound {b[0]:.4f} ms ({b[1]})", flush=True)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
            "library_ms": lib_ms, "path": run if routed else None,
            "run": run, "shape": shape}


FIR_SOURCE = {"fir_stream_f32": "qradiolink_tpu_torch/csrc/fir.cu",
              "fir_stream_v0_f32":
                  "qradiolink_tpu_torch/csrc/fir_stream_v0.cu",
              "fir_decim_f32": "qradiolink_tpu_torch/csrc/fir_decim.cu",
              "fir_long_f32": "qradiolink_tpu_torch/csrc/fir_long.cu",
              "fir_cols_f32": "qradiolink_tpu_torch/csrc/fir_cols.cu",
              "fir_s1_f32": "qradiolink_tpu_torch/csrc/fir_s1.cu",
              "resample_dec_f32": "qradiolink_tpu_torch/csrc/resample_dec.cu"}


def fir_row(name, replaces, xs, tf, D, n_out, tails, run, timing=True,
            on_path=True):
    """The strided FIR kernel that the shape routes to against its plain
    version (and F.conv1d), on the shape that path `run` gives it once a
    step (on_path false: a shape of a chain that no path here drives, its
    row with no path and no launch on `run`). Where the route picks a new
    kernel, fir_stream_f32, which served the shape before, is held against
    the plain version too and timed in turns with it (old, new, new, old);
    its row has no path. Where the route gives the shape to
    fir_stream_f32, its first design fir_stream_v0_f32 takes that place.
    fir_s1_f32 and fir_stream_v0_f32 keep fir_stream_f32's sum order, so
    their outputs must be equal to its bit for bit. At the L 1 heads
    (cuda_fir.DEC_SHAPES: K2239 D50, SSB's K5597 D125), routed to
    resample_dec_f32 at L 1, fir_long_f32 is timed in turns too, its row
    with no path, and the two must be equal bit for bit (the first takes
    the second's segments, column groups and sum order)."""
    from qradiolink_tpu_torch.ops import cuda_fir
    import torch.nn.functional as F

    K = tf.shape[0]
    n_rows = xs[0].numel() // xs[0].shape[-1]
    shape = cuda_fir.shape_key(xs, K, D, tails)
    op = cuda_fir.stream_route(K, D, xs[0].shape[-1], n_out, tails)
    fns = {op: lambda: cuda_fir.fir_stream(xs, tf, D, n_out, tails=tails)}
    if op != cuda_fir.OP:
        fns = {cuda_fir.OP: lambda: cuda_fir._launch_stream(
            xs, tf, D, n_out, tails), **fns}
    else:
        fns = {cuda_fir.V0_OP: lambda: cuda_fir.fir_stream_v0(
            xs, tf, D, n_out, tails), **fns}
    if op == cuda_fir.DEC_OP:
        fns[cuda_fir.LONG_OP] = lambda: cuda_fir.fir_long(
            xs, tf, D, n_out, tails)
    plain = cuda_fir.fir_stream_plain(xs, tf, D, n_out, tails=tails)
    outs = {k: fn() for k, fn in fns.items()}
    errs = {k: check_fir(f"{k}/{name}", y, plain) for k, y in outs.items()}
    for same in (cuda_fir.S1_OP, cuda_fir.V0_OP):
        if same not in outs:
            continue
        if not all(torch.equal(a, b) for a, b in
                   zip(outs[same], outs[cuda_fir.OP])):
            raise RuntimeError(f"{same}/{name}: not bit-equal to "
                               f"{cuda_fir.OP}")
        print(f"  {same}/{name}: bit-equal to {cuda_fir.OP}", flush=True)
    if cuda_fir.DEC_OP in outs:
        if not all(torch.equal(a, b) for a, b in
                   zip(outs[cuda_fir.DEC_OP], outs[cuda_fir.LONG_OP])):
            raise RuntimeError(f"{cuda_fir.DEC_OP}/{name}: not bit-equal to "
                               f"{cuda_fir.LONG_OP}")
        print(f"  {cuda_fir.DEC_OP}/{name}: bit-equal to {cuda_fir.LONG_OP}",
              flush=True)
    del outs
    torch.cuda.synchronize()
    if not timing:
        for k, err in errs.items():
            print(f"  {k}/{name}: max_abs_err {err:.3e}", flush=True)
        return []
    xcat = [x if tails is None else torch.cat([t, x], -1)
            for x, t in zip(xs, tails or [None] * len(xs))]
    lib_in = torch.stack(xcat).reshape(-1, 1, xcat[0].shape[-1])
    w = tf.reshape(1, 1, K)
    if len(fns) == 1:
        ms = {op: cuda_ms(fns[op])}
    else:
        ms, turns = turns_ms(fns)
        print(f"  {name} in turns: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in turns), flush=True)
    plain_ms = cuda_ms(lambda: cuda_fir.fir_stream_plain(
        xs, tf, D, n_out, tails=tails))
    lib_ms = cuda_ms(lambda: F.conv1d(lib_in, w, stride=D))
    n_in = sum(x.numel() for x in xs) + (
        0 if tails is None else sum(t.numel() for t in tails))
    n_bytes = 4 * (n_in + len(xs) * n_rows * n_out + K)
    b = bound(n_bytes, 2 * K * len(xs) * n_rows * n_out)
    return [row(f"{k}/{name}", FIR_SOURCE[k], replaces, errs[k], ms[k],
                plain_ms, b, lib_ms, run, shape, routed=on_path and k == op)
            for k in sorted(fns, key=lambda k: k != op)]


def fir_phase(chain, nbfm, dev, gen):
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # resampler head: two chained blocks, the tails read through strided
    # views of a (C, 2, K-1) state as the chain reads them; the second
    # (carried-tail) block is timed
    rs = chain.resamp
    k1 = rs.kp - 1
    state = torch.zeros((N_CH, 2, k1), device=dev)
    for blk in range(2):
        x = (randn(N_CH, T_STEP), randn(N_CH, T_STEP))
        tails = (state[:, 0, :], state[:, 1, :])
        rows += fir_row("head", "qradiolink_tpu/ops/pallas_fir.py:218", x,
                        rs.phase_taps[0], rs.M, T_STEP // rs.M, tails,
                        "fsk", timing=blk == 1)
        state = torch.stack([x[0][:, -k1:], x[1][:, -k1:]], dim=-2)
        del x
    n_lo = T_STEP // rs.M
    cf = chain.chan_filter
    st = randn(N_CH, 2, cf.ntaps - 1)
    rows += fir_row("chan_lp", "qradiolink_tpu/ops/pallas_fir.py:218",
                    (randn(N_CH, n_lo), randn(N_CH, n_lo)), cf.taps_flipped,
                    1, n_lo, (st[:, 0, :], st[:, 1, :]), "fsk")
    # the RRC's real input: its tail read in place from the (C, 2, K-1)
    # state, as FirFilter reads it
    sh = chain.shaping
    st = randn(N_CH, 2, sh.ntaps - 1)
    rows += fir_row("rrc", "qradiolink_tpu/ops/pallas_fir.py:111",
                    (randn(N_CH, n_lo),), sh.taps_flipped, 1, n_lo,
                    (st[:, 0, :],), "fsk")
    # the mixed path's groups, 32 ch x 100,000 samples each: the FSK
    # group's channel LP and RRC at 2,000; the NBFM group's resampler head,
    # channel LP at 2,000, audio resampler phases at 400 and audio LP at
    # 800
    nr = nbfm.resamp
    n_nb = MIX_M // 2
    for name, replaces, blk, planes in (("fsk32_chan_lp", 218, cf, 2),
                                        ("fsk32_rrc", 111, sh, 1)):
        st = randn(n_nb, 2, blk.ntaps - 1)
        rows += fir_row(name, f"qradiolink_tpu/ops/pallas_fir.py:{replaces}",
                        tuple(randn(n_nb, MIX_T // rs.M)
                              for _ in range(planes)),
                        blk.taps_flipped, 1, MIX_T // rs.M,
                        (st[:, 0, :], st[:, 1, :])[:planes], "mixed")
    st = randn(n_nb, 2, nr.kp - 1)
    rows += fir_row("nbfm_head", "qradiolink_tpu/ops/pallas_fir.py:218",
                    (randn(n_nb, MIX_T), randn(n_nb, MIX_T)),
                    nr.phase_taps[0], nr.M, MIX_T // nr.M,
                    (st[:, 0, :], st[:, 1, :]), "mixed")
    n_ch = MIX_T // nr.M
    rows += resample_rows(nbfm, n_nb, n_ch, dev, gen)
    for name, blk, n, planes in (
            ("nbfm_chan_lp", nbfm.chan_filter, n_ch, 2),
            ("nbfm_audio_lp", nbfm.audio_filter, n_ch * 2 // 5, 1)):
        st = randn(n_nb, 2, blk.ntaps - 1)
        rows += fir_row(name, "qradiolink_tpu/ops/pallas_fir.py:218",
                        tuple(randn(n_nb, n) for _ in range(planes)),
                        blk.taps_flipped, 1, n,
                        (st[:, 0, :], st[:, 1, :])[:planes], "mixed")
    return rows


def resample_rows(nbfm, n_rows, T, dev, gen):
    """The NBFM audio resampler (L 2, M 5, K 113) on the demodulated real
    audio, n_rows x T, over two chained blocks: resample_poly_f32 within
    1e-5 of the plain version, and its outputs and new state equal bit for
    bit to the two-launch route that served the shape before
    (fir_stream_f32 once a phase, the tails read in place, q_r as the
    shift, the phases interleaved and the state built in PyTorch). The
    kernel and the old route's two launches timed in turns, an empty
    kernel's launch floor, and one F.conv1d with L output channels (phase
    r's taps shifted by q_r) as the library yardstick."""
    from qradiolink_tpu_torch.ops import cuda_fir, cuda_resample
    import torch.nn.functional as F

    ar = nbfm.audio_resamp
    L, M, K, taps = ar.L, ar.M, ar.kp, ar.poly_taps
    n_pp, k1 = T // M, ar.kp - 1
    offs = cuda_resample.phase_offsets(L, M)

    def old_launches(xs, tails):
        return [cuda_fir._launch_stream(xs, ar.phase_taps[r], M, n_pp,
                                        tails, q)
                for r, q in enumerate(offs)]

    def old_route(xs, tails):
        phases = old_launches(xs, tails)
        y = torch.stack([p[0] for p in phases], -1).reshape(n_rows, -1)
        tail = torch.cat([tails[0], xs[0]], -1)[:, -k1:]
        return torch.stack([tail, torch.zeros_like(tail)], -2), (y,)

    state = torch.randn((n_rows, 2, k1), generator=gen, device=dev)
    errs = {cuda_resample.OP: 0.0, cuda_fir.OP: 0.0}
    for blk in range(2):
        xs = (torch.randn((n_rows, T), generator=gen, device=dev),)
        tails = (state[:, 0, :],)
        new_state, ys = cuda_resample.resample_poly(xs, taps, L, M, tails)
        p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M,
                                                          tails)
        o_state, o_ys = old_route(xs, tails)
        torch.cuda.synchronize()
        for op, got in ((cuda_resample.OP, ys), (cuda_fir.OP, o_ys)):
            errs[op] = max(errs[op], check_fir(f"{op}/nbfm_audio_resamp "
                                               f"block {blk}", got, p_ys))
        if not (torch.equal(ys[0], o_ys[0]) and torch.equal(new_state,
                                                            o_state)
                and torch.equal(new_state, p_state)):
            raise RuntimeError(f"resample_poly_f32 block {blk}: outputs or "
                               f"state differ from the two-launch route")
        state = new_state
    print(f"  {cuda_resample.OP}/nbfm_audio_resamp: 2 chained blocks "
          f"within 1e-5 of the plain version, outputs and state bit-equal "
          f"to the two-launch route", flush=True)
    ms, turns = turns_ms({
        cuda_fir.OP: lambda: old_launches(xs, tails),
        cuda_resample.OP: lambda: cuda_resample.resample_poly(
            xs, taps, L, M, tails)})
    print("  nbfm_audio_resamp in turns: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in turns), flush=True)
    floor_ms = cuda_ms(lambda: cuda_resample.empty_launch(dev))
    print(f"  launch floor (an empty kernel): {floor_ms:.4f} ms", flush=True)
    plain_ms = cuda_ms(lambda: cuda_resample.resample_poly_plain(
        xs, taps, L, M, tails))
    w = torch.zeros((L, 1, K + offs[-1]), device=dev)
    for r, q in enumerate(offs):
        w[r, 0, q:q + K] = taps[r]
    lib_in = torch.cat([tails[0], xs[0]], -1).reshape(n_rows, 1, -1)
    lib = F.conv1d(lib_in, w, stride=M).transpose(1, 2).reshape(n_rows, -1)
    check_fir("F.conv1d with L output channels", (lib,),
              cuda_resample.resample_poly_plain(xs, taps, L, M, tails)[1])
    lib_ms = cuda_ms(lambda: F.conv1d(lib_in, w, stride=M))
    n_bytes = 4 * (3 * n_rows * k1 + n_rows * T + L * K + n_rows * n_pp * L)
    b = bound(n_bytes, 2 * K * n_rows * n_pp * L)
    replaces = "qradiolink_tpu/ops/pallas_fir.py:111"
    return [row(f"{cuda_resample.OP}/nbfm_audio_resamp",
                "qradiolink_tpu_torch/csrc/resample_poly.cu", replaces,
                errs[cuda_resample.OP], ms[cuda_resample.OP], plain_ms, b,
                lib_ms, "mixed", cuda_resample.shape_key(xs, L, K, M)),
            row(f"{cuda_fir.OP}/nbfm_audio_resamp", FIR_SOURCE[cuda_fir.OP],
                replaces, errs[cuda_fir.OP], ms[cuda_fir.OP], plain_ms, b,
                lib_ms, "mixed", cuda_fir.shape_key(xs, K, M, tails),
                routed=False)]


def host_ms(fn, iters=20, warmup=2):
    """Median host-clock time of fn() in ms, each call fenced by a
    synchronize: the wrapper's host work and the device's time together."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def host_pace_us(dev, n_ops=200):
    """The host's pace, printed beside the host-bound steps: host-clock
    microseconds an op of n_ops adds on a one-element card tensor, each
    dispatched alone, then one synchronize; the median of 5 rounds after
    one warm-up round. The card's share is a few microseconds in all."""
    x = torch.zeros(1, device=dev)
    rounds = []
    for _ in range(6):
        t0 = time.perf_counter()
        for _ in range(n_ops):
            x = x + 1.0
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / n_ops * 1e6)
    return statistics.median(rounds[1:])


def viterbi_soft(shape, kind, dev, gen):
    """Integer soft pairs, or non-integer ones shaped like the 4FSK chain's
    clip(sin/cos(pi/2 * sym) * 128 + 128)."""
    if kind == "integer":
        return torch.randint(0, 256, shape, generator=gen,
                             device=dev).float()
    ph = float(np.pi / 2) * 1.5 * torch.randn(shape[:-1], generator=gen,
                                              device=dev)
    soft = torch.clamp(torch.stack([torch.sin(ph), torch.cos(ph)], -1)
                       * 128.0 + 128.0, 0.0, 255.0)
    if bool((soft == soft.round()).all()):
        raise RuntimeError("chain-like soft came out integer")
    return soft


def viterbi_phase(dev, gen):
    """K3. viterbi_tiled_k7 on prebuilt windows (R 8,192) bit-exact against
    the plain version. viterbi_bfly_k7 through decode_stream at the 4FSK
    shape (2048 channels x 400 pairs) and the mixed path's (32 x 200), two
    chained blocks of integer and chain-like soft: bits and new tail equal
    to the plain version's and to the old route's (the windows built in
    PyTorch, then viterbi_tiled_k7). 64 noisy CCSDS codewords through
    TiledViterbi. At both shapes, in turns: the two kernels alone (the old
    one on prebuilt windows) and the two TiledViterbi routes."""
    from qradiolink_tpu_torch.fec.conv import CCSDS_K7, conv_encode
    from qradiolink_tpu_torch.fec.conv_ff import TiledViterbi
    from qradiolink_tpu_torch.fec.viterbi_cuda import (
        decode_stream, decode_stream_plain, decode_stream_tiled,
        decode_windows, decode_windows_plain, overlap_windows)
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    W, L = 32, 128
    S = L + 2 * W
    R = N_CH * 4  # 400 pairs + 32 overlap, padded to 4 chunks of 128
    for label in ("integer", "chain-like"):
        soft = viterbi_soft((R, S, 2), label, dev, gen)
        k = decode_windows(CCSDS_K7, soft, W)
        p = decode_windows_plain(CCSDS_K7, soft, W)
        n_diff = int((k != p).sum())
        print(f"  viterbi_tiled_k7 {label} soft R{R} S{S}: {n_diff} bits "
              f"differ", flush=True)
        if n_diff:
            raise RuntimeError(f"viterbi_tiled_k7 not bit-exact ({label})")

    rows = []
    for run, n_ch, T in (("fsk", N_CH, 400), ("mixed", MIX_M // 2, 200)):
        for label in ("integer", "chain-like"):
            state = torch.full((n_ch, W, 2), 128.0, device=dev)
            for blk in range(2):
                soft = viterbi_soft((n_ch, T, 2), label, dev, gen)
                tail, bits = decode_stream(CCSDS_K7, state, soft)
                refs = {"plain": decode_stream_plain(CCSDS_K7, state, soft,
                                                     L, W),
                        "old route": decode_stream_tiled(CCSDS_K7, state,
                                                         soft, L, W)}
                for name, (r_tail, r_bits) in refs.items():
                    if not (torch.equal(bits, r_bits)
                            and torch.equal(tail, r_tail)):
                        raise RuntimeError(
                            f"viterbi_bfly_k7 {run} {label} block {blk}: "
                            f"bits or tail differ from the {name}")
                state = tail
            print(f"  viterbi_bfly_k7 {label} soft {n_ch} ch x {T} pairs, "
                  f"2 chained blocks: bits and tail equal to the plain "
                  f"version and the old route", flush=True)
        C = -(-(T + W) // L)
        R = n_ch * C
        x = torch.cat([state, soft, torch.full((n_ch, C * L - T - W, 2),
                                               128.0, device=dev)], 1)
        win = overlap_windows(x, L, W).reshape(R, S, 2).contiguous()
        ms, turns = turns_ms({
            "viterbi_tiled_k7": lambda: decode_windows(CCSDS_K7, win, W),
            "viterbi_bfly_k7": lambda: decode_stream(CCSDS_K7, state, soft)})
        print(f"  kernels at R{R} S{S} in turns: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in turns), flush=True)
        tv = TiledViterbi(lead_shape=(n_ch,), device=dev)
        routes = {"old route": lambda: decode_stream_tiled(
                      CCSDS_K7, state, soft, L, W),
                  "TiledViterbi": lambda: tv(state, soft)}
        call_ms, call_turns = turns_ms(routes)
        print(f"  TiledViterbi call {n_ch} ch x {T} pairs, device time in "
              f"turns: " + ", ".join(f"{k} {t:.4f} ms"
                                     for k, t in call_turns), flush=True)
        order = list(routes) + list(routes)[::-1]
        print(f"  TiledViterbi call {n_ch} ch x {T} pairs, host clock in "
              f"turns: " + ", ".join(f"{k} {host_ms(routes[k]):.4f} ms"
                                     for k in order), flush=True)
        plain_ms = cuda_ms(lambda: decode_stream_plain(
            CCSDS_K7, state, soft, L, W), iters=3, warmup=1)
        plain_win_ms = cuda_ms(lambda: decode_windows_plain(
            CCSDS_K7, win, W), iters=3, warmup=1)
        # per state-step: 2 mul + 4 add/sub + compare + select
        b = bound(R * S * 2 * 4 + R * (S - W), R * S * 64 * 8)
        rows.append(row(f"viterbi_bfly_k7/{run}",
                        "qradiolink_tpu_torch/csrc/viterbi_bfly.cu",
                        "qradiolink_tpu/fec/viterbi_pallas.py:83", 0.0,
                        ms["viterbi_bfly_k7"], plain_ms, b, None, run,
                        f"R{R} S{S}"))
        rows.append(row(f"viterbi_tiled_k7/{run}",
                        "qradiolink_tpu_torch/csrc/viterbi.cu",
                        "qradiolink_tpu/fec/viterbi_pallas.py:83", 0.0,
                        ms["viterbi_tiled_k7"], plain_win_ms, b, None, run,
                        f"R{R} S{S}", routed=False))

    # real CCSDS codewords, noisy soft, through TiledViterbi: the interior
    # must decode exactly
    bits = torch.randint(0, 2, (64, 600), generator=gen, device=dev)
    coded = conv_encode(CCSDS_K7, bits.to(torch.uint8)).reshape(64, 600, 2)
    soft = (coded.float() * 255.0 + torch.randn(
        (64, 600, 2), generator=gen, device=dev) * 40.0).clamp(0.0, 255.0)
    tv = TiledViterbi(lead_shape=(64,), device=dev)
    kernel_paths.reset()
    _, dec = tv(tv.init_state(), soft)
    if kernel_paths.launches("viterbi_bfly_k7") != 1:
        raise RuntimeError("TiledViterbi did not launch viterbi_bfly_k7")
    if not torch.equal(dec[:, 32:568], bits[:, 32:568].to(torch.uint8)):
        raise RuntimeError("viterbi_bfly_k7 failed to decode codewords")
    print("  TiledViterbi (viterbi_bfly_k7) decodes 64 noisy CCSDS "
          "codewords exactly", flush=True)
    return rows


def depthwise_phase(dev, gen):
    """K4 at the synthesizer's branch shape (kp 23, the tails read in place
    from a (2, 64, 22) state), the round trip's, and the channelizer's
    (kp 24, VALID), which complex input runs and no path of this script:
    64 rows, two planes, 100,000 outputs. depthwise_run_f32, which route(kp)
    gives both, within 1e-5 of the plain version and equal bit for bit to
    depthwise_fir_f32 on the concatenation, which served both before; the
    two timed in turns, beside a device copy of the same bytes. Then the
    synthesizer's _branches call against the old one (two concatenations,
    depthwise_fir_f32, the state), outputs and state equal, timed in turns.
    Returns the synthesizer's rows."""
    from qradiolink_tpu_torch.ops import cuda_depthwise as dw
    from qradiolink_tpu_torch.ops.channelizer import (PfbChannelizer,
                                                      PfbSynthesizer)
    import torch.nn.functional as F

    syn = PfbSynthesizer(MIX_M, device=dev)
    rows = []
    n_out = MIX_T
    for name, tf in (("synth", syn._bt_flipped),
                     ("branches", PfbChannelizer(MIX_M,
                                                 device=dev)._btq_flipped)):
        C, kp = tf.shape
        if dw.route(kp) != dw.RUN_OP:
            raise RuntimeError(f"kp={kp} routes to {dw.route(kp)}")
        tails = None
        if name == "synth":
            st = torch.randn((2, C, kp - 1), generator=gen, device=dev)
            tails = (st[0], st[1])
            xs = tuple(torch.randn((C, n_out), generator=gen, device=dev)
                       for _ in range(2))
            xcat = tuple(torch.cat([t, x], -1) for t, x in zip(tails, xs))
        else:
            xs = xcat = tuple(torch.randn((C, n_out + kp - 1), generator=gen,
                                          device=dev) for _ in range(2))
        key = f"C{C} kp{kp}" + (" tail" if tails is not None else "")
        kern = dw.depthwise_fir(xs, tf, n_out, tails=tails)
        old = dw._launch_fir(xcat, tf, n_out, key)
        plain = dw.depthwise_fir_plain(xs, tf, n_out, tails)
        torch.cuda.synchronize()
        err = check_fir(f"{dw.RUN_OP} {name}", kern, plain)
        old_err = check_fir(f"{dw.OP} {name}", old, plain)
        if not all(torch.equal(k, o) for k, o in zip(kern, old)):
            raise RuntimeError(f"{dw.RUN_OP} {name}: not bit-equal to "
                               f"{dw.OP}")
        print(f"  {dw.RUN_OP}/{name}: bit-equal to {dw.OP}", flush=True)
        lib_in = torch.stack(xcat)  # (2, C, Tc): the planes as a batch
        w = tf.reshape(C, 1, kp)
        lib = F.conv1d(lib_in, w, groups=C)
        check_fir(f"F.conv1d groups {name}", lib.unbind(0), plain)
        ms, turns = turns_ms({
            dw.OP: lambda: dw._launch_fir(xcat, tf, n_out, key),
            dw.RUN_OP: lambda: dw.depthwise_fir(xs, tf, n_out, tails=tails)})
        print(f"  K4 {name} in turns: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in turns), flush=True)
        plain_ms = cuda_ms(lambda: dw.depthwise_fir_plain(xs, tf, n_out,
                                                          tails))
        lib_ms = cuda_ms(lambda: F.conv1d(lib_in, w, groups=C))
        # a yardstick for the bytes: a device copy of two (C, n_out) planes
        outs = tuple(torch.empty_like(k) for k in kern)
        src = tuple(x[..., :n_out] if tails is not None else
                    x[..., kp - 1:].contiguous() for x in xs)
        copy_ms = cuda_ms(lambda: [o.copy_(p) for o, p in zip(outs, src)])
        print(f"  a device copy of the same bytes (2 planes of {C} x "
              f"{n_out} in, 2 out): {copy_ms:.4f} ms", flush=True)
        del outs, src
        n_bytes = 4 * (2 * C * (n_out + kp - 1) + 2 * C * n_out + C * kp)
        b = bound(n_bytes, 2 * kp * 2 * C * n_out)
        replaces = "qradiolink_tpu/ops/pallas_fir.py:401"
        if name == "synth":
            rows += [row(f"{dw.RUN_OP}/{name}",
                         "qradiolink_tpu_torch/csrc/depthwise_run.cu",
                         replaces, err, ms[dw.RUN_OP], plain_ms, b, lib_ms,
                         "round_trip", key),
                     row(f"{dw.OP}/{name}",
                         "qradiolink_tpu_torch/csrc/depthwise.cu", replaces,
                         old_err, ms[dw.OP], plain_ms, b, lib_ms,
                         "round_trip", key, routed=False)]

    # the synthesizer's _branches call, in turns with the route it had
    k1 = syn.kp - 1

    def old_branches(state, wre, wim):
        wc = [torch.cat([state[p], x], -1) for p, x in enumerate((wre, wim))]
        vr, vi = dw._launch_fir(wc, syn._bt_flipped, wre.shape[-1], "")
        return torch.stack([c[..., -k1:] for c in wc], -3), vr, vi

    st = torch.randn((2, MIX_M, k1), generator=gen, device=dev)
    w = [torch.randn((MIX_M, n_out), generator=gen, device=dev)
         for _ in range(2)]
    got, want = syn._branches(st, *w), old_branches(st, *w)
    if not all(torch.equal(g, o) for g, o in zip(got, want)):
        raise RuntimeError("PfbSynthesizer._branches differs from the "
                           "concatenation route")
    _, turns = turns_ms({"concatenation + depthwise_fir_f32":
                         lambda: old_branches(st, *w),
                         "_branches": lambda: syn._branches(st, *w)})
    print("  PfbSynthesizer._branches (outputs and state bit-equal) in "
          "turns: " + ", ".join(f"{k} {t:.4f} ms" for k, t in turns),
          flush=True)
    return rows


def pfb_phase(dev, gen):
    """K5 over two chained blocks at B = 1, M = 64, Tm = 100,000: the
    channelizer (pfb_fft_f32) and pfb_channelize_f32 on the same blocks,
    each against the plain version, then the two timed in turns; then the
    channelizer stage against the JAX package's default route."""
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.ops import cuda_pfb
    from qradiolink_tpu_torch.ops.channelizer import PfbChannelizer
    from qradiolink_tpu_torch.ops.cuda_pfb import channelize_plain

    ch = PfbChannelizer(MIX_M, device=dev)
    M, kp, Tm = MIX_M, ch.kp, MIX_T
    new, old = cuda_pfb.route(M, kp), cuda_pfb.OP
    if new != cuda_pfb.FFT_OP:
        raise RuntimeError(f"M={M} kp={kp} routes to {new}")
    state = ch.init_state()
    errs = {new: 0.0, old: 0.0}
    for blk in range(2):
        x = IqPair(torch.randn((Tm * M,), generator=gen, device=dev) * 0.05,
                   torch.randn((Tm * M,), generator=gen, device=dev) * 0.05)
        new_state, y = ch(state, x)
        y_old = cuda_pfb._launch((x.re, x.im), state, ch._ct, ch._dft)
        plain = channelize_plain((x.re, x.im), state, ch._ct)
        torch.cuda.synchronize()
        for op, got in ((new, (y.re, y.im)), (old, y_old)):
            errs[op] = max(errs[op], peak_err(f"{op} block {blk}", got,
                                              plain, 1e-5))
        want = torch.cat([state, torch.stack([x.re, x.im])], -1)[..., -kp * M:]
        if not torch.equal(new_state, want):
            raise RuntimeError("pfb: carried raw history is not the last "
                               "kp*M input samples")
        state = new_state
    xs = (x.re, x.im)
    print(f"  {new}: 2 chained blocks within 1e-5 of the plain version's "
          f"peak, state bit-equal", flush=True)
    ms, turns = turns_ms({
        old: lambda: cuda_pfb._launch(xs, state, ch._ct, ch._dft),
        new: lambda: cuda_pfb._launch_fft(xs, state, ch._ct)})
    print(f"  K5 M{M} kp{kp} in turns: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in turns), flush=True)
    plain_ms = cuda_ms(lambda: channelize_plain(xs, state, ch._ct))
    # a yardstick for the bytes: a device copy of the two input planes into
    # two output planes, the same 102.4 MB the kernel reads and writes
    outs = tuple(torch.empty_like(p) for p in xs)
    copy_ms = cuda_ms(lambda: [o.copy_(p) for o, p in zip(outs, xs)])
    print(f"  a device copy of the same bytes (2 planes in, 2 out): "
          f"{copy_ms:.4f} ms", flush=True)
    del outs
    # the planes in and out, the history and the taps
    n_bytes = 4 * (2 * Tm * M + 2 * kp * M + 2 * M * Tm + (kp + 1) * M)
    # the column FIR's FMAs, and the DFT at an FFT's cost, 5 M log2 M
    # flops a row of M complex samples
    n_ops = 2 * (kp + 1) * 2 * Tm * M + 5 * M * np.log2(M) * Tm
    b = bound(n_bytes, n_ops)

    # the channelizer stage by the JAX package's default route: the
    # commutator in PyTorch, K4 on the branches, the IDFT as four real
    # products over the commutator-ordered rows (column q is branch M-1-q)
    k = np.arange(M)
    wq = np.exp(2j * np.pi * np.outer(k, k) / M)[:, ::-1]
    wq_re, wq_im = (torch.tensor(a.copy(), dtype=torch.float32, device=dev)
                    for a in (wq.real, wq.imag))

    def jax_route():
        vr, vi = ch._branches(state, x.re, x.im)
        return ch._new_raw(state, x.re, x.im), (
            torch.matmul(wq_re, vr) - torch.matmul(wq_im, vi),
            torch.matmul(wq_re, vi) + torch.matmul(wq_im, vr))

    _, y = ch(state, x)
    _, yj = jax_route()
    route_err = peak_err("JAX default route", yj, (y.re, y.im), 1e-5)
    stage_ms = cuda_ms(lambda: ch(state, x))
    route_ms = cuda_ms(jax_route)
    print(f"  channelizer stage {stage_ms:.4f} ms ({new}); the JAX "
          f"package's default route {route_ms:.4f} ms (commutator + K4 + "
          f"products), max |diff| {route_err:.3e}", flush=True)
    replaces = "qradiolink_tpu/ops/pallas_pfb.py:186"
    return [row(new, "qradiolink_tpu_torch/csrc/pfb_fft.cu", replaces,
                errs[new], ms[new], plain_ms, b, None, "mixed",
                f"M{M} kp{kp}"),
            row(old, "qradiolink_tpu_torch/csrc/pfb.cu", replaces, errs[old],
                ms[old], plain_ms, b, None, "mixed", f"M{M} kp{kp}",
                routed=False)]


def timed(stages, name, fn):
    """fn() fenced by CUDA events; its time goes to stages[name]."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    y = fn()
    end.record()
    end.synchronize()
    stages[name] = round(start.elapsed_time(end), 4)
    return y


def trace_step(name, fn):
    """Two calls of fn under torch.profiler, the first a warm-up that is
    not recorded; prints the second's device ops (kernels, copies, fills),
    the five that took the most device time by name, the time the device
    was busy with them (the union of their intervals) and the span from
    the first one's start to the last one's end. The profiler's own host
    work stretches the span, so the idle share it gives is an upper bound.
    (Without the warm-up, the SSB step's traced ops lacked its longest
    kernel, which scripts/trace_fir_stream.py shows the profiler records
    when it is traced on its own.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    traced = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: traced.extend(p.events())) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    # the profiler's own step annotation spans the step on the device
    # timeline; it is not an op
    ops = [(e.time_range.start, e.time_range.end, e.name)
           for e in traced if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")]
    spans = sorted(o[:2] for o in ops)
    if not spans:
        print(f"  {name} traced: the profiler saw no device ops", flush=True)
        return
    by_name = {}
    for lo, hi, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (hi - lo) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"  {name} traced, device ms by op: " + "; ".join(
        f"{n[:60]} {ms:.3f}" for n, ms in top), flush=True)
    busy, end = 0.0, spans[0][0]
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    span = end - spans[0][0]
    print(f"  {name} traced: {len(spans)} device ops, busy {busy / 1e3:.3f} "
          f"ms of a {span / 1e3:.3f} ms span ({1 - busy / span:.1%} idle)",
          flush=True)


def step_times(step_s, n_samples):
    ms = [s * 1e3 for s in step_s]
    med = statistics.median(ms[1:])
    return (f"step ms {[round(m, 3) for m in ms]}  (median of steps 2-"
            f"{len(ms)} {med:.3f} ms, {n_samples / med / 1e3:.1f} "
            f"Msamples/s)")


def drive(fn, state, xs, every_step):
    """state, out = fn(state, x) for each x of the list xs in turn, each
    call fenced and timed on the host clock, with the launch counters
    zeroed just before: every op of every_step must launch on each step,
    and nothing may take a plain path. Returns (state, every step's output,
    step seconds, kernel report)."""
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    step_s, seen, outs = [], {op: 0 for op in every_step}, []
    kernel_paths.reset()
    for i, x in enumerate(xs):
        t0 = time.perf_counter()
        state, out = fn(state, x)
        outs.append(out)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        for op in every_step:
            n = kernel_paths.launches(op)
            if n <= seen[op]:
                raise RuntimeError(f"step {i}: {op} did not launch")
            seen[op] = n
    report = kernel_paths.report()
    print(f"  kernel paths over {len(xs)} steps: {json.dumps(report)}",
          flush=True)
    if not kernel_paths.served_only():
        raise RuntimeError("a stage took the plain path on the card")
    return state, outs, step_s, report


# ops each main path must launch on every step
FSK_EVERY_STEP = ("fir_decim_f32", "fir_s1_f32", "viterbi_bfly_k7")
MIXED_EVERY_STEP = ("pfb_fft_f32", "resample_dec_f32",
                    "resample_poly_f32") + FSK_EVERY_STEP


def main_path(chain, dev, gen):
    from qradiolink_tpu_torch.core import IqPair

    iq = IqPair(torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1,
                torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1)
    state = chain.init_state()
    torch.cuda.synchronize()
    state, outs, step_s, report = drive(chain, state, [iq] * N_STEPS,
                                        FSK_EVERY_STEP)
    out = outs[-1]
    n_sym = T_STEP // chain.resamp.M // chain.sps
    checks = {"bits": (N_CH, n_sym), "symbols": (N_CH, n_sym),
              "rssi": (N_CH,)}
    for key, shape in checks.items():
        if tuple(out[key].shape) != shape:
            raise RuntimeError(f"{key} shape {tuple(out[key].shape)}")
    if out["bits"].dtype != torch.uint8 or int(out["bits"].max()) > 1:
        raise RuntimeError("bits are not 0/1 uint8")
    for v in (out["symbols"], out["rssi"], out["constellation"].re,
              out["constellation"].im):
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError("non-finite chain output")
    med = statistics.median([s * 1e3 for s in step_s[1:]])
    print(f"  {step_times(step_s, N_CH * T_STEP)}, "
          f"{N_CH * T_STEP / med / 1e3 / N_CH:.2f} Msamples/s per channel",
          flush=True)

    # one more step, stage by stage (after the counters were read)
    from qradiolink_tpu_torch.core import Sequencer
    from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
    seq = Sequencer(state)
    stages = {}
    x = timed(stages, "resampler (fir_decim_f32 head)",
              lambda: seq(chain.resamp, iq))
    x = timed(stages, "channel LP (fir_s1_f32 K55)",
              lambda: seq(chain.chan_filter, x))
    timed(stages, "rssi", lambda: rssi_dbm(x))
    x = timed(stages, "quadrature demod", lambda: seq(chain.quad, x))
    x = timed(stages, "RRC (fir_s1_f32 K251)",
              lambda: seq(chain.shaping, x))
    syms = timed(stages, "feedforward sync",
                 lambda: seq(chain.symbol_sync, x))

    def soft_map():
        ph = float(np.pi / 2) * syms
        s = torch.stack([torch.sin(ph), torch.cos(ph)], -1)
        return torch.clamp(s.reshape(N_CH, -1) * 128.0 + 128.0, 0.0, 255.0)

    soft = timed(stages, "soft mapping", soft_map)
    timed(stages, "FEC tail (viterbi_bfly_k7 + descrambler)",
          lambda: seq(chain.fec_tail, soft))
    print(f"  stage ms (one step, CUDA events): {json.dumps(stages)}",
          flush=True)
    trace_step("one more step", lambda: chain(state, iq))
    return report


def mixed_groups():
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod

    half = MIX_M // 2
    return [(Fsk4DemodFF, list(range(half))),
            (NbfmDemod, list(range(half, MIX_M)))]


def mixed_path(dev, gen):
    """The mixed 64-channel config; returns the kernel report of its
    steps."""
    from qradiolink_tpu_torch.core import IqPair, Sequencer, iq_take
    from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
    from qradiolink_tpu_torch.parallel.sharding import MultichannelRx

    rx = MultichannelRx(MIX_M, mixed_groups(), device=dev)
    T = MIX_M * MIX_T
    # bench.py:136-137: complex normal IQ at 0.05 RMS a plane
    iq = IqPair(torch.randn((T,), generator=gen, device=dev) * 0.05,
                torch.randn((T,), generator=gen, device=dev) * 0.05)
    state = rx.init_state()
    torch.cuda.synchronize()
    state, outs, step_s, report = drive(rx, state, [iq] * N_STEPS,
                                        MIXED_EVERY_STEP)
    fsk, nb = outs[-1]
    for op in ("fir_stream_f32", "pfb_channelize_f32"):
        if report.get(op, {}).get("cuda", 0):
            raise RuntimeError(f"the mixed path launched {op}")
    n_fsk, n_nb = len(rx.groups[0][1]), len(rx.groups[1][1])
    want = {"bits": (fsk["bits"], (n_fsk, MIX_T // 500)),
            "symbols": (fsk["symbols"], (n_fsk, MIX_T // 500)),
            "audio": (nb["audio"], (n_nb, MIX_T // 125)),
            "nbfm rssi": (nb["rssi"], (n_nb,))}
    for key, (v, shape) in want.items():
        if tuple(v.shape) != shape or not bool(torch.isfinite(
                v.float()).all()):
            raise RuntimeError(f"{key}: shape {tuple(v.shape)} or "
                               f"non-finite")
    print(f"  {step_times(step_s, T)}", flush=True)

    # one more step, stage by stage (after the counters were read)
    stages = {}
    ch_state, g_states = state
    _, chans = timed(stages, "channelizer (K5, pfb_fft_f32)",
                     lambda: rx.channelizer(ch_state, iq))
    (fchain, fidx), (nchain, nidx) = rx.groups
    xf = iq_take(chans, fidx)
    xn = iq_take(chans, nidx)
    timed(stages, "FSK group (32 ch)", lambda: fchain(g_states[0], xf))
    timed(stages, "NBFM group (32 ch)", lambda: nchain(g_states[1], xn))
    seq = Sequencer(g_states[1])
    x = timed(stages, "nbfm resampler (resample_dec_f32 head K2239 D50)",
              lambda: seq(nchain.resamp, xn))
    x = timed(stages, "nbfm channel LP (fir_s1_f32 K133)",
              lambda: seq(nchain.chan_filter, x))
    timed(stages, "nbfm rssi", lambda: rssi_dbm(x))
    x = timed(stages, "nbfm power squelch", lambda: seq(nchain.squelch, x))
    x = timed(stages, "nbfm quadrature demod", lambda: seq(nchain.quad, x))
    x = timed(stages, "nbfm audio resampler (2/5, resample_poly_f32)",
              lambda: seq(nchain.audio_resamp, x))
    x = timed(stages, "nbfm audio LP (fir_s1_f32 K55)",
              lambda: seq(nchain.audio_filter, x))
    timed(stages, "nbfm de-emphasis", lambda: seq(nchain.deemph, x))
    print(f"  stage ms (one step, CUDA events): {json.dumps(stages)}",
          flush=True)
    trace_step("one more step", lambda: rx(state, iq))
    trace_step("its NBFM group", lambda: nchain(g_states[1], xn))
    return report


def fixture_phase(dev):
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.core import IqPair

    data = np.load(FIXTURE)
    re = data["iq_re"].astype(np.float32)
    im = data["iq_im"].astype(np.float32)
    half = len(re) // 2
    outs = {}
    for d in (dev, torch.device("cpu")):
        chain = Fsk4DemodFF(device=d)
        state = chain.init_state()
        bits, syms = [], []
        for sl in (slice(0, half), slice(half, 2 * half)):
            iq = IqPair(torch.from_numpy(re[sl].copy()).to(d),
                        torch.from_numpy(im[sl].copy()).to(d))
            state, out = chain(state, iq)
            bits.append(out["bits"].cpu().numpy())
            syms.append(out["symbols"].cpu().numpy())
        outs[d.type] = (np.concatenate(bits), np.concatenate(syms))
    (gb, gs), (cb, cs) = outs["cuda"], outs["cpu"]
    sent = bytes_to_bits(torch.from_numpy(data["payload"])).numpy()
    ber = best_ber(gb, sent)
    n_diff = int((gb != cb).sum())
    print(f"  fixture: {n_diff} of {gb.size} bits differ card vs CPU, "
          f"symbols max |diff| {float(np.abs(gs - cs).max()):.3e}, "
          f"BER {ber:.4f}", flush=True)
    if n_diff:
        raise RuntimeError("card bits differ from CPU bits on the fixture")
    if not ber < 0.01:
        raise RuntimeError(f"fixture BER {ber}")


def nbfm_signal(n, seed=7):
    """Seeded 1 Msps NBFM IQ: a 1 kHz tone at 2.5 kHz deviation plus noise
    at 0.05 RMS a plane (the input of tests/test_torch_nbfm.py)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 1e6
    ph = np.cumsum(2 * np.pi * 2500.0 * 0.5 * np.sin(2 * np.pi * 1e3 * t)
                   / 1e6)
    x = np.exp(1j * ph) + 0.05 * (rng.standard_normal(n)
                                  + 1j * rng.standard_normal(n))
    return x.real.astype(np.float32), x.imag.astype(np.float32)


def round_trip_phase(dev, M=MIX_M, fsk_ch=3, nbfm_ch=40, steps=RT_STEPS,
                     devices=None):
    """The capture on channel fsk_ch of M by the synthesizer on `dev`, an
    NBFM signal on nbfm_ch, then MultichannelRx(M) on each of `devices`
    (default: dev and the CPU). Returns the synthesizer's kernel report."""
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.ops.channelizer import PfbSynthesizer
    from qradiolink_tpu_torch.parallel.sharding import MultichannelRx
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    data = np.load(FIXTURE)
    cap = (torch.from_numpy(data["iq_re"].astype(np.float32)),
           torch.from_numpy(data["iq_im"].astype(np.float32)))
    Tm = cap[0].shape[0] // steps
    nb = [torch.from_numpy(p) for p in nbfm_signal(Tm * steps)]
    syn = PfbSynthesizer(M, device=dev)
    st = syn.init_state()
    wide = []
    kernel_paths.reset()
    for i in range(steps):
        s = [torch.zeros((M, Tm), device=dev) for _ in range(2)]
        for p in range(2):
            s[p][fsk_ch] = cap[p][i * Tm:(i + 1) * Tm].to(dev)
            s[p][nbfm_ch] = nb[p][i * Tm:(i + 1) * Tm].to(dev)
        st, y = syn(st, IqPair(*s))
        wide.append(y)
    report = kernel_paths.report()
    if report.get("depthwise_fir_f32", {}).get("cuda", 0):
        raise RuntimeError("the synthesizer launched depthwise_fir_f32")
    outs = {}
    for d in devices or (dev, torch.device("cpu")):
        rx = MultichannelRx(M, [(Fsk4DemodFF, [fsk_ch]),
                                (NbfmDemod, [nbfm_ch])], device=d)
        state = rx.init_state()
        bits, audio = [], []
        for y in wide:
            state, (fo, no) = rx(state, IqPair(y.re.to(d), y.im.to(d)))
            bits.append(fo["bits"][0].cpu().numpy())
            audio.append(no["audio"][0].cpu().numpy())
        outs[d.type] = (np.concatenate(bits), np.concatenate(audio))
    sent = bytes_to_bits(torch.from_numpy(data["payload"])).numpy()
    (gb, ga), (cb, ca) = outs[dev.type], outs["cpu"]
    ber = best_ber(gb, sent)
    n_diff = int((gb != cb).sum())
    a_err = float(np.abs(ga - ca).max())
    a_ok = bool(np.all(np.abs(ga - ca) <= 1e-5 + 1e-5 * np.abs(ca)))
    print(f"  round trip (M={M}, {steps} steps of {Tm}): {n_diff} of "
          f"{gb.size} FSK bits differ {dev.type} vs CPU, BER {ber:.4f}; "
          f"NBFM audio max |diff| {a_err:.3e} (peak "
          f"{float(np.abs(ca).max()):.3f})", flush=True)
    if n_diff:
        raise RuntimeError("round trip: bits differ between devices")
    if not ber < 0.01:
        raise RuntimeError(f"round trip BER {ber}")
    if not a_ok:
        raise RuntimeError("round trip: NBFM audio differs between devices")
    return report


# -- the analog voice chains (SSB, AM, WBFM, the TX side) --------------------

SSB_EVERY_STEP = ("resample_dec_f32", "fir_s1_f32", "agc2_f32")
WBFM_EVERY_STEP = ("fir_cols_f32", "fir_s1_f32")
TX_EVERY_STEP = ("fir_s1_f32", "resample_up_f32")
AUDIO_PER_STEP = T_STEP // 125   # 8 ksps audio samples a step (1,600)
# BASELINE's 4FSK target: 10x real time a channel (PERF.md section 2)
VS_BASELINE_LIMIT = 10.0


def require_shapes(report, want, steps, run, never=()):
    """Each (op, key): n of `want` must have launched n x steps times on
    the `run` path, and each op of `never` not at all."""
    for op in never:
        if report.get(op, {}).get("cuda", 0):
            raise RuntimeError(f"{run}: {op} launched: {report[op]}")
    for (op, key), n in want.items():
        got = report.get(op, {}).get("shapes", {}).get(f"cuda {key}", 0)
        if got != n * steps:
            raise RuntimeError(f"{run}: {op} at {key} launched {got} times "
                               f"in {steps} steps, not {n * steps}")
        print(f"  {run}: {op} at {key}: {got} launches in {steps} steps",
              flush=True)


def only_shape(report, op, key, run):
    """op launched at no shape but key on the `run` path."""
    shapes = {k for k, n in report.get(op, {}).get("shapes", {}).items()
              if k.startswith("cuda ") and n}
    if shapes - {f"cuda {key}"}:
        raise RuntimeError(f"{run}: {op} launched at {sorted(shapes)}, "
                           f"not only at {key}")
    print(f"  {run}: {op} at {key} alone", flush=True)


def ssb_path(dev, gen):
    """The slice's main path: SsbDemod(usb=True) at 2048 channels x 200,000
    samples a step (the 4FSK path's shape), seeded IQ at 0.1 RMS a plane,
    3 steps with state carried and the counters zeroed just before; the
    head on resample_dec_f32 at L 1, the channel band-pass two fir_s1_f32
    launches, the audio band-pass one, agc2_f32 one, a step,
    fir_stream_f32, fir_long_f32 and agc2_gain_f32 none. The step must
    beat vs_baseline 10; it is printed beside the host's pace just before
    and just after (host_pace_us), since the step is partly host-bound. Then one more step stage by stage, and
    one under torch.profiler. Returns the report."""
    from qradiolink_tpu_torch.chains.ssb import SsbDemod
    from qradiolink_tpu_torch.core import IqPair, Sequencer
    from qradiolink_tpu_torch.ops.spectrum import rssi_dbm

    chain = SsbDemod(usb=True, lead_shape=(N_CH,), device=dev)
    iq = IqPair(torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1,
                torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1)
    state = chain.init_state()
    torch.cuda.synchronize()
    pace = [host_pace_us(dev)]
    state, outs, step_s, report = drive(chain, state, [iq] * N_STEPS,
                                        SSB_EVERY_STEP)
    out = outs[-1]
    pace.append(host_pace_us(dev))
    for key, shape in (("audio", (N_CH, AUDIO_PER_STEP)), ("rssi", (N_CH,))):
        v = out[key]
        if tuple(v.shape) != shape or v.dtype != torch.float32 \
                or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"ssb {key}: {tuple(v.shape)} {v.dtype} or "
                               f"non-finite")
    if not float(out["audio"].abs().max()) > 0:
        raise RuntimeError("ssb audio is all zero")
    from qradiolink_tpu_torch.ops.fir import FFT_OP

    cf = chain.chan_filter
    require_shapes(report, {
        ("resample_dec_f32", f"K{chain.resamp.kp} D125 tail 2x{N_CH}"): 1,
        (FFT_OP, f"K{cf.ntaps} D1 2x{N_CH}") if cf.form(False) == "fft"
        else ("fir_s1_f32", f"K{cf.ntaps} D1 tail 2x{N_CH}"): (
            1 if cf.form(False) == "fft" else 2),
        ("fir_s1_f32", f"K{chain.audio_filter.ntaps} D1 tail 1x{N_CH}"): 1,
        ("agc2_f32", f"complex {N_CH}x{AUDIO_PER_STEP}"): 1}, N_STEPS, "ssb",
        never=("fir_stream_f32", "agc2_gain_f32", "fir_long_f32"))
    med = statistics.median([s * 1e3 for s in step_s[1:]])
    vs = N_CH * T_STEP / med / 1e3 / N_CH
    print(f"  {step_times(step_s, N_CH * T_STEP)}, vs_baseline {vs:.2f} "
          f"Msamples/s per channel (limit {VS_BASELINE_LIMIT}); host pace "
          f"{pace[0]:.2f} / {pace[1]:.2f} us an op before / after "
          f"(host_pace_us)", flush=True)
    if not vs > VS_BASELINE_LIMIT:
        raise RuntimeError(f"ssb: vs_baseline {vs:.2f} is not above "
                           f"{VS_BASELINE_LIMIT}")

    seq = Sequencer(state)
    stages = {}
    x = timed(stages, "resampler 1/125 (resample_dec_f32 K5597 D125)",
              lambda: seq(chain.resamp, iq))
    x = timed(stages, "x0.9", lambda: 0.9 * x)
    x = timed(stages, f"channel band-pass (K{cf.ntaps} complex, "
              + ("FFT)" if cf.form(False) == "fft"
                 else "fir_s1_f32, 2 launches)"),
              lambda: seq(chain.chan_filter, x))
    timed(stages, "rssi", lambda: rssi_dbm(x))
    x = timed(stages, "power squelch", lambda: seq(chain.squelch, x))
    x = timed(stages, "agc (agc2_f32)", lambda: seq(chain.agc, x))
    x = timed(stages, "cessb clipper", lambda: chain.clipper.apply(x))
    x = timed(stages, "cessb stretcher", lambda: seq(chain.stretcher, x))
    x = timed(stages, "real x1.333", lambda: x.real * 1.333)
    timed(stages, "audio band-pass (fir_s1_f32 K97)",
          lambda: seq(chain.audio_filter, x))
    print(f"  stage ms (one step, CUDA events): {json.dumps(stages)}",
          flush=True)
    trace_step("one more step", lambda: chain(state, iq))
    return report


def wbfm_path(dev, gen):
    """WbfmDemod at 2048 x 200,000 a step, 3 steps, counters zeroed just
    before: the head (K225 D5) and the audio resampler (K1121 D25, real,
    its tail read in place) on fir_cols_f32, the channel and audio
    low-passes on fir_s1_f32, once each a step; fir_stream_f32 none.
    Returns the report."""
    from qradiolink_tpu_torch.chains.wbfm import WbfmDemod
    from qradiolink_tpu_torch.core import IqPair

    chain = WbfmDemod(lead_shape=(N_CH,), device=dev)
    iq = IqPair(torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1,
                torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1)
    state, outs, step_s, report = drive(chain, chain.init_state(),
                                        [iq] * N_STEPS, WBFM_EVERY_STEP)
    out = outs[-1]
    if tuple(out["audio"].shape) != (N_CH, AUDIO_PER_STEP) \
            or not bool(torch.isfinite(out["audio"]).all()):
        raise RuntimeError("wbfm audio: wrong shape or non-finite")
    require_shapes(report, {
        ("fir_cols_f32", f"K{chain.resamp.kp} D5 tail 2x{N_CH}"): 1,
        ("fir_s1_f32", f"K{chain.chan_filter.ntaps} D1 tail 2x{N_CH}"): 1,
        ("fir_cols_f32", f"K{chain.audio_resamp.kp} D25 tail 1x{N_CH}"): 1,
        ("fir_s1_f32", f"K{chain.audio_filter.ntaps} D1 tail 1x{N_CH}"): 1},
        N_STEPS, "wbfm", never=("fir_stream_f32",))
    print(f"  {step_times(step_s, N_CH * T_STEP)}", flush=True)
    return report


def tx_modulators(dev):
    from qradiolink_tpu_torch.chains.nbfm import NbfmMod
    from qradiolink_tpu_torch.chains.ssb import SsbMod

    return (SsbMod(usb=True, lead_shape=(N_CH,), device=dev),
            NbfmMod(lead_shape=(N_CH,), pair=True, device=dev))


def am_modulator(dev):
    from qradiolink_tpu_torch.chains.am import AmMod

    return AmMod(lead_shape=(N_CH,), device=dev)


def tx_audio(dev, gen):
    """A 1 kHz tone at 0.5 with seeded noise at 0.05, 2048 x 1,600."""
    t = torch.arange(AUDIO_PER_STEP, device=dev) / 8000.0
    return (0.5 * torch.sin(2 * np.pi * 1000.0 * t)
            + 0.05 * torch.randn((N_CH, AUDIO_PER_STEP), generator=gen,
                                 device=dev)).float()


def tx_path(dev, gen):
    """The TX side at 2048 channels: SsbMod and NbfmMod (IqPair out) on
    1,600 audio samples a step (200,000 IQ samples out), 3 steps, counters
    zeroed just before: the 125/1, 25/4 and 20/1 interpolators on
    resample_up_f32, once each a step, resample_poly_f32 never; then one
    more step under torch.profiler. Returns the report."""
    ssbm, nbm = tx_modulators(dev)
    audio = tx_audio(dev, gen)

    def step(states, a):
        s1, o1 = ssbm(states[0], a)
        s2, o2 = nbm(states[1], a)
        return (s1, s2), (o1["iq"], o2["iq"])

    states, outs, step_s, report = drive(
        step, (ssbm.init_state(), nbm.init_state()), [audio] * N_STEPS,
        TX_EVERY_STEP)
    iq_ssb, iq_nb = outs[-1]
    for name, v in (("ssb", iq_ssb), ("nbfm re", iq_nb.re),
                    ("nbfm im", iq_nb.im)):
        if tuple(v.shape) != (N_CH, T_STEP) \
                or not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"tx {name}: wrong shape or non-finite")
    require_shapes(report, {
        ("resample_up_f32", f"L125 K{ssbm.up.kp} D1 tail 2x{N_CH}"): 1,
        ("resample_up_f32", f"L25 K{nbm.up1.kp} D4 tail 1x{N_CH}"): 1,
        ("resample_up_f32", f"L20 K{nbm.up2.kp} D1 tail 2x{N_CH}"): 1},
        N_STEPS, "tx", never=("resample_poly_f32",))
    print(f"  {step_times(step_s, 2 * N_CH * T_STEP)} (IQ samples out of "
          f"both modulators)", flush=True)
    trace_step("one more step", lambda: step(states, audio))
    return report


def am_tx_path(dev, gen):
    """AmMod at 2048 channels on the same audio, 3 steps, counters zeroed
    just before: its 125/1 interpolator on one real plane, on
    resample_up_f32 once a step, resample_poly_f32 never; complex64 IQ of
    200,000 samples a channel out; then one more step under
    torch.profiler. Returns the report."""
    from qradiolink_tpu_torch.ops.fir import FFT_OP

    am = am_modulator(dev)
    audio = tx_audio(dev, gen)
    fft = am.post_filter.form(True) == "fft"
    state, outs, step_s, report = drive(
        am, am.init_state(), [audio] * N_STEPS,
        TX_EVERY_STEP + ((FFT_OP,) if fft else ()))
    iq = outs[-1]["iq"]
    if tuple(iq.shape) != (N_CH, T_STEP) or iq.dtype != torch.complex64 \
            or not bool(torch.isfinite(torch.view_as_real(iq)).all()):
        raise RuntimeError("am tx iq: wrong shape, dtype or non-finite")
    pf = am.post_filter
    want = {("resample_up_f32", f"L125 K{am.up.kp} D1 tail 1x{N_CH}"): 1}
    if fft:
        want[(FFT_OP, f"K{pf.ntaps} D1 2x{N_CH}")] = 1
    require_shapes(report, want, N_STEPS, "am_tx",
                   never=("resample_poly_f32",))
    direct_key = f"cuda K{pf.ntaps} D1 tail 2x{N_CH}"
    if fft and report.get("fir_s1_f32", {}).get("shapes", {}).get(
            direct_key):
        raise RuntimeError("am_tx: the post filter launched fir_s1_f32")
    print(f"  {step_times(step_s, N_CH * T_STEP)} (IQ samples out)",
          flush=True)
    trace_step("one more step", lambda: am(state, audio))
    return report


def am_path(dev, gen):
    """AmDemod at 2048 x 200,000 a step, 3 steps, counters zeroed just
    before: its AGC (on the real magnitudes, 2048 x 4,000) one launch of
    agc2_f32 a step, agc2_gain_f32 none. Returns the report."""
    from qradiolink_tpu_torch.chains.am import AmDemod
    from qradiolink_tpu_torch.core import IqPair

    chain = AmDemod(lead_shape=(N_CH,), device=dev)
    iq = IqPair(torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1,
                torch.randn((N_CH, T_STEP), generator=gen, device=dev) * 0.1)
    _, outs, step_s, report = drive(chain, chain.init_state(),
                                    [iq] * N_STEPS, ("agc2_f32",))
    audio = outs[-1]["audio"]
    if tuple(audio.shape) != (N_CH, AUDIO_PER_STEP) \
            or not bool(torch.isfinite(audio).all()):
        raise RuntimeError(f"am audio: {tuple(audio.shape)} or non-finite")
    require_shapes(report, {("agc2_f32", f"real {N_CH}x{T_STEP // 50}"): 1},
                   N_STEPS, "am", never=("agc2_gain_f32",))
    print(f"  {step_times(step_s, N_CH * T_STEP)}", flush=True)
    return report

def complex_fir_row(name, replaces, filt, C, n, run, dev, gen,
                    routed=True):
    """A FIR with complex taps over the (re, im) planes of C rows x n
    samples, tails read in place: fir_planes (two launches of the routed
    kernel, one a tap plane, then the combine) against its plain version
    (the plain FIR twice, the same combine), and one complex F.conv1d as
    the library call. routed false: no path launches the kernel at this
    shape (a row with no path)."""
    from qradiolink_tpu_torch.ops import cuda_fir
    from qradiolink_tpu_torch.ops.fir import fir_planes
    import torch.nn.functional as F

    K = filt.ntaps
    op = cuda_fir.route(K, 1)
    tr, ti = filt.tap_planes
    xs = tuple(torch.randn((C, n), generator=gen, device=dev)
               for _ in range(2))
    st = torch.randn((C, 2, K - 1), generator=gen, device=dev)
    tails = (st[:, 0, :], st[:, 1, :])

    def plain():
        (rr, ir), (ri, ii) = (cuda_fir.fir_stream_plain(xs, t, 1, n, tails)
                              for t in (tr, ti))
        return rr - ii, ri + ir

    got = fir_planes(xs, (tr, ti), 1, n, tails)
    err = check_fir(f"{op}/{name}", got, plain())
    xc = torch.complex(*(torch.cat([t, x], -1) for t, x in zip(tails, xs)))
    w = torch.complex(tr, ti).reshape(1, 1, K)
    lib = F.conv1d(xc.reshape(C, 1, -1), w).reshape(C, n)
    check_fir(f"complex F.conv1d/{name}", (lib.real, lib.imag), plain())
    ms = cuda_ms(lambda: fir_planes(xs, (tr, ti), 1, n, tails))
    plain_ms = cuda_ms(plain)
    lib_ms = cuda_ms(lambda: F.conv1d(xc.reshape(C, 1, -1), w))
    # two planes and their tails in, two out, two tap planes; four real
    # FIRs of 2K operations an output
    b = bound(4 * (2 * C * (n + K - 1) + 2 * C * n + 2 * K),
              4 * 2 * K * C * n)
    r = row(f"{op}/{name}", FIR_SOURCE[op], replaces, err, ms, plain_ms, b,
            lib_ms, run, cuda_fir.shape_key(xs, K, 1, tails), routed=routed)
    r["per_step"] = 2
    return [r]


def agc_rows(dev, gen):
    """agc2_f32, the Agc2 stage in one launch, at the QPSK250K path's shape
    (2048 x 100,000 complex, a QPSK signal whose first samples are ~1e-20),
    the SSB path's (2048 x 1,600 complex) and the AM path's (2048 x 4,000
    real): y and the carried gain equal bit for bit to the plain version's
    (torch.abs, the loop, the products) over two chained blocks of bursty
    input at the SSB and AM shapes and at 2048 x 4,000 complex, and at
    QPSK250K's shape to one timed call of the plain version; each timed in
    turns (old, new, new, old) with the stage as it ran before (torch.abs,
    agc2_gain_f32, the products plane by plane), beside the chain's floor
    (scripts/loop_chain_floor.py's agc variant, the recurrence alone on a
    register ring). agc2_gain_f32, which no path launches now, stays
    bit-equal to its plain loop at the SSB and AM shapes; its rows (path
    null) give its time at the QPSK250K and SSB shapes. No PyTorch call
    computes the recurrence."""
    from qradiolink_tpu_torch.chains.am import AmDemod
    from qradiolink_tpu_torch.chains.psk import QpskDemod
    from qradiolink_tpu_torch.chains.ssb import SsbDemod
    from qradiolink_tpu_torch.ops import cuda_agc

    sys.path.insert(0, str(HERE / "scripts"))
    import loop_chain_floor

    src = "qradiolink_tpu_torch/csrc/agc2.cu"
    where = "qradiolink_tpu/ops/agc.py:51"
    agcs = {"qpsk": QpskDemod(125_000, 500_000, device=dev).agc,
            "ssb": SsbDemod(usb=True, device=dev).agc,
            "am": AmDemod(device=dev).agc}

    def params(name):
        a = agcs[name]
        return a.attack, a.decay, a.reference, a.max_gain

    def bursty(T, cplx):
        amp = torch.where((torch.arange(T, device=dev) // 150) % 2 == 0,
                          2.0, 0.02)
        dt = torch.complex64 if cplx else torch.float32
        return torch.randn((N_CH, T), generator=gen, device=dev,
                           dtype=dt) * amp

    # two chained blocks: agc2_f32 against the plain stage; agc2_gain_f32
    # against its plain loop
    for name, T, cplx in (("ssb", AUDIO_PER_STEP, True),
                          ("am", T_STEP // 50, False),
                          ("qpsk", T_STEP // 50, True)):
        g = gg = torch.ones(N_CH, device=dev)
        for blk in range(2):
            x = bursty(T, cplx)
            if blk == 0:
                x[:, :200] *= 1e-20
            args = (*params(name),)
            got = cuda_agc.agc2(x, g, *args)
            equal_leaves(f"{cuda_agc.OP_FUSED}/{name} {N_CH}x{T} block "
                         f"{blk}", got, cuda_agc.agc2_plain(x, g, *args))
            m = torch.abs(x).float()
            old = cuda_agc.agc2_gain(m, gg, *args)
            equal_leaves(f"{cuda_agc.OP}/{name} {N_CH}x{T} block {blk}",
                         old, cuda_agc.agc2_gain_plain(m, gg, *args))
            g, gg = got[1], old[1]
        print(f"  {cuda_agc.OP_FUSED} and {cuda_agc.OP} {name} {N_CH}x{T} "
              f"{'complex' if cplx else 'real'}: 2 chained blocks equal bit "
              f"for bit to their plain versions", flush=True)

    chain_lib = loop_chain_floor.build_agc_chain()
    rows = []
    T_in = T_STEP // 2
    for name, run, T, cplx in (("qpsk", "qpsk", T_in, True),
                               ("ssb", "ssb", AUDIO_PER_STEP, True),
                               ("am", "am", T_STEP // 50, False)):
        x = loop_signal(dev, gen, N_CH, T) if name == "qpsk" else bursty(
            T, cplx)
        g0 = torch.ones(N_CH, device=dev)
        args = (x, g0, *params(name))
        (ms, seq) = turns_ms({
            "stage_before": lambda: loop_chain_floor.agc_stage_before(*args),
            cuda_agc.OP_FUSED: lambda: cuda_agc.agc2(*args)})
        got = cuda_agc.agc2(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = cuda_agc.agc2_plain(*args)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        equal_leaves(f"{cuda_agc.OP_FUSED}/{name} at {tuple(x.shape)}", got,
                     want)
        floor = loop_chain_floor.agc_chain_ms(
            chain_lib, torch.abs(x[:, :T - T % loop_chain_floor.RING]),
            agcs[name]) if T >= 1008 else None
        n = N_CH * T
        # x in and y out, g0 in and g_last out; |x| (a hypot, ~12
        # operations), the product (1 or 2) and the recurrence (7)
        b = bound((16 if cplx else 8) * n + 8 * N_CH,
                  ((12 + 2) if cplx else 2) * n + 7 * n)
        r = row(f"{cuda_agc.OP_FUSED}/{name}", src, where, 0.0,
                ms[cuda_agc.OP_FUSED], plain_ms, b, None, run,
                cuda_agc.fused_key(x))
        r["stage_before_ms"] = ms["stage_before"]
        r["chain_floor_ms"] = floor
        print(f"  {r['name']}: in turns with the stage before "
              f"{json.dumps(seq)}; chain floor "
              f"{'n/a' if floor is None else f'{floor:.4f} ms'}", flush=True)
        rows.append(r)
        if name != "am":
            # agc2_gain_f32 alone at the same shape: no path launches it
            m = torch.abs(x).float()
            gargs = (m, g0, *params(name))
            ms_old = cuda_ms(lambda: cuda_agc.agc2_gain(*gargs))
            rows.append(row(
                f"{cuda_agc.OP}/{name}", src, where, 0.0, ms_old,
                cuda_ms(lambda: cuda_agc.agc2_gain_plain(*gargs), iters=1,
                        warmup=0), bound(8 * n + 8 * N_CH, 7 * n), None, run,
                cuda_agc.shape_key(m), routed=False))
        del x
    torch.cuda.empty_cache()
    return rows


RESAMPLE_SOURCE = {
    "resample_poly_f32": "qradiolink_tpu_torch/csrc/resample_poly.cu",
    "resample_up_f32": "qradiolink_tpu_torch/csrc/resample_up.cu",
    "resample_x2_f32": "qradiolink_tpu_torch/csrc/resample_x2.cu",
    "resample_rat_f32": "qradiolink_tpu_torch/csrc/resample_rat.cu",
    "resample_dec_f32": "qradiolink_tpu_torch/csrc/resample_dec.cu"}
# what each resampler kernel replaces: the per-phase strided FIR
# (banded_fir_stream, which the JAX package runs once a phase at the
# decimating shapes) for resample_dec_f32, banded_fir for the others
RESAMPLE_REPLACES = {"resample_dec_f32":
                     "qradiolink_tpu/ops/pallas_fir.py:218"}


def poly_row(name, rs, planes, C, T, run, dev, gen, on_path=True):
    """A resampler's shape (C rows x T input samples, `planes` planes, the
    tails read in place): the kernel that the route gives it at C rows
    against the plain version (outputs within 1e-5, the new state equal).
    Where the route gives it resample_up_f32, resample_x2_f32,
    resample_rat_f32 or resample_dec_f32, resample_poly_f32, which served
    it before, is held against the plain version too; where the route
    gives a call of few rows resample_poly_f32, the kernel it gives many
    rows takes that place. The two are run over two chained blocks (the
    second from the routed kernel's new state) and timed in turns (old,
    new, new, old); their outputs and states must be equal bit for bit,
    except resample_dec_f32's outputs, which sum in another order and are
    held within the FIR's bound of the plain version on both blocks
    (outside its taps-in-order instances, cuda_resample.DEC_IN_ORDER,
    whose bits are resample_poly_f32's). The
    row of the kernel the route does not pick has no path. One F.conv1d
    with L output channels is the library call, beside each; an empty
    kernel's launch floor too at resample_rat_f32's and resample_dec_f32's
    shapes and at the few-row calls. on_path false: a shape no chain runs
    on `run` (every row with no path)."""
    from qradiolink_tpu_torch.ops import cuda_resample
    import torch.nn.functional as F

    L, M, K, taps = rs.L, rs.M, rs.kp, rs.poly_taps
    xs = tuple(torch.randn((C, T), generator=gen, device=dev)
               for _ in range(planes))
    st = torch.randn((C, 2, K - 1), generator=gen, device=dev)
    tails = (st[:, 0, :], st[:, 1, :])[:planes]
    op = cuda_resample.route(L, M, K, C)
    many = cuda_resample.route(L, M, K)
    old = cuda_resample.OP if op != cuda_resample.OP else many
    kinds = (op,) if old == op else (op, old)
    fns = {k: (lambda k=k: cuda_resample.launch(k, xs, taps, L, M, tails))
           for k in kinds[::-1]}
    p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M, tails)
    outs = {k: fn() for k, fn in fns.items()}
    errs = {}
    for k, (state, ys) in outs.items():
        errs[k] = check_fir(f"{k}/{name}", ys, p_ys)
        if not torch.equal(state, p_state):
            raise RuntimeError(f"{k}/{name}: state differs")
    if len(kinds) == 2:
        # a second block from the routed kernel's new state, fresh input
        st2 = outs[op][0]
        xs2 = tuple(torch.randn((C, T), generator=gen, device=dev)
                    for _ in range(planes))
        tails2 = (st2[:, 0, :], st2[:, 1, :])[:planes]
        chained = {k: cuda_resample.launch(k, xs2, taps, L, M, tails2)
                   for k in kinds}
        exact = cuda_resample.DEC_OP not in kinds or (
            (L, M, K) in cuda_resample.DEC_IN_ORDER)
        if not exact:
            w2, p2 = cuda_resample.resample_poly_plain(xs2, taps, L, M,
                                                       tails2)
            for k, (s2, y2) in chained.items():
                errs[k] = max(errs[k], check_fir(f"{k}/{name} block 1", y2,
                                                 p2))
                if not torch.equal(s2, w2):
                    raise RuntimeError(f"{k}/{name} block 1: state differs")
            del w2, p2
        for blk, o in enumerate((outs, chained)):
            (s0, y0), (s1, y1) = o[old], o[op]
            if not (torch.equal(s0, s1) and (not exact or all(
                    torch.equal(a, b) for a, b in zip(y0, y1)))):
                raise RuntimeError(f"{op}/{name} block {blk}: not "
                                   f"{'bit-' if exact else 'state-'}equal "
                                   f"to {old}")
        print(f"  {op}/{name}: " + (
            f"outputs and state bit-equal to {old}" if exact else
            f"within the FIR's bound, state equal to {old}'s")
            + " over two chained blocks", flush=True)
        del chained, xs2, tails2, st2
    del outs
    offs = cuda_resample.phase_offsets(L, M)
    w = torch.zeros((L, 1, K + offs[-1]), device=dev)
    for r, q in enumerate(offs):
        w[r, 0, q:q + K] = taps[r]
    lib_in = torch.stack([torch.cat([t, x], -1) for t, x in zip(tails, xs)]
                         ).reshape(planes * C, 1, -1)
    lib = F.conv1d(lib_in, w, stride=M).transpose(1, 2).reshape(
        planes, C, -1)
    check_fir(f"F.conv1d with L output channels/{name}", lib.unbind(0),
              p_ys)
    del lib, p_ys
    torch.cuda.synchronize()
    ms, turns = turns_ms(fns)
    if len(kinds) > 1:
        print(f"  {name} in turns: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in turns), flush=True)
    plain_ms = cuda_ms(lambda: cuda_resample.resample_poly_plain(
        xs, taps, L, M, tails), iters=3, warmup=1)
    lib_ms = cuda_ms(lambda: F.conv1d(lib_in, w, stride=M))
    n_out = T // M * L
    b = bound(4 * (planes * C * (K - 1 + T) + L * K + planes * C * n_out
                   + 2 * C * (K - 1)), 2 * K * planes * C * n_out)
    versus = "".join(f"{ms[k] / ms[op]:.2f}x {k} in turns, "
                     for k in kinds[1:])
    floor = ""
    if op in (cuda_resample.RAT_OP, cuda_resample.DEC_OP) or (
            op == cuda_resample.OP and old != op):
        floor_ms = launch_floor(dev)
        floor = f", launch floor {floor_ms:.4f} ms"
    print(f"  {op}/{name}: {versus}{lib_ms / ms[op]:.2f}x F.conv1d, "
          f"{b[0] / ms[op]:.1%} of its bound{floor} ({CARD})", flush=True)
    shape = cuda_resample.shape_key(xs, L, K, M)
    rows = [row(f"{k}/{name}", RESAMPLE_SOURCE[k], RESAMPLE_REPLACES.get(
                k, "qradiolink_tpu/ops/pallas_fir.py:111"), errs[k], ms[k],
                plain_ms, b, lib_ms, run, shape, routed=on_path and k == op)
            for k in kinds]
    if floor:
        rows[0]["launch_floor_ms"] = floor_ms
    return rows


def analog_rows(dev, gen):
    """The new shapes' kernels against their plain versions: the SSB and
    WBFM paths' FIRs, the TX interpolators, agc2_gain_f32."""
    from qradiolink_tpu_torch.chains.ssb import SsbDemod
    from qradiolink_tpu_torch.chains.wbfm import WbfmDemod

    ssb = SsbDemod(usb=True, lead_shape=(N_CH,), device=dev)
    wb = WbfmDemod(lead_shape=(N_CH,), device=dev)
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    k1 = "qradiolink_tpu/ops/pallas_fir.py:218"
    for name, rs, T, run in (("ssb_head", ssb.resamp, T_STEP, "ssb"),
                             ("wbfm_head", wb.resamp, T_STEP, "wbfm")):
        st = randn(N_CH, 2, rs.kp - 1)
        rows += fir_row(name, k1, (randn(N_CH, T), randn(N_CH, T)),
                        rs.phase_taps[0], rs.M, T // rs.M,
                        (st[:, 0, :], st[:, 1, :]), run)
    # the WBFM audio resampler on real input, its tail read in place from
    # the (C, 2, K-1) state as RationalResampler reads it
    ar = wb.audio_resamp
    n_in = T_STEP // wb.resamp.M
    st = randn(N_CH, 2, ar.kp - 1)
    rows += fir_row("wbfm_audio_resamp",
                    "qradiolink_tpu/ops/pallas_fir.py:111",
                    (randn(N_CH, n_in),), ar.phase_taps[0], ar.M,
                    n_in // ar.M, (st[:, 0, :],), "wbfm")
    rows += complex_fir_row("ssb_chan_bp", k1, ssb.chan_filter, N_CH,
                            AUDIO_PER_STEP, "ssb", dev, gen,
                            routed=ssb.chan_filter.form(False) == "conv")
    # AmMod's post filter: 963 complex taps over its 200,000 IQ samples a
    # step in direct form; ops/fir.auto_impl gives it the FFT form, so no
    # path launches the direct kernels at this shape (fft_route_phase times
    # the two forms in turns)
    am_pf = am_modulator(dev).post_filter
    rows += complex_fir_row("am_post_filter", k1, am_pf, N_CH, T_STEP,
                            "am_tx", dev, gen,
                            routed=am_pf.form(True) == "conv")
    af = ssb.audio_filter
    st = randn(N_CH, 2, af.ntaps - 1)
    rows += fir_row("ssb_audio_bp", "qradiolink_tpu/ops/pallas_fir.py:111",
                    (randn(N_CH, AUDIO_PER_STEP),), af.taps_flipped, 1,
                    AUDIO_PER_STEP, (st[:, 0, :],), "ssb")
    rows += agc_rows(dev, gen)
    ssbm, nbm = tx_modulators(dev)
    rows += poly_row("ssb_tx_up", ssbm.up, 2, N_CH, AUDIO_PER_STEP, "tx",
                     dev, gen)
    rows += poly_row("am_tx_up", am_modulator(dev).up, 1, N_CH,
                     AUDIO_PER_STEP, "am_tx", dev, gen)
    rows += poly_row("nbfm_tx_up1", nbm.up1, 1, N_CH, AUDIO_PER_STEP, "tx",
                     dev, gen)
    rows += poly_row("nbfm_tx_up2", nbm.up2, 2, N_CH,
                     AUDIO_PER_STEP * 25 // 4, "tx", dev, gen)
    return rows


def card_vs_cpu_phase(dev, gen, n_ch=4, T=25_000):
    """SsbDemod, AmDemod and WbfmDemod at n_ch channels x 2 blocks of T
    IqPair samples (0.1 RMS a plane), on the card and on the port's own CPU
    path: audio and every state leaf within 1e-5 of the CPU's peak (the
    FIRs' bound), rssi within 1e-4 dB."""
    from qradiolink_tpu_torch.chains.am import AmDemod
    from qradiolink_tpu_torch.chains.ssb import SsbDemod
    from qradiolink_tpu_torch.chains.wbfm import WbfmDemod
    from qradiolink_tpu_torch.core import IqPair, _flatten

    def close(name, got, want):
        return peak_err(name, (got.cpu(),), (want,), 1e-5)

    cpu = torch.device("cpu")
    for cls in (SsbDemod, AmDemod, WbfmDemod):
        chains = {d.type: cls(lead_shape=(n_ch,), device=d)
                  for d in (dev, cpu)}
        states = {k: c.init_state() for k, c in chains.items()}
        errs = {"audio": 0.0, "rssi": 0.0, "state": 0.0}
        for blk in range(2):
            re, im = (torch.randn((n_ch, T), generator=gen, device=dev) * 0.1
                      for _ in range(2))
            outs = {}
            for d in (dev, cpu):
                states[d.type], outs[d.type] = chains[d.type](
                    states[d.type], IqPair(re.to(d), im.to(d)))
            g, c = outs[dev.type], outs["cpu"]
            what = f"{cls.__name__} block {blk}"
            errs["audio"] = max(errs["audio"], close(
                f"{what} audio", g["audio"], c["audio"]))
            r_err = float((g["rssi"].cpu() - c["rssi"]).abs().max())
            if not r_err <= 1e-4:
                raise RuntimeError(f"{what} rssi differs by {r_err} dB")
            errs["rssi"] = max(errs["rssi"], r_err)
            for i, (a, b) in enumerate(zip(_flatten(states[dev.type], []),
                                           _flatten(states["cpu"], []))):
                errs["state"] = max(errs["state"], close(
                    f"{what} state leaf {i}", a, b))
        print(f"  {cls.__name__} {n_ch} ch x 2 blocks of {T}: card vs CPU "
              f"audio max |diff| {errs['audio']:.3e}, rssi "
              f"{errs['rssi']:.3e} dB, state {errs['state']:.3e}",
              flush=True)


def ssb_capture_phase(dev):
    """The frozen SSB capture (scripts/make_ssb_capture.py) in two blocks of
    100,000 samples through SsbDemod(usb=True) on the card and on the
    port's CPU path: the head on resample_dec_f32 at L 1 once a block
    (counters zeroed before, read after; fir_long_f32 and fir_stream_f32
    never), audio and every state leaf within 1e-5 of the CPU's peak, rssi
    within 1e-4 dB."""
    from qradiolink_tpu_torch.chains.ssb import SsbDemod
    from qradiolink_tpu_torch.core import IqPair, _flatten
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    data = np.load(SSB_FIXTURE)
    re = data["iq_re"].astype(np.float32)[None, :]
    im = data["iq_im"].astype(np.float32)[None, :]
    half = re.shape[1] // 2
    cpu = torch.device("cpu")
    chains = {d.type: SsbDemod(usb=True, lead_shape=(1,), device=d)
              for d in (dev, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    errs = {"audio": 0.0, "rssi": 0.0, "state": 0.0}
    kernel_paths.reset()
    for blk, sl in enumerate((slice(0, half), slice(half, 2 * half))):
        outs = {}
        for d in (dev, cpu):
            iq = IqPair(torch.from_numpy(re[:, sl].copy()).to(d),
                        torch.from_numpy(im[:, sl].copy()).to(d))
            states[d.type], outs[d.type] = chains[d.type](states[d.type], iq)
        g, c = outs[dev.type], outs["cpu"]
        what = f"ssb capture block {blk}"
        errs["audio"] = max(errs["audio"], peak_err(
            f"{what} audio", (g["audio"].cpu(),), (c["audio"],), 1e-5))
        r_err = float((g["rssi"].cpu() - c["rssi"]).abs().max())
        if not r_err <= 1e-4:
            raise RuntimeError(f"{what} rssi differs by {r_err} dB")
        errs["rssi"] = max(errs["rssi"], r_err)
        for i, (a, b) in enumerate(zip(_flatten(states[dev.type], []),
                                       _flatten(states["cpu"], []))):
            errs["state"] = max(errs["state"], peak_err(
                f"{what} state leaf {i}", (a.cpu(),), (b,), 1e-5))
    rep = kernel_paths.report()
    key = f"cuda K{chains['cpu'].resamp.kp} D125 tail 2x1"
    head = "resample_dec_f32"
    n = rep.get(head, {}).get("shapes", {}).get(key, 0)
    if n != 2 or any(rep.get(k, {}).get("cuda", 0)
                     for k in ("fir_stream_f32", "fir_long_f32")):
        raise RuntimeError(f"ssb capture: the head did not run on "
                           f"{head} once a block: {json.dumps(rep)}")
    print(f"  {SSB_FIXTURE.name}: 2 blocks of {half}, head on {head} "
          f"({n} launches); card vs CPU audio max |diff| "
          f"{errs['audio']:.3e}, rssi {errs['rssi']:.3e} dB, state "
          f"{errs['state']:.3e}", flush=True)


def tone_snr(audio, freq, rate=8000):
    """Power at the tone's bin against the rest, DC excluded (a copy of
    tests/test_chains_analog.tone_snr)."""
    a = audio - np.mean(audio)
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    freqs = np.fft.rfftfreq(len(a), 1 / rate)
    tone_band = (freqs > freq - 50) & (freqs < freq + 50)
    noise_band = (freqs > 100) & ~tone_band
    return 10 * np.log10(spec[tone_band].sum()
                         / (spec[noise_band].sum() + 1e-12))


def loopback_phase(dev, n_ch=8, n_audio=4000):
    """TX -> ChannelModel at 30 dB -> RX on the card, torch only, at n_ch
    channels of a 0.5-amplitude tone (0.5 s): the JAX tests' tone-SNR
    thresholds (tests/test_chains_analog.py) on every channel."""
    from qradiolink_tpu_torch.chains.am import AmDemod, AmMod
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod, NbfmMod
    from qradiolink_tpu_torch.chains.ssb import SsbDemod, SsbMod
    from qradiolink_tpu_torch.chains.wbfm import WbfmDemod
    from qradiolink_tpu_torch.ops.analog import FrequencyMod
    from qradiolink_tpu_torch.ops.resample import RationalResampler

    ls = (n_ch,)

    def tone(freq):
        t = torch.arange(n_audio, device=dev, dtype=torch.float64) / 8000
        return (0.5 * torch.sin(2 * np.pi * freq * t)).float().expand(
            n_ch, n_audio).contiguous()

    def wide_fm(freq):
        up = RationalResampler(125, 1, lead_shape=ls, device=dev)
        _, a = up(up.init_state(), tone(freq))
        fm = FrequencyMod(2 * np.pi * 75_000.0 / 1e6, lead_shape=ls,
                          device=dev)
        return fm(fm.init_state(), a)[1]

    cases = [  # name, TX (or None: IQ made directly), RX, tone, skip, test
        ("NBFM", NbfmMod, NbfmDemod, 800.0, 1000, "> 15"),
        ("AM", AmMod, AmDemod, 700.0, 1500, "> 12"),
        ("USB", lambda **k: SsbMod(usb=True, **k),
         lambda **k: SsbDemod(usb=True, **k), 1000.0, 1500, "> 10"),
        ("LSB", lambda **k: SsbMod(usb=False, **k),
         lambda **k: SsbDemod(usb=False, **k), 1000.0, 1500, "> 10"),
        ("USB into LSB", lambda **k: SsbMod(usb=True, **k),
         lambda **k: SsbDemod(usb=False, **k), 1000.0, 1500, "< 5"),
        ("WBFM", None, WbfmDemod, 800.0, 1500, "> 15")]
    for name, tx, rx, freq, skip, test in cases:
        if tx is None:
            iq = wide_fm(freq)
        else:
            mod = tx(lead_shape=ls, device=dev)
            iq = mod(mod.init_state(), tone(freq))[1]["iq"]
            iq = ChannelModel(1_000_000, snr_db=30.0)(iq)
        demod = rx(lead_shape=ls, device=dev)
        audio = demod(demod.init_state(), iq)[1]["audio"].cpu().numpy()
        snrs = [tone_snr(a[skip:], freq) for a in audio]
        lim = float(test[2:])
        ok = all(s > lim for s in snrs) if test[0] == ">" else all(
            s < lim for s in snrs)
        print(f"  loopback {name}: audio SNR {min(snrs):.2f} - "
              f"{max(snrs):.2f} dB over {n_ch} channels (must be {test})",
              flush=True)
        if not ok:
            raise RuntimeError(f"loopback {name}: SNR {snrs} not {test} dB")


# -- the PSK modems (QPSK250K, BPSK2K) ----------------------------------------

QPSK_FIXTURE = HERE / "tests" / "fixtures" / "iq_qpsk250k_10db.npz"
QPSK_BYTES = 3_125      # a step's payload a channel: 200,000 IQ samples
QPSK_SYMS = T_STEP // 8  # 25,000 symbols a step (500 ksps, sps 4)
QPSK_EVERY_STEP = ("fir_cols_f32", "fll_band_edge_f32", "fir_s1_f32",
                   "agc2_f32", "costas_loop_f32", "symbol_sync_mm_f32",
                   "viterbi_stream_k7")
BPSK_BYTES = 25          # a step's payload a channel at 2,000 symbols/s
BPSK_STEPS = 8           # 1.6 s of signal: 1,600 bits a channel
BPSK_PAIRS = 8 * BPSK_BYTES  # soft pairs a delay-diversity row a step (200)
# the loop kernels' timing shapes: 2048 rows, short blocks for the checks
# against the plain loops (whose every step is a dozen device ops)
LOOP_CHECK_T = 4_000
VITERBI_CHECK_T = 1_000

def qpsk_tx(dev, gen, n_ch, steps, n_bytes=None):
    """QpskMod(125_000) on the card at n_ch channels, `steps` steps of
    n_bytes (QPSK_BYTES) seeded random bytes a channel; returns (the bytes
    of each step, the IQ of each step as complex64, 64 samples a byte)."""
    from qradiolink_tpu_torch.chains.psk import QpskMod

    n_bytes = QPSK_BYTES if n_bytes is None else n_bytes
    mod = QpskMod(125_000, lead_shape=(n_ch,), device=dev)
    st, data, iq = mod.init_state(), [], []
    for _ in range(steps):
        d = torch.randint(0, 256, (n_ch, n_bytes), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.uint8)
        st, out = mod(st, d)
        data.append(d)
        iq.append(out["iq"])
    return data, iq


def loop_signal(dev, gen, C, T):
    """A QPSK250K signal from QpskMod, 1 kHz off, noise at 0.05 a plane,
    the first 200 samples at ~1e-20 (the denormal trap): (C, T) complex64."""
    _, iq = qpsk_tx(dev, gen, C, 1, -(-T // 64) + 1)
    t = torch.arange(T, device=dev, dtype=torch.float64)
    x = iq[0][:, :T] * torch.exp(1j * (2 * np.pi * 1e-3 * t)).to(
        torch.complex64)
    x = x + 0.05 * torch.randn((C, T), generator=gen, device=dev,
                               dtype=torch.complex64)
    x[:, :200] *= 1e-20
    return x.contiguous()


def max_diff(a, b):
    """max |a - b| of two tensors of one shape, complex ones plane by
    plane, integers widened first."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def equal_leaves(name, got, want):
    """Every output and state leaf of got equal bit for bit to want's;
    raises on the first that is not. Returns their max |diff| (0.0)."""
    err = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        d = max_diff(a, b)
        err = max(err, d)
        if not torch.equal(a, b):
            raise RuntimeError(f"{name}: output {j} not equal bit for bit "
                               f"to the plain loop (max |diff| {d:.3e})")
    return err


def chained_equal(name, launch, plain, blocks, state, carry):
    """Two chained blocks: launch(block, state) and plain(block, state),
    each returning (outputs..., ) with carry(outputs) the next state; every
    output must be equal bit for bit. Returns the last arguments."""
    for i, blk in enumerate(blocks):
        got = launch(blk, state)
        equal_leaves(f"{name} block {i}", got, plain(blk, state))
        state = carry(got)
    print(f"  {name}: 2 chained blocks of {tuple(blocks[0].shape)} equal bit "
          f"for bit to the plain loop (outputs and state)", flush=True)
    return state


def loop_row(name, source, replaces, fn, plain_fn, n_bytes, n_ops, run,
             shape):
    """A loop kernel's row at the path's full shape: the kernel's time,
    then one more call of it and the plain loop's one call (timed) on the
    same inputs, every output and state leaf equal bit for bit; the row's
    max_abs_err is their measured max |diff|, its bound bytes or
    operations."""
    ms = cuda_ms(fn, iters=5, warmup=1)
    got = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = plain_fn()
    end.record()
    end.synchronize()
    err = equal_leaves(f"{name} at {shape}", got, want)
    print(f"  {name}: outputs and state at {shape} equal bit for bit to the "
          f"plain loop", flush=True)
    return row(name, source, replaces, err, ms, start.elapsed_time(end),
               bound(n_bytes, n_ops), None, run, shape)


# symbol_sync_mm_f32's cycles a symbol are taken at the SM clock that
# scripts/loop_chain_floor.py samples under it on the H100 (1,980 MHz); the
# conj mode's (its QPSK250K row) is printed beside the levels rows
SYNC_MHZ = 1980.0
SYNC_CYCLES = {}


def sync_cycles(ms, symbols):
    return ms * 1e-3 * SYNC_MHZ * 1e6 / symbols


def levels_v0_row(name, fn, v0, kernel_row, run, shape, symbols):
    """The levels mode on real input as the hypotf levels code runs it
    (symbol_sync_levels_v0: the imaginary plane copied and interpolated, a
    hypotf a level) on the kernel row's inputs: every output and state leaf
    equal bit for bit to the real-levels path's, the two timed in turns;
    prints both in cycles a symbol beside the conj mode's. Its row has no
    path."""
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css

    equal_leaves(f"{css.V0_OP}/{run} at {shape}", v0(), fn())
    ms, turns = turns_ms({css.V0_OP: v0, css.OP: fn})
    print(f"  {name} in turns: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in turns), flush=True)
    conj = SYNC_CYCLES.get("conj")
    print(f"  {name}: {sync_cycles(ms[css.OP], symbols):.0f} cycles a symbol "
          f"(the hypotf levels code {sync_cycles(ms[css.V0_OP], symbols):.0f}, "
          f"{ms[css.V0_OP] / ms[css.OP]:.2f}x; conj mode "
          f"{'not timed' if conj is None else f'{conj:.0f}'}) at "
          f"{SYNC_MHZ:.0f} MHz, {symbols} symbols a row ({CARD})",
          flush=True)
    return row(f"{css.V0_OP}/{run}", kernel_row["source"],
               kernel_row["replaces"], 0.0, ms[css.V0_OP],
               kernel_row["plain_ms"], (kernel_row["bound_ms"],
                                        kernel_row["bound_by"]),
               None, run, shape, routed=False)


# FllBandEdge's bound against its plain loop, elementwise |k - p| <= atol +
# rtol |p| (tests/test_torch_sync_loops.py): the kernel sums each
# sub-block's band-edge energy in its own order
FLL_ATOL, FLL_RTOL = 2e-5, 1e-5


def fll_diffs(name, got, want, gate):
    """The max |diff| of each leaf of (y, phase, freq, tail), the phase
    as a distance on the circle (mod 2 pi may wrap apart); with gate, every
    element within FLL_ATOL + FLL_RTOL |plain| (raises otherwise). Every
    leaf must be finite."""
    diffs = {}
    for leaf, a, b in zip(("y", "phase", "freq", "tail"), got, want,
                          strict=True):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        a, b = a.double(), b.double()
        d = (a - b).abs()
        if leaf == "phase":
            d = torch.minimum(d, 2 * np.pi - d)
        diffs[leaf] = float(d.max())
        if not bool(torch.isfinite(a).all()):
            raise RuntimeError(f"{name}: {leaf} not finite")
        if gate and not bool((d <= FLL_ATOL + FLL_RTOL * b.abs()).all()):
            raise RuntimeError(f"{name}: {leaf} off the plain loop by "
                               f"{diffs[leaf]:.3e}")
    return diffs


def fll_rows(q_fll, dev, gen):
    """fll_band_edge_f32: QpskDemod's FLL (q_fll) and BpskDemod's against
    the plain loop over two chained blocks of 2048 x LOOP_CHECK_T of a QPSK
    signal 1 kHz off (its first samples ~1e-20), one launch a block and no
    other kernel: each block within the FLL's bound of the plain loop run
    from the kernel's state, and of the plain loop chained from its own
    state; then each at its path's full shape (QPSK250K 2048 x 100,000,
    200 sub-blocks; BPSK2K 2048 x 4,000) timed, and held within the FLL's
    bound of one timed call of the plain loop over the whole chain, the
    max |diff| of each leaf printed. No single PyTorch call computes the
    loop."""
    from qradiolink_tpu_torch.chains.psk import BpskDemod
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.sync import cuda_fll as cf
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    b_fll = BpskDemod(lead_shape=(N_CH,), device=dev).fll
    x = loop_signal(dev, gen, N_CH, 2 * LOOP_CHECK_T)
    for name, fll in (("qpsk", q_fll), ("bpsk", b_fll)):
        st = st_p = fll.init_state()
        sb = fll.sub_block_len(LOOP_CHECK_T)
        worst = {}
        for i in range(2):
            xb = x[:, i * LOOP_CHECK_T:(i + 1) * LOOP_CHECK_T]
            pair = IqPair(xb.real.contiguous(), xb.imag.contiguous())
            kernel_paths.reset()
            st_k, y = fll(st, pair)
            rep = kernel_paths.report()
            if rep != {cf.OP: {"cuda": 1, "plain": 0, "shapes": {
                    f"cuda {cf.shape_key(pair.re, sb)}": 1}}}:
                raise RuntimeError(f"{cf.OP} {name}: {json.dumps(rep)}")
            for tag, s0 in (("from the kernel's state", st),
                            ("chained on its own", st_p)):
                want = cf.fll_plain(pair.re, pair.im, *s0, fll.taps,
                                    fll.beta, fll.max_freq, sb)
                d = fll_diffs(f"{cf.OP} {name} block {i}, plain loop {tag}",
                              (y, *st_k), want, gate=True)
                worst = {k: max(v, worst.get(k, 0.0)) for k, v in d.items()}
            st, st_p = st_k, want[1:]
        print(f"  {cf.OP}/{name}: 2 chained blocks of {N_CH} x "
              f"{LOOP_CHECK_T} within {FLL_ATOL} + {FLL_RTOL} |plain| of "
              f"the plain loop (from the kernel's state and chained on its "
              f"own), max |diff| {json.dumps(worst)}", flush=True)
    del x
    rows = []
    for name, fll, T, run in (("qpsk", q_fll, T_STEP // 2, "qpsk"),
                              ("bpsk", b_fll, T_STEP // 50, "bpsk")):
        x = loop_signal(dev, gen, N_CH, T)
        xr, xi = x.real.contiguous(), x.imag.contiguous()
        del x
        st = fll.init_state()
        sb = fll.sub_block_len(T)

        def fn():
            return cf.fll_band_edge(xr, xi, *st, fll.taps, fll.beta,
                                    fll.max_freq, sb)

        ms = cuda_ms(fn, iters=5, warmup=1)
        got = fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = cf.fll_plain(xr, xi, *st, fll.taps, fll.beta, fll.max_freq,
                            sb)
        end.record()
        end.synchronize()
        d = fll_diffs(f"{cf.OP} {name} at full shape", got, want,
                      gate=True)
        print(f"  {cf.OP}/{name}: {N_CH} x {T}, {T // sb} sub-blocks of "
              f"{sb}: within {FLL_ATOL} + {FLL_RTOL} |plain| of one call of "
              f"the plain loop, max |diff| {json.dumps(d)}", flush=True)
        K = fll.ntaps
        # two planes in, complex64 out; 2 filters x 4 real FIRs x K FMAs
        # an output
        b = bound(8 * N_CH * T * 2 + 16 * K + 16 * N_CH * K,
                  2 * 2 * 4 * K * N_CH * T)
        rows.append(row(f"{cf.OP}/{name}_fll",
                        "qradiolink_tpu_torch/csrc/fll_band_edge.cu",
                        "qradiolink_tpu/sync/fll.py:93", max(d.values()), ms,
                        start.elapsed_time(end), b, None, run,
                        cf.shape_key(xr, sb)))
        print(f"  {cf.OP}/{name}: {b[0] / ms:.1%} of its bound", flush=True)
        del xr, xi, got, want
        torch.cuda.empty_cache()
    return rows


def stress_ramps(C, n, dev):
    """The symbol sync's stress input (tests/test_torch_cuda.stress_ramps):
    complex rows that ramp up (even rows) and down (odd rows) at slope 1 on
    both planes. To the M&M TED every symbol is late (up) or early (down),
    so |e| sits at its clip and omega at omax or omin: each symbol advances
    the position by omax + gain_mu or omin - gain_mu, the extremes the
    kernel's ring plan serves."""
    t = torch.arange(n, device=dev, dtype=torch.float32)
    v = torch.stack([t + 1, n - t]).repeat(C // 2, 1)
    return torch.complex(v, v).contiguous()


def sync_stress(dev):
    """symbol_sync_mm_f32 on the stress ramps over two chained blocks of
    2048 x LOOP_CHECK_T, QPSK250K's loop with gain_omega 1e-4 (omega at its
    limit within the first block): every output and state leaf equal bit
    for bit to the plain loop from the kernel's state, one launch a block,
    and omega at omax on the rows that ramp up, omin on those that ramp
    down, after each block."""
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css
    from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    ss = SymbolSync(4, gain_mu=0.02, gain_omega=1e-4, omega_limit=0.0016,
                    lead_shape=(N_CH,), device=dev)
    x = stress_ramps(N_CH, 2 * LOOP_CHECK_T, dev)
    omax = float(np.float32(ss.sps + ss.omega_limit))
    omin = float(np.float32(ss.sps - ss.omega_limit))
    st = ss.init_state()
    for i in range(2):
        xb = x[:, i * LOOP_CHECK_T:(i + 1) * LOOP_CHECK_T].contiguous()
        pos, om, yp, dp, tail = st
        args = (pos, om, yp, dp, LOOP_CHECK_T // 4, css.MODE_CONJ, None,
                ss.sps, ss.alpha, ss.beta, ss.omega_limit, ss.ted_norm)
        kernel_paths.reset()
        got = css.symbol_sync(tail, xb, *args)
        if kernel_paths.launches(css.OP) != 1:
            raise RuntimeError(f"{css.OP} stress: not one launch")
        xc = torch.cat([tail, xb], dim=-1)
        r = css.symbol_sync_plain(xc.real.contiguous(), xc.imag.contiguous(),
                                  *args)
        equal_leaves(f"{css.OP} stress block {i}", got,
                     (torch.complex(r[0], r[1]),) + r[2:])
        if not (bool((got[2][0::2] == omax).all())
                and bool((got[2][1::2] == omin).all())):
            raise RuntimeError(f"{css.OP} stress block {i}: omega off its "
                               f"limits")
        st, _ = ss(st, xb)
    print(f"  {css.OP} stress: 2 chained blocks of {N_CH} x {LOOP_CHECK_T} "
          f"ramps, omega at {omax} / {omin}, equal bit for bit to the "
          f"plain loop (outputs and state)", flush=True)


def psk_rows(dev, gen):
    """The PSK paths' kernels: the three loop kernels bit-equal to their
    plain loops over two chained blocks at 2048 rows (a real QPSK signal,
    its first samples ~1e-20), then timed at QPSK250K's full shapes and
    held bit-equal there once more against the plain loop's one call; the
    head's K83 D2 and QPSK20K/2K's K1045 D25 on fir_cols_f32 (in turns with
    fir_stream_f32), the RRC K45 and the FLL's complex K32 band-edge
    filter (off the path) on fir_s1_f32, against their plain versions and
    F.conv1d; fll_band_edge_f32 (fll_rows)."""
    from qradiolink_tpu_torch.chains.psk import QpskDemod
    from qradiolink_tpu_torch.fec import viterbi_stream_cuda as vsc
    from qradiolink_tpu_torch.fec.conv import CCSDS_K7
    from qradiolink_tpu_torch.sync import cuda_costas as cc
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css

    q = QpskDemod(125_000, 500_000, lead_shape=(N_CH,), device=dev)
    rows = []
    x = loop_signal(dev, gen, N_CH, 2 * LOOP_CHECK_T)
    blocks = [x[:, :LOOP_CHECK_T].contiguous(),
              x[:, LOOP_CHECK_T:].contiguous()]
    for order, loop in ((4, q.costas_pll), (2, q.costas)):
        a = (order, loop.alpha, loop.beta, loop.max_freq)
        zero = torch.zeros(N_CH, device=dev)
        chained_equal(
            f"{cc.OP} order {order}",
            lambda b, s: cc.costas_loop(b, *s, *a),
            lambda b, s: (lambda r: (torch.complex(r[0], r[1]), r[2],
                                     r[3]))(cc.costas_loop_plain(
                                         b.real, b.imag, *s, *a)),
            blocks, (zero, zero.clone()), lambda g: g[1:])
    ss = q.symbol_sync
    mode = css.MODE_CONJ
    n_sym = LOOP_CHECK_T // 4

    def sync_args(s, n=n_sym):
        pos, om, yp, dp, _ = s
        return (pos, om, yp, dp, n, mode, None, ss.sps, ss.alpha, ss.beta,
                ss.omega_limit, ss.ted_norm)

    def sync_plain(b, s, n=n_sym):
        xc = torch.cat([s[4], b], dim=-1)
        r = css.symbol_sync_plain(xc.real.contiguous(),
                                  xc.imag.contiguous(), *sync_args(s, n))
        return (torch.complex(r[0], r[1]),) + r[2:]

    chained_equal(
        css.OP, lambda b, s: css.symbol_sync(s[4], b, *sync_args(s)),
        sync_plain, blocks, ss.init_state(),
        lambda g: (torch.clamp(g[1] - LOOP_CHECK_T, 0.0, ss.tail_len - 2.0),
                   *g[2:], blocks[0][:, -ss.tail_len:]))
    sync_stress(dev)
    soft = torch.clamp(128.0 + 48.0 * torch.view_as_real(
        loop_signal(dev, gen, N_CH, 2 * VITERBI_CHECK_T)) * 4.0, 0.0, 255.0)
    vblocks = [soft[:, :VITERBI_CHECK_T].contiguous(),
               soft[:, VITERBI_CHECK_T:].contiguous()]
    lag = q.fec_tail.viterbi.lag
    chained_equal(
        vsc.OP, lambda b, s: vsc.viterbi_stream(CCSDS_K7, s[0], s[1], b),
        lambda b, s: vsc.viterbi_stream_plain(CCSDS_K7, s[0], s[1], b),
        vblocks, (torch.zeros((N_CH, 64), device=dev),
                  torch.full((N_CH, lag, 2), 128.0, device=dev)),
        lambda g: (g[0], vblocks[0][:, -lag:].contiguous()))
    del x, blocks, soft, vblocks
    torch.cuda.empty_cache()

    # the full shapes of a QPSK250K step
    T_in = T_STEP // q.resamp.M
    x = loop_signal(dev, gen, N_CH, T_in)
    ph = torch.zeros(N_CH, device=dev)
    pll = (4, q.costas_pll.alpha, q.costas_pll.beta, q.costas_pll.max_freq)

    def costas_plain(xc, a):
        yr, yi, p, f = cc.costas_loop_plain(xc.real, xc.imag, ph, ph, *a)
        return torch.complex(yr, yi), p, f

    rows.append(loop_row(
        f"{cc.OP}/qpsk_pll", "qradiolink_tpu_torch/csrc/costas.cu",
        "qradiolink_tpu/sync/costas.py:64",
        lambda: cc.costas_loop(x, ph, ph, *pll),
        lambda: costas_plain(x, pll),
        2 * 8 * N_CH * T_in + 16 * N_CH, 60 * N_CH * T_in, "qpsk",
        cc.shape_key(x, 4)))
    xs = x[:, :QPSK_SYMS].contiguous()
    sym = (4, q.costas.alpha, q.costas.beta, q.costas.max_freq)
    rows.append(loop_row(
        f"{cc.OP}/qpsk_symbols", "qradiolink_tpu_torch/csrc/costas.cu",
        "qradiolink_tpu/sync/costas.py:64",
        lambda: cc.costas_loop(xs, ph, ph, *sym),
        lambda: costas_plain(xs, sym),
        2 * 8 * N_CH * QPSK_SYMS + 16 * N_CH, 60 * N_CH * QPSK_SYMS, "qpsk",
        cc.shape_key(xs, 4)))
    s0 = ss.init_state()
    rows.append(loop_row(
        f"{css.OP}/qpsk", "qradiolink_tpu_torch/csrc/symbol_sync.cu",
        "qradiolink_tpu/sync/symbol_sync.py:152",
        lambda: css.symbol_sync(s0[4], x, *sync_args(s0, QPSK_SYMS)),
        lambda: sync_plain(x, s0, QPSK_SYMS),
        8 * N_CH * (T_in + QPSK_SYMS), 60 * N_CH * QPSK_SYMS, "qpsk",
        css.shape_key(N_CH, T_in, QPSK_SYMS, mode)))
    SYNC_CYCLES["conj"] = sync_cycles(rows[-1]["ms"], QPSK_SYMS)
    print(f"  {css.OP}/qpsk: {SYNC_CYCLES['conj']:.0f} cycles a symbol at "
          f"{SYNC_MHZ:.0f} MHz", flush=True)
    del x, xs
    soft = torch.clamp(128.0 + 48.0 * torch.randn(
        (N_CH, QPSK_SYMS, 2), generator=gen, device=dev) * 2.0, 0.0, 255.0)
    pm0 = torch.zeros((N_CH, 64), device=dev)
    tail = torch.full((N_CH, lag, 2), 128.0, device=dev)
    S = QPSK_SYMS + lag
    v_bound = (N_CH * (8 * S + 2 * 8 * S + QPSK_SYMS + 2 * 4 * 64),
               10 * 64 * N_CH * S)
    rows.append(loop_row(
        f"{vsc.OP}/qpsk", "qradiolink_tpu_torch/csrc/viterbi_stream.cu",
        "qradiolink_tpu/fec/conv.py:217",
        lambda: vsc.viterbi_stream(CCSDS_K7, pm0, tail, soft),
        lambda: vsc.viterbi_stream_plain(CCSDS_K7, pm0, tail, soft),
        *v_bound, "qpsk", vsc.shape_key(soft, lag)))
    # the one-warp design the CCSDS code had before and the one-warp
    # design with the class minima, in turns with it and bit-equal to it
    # (so to the plain loop); no path launches them
    vfns = {vsc.OP_WARP: lambda: vsc.viterbi_stream_warp(CCSDS_K7, pm0,
                                                         tail, soft),
            vsc.OP_REDUX: lambda: vsc.viterbi_stream_redux(CCSDS_K7, pm0,
                                                           tail, soft),
            vsc.OP: lambda: vsc.viterbi_stream(CCSDS_K7, pm0, tail, soft)}
    want = vfns[vsc.OP]()
    errs = {op: equal_leaves(f"{op}/qpsk", vfns[op](), want)
            for op in (vsc.OP_WARP, vsc.OP_REDUX)}
    vms, vseq = turns_ms(vfns)
    print(f"  {vsc.OP} in turns with {vsc.OP_WARP} and {vsc.OP_REDUX}: "
          f"{json.dumps(vseq)}", flush=True)
    rows[-1]["in_turns_ms"] = vms[vsc.OP]
    plain_ms = rows[-1]["plain_ms"]
    for op, src in ((vsc.OP_WARP, "viterbi_stream_warp.cu"),
                    (vsc.OP_REDUX, "viterbi_stream_redux.cu")):
        rows.append(row(f"{op}/qpsk", f"qradiolink_tpu_torch/csrc/{src}",
                        "qradiolink_tpu/fec/conv.py:217", errs[op], vms[op],
                        plain_ms, bound(*v_bound), None, "qpsk",
                        vsc.shape_key(soft, lag), routed=False))
    del soft, want
    # BPSK2K's shape: the delay-diversity pair, 2 x 2048 rows of 200 pairs
    soft = torch.clamp(128.0 + 48.0 * torch.randn(
        (2 * N_CH, BPSK_PAIRS, 2), generator=gen, device=dev) * 2.0, 0.0,
        255.0)
    pm0 = torch.zeros((2 * N_CH, 64), device=dev)
    tail = torch.full((2 * N_CH, lag, 2), 128.0, device=dev)
    S = BPSK_PAIRS + lag
    rows.append(loop_row(
        f"{vsc.OP}/bpsk", "qradiolink_tpu_torch/csrc/viterbi_stream.cu",
        "qradiolink_tpu/fec/conv.py:217",
        lambda: vsc.viterbi_stream(CCSDS_K7, pm0, tail, soft),
        lambda: vsc.viterbi_stream_plain(CCSDS_K7, pm0, tail, soft),
        2 * N_CH * (8 * S + 2 * 8 * S + BPSK_PAIRS + 2 * 4 * 64),
        10 * 64 * 2 * N_CH * S, "bpsk", vsc.shape_key(soft, lag)))
    del soft
    torch.cuda.empty_cache()

    k1 = "qradiolink_tpu/ops/pallas_fir.py:218"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    rs = q.resamp
    st = randn(N_CH, 2, rs.kp - 1)
    rows += fir_row("qpsk250k_head", k1, (randn(N_CH, T_STEP),
                                          randn(N_CH, T_STEP)),
                    rs.phase_taps[0], rs.M, T_STEP // rs.M,
                    (st[:, 0, :], st[:, 1, :]), "qpsk")
    # the RRC (K45, complex input, 100,000 samples) and the FLL's upper
    # band-edge filter (32 complex taps over a 500-sample sub-block; the
    # lower one has the same shape: 4 launches a sub-block)
    st = randn(N_CH, 2, q.shaping.ntaps - 1)
    rows += fir_row("qpsk_rrc", "qradiolink_tpu/ops/pallas_fir.py:111",
                    (randn(N_CH, T_in), randn(N_CH, T_in)),
                    q.shaping.taps_flipped, 1, T_in,
                    (st[:, 0, :], st[:, 1, :]), "qpsk")
    # the FLL's upper band-edge filter as it ran before fll_band_edge_f32:
    # 32 complex taps over a 500-sample sub-block, 4 launches a sub-block
    # with the lower one; no path launches it there now
    n_sub = T_in // q.fll.sub_block_len(T_in)
    rows += complex_fir_row(
        "qpsk_fll_band_edge", "qradiolink_tpu/ops/pallas_fir.py:111",
        types.SimpleNamespace(ntaps=q.fll.ntaps, tap_planes=(
            q.fll.taps[0], q.fll.taps[1])),
        N_CH, T_in // n_sub, "qpsk", dev, gen, routed=False)
    rows += fll_rows(q.fll, dev, gen)
    rs = QpskDemod(10_000, 40_000, lead_shape=(N_CH,), device=dev).resamp
    st = randn(N_CH, 2, rs.kp - 1)
    rows += fir_row("qpsk20k_head", k1, (randn(N_CH, T_STEP),
                                         randn(N_CH, T_STEP)),
                    rs.phase_taps[0], rs.M, T_STEP // rs.M,
                    (st[:, 0, :], st[:, 1, :]), "qpsk", on_path=False)
    torch.cuda.empty_cache()
    return rows


def best_ber_rows(bits, sent, max_offset):
    """best_ber for every row at once, on the bits' device: the BER of the
    steady-state segment [n/2, 7n/8) at each alignment 0 .. max_offset-1
    that fits, the least of them a row."""
    n = sent.shape[-1]
    lo, hi = n // 2, (7 * n) // 8
    ref = sent[:, lo:hi]
    errs = [(bits[:, o + lo:o + hi] != ref).float().mean(dim=-1)
            for o in range(max_offset) if o + hi <= bits.shape[-1]]
    return torch.stack(errs, dim=-1).min(dim=-1).values


def ber_report(name, bers):
    """Prints the rows' steady-state BERs; returns the worst."""
    worst = float(bers.max())
    print(f"  {name}: steady-state BER worst {worst:.5f}, mean "
          f"{float(bers.mean()):.6f} over {bers.numel()} channels",
          flush=True)
    return worst


def psk_bits(out_steps, key="bits"):
    return torch.cat([o[key] for o in out_steps], dim=-1)


def qpsk_path(dev, gen):
    """QPSK250K, BASELINE configs[3]: QpskMod(125_000) on the card makes
    3,125 seeded random bytes a channel a step for 2048 channels (200,000 IQ
    samples), ChannelModel(1e6) passes them clean (as the JAX test at rate
    does), and QpskDemod(125_000, 500_000) runs 3 steps with state carried,
    the counters zeroed just before: the head on fir_cols_f32, the FLL on
    fll_band_edge_f32, the RRC on fir_s1_f32 (its only shape there),
    agc2_f32, costas_loop_f32 twice, symbol_sync_mm_f32 and
    viterbi_stream_k7, each once a step; fir_stream_f32, agc2_gain_f32 and
    viterbi_stream_warp_k7 never. BER < 0.01 on the steady-state
    segment. Then one more step stage by stage and one under
    torch.profiler; then 3 more steps at SNR 10 dB with a 1 kHz offset,
    their BER printed. The modulator runs before the counters are zeroed;
    its launches are counted in psk_tx_path's run. Returns the report."""
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.chains.psk import QpskDemod
    from qradiolink_tpu_torch.core import IqPair, Sequencer
    from qradiolink_tpu_torch.ops.spectrum import rssi_dbm

    chain = QpskDemod(125_000, 500_000, lead_shape=(N_CH,), device=dev)
    data, tx = qpsk_tx(dev, gen, N_CH, N_STEPS)
    clean = ChannelModel(1_000_000)
    iqs = []
    for i in range(N_STEPS):
        y = clean(tx[i])
        iqs.append(IqPair(y.real.contiguous(), y.imag.contiguous()))
        tx[i] = None
    del tx, y
    torch.cuda.empty_cache()
    state, outs, step_s, report = drive(chain, chain.init_state(), iqs,
                                        QPSK_EVERY_STEP)
    out = outs[-1]
    for key, shape, dt in (("bits", (N_CH, QPSK_SYMS), torch.uint8),
                           ("constellation", (N_CH, QPSK_SYMS),
                            torch.complex64), ("rssi", (N_CH,),
                                               torch.float32)):
        v = out[key]
        fin = torch.isfinite(torch.view_as_real(v) if v.is_complex()
                             else v.float()).all()
        if tuple(v.shape) != shape or v.dtype != dt or not bool(fin):
            raise RuntimeError(f"qpsk {key}: {tuple(v.shape)} {v.dtype} or "
                               f"non-finite")
    fll = chain.fll
    T_in = T_STEP // chain.resamp.M
    n_sub = T_in // fll.sub_block_len(T_in)
    require_shapes(report, {
        ("fir_cols_f32", f"K{chain.resamp.kp} D2 tail 2x{N_CH}"): 1,
        ("fll_band_edge_f32", f"{N_CH}x{T_in} sb{T_in // n_sub}"): 1,
        ("fir_s1_f32", f"K{chain.shaping.ntaps} D1 tail 2x{N_CH}"): 1,
        ("agc2_f32", f"complex {N_CH}x{T_in}"): 1,
        ("costas_loop_f32", f"order4 {N_CH}x{T_in}"): 1,
        ("costas_loop_f32", f"order4 {N_CH}x{QPSK_SYMS}"): 1,
        ("symbol_sync_mm_f32", f"conj {N_CH}x{T_in}->{QPSK_SYMS}"): 1,
        ("viterbi_stream_k7", f"R{N_CH} T{QPSK_SYMS} lag64"): 1},
        N_STEPS, "qpsk",
        never=("fir_stream_f32", "agc2_gain_f32", "viterbi_stream_warp_k7",
               "viterbi_stream_redux_k7"))
    only_shape(report, "fir_s1_f32",
               f"K{chain.shaping.ntaps} D1 tail 2x{N_CH}", "qpsk")
    sent = torch.cat([bytes_to_bits(d) for d in data], dim=-1)
    ber = ber_report("qpsk clean",
                     best_ber_rows(psk_bits(outs), sent, 1000))
    if not ber < 0.01:
        raise RuntimeError(f"qpsk: BER {ber} is not below 0.01")
    med = statistics.median([s * 1e3 for s in step_s[1:]])
    vs = N_CH * T_STEP / med / 1e3 / N_CH
    print(f"  {step_times(step_s, N_CH * T_STEP)}, vs_baseline {vs:.2f} "
          f"Msamples/s per channel (printed, not gated)", flush=True)

    iq = iqs[-1]
    seq = Sequencer(state[:-1])
    stages = {}
    x = timed(stages, "resampler 1/2 (fir_cols_f32 K83 D2)",
              lambda: seq(chain.resamp, iq))
    timed(stages, "rssi", lambda: rssi_dbm(x))
    x = timed(stages, f"FLL (fll_band_edge_f32, {n_sub} sub-blocks)",
              lambda: seq(chain.fll, x))
    x = timed(stages, "RRC (fir_s1_f32 K45)", lambda: seq(chain.shaping, x))
    x = timed(stages, "agc (agc2_f32)", lambda: seq(chain.agc, x))
    x = timed(stages, "Costas PLL (costas_loop_f32, 100,000)",
              lambda: seq(chain.costas_pll, x))
    syms = timed(stages, "symbol sync (symbol_sync_mm_f32)",
                 lambda: seq(chain.symbol_sync, x))
    syms = timed(stages, "Costas (costas_loop_f32, 25,000)",
                 lambda: seq(chain.costas, syms))
    soft = timed(stages, "differential decode + soft",
                 lambda: chain.diff_soft(state[-1], syms)[0])
    timed(stages, "FEC tail (viterbi_stream_k7 + descrambler)",
          lambda: seq(chain.fec_tail, soft))
    print(f"  stage ms (one step, CUDA events): {json.dumps(stages)}",
          flush=True)
    trace_step("one more step", lambda: chain(state, iq))
    del iqs, iq, x, syms, soft, outs
    torch.cuda.empty_cache()

    # SNR 10 dB, 1 kHz offset, no gate
    data, tx = qpsk_tx(dev, gen, N_CH, N_STEPS)
    noisy = ChannelModel(1_000_000, snr_db=10.0, freq_offset_hz=1000.0)
    st, bits = chain.init_state(), []
    for i in range(N_STEPS):
        y = noisy(tx[i])
        tx[i] = None
        st, o = chain(st, IqPair(y.real.contiguous(), y.imag.contiguous()))
        bits.append(o["bits"])
        del y
    sent = torch.cat([bytes_to_bits(d) for d in data], dim=-1)
    ber_report("qpsk at 10 dB, 1 kHz offset (not gated)",
               best_ber_rows(torch.cat(bits, dim=-1), sent, 1000))
    torch.cuda.empty_cache()
    return report


def bpsk_path(dev, gen):
    """BPSK2K at 2048 channels: BpskMod on the card, 25 seeded bytes a
    channel a step (200,000 IQ samples), clean; BpskDemod over BPSK_STEPS
    steps with state carried, each step's IQ made just before it (the
    modulator's launches count too), the counters zeroed before the first:
    the head on fir_decim_f32, the FLL on fll_band_edge_f32, the RRC on
    fir_s1_f32 (its only shape there), agc2_f32, symbol_sync_mm_f32,
    costas_loop_f32 (order 2) and
    viterbi_stream_k7 (the delay-diversity pair, 2 x 2048 rows), each its
    count a step, and the modulator's two interpolators on resample_up_f32
    (their rows come from psk_tx_path's run). The better of bits /
    bits_alt at BER < 0.01. Returns the report."""
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.chains.psk import BpskDemod, BpskMod
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    mod = BpskMod(lead_shape=(N_CH,), device=dev)
    chain = BpskDemod(lead_shape=(N_CH,), device=dev)
    mst, st = mod.init_state(), chain.init_state()
    data, outs, step_s = [], [], []
    kernel_paths.reset()
    for i in range(BPSK_STEPS):
        d = torch.randint(0, 256, (N_CH, BPSK_BYTES), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.uint8)
        mst, tx = mod(mst, d)
        iq = IqPair(tx["iq"].real.contiguous(), tx["iq"].imag.contiguous())
        del tx
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, out = chain(st, iq)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        data.append(d)
        outs.append(out)
    report = kernel_paths.report()
    print(f"  kernel paths over {BPSK_STEPS} steps (modulator included): "
          f"{json.dumps(report)}", flush=True)
    if not kernel_paths.served_only():
        raise RuntimeError("bpsk: a stage took the plain path on the card")
    T_in = T_STEP // chain.resamp.M
    n_sym = T_in // chain.sps
    n_sub = T_in // chain.fll.sub_block_len(T_in)
    require_shapes(report, {
        ("resample_up_f32", f"L10 K{mod.shaper.kp} D1 tail 2x{N_CH}"): 1,
        ("resample_up_f32", f"L50 K{mod.up.kp} D1 tail 2x{N_CH}"): 1,
        ("fir_decim_f32", f"K{chain.resamp.kp} D50 tail 2x{N_CH}"): 1,
        ("fir_s1_f32", f"K{chain.shaping.ntaps} D1 tail 2x{N_CH}"): 1,
        ("fll_band_edge_f32", f"{N_CH}x{T_in} sb{T_in // n_sub}"): 1,
        ("agc2_f32", f"complex {N_CH}x{T_in}"): 1,
        ("symbol_sync_mm_f32", f"conj {N_CH}x{T_in}->{n_sym}"): 1,
        ("costas_loop_f32", f"order2 {N_CH}x{n_sym}"): 1,
        ("viterbi_stream_k7", f"R{2 * N_CH} T{n_sym // 2} lag64"): 1},
        BPSK_STEPS, "bpsk",
        never=("fir_stream_f32", "resample_poly_f32", "agc2_gain_f32",
               "viterbi_stream_warp_k7", "viterbi_stream_redux_k7"))
    only_shape(report, "fir_s1_f32",
               f"K{chain.shaping.ntaps} D1 tail 2x{N_CH}", "bpsk")
    sent = torch.cat([bytes_to_bits(d) for d in data], dim=-1)
    # a channel decodes on one of the two delay-diversity pairings
    ber = ber_report("bpsk, the better of bits and bits_alt", torch.minimum(
        best_ber_rows(psk_bits(outs), sent, 400),
        best_ber_rows(psk_bits(outs, "bits_alt"), sent, 400)))
    if not ber < 0.01:
        raise RuntimeError(f"bpsk: BER {ber} is not below 0.01")
    print(f"  {step_times(step_s, N_CH * T_STEP)}", flush=True)
    return report


def psk_tx_path(dev, gen):
    """The PSK modulators at 2048 channels, N_STEPS steps with state
    carried and the counters zeroed just before: QpskMod(125_000) on 3,125
    seeded random bytes a channel a step and BpskMod on 25, 200,000 IQ
    samples a channel out of each. QpskMod's RRC interpolator (L4) and
    BpskMod's two (L10, L50) on resample_up_f32, QpskMod's x2 (L2 M1) on
    resample_x2_f32, once each a step; resample_poly_f32 never. Returns
    (the report, the modulators)."""
    from qradiolink_tpu_torch.chains.psk import BpskMod, QpskMod

    qm = QpskMod(125_000, lead_shape=(N_CH,), device=dev)
    bm = BpskMod(lead_shape=(N_CH,), device=dev)
    data = [tuple(torch.randint(0, 256, (N_CH, n), generator=gen, device=dev,
                                dtype=torch.int64).to(torch.uint8)
                  for n in (QPSK_BYTES, BPSK_BYTES)) for _ in range(N_STEPS)]

    def step(states, d):
        s1, o1 = qm(states[0], d[0])
        s2, o2 = bm(states[1], d[1])
        return (s1, s2), (o1["iq"], o2["iq"])

    _, outs, step_s, report = drive(
        step, (qm.init_state(), bm.init_state()), data,
        ("resample_up_f32", "resample_x2_f32"))
    for name, v in zip(("qpsk", "bpsk"), outs[-1]):
        if tuple(v.shape) != (N_CH, T_STEP) or v.dtype != torch.complex64 \
                or not bool(torch.isfinite(torch.view_as_real(v)).all()):
            raise RuntimeError(f"psk tx {name} iq: wrong shape, dtype or "
                               f"non-finite")
    del outs
    torch.cuda.empty_cache()
    require_shapes(report, {
        ("resample_up_f32", f"L4 K{qm.shaper.kp} D1 tail 2x{N_CH}"): 1,
        ("resample_x2_f32", f"L2 K{qm.up.kp} D1 tail 2x{N_CH}"): 1,
        ("resample_up_f32", f"L10 K{bm.shaper.kp} D1 tail 2x{N_CH}"): 1,
        ("resample_up_f32", f"L50 K{bm.up.kp} D1 tail 2x{N_CH}"): 1},
        N_STEPS, "psk_tx", never=("resample_poly_f32",))
    print(f"  {step_times(step_s, 2 * N_CH * T_STEP)} (IQ samples out of "
          f"both modulators)", flush=True)
    return report, (qm, bm)


def psk_tx_rows(mods, dev, gen):
    """The PSK modulators' interpolators at the shapes psk_tx_path gives
    them (complex symbols, two planes), each against its plain version."""
    qm, bm = mods
    n_sym = 8 * QPSK_BYTES      # rate-1/2 coded dibits a step
    n_bit = 16 * BPSK_BYTES     # rate-1/2 coded bits a step
    rows = poly_row("qpsk_tx_rrc", qm.shaper, 2, N_CH, n_sym, "psk_tx", dev,
                    gen)
    rows += poly_row("qpsk_tx_up", qm.up, 2, N_CH, n_sym * qm.sps, "psk_tx",
                     dev, gen)
    rows += poly_row("bpsk_tx_rrc", bm.shaper, 2, N_CH, n_bit, "psk_tx", dev,
                     gen)
    rows += poly_row("bpsk_tx_up", bm.up, 2, N_CH, n_bit * bm.sps, "psk_tx",
                     dev, gen)
    torch.cuda.empty_cache()
    return rows


def qpsk_capture_phase(dev):
    """The frozen QPSK250K capture (scripts/make_qpsk_capture.py) in two
    blocks of 40,000 samples through QpskDemod(125_000, 500_000) on the
    card (each loop kernel once a block) and on the port's CPU path: the
    bits equal, the BER against the payload below 0.01."""
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.chains.psk import QpskDemod
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    data = np.load(QPSK_FIXTURE)
    re = data["iq_re"].astype(np.float32)[None, :]
    im = data["iq_im"].astype(np.float32)[None, :]
    half = re.shape[1] // 2
    cpu = torch.device("cpu")
    chains = {d.type: QpskDemod(125_000, 500_000, lead_shape=(1,), device=d)
              for d in (dev, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    bits = {k: [] for k in chains}
    err = 0.0
    kernel_paths.reset()
    for sl in (slice(0, half), slice(half, 2 * half)):
        outs = {}
        for d in (dev, cpu):
            iq = IqPair(torch.from_numpy(re[:, sl].copy()).to(d),
                        torch.from_numpy(im[:, sl].copy()).to(d))
            states[d.type], outs[d.type] = chains[d.type](states[d.type], iq)
            bits[d.type].append(outs[d.type]["bits"].cpu())
        err = max(err, float((outs[dev.type]["constellation"].cpu()
                              - outs["cpu"]["constellation"]).abs().max()))
    rep = kernel_paths.report()
    for op in ("costas_loop_f32", "symbol_sync_mm_f32", "viterbi_stream_k7"):
        if rep.get(op, {}).get("cuda", 0) < 2:
            raise RuntimeError(f"qpsk capture: {op} did not launch on the "
                               f"card: {json.dumps(rep)}")
    card, host = torch.cat(bits[dev.type], -1), torch.cat(bits["cpu"], -1)
    if not torch.equal(card, host):
        raise RuntimeError(f"qpsk capture: {int((card != host).sum())} bits "
                           f"differ between the card and the CPU")
    sent = bytes_to_bits(torch.from_numpy(data["payload"])).numpy()
    ber = best_ber(card[0].numpy(), sent, 1000)
    if not ber < 0.01:
        raise RuntimeError(f"qpsk capture: BER {ber}")
    print(f"  {QPSK_FIXTURE.name}: 2 blocks of {half}; {card.shape[-1]} bits "
          f"equal on the card and the CPU, BER {ber:.4f}; constellation "
          f"card vs CPU max |diff| {err:.3e}", flush=True)


# -- the M17 and DMR modems --------------------------------------------------

FSK4_T24 = T_STEP * 3 // 125     # samples a step at 24 ksps (4,800)
FSK4_SYMS = FSK4_T24 // 5        # symbols a step (960)
FSK4_BITS = 2 * FSK4_SYMS        # bits a row a step (1,920)
FRAME_ROWS = 8                   # rows whose frames the host decodes
CVC_ROWS = 4                     # rows of the card-against-CPU check
# the card against the port's CPU path, relative to each one's peak: soft
# and every state leaf within 2e-5 (tests/test_torch_dmr.py's bound against
# the JAX chains; the FIRs' sums round apart on the two), the symbols
# within 1e-3: over a 200,000-sample block DMR's symbols differed by
# 3.0e-4 (the state leaves by 3.1e-6), an M&M decision near a level
# boundary flipping on a FIR rounding and the loop carrying it into the
# next symbols' timing until it reconverges; the bits are equal
FSK4_TOL = 2e-5
FSK4_SYM_TOL = 1e-3
M17_STREAMS = 11                 # stream frames a row sends
SLOT24 = 720                     # one TDMA slot at 24 ksps (30 ms)
# besides the head's kernel (head_launches)
FSK4_EVERY_STEP = ("fir_s1_f32", "symbol_sync_mm_f32")


def fsk4_chains(kind):
    """(modulator, M&M demodulator, feedforward demodulator) classes."""
    from qradiolink_tpu_torch.chains import dmr, m17

    if kind == "m17":
        return m17.M17Mod, m17.M17Demod, m17.M17DemodFF
    return dmr.DmrMod, dmr.DmrDemod, dmr.DmrDemodFF


def m17_streams(rng, n_rows):
    """Each row's M17 transmission over N_STEPS steps (15 frames of 384
    bits = 5,760): two preambles, the LSF, M17_STREAMS stream frames of
    seeded 16-byte payloads, one frame of zeros. Returns (bits (n_rows,
    5,760) uint8, each row's payloads)."""
    from qradiolink_tpu_torch.protocols import m17

    lsf = m17.LinkSetupFrame.for_stream("SP5WWP", "AB1CDE", can=3)
    bits, sent = [], []
    for _ in range(n_rows):
        enc = m17.FrameEncoder(lsf)
        pays = [bytes(rng.integers(0, 256, 16).astype(np.uint8))
                for _ in range(M17_STREAMS)]
        frames = [enc.encode_preamble(), enc.encode_preamble(),
                  enc.encode_lsf()]
        frames += [enc.encode_stream(p, last=i == M17_STREAMS - 1)
                   for i, p in enumerate(pays)]
        bits.append(np.concatenate(frames + [np.zeros(384, np.uint8)]))
        sent.append(pays)
    return np.stack(bits), sent


def dmr_streams(rng, n_rows):
    """Each row's DMR transmission over N_STEPS steps (5,760 bits), as
    tests/test_chains_dmr.py builds it: 8 frames of idle dibits, a voice
    LC header, a voice superframe A-F with the embedded LC and the
    terminator (color code 1, the row's own source id and voice bits),
    then idle dibits. Built with the block codes on the CPU (test data).
    Returns (bits (n_rows, 5,760) uint8, each row's (LinkControl, voice
    bits (6, 216)))."""
    from qradiolink_tpu_torch.protocols import dmr

    n = N_STEPS * FSK4_BITS
    lead = np.tile(np.array([0, 1, 1, 1], np.uint8), 66 * 8)
    bits, sent = [], []
    for r in range(n_rows):
        lc = dmr.LinkControl(flco=dmr.FLCO_GROUP, dst_id=91,
                             src_id=2_405_321 + r)
        voice = rng.integers(0, 2, (6, 216)).astype(np.uint8)
        bursts = [dmr.make_lc_burst(lc, 1, dmr.DT_VOICE_LC_HEADER,
                                    device="cpu"),
                  *dmr.make_voice_superframe(voice, lc, 1, device="cpu"),
                  dmr.make_lc_burst(lc, 1, dmr.DT_TERMINATOR_WITH_LC,
                                    device="cpu")]
        row = np.concatenate([lead] + [b.ravel() for b in bursts])
        tail = np.tile(np.array([0, 1, 1, 1], np.uint8),
                       -(-(n - row.size) // 4))[:n - row.size]
        bits.append(np.concatenate([row, tail]))
        sent.append((lc, voice))
    return np.stack(bits), sent


def fsk4_rx_input(kind, dev):
    """The RX paths' input: each row's transmission (m17_streams,
    dmr_streams; host ms a row printed) through the port's modulator on
    the card, N_STEPS steps of FSK4_BITS bits, then ChannelModel at 10 dB
    with a 100 Hz offset (20 whole cycles a step, so the carrier runs on
    across steps). Returns (IqPair a step, each row's sent frames)."""
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.core import IqPair

    Mod = fsk4_chains(kind)[0]
    rng = np.random.default_rng(17)
    t0 = time.perf_counter()
    bits, sent = (m17_streams if kind == "m17" else dmr_streams)(rng, N_CH)
    print(f"  {kind}: {N_CH} rows' frames built on the host in "
          f"{(time.perf_counter() - t0) / N_CH * 1e3:.3f} ms a row",
          flush=True)
    bits = torch.from_numpy(bits).to(dev)
    mod = Mod(lead_shape=(N_CH,), device=dev)
    chan = ChannelModel(1_000_000, snr_db=10.0, freq_offset_hz=100.0,
                        seed=29)
    st, iqs = mod.init_state(), []
    for i in range(N_STEPS):
        st, out = mod(st, bits[:, i * FSK4_BITS:(i + 1) * FSK4_BITS])
        y = chan(out["iq"])
        del out
        iqs.append(IqPair(y.real.contiguous(), y.imag.contiguous()))
        del y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return iqs, sent


def m17_frames_ok(bits, sent):
    """M17 frame layer on one row's received bits: Deframer("M17") then
    FrameDecoder. Returns (the LSF's source or None, payloads that match
    the row's)."""
    from qradiolink_tpu_torch.framing.layer1 import Deframer, FrameType
    from qradiolink_tpu_torch.protocols.m17 import FrameDecoder

    dec, lsf, ok = FrameDecoder(), None, 0
    for ftype, fb in Deframer("M17").process(bits):
        fbits = np.unpackbits(np.frombuffer(fb, np.uint8))
        if ftype == FrameType.M17_LSF:
            lsf = dec.decode_lsf(fbits) or lsf
        elif ftype == FrameType.M17_STREAM:
            ok += dec.decode_stream(fbits).payload in sent
    if lsf is None and dec.lsf_valid:
        lsf = dec.lsf  # late entry: the LSF from the LICH chunks
    return (None if lsf is None else lsf.source), ok


def dmr_frames_ok(bits, sent, dev):
    """DMR frame layer on one row's received bits: find_bursts, then
    decode_burst (block codes on the card) at each hit and, after a voice
    sync, the 5 voice bursts by dead reckoning (tests/test_chains_dmr.py).
    Returns ((src_id, dst_id) of the voice LC header and of the terminator
    with LC, each None where it did not decode, frame A's voice bits
    equal)."""
    from qradiolink_tpu_torch.protocols import dmr

    hits = dict(dmr.find_bursts(bits))
    starts = set(hits)
    for s, name in list(hits.items()):
        if name.endswith("audio"):
            starts |= {s + k * dmr.FRAME_BITS for k in range(1, 6)
                       if s + (k + 1) * dmr.FRAME_BITS <= bits.size}
    lcs = {dmr.DT_VOICE_LC_HEADER: None, dmr.DT_TERMINATOR_WITH_LC: None}
    voice_a = False
    for s in sorted(starts):
        d = dmr.decode_burst(bits[s:s + dmr.FRAME_BITS], dev)
        if d.kind == "data" and d.ok and lcs.get(d.data_type, 0) is None:
            lcs[d.data_type] = (d.lc.src_id, d.lc.dst_id)
        if d.kind == "voice_sync" and not voice_a:
            voice_a = bool(np.array_equal(d.voice_bits, sent[1][0]))
    return (lcs[dmr.DT_VOICE_LC_HEADER], lcs[dmr.DT_TERMINATOR_WITH_LC],
            voice_a)


def frame_phase(kind, rx_bits, sent, dev):
    """The frame layer on the host for FRAME_ROWS rows spread over the
    batch; each must pass its gate. M17: the LSF (or its late entry from
    the LICH chunks) and all but one of the row's stream payloads. DMR:
    frame A's voice bits, and the row's LC (src_id, dst_id) from the voice
    LC header, or from the terminator where the header was lost: the
    chain's M&M loop leaves the idle tone (alternating +-1.5) for the
    header's random dibits with tens of bit errors in the header's first
    ~110 bits on many rows (the JAX chain gives the same bits on this
    input), as M17's LSF can be lost to acquisition. Prints how many
    headers decoded, and the host ms a row."""
    rows = np.linspace(0, N_CH - 1, FRAME_ROWS).astype(int)
    got = rx_bits[torch.as_tensor(rows, device=rx_bits.device)].cpu().numpy()
    t0 = time.perf_counter()
    n_header = 0
    for r, b in zip(rows, got):
        if kind == "m17":
            src, ok = m17_frames_ok(b, sent[r])
            if src != "SP5WWP" or ok < M17_STREAMS - 1:
                raise RuntimeError(f"m17 row {r}: LSF source {src}, {ok} of "
                                   f"{M17_STREAMS} payloads")
        else:
            want = (sent[r][0].src_id, sent[r][0].dst_id)
            header, term, voice_a = dmr_frames_ok(b, sent[r], dev)
            n_header += header == want
            if (header if header is not None else term) != want \
                    or not voice_a:
                raise RuntimeError(f"dmr row {r}: header {header}, "
                                   f"terminator {term}, frame A voice bits "
                                   f"equal {voice_a}")
    host_ms = (time.perf_counter() - t0) / len(rows) * 1e3
    gate = (f"the LSF and at least {M17_STREAMS - 1} of {M17_STREAMS} "
            f"payloads" if kind == "m17" else
            f"the LC's ids (from the header on {n_header} of {len(rows)} "
            f"rows, the terminator on the others) and frame A's voice bits")
    print(f"  {kind} frame layer on rows {rows.tolist()}: {gate} on every "
          f"row; host {host_ms:.3f} ms a row of {rx_bits.shape[-1]} bits",
          flush=True)


def fsk4_card_vs_cpu(kind, iqs, dev):
    """The M&M chain on CVC_ROWS rows x 2 blocks (the path's first two
    steps) on the card and on the port's CPU path: bits equal; symbols
    within FSK4_SYM_TOL of their peak, soft and every state leaf within
    FSK4_TOL (each one's max |diff| over its peak printed)."""
    from qradiolink_tpu_torch.core import IqPair, _flatten

    Demod = fsk4_chains(kind)[1]
    cpu = torch.device("cpu")
    chains = {d.type: Demod(lead_shape=(CVC_ROWS,), device=d)
              for d in (dev, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    diffs = {}
    for blk in range(2):
        outs = {}
        for d in (dev, cpu):
            iq = IqPair(iqs[blk].re[:CVC_ROWS].to(d).contiguous(),
                        iqs[blk].im[:CVC_ROWS].to(d).contiguous())
            states[d.type], outs[d.type] = chains[d.type](states[d.type], iq)
        card, host = outs[dev.type], outs["cpu"]
        if not torch.equal(card["bits"].cpu(), host["bits"]):
            n = int((card["bits"].cpu() != host["bits"]).sum())
            raise RuntimeError(f"{kind} card vs CPU block {blk}: {n} bits "
                               f"differ")
        pairs = [(k, card[k].cpu(), host[k]) for k in ("symbols", "soft")
                 if k in host]
        pairs += [(f"state leaf {i}", a.cpu(), b) for i, (a, b) in enumerate(
            zip(_flatten(states[dev.type], []), _flatten(states["cpu"], [])))]
        for name, a, b in pairs:
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            d = float((a.double() - b.double()).abs().max()) if a.numel() \
                else 0.0
            peak = max(float(b.abs().max()) if b.numel() else 0.0, 1.0)
            diffs[name] = max(diffs.get(name, (0.0, peak)), (d / peak, peak))
    print(f"  {kind} card vs CPU, {CVC_ROWS} rows x 2 blocks of {T_STEP}: "
          f"bits equal; max |diff| / peak: " + ", ".join(
              f"{k} {v[0]:.2e}" for k, v in diffs.items()), flush=True)
    bad = {k: v for k, v in diffs.items() if not v[0] <= (
        FSK4_SYM_TOL if k == "symbols" else FSK4_TOL)}
    if bad:
        raise RuntimeError(f"{kind} card vs CPU beyond the bound: {bad}")


def fsk4_path(kind, dev):
    """The M17 or DMR RX path (BASELINE configs[2]): each row's own
    transmission (fsk4_rx_input) at 2048 channels x 200,000 samples a
    step through M17Demod / DmrDemod for N_STEPS steps with state carried,
    the counters zeroed just before: the 3/125 head on resample_dec_f32,
    the RRC (and M17's channel LP) on fir_s1_f32, symbol_sync_mm_f32 on its
    4 levels, each once a step; fir_stream_f32, resample_poly_f32 and
    fir_long_f32 never. Step ms and
    vs_baseline (printed, not gated), one step stage by stage, one traced;
    the frame layer on FRAME_ROWS rows (frame_phase); the card against
    the CPU (fsk4_card_vs_cpu); then the feedforward chain on the same
    input, step ms. Returns (the M&M run's report, the FF run's)."""
    from qradiolink_tpu_torch.chains.m17 import constellation, dibit_bits
    from qradiolink_tpu_torch.core import Sequencer
    from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css

    _, Demod, DemodFF = fsk4_chains(kind)
    iqs, sent = fsk4_rx_input(kind, dev)
    chain = Demod(lead_shape=(N_CH,), device=dev)
    head, per_step = head_launches(chain.resamp)
    heads = {"resample_poly_f32", "fir_long_f32",
             "resample_dec_f32"} - {head[0]}
    state, outs, step_s, report = drive(chain, chain.init_state(), iqs,
                                        (head[0],) + FSK4_EVERY_STEP)
    for out in outs:
        for key, shape, dt in (("bits", (N_CH, FSK4_BITS), torch.uint8),
                               ("symbols", (N_CH, FSK4_SYMS), torch.float32),
                               ("constellation", (N_CH, FSK4_SYMS),
                                torch.complex64),
                               ("rssi", (N_CH,), torch.float32)):
            v = out[key]
            fin = torch.isfinite(torch.view_as_real(v) if v.is_complex()
                                 else v.float()).all()
            if tuple(v.shape) != shape or v.dtype != dt or not bool(fin):
                raise RuntimeError(f"{kind} {key}: {tuple(v.shape)} "
                                   f"{v.dtype} or non-finite")
    want = {head: per_step,
            ("fir_s1_f32", f"K{chain.shaping.ntaps} D1 tail 1x{N_CH}"): 1,
            ("symbol_sync_mm_f32", css.shape_key(
                N_CH, FSK4_T24, FSK4_SYMS, css.MODE_LEVELS)): 1}
    if kind == "m17":
        want[("fir_s1_f32",
              f"K{chain.chan_filter.ntaps} D1 tail 2x{N_CH}")] = 1
    require_shapes(report, want, N_STEPS, kind,
                   never=("fir_stream_f32", "resample_up_f32", *heads))
    med = statistics.median([s * 1e3 for s in step_s[1:]])
    print(f"  {step_times(step_s, N_CH * T_STEP)}, vs_baseline "
          f"{T_STEP / med / 1e3:.2f} Msamples/s per channel (printed, not "
          f"gated)", flush=True)

    iq = iqs[-1]
    mag = 1.0 if kind == "m17" else 0.9

    def stage_step():
        seq, stages = Sequencer(state), {}
        x = timed(stages, f"resampler 3/125 ({head[0]} x{per_step} "
                  f"K{chain.resamp.kp})", lambda: seq(chain.resamp, iq))
        if kind == "m17":
            x = timed(stages, f"channel LP (fir_s1_f32 "
                      f"K{chain.chan_filter.ntaps})",
                      lambda: seq(chain.chan_filter, x))
        timed(stages, "rssi", lambda: rssi_dbm(x))
        x = timed(stages, "quadrature demod", lambda: seq(chain.quad, x))
        x = timed(stages, f"RRC (fir_s1_f32 K{chain.shaping.ntaps})",
                  lambda: seq(chain.shaping, x))
        syms = timed(stages, "symbol sync (symbol_sync_mm_f32, levels)",
                     lambda: seq(chain.symbol_sync, x))
        timed(stages, "dibits + constellation",
              lambda: (dibit_bits(syms, mag), constellation(syms)))
        return stages

    # the first pass stage by stage took ms in small ops (one-off work of
    # the first calls in this order), so the second is printed
    stage_step()
    stages = stage_step()
    print(f"  stage ms (one step, CUDA events): {json.dumps(stages)}",
          flush=True)
    trace_step("one more step", lambda: chain(state, iq))
    rx_bits = torch.cat([o["bits"] for o in outs], dim=-1)
    del outs, state
    torch.cuda.empty_cache()
    frame_phase(kind, rx_bits, sent, dev)
    fsk4_card_vs_cpu(kind, iqs, dev)

    ff = DemodFF(lead_shape=(N_CH,), device=dev)
    _, outs, step_s, ff_report = drive(ff, ff.init_state(), iqs,
                                       (head[0], "fir_s1_f32"))
    require_shapes(ff_report, {head: per_step}, N_STEPS, f"{kind}_ff",
                   never=("fir_stream_f32", "symbol_sync_mm_f32", *heads))
    if tuple(outs[-1]["bits"].shape) != (N_CH, FSK4_BITS) or not bool(
            torch.isfinite(outs[-1]["symbols"]).all()):
        raise RuntimeError(f"{kind}_ff: wrong bits shape or non-finite "
                           f"symbols")
    print(f"  {DemodFF.__name__}: {step_times(step_s, N_CH * T_STEP)}",
          flush=True)
    del outs, iqs
    torch.cuda.empty_cache()
    return report, ff_report


def head_row(name, rs, run, dev, gen):
    """A 3/125 head at its path's shape (2048 rows x 200,000, 2 planes, the
    tails read in place): resample_dec_f32 (the route's kernel),
    resample_poly_f32 and the per-phase route
    (cuda_resample.resample_phases: one launch a phase of the strided
    FIR's routed kernel, fir_stream_f32 at M17's K349, fir_long_f32 at
    DMR's K2091, and the interleave), each against the plain version
    (outputs within the FIR's bound, state equal), resample_dec_f32 over
    a second block chained from its new state and, at DMR's head, bit for
    bit equal to the per-phase route (it takes fir_long_f32's layout and
    sum order there), the three timed in turns, and one F.conv1d with L
    output channels (TF32 off). The rows of the ones that
    cuda_resample.route does not pick have no path."""
    from qradiolink_tpu_torch.ops import cuda_fir, cuda_resample
    import torch.nn.functional as F

    L, M, K, taps = rs.L, rs.M, rs.kp, rs.poly_taps
    op = cuda_resample.route(L, M, K, N_CH)

    def planes():
        return tuple(torch.randn((N_CH, T_STEP), generator=gen,
                                 device=dev) * 0.1 for _ in range(2))

    xs = planes()
    st = torch.randn((N_CH, 2, K - 1), generator=gen, device=dev) * 0.1
    tails = (st[:, 0, :], st[:, 1, :])
    ph_op = cuda_fir.route(K, M)
    fns = {cuda_resample.OP: lambda: cuda_resample.launch(
               cuda_resample.OP, xs, taps, L, M, tails),
           ph_op: lambda: cuda_resample.resample_phases(xs, taps, L, M,
                                                        tails),
           cuda_resample.DEC_OP: lambda: cuda_resample.launch(
               cuda_resample.DEC_OP, xs, taps, L, M, tails)}
    p_state, p_ys = cuda_resample.resample_poly_plain(xs, taps, L, M, tails)
    errs, outs = {}, {}
    for k, fn in fns.items():
        state, ys = fn()
        errs[k] = check_fir(f"{k}/{name}", ys, p_ys)
        if not torch.equal(state, p_state):
            raise RuntimeError(f"{k}/{name}: state differs")
        outs[k] = ys
        if k == cuda_resample.DEC_OP:
            # a second block from the kernel's new state, fresh input
            xs2 = planes()
            tails2 = (state[:, 0, :], state[:, 1, :])
            s2, y2 = cuda_resample.launch(k, xs2, taps, L, M, tails2)
            w2, p2 = cuda_resample.resample_poly_plain(xs2, taps, L, M,
                                                       tails2)
            errs[k] = max(errs[k], check_fir(f"{k}/{name} block 1", y2, p2))
            if not torch.equal(s2, w2):
                raise RuntimeError(f"{k}/{name} block 1: state differs")
            print(f"  {k}/{name}: within the FIR's bound, state equal, over "
                  f"two chained blocks", flush=True)
            del xs2, tails2, s2, y2, w2, p2
        del state, ys
    if ph_op == cuda_fir.LONG_OP:
        # DMR's head: resample_dec_f32 takes fir_long_f32's segments,
        # column groups and sum order, so the two routes' bits are equal
        if not all(torch.equal(a, b) for a, b in zip(
                outs[cuda_resample.DEC_OP], outs[ph_op])):
            raise RuntimeError(f"{cuda_resample.DEC_OP}/{name}: not "
                               f"bit-equal to {ph_op} once a phase")
        print(f"  {cuda_resample.DEC_OP}/{name}: outputs bit-equal to the "
              f"per-phase route on {ph_op}", flush=True)
    del outs
    offs = cuda_resample.phase_offsets(L, M)
    w = torch.zeros((L, 1, K + offs[-1]), device=dev)
    for r, q in enumerate(offs):
        w[r, 0, q:q + K] = taps[r]
    lib_in = torch.stack([torch.cat([t, x], -1) for t, x in zip(tails, xs)]
                         ).reshape(2 * N_CH, 1, -1)
    lib = F.conv1d(lib_in, w, stride=M).transpose(1, 2).reshape(2, N_CH, -1)
    check_fir(f"F.conv1d with L output channels/{name}", lib.unbind(0),
              p_ys)
    del lib, p_ys, p_state
    torch.cuda.synchronize()
    ms, turns = turns_ms(fns)
    print(f"  {name} in turns: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in turns), flush=True)
    plain_ms = cuda_ms(lambda: cuda_resample.resample_poly_plain(
        xs, taps, L, M, tails), iters=3, warmup=1)
    lib_ms = cuda_ms(lambda: F.conv1d(lib_in, w, stride=M))
    n_out = T_STEP // M * L
    b = bound(4 * (2 * N_CH * (K - 1 + T_STEP) + L * K + 2 * N_CH * n_out
                   + 2 * N_CH * (K - 1)), 2 * K * 2 * N_CH * n_out)
    print(f"  {name}: the route's {op} " + ", ".join(
        f"{ms[k] / ms[op]:.2f}x {k}" for k in fns if k != op)
        + f" in turns, {lib_ms / ms[op]:.2f}x F.conv1d, "
        f"{b[0] / ms[op]:.1%} of its bound ({CARD})", flush=True)
    del lib_in
    rows = [row(f"{k}/{name}", RESAMPLE_SOURCE[k], RESAMPLE_REPLACES.get(
                k, "qradiolink_tpu/ops/pallas_fir.py:111"), errs[k], ms[k],
                plain_ms, b, lib_ms, run,
                cuda_resample.shape_key(xs, L, K, M), routed=op == k)
            for k in (cuda_resample.DEC_OP, cuda_resample.OP)]
    rows.append(row(f"{ph_op}/{name}", FIR_SOURCE[ph_op],
                    "qradiolink_tpu/ops/pallas_fir.py:218", errs[ph_op],
                    ms[ph_op], plain_ms, b, lib_ms, run,
                    cuda_fir.shape_key(xs, K, M, tails), routed=op == ph_op))
    rows[-1]["per_step"] = L
    del xs, st, tails
    torch.cuda.empty_cache()
    return rows


def head_launches(rs):
    """((kernel, shape key) of a 3/125 head on the route, launches a step)
    at N_CH rows, 2 planes: resample_dec_f32 (or another resampler
    kernel) once."""
    from qradiolink_tpu_torch.ops import cuda_resample

    op = cuda_resample.route(rs.L, rs.M, rs.kp, N_CH)
    return (op, f"L{rs.L} K{rs.kp} D{rs.M} tail 2x{N_CH}"), 1


def fsk4_signal(dev, gen, C, T):
    """A 4-level signal at 5 samples a symbol: levels {-1.5, -0.5, 0.5,
    1.5} held 5 samples, smoothed by a 5-tap moving average, noise at
    0.05; (C, T) f32."""
    lv = torch.tensor([-1.5, -0.5, 0.5, 1.5], device=dev)
    idx = torch.randint(0, 4, (C, -(-T // 5) + 1), generator=gen,
                        device=dev)
    x = torch.repeat_interleave(lv[idx], 5, dim=-1)
    x = torch.nn.functional.avg_pool1d(x[:, None], 5, 1)[:, 0, :T]
    return (x + 0.05 * torch.randn(x.shape, generator=gen, device=dev)
            ).contiguous()


def fsk4_rows(dev, gen):
    """The M17 and DMR paths' new kernel shapes against their plain
    versions: the 3/125 heads (head_row); fir_s1_f32 at M17's channel LP
    (K11, 2 planes) and RRC (K251) and DMR's RRC (K125), 2048 x 4,800, in
    turns with fir_stream_f32 and bit-equal to it; symbol_sync_mm_f32 in
    levels mode with each chain's loop over two chained blocks of 2048 x
    4,800 -> 960, bit-equal to the plain loop, then timed at that shape
    and held bit-equal once more against one timed call of the plain loop;
    the TX interpolators on resample_up_f32 (poly_row: M17's and DMR's
    5/1 shaper, one plane 960 -> 4,800, and 125/3, two planes 4,800 ->
    200,000), bit-equal to resample_poly_f32 and timed in turns with it."""
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css

    rows = []
    k2 = "qradiolink_tpu/ops/pallas_fir.py:111"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for kind in ("m17", "dmr"):
        Mod, Demod, _ = fsk4_chains(kind)
        rx = Demod(lead_shape=(N_CH,), device=dev)
        rows += head_row(f"{kind}_head", rx.resamp, kind, dev, gen)
        filts = [("rrc", rx.shaping, 1)]
        if kind == "m17":
            filts.insert(0, ("chan_lp", rx.chan_filter, 2))
        for fname, filt, planes in filts:
            st = randn(N_CH, 2, filt.ntaps - 1)
            rows += fir_row(f"{kind}_{fname}", k2 if fname == "rrc" else
                            "qradiolink_tpu/ops/pallas_fir.py:218",
                            tuple(randn(N_CH, FSK4_T24)
                                  for _ in range(planes)),
                            filt.taps_flipped, 1, FSK4_T24,
                            (st[:, 0, :], st[:, 1, :])[:planes], kind)
        ss = rx.symbol_sync
        mode = css.MODE_LEVELS

        def sync_args(s, ss=ss):
            pos, om, yp, dp, _ = s
            return (pos, om, yp, dp, FSK4_SYMS, mode, ss.levels, ss.sps,
                    ss.alpha, ss.beta, ss.omega_limit, ss.ted_norm)

        def sync_plain(b, s, ss=ss):
            xc = torch.cat([s[4], b.to(torch.complex64)], dim=-1)
            r = css.symbol_sync_plain(xc.real.contiguous(),
                                      xc.imag.contiguous(), *sync_args(s))
            return (torch.complex(r[0], r[1]),) + r[2:]

        x = fsk4_signal(dev, gen, N_CH, 2 * FSK4_T24)
        blocks = [x[:, :FSK4_T24].contiguous(), x[:, FSK4_T24:].contiguous()]
        s1 = chained_equal(
            f"{css.OP} levels ({kind})",
            lambda b, s: css.symbol_sync(s[4], b, *sync_args(s)), sync_plain,
            blocks, ss.init_state(),
            lambda g: (torch.clamp(g[1] - FSK4_T24, 0.0, ss.tail_len - 2.0),
                       *g[2:], blocks[0][:, -ss.tail_len:].to(
                           torch.complex64)))
        xb = blocks[1]
        shape = css.shape_key(N_CH, FSK4_T24, FSK4_SYMS, mode)
        rows.append(loop_row(
            f"{css.OP}/{kind}", "qradiolink_tpu_torch/csrc/symbol_sync.cu",
            "qradiolink_tpu/sync/symbol_sync.py:152",
            lambda: css.symbol_sync(s1[4], xb, *sync_args(s1)),
            lambda: sync_plain(xb, s1),
            4 * N_CH * (FSK4_T24 + ss.tail_len) + 8 * N_CH * FSK4_SYMS,
            60 * N_CH * FSK4_SYMS, kind, shape))
        a1 = sync_args(s1)
        rows.append(levels_v0_row(
            f"{css.OP}/{kind}", lambda: css.symbol_sync(s1[4], xb, *a1),
            lambda: css.symbol_sync_levels_v0(s1[4], xb, *a1[:5], *a1[6:]),
            rows[-1], kind, shape, FSK4_SYMS))
        del x, blocks, xb, s1
        tx = Mod(lead_shape=(N_CH,), device=dev)
        rows += poly_row(f"{kind}_tx_shaper", tx.shaper, 1, N_CH, FSK4_SYMS,
                         "fsk4_tx", dev, gen)
        rows += poly_row(f"{kind}_tx_up", tx.up, 2, N_CH, FSK4_T24,
                         "fsk4_tx", dev, gen)
        torch.cuda.empty_cache()
    return rows


def fsk4_tx_path(dev, gen):
    """M17Mod and DmrMod at 2048 channels, N_STEPS steps of FSK4_BITS
    seeded random bits a row each (200,000 IQ samples out of each), state
    carried, the counters zeroed just before; DmrMod's mask zeroes one
    720-sample slot in three at 24 ksps, the slots running on across
    steps. Each 5/1 shaper and 125/3 interpolator on resample_up_f32 and
    M17's post filter (K11) on fir_s1_f32, once each a step;
    resample_poly_f32 and fir_stream_f32 never. The last step's DMR IQ
    must be near zero in a zeroed slot. Returns the report."""
    from qradiolink_tpu_torch.chains.dmr import DmrMod
    from qradiolink_tpu_torch.chains.m17 import M17Mod

    mm = M17Mod(lead_shape=(N_CH,), device=dev)
    dm = DmrMod(lead_shape=(N_CH,), device=dev)
    data = []
    for i in range(N_STEPS):
        b = [torch.randint(0, 2, (N_CH, FSK4_BITS), generator=gen,
                           device=dev, dtype=torch.int64).to(torch.uint8)
             for _ in range(2)]
        t = torch.arange(i * FSK4_T24, (i + 1) * FSK4_T24, device=dev)
        data.append((*b, ((t // SLOT24) % 3 != 1).float().expand(N_CH, -1)))

    def step(states, d):
        s1, o1 = mm(states[0], d[0])
        s2, o2 = dm(states[1], d[1], mask=d[2])
        return (s1, s2), (o1["iq"], o2["iq"])

    _, outs, step_s, report = drive(
        step, (mm.init_state(), dm.init_state()), data,
        ("resample_up_f32", "fir_s1_f32"))
    for name, v in zip(("m17", "dmr"), outs[-1]):
        if tuple(v.shape) != (N_CH, T_STEP) or v.dtype != torch.complex64 \
                or not bool(torch.isfinite(torch.view_as_real(v)).all()):
            raise RuntimeError(f"{name} tx iq: wrong shape, dtype or "
                               f"non-finite")
    # the last step's first zeroed slot and the open slot two before it,
    # both wholly inside the step: their middle 10,000 samples at 1 Msps
    lo = (N_STEPS - 1) * FSK4_T24
    s = -(-lo // SLOT24) + 2
    s += (1 - s) % 3
    iq = outs[-1][1]

    def slot_power(k):
        mid = ((k * SLOT24 - lo) + SLOT24 // 2) * 125 // 3
        return float((iq[:, mid - 5000:mid + 5000].abs() ** 2).mean())

    idle, busy = slot_power(s), slot_power(s - 2)
    if not idle < 1e-3 * busy:
        raise RuntimeError(f"dmr tx: the zeroed slot's power {idle:.3e} is "
                           f"not below 1e-3 of {busy:.3e}")
    print(f"  dmr tx mask: power in a zeroed slot {idle / busy:.2e} of the "
          f"rest", flush=True)
    del outs, iq
    torch.cuda.empty_cache()
    require_shapes(report, {
        ("resample_up_f32", f"L5 K{mm.shaper.kp} D1 tail 1x{N_CH}"): 1,
        ("resample_up_f32", f"L125 K{mm.up.kp} D3 tail 2x{N_CH}"): 1,
        ("resample_up_f32", f"L5 K{dm.shaper.kp} D1 tail 1x{N_CH}"): 1,
        ("resample_up_f32", f"L125 K{dm.up.kp} D3 tail 2x{N_CH}"): 1,
        ("fir_s1_f32", f"K{mm.post_filter.ntaps} D1 tail 2x{N_CH}"): 1},
        N_STEPS, "fsk4_tx", never=("resample_poly_f32", "fir_stream_f32"))
    print(f"  {step_times(step_s, 2 * N_CH * T_STEP)} (IQ samples out of "
          f"both modulators)", flush=True)
    return report


# -- slice 6: the remaining modems (FSK family, DSSS, CW, FreeDV's DSP ends,
# MMDVM) through the registry, and AmMod's FFT post filter ------------------
SWEEP_ROWS = 256
SWEEP_STEPS = 2
SAMPLE_ROWS = 8            # rows whose bits the BER gates read
FB_SNR_DB = 14.0           # tests/test_fsk4_variants.py:49-51
GMSK_SNR_DB = 12.0         # tests/test_chains_digital.py:126-133
# payload bytes of the slice's data modes come from a CPU generator seeded
# with PAYLOAD_SEED, one a run: row r of step i is row r of the i-th (rows,
# bytes) draw, so any row's payload can be made again off the card
PAYLOAD_SEED = 41
# the full-width paths: mode -> (bytes a row a step, channel SNR dB)
FULL_PATHS = {"4FSK2KFB": (50, FB_SNR_DB), "GMSK2K": (25, GMSK_SNR_DB)}
# the card against the CPU on these paths (bits equal on both): mode ->
# (symbols' bound, state leaves' bound), relative to each one's peak.
# GMSK2K: the M17/DMR symbol bound above (measured 2.4e-5); its state
# leaves 1e-4, as the sync carries its last symbol (y_prev, 2.4e-5; the
# other leaves 1.0e-5). The filter bank's discriminator takes a tone only
# on a strict maximum of four magnitudes, and where two magnitudes lie
# within a rounding of each other (the card's fir_s1_f32 and the CPU's
# F.conv1d sum apart) its point flips to another corner, 1.41 away, before
# the K837 symbol LP: 4FSK2KFB's symbols within 0.1 (measured 4.5e-2 over 4
# rows x 2 steps), its state leaves within 3e-3 (1.2e-3: the soft values
# and path metrics the symbols feed). BPSKDSSS8 (the sampled rows of the
# sweep run): the FIRs' sums round apart on the card and the CPU, and the
# Costas loop, AGC and fold carry that; its bounds are FSK4_SYM_TOL and
# FSK4_TOL
CVC_TOLS = {"4FSK2KFB": (0.1, 3e-3), "GMSK2K": (FSK4_SYM_TOL, 1e-4),
            "BPSKDSSS8": (FSK4_SYM_TOL, FSK4_TOL),
            "GMSK10K": (FSK4_SYM_TOL, FSK4_TOL),
            "2FSK10K": (FSK4_SYM_TOL, FSK4_TOL)}
# the sweep's data modes: mode -> (samples a step, bytes a row a step,
# channel SNR dB or None, BER limit), the JAX tests' loopback gates
# (tests/test_chains_digital.py, tests/test_fsk4_variants.py); each step
# long enough that [n/2, 7n/8) of 2 steps' bits lies past the chain's delay
SWEEP_MODES = {
    "4FSK2K": (500_000, 125, 12.0, 0.02),
    "4FSK1KFM": (1_000_000, 125, None, 0.01),
    "4FSK10KFM": (200_000, 250, None, 0.01),
    "4FSK100K": (200_000, 2500, 14.0, 0.02),
    "2FSK2K": (1_000_000, 125, None, 0.01),
    "2FSK1K": (2_000_000, 125, None, 0.01),
    "2FSK10K": (200_000, 250, None, 0.01),
    "2FSK2KFB": (1_000_000, 125, None, 0.01),
    "2FSK1KFB": (2_000_000, 125, None, 0.01),
    "GMSK1K": (2_000_000, 125, GMSK_SNR_DB, 0.02),
    "GMSK10K": (200_000, 250, GMSK_SNR_DB, 0.02),
}
# sampled rows a sweep mode may have at or above its BER limit, where the
# JAX chain is shown to fail the same payloads: 4FSK1KFM's M&M loop slips
# on some random payloads on a clean channel, and
# tests/test_torch_fsk.py::test_4fsk1kfm_slips_as_the_jax_chain holds the
# port's bits to the JAX chain's on such rows (PAYLOAD_SEED 41: rows 45,
# 138, 198 of 256). Every other mode: none.
SLIP_WITNESSED = {"4FSK1KFM": 1}
DSSS_T = 250_000           # a multiple of 62,500 holding whole soft pairs
DSSS_GATE_BYTES = 24       # tests/test_chains_dsss_cw.py: 24 s of signal
FREEDV_T = 1_000_000       # 1 s a step: 8,000 passband samples
MMDVM_T = 250_000          # 1 s at 250 ksps: 24,000 audio samples
CW_T = 200_000             # 1,600 key samples at 8 kHz
# FreeDV's passband tone through FreeDvMod -> ChannelModel -> FreeDvDemod
# (tests/test_torch_freedv_mmdvm.py): SNR above 25 dB at 10 dB
FREEDV_SNR_DB, FREEDV_TONE_DB = 10.0, 25.0
FREEDV_TOL = 1e-5          # card against CPU, relative to the peak
MULTI_C = 7
AM_FFT_TOL = 1e-3          # tests/test_fir.py:66-70, FFT against direct
# the loop kernels: op -> (source, the TPU-era function it replaces)
LOOP_SOURCE = {
    "costas_loop_f32": ("qradiolink_tpu_torch/csrc/costas.cu",
                        "qradiolink_tpu/sync/costas.py:64"),
    "symbol_sync_mm_f32": ("qradiolink_tpu_torch/csrc/symbol_sync.cu",
                           "qradiolink_tpu/sync/symbol_sync.py:152"),
    "viterbi_stream_k7": ("qradiolink_tpu_torch/csrc/viterbi_stream.cu",
                          "qradiolink_tpu/fec/conv.py:217"),
    "agc2_f32": ("qradiolink_tpu_torch/csrc/agc2.cu",
                 "qradiolink_tpu/ops/agc.py:51")}


@contextlib.contextmanager
def call_capture():
    """While active, records every FIR (ops/cuda_fir.fir_stream, as
    FirFilter and the L = 1 resampler call it), every resampler
    (ops/cuda_resample.resample_poly) and every loop kernel call (the
    Costas loop, the symbol sync, Agc2, the streaming Viterbi and the FLL
    as their blocks call them): {(kernel, shape key): [calls, meta]}, meta enough to
    build the same shape again (FIRs, resamplers: taps, stride, rows,
    planes, lengths) or the first call's own inputs (loops: the wrapper
    and a copy of its arguments)."""
    from qradiolink_tpu_torch.fec import conv
    from qradiolink_tpu_torch.fec import viterbi_stream_cuda as vsc
    from qradiolink_tpu_torch.ops import agc as agc_mod
    from qradiolink_tpu_torch.ops import cuda_agc, cuda_fir, cuda_resample
    from qradiolink_tpu_torch.ops import fir as fir_mod
    from qradiolink_tpu_torch.ops import resample as rs_mod
    from qradiolink_tpu_torch.sync import costas as costas_mod
    from qradiolink_tpu_torch.sync import cuda_costas as cc
    from qradiolink_tpu_torch.sync import cuda_fll as cf
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css
    from qradiolink_tpu_torch.sync import fll as fll_mod
    from qradiolink_tpu_torch.sync import symbol_sync as ss_mod

    seen = {}
    orig_fs, orig_rp = cuda_fir.fir_stream, cuda_resample.resample_poly

    def note(key, meta):
        seen.setdefault(key, [0, meta])[0] += 1

    def fs(xs, taps_flipped, stride, n_out, tails=None, shift=0):
        K = taps_flipped.shape[0]
        if shift == 0:
            note((cuda_fir.stream_route(K, stride, xs[0].shape[-1], n_out,
                                        tails),
                  cuda_fir.shape_key(xs, K, stride, tails)),
                 dict(kind="fir", taps=taps_flipped, stride=stride,
                      n_out=n_out, planes=len(xs),
                      lead=tuple(xs[0].shape[:-1]), T=xs[0].shape[-1],
                      tail=tails is not None))
        return orig_fs(xs, taps_flipped, stride, n_out, tails=tails,
                       shift=shift)

    def rp(xs, phase_taps, L, M, tails):
        K = phase_taps.shape[1]
        note((cuda_resample.route(L, M, K, math.prod(xs[0].shape[:-1])),
              cuda_resample.shape_key(xs, L, K, M)),
             dict(kind="poly", taps=phase_taps, L=L, M=M,
                  planes=len(xs), lead=tuple(xs[0].shape[:-1]),
                  T=xs[0].shape[-1]))
        return orig_rp(xs, phase_taps, L, M, tails)

    # the loops: (module, name, kernel, key of a call's arguments)
    loops = [(costas_mod, "costas_loop", cc.OP,
              lambda a: cc.shape_key(a[0], a[3])),
             (ss_mod, "symbol_sync", css.OP,
              lambda a: css.shape_key(a[0].shape[0], a[1].shape[-1], a[6],
                                      a[7])),
             (agc_mod, "agc2", cuda_agc.OP_FUSED,
              lambda a: cuda_agc.fused_key(a[0])),
             (conv, "viterbi_stream", vsc.OP,
              lambda a: vsc.shape_key(a[3], a[2].shape[1])),
             (fll_mod, "fll_band_edge", cf.OP,
              lambda a: cf.shape_key(a[0], a[8]))]
    origs = [getattr(mod, name) for mod, name, _, _ in loops]

    def loop(fn, op, key_of):
        def call(*args):
            key = (op, key_of(args))
            if key not in seen:
                seen[key] = [0, dict(kind="loop", fn=fn, args=tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args))]
            seen[key][0] += 1
            return fn(*args)
        return call

    fir_mod.fir_stream = rs_mod.fir_stream = fs
    rs_mod.resample_poly = rp
    for (mod, name, op, key_of), fn in zip(loops, origs):
        setattr(mod, name, loop(fn, op, key_of))
    try:
        yield seen
    finally:
        fir_mod.fir_stream = rs_mod.fir_stream = orig_fs
        rs_mod.resample_poly = orig_rp
        for (mod, name, _, _), fn in zip(loops, origs):
            setattr(mod, name, fn)


def fir_launches(f, planes, rows, complex_in=False):
    """{(kernel, shape key): launches} of one call of FirFilter f on
    `planes` planes of `rows` rows (complex_in: a complex tensor, not an
    IqPair or real planes): the FFT form once, or the routed kernel once a
    tap plane (two for complex taps)."""
    from qradiolink_tpu_torch.ops import cuda_fir
    from qradiolink_tpu_torch.ops.fir import FFT_OP

    K, D = f.ntaps, f.decim
    if f.form(complex_in) == "fft":
        return {(FFT_OP, f"K{K} D{D} {planes}x{rows}"): 1}
    return {(cuda_fir.route(K, D), f"K{K} D{D} tail {planes}x{rows}"):
            len(f.tap_planes)}


def rs_launches(rs, planes, rows):
    """{(kernel, shape key): launches} of one call of RationalResampler rs:
    at L 1 the routed strided FIR once; else the resampler kernel the
    route gives `rows` rows, once."""
    from qradiolink_tpu_torch.ops import cuda_fir, cuda_resample

    if rs.L == 1:
        return {(cuda_fir.route(rs.kp, rs.M),
                 f"K{rs.kp} D{rs.M} tail {planes}x{rows}"): 1}
    op = cuda_resample.route(rs.L, rs.M, rs.kp, rows)
    return {(op, f"L{rs.L} K{rs.kp} D{rs.M} tail {planes}x{rows}"): 1}


def chain_launches(chain, rows, T=0):
    """{(kernel, shape key): launches} of one call of a slice-6 chain at
    `rows` rows, stage by stage from its blocks (the keys of the launch
    report); T: an RX chain's input samples a row, which set its loops'
    shapes. IQ between stages is an IqPair or a complex tensor (2 planes),
    FM audio, quadrature output and soft ratios real (1)."""
    from collections import Counter
    from qradiolink_tpu_torch.chains import dmr, dsss, freedv, fsk, mmdvm
    from qradiolink_tpu_torch.fec import viterbi_stream_cuda as vsc
    from qradiolink_tpu_torch.ops import cuda_agc, cuda_pfb
    from qradiolink_tpu_torch.ops import cuda_depthwise as dw
    from qradiolink_tpu_torch.sync import cuda_costas as cc
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css

    w = Counter()

    def fir(f, planes, complex_in=False, n=rows):
        w.update(fir_launches(f, planes, n, complex_in))

    def rs(r, planes, n=rows):
        w.update(rs_launches(r, planes, n))

    def sync_fec(mode, t, streams, per_sym):
        """The symbol sync on t samples and the Viterbi on `streams` x rows
        rows of per_sym soft pairs a symbol."""
        n = int(round(t / chain.symbol_sync.sps))
        w[(css.OP, css.shape_key(rows, t, n, mode))] += 1
        w[(vsc.OP, f"R{streams * rows} T{int(n * per_sym)} "
                   f"lag{chain.fec_tail.viterbi.lag}")] += 1

    c = chain
    if isinstance(c, fsk.Fsk4Mod):
        rs(c.shaper, 1)
        rs(c.up1, 2)
        if c.up2 is not None:
            rs(c.up2, 2)
    elif isinstance(c, fsk._BinaryFskModBase):
        rs(c.shaper, 1)
        rs(c.up, 2)
    elif isinstance(c, dsss.DsssBpskMod):
        rs(c.shaper, 2)
        fir(c.post, 2, True)
        rs(c.up_if, 2)
        rs(c.up_rf, 2)
    elif isinstance(c, dsss.CwMod):
        fir(c.key_filter, 1)
        fir(c.ssb.audio_filter, 1)
        fir(c.ssb.analytic, 2, True)
        rs(c.ssb.up, 2)
    elif isinstance(c, freedv.FreeDvMod):
        fir(c.chan_filter, 2, True)
        rs(c.up, 2)
    elif isinstance(c, mmdvm.MmdvmMod):
        fir(c.post, 2)
        rs(c.up, 2)
    elif isinstance(c, mmdvm.MmdvmMultiTx):
        fir(c.chan_filter, 2, n=c.C)
        rs(c.resamp, 2, n=c.C)
        M, kp = c.synthesizer._bt_flipped.shape
        w[(dw.route(kp), f"C{M} kp{kp} tail")] += 1
    elif isinstance(c, mmdvm.MmdvmMultiRx):
        M, kp = c.channelizer.M, c.channelizer.kp
        w[(cuda_pfb.route(M, kp), f"M{M} kp{kp}")] += 1
        rs(c.resamp, 2, n=c.C)
        fir(c.chan_filter, 2, n=c.C)
    elif isinstance(c, mmdvm.MmdvmDemod):
        rs(c.resamp, 2)
        fir(c.chan_filter, 2)
    elif isinstance(c, dmr.DmrMod):
        rs(c.shaper, 1)
        rs(c.up, 2)
    elif isinstance(c, dmr.DmrDemod):
        rs(c.resamp, 2)
        fir(c.shaping, 1)
        t = T // c.resamp.M * c.resamp.L
        w[(css.OP, css.shape_key(rows, t, t // c.sps, css.MODE_LEVELS))] += 1
    elif isinstance(c, freedv.FreeDvDemod):
        rs(c.resamp, 2)
        fir(c.chan_filter, 2)
        w[(cuda_agc.OP_FUSED, f"real {rows}x{T // c.resamp.M}")] += 1
        fir(c.audio_filter, 1)
    elif isinstance(c, dsss.DsssBpskDemod):
        rs(c.resamp, 2)
        rs(c.resamp_if, 2)
        t = T // c.resamp.M * c.resamp_if.L // c.resamp_if.M
        w[(cc.OP, f"order{c.costas_freq.order} {rows}x{t}")] += 1
        fir(c.chan_filter, 2, True)
        w[(cuda_agc.OP_FUSED, f"complex {rows}x{t}")] += 1
        fir(c.matched, 2, True)
        w[(vsc.OP, f"R{4 * rows} T{t // dsss.BIT_SAMPLES // 2} "
                   f"lag{c.fec_tail.viterbi.lag}")] += 1
    else:
        rs(c.resamp, 2)
        fir(c.chan_filter, 2)
        t = T // c.resamp.M * c.resamp.L
        if isinstance(c, fsk.Fsk4Demod):
            fir(c.shaping, 1)
            sync_fec(css.MODE_LEVELS, t, 1, 1)
        elif isinstance(c, fsk.Fsk4FbDemod):
            for f in c.tone_bank:
                fir(f, 2)
            fir(c.symbol_filter, 2, True)
            sync_fec(css.MODE_CONJ, t, 1, 1)
        elif isinstance(c, fsk._BinaryFskDemodBase):
            fir(c.shaping, 1)
            sync_fec(css.MODE_LEVELS, t, 2, 0.5)
        elif isinstance(c, fsk.Fsk2FbDemod):
            fir(c.lower, 2)
            fir(c.upper, 2)
            fir(c.symbol_filter, 1)
            sync_fec(css.MODE_LEVELS, t, 2, 0.5)
        else:
            raise TypeError(f"no launch table for {type(c).__name__}")
    return w


def times(launches, n):
    """Each count of a launch table n times (n calls), a Counter."""
    from collections import Counter

    return Counter({k: v * n for k, v in launches.items()})


def require_exactly(report, want, run):
    """The `run` path launched each (kernel, shape key) of `want` exactly
    its count of times and no other kernel or shape on the card: a stage
    that launched twice, or not at all, or at another shape, fails."""
    from collections import Counter

    from qradiolink_tpu_torch.ops import cuda_resample

    got = {(op, k[len("cuda "):]): n for op, r in report.items()
           for k, n in r.get("shapes", {}).items()
           if k.startswith("cuda ") and n}
    want = dict(Counter(want))
    if got != want:
        diff = {f"{op} {key}": (got.get((op, key), 0), n) for (op, key), n
                in {**got, **want}.items()
                if got.get((op, key), 0) != want.get((op, key), 0)}
        raise RuntimeError(f"{run}: launches (got, want) differ from the "
                           f"chains' launch table: {diff}")
    print(f"  {run}: every launch as the chains' stages give it: "
          + ", ".join(f"{op} {key} x{n}" for (op, key), n in want.items()),
          flush=True)
    # the shapes resample_rat_f32 took over: the table is the whole report,
    # so resample_poly_f32 launched at none of them
    moved = [key for op, key in want if op == cuda_resample.RAT_OP]
    if moved:
        print(f"  {run}: {cuda_resample.RAT_OP} at {', '.join(moved)}; "
              f"{cuda_resample.OP} 0 times there", flush=True)


def loop_capture_row(op, key, meta, run):
    """A loop kernel's row at a path's shape, on the arguments its first
    call there had (call_capture): loop_row, bit-equal to the plain loop;
    bytes: each input read once and each output written once, operations
    as psk_rows and agc_rows count them. The FLL's row is
    fll_capture_row's."""
    from qradiolink_tpu_torch.fec import viterbi_stream_cuda as vsc
    from qradiolink_tpu_torch.ops import cuda_agc
    from qradiolink_tpu_torch.sync import cuda_costas as cc
    from qradiolink_tpu_torch.sync import cuda_fll as cf
    from qradiolink_tpu_torch.sync import cuda_symbol_sync as css

    fn, a = meta["fn"], meta["args"]
    if op == cf.OP:
        return [fll_capture_row(fn, a, run, key)]
    if op == cc.OP:
        x = a[0]
        C, T = math.prod(x.shape[:-1]), x.shape[-1]

        def plain():
            r = cc.costas_loop_plain(x.real, x.imag, *a[1:])
            return (torch.complex(r[0], r[1]),) + r[2:]
        b = (2 * 8 * C * T + 16 * C, 60 * C * T)
    elif op == css.OP:
        tail, x = a[:2]
        C, T, n = x.shape[0], x.shape[-1], a[6]

        def plain():
            xc = torch.cat([tail, x.to(torch.complex64)], dim=-1)
            r = css.symbol_sync_plain(xc.real.contiguous(),
                                      xc.imag.contiguous(), *a[2:])
            return (torch.complex(r[0], r[1]),) + r[2:]
        planes = 2 if x.is_complex() else 1
        b = (4 * C * (planes * T + 2 * tail.shape[-1]) + 8 * C * n,
             60 * C * n)
        if planes == 1 and a[7] == css.MODE_LEVELS:
            src, where = LOOP_SOURCE[op]
            r = loop_row(f"{op}/{run}", src, where, lambda: fn(*a), plain,
                         *b, run, key)
            return [r, levels_v0_row(
                f"{op}/{run}", lambda: fn(*a),
                lambda: css.symbol_sync_levels_v0(*a[:7], *a[8:]), r, run,
                key, n)]
    elif op == vsc.OP:
        soft, lag = a[3], a[2].shape[1]
        C, pairs = soft.shape[0], soft.shape[1]
        S = pairs + lag

        def plain():
            return vsc.viterbi_stream_plain(*a)
        b = (C * (8 * S + 2 * 8 * S + pairs + 2 * 4 * 64), 10 * 64 * C * S)
    else:
        x = a[0]
        n, cplx = x.numel(), x.is_complex()
        C = n // x.shape[-1]

        def plain():
            return cuda_agc.agc2_plain(*a)
        b = ((16 if cplx else 8) * n + 8 * C,
             ((12 + 2) if cplx else 2) * n + 7 * n)
    src, where = LOOP_SOURCE[op]
    return [loop_row(f"{op}/{run}", src, where, lambda: fn(*a), plain, *b,
                     run, key)]


def fll_capture_row(fn, a, run, key):
    """fll_band_edge_f32's row at a path's shape, on the arguments its
    first call there had (call_capture): within FLL_ATOL + FLL_RTOL |plain|
    of one timed call of the plain loop (fll_diffs), bytes and operations
    as fll_rows counts them."""
    from qradiolink_tpu_torch.sync import cuda_fll as cf

    xr, xi, taps = a[0], a[1], a[5]
    C, T, K = math.prod(xr.shape[:-1]), xr.shape[-1], taps.shape[-1]
    name = f"{cf.OP}/{run}"
    ms = cuda_ms(lambda: fn(*a), iters=5, warmup=1)
    got = fn(*a)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = cf.fll_plain(xr, torch.zeros_like(xr) if xi is None else xi,
                        *a[2:])
    end.record()
    end.synchronize()
    d = fll_diffs(f"{name} at {key}", got, want, gate=True)
    print(f"  {name}: at {key} within {FLL_ATOL} + {FLL_RTOL} |plain| of "
          f"the plain loop, max |diff| {json.dumps(d)}", flush=True)
    planes = 1 if xi is None else 2
    b = bound(4 * planes * C * T + 8 * C * T + 16 * K + 16 * C * K,
              2 * 2 * 4 * K * C * T)
    return row(name, "qradiolink_tpu_torch/csrc/fll_band_edge.cu",
               "qradiolink_tpu/sync/fll.py:93", max(d.values()), ms,
               start.elapsed_time(end), b, None, run, key)


def captured_rows(seen, want, run, done, dev, gen):
    """A row for each kernel shape of `run` that call_capture saw in its
    first step and no earlier row has: a FIR or resampler shape's routed
    kernel on seeded inputs of that shape against its plain version
    (fir_row, poly_row: F.conv1d beside, and the kernel the route replaced
    in turns where there is one), a loop's on the path's own inputs
    against its plain loop (loop_capture_row). Each row on the path must
    have launched want[(kernel, shape)] times in the run."""
    from qradiolink_tpu_torch.ops import cuda_fir

    rows = []
    for (op, key), (_, meta) in seen.items():
        if (op, key) not in want:
            raise RuntimeError(f"{run}: {op} at {key} is not in the launch "
                               f"table")
        if (op, key) in done:
            continue
        done.add((op, key))
        name = f"{run} {key}"
        if meta["kind"] == "loop":
            new = loop_capture_row(op, key, meta, run)
        elif meta["kind"] == "poly":
            new = poly_row(name, types.SimpleNamespace(
                L=meta["L"], M=meta["M"], kp=meta["taps"].shape[1],
                poly_taps=meta["taps"]), meta["planes"],
                math.prod(meta["lead"]), meta["T"], run, dev, gen)
        else:
            C = math.prod(meta["lead"])
            K, D = meta["taps"].shape[0], meta["stride"]
            xs = tuple(torch.randn((C, meta["T"]), generator=gen,
                                   device=dev) for _ in range(meta["planes"]))
            tails = None
            if meta["tail"]:
                st = torch.randn((C, 2, K - 1), generator=gen, device=dev)
                tails = (st[:, 0, :], st[:, 1, :])[:meta["planes"]]
            new = fir_row(name, "qradiolink_tpu/ops/pallas_fir.py:"
                          + ("111" if D == 1 else "218"), xs, meta["taps"],
                          D, meta["n_out"], tails, run)
            if op != cuda_fir.route(K, D):
                raise RuntimeError(f"{name}: captured {op}")
            del xs, tails
        for r in new:
            if r["path"] is not None:
                r["want"] = want[(op, key)]
        rows += new
        torch.cuda.empty_cache()
    return rows


def rx_planes(iq):
    """An IqPair of contiguous planes from a TX chain's output."""
    from qradiolink_tpu_torch.core import IqPair

    if isinstance(iq, IqPair):
        return IqPair(iq.re.contiguous(), iq.im.contiguous())
    return IqPair(iq.real.contiguous(), iq.imag.contiguous())


def sampled_rows(n_rows):
    """SAMPLE_ROWS rows spread over n_rows."""
    return torch.linspace(0, n_rows - 1, min(SAMPLE_ROWS, n_rows)).long()


def mode_ber(outs, sent, rows):
    """The steady-state BER of each sampled row, the least over `bits` and
    `bits_alt` where the chain has both."""
    keys = [k for k in ("bits", "bits_alt", "bits_inv", "bits_alt_inv")
            if k in outs[0]]
    bers = [best_ber_rows(psk_bits(outs, k)[rows].cpu(), sent[rows].cpu(),
                          400) for k in keys]
    return torch.stack(bers).min(dim=0).values


def payloads(rows, n_bytes):
    """Draw i: (rows, n_bytes) payload bytes, on the CPU (PAYLOAD_SEED)."""
    g = torch.Generator()
    g.manual_seed(PAYLOAD_SEED)
    while True:
        yield torch.randint(0, 256, (rows, n_bytes), generator=g,
                            dtype=torch.int64).to(torch.uint8)


def data_source(mode, rows, T, n_bytes, snr, seed, dev, sent):
    """Step i's RX input of a data mode: the i-th payload draw (payloads())
    through the registry's TX chain of `mode` at `rows` rows and
    ChannelModel at snr dB (None: clean; seed: its noise's), T samples a
    row (checked); each step's bits are appended to `sent` (CPU). Returns
    (TX chain, source)."""
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.models import registry

    tx = registry.tx_chain(mode, lead_shape=(rows,), device=dev)
    chan = ChannelModel(1_000_000, snr_db=snr, seed=seed)
    draws = payloads(rows, n_bytes)
    st = [tx.init_state()]

    def source(i):
        d = next(draws)
        sent.append(bytes_to_bits(d))
        st[0], out = tx(st[0], d.to(dev))
        iq = rx_planes(chan(out["iq"]) if snr is not None else out["iq"])
        if iq.re.shape[-1] != T:
            raise RuntimeError(f"{mode}: {iq.re.shape[-1]} IQ samples a "
                               f"step, not {T}")
        return iq
    return tx, source


def run_steps(rx, steps, source, keep=None):
    """`steps` steps of the RX chain `rx` (None: a TX-only mode, whose
    source's output is the result), step i's input source(i) made just
    before it; the first step under call_capture, the RX step timed. keep:
    True keeps each step's RX input, a tensor of row indices those rows'
    on the CPU. Returns (captured calls, RX state, outputs, inputs kept,
    RX step seconds)."""
    from qradiolink_tpu_torch.core import IqPair

    rs = rx.init_state() if rx is not None else None
    seen, outs, iqs, step_s = {}, [], [], []
    for i in range(steps):
        with (call_capture() if i == 0 else contextlib.nullcontext()) as s:
            iq = source(i)
            if rx is None:
                y = iq
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rs, y = rx(rs, iq)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        if s is not None:
            seen.update(s)
        outs.append(y)
        if keep is True:
            iqs.append(iq)
        elif keep is not None:
            iqs.append(IqPair(iq.re[keep].cpu(), iq.im[keep].cpu()))
        del iq
    return seen, rs, outs, iqs, step_s


def finite(name, out):
    """Every float output of a chain finite."""
    from qradiolink_tpu_torch.core import IqPair

    for k, v in out.items():
        for p in (v if isinstance(v, IqPair) else (v,)):
            if p.is_complex():
                p = torch.view_as_real(p)
            if p.is_floating_point() and not bool(torch.isfinite(p).all()):
                raise RuntimeError(f"{name}: {k} not finite")


def run_report(name, steps):
    """The launch report since the last reset; raises if a stage took a
    plain path on the card."""
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    report = kernel_paths.report()
    print(f"  kernel paths over {steps} steps: {json.dumps(report)}",
          flush=True)
    if not kernel_paths.served_only():
        raise RuntimeError(f"{name}: a stage took the plain path on the card")
    return report


def cpu_twin(mode, iqs):
    """The port's CPU path of `mode` on the kept RX inputs (CPU IqPairs of
    n rows, one a step): (outputs a step, final state)."""
    from qradiolink_tpu_torch.models import registry

    cpu = registry.rx_chain(mode, lead_shape=(iqs[0].re.shape[0],),
                            device="cpu")
    st, outs = cpu.init_state(), []
    for iq in iqs:
        st, y = cpu(st, iq)
        outs.append(y)
    return outs, st


def rel_diffs(pairs, diffs):
    """For each (name, card, CPU) tensor pair, max |card - CPU| over the
    CPU's peak (at least 1), the largest so far kept in diffs[name]."""
    for name, a, b in pairs:
        a = a.cpu()
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        d = float((a.double() - b.double()).abs().max()) if a.numel() \
            else 0.0
        peak = max(float(b.abs().max()) if b.numel() else 0.0, 1.0)
        diffs[name] = max(diffs.get(name, (0.0, peak)), (d / peak, peak))
    return diffs


def check_diffs(mode, diffs, what):
    """Prints diffs (rel_diffs) and holds the symbols and every state leaf
    to CVC_TOLS[mode]."""
    print(f"  {mode} card vs CPU, {what}: bits equal; max |diff| / peak: "
          + ", ".join(f"{k} {v[0]:.2e}" for k, v in diffs.items()),
          flush=True)
    sym_tol, tol = CVC_TOLS[mode]
    bad = {k: v for k, v in diffs.items() if not v[0] <= (
        sym_tol if k == "symbols" else tol)}
    if bad:
        raise RuntimeError(f"{mode} card vs CPU beyond the bound: {bad}")


def sweep_data_mode(mode, dev, gen, done):
    """A data mode of the sweep at SWEEP_ROWS rows: TX -> ChannelModel ->
    RX for SWEEP_STEPS steps, the counters zeroed before and read after,
    every launch as chain_launches gives it; every output finite. On
    SAMPLE_ROWS rows the port's CPU path runs on the same IQ (the parity
    tests hold it to the JAX chain's bits): each row's decoding stream
    (its best) has the same bits on the card and the CPU, and its BER is
    below the JAX test's limit, but for at most SLIP_WITNESSED[mode] rows
    (a mode whose JAX chain is shown to fail such payloads). Then the rows
    of its kernel shapes. Returns (report, rows)."""
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    T, n_bytes, snr, limit = SWEEP_MODES[mode]
    rows = sampled_rows(SWEEP_ROWS)
    sent = []
    tx, source = data_source(mode, SWEEP_ROWS, T, n_bytes, snr, 41, dev,
                             sent)
    rx = registry.rx_chain(mode, lead_shape=(SWEEP_ROWS,), device=dev)
    kernel_paths.reset()
    seen, _, outs, iqs, step_s = run_steps(rx, SWEEP_STEPS, source,
                                           keep=rows.to(dev))
    report = run_report(mode, SWEEP_STEPS)
    run = f"sweep_{mode}"
    want = times(chain_launches(rx, SWEEP_ROWS, T) + chain_launches(
        tx, SWEEP_ROWS), SWEEP_STEPS)
    require_exactly(report, want, run)
    for out in outs:
        finite(mode, out)
    ref, _ = cpu_twin(mode, iqs)
    keys = [k for k in ("bits", "bits_alt") if k in ref[0]]
    card = {k: psk_bits(outs, k)[rows].cpu() for k in keys}
    host = {k: psk_bits(ref, k) for k in keys}
    sent = torch.cat(sent, dim=-1)[rows]
    # a row decodes on its best stream (the binary chains' other pairing
    # decodes misaligned pairs, whose Viterbi decisions tie and flip on a
    # rounding)
    ber_card = torch.stack([best_ber_rows(card[k], sent, 400) for k in keys])
    best = ber_card.argmin(dim=0)
    bers = ber_card.min(dim=0).values
    ber_report(f"{mode} ({'clean' if snr is None else f'{snr} dB'})", bers)
    fails = []
    for j in range(len(rows)):
        k = keys[int(best[j])]
        if not torch.equal(card[k][j], host[k][j]):
            raise RuntimeError(f"{mode}: row {int(rows[j])}'s {k} differ "
                               f"between the card and the CPU")
        if not bers[j] < limit:
            fails.append(int(rows[j]))
    print(f"  {mode}: on {len(rows)} rows the decoding stream's bits equal "
          f"on the card and the CPU; rows at or above the JAX test's BER "
          f"limit {limit}: {fails} of payload seed {PAYLOAD_SEED} (per row "
          f"{[round(float(b), 4) for b in bers]})", flush=True)
    if len(fails) > SLIP_WITNESSED.get(mode, 0):
        raise RuntimeError(f"{mode}: rows {fails} fail")
    print(f"  {mode}: RX {step_times(step_s, SWEEP_ROWS * T)}", flush=True)
    del outs, iqs
    torch.cuda.empty_cache()
    return report, captured_rows(seen, want, run, done, dev, gen)


def dsss_mode(dev, gen, done):
    """BPSKDSSS8 at SWEEP_ROWS rows x SWEEP_STEPS steps of DSSS_T (4 coded
    bits a step): one payload byte a row (1 s of IQ) through the TX once,
    its IQ cut into the RX's steps; every launch as chain_launches gives
    it, outputs finite. On the SAMPLE_ROWS sampled rows the port's CPU path
    runs on the same IQ: the four bit streams equal, the symbols and every
    state leaf (the card's cut to those rows) within CVC_TOLS. Then the
    JAX test's gate on SAMPLE_ROWS rows: DSSS_GATE_BYTES bytes a row (24 s
    of IQ) in one block, the best of the four streams below 1% BER over
    [n/4, n/2) (tests/test_chains_dsss_cw.py). Then the rows of its kernel
    shapes, its loops on the path's own inputs. Returns (report, rows)."""
    from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits
    from qradiolink_tpu_torch.core import IqPair, _flatten
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    mode, T, run = "BPSKDSSS8", DSSS_T, "sweep_BPSKDSSS8"
    rows = sampled_rows(SWEEP_ROWS)
    tx = registry.tx_chain(mode, lead_shape=(SWEEP_ROWS,), device=dev)
    rx = registry.rx_chain(mode, lead_shape=(SWEEP_ROWS,), device=dev)
    held = {}

    def source(i):
        if i == 0:
            d = next(payloads(SWEEP_ROWS, 1)).to(dev)
            held["iq"] = rx_planes(tx(tx.init_state(), d)[1]["iq"])
        iq = held["iq"]
        return IqPair(iq.re[:, i * T:(i + 1) * T].contiguous(),
                      iq.im[:, i * T:(i + 1) * T].contiguous())

    kernel_paths.reset()
    seen, state, outs, iqs, _ = run_steps(rx, SWEEP_STEPS, source,
                                          keep=rows.to(dev))
    report = run_report(mode, SWEEP_STEPS)
    held.clear()
    # the TX ran once, the RX SWEEP_STEPS times
    want = times(chain_launches(rx, SWEEP_ROWS, T), SWEEP_STEPS) + \
        chain_launches(tx, SWEEP_ROWS)
    require_exactly(report, want, run)
    for out in outs:
        finite(mode, out)
    ref, ref_state = cpu_twin(mode, iqs)
    diffs = {}
    for blk, (y, h) in enumerate(zip(outs, ref)):
        for k in ("bits", "bits_alt", "bits_inv", "bits_alt_inv"):
            if not torch.equal(y[k][rows].cpu(), h[k]):
                raise RuntimeError(f"{mode} card vs CPU block {blk}: {k} "
                                   f"differ")
        rel_diffs([("symbols", y["symbols"][rows], h["symbols"])], diffs)
    leaves = []
    for i, (a, b) in enumerate(zip(_flatten(state, []),
                                   _flatten(ref_state, []))):
        # the card's leaf cut to the sampled rows on its row axis
        ax = [d for d in range(a.ndim) if a.shape[d] != b.shape[d]]
        leaves.append((f"state leaf {i}", a.index_select(
            ax[0], rows.to(a.device)) if ax else a, b))
    check_diffs(mode, rel_diffs(leaves, diffs),
                f"{len(rows)} sampled rows x {SWEEP_STEPS} steps")
    del outs, iqs, state
    torch.cuda.empty_cache()
    txg = registry.tx_chain(mode, lead_shape=(SAMPLE_ROWS,), device=dev)
    rxg = registry.rx_chain(mode, lead_shape=(SAMPLE_ROWS,), device=dev)
    data = next(payloads(SAMPLE_ROWS, DSSS_GATE_BYTES))
    iq = txg(txg.init_state(), data.to(dev))[1]["iq"]
    m = iq.shape[-1] - iq.shape[-1] % 125_000
    t0 = time.perf_counter()
    out = rxg(rxg.init_state(), rx_planes(iq[:, :m]))[1]
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    sent = bytes_to_bits(data).numpy()
    bers = []
    for r in range(SAMPLE_ROWS):
        n = sent.shape[-1]
        lo, hi = n // 4, n // 2
        best = 1.0
        for k in ("bits", "bits_alt", "bits_inv", "bits_alt_inv"):
            dec = out[k][r].cpu().numpy()
            for off in range(200):
                seg = dec[off + lo: off + hi]
                if len(seg) < hi - lo:
                    break
                best = min(best, float(np.mean(seg != sent[r, lo:hi])))
        bers.append(best)
    print(f"  {mode} gate: {SAMPLE_ROWS} rows x {m} samples in one block "
          f"({gate_s:.3f} s), best-stream BER per row {bers}", flush=True)
    if not max(bers) < 0.01:
        raise RuntimeError(f"{mode}: BER {max(bers)} is not below 0.01")
    del iq, out
    torch.cuda.empty_cache()
    return report, captured_rows(seen, want, run, done, dev, gen)


def freedv_tone(rows, n, dev):
    """A 1 kHz passband tone at 0.5, rows x n at 8 kHz."""
    t = torch.arange(n, device=dev) / 8000.0
    return (0.5 * torch.sin(2 * np.pi * 1000.0 * t)).expand(rows, n
                                                           ).contiguous()


def freedv_mode(mode, dev, gen, done):
    """A FreeDV mode's DSP ends at SWEEP_ROWS rows: FreeDvMod on a passband
    tone -> ChannelModel at FREEDV_SNR_DB -> FreeDvDemod, SWEEP_STEPS steps
    of FREEDV_T, every launch as chain_launches gives it; the second step's
    passband tone SNR above FREEDV_TONE_DB on SAMPLE_ROWS rows (the
    libcodec2 halves stay on the host and are not ported); then the card
    against the CPU on 4 rows x 2 steps (passband, IQ and every state leaf
    within FREEDV_TOL of the peak). Returns (report, rows)."""
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.core import _flatten
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    n_pb = FREEDV_T // 125
    tone = freedv_tone(SWEEP_ROWS, n_pb, dev)
    tx = registry.tx_chain(mode, lead_shape=(SWEEP_ROWS,), device=dev)
    rx = registry.rx_chain(mode, lead_shape=(SWEEP_ROWS,), device=dev)
    chan = ChannelModel(1_000_000, snr_db=FREEDV_SNR_DB, seed=43)
    st = [tx.init_state()]

    def source(i):
        st[0], out = tx(st[0], tone)
        return rx_planes(chan(out["iq"]))

    kernel_paths.reset()
    seen, _, outs, _, _ = run_steps(rx, SWEEP_STEPS, source)
    report = run_report(mode, SWEEP_STEPS)
    run = f"sweep_{mode}"
    want = times(chain_launches(rx, SWEEP_ROWS, FREEDV_T) + chain_launches(
        tx, SWEEP_ROWS), SWEEP_STEPS)
    require_exactly(report, want, run)
    for y in outs:
        finite(mode, y)
    pb = outs[-1]["passband"][sampled_rows(SWEEP_ROWS)].cpu().numpy()
    snrs = [tone_snr(p[n_pb // 2:], 1000.0) for p in pb]
    print(f"  {mode}: passband tone SNR on {len(snrs)} rows, worst "
          f"{min(snrs):.1f} dB", flush=True)
    if not min(snrs) > FREEDV_TONE_DB:
        raise RuntimeError(f"{mode}: tone SNR {min(snrs):.1f} dB")
    del outs
    # the card against the CPU
    cpu = torch.device("cpu")
    pair = {d.type: (registry.tx_chain(mode, lead_shape=(CVC_ROWS,),
                                       device=d),
                     registry.rx_chain(mode, lead_shape=(CVC_ROWS,),
                                       device=d)) for d in (dev, cpu)}
    sts = {k: (t.init_state(), r.init_state()) for k, (t, r) in pair.items()}
    worst = 0.0
    for blk in range(2):
        pbs = (freedv_tone(CVC_ROWS, n_pb, dev)
               + 0.1 * torch.randn((CVC_ROWS, n_pb), generator=gen,
                                   device=dev))
        got = {}
        for d in (dev, cpu):
            t, r = pair[d.type]
            s_t, s_r = sts[d.type]
            s_t, o = t(s_t, pbs.to(d))
            s_r, y = r(s_r, rx_planes(o["iq"]))
            sts[d.type] = (s_t, s_r)
            got[d.type] = (o["iq"], y["passband"])
        pairs = [(f"block {blk} iq", got[dev.type][0], got["cpu"][0]),
                 (f"block {blk} passband", got[dev.type][1], got["cpu"][1])]
        pairs += [(f"block {blk} state leaf {i}", a, b) for i, (a, b) in
                  enumerate(zip(_flatten(sts[dev.type], []),
                                _flatten(sts["cpu"], [])))]
        for name, a, b in pairs:
            a = a.cpu()
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            d = float((a.double() - b.double()).abs().max())
            peak = max(float(b.abs().max()), 1e-30)
            worst = max(worst, d / peak)
            if not d <= FREEDV_TOL * peak:
                raise RuntimeError(f"{mode} card vs CPU {name}: {d:.3e} "
                                   f"of a peak {peak:.3e}")
    print(f"  {mode} card vs CPU, {CVC_ROWS} rows x 2 blocks: max |diff| / "
          f"peak {worst:.2e} (bound {FREEDV_TOL})", flush=True)
    torch.cuda.empty_cache()
    return report, captured_rows(seen, want, run, done, dev, gen)


def mmdvm_tone(rows, n, dev, freq=1000.0, amp=0.15):
    """tests/test_chains_mmdvm._tone on every row (amp 0.15: a 1.9 kHz
    deviation) at 24 kHz, row r's phase r / 8 rad."""
    t = torch.arange(n, device=dev, dtype=torch.float64) / 24_000.0
    ph = torch.arange(rows, device=dev, dtype=torch.float64)[:, None] / 8
    return (amp * torch.sin(2 * np.pi * freq * t + ph)).float()


def mmdvm_snr(audio, freq):
    """tests/test_chains_mmdvm._tone_snr_db."""
    x = np.asarray(audio, np.float64)
    x = x - x.mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    f = np.fft.rfftfreq(len(x), 1 / 24_000)
    sig = spec[np.abs(f - freq) < 150].sum()
    noise = spec[(np.abs(f - freq) >= 150) & (f > 50) & (f < 4000)].sum()
    return 10 * np.log10(sig / (noise + 1e-12))


def audio_source(tx, audio, n):
    """Step i's RX input: TX chain tx on audio[..., i n:(i + 1) n]."""
    st = [tx.init_state()]

    def source(i):
        st[0], out = tx(st[0], audio[..., i * n:(i + 1) * n].contiguous())
        return rx_planes(out["iq"])
    return source


def mmdvm_mode(dev, gen, done):
    """MMDVM single-carrier at SWEEP_ROWS rows: MmdvmMod (IqPair, the
    registry's form) on a 1 kHz tone -> MmdvmDemod, SWEEP_STEPS steps of
    MMDVM_T at 250 ksps, every launch as chain_launches gives it; tone SNR
    above 30 dB on SAMPLE_ROWS rows of the second step
    (tests/test_chains_mmdvm.py:31-43). Returns (report, rows)."""
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    n24 = MMDVM_T * 12 // 125
    tx = registry.tx_chain("MMDVM", lead_shape=(SWEEP_ROWS,), device=dev)
    rx = registry.rx_chain("MMDVM", lead_shape=(SWEEP_ROWS,), device=dev)
    source = audio_source(tx, mmdvm_tone(SWEEP_ROWS, 2 * n24, dev), n24)
    kernel_paths.reset()
    seen, _, outs, _, _ = run_steps(rx, SWEEP_STEPS, source)
    report = run_report("MMDVM", SWEEP_STEPS)
    want = times(chain_launches(rx, SWEEP_ROWS, MMDVM_T) + chain_launches(
        tx, SWEEP_ROWS), SWEEP_STEPS)
    require_exactly(report, want, "sweep_MMDVM")
    for y in outs:
        finite("MMDVM", y)
    y = outs[-1]
    rec = y["audio"][sampled_rows(SWEEP_ROWS)].cpu().numpy()
    snrs = [mmdvm_snr(r[2000:], 1000.0) for r in rec]
    print(f"  MMDVM: tone SNR on {len(snrs)} rows, worst {min(snrs):.1f} dB "
          f"(rssi_slots {tuple(y['rssi_slots'].shape)})", flush=True)
    if not min(snrs) > 30.0:
        raise RuntimeError(f"MMDVM: tone SNR {min(snrs):.1f} dB")
    return report, captured_rows(seen, want, "sweep_MMDVM", done, dev, gen)


def cw_mode(dev, gen, done):
    """CW at SWEEP_ROWS rows: CwMod on a key a row (down for 75 ms from
    37.5 ms into each 200 ms step), SWEEP_STEPS steps of CW_T, every launch
    as chain_launches gives it; on SAMPLE_ROWS rows the key-down power
    above 100 times the key-up power (tests/test_chains_dsss_cw.py:42).
    Returns (report, rows)."""
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    n8 = CW_T // 125
    key = torch.zeros((SWEEP_ROWS, n8), device=dev)
    key[:, 300:900] = 1.0
    tx = registry.tx_chain("CW", lead_shape=(SWEEP_ROWS,), device=dev)
    st = [tx.init_state()]

    def source(i):
        st[0], out = tx(st[0], key)
        return out

    kernel_paths.reset()
    seen, _, outs, _, _ = run_steps(None, SWEEP_STEPS, source)
    report = run_report("CW", SWEEP_STEPS)
    want = times(chain_launches(tx, SWEEP_ROWS), SWEEP_STEPS)
    require_exactly(report, want, "sweep_CW")
    for out in outs:
        finite("CW", out)
    p = torch.abs(outs[-1]["iq"][sampled_rows(SWEEP_ROWS)]) ** 2
    on = p[:, 500 * 125:800 * 125].mean(dim=-1)
    off = p[:, 1100 * 125:1500 * 125].mean(dim=-1)
    ratio = float((on / torch.clamp(off, min=1e-12)).min())
    print(f"  CW: key-down / key-up power on {p.shape[0]} rows, least "
          f"{ratio:.3e}", flush=True)
    if not ratio > 100.0:
        raise RuntimeError(f"CW: keying ratio {ratio:.3e}")
    return report, captured_rows(seen, want, "sweep_CW", done, dev, gen)


def sweep_phase(dev, gen, done):
    """Every other new mode at SWEEP_ROWS rows x SWEEP_STEPS steps through
    the registry. Returns ({run: report}, rows)."""
    reports, rows = {}, []
    for mode in SWEEP_MODES:
        print(f"sweep: {mode}, {SWEEP_ROWS} rows x {SWEEP_STEPS} steps of "
              f"{SWEEP_MODES[mode][0]} samples", flush=True)
        reports[f"sweep_{mode}"], r = sweep_data_mode(mode, dev, gen, done)
        rows += r
    for name, fn in (("BPSKDSSS8", dsss_mode), ("MMDVM", mmdvm_mode),
                     ("CW", cw_mode)):
        print(f"sweep: {name}, {SWEEP_ROWS} rows x {SWEEP_STEPS} steps",
              flush=True)
        reports[f"sweep_{name}"], r = fn(dev, gen, done)
        rows += r
    for mode in ("FreeDV1600USB", "FreeDV700DLSB"):
        print(f"sweep: {mode}, {SWEEP_ROWS} rows x {SWEEP_STEPS} steps of "
              f"{FREEDV_T} samples", flush=True)
        reports[f"sweep_{mode}"], r = freedv_mode(mode, dev, gen, done)
        rows += r
    return reports, rows


def fsk_card_vs_cpu(mode, iqs, dev):
    """The registry's RX chain of `mode` on CVC_ROWS rows x 2 steps (the
    path's first two) on the card and on the port's CPU path: bits equal,
    symbols and the state leaves within their bounds of the peak
    (CVC_TOLS; max |diff| / peak printed)."""
    from qradiolink_tpu_torch.core import IqPair, _flatten
    from qradiolink_tpu_torch.models import registry

    cpu = torch.device("cpu")
    chains = {d.type: registry.rx_chain(mode, lead_shape=(CVC_ROWS,),
                                        device=d) for d in (dev, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    diffs = {}
    for blk in range(2):
        outs = {}
        for d in (dev, cpu):
            iq = IqPair(iqs[blk].re[:CVC_ROWS].to(d).contiguous(),
                        iqs[blk].im[:CVC_ROWS].to(d).contiguous())
            states[d.type], outs[d.type] = chains[d.type](states[d.type], iq)
        card, host = outs[dev.type], outs["cpu"]
        for k in ("bits", "bits_alt"):
            if k in host and not torch.equal(card[k].cpu(), host[k]):
                n = int((card[k].cpu() != host[k]).sum())
                raise RuntimeError(f"{mode} card vs CPU block {blk}: {n} "
                                   f"{k} differ")
        pairs = [("symbols", card["symbols"], host["symbols"])]
        pairs += [(f"state leaf {i}", a, b) for i, (a, b) in enumerate(
            zip(_flatten(states[dev.type], []), _flatten(states["cpu"], [])))]
        rel_diffs(pairs, diffs)
    check_diffs(mode, diffs, f"{CVC_ROWS} rows x 2 blocks of {T_STEP}")


def fsk10k_head_phase(dev):
    """GMSK10K's and 2FSK10K's RX chains card against CPU as
    tests/test_torch_cuda.py test_new_mode_on_card_matches_cpu runs them
    (a generator on the card seeded 0, 2 rows of 30 random bytes through
    the TX chain on the card, noise at 0.05 a plane, two blocks of 10,000):
    bits equal, symbols and every state leaf within CVC_TOLS (the
    Viterbi's path metrics 2e-5 of their peak); the 2/25 K561 head on its
    route once a block (counters zeroed before, read after). On each
    chain's own head input of the first block, resample_dec_f32's
    taps-in-order form bit-equal to resample_poly_f32, whose order the
    CPU path's F.conv1d gives."""
    from qradiolink_tpu_torch.core import IqPair, _flatten
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.ops import cuda_resample
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    cpu, T, rows = torch.device("cpu"), 10_000, 2
    for mode in ("GMSK10K", "2FSK10K"):
        g = torch.Generator(device=dev)
        g.manual_seed(0)
        data = torch.randint(0, 256, (rows, 30), generator=g, device=dev,
                             dtype=torch.int64).to(torch.uint8)
        tx = registry.tx_chain(mode, lead_shape=(rows,), device=dev)
        iq = tx(tx.init_state(), data)[1]["iq"]
        iq = (iq.to_complex() if isinstance(iq, IqPair) else iq)[..., :2 * T]
        iq = iq + 0.05 * torch.randn(iq.shape, generator=g, device=dev,
                                     dtype=torch.complex64)
        chains = {d.type: registry.rx_chain(mode, lead_shape=(rows,),
                                            device=d) for d in (dev, cpu)}
        rs = chains[dev.type].resamp
        L, M, K = rs.L, rs.M, rs.kp
        if (L, M, K) not in cuda_resample.DEC_IN_ORDER:
            raise RuntimeError(f"{mode}: head L{L} M{M} K{K} is not a "
                               f"taps-in-order instance")
        op = cuda_resample.route(L, M, K, rows)
        states = {k: c.init_state() for k, c in chains.items()}
        diffs = {}
        kernel_paths.reset()
        for blk in range(2):
            xb = iq[..., blk * T:(blk + 1) * T]
            outs = {}
            for d in (dev, cpu):
                xp = IqPair(xb.real.to(d).contiguous(),
                            xb.imag.to(d).contiguous())
                states[d.type], outs[d.type] = chains[d.type](states[d.type],
                                                              xp)
            card, host = outs[dev.type], outs["cpu"]
            for k in ("bits", "bits_alt"):
                if not torch.equal(card[k].cpu(), host[k]):
                    raise RuntimeError(f"{mode} block {blk}: {k} differ")
            pairs = [("symbols", card["symbols"], host["symbols"])]
            for i, (a, b) in enumerate(zip(_flatten(states[dev.type], []),
                                           _flatten(states["cpu"], []))):
                if a.is_floating_point() or a.is_complex():
                    pairs.append((f"state leaf {i}", a, b))
                elif not torch.equal(a.cpu(), b):
                    raise RuntimeError(f"{mode} block {blk}: state leaf "
                                       f"{i} differs")
            rel_diffs(pairs, diffs)
        rep = kernel_paths.report()
        key = f"cuda L{L} K{K} D{M} tail 2x{rows}"
        if rep.get(op, {}).get("shapes", {}).get(key, 0) != 2:
            raise RuntimeError(f"{mode}: the head did not run {op} once a "
                               f"block: {json.dumps(rep)}")
        check_diffs(mode, diffs, f"{rows} rows x 2 blocks of {T}, the head "
                    f"on {op}")
        x0 = iq[..., :T]
        xs = (x0.real.contiguous(), x0.imag.contiguous())
        st = rs.init_state()
        tails = (st[:, 0], st[:, 1])
        got = cuda_resample.launch(cuda_resample.DEC_OP, xs, rs.poly_taps,
                                   L, M, tails)
        want = cuda_resample.launch(cuda_resample.OP, xs, rs.poly_taps, L,
                                    M, tails)
        if not all(torch.equal(a, b) for a, b in
                   zip((got[0], *got[1]), (want[0], *want[1]))):
            raise RuntimeError(f"{mode}: {cuda_resample.DEC_OP} is not "
                               f"bit-equal to {cuda_resample.OP} at the "
                               f"head")
        print(f"  {mode}: {cuda_resample.DEC_OP}'s taps-in-order form "
              f"bit-equal to {cuda_resample.OP} on the chain's head input",
              flush=True)


def full_path(mode, dev, gen, done):
    """4FSK2KFB (Fsk4FbDemod: the tone bank, the K837 complex symbol LP,
    the conj-mode sync) or GMSK2K (the K2239 head, the Viterbi on the
    delay-diversity pair) at N_CH rows x T_STEP samples, N_STEPS steps,
    state carried: each row's own transmission from the registry's TX chain
    through ChannelModel at the JAX test's SNR (a step's IQ made just
    before the step), the counters zeroed before the first step and read
    after the last (the modulator's launches count too), every launch as
    chain_launches gives it. Step ms and vs_baseline; BER below 0.02 on
    SAMPLE_ROWS rows (GMSK: the least over bits and bits_alt); one step
    stage by stage and one traced; the card against the CPU; then the rows
    of the path's kernel shapes, its loops on the path's own inputs.
    Returns (report, rows)."""
    from qradiolink_tpu_torch.core import Sequencer
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.ops.spectrum import rssi_dbm
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    n_bytes, snr = FULL_PATHS[mode]
    run = mode.lower()
    sent = []
    tx, source = data_source(mode, N_CH, T_STEP, n_bytes, snr, 47, dev, sent)
    chain = registry.rx_chain(mode, lead_shape=(N_CH,), device=dev)
    kernel_paths.reset()
    seen, state, outs, iqs, step_s = run_steps(chain, N_STEPS, source,
                                               keep=True)
    report = run_report(run, N_STEPS)
    want = times(chain_launches(chain, N_CH, T_STEP) + chain_launches(
        tx, N_CH), N_STEPS)
    require_exactly(report, want, run)
    for out in outs:
        finite(mode, out)
    ber = ber_report(f"{mode} ({snr} dB)", mode_ber(
        outs, torch.cat(sent, dim=-1), sampled_rows(N_CH)))
    if not ber < 0.02:
        raise RuntimeError(f"{mode}: BER {ber} is not below 0.02")
    med = statistics.median([s * 1e3 for s in step_s[1:]])
    print(f"  {step_times(step_s, N_CH * T_STEP)}, vs_baseline "
          f"{T_STEP / med / 1e3:.2f} Msamples/s per channel (printed, not "
          f"gated)", flush=True)
    fb = mode == "4FSK2KFB"
    iq = iqs[-1]

    def stage_step():
        seq, stages = Sequencer(state), {}
        x = timed(stages, "head", lambda: seq(chain.resamp, iq))
        x = timed(stages, f"channel LP K{chain.chan_filter.ntaps}",
                  lambda: seq(chain.chan_filter, x))
        timed(stages, "rssi", lambda: rssi_dbm(x))
        if fb:
            from qradiolink_tpu_torch.chains.fsk import _mag
            mags = timed(stages, "tone bank (4 x K"
                         f"{chain.tone_bank[0].ntaps} complex) + |x|",
                         lambda: torch.stack([_mag(seq(f, x)) for f in
                                              chain.tone_bank], dim=-2))
            pts = timed(stages, "discriminator",
                        lambda: chain.discriminator(mags))
            x = timed(stages, f"symbol LP K{chain.symbol_filter.ntaps} "
                      "(complex points)", lambda: seq(chain.symbol_filter,
                                                      pts))
        else:
            x = timed(stages, "quadrature demod", lambda: seq(chain.quad, x))
            x = timed(stages, f"symbol LP K{chain.shaping.ntaps}",
                      lambda: seq(chain.shaping, x))
        syms = timed(stages, "symbol sync (symbol_sync_mm_f32, "
                     f"{'conj' if fb else 'levels'})",
                     lambda: seq(chain.symbol_sync, x))
        if fb:
            soft = timed(stages, "soft pairs", lambda: torch.clamp(
                torch.stack([syms.real, syms.imag], -1).reshape(
                    N_CH, -1) * 181.0 + 128.0, 0.0, 255.0))
        else:
            from qradiolink_tpu_torch.chains.fsk import _delay_diversity
            soft = timed(stages, "soft pairs (delay diversity)",
                         lambda: _delay_diversity(torch.clamp(
                             syms * 128.0 + 128.0, 0.0, 255.0)))
        timed(stages, "FEC tail (viterbi_stream_k7 + descrambler)",
              lambda: seq(chain.fec_tail, soft))
        return stages

    stage_step()
    stages = stage_step()
    print(f"  stage ms (one step, CUDA events): {json.dumps(stages)}",
          flush=True)
    trace_step("one more step", lambda: chain(state, iq))
    del outs, state
    torch.cuda.empty_cache()
    fsk_card_vs_cpu(mode, iqs, dev)
    del iqs, iq
    torch.cuda.empty_cache()
    rows = captured_rows(seen, want, run, done, dev, gen)
    return report, rows


def mmdvm_multi_path(dev, gen, done):
    """MMDVMmulti at its real size: one site, MULTI_C carriers, MMDVM_T
    samples a step at 250 ksps, N_STEPS steps. The registry's TX
    (MmdvmMultiTx, IqPair out) on a tone a carrier, then MmdvmMultiRx on
    the IqPair (the fused channelizer), the counters zeroed before the
    first step and read after the last, every launch as chain_launches
    gives it: pfb_fft_f32 at M 10, kp 56 and depthwise_run_f32 at the
    synthesizer's kp 53 once a step each, pfb_channelize_f32 and
    depthwise_fir_f32 never. Gates of tests/test_chains_mmdvm.py: each
    carrier's tone SNR above 25 dB after 4,000 samples, carrier 0's tone
    below 10 dB in carrier 3; a mask zeroing carrier 1 of 3 leaves its RF
    power below 1e-4 of the others'. Then the two kernels at one site and
    at the farm shape against their plain versions and the kernels they
    replaced (mmdvm_pfb_rows). Returns (report, rows)."""
    from qradiolink_tpu_torch.chains.mmdvm import MmdvmMultiTx
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.ops import cuda_depthwise as dw
    from qradiolink_tpu_torch.ops import cuda_pfb
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    n24 = MMDVM_T * 24 // 250
    freqs = 600.0 + 300.0 * torch.arange(MULTI_C, device=dev)
    t = torch.arange(N_STEPS * n24, device=dev, dtype=torch.float64) / 24_000
    audio = (0.15 * torch.sin(2 * np.pi * freqs[:, None] * t)).float()
    tx = registry.tx_chain("MMDVMmulti", device=dev)
    rx = registry.rx_chain("MMDVMmulti", device=dev)
    kernel_paths.reset()
    seen, _, outs, _, step_s = run_steps(rx, N_STEPS,
                                         audio_source(tx, audio, n24))
    report = run_report("mmdvm_multi", N_STEPS)
    M, kp_ch, kp_syn = (rx.channelizer.M, rx.channelizer.kp,
                        tx.synthesizer.kp)
    if (cuda_pfb.route(M, kp_ch), dw.route(kp_syn)) != (cuda_pfb.FFT_OP,
                                                        dw.RUN_OP):
        raise RuntimeError(f"MMDVMmulti routes: {cuda_pfb.route(M, kp_ch)}, "
                           f"{dw.route(kp_syn)}")
    want = times(chain_launches(rx, 1, MMDVM_T) + chain_launches(tx, 1),
                 N_STEPS)
    require_exactly(report, want, "mmdvm_multi")
    replaced_not_launched("mmdvm_multi", report)
    for y in outs:
        finite("MMDVMmulti", y)
    print(f"  RX {step_times(step_s, MMDVM_T)} (one site, {MULTI_C} "
          f"carriers)", flush=True)
    rec = torch.cat([y["audio"] for y in outs], dim=-1).cpu().numpy()
    snrs = [mmdvm_snr(rec[c, 4000:], float(freqs[c])) for c in
            range(MULTI_C)]
    leak = mmdvm_snr(rec[3, 4000:], float(freqs[0]))
    print(f"  MMDVMmulti loopback: tone SNR per carrier "
          f"{[round(s, 1) for s in snrs]} dB, carrier 0's tone in carrier "
          f"3 {leak:.1f} dB", flush=True)
    if not (min(snrs) > 25.0 and leak < 10.0):
        raise RuntimeError("MMDVMmulti loopback gate failed")
    # the mask gate at 3 carriers
    tx3 = MmdvmMultiTx(3, device=dev)
    a3 = (0.15 * torch.sin(2 * np.pi * (800.0 + 200.0 * torch.arange(
        3, device=dev))[:, None] * t[:4 * 2400])).float()
    mask = torch.ones((3, 4 * 2400 * 25 // 24), device=dev)
    mask[1] = 0.0
    iq3 = tx3(tx3.init_state(), a3, mask=mask)[1]["iq"].cpu().numpy()[5000:]
    spec = np.abs(np.fft.fft(iq3 * np.hanning(len(iq3)))) ** 2
    f = np.fft.fftfreq(len(iq3), 1 / 250_000)

    def carrier_pow(fc):
        return spec[np.abs(f - fc) < 13_000].sum()

    p_on = carrier_pow(0.0) + carrier_pow(50_000.0)
    p_off = carrier_pow(25_000.0)
    print(f"  MMDVMmulti mask: gated carrier {p_off / p_on:.2e} of the "
          f"others' power", flush=True)
    if not p_off < 1e-4 * p_on:
        raise RuntimeError("MMDVMmulti mask gate failed")
    rows = captured_rows(seen, want, "mmdvm_multi", done, dev, gen)
    pfb_rows = mmdvm_pfb_rows(rx.channelizer, tx.synthesizer, dev, gen)
    for r in pfb_rows:
        if r["path"] is not None:
            r["want"] = want[(r["name"].split("/")[0], r["shape"])]
    # the two resamplers at the farm of MMDVM_FARM sites, where rates bind
    for name, rs, T in (("TX 25/24", tx.resamp, n24),
                        ("RX 24/25", rx.resamp, MMDVM_T // rx.channelizer.M)):
        pfb_rows += poly_row(f"mmdvm_multi farm {name}", rs, 2,
                             MMDVM_FARM * MULTI_C, T, "mmdvm_multi", dev,
                             gen, on_path=False)
        torch.cuda.empty_cache()
    return report, rows + pfb_rows


def replaced_not_launched(run, report):
    """MMDVMmulti's channelizer and synthesizer shapes on the kernels that
    served them before their redesign: none in the run's report."""
    from qradiolink_tpu_torch.ops import cuda_depthwise as dw
    from qradiolink_tpu_torch.ops import cuda_pfb

    for op, key in ((cuda_pfb.OP, "cuda M10 kp56"),
                    (dw.OP, "cuda C10 kp53 tail")):
        n = report.get(op, {}).get("shapes", {}).get(key, 0)
        if n:
            raise RuntimeError(f"{run}: {op} launched {n} times at {key}")


MMDVM_FARM = 64            # sites of the farm shape: the blocks' lead_shape


def mmdvm_pfb_rows(ch, syn, dev, gen, T=MMDVM_T, run="mmdvm_multi"):
    """MMDVMmulti's two kernels at the shape of a `run` step or block (T
    samples at one site) and, at the one-site shape, again at a farm of
    MMDVM_FARM sites (lead shape (64,), which no chain runs): K5
    (pfb_fft_f32 at M 10, kp 56) within 1e-5 of the plain version's peak
    and of pfb_channelize_f32's output, which served the shape before; K4
    (depthwise_run_f32 at the synthesizer's kp 53, the tails read in place)
    over two chained blocks through PfbSynthesizer._branches, outputs and
    state equal bit for bit to the route it had (the concatenation, then
    depthwise_fir_f32) and within the FIR's bound of the plain version,
    F.conv1d(groups=10) beside it. Each new kernel timed in turns with the
    old one (K4's old route with its two concatenations, as it ran, and
    its kernel alone), the empty kernel's launch floor beside; K4's run
    count (the grid covering the card) in turns with the count it had (at
    most one run a tile).
    Returns the rows: the new kernels' on the `run` path, the old ones' and
    the farm's with no path."""
    rows = []
    tag = run if T == MMDVM_T else f"{run} T{T}"
    rows += k5_rows(ch, dev, gen, T, (), run, tag)
    rows += k4_rows(syn, dev, gen, T // ch.M, (), run, tag)
    if T == MMDVM_T:
        lead = (MMDVM_FARM,)
        rows += k5_rows(ch, dev, gen, T, lead, run, f"{tag} farm")
        torch.cuda.empty_cache()
        rows += k4_rows(syn, dev, gen, T // ch.M, lead, run, f"{tag} farm")
        torch.cuda.empty_cache()
    return rows


def launch_floor(dev):
    """The median device time of an empty kernel's launch, in ms."""
    from qradiolink_tpu_torch.ops import cuda_resample

    return cuda_ms(lambda: cuda_resample.empty_launch(dev))


def k5_rows(ch, dev, gen, T, lead, run, tag):
    """K5 at M 10, kp 56 on lead + (T,) IqPair planes: pfb_fft_f32 (the
    route) and pfb_channelize_f32 against the plain version, each within
    1e-5 of its peak, timed in turns; rows for both (the old one with no
    path; the farm's rows, lead not (), with no path either)."""
    from qradiolink_tpu_torch.ops import cuda_pfb
    from qradiolink_tpu_torch.ops.cuda_pfb import channelize_plain

    M, kp = ch.M, ch.kp
    Tm = T // M
    new, old = cuda_pfb.route(M, kp), cuda_pfb.OP
    if new != cuda_pfb.FFT_OP:
        raise RuntimeError(f"M{M} kp{kp} routes to {new}")
    xs = tuple(torch.randn(lead + (T,), generator=gen, device=dev) * 0.1
               for _ in range(2))
    hist = torch.randn(lead + (2, kp * M), generator=gen, device=dev) * 0.1
    got = cuda_pfb.channelize(xs, hist, ch._ct, ch._dft)
    was = cuda_pfb._launch(xs, hist, ch._ct, ch._dft)
    plain = channelize_plain(xs, hist, ch._ct)
    err = peak_err(f"{new} M{M} {tag}", got, plain, 1e-5)
    old_err = peak_err(f"{old} M{M} {tag}", was, plain, 1e-5)
    peak_err(f"{new} against {old} M{M} {tag}", got, was, 1e-5)
    del got, was, plain
    ms, turns = turns_ms({
        old: lambda: cuda_pfb._launch(xs, hist, ch._ct, ch._dft),
        new: lambda: cuda_pfb.channelize(xs, hist, ch._ct, ch._dft)})
    floor_ms = launch_floor(dev)
    plain_ms = cuda_ms(lambda: channelize_plain(xs, hist, ch._ct))
    B = math.prod(lead)
    # the planes in and out, the history and the taps; the column FIR's
    # FMAs and the DFT at an FFT's cost, 5 M log2 M flops a row of M
    b = bound(4 * (B * (2 * Tm * M + 2 * kp * M + 2 * M * Tm) + (kp + 1) * M),
              B * (2 * (kp + 1) * 2 * Tm * M + 5 * M * np.log2(M) * Tm))
    print(f"  K5 M{M} kp{kp} {tag} ({B} x {T} samples) in turns: "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in turns)
          + f"; launch floor {floor_ms:.4f} ms; bound {b[0]:.4f} ms, "
          f"{new} at {100 * b[0] / ms[new]:.1f}% of it ({CARD})", flush=True)
    replaces = "qradiolink_tpu/ops/pallas_pfb.py:186"
    shape = f"M{M} kp{kp}" + (f" lead {lead}" if lead else "")
    return [row(f"{new}/{tag}", "qradiolink_tpu_torch/csrc/pfb_fft.cu",
                replaces, err, ms[new], plain_ms, b, None, run, shape,
                routed=not lead),
            row(f"{old}/{tag}", "qradiolink_tpu_torch/csrc/pfb.cu", replaces,
                old_err, ms[old], plain_ms, b, None, run, shape,
                routed=False)]


def k4_rows(syn, dev, gen, Tm, lead, run, tag):
    """K4 at the synthesizer's 10 rows and kp 53, lead + (10, Tm) planes
    with the (..., 2, 10, 52) state: two chained blocks through
    PfbSynthesizer._branches (depthwise_run_f32, the tails read in place)
    and the route it had (two concatenations, then depthwise_fir_f32),
    outputs and new state equal bit for bit, each output within the FIR's
    bound of the plain version; then the two routes' FIR calls (the old
    one with its concatenations, and its kernel alone) timed in turns, and
    depthwise_run_f32 at its own run count in turns with the count its
    launcher took before (at most one run a tile), where the two differ;
    F.conv1d(groups=10) beside."""
    from qradiolink_tpu_torch.ops import cuda_depthwise as dw
    import torch.nn.functional as F

    tf = syn._bt_flipped
    C, kp = tf.shape
    k1 = kp - 1
    if dw.route(kp) != dw.RUN_OP:
        raise RuntimeError(f"kp{kp} routes to {dw.route(kp)}")
    key = f"C{C} kp{kp} tail"

    def old_branches(state, wre, wim):
        wc = [torch.cat([state[..., p, :, :], x], -1)
              for p, x in enumerate((wre, wim))]
        vr, vi = dw._launch_fir(wc, tf, Tm, key)
        return torch.stack([c[..., -k1:] for c in wc], -3), vr, vi

    state = torch.randn(lead + (2, C, k1), generator=gen, device=dev)
    err = 0.0
    for blk in range(2):
        ws = [torch.randn(lead + (C, Tm), generator=gen, device=dev)
              for _ in range(2)]
        got, want = syn._branches(state, *ws), old_branches(state, *ws)
        if not all(torch.equal(g, o) for g, o in zip(got, want)):
            raise RuntimeError(f"{dw.RUN_OP} {tag} block {blk}: outputs or "
                               f"state not bit-equal to {dw.OP}'s route")
        tails = (state[..., 0, :, :], state[..., 1, :, :])
        err = max(err, check_fir(f"{dw.RUN_OP} {tag} block {blk}", got[1:],
                                 dw.depthwise_fir_plain(ws, tf, Tm, tails)))
        state = got[0]
    print(f"  {dw.RUN_OP}/{tag}: 2 chained blocks bit-equal to {dw.OP} on "
          f"the concatenation, state too", flush=True)
    tails = (state[..., 0, :, :], state[..., 1, :, :])
    xcat = torch.stack([torch.cat([t, w], -1) for t, w in zip(tails, ws)])
    w = tf.reshape(C, 1, kp)
    lib_in = xcat.reshape(-1, C, Tm + k1)
    plain = dw.depthwise_fir_plain(ws, tf, Tm, tails)
    check_fir(f"F.conv1d groups {tag}", F.conv1d(lib_in, w, groups=C)
              .reshape(xcat.shape[:-1] + (Tm,)).unbind(0), plain)
    del plain
    rows_n = math.prod(lead) * C
    runs = dw.run_count(rows_n, kp, Tm, 2, dev)
    # the count the launcher took first: at most one run a tile of 2,048
    tile_runs = min(runs, -(-Tm // 2048))
    xcat_planes = tuple(xcat.unbind(0))
    alone = f"{dw.OP} alone"
    ms, turns = turns_ms({
        dw.OP: lambda: dw._launch_fir(tuple(torch.cat([t, x], -1) for t, x
                                            in zip(tails, ws)), tf, Tm, key),
        alone: lambda: dw._launch_fir(xcat_planes, tf, Tm, key),
        dw.RUN_OP: lambda: dw.depthwise_fir(ws, tf, Tm, tails=tails)})
    run_turns = [(f"{runs} runs, as one run a tile gave too", ms[dw.RUN_OP])]
    if tile_runs != runs:
        _, run_turns = turns_ms({
            f"{tile_runs} runs": lambda: dw._launch_run(
                ws, tf, Tm, tails, key, runs=tile_runs),
            f"{runs} runs": lambda: dw._launch_run(ws, tf, Tm, tails, key)})
    floor_ms = launch_floor(dev)
    plain_ms = cuda_ms(lambda: dw.depthwise_fir_plain(ws, tf, Tm, tails))
    lib_ms = cuda_ms(lambda: F.conv1d(lib_in, w, groups=C))
    b = bound(4 * (2 * rows_n * (Tm + k1) + 2 * rows_n * Tm + C * kp),
              2 * kp * 2 * rows_n * Tm)
    print(f"  K4 C{C} kp{kp} {tag} ({rows_n} rows x {Tm} outputs) in turns: "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in turns)
          + f" ({dw.OP} with its two concatenations, and alone on them); "
          f"{dw.RUN_OP} by runs a "
          f"row-plane, in turns: " + ", ".join(
              f"{k} {t:.4f} ms" for k, t in run_turns)
          + f"; launch floor {floor_ms:.4f} ms; F.conv1d(groups={C}) "
          f"{lib_ms:.4f} ms; bound {b[0]:.4f} ms, {dw.RUN_OP} at "
          f"{100 * b[0] / ms[dw.RUN_OP]:.1f}% of it ({CARD})", flush=True)
    replaces = "qradiolink_tpu/ops/pallas_fir.py:401"
    shape = key + (f" lead {lead}" if lead else "")
    return [row(f"{dw.RUN_OP}/{tag}",
                "qradiolink_tpu_torch/csrc/depthwise_run.cu", replaces, err,
                ms[dw.RUN_OP], plain_ms, b, lib_ms, run, shape,
                routed=not lead),
            row(f"{dw.OP}/{tag}", "qradiolink_tpu_torch/csrc/depthwise.cu",
                replaces, err, ms[dw.OP], plain_ms, b, lib_ms, run, shape,
                routed=False)]


def fft_route_phase(dev, gen):
    """The FFT form against the direct kernels at the candidates' shapes
    (complex taps of more than 96 at decimation 1, on the paths' input):
    AmMod's post filter K963 at N_CH x T_STEP, SsbDemod's channel
    band-pass K167 and SsbMod's analytic filter K167 at N_CH x
    AUDIO_PER_STEP, FreeDvDemod's K167 and FreeDvMod's K133 at SWEEP_ROWS
    x FREEDV_T / 125. At each, the two
    forms (FirFilter impl="fft", torch.fft; impl="conv", two fir_s1_f32
    launches and the combine) on the same input and state: the states
    equal, the FFT within AM_FFT_TOL of the direct form's peak, then timed
    in turns (direct, fft, fft, direct); "auto" (ops/fir.auto_impl) must
    take the FFT only where it ran faster, and AmMod's filter on the faster
    form. Then the AM TX step with AmMod's
    post filter forced direct (the route before the FFT form), 3 steps.
    Beside them, the library call: one complex F.conv1d over the tail and
    the block (TF32 off), within AM_FFT_TOL of the direct form's peak.
    Returns {candidate: {form: ms}}."""
    from qradiolink_tpu_torch.chains.freedv import FreeDvDemod, FreeDvMod
    from qradiolink_tpu_torch.chains.ssb import SsbDemod
    from qradiolink_tpu_torch.ops.fir import FirFilter
    import torch.nn.functional as F

    am = am_modulator(dev)
    cands = {
        "am_post_filter": (am.post_filter, N_CH, T_STEP, True),
        "ssb_chan_bp": (SsbDemod(usb=True, lead_shape=(1,),
                                 device=dev).chan_filter, N_CH,
                        AUDIO_PER_STEP, False),
        "freedv_rx_bp": (FreeDvDemod(lead_shape=(1,),
                                     device=dev).chan_filter, SWEEP_ROWS,
                         FREEDV_T // 125, False),
        "freedv_tx_bp": (FreeDvMod(lead_shape=(1,), device=dev).chan_filter,
                         SWEEP_ROWS, FREEDV_T // 125, True),
        # SsbMod's (and CwMod's) analytic filter, the other complex K167
        "ssb_tx_analytic": (tx_modulators(dev)[0].analytic, N_CH,
                            AUDIO_PER_STEP, True)}
    result, wrong = {}, []
    for name, (filt, C, T, complex_in) in cands.items():
        forms = {impl: FirFilter(filt.taps, impl=impl, lead_shape=(C,),
                                 device=dev) for impl in ("conv", "fft")}
        x = torch.complex(*(torch.randn((C, T), generator=gen, device=dev)
                            for _ in range(2)))
        # the modulators filter real signals as complex, the demodulator
        # an IqPair
        x = x.real.to(torch.complex64) if complex_in else rx_planes(x)
        st = torch.randn((C, 2, filt.ntaps - 1), generator=gen, device=dev)
        outs = {k: f(st, x) for k, f in forms.items()}
        if not torch.equal(outs["conv"][0], outs["fft"][0]):
            raise RuntimeError(f"{name}: the two forms' states differ")
        ys = {k: (o[1].to_complex() if hasattr(o[1], "to_complex")
                  else o[1]) for k, o in outs.items()}
        d = float((ys["fft"] - ys["conv"]).abs().max())
        peak = float(ys["conv"].abs().max())
        # the library call: one complex F.conv1d over the tail and the
        # block (TF32 off), held to the direct form as the FFT is
        xc = torch.complex(*(torch.cat([st[:, i], p], -1) for i, p in
                             enumerate((x.real, x.imag) if complex_in
                                       else (x.re, x.im))))
        wc = torch.complex(*filt.tap_planes).reshape(1, 1, -1) \
            if len(filt.tap_planes) == 2 else None
        if wc is None:
            raise RuntimeError(f"{name}: expected complex taps")
        lib = F.conv1d(xc.reshape(C, 1, -1), wc).reshape(C, T)
        d_lib = float((lib - ys["conv"]).abs().max())
        del outs, ys, lib
        if not d <= AM_FFT_TOL * peak:
            raise RuntimeError(f"{name}: FFT off the direct form by {d:.3e}")
        if not d_lib <= AM_FFT_TOL * peak:
            raise RuntimeError(f"{name}: complex F.conv1d off the direct "
                               f"form by {d_lib:.3e}")
        torch.cuda.empty_cache()
        lib_ms = cuda_ms(lambda: F.conv1d(xc.reshape(C, 1, -1), wc))
        del xc
        ms, turns = turns_ms({k: (lambda f=f: f(st, x)) for k, f in
                              forms.items()})
        auto = filt.form(complex_in)
        # the function's bound: its bytes (complex in and out, the state's
        # two planes of K-1, the complex taps); the direct form's: its f32
        # operations, 8 a complex tap and output
        K = filt.ntaps
        b_bytes = bound(8 * C * T * 2 + 4 * C * 2 * (K - 1) + 8 * K, 0)
        b_ops = bound(0, 8 * K * C * T)
        print(f"  {name} K{K} complex, {C} x {T}"
              f"{'' if complex_in else ' (IqPair)'}: FFT against direct max "
              f"|diff| {d:.3e} of a peak {peak:.3e} ({d / peak:.2e}); in "
              f"turns: " + ", ".join(f"{k} {t:.4f} ms" for k, t in turns)
              + f"; auto takes {auto}, the FFT {ms['conv'] / ms['fft']:.2f}x "
              f"the direct form; one complex F.conv1d {lib_ms:.4f} ms (max "
              f"|diff| {d_lib:.3e}); bound {b_bytes[0]:.4f} ms (bytes), the "
              f"direct form's {b_ops[0]:.4f} ms (operations) ({CARD})",
              flush=True)
        # the FFT only where it ran faster; AmMod's filter on the faster
        if (auto == "fft" and ms["fft"] > ms["conv"]) or (
                name == "am_post_filter" and auto == "conv"
                and ms["fft"] < ms["conv"]):
            wrong.append(f"{name}: auto took {auto} ({ms})")
        result[name] = {**ms, "F.conv1d": lib_ms}
        del x, st, forms
        torch.cuda.empty_cache()
    if wrong:
        raise RuntimeError("; ".join(wrong))
    am.post_filter = FirFilter(am.post_filter.taps, impl="conv",
                               lead_shape=(N_CH,), device=dev)
    audio = tx_audio(dev, gen)
    _, _, step_s, _ = drive(am, am.init_state(), [audio] * N_STEPS,
                            ("resample_up_f32", "fir_s1_f32"))
    print(f"  AM TX with the post filter direct: "
          f"{step_times(step_s, N_CH * T_STEP)}", flush=True)
    torch.cuda.empty_cache()
    return result


def slice6_phase(dev, gen, rows):
    """The slice's paths and their rows (their shapes deduplicated against
    the rows so far). Returns ({run: report}, new rows)."""
    done = {(r["name"].split("/")[0], r["shape"]) for r in rows}
    reports, new = {}, []
    for mode in FULL_PATHS:
        print(f"{mode} path: {N_CH} ch x {T_STEP} samples, {N_STEPS} steps, "
              f"each row its own transmission at {FULL_PATHS[mode][1]} dB",
              flush=True)
        reports[mode.lower()], r = full_path(mode, dev, gen, done)
        new += r
    print(f"MMDVMmulti path: one site, {MULTI_C} carriers, {MMDVM_T} "
          f"samples a step, {N_STEPS} steps", flush=True)
    reports["mmdvm_multi"], r = mmdvm_multi_path(dev, gen, done)
    new += r
    rep, r = sweep_phase(dev, gen, done)
    reports.update(rep)
    new += r
    return reports, new


def earlier_phases(dev, gen):
    """The phases of the earlier slices, in order (1-20 above). Returns
    (kernel rows, {run: report})."""
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod

    chain = Fsk4DemodFF(lead_shape=(N_CH,), device=dev)
    nbfm = NbfmDemod(lead_shape=(MIX_M // 2,), device=dev)

    print("kernels against their plain versions:", flush=True)
    rows = fir_phase(chain, nbfm, dev, gen) + viterbi_phase(dev, gen)
    rows += depthwise_phase(dev, gen) + pfb_phase(dev, gen)
    torch.cuda.empty_cache()

    reports = {}
    print(f"main path: Fsk4DemodFF {N_CH} ch x {T_STEP} samples, "
          f"{N_STEPS} steps", flush=True)
    reports["fsk"] = main_path(chain, dev, gen)
    del chain
    torch.cuda.empty_cache()

    print(f"mixed path: MultichannelRx({MIX_M}) over {MIX_M} x {MIX_T} "
          f"samples a step, 32 x Fsk4DemodFF + 32 x NbfmDemod, {N_STEPS} "
          f"steps", flush=True)
    reports["mixed"] = mixed_path(dev, gen)
    torch.cuda.empty_cache()

    print("frozen capture:", flush=True)
    fixture_phase(dev)
    print("round trip through the synthesizer:", flush=True)
    reports["round_trip"] = round_trip_phase(dev)
    torch.cuda.empty_cache()

    print("analog kernels against their plain versions:", flush=True)
    rows += analog_rows(dev, gen)
    torch.cuda.empty_cache()
    print(f"SSB path: SsbDemod(usb=True) {N_CH} ch x {T_STEP} samples, "
          f"{N_STEPS} steps", flush=True)
    reports["ssb"] = ssb_path(dev, gen)
    torch.cuda.empty_cache()
    print(f"WBFM path: WbfmDemod {N_CH} ch x {T_STEP} samples, {N_STEPS} "
          f"steps", flush=True)
    reports["wbfm"] = wbfm_path(dev, gen)
    torch.cuda.empty_cache()
    print(f"TX path: SsbMod + NbfmMod {N_CH} ch x {AUDIO_PER_STEP} audio "
          f"samples, {N_STEPS} steps", flush=True)
    reports["tx"] = tx_path(dev, gen)
    torch.cuda.empty_cache()
    print(f"AM TX path: AmMod {N_CH} ch x {AUDIO_PER_STEP} audio samples, "
          f"{N_STEPS} steps", flush=True)
    reports["am_tx"] = am_tx_path(dev, gen)
    torch.cuda.empty_cache()
    print(f"AM path: AmDemod {N_CH} ch x {T_STEP} samples, {N_STEPS} steps",
          flush=True)
    reports["am"] = am_path(dev, gen)
    torch.cuda.empty_cache()
    print("analog chains, card against CPU:", flush=True)
    card_vs_cpu_phase(dev, gen)
    print("frozen SSB capture, card against CPU:", flush=True)
    ssb_capture_phase(dev)
    print("analog loopbacks on the card:", flush=True)
    loopback_phase(dev)

    print("PSK kernels against their plain versions:", flush=True)
    rows += psk_rows(dev, gen)
    print(f"QPSK250K path: QpskDemod(125_000, 500_000) {N_CH} ch x {T_STEP} "
          f"samples, {N_STEPS} steps", flush=True)
    reports["qpsk"] = qpsk_path(dev, gen)
    print(f"BPSK2K path: BpskDemod {N_CH} ch x {T_STEP} samples, "
          f"{BPSK_STEPS} steps", flush=True)
    reports["bpsk"] = bpsk_path(dev, gen)
    torch.cuda.empty_cache()
    print("frozen QPSK250K capture, card against CPU:", flush=True)
    qpsk_capture_phase(dev)
    print(f"PSK TX path: QpskMod(125_000) + BpskMod {N_CH} ch, {T_STEP} IQ "
          f"samples a step each, {N_STEPS} steps", flush=True)
    reports["psk_tx"], mods = psk_tx_path(dev, gen)
    rows += psk_tx_rows(mods, dev, gen)
    del mods
    torch.cuda.empty_cache()

    print("M17 and DMR kernels against their plain versions:", flush=True)
    rows += fsk4_rows(dev, gen)
    for kind in ("m17", "dmr"):
        print(f"{kind.upper()} path: {fsk4_chains(kind)[1].__name__} {N_CH} "
              f"ch x {T_STEP} samples, {N_STEPS} steps, then "
              f"{fsk4_chains(kind)[2].__name__}", flush=True)
        reports[kind], reports[f"{kind}_ff"] = fsk4_path(kind, dev)
    print(f"M17/DMR TX path: M17Mod + DmrMod {N_CH} ch x {FSK4_BITS} bits, "
          f"{T_STEP} IQ samples a step each, {N_STEPS} steps", flush=True)
    reports["fsk4_tx"] = fsk4_tx_path(dev, gen)
    torch.cuda.empty_cache()
    return rows, reports

# ---------------------------------------------------------------------------
# slice 7: the application and the DMR call layer

APP_BLOCK = 125_000        # the application's block: 125 ms of air at 1 Msps
APP_TEXT = "cq de tpu " * 6
CALL_STEPS = 6             # the call path's steps: 1.2 s of air a row
CALL_SRC = 3_100_000       # row r's source id is CALL_SRC + r
CALL_DST = 91
CALL_ROWS = 32            # rows whose call the host stack decodes
# The voice gate of tests/test_dmr_call.py:198-213 (8 of a row's 12 voice
# bursts FEC-recovered) holds for its one seeded call, not on every row at
# 10 dB with 100 Hz: the reference chain's M&M loop misses a superframe's
# voice sync on a few rows, and its 6 bursts are never taken (in a CPU run
# of this phase at 48 rows 4 rows recovered 5-6, their bits equal to the
# JAX chain's). So every sampled row's bits must equal those of DmrDemod
# on the CPU, given the row's IQ from the same run (a row's miss is then
# the chain's, not a kernel's), and give its terminator; and at least
# CALL_ROW_SHARE of the rows pass the per-row gate and CALL_BURST_SHARE of
# all their bursts are recovered (on the H100 30 of 32 rows and 368 of
# 384 bursts; PERF.md section 7).
CALL_ROW_SHARE = 7 / 8
CALL_BURST_SHARE = 11 / 12


def cpu_launch_table(fn):
    """{(kernel, shape key): calls} that fn() makes on the CPU: the plain
    calls each wrapper records, kernel and shape, which are launches where
    the same work runs on the card."""
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    kernel_paths.reset()
    fn()
    return {(op, k[len("plain "):]): n
            for op, r in kernel_paths.report().items()
            for k, n in r["shapes"].items() if k.startswith("plain ") and n}


def card_counted(run, card_fn):
    """card_fn() with the launch counters zeroed just before and read just
    after: every call on the card must have launched its kernel. Returns
    (card_fn()'s result, the launch report)."""
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    kernel_paths.reset()
    out = card_fn()
    torch.cuda.synchronize()
    report = kernel_paths.report()
    if not kernel_paths.served_only():
        raise RuntimeError(f"{run}: a call took the plain path on the card: "
                           f"{json.dumps(report)}")
    return out, report


def app_counted(run, card_fn, cpu_fn):
    """card_fn() under card_counted, its launches equal, kernel and shape,
    to the calls of cpu_fn() (the same work on the CPU, run first,
    cpu_launch_table). Returns (card_fn()'s result, cpu_fn()'s), the CPU's
    the plain versions' witness that the caller holds the card's to."""
    cpu_out = []
    want = cpu_launch_table(lambda: cpu_out.append(cpu_fn()))
    out, report = card_counted(run, card_fn)
    require_exactly(report, want, run)
    return out, cpu_out[0]


def same_events(run, want, got):
    """The card's controller events equal the CPU's (tests/test_torch_app.py
    assert_same_events): kinds, texts, frame types, payloads and sample
    times exactly, rssi within 1e-3 dB, audio within NbfmDemod's bound
    (audio_close)."""
    if [e.kind for e in got] != [e.kind for e in want]:
        raise RuntimeError(f"{run}: events {[e.kind for e in got]} on the "
                           f"card, {[e.kind for e in want]} on the CPU")
    for i, (w, g) in enumerate(zip(want, got)):
        for f in ("text", "frame_type", "payload", "sample_time"):
            if getattr(g, f) != getattr(w, f):
                raise RuntimeError(f"{run}: event {i} ({w.kind}) {f} "
                                   f"{getattr(g, f)!r} on the card, "
                                   f"{getattr(w, f)!r} on the CPU")
        if (w.rssi is None) != (g.rssi is None) or (
                w.rssi is not None and abs(g.rssi - w.rssi) > 1e-3):
            raise RuntimeError(f"{run}: event {i} rssi {g.rssi} on the "
                               f"card, {w.rssi} on the CPU")
        if (w.audio is None) != (g.audio is None) or (
                w.audio is not None and not audio_close(w.audio, g.audio)):
            raise RuntimeError(f"{run}: event {i}'s audio differs")


def audio_close(want, got, rtol=1e-5, atol=1e-5):
    """got within atol + rtol x |want| of want, sample by sample, the same
    shape (np.allclose; NbfmDemod's bound in tests/test_torch_nbfm.py)."""
    return got.shape == want.shape and bool(np.allclose(got, want, rtol=rtol,
                                                        atol=atol))


def fm_phase_drift(card_path, cpu_path):
    """Prints how the card's FM TX IQ file differs from the CPU's: the
    largest difference, and the phase between the two (its largest value
    and its largest change a sample). The carried phase is an f32 cumsum
    over the whole call (2,000,000 samples in app_phase), whose rounding
    differs between the card's scan and the CPU's: the phase drifts slowly
    and the IQ parts by far more than NbfmMod's 5e-5 of the peak at its
    parity test's 50,000 samples, while the frequency a sample (the
    kernels' output, scaled) stays within rounding. The caller holds the
    TX to the CPU's through the CPU's RX (app_phase)."""
    from qradiolink_tpu_torch.io.iq import read_iq

    got, want = read_iq(card_path), read_iq(cpu_path)
    if got.shape != want.shape:
        raise RuntimeError(f"app tx FM: {got.shape} IQ samples on the card, "
                           f"{want.shape} on the CPU")
    d = np.angle(got.astype(np.complex128) * np.conj(want))
    print(f"  app tx FM: {got.size} IQ samples, the card's within "
          f"{float(np.abs(got - want).max()):.3g} of the CPU's (peak "
          f"{float(np.abs(want).max()):.3g}); the phase between them at most "
          f"{float(np.abs(d).max()):.3g} rad, its change a sample at most "
          f"{float(np.abs(np.diff(d)).max()):.3g} rad", flush=True)


def iq_close(run, card_path, cpu_path, rtol):
    """The IQ file that the card wrote within rtol x the peak of the one
    that the CPU wrote (the modulator's bound in its parity test)."""
    from qradiolink_tpu_torch.io.iq import read_iq

    got, want = read_iq(card_path), read_iq(cpu_path)
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    peak = float(np.abs(want).max())
    print(f"  {run}: {got.size} IQ samples, the card's within {err:.3g} of "
          f"the CPU's (peak {peak:.3g}, bound {rtol:g} x the peak)",
          flush=True)
    if not err <= rtol * peak:
        raise RuntimeError(f"{run}: the card's IQ differs from the CPU's by "
                           f"{err} (shape {got.shape} against {want.shape})")


def cli_out(argv):
    """(return code, standard output) of cli.main(argv)."""
    from qradiolink_tpu_torch.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def cli_ok(argv, dev):
    """cli.main(argv + --device) must return 0; returns its stdout."""
    rc, out = cli_out(argv + ["--device", dev.type])
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv)} returned {rc}: {out}")
    return out


def app_text(out):
    """The text of the [text] lines of `rx`'s output, a frame a line."""
    return "".join(ln[len("[text] "):] for ln in out.splitlines()
                   if ln.startswith("[text] "))


def tone_hz(audio, rate=8000):
    """The strongest frequency in 200-3,000 Hz (tests/test_app.py:93-117)."""
    x = audio[4000:]
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    f = np.fft.rfftfreq(len(x), 1 / rate)
    band = (f > 200) & (f < 3000)
    return float(f[band][np.argmax(spec[band])])


def app_dmr_iq(dev):
    """tests/test_app.py:398-405's stream, built with the port's burst
    builders (block codes on the CPU: test data): slot 2 a voice LC
    header, one superframe of AMBE-coded voice and the terminator (source
    44556, group 9), slot 1 idle, four idle slots ahead, through DmrMod on
    `dev`. Returns complex64 numpy IQ, whole APP_BLOCKs."""
    from qradiolink_tpu_torch.chains.dmr import DmrMod
    from qradiolink_tpu_torch.core import get_iq
    from qradiolink_tpu_torch.fec import ambe
    from qradiolink_tpu_torch.protocols import dmr
    from qradiolink_tpu_torch.protocols.dmr_stream import build_bs_stream

    cpu = "cpu"
    rng = np.random.default_rng(2)
    lc = dmr.LinkControl(flco=dmr.FLCO_GROUP, src_id=44556, dst_id=9)
    voice = ambe.voice_encode(
        rng.integers(0, 2, (6, 3, 49)).astype(np.uint8), cpu)
    slot2 = ([dmr.make_lc_burst(lc, 1, dmr.DT_VOICE_LC_HEADER, device=cpu)]
             + list(dmr.make_voice_superframe(voice, lc, 1, device=cpu))
             + [dmr.make_lc_burst(lc, 1, dmr.DT_TERMINATOR_WITH_LC,
                                  device=cpu)])
    idle = dmr.make_data_burst(np.zeros(196, np.uint8), 1, dmr.DT_IDLE,
                               device=cpu)
    bits = build_bs_stream([idle] * (len(slot2) + 2), slot2, lead_idle=4,
                           device=cpu)
    mod = DmrMod(device=dev)
    iq = get_iq(mod(mod.init_state(), torch.from_numpy(bits).to(dev))[1]
                ["iq"])
    return iq[:len(iq) - len(iq) % APP_BLOCK]


def app_controller(mode, dev):
    """An RX controller on `dev`, codec2 taken out (as in
    tests/test_torch_app.py) so that voice arrives as frames whose payloads
    compare exactly, whether or not the library is installed."""
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings

    s = Settings()
    s.rx_mode = s.tx_mode = mode
    c = RadioController(s, device=dev)
    c.toggle_rx_mode(mode)
    c._codec = None
    if mode == "DMR":
        c._dmr_stack().config.timeslot = 2
    return c


def rx_blocks(ctl, blocks):
    """ctl.rx_block over the blocks in turn; their events."""
    return [e for b in blocks for e in ctl.rx_block(b)]


def rx_blocks_timed(ctl, blocks):
    """ctl.rx_block over the blocks, each timed on the host clock, and the
    chain call inside it fenced and timed apart (the block's IQ put on
    the card, then the chain's launches and their device time). Returns
    (events, block ms, chain ms)."""
    chain, chain_s = ctl._rx, []

    def fenced(state, x):
        t0 = time.perf_counter()
        out = chain(state, x)
        torch.cuda.synchronize()
        chain_s.append(time.perf_counter() - t0)
        return out

    ctl._rx = fenced
    events, block_s = [], []
    try:
        for b in blocks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events += ctl.rx_block(b)
            block_s.append(time.perf_counter() - t0)
    finally:
        ctl._rx = chain
    return events, [t * 1e3 for t in block_s], [t * 1e3 for t in chain_s]


def block_report(name, block_ms, chain_ms):
    """Median ms of a block after the first, the chain call's part, the
    rest (host dispatch, the copies, framing), the real-time factor."""
    blk = statistics.median(block_ms[1:])
    ch = statistics.median(chain_ms[1:])
    print(f"  {name} RX, one radio: a {APP_BLOCK}-sample block (125 ms of "
          f"air) median {blk:.3f} ms over {len(block_ms) - 1} blocks after "
          f"the first ({[round(m, 3) for m in block_ms]}); the chain call "
          f"{ch:.3f} ms, outside it {blk - ch:.3f} ms ({(blk - ch) / blk:.1%}"
          f" of the block); real-time factor {125.0 / blk:.1f} ({CARD})",
          flush=True)
    return {"block_ms": blk, "chain_ms": ch, "rtf": 125.0 / blk}


def app_phase(dev):
    """The application on the card through its public entry points
    (app/cli.py, app/controller.py). Each run's launches equal, kernel and
    shape, the same run's calls on the CPU, and its output equals the
    CPU's (app_counted's witness) within the bounds of the chains' parity
    tests:
    - `modes` lists the registry's 41 modes;
    - `tx --mode 4FSK2K --text` to a file: its IQ within Fsk4Mod's 1e-4 of
      the peak of the CPU's; `rx` of it prints the CPU's lines exactly,
      the text whole but for at most its first frame (the RX loops lock
      during it: `tx` sends no preamble, as in the JAX CLI);
    - `loopback --mode 4FSK2K --snr 12` returns 0 and prints the CPU's
      line;
    - FM `tx --wav-in` (2 s of an 800 Hz tone), then `rx --wav-out` of
      its IQ: the tone at 800 +- 40 Hz, the WAV within NbfmDemod's bound
      and a 16-bit step of the CPU's RX of the same file, and that within
      the same bound of the CPU's RX of the CPU's TX IQ (the TX's phase
      drifts over the call: fm_phase_drift);
    - 4FSK2K and the DMR call of tests/test_app.py:398-427 through
      RadioController.rx_block in APP_BLOCK blocks: the CPU's events
      (same_events), codec2 taken out (app_controller); DMR's voice
      frames, receive_end and the source id in a callsign or receive_end
      event;
    - the median ms of an APP_BLOCK block of 4FSK2K and of DMR RX, its
      part outside the chain call and the real-time factor (block_report).
    Files go to a temporary directory under build/. Returns {name: ms}."""
    import tempfile

    from qradiolink_tpu_torch.framing.layer1 import MODE_FRAME_CONFIG
    from qradiolink_tpu_torch.io.iq import read_iq
    from qradiolink_tpu_torch.io.wav import read_wav, write_wav
    from qradiolink_tpu_torch.models.registry import MODES

    cpu = torch.device("cpu")
    out = {}
    rc, text = cli_out(["modes"])
    names = [ln.split()[0] for ln in text.splitlines()[1:]]
    if rc != 0 or names != list(MODES) or len(names) != 41:
        raise RuntimeError(f"modes: rc {rc}, {len(names)} modes")
    print(f"  modes: the registry's {len(names)} modes", flush=True)
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tmp = pathlib.Path(tmp)
        iq_path, iq_cpu = tmp / "text.cf32", tmp / "text_cpu.cf32"
        argv = ["tx", "--mode", "4FSK2K", "--text", APP_TEXT]
        app_counted("app tx 4FSK2K",
                    lambda: cli_ok(argv + ["--iq-out", str(iq_path)], dev),
                    lambda: cli_ok(argv + ["--iq-out", str(iq_cpu)], cpu))
        iq_close("app tx 4FSK2K", iq_path, iq_cpu, 1e-4)
        argv = ["rx", "--mode", "4FSK2K", "--iq-in", str(iq_path)]
        got, want = app_counted("app rx 4FSK2K", lambda: cli_ok(argv, dev),
                                lambda: cli_ok(argv, cpu))
        lost = len(APP_TEXT) - len(app_text(got))
        if got != want or not APP_TEXT.endswith(app_text(got)) \
                or lost > MODE_FRAME_CONFIG["4FSK2K"].frame_length \
                or "[end of transmission]" not in got:
            raise RuntimeError(f"rx 4FSK2K printed {got!r} on the card, "
                               f"{want!r} on the CPU")
        print(f"  tx --text then rx, 4FSK2K: {app_text(got)!r}, the CPU's "
              f"lines exactly ({lost} characters of the first frame lost "
              f"while the loops lock)", flush=True)
        argv = ["loopback", "--mode", "4FSK2K", "--snr", "12"]
        got, want = app_counted("app loopback 4FSK2K",
                                lambda: cli_ok(argv, dev),
                                lambda: cli_ok(argv, cpu))
        if got != want:
            raise RuntimeError(f"loopback printed {got!r} on the card, "
                               f"{want!r} on the CPU")
        print(f"  {got.strip()}, as on the CPU", flush=True)

        t = np.arange(16_000) / 8000.0
        write_wav(tmp / "in.wav",
                  (0.5 * np.sin(2 * np.pi * 800 * t)).astype(np.float32))
        argv = ["tx", "--mode", "FM", "--wav-in", str(tmp / "in.wav")]
        app_counted("app tx FM",
                    lambda: cli_ok(argv + ["--iq-out", str(tmp / "fm.cf32")],
                                   dev),
                    lambda: cli_ok(argv + ["--iq-out",
                                           str(tmp / "fm_c.cf32")], cpu))
        fm_phase_drift(tmp / "fm.cf32", tmp / "fm_c.cf32")
        argv = ["rx", "--mode", "FM", "--iq-in", str(tmp / "fm.cf32")]
        app_counted("app rx FM",
                    lambda: cli_ok(argv + ["--wav-out",
                                           str(tmp / "out.wav")], dev),
                    lambda: cli_ok(argv + ["--wav-out",
                                           str(tmp / "out_c.wav")], cpu))
        # the CPU's TX IQ through the CPU's RX: the card's TX held to it
        cli_ok(argv[:-1] + [str(tmp / "fm_c.cf32"), "--wav-out",
                            str(tmp / "out_cc.wav")], cpu)
        audio, rate = read_wav(tmp / "out.wav")
        want, _ = read_wav(tmp / "out_c.wav")
        want_tx, _ = read_wav(tmp / "out_cc.wav")
        f = tone_hz(audio)
        step = 1e-5 + 1 / 32767
        if rate != 8000 or audio.size <= 8000 or abs(f - 800.0) >= 40.0 \
                or not audio_close(want, audio, atol=step) \
                or not audio_close(want_tx, want, atol=step):
            raise RuntimeError(f"FM rx: {audio.size} samples at {rate} Hz, "
                               f"tone {f:.1f} Hz, the CPU's {want.size} and "
                               f"{want_tx.size} samples")
        print(f"  FM tx --wav-in then rx --wav-out: {audio.size} samples, "
              f"the tone at {f:.1f} Hz; within NbfmDemod's bound and a "
              f"16-bit step: the card's RX WAV of the CPU's RX of the same "
              f"IQ (largest difference "
              f"{float(np.abs(audio - want).max()):.3g}), the CPU's RX of "
              f"the card's TX IQ of the CPU's RX of the CPU's TX IQ "
              f"({float(np.abs(want - want_tx).max()):.3g})", flush=True)
        fsk_iq = read_iq(iq_path)

    # the RX block's time at the application's width, one radio
    fsk_iq = np.concatenate([fsk_iq, np.zeros((-fsk_iq.size) % APP_BLOCK,
                                              np.complex64)])
    blocks = list(fsk_iq.reshape(-1, APP_BLOCK)) * 4
    (events, block_ms, chain_ms), want = app_counted(
        "app rx_block 4FSK2K",
        lambda: rx_blocks_timed(app_controller("4FSK2K", dev), blocks),
        lambda: rx_blocks(app_controller("4FSK2K", cpu), blocks))
    same_events("app rx_block 4FSK2K", want, events)
    print(f"  4FSK2K through rx_block: {len(events)} events, the CPU's",
          flush=True)
    out["4FSK2K"] = block_report("4FSK2K", block_ms, chain_ms)

    dmr_blocks = list(app_dmr_iq(dev).reshape(-1, APP_BLOCK))
    (events, block_ms, chain_ms), want = app_counted(
        "app rx_block DMR",
        lambda: rx_blocks_timed(app_controller("DMR", dev), dmr_blocks),
        lambda: rx_blocks(app_controller("DMR", cpu), dmr_blocks))
    same_events("app rx_block DMR", want, events)
    kinds = [e.kind for e in events]
    ids = [e.text for e in events if e.kind in ("callsign", "receive_end")]
    if kinds.count("frame") < 4 or "receive_end" not in kinds \
            or "44556" not in ids:
        raise RuntimeError(f"DMR rx_block: events {kinds}, ids {ids}")
    print(f"  DMR through rx_block: the CPU's events, "
          f"{kinds.count('frame')} voice frames, receive_end, source 44556 "
          f"in {ids}", flush=True)
    out["DMR"] = block_report("DMR", block_ms, chain_ms)
    return out


def dmr_call_bits(n_rows):
    """Each row's late-entry BS call (tests/test_dmr_call.py:162-174): slot
    1 idle; slot 2 two superframes of ambe.voice_encode voice with the
    row's own source id (CALL_SRC + r, group CALL_DST) in the embedded LC,
    no header, and the terminator with LC; two idle slots ahead and idle
    bursts after, CALL_STEPS steps of FSK4_BITS bits. Built with the block
    codes on the CPU (test data; host ms a row printed). Returns (bits
    (n_rows, CALL_STEPS * FSK4_BITS) uint8, payloads (n_rows, 12, 3,
    49))."""
    from qradiolink_tpu_torch.fec import ambe
    from qradiolink_tpu_torch.protocols import dmr
    from qradiolink_tpu_torch.protocols.dmr_stream import (SLOT_BITS,
                                                           build_bs_stream)

    cpu = "cpu"
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    payloads = rng.integers(0, 2, (n_rows, 12, 3, 49)).astype(np.uint8)
    voice = ambe.voice_encode(payloads, cpu)
    idle = dmr.make_data_burst(np.zeros(196, np.uint8), 1, dmr.DT_IDLE,
                               device=cpu)
    pairs = CALL_STEPS * FSK4_BITS // (2 * SLOT_BITS) - 1
    bits = np.empty((n_rows, CALL_STEPS * FSK4_BITS), np.uint8)
    for r in range(n_rows):
        lc = dmr.LinkControl(flco=dmr.FLCO_GROUP, src_id=CALL_SRC + r,
                             dst_id=CALL_DST)
        slot2 = [*dmr.make_voice_superframe(voice[r, :6], lc, 1, device=cpu),
                 *dmr.make_voice_superframe(voice[r, 6:], lc, 1, device=cpu),
                 dmr.make_lc_burst(lc, 1, dmr.DT_TERMINATOR_WITH_LC,
                                   device=cpu)]
        bits[r] = build_bs_stream([idle] * pairs, slot2, lead_idle=2,
                                  device=cpu)
    print(f"  dmr_call: {n_rows} rows' calls built on the host in "
          f"{(time.perf_counter() - t0) / n_rows * 1e3:.3f} ms a row",
          flush=True)
    return bits, payloads


def call_stack(bits, dev):
    """The call layer (DmrRxStream + DmrControl, AMBE regeneration on,
    tests/test_dmr_call.py's RX config) on one row's received bits, a
    step's bits a push, its block codes on `dev`. Returns (events in
    order, host seconds)."""
    from qradiolink_tpu_torch.protocols import dmr_control as dc
    from qradiolink_tpu_torch.protocols.dmr_stream import DmrRxStream

    ctl = dc.DmrControl(dc.DmrConfig(color_code=1, timeslot=2, source_id=0,
                                     destination_id=0, vocoder=True),
                        device=dev)
    events = []
    ctl.on_digital_audio = lambda b: events.append(("voice", b))
    ctl.on_header = lambda h: events.append(("header", h.src_id, h.dst_id))
    ctl.on_terminator = lambda h: events.append(("term", h.src_id, h.dst_id))
    rx = DmrRxStream(ctl)
    t0 = time.perf_counter()
    for i in range(0, bits.size, FSK4_BITS):
        rx.push_bits(bits[i:i + FSK4_BITS])
    return events, time.perf_counter() - t0


def dmr_call_phase(dev):
    """The DMR call layer at the DMR path's width (BASELINE configs[2]):
    each of 2048 rows its own late-entry call (dmr_call_bits) through
    DmrMod, ChannelModel (10 dB, 100 Hz) and DmrDemod on the card,
    CALL_STEPS steps of 200,000 samples, the chains' launches exactly
    their stages' (chain_launches); DmrDemod on the CPU, on the same IQ of
    CALL_ROWS rows, as the card's witness: each row's bits equal; then the
    call stack on the host for those rows, its block codes on the card
    and, in turns, on CPU tensors, the two giving the same events.
    tests/test_dmr_call.py:198-213's gate: each row one terminator with
    its own source and group (from the embedded LC: late entry); 8 or more
    of its 12 voice bursts FEC-recovered to the sent payloads on
    CALL_ROW_SHARE of the rows, CALL_BURST_SHARE of all bursts recovered
    (CALL_ROWS' comment). Prints the stack's host ms a row and a second of
    air."""
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.chains.dmr import DmrDemod, DmrMod
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.fec import ambe
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    cpu = torch.device("cpu")
    bits, payloads = dmr_call_bits(N_CH)
    bits_dev = torch.from_numpy(bits).to(dev)
    mod = DmrMod(lead_shape=(N_CH,), device=dev)
    dem = DmrDemod(lead_shape=(N_CH,), device=dev)
    chan = ChannelModel(1_000_000, snr_db=10.0, freq_offset_hz=100.0,
                        seed=31)
    rows = np.linspace(0, N_CH - 1, CALL_ROWS).astype(int)
    rows_dev = torch.as_tensor(rows, device=dev)
    ms_, ds_ = mod.init_state(), dem.init_state()
    rx_bits, step_s, iq_rows = [], [], []
    kernel_paths.reset()
    for i in range(CALL_STEPS):
        ms_, tx = mod(ms_, bits_dev[:, i * FSK4_BITS:(i + 1) * FSK4_BITS])
        y = chan(tx["iq"])
        del tx
        iq = IqPair(y.real.contiguous(), y.imag.contiguous())
        del y
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ds_, out = dem(ds_, iq)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        rx_bits.append(out["bits"])
        iq_rows.append(IqPair(iq.re[rows_dev].cpu(), iq.im[rows_dev].cpu()))
        del iq, out
    report = kernel_paths.report()
    if not kernel_paths.served_only():
        raise RuntimeError("dmr_call: a stage took the plain path")
    want = times(chain_launches(mod, N_CH), CALL_STEPS)
    want.update(times(chain_launches(dem, N_CH, T_STEP), CALL_STEPS))
    require_exactly(report, want, "dmr_call")
    print(f"  DmrDemod: {step_times(step_s, N_CH * T_STEP)} ({CARD})",
          flush=True)
    got = torch.cat(rx_bits, -1)[rows_dev].cpu().numpy()
    del rx_bits, bits_dev
    torch.cuda.empty_cache()

    # the witness: DmrDemod's plain versions on the CPU, the same IQ
    t0 = time.perf_counter()
    dem_cpu = DmrDemod(lead_shape=(CALL_ROWS,), device=cpu)
    s_cpu, ref = dem_cpu.init_state(), []
    for iq in iq_rows:
        s_cpu, out = dem_cpu(s_cpu, iq)
        ref.append(out["bits"])
    ref = torch.cat(ref, -1).numpy()
    del iq_rows
    if ref.shape != got.shape:
        raise RuntimeError(f"dmr_call: bits {got.shape} on the card, "
                           f"{ref.shape} on the CPU")
    diff = (ref != got).sum(-1)
    print(f"  dmr_call: DmrDemod on the CPU on the same IQ of the {CALL_ROWS} "
          f"rows in {time.perf_counter() - t0:.1f} s; bits that differ from "
          f"the card's a row of {got.shape[-1]}: {diff.tolist()}", flush=True)
    if diff.any():
        raise RuntimeError(f"dmr_call: rows {rows[diff > 0].tolist()}'s bits "
                           f"differ from DmrDemod's on the CPU")

    host = {"card": [], "cpu": []}
    recovered, no_term = [], []
    for k, (r, b) in enumerate(zip(rows, got)):
        order = (("card", dev), ("cpu", cpu))
        evs = {}
        for name, d in order if k % 2 == 0 else order[::-1]:
            evs[name], sec = call_stack(b, d)
            host[name].append(sec * 1e3)
        if evs["card"] != evs["cpu"]:
            raise RuntimeError(f"dmr_call row {r}: the stack's events on the "
                               f"card and on the CPU differ")
        terms = [e[1:] for e in evs["card"] if e[0] == "term"]
        if terms != [(CALL_SRC + r, CALL_DST)]:
            no_term.append((int(r), terms))
        sent = {tuple(np.packbits(p.reshape(-1))) for p in payloads[r]}
        ok = 0
        for e in evs["card"]:
            if e[0] == "voice":
                dec, _ = ambe.voice_decode(
                    np.unpackbits(np.frombuffer(e[1], np.uint8)), "cpu")
                ok += tuple(np.packbits(dec.reshape(-1))) in sent
        recovered.append(ok)
    rec = np.array(recovered)
    passed = int((rec >= 8).sum())
    print(f"  dmr_call: voice bursts FEC-recovered of 12 on rows "
          f"{rows.tolist()}: {rec.tolist()}; {passed} of {len(rows)} rows "
          f"pass tests/test_dmr_call.py's per-row gate (>= 8), "
          f"{rec.sum()} of {12 * len(rows)} bursts in all", flush=True)
    if no_term:
        raise RuntimeError(f"dmr_call: rows without their own terminator "
                           f"(row, terminators): {no_term}")
    if passed < CALL_ROW_SHARE * len(rows) \
            or rec.sum() < CALL_BURST_SHARE * 12 * len(rows):
        raise RuntimeError(f"dmr_call: {passed} of {len(rows)} rows pass the "
                           f"voice gate, {rec.sum()} bursts recovered")
    air_s = CALL_STEPS * T_STEP / 1e6
    med = {k: statistics.median(v) for k, v in host.items()}
    print(f"  dmr_call: every sampled row one terminator with its own "
          f"source and group from the embedded LC (late entry), its bits "
          f"those of the CPU's chain, the card's and the CPU's stacks "
          f"giving the same events; the call "
          f"stack's host time a row of {air_s:.1f} s of air, block codes on "
          f"the card {med['card']:.2f} ms ({med['card'] / air_s:.2f} ms a "
          f"second of air; rows {[round(v, 1) for v in host['card']]}), on "
          f"CPU tensors {med['cpu']:.2f} ms ({med['cpu'] / air_s:.2f}; "
          f"{[round(v, 1) for v in host['cpu']]}) ({CARD})", flush=True)
    return med


# ---------------------------------------------------------------------------
# slice 8: the headless service

HEADLESS_TEXT = "cq de tpu headless " * 3
HEADLESS_VERBS = ["rxstatus", "rxmode", "setrxmode NBFM", "rxmode",
                  "setrxmode 4FSK2K", "ptt_on", "txactive", "ptt_off",
                  "txactive"]
UDP_WINDOW = 32            # datagrams in flight ahead of the reader
MMDVM_BLOCK = 30_000       # 120 ms of air at 250 ksps: 2,880 samples at
#                            24 ksps, four 720-sample slots
MMDVM_RX_BLOCKS = 8
MMDVM_TX_BLOCKS = 4
MMDVM_BURSTS = 14          # 720-sample bursts served to carrier 0 (to
#                            carrier c, 14 - c): 3.5 blocks, then idle
MMDVM_TX_TOL = {1: 3e-3, 7: 6e-3}   # tests/test_torch_freedv_mmdvm.py
NET_BLOCK = 50_000         # tests/test_net.py's RX block
NET_SIZES = (120, 1500, 64)          # tests/test_net.py's payloads
NET_PRE, NET_TAIL = 1000, 1000       # preamble and tail bytes (tests/test_net.py: 3000, 2000)
NET_TX_TOL = 1e-4          # of the peak: tests/test_torch_net.py's TX_TOL
PEER_WAIT_MS = 20_000


def probe_lines():
    """Prints whether `import zmq` can succeed here and `g++ --version`;
    returns the former."""
    import importlib.util

    has_zmq = importlib.util.find_spec("zmq") is not None
    print(f"  probe: import zmq {'finds pyzmq' if has_zmq else 'fails: no pyzmq on this machine'}",
          flush=True)
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0]
    print(f"  probe: g++ --version: {gxx}", flush=True)
    return has_zmq


def telnet_lines(port, lines):
    """A telnet session on 127.0.0.1:port: the banner's two lines, then
    each line's reply (up to its CRLF; `shutdown`'s up to the close)."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
        f = c.makefile("rwb")
        got = [f.readline(), f.readline()]
        for line in lines:
            f.write(line.encode() + b"\n")
            f.flush()
            if line == "shutdown":
                got.append(f.read())
                break
            reply = f.readline()
            while reply and not reply.endswith(b"\r\n"):
                reply += f.readline()
            got.append(reply)
    return got


class CountedSocket:
    """The service's UDP socket, counting its reads in `reads` (a shared
    multiprocessing counter, which a sender in another process can read:
    the sender's window waits on it, so no datagram outruns the socket's
    buffer) and summing the seconds spent in recvfrom, the wait for the
    sender included."""

    def __init__(self, sock, reads):
        self.sock = sock
        self.reads = reads
        self.recv_s = 0.0

    def recvfrom(self, n):
        t0 = time.perf_counter()
        out = self.sock.recvfrom(n)
        self.recv_s += time.perf_counter() - t0
        self.reads.value += 1
        return out

    def __getattr__(self, name):
        return getattr(self.sock, name)


def udp_send(port, iq, block, reads, sent):
    """Sends iq to 127.0.0.1:port as UdpIqSink's cf32 datagrams, at most
    UDP_WINDOW ahead of the shared read count `reads`; sent[b] gets the
    time.perf_counter() (the system's monotonic clock, one for every
    process) of sending the datagram that carries block b's first
    sample."""
    from qradiolink_tpu_torch.io.iq import UdpIqSink

    sink = UdpIqSink(port)
    n_blocks, nb = iq.size // block, 0
    for k, i in enumerate(range(0, iq.size, sink.chunk)):
        while k - reads.value >= UDP_WINDOW:
            time.sleep(0.0002)
        while nb < n_blocks and nb * block < i + sink.chunk:
            sent[nb] = time.perf_counter()
            nb += 1
        sink.write(iq[i:i + sink.chunk])
    sink.close()


def headless_session(device, iq, block, sender="thread"):
    """The CLI's headless service (app/cli.HeadlessService, the loop that
    `headless` runs) with `--udp --udp-port 0 --control-port 0 --rx-mode
    4FSK2K --start-trx --device <device>`, its loop in a thread: the telnet
    verbs HEADLESS_VERBS, then `iq` as cf32 datagrams (udp_send), then
    `rxstatus` and `shutdown`. sender "thread": udp_send runs in this
    process, beside the service's loop; "process": in a process of its
    own (multiprocessing, spawned), which shares no interpreter lock with
    the loop. Returns (telnet replies, the text events, {first datagram
    sent, read_block s, its part in recvfrom s, rx_block s, events out: a
    list a block})."""
    import multiprocessing
    import threading

    from qradiolink_tpu_torch.app import cli

    args = cli.build_parser().parse_args(
        ["headless", "--udp", "--udp-port", "0", "--control-port", "0",
         "--rx-mode", "4FSK2K", "--start-trx", "--device", device])
    svc = cli.HeadlessService(args)
    mp = multiprocessing.get_context("spawn")
    n_blocks = iq.size // block
    sent = mp.Array("d", n_blocks, lock=False)
    counted = CountedSocket(svc.src.sock, mp.Value("q", 0, lock=False))
    svc.src.sock = counted
    t = {"read": [], "recv": [], "rx": [], "out": []}
    events = []
    read_inner, rx_inner = svc.src.read_block, svc.ctl.rx_block

    def read_block():
        t0, r0 = time.perf_counter(), counted.recv_s
        b = read_inner()
        t["read"].append(time.perf_counter() - t0)
        t["recv"].append(counted.recv_s - r0)
        return b

    def rx_block(b):
        t0 = time.perf_counter()
        new = rx_inner(b)
        t1 = time.perf_counter()
        t["rx"].append(t1 - t0)
        t["out"].append(t1)
        events.append(new)
        return new

    svc.src.read_block, svc.ctl.rx_block = read_block, rx_block
    rc = []
    th = threading.Thread(target=lambda: rc.append(svc.run()), daemon=True)
    th.start()
    proc = None
    try:
        replies = telnet_lines(svc.telnet.port, HEADLESS_VERBS)
        send = (counted.getsockname()[1], iq, block, counted.reads, sent)
        if sender == "process":
            proc = mp.Process(target=udp_send, args=send)
            proc.start()
        else:
            udp_send(*send)
        end = time.monotonic() + 300
        while len(events) < n_blocks and time.monotonic() < end:
            time.sleep(0.005)
        replies += telnet_lines(svc.telnet.port, ["rxstatus",
                                                  "shutdown"])[2:]
        th.join(timeout=60)
    finally:
        if th.is_alive():
            svc.telnet.server.stop_flag.set()
            th.join(timeout=60)
        if proc is not None:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if rc != [0] or len(events) != n_blocks or (
            proc is not None and proc.exitcode != 0):
        raise RuntimeError(f"headless on {device}: loop returned {rc}, "
                           f"{len(events)} of {n_blocks} blocks, sender "
                           f"{sender} exit {proc and proc.exitcode}")
    t["sent"] = list(sent)
    texts = [e.text for new in events for e in new if e.kind == "text"]
    return replies, texts, t


def read_block_at_hand(iq, block):
    """UdpIqSource.read_block's ms a block (all but the first) with every
    datagram already at hand: its socket a stand-in whose recvfrom returns
    the next of udp_send's cf32 datagrams at once, so the time is the
    decoding and reassembly alone, with no wait on a sender or a socket."""
    from qradiolink_tpu_torch.io.iq import UdpIqSource

    chunk = 1472 // 8
    inter = np.empty(2 * iq.size, np.float32)
    inter[0::2], inter[1::2] = iq.real, iq.imag
    grams = iter([inter[2 * i:2 * (i + chunk)].tobytes()
                  for i in range(0, iq.size, chunk)])

    class AtHand:
        def recvfrom(self, n):
            return next(grams), None

    src = UdpIqSource(0, block)
    src.sock.close()
    src.sock = AtHand()
    ms = []
    for _ in range(iq.size // block):
        t0 = time.perf_counter()
        src.read_block()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms[1:])


def session_figures(t):
    """Median ms a block (all but the first): from its first datagram sent
    to its events out, from the last block's events out to its own (the
    service's period), in read_block, in read_block's recvfrom calls, in
    rx_block."""
    n = len(t["out"])
    block = [(t["out"][i] - t["sent"][i]) * 1e3 for i in range(n)]
    return {"block_ms": statistics.median(block[1:]),
            "period_ms": statistics.median(np.diff(t["out"]) * 1e3),
            "read_ms": statistics.median(t["read"][1:]) * 1e3,
            "recv_ms": statistics.median(t["recv"][1:]) * 1e3,
            "rx_ms": statistics.median(t["rx"][1:]) * 1e3,
            "blocks": [round(b, 3) for b in block]}


def headless_service_phase(dev):
    """(a) The headless service, one radio, 4FSK2K RX at 1 Msps in
    APP_BLOCK blocks (headless_session): the port's own 4FSK2K TX of a
    text (preamble frames, the text, zeros) as cf32 datagrams. The card's
    launches equal the CPU session's calls (app_counted), its telnet
    replies and decoded texts equal the CPU's, the text arrives whole;
    then the same on the card with the sender in a process of its own,
    its replies and texts the same. For each sender, prints ms a block
    from its first datagram sent to its events out, the part in
    UdpIqSource.read_block and, of that, in its socket's recvfrom (the
    wait for the sender), and the real-time factor 125 / ms; then
    read_block's ms with the datagrams at hand (read_block_at_hand).
    Returns the figures."""
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings
    from qradiolink_tpu_torch.framing.layer1 import FrameType
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    tx = RadioController(Settings(tx_mode="4FSK2K"), device=dev)
    tx.toggle_tx_mode("4FSK2K")
    pre = tx._framer.frame(b"\xaa" * 64, FrameType.VOICE_1) * 6
    iq = np.concatenate([tx.tx_bytes(pre), tx.tx_text(HEADLESS_TEXT),
                         np.zeros(60_000, np.complex64)])
    iq = np.concatenate([iq, np.zeros((-iq.size) % APP_BLOCK,
                                      np.complex64)]).astype(np.complex64)
    (replies, texts, t), (c_replies, c_texts, _) = app_counted(
        "headless 4FSK2K", lambda: headless_session(dev.type, iq, APP_BLOCK),
        lambda: headless_session("cpu", iq, APP_BLOCK))
    report = kernel_paths.report()
    print_stages("headless 4FSK2K", report)
    if replies != c_replies or texts != c_texts \
            or HEADLESS_TEXT not in "".join(texts):
        raise RuntimeError(f"headless: replies {replies} / texts {texts} on "
                           f"the card, {c_replies} / {c_texts} on the CPU")
    print(f"  headless: telnet replies equal the CPU session's "
          f"({len(replies) - 2} verbs: {[r.decode().strip() for r in replies[2:]]}); "
          f"the text decoded whole, the CPU's text events", flush=True)
    p_replies, p_texts, p_t = headless_session(dev.type, iq, APP_BLOCK,
                                               sender="process")
    if p_replies != replies or p_texts != texts:
        raise RuntimeError(f"headless, sender in a process: replies "
                           f"{p_replies} / texts {p_texts}")
    figs = {}
    for sender, tt in (("in the service's process", t),
                       ("in a process of its own", p_t)):
        f = session_figures(tt)
        print(f"  headless 4FSK2K, one radio, {len(tt['out'])} blocks of "
              f"{APP_BLOCK} samples in cf32 datagrams of 184 (1,472 "
              f"bytes), the sender {sender}: a block from its first "
              f"datagram sent to its events out median {f['block_ms']:.3f} "
              f"ms ({f['blocks']}); UdpIqSource.read_block "
              f"{f['read_ms']:.3f} ms ({f['read_ms'] / f['block_ms']:.1%}), "
              f"of which in recvfrom {f['recv_ms']:.3f} ms; rx_block "
              f"{f['rx_ms']:.3f} ms; real-time factor "
              f"{125.0 / f['block_ms']:.2f}; from one block's events to "
              f"the next's {f['period_ms']:.3f} ms (real-time factor "
              f"{125.0 / f['period_ms']:.2f}) ({CARD})", flush=True)
        figs[sender] = f
    at_hand = read_block_at_hand(iq, APP_BLOCK)
    print(f"  headless: UdpIqSource.read_block with every datagram at hand "
          f"(no sender, no socket): {at_hand:.3f} ms a block of "
          f"{APP_BLOCK} (host clock, {CARD})", flush=True)
    figs["at_hand_ms"] = at_hand
    return figs


def print_stages(run, report):
    """Which kernel served each stage: the launch report's shapes."""
    print(f"  {run}: kernels a stage served: " + "; ".join(
        f"{op} {k[len('cuda '):]} x{n}" for op, r in report.items()
        for k, n in r["shapes"].items() if n), flush=True)


def launch_counts(report):
    """{(kernel, shape key): launches} on the card in a launch report."""
    from collections import Counter

    return Counter({(op, k[len("cuda "):]): n for op, r in report.items()
                    for k, n in r["shapes"].items()
                    if k.startswith("cuda ") and n})


@contextlib.contextmanager
def capture_into(seen, on):
    """call_capture's calls inside the block go to the dict `seen` where
    `on` holds and seen is not None; otherwise nothing is recorded."""
    if seen is None or not on:
        yield
        return
    with call_capture() as s:
        yield
    seen.update(s)


def queue_transport():
    """The port's MMDVM publisher and poller with their ZMQ sockets
    replaced by in-memory queues (the transport's _send and _request):
    the same slotting and the same wire bytes, for a machine without
    pyzmq. Returns (QueuePublisher, QueuePoller)."""
    from qradiolink_tpu_torch.io import mmdvm_transport as mt

    class QueuePublisher(mt.MmdvmRxPublisher):
        def __init__(self, num_channels):
            self._init_slots(num_channels)
            self.sent = [[] for _ in range(num_channels)]

        def _send(self, chan, msg):
            self.sent[chan].append(msg)

        def close(self):
            pass

    class QueuePoller(mt.MmdvmTxPoller):
        def __init__(self, served):
            self.served = served

        def _request(self, chan):
            q = self.served[chan]
            return q.pop(0) if q else b""

        def close(self):
            pass

    return QueuePublisher, QueuePoller


class MmdvmPeer:
    """MMDVMHost's side of C carriers: unpacks the radio's RX slot
    messages and answers every TX poll with the next queued burst (a
    wire message) or an idle reply (b""). With pyzmq: PULL and REP
    sockets on ipc paths in `tmp`, the replies from a thread; without:
    queue_transport's publisher and poller."""

    def __init__(self, C, bursts, tmp, has_zmq):
        from qradiolink_tpu_torch.app import mmdvm_session as ms

        self.C, self.has_zmq = C, has_zmq
        self.session_cls = ms.MmdvmSession
        self.served = [list(b) for b in bursts]
        self.sess = None
        if has_zmq:
            import threading
            import zmq

            rel = os.path.relpath(tmp)
            self.tpl = {k: f"ipc://{rel}/{k}{{}}.ipc" for k in ("rx", "tx")}
            ctx = zmq.Context.instance()
            self.pulls, self.reps = [], []
            for c in range(C):
                p = ctx.socket(zmq.PULL)
                p.setsockopt(zmq.RCVTIMEO, PEER_WAIT_MS)
                p.connect(self.tpl["rx"].format(c + 1))
                r = ctx.socket(zmq.REP)
                r.bind(self.tpl["tx"].format(c + 1))
                self.pulls.append(p)
                self.reps.append(r)
            self.stop = threading.Event()
            self.thread = threading.Thread(target=self._serve, daemon=True)
            self.thread.start()

    def _serve(self):
        import zmq

        poller = zmq.Poller()
        for r in self.reps:
            poller.register(r, zmq.POLLIN)
        while not self.stop.is_set():
            for sock, _ in poller.poll(50):
                c = self.reps.index(sock)
                sock.recv()
                q = self.served[c]
                sock.send(q.pop(0) if q else b"")

    def session(self, settings, num_channels=1):
        """app/mmdvm_session.MmdvmSession on this peer's transport (the
        controller builds its session through this while the peer is
        installed)."""
        if self.has_zmq:
            import zmq

            sess = self.session_cls(settings, num_channels,
                                    rx_path_tpl=self.tpl["rx"],
                                    tx_path_tpl=self.tpl["tx"],
                                    timeout_ms=PEER_WAIT_MS)
            for s in sess.publisher.socks:
                if not s.poll(PEER_WAIT_MS, zmq.POLLOUT):
                    raise RuntimeError("MMDVM peer never connected")
        else:
            pub_cls, poll_cls = queue_transport()
            sess = self.session_cls(settings, num_channels,
                                    publisher=pub_cls(num_channels),
                                    poller=poll_cls(self.served))
        self.sess = sess
        return sess

    def slots(self, chan, n):
        """The next n RX slot messages of carrier chan, unpacked."""
        from qradiolink_tpu_torch.io.mmdvm_transport import unpack_rx_message

        if self.has_zmq:
            return [unpack_rx_message(self.pulls[chan].recv())
                    for _ in range(n)]
        sent = self.sess.publisher.sent[chan]
        out = [unpack_rx_message(m) for m in sent[:n]]
        del sent[:n]
        return out

    def close(self):
        if self.has_zmq:
            self.stop.set()
            self.thread.join(timeout=60)
            for s in self.pulls + self.reps:
                s.close(0)


def mmdvm_bursts(C):
    """Carrier c's served TX: MMDVM_BURSTS - c wire messages of 720
    seeded int16 samples, MARK_SLOT1 then MARK_SLOT2."""
    from qradiolink_tpu_torch.io import mmdvm_transport as mt

    rng = np.random.default_rng(21)
    out = []
    for c in range(C):
        msgs = []
        for k in range(MMDVM_BURSTS - c):
            s = (8000 * np.sin(np.arange(720) * (0.05 + 0.01 * c) + k)
                 + rng.normal(0, 50, 720)).astype(np.int16)
            ctrl = np.full(720, mt.MARK_SLOT1 + k % 2, np.uint8)
            msgs.append(mt.pack_tx_message(s, ctrl))
        out.append(msgs)
    return out


def mmdvm_headless(mode, device, blocks, has_zmq, tmp, seen=None):
    """RadioController on `device` in `mode` with its session on an
    MmdvmPeer: rx_block over `blocks` (each timed, events kept), the
    peer's slots, then MMDVM_TX_BLOCKS of mmdvm_tx_poll(2,880) (each
    timed; the mask handed to the TX chain kept), then NBFM, which must
    close the session. seen: a dict that call_capture's calls of the
    first RX and the first TX block go to. Returns a dict of the
    results."""
    from qradiolink_tpu_torch.app import mmdvm_session as ms
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings

    C = Settings().mmdvm_channels if mode == "MMDVMmulti" else 1
    peer = MmdvmPeer(C, mmdvm_bursts(C), tmp, has_zmq)
    ms.MmdvmSession = peer.session
    try:
        c = RadioController(Settings(), device=device)
        c.toggle_rx_mode(mode)
        c.toggle_tx_mode(mode)
        events, rx_ms = [], []
        for i, b in enumerate(blocks):
            with capture_into(seen, i == 0):
                t0 = time.perf_counter()
                events.append(c.rx_block(b))
                rx_ms.append((time.perf_counter() - t0) * 1e3)
        slots = [peer.slots(k, len(blocks) * 4) for k in range(C)]
        masks, tx_ms, iqs = [], [], []
        inner = c._tx

        def spy(state, audio, mask=None):
            masks.append(mask.cpu().numpy())
            return inner(state, audio, mask=mask)

        c._tx = spy
        for i in range(MMDVM_TX_BLOCKS):
            with capture_into(seen, i == 0):
                t0 = time.perf_counter()
                iqs.append(c.mmdvm_tx_poll(2880))
                tx_ms.append((time.perf_counter() - t0) * 1e3)
        c._tx = inner
        sess = c._mmdvm
        c.toggle_rx_mode("NBFM")
        if c._mmdvm is not None or sess is None:
            raise RuntimeError(f"{mode}: the session outlived the mode")
    finally:
        ms.MmdvmSession = peer.session_cls
        peer.close()
    return dict(C=C, events=events, slots=slots, masks=masks, iqs=iqs,
                rx_ms=rx_ms, tx_ms=tx_ms)


def mmdvm_blocks(mode, C):
    """MMDVM_RX_BLOCKS blocks of MMDVM_BLOCK samples at 250 ksps: the
    port's TX chain on the CPU on a 1 kHz tone a carrier (carrier c's
    phase c / 8), plus seeded noise at 0.01 a plane."""
    from qradiolink_tpu_torch.chains import mmdvm
    from qradiolink_tpu_torch.core import get_iq

    n24 = MMDVM_RX_BLOCKS * MMDVM_BLOCK * 24 // 250
    t = np.arange(n24) / 24_000.0
    a = (0.15 * np.sin(2 * np.pi * 1000.0 * t
                       + np.arange(C)[:, None] / 8)).astype(np.float32)
    tx = mmdvm.MmdvmMultiTx(C, device="cpu") if mode == "MMDVMmulti" \
        else mmdvm.MmdvmMod(device="cpu")
    iq = get_iq(tx(tx.init_state(), torch.from_numpy(
        a if mode == "MMDVMmulti" else a[0]))[1]["iq"])
    rng = np.random.default_rng(22)
    iq = iq + 0.01 * (rng.standard_normal(iq.size)
                      + 1j * rng.standard_normal(iq.size))
    return list(iq.astype(np.complex64).reshape(MMDVM_RX_BLOCKS, -1))


def mmdvm_headless_phase(has_zmq, dev, gen, done):
    """(b) MMDVM through RadioController: one carrier, then MMDVMmulti at
    settings.mmdvm_channels carriers, MMDVM_RX_BLOCKS RX blocks of
    MMDVM_BLOCK at 250 ksps and MMDVM_TX_BLOCKS TX polls, on the card and
    on the CPU (app_counted: the card's launches those of the CPU's calls).
    The card's slots (int16 samples, rssi) within one step of the CPU's,
    control bytes equal; the TX IQ within the parity tests' bound of the
    peak of the CPU's and the gated masks equal; a row for every FIR and
    resampler shape the card run launched (captured_rows) and, for
    MMDVMmulti, K5 and K4 at the block's shape (mmdvm_pfb_rows). Prints
    ms a block and the real-time factor (120 ms of air a block) for RX and
    TX. Returns ({run: report}, rows, figures)."""
    import tempfile

    from qradiolink_tpu_torch.chains import mmdvm
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    reports, rows, figs = {}, [], {}
    (HERE / "build").mkdir(exist_ok=True)
    print("  MMDVM transport: " + (
        "ZeroMQ ipc sockets in a directory under build/" if has_zmq else
        "no pyzmq here: the port's publisher and poller with in-memory "
        "queues for sockets (queue_transport), the same wire bytes"),
        flush=True)
    for mode in ("MMDVM", "MMDVMmulti"):
        C = 7 if mode == "MMDVMmulti" else 1
        blocks = mmdvm_blocks(mode, C)
        run = f"headless_{mode.lower()}"
        seen = {}
        with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
            os.mkdir(os.path.join(tmp, "card"))
            os.mkdir(os.path.join(tmp, "cpu"))
            got, want = app_counted(
                run, lambda: mmdvm_headless(mode, dev.type, blocks, has_zmq,
                                            os.path.join(tmp, "card"), seen),
                lambda: mmdvm_headless(mode, "cpu", blocks, has_zmq,
                                       os.path.join(tmp, "cpu")))
        report = kernel_paths.report()
        reports[run] = report
        print_stages(run, report)
        if got["C"] != C or len(got["slots"]) != C:
            raise RuntimeError(f"{mode}: {got['C']} carriers")
        worst_s = worst_r = 0
        for ch, cch in zip(got["slots"], want["slots"]):
            if len(ch) != len(cch) or len(ch) != 4 * MMDVM_RX_BLOCKS:
                raise RuntimeError(f"{mode}: {len(ch)} slots, the CPU "
                                   f"{len(cch)}")
            for (s, ctrl, r), (cs, cctrl, cr) in zip(ch, cch):
                if s.size != 720 or not np.array_equal(ctrl, cctrl):
                    raise RuntimeError(f"{mode}: a slot's size or control")
                worst_s = max(worst_s, int(np.abs(s.astype(int)
                                                  - cs.astype(int)).max()))
                worst_r = max(worst_r, abs(r - cr))
        if worst_s > 1 or worst_r > 1:
            raise RuntimeError(f"{mode}: slots {worst_s} int16 steps, rssi "
                               f"{worst_r} from the CPU's")
        tol = MMDVM_TX_TOL[C]
        if len(got["iqs"]) != MMDVM_TX_BLOCKS or any(
                x is None for x in got["iqs"] + want["iqs"]):
            raise RuntimeError(f"{mode}: a TX poll gave no IQ")
        tx_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                     for a, b in zip(got["iqs"], want["iqs"]))
        masks_equal = all(np.array_equal(a, b) for a, b in
                          zip(got["masks"], want["masks"]))
        if tx_err > tol or not masks_equal or \
                len(got["masks"]) != MMDVM_TX_BLOCKS:
            raise RuntimeError(f"{mode}: TX IQ {tx_err:.3g} of the peak "
                               f"from the CPU's (bound {tol}), masks equal "
                               f"{masks_equal}")
        gated = [round(float(m.mean()), 4) for m in got["masks"]]
        rx_med = statistics.median(got["rx_ms"][1:])
        tx_med = statistics.median(got["tx_ms"][1:])
        print(f"  {mode} ({C} carrier{'s' if C > 1 else ''}, "
              f"{'ZeroMQ ipc' if has_zmq else 'in-memory queues: no pyzmq'}): "
              f"{4 * MMDVM_RX_BLOCKS} slots a carrier, int16 samples within "
              f"{worst_s} step and rssi within {worst_r} of the CPU's; TX IQ "
              f"within {tx_err:.3g} of the peak of the CPU's (bound {tol}), "
              f"the gated masks equal (open share a block {gated}); RX a "
              f"{MMDVM_BLOCK}-sample block (120 ms of air) median "
              f"{rx_med:.3f} ms ({[round(m, 3) for m in got['rx_ms']]}), "
              f"real-time factor {120.0 / rx_med:.1f}; TX a poll of 2,880 "
              f"samples median {tx_med:.3f} ms "
              f"({[round(m, 3) for m in got['tx_ms']]}), real-time factor "
              f"{120.0 / tx_med:.1f} ({CARD})", flush=True)
        figs[mode] = {"rx_ms": rx_med, "tx_ms": tx_med,
                      "rx_rtf": 120.0 / rx_med, "tx_rtf": 120.0 / tx_med}
        launched = launch_counts(report)
        blocks_n = MMDVM_RX_BLOCKS + MMDVM_TX_BLOCKS
        print(f"  {run}: launches a block (RX and TX blocks together, "
              f"{blocks_n}): " + ", ".join(
                  f"{op} {k} {n / blocks_n:g}" for (op, k), n in
                  launched.items()), flush=True)
        rows += captured_rows(seen, launched, run, done, dev, gen)
        if C > 1:
            rx = mmdvm.MmdvmMultiRx(C, device=dev)
            tx = mmdvm.MmdvmMultiTx(C, device=dev)
            replaced_not_launched(run, report)
            pfb = mmdvm_pfb_rows(rx.channelizer, tx.synthesizer, dev, gen,
                                 T=MMDVM_BLOCK, run=run)
            for r in pfb:
                if r["path"] is not None:
                    r["want"] = launched[(r["name"].split("/")[0],
                                          r["shape"])]
            rows += pfb
        torch.cuda.empty_cache()
    return reports, rows, figs


def net_session(device, seen=None):
    """IP-over-radio through one RadioController on `device`:
    NetPump(LoopbackNetDevice(), "QPSK250K") (burst mode) with
    tests/test_net.py's three payloads, tx_net_poll for each between its
    NET_PRE-byte preamble and NET_TAIL-byte tail (tx_bytes; each part
    timed), then the same controller's RX with the pump attached, NET_BLOCK
    blocks (each timed, events kept). seen: a dict that call_capture's
    calls of the first poll and the first RX block go to. Returns a dict
    of the results."""
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings
    from qradiolink_tpu_torch.net import LoopbackNetDevice, NetPump

    rng = np.random.default_rng(3)
    payloads = [bytes(rng.integers(0, 256, n, dtype=np.uint8))
                for n in NET_SIZES]
    netdev = LoopbackNetDevice()
    pump = NetPump(netdev, "QPSK250K", burst_mode=True)
    for p in payloads:
        netdev.inject(p)
    c = RadioController(Settings(tx_mode="QPSK250K", rx_mode="QPSK250K"),
                        device=device)
    c.start_transmission()
    parts, tx_ms = [c.tx_bytes(b"\xaa" * NET_PRE)], []
    for i in range(len(payloads)):
        with capture_into(seen, i == 0):
            t0 = time.perf_counter()
            parts.append(c.tx_net_poll(pump, 0.05))
            tx_ms.append((time.perf_counter() - t0) * 1e3)
    if c.tx_net_poll(pump, 0.05) is not None:
        raise RuntimeError("net: the dry pump in burst mode sent a frame")
    parts.append(c.tx_bytes(b"\xaa" * NET_TAIL))
    iq = np.concatenate(parts)
    c.attach_net(pump)
    c.toggle_rx_mode("QPSK250K")
    rx_ms, events = [], []
    for k, i in enumerate(range(0, iq.size - iq.size % NET_BLOCK,
                                NET_BLOCK)):
        with capture_into(seen, k == 0):
            t0 = time.perf_counter()
            events += c.rx_block(iq[i:i + NET_BLOCK])
            rx_ms.append((time.perf_counter() - t0) * 1e3)
    return dict(payloads=payloads, delivered=netdev.delivered(),
                parts=parts, events=events, tx_ms=tx_ms, rx_ms=rx_ms)


def net_cpu_twin():
    """net_session on the CPU and its calls (cpu_launch_table), in a
    process of its own (two threads; no card)."""
    torch.set_num_threads(2)
    out = []
    want = cpu_launch_table(lambda: out.append(net_session("cpu")))
    return want, out[0]


def net_headless_phase(dev, gen, done):
    """(c) IP-over-radio (net_session) on the card and on the CPU, the
    CPU's run (net_cpu_twin) in a spawned process while the card runs and
    its rows are built: the card's launches those of the CPU's calls
    (card_counted, require_exactly); the card delivers the payloads back,
    in order; each TX part within NET_TX_TOL of the peak of the CPU's; the
    RX events the CPU's (same_events); a row for each kernel shape of the
    first poll and the first RX block that no earlier row has
    (captured_rows: the FIRs and interpolators on seeded inputs of their
    shape, the loops on the path's own inputs). Prints ms a poll and a
    block and the real-time factor. Returns ({run: report}, rows,
    figures)."""
    import concurrent.futures
    import multiprocessing

    run = "headless_net"
    seen = {}
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        twin = pool.submit(net_cpu_twin)
        got, report = card_counted(run, lambda: net_session(dev.type, seen))
        print_stages(run, report)
        rows = captured_rows(seen, launch_counts(report), run, done, dev,
                             gen)
        want_calls, want = twin.result(timeout=900)
    require_exactly(report, want_calls, run)
    payloads = got["payloads"]
    if got["delivered"] != payloads or want["delivered"] != payloads:
        raise RuntimeError(
            f"net: delivered {[len(g) for g in got['delivered']]} bytes on "
            f"the card, {[len(g) for g in want['delivered']]} on the CPU, "
            f"sent {[len(p) for p in payloads]}")
    if [p.shape for p in got["parts"]] != [p.shape for p in want["parts"]]:
        raise RuntimeError(f"net: TX parts {[p.shape for p in got['parts']]}"
                           f" on the card, {[p.shape for p in want['parts']]}"
                           f" on the CPU")
    tx_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                 for a, b in zip(got["parts"], want["parts"]))
    if not tx_err <= NET_TX_TOL:
        raise RuntimeError(f"net: TX IQ {tx_err:.3g} of the peak from the "
                           f"CPU's (bound {NET_TX_TOL})")
    same_events(run, want["events"], got["events"])
    rx_med = statistics.median(got["rx_ms"][1:])
    print(f"  net QPSK250K: the {len(payloads)} payloads "
          f"({list(NET_SIZES)} bytes) back through the device in order, on "
          f"the card and on the CPU; the TX IQ ({len(got['parts'])} parts) "
          f"within {tx_err:.3g} of the peak of the CPU's (bound "
          f"{NET_TX_TOL}); the {len(got['events'])} RX events the CPU's "
          f"({sum(e.kind == 'net' for e in got['events'])} net); "
          f"tx_net_poll {[round(m, 3) for m in got['tx_ms']]} ms; RX a "
          f"{NET_BLOCK}-sample block (50 ms of air) median {rx_med:.3f} ms "
          f"over {len(got['rx_ms'])} blocks, real-time factor "
          f"{50.0 / rx_med:.1f} ({CARD})", flush=True)
    return {run: report}, rows, {"rx_ms": rx_med,
                                 "tx_ms": statistics.median(got["tx_ms"])}


def engine_phase():
    """(d) The C++ host-IO engine (io/native.py): the four conversions
    against the numpy forms on 4 M complex samples (MS/s, host clock,
    median of 5), and UdpRxEngine's datagrams a second for 20,000 1,472-
    byte datagrams from one Python socket on loopback, at most UDP_WINDOW
    ahead of the engine's count (the socket's buffer never overflows;
    the sender's pace bounds the rate; printed, not gated)."""
    import socket

    from qradiolink_tpu_torch.io import native

    n = 1 << 23
    rng = np.random.default_rng(5)
    s16 = rng.integers(-32768, 32768, n).astype(np.int16)
    u8 = rng.integers(0, 256, n).astype(np.uint8)
    f = rng.uniform(-1.1, 1.1, n).astype(np.float32)
    cases = [
        ("cs16 read", lambda: native.cs16_to_f32(s16),
         lambda: s16.astype(np.float32) / 32767.0),
        ("cs16 write", lambda: native.f32_to_cs16(f),
         lambda: np.round(np.clip(f * 32767.0, -32767, 32767)
                          ).astype(np.int16)),
        ("cu8 read", lambda: native.cu8_to_f32(u8),
         lambda: (u8.astype(np.float32) - 127.5) / 127.5),
        ("cu8 write", lambda: native.f32_to_cu8(f),
         lambda: np.round(np.clip(f * 127.5 + 127.5, 0, 255)
                          ).astype(np.uint8))]

    def rate(fn):
        fn()
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
        return n / 2 / statistics.median(ts) / 1e6

    out = {}
    for name, nat, ref in cases:
        out[name] = (rate(nat), rate(ref))
    print("  engine: " + "; ".join(
        f"{k} {a:.0f} MS/s against numpy's {b:.0f} ({a / b:.2f}x)"
        for k, (a, b) in out.items()) + " (complex samples, host clock)",
        flush=True)
    n_dg, size = 20_000, 1472
    eng = native.UdpRxEngine(port=0, ring_bytes=1 << 25)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    payload = bytes(size)
    try:
        t0 = time.perf_counter()
        for k in range(n_dg):
            while k - eng.datagrams >= UDP_WINDOW:
                time.sleep(0)
            tx.sendto(payload, ("127.0.0.1", eng.port))
        end = time.monotonic() + 30
        while eng.datagrams < n_dg and time.monotonic() < end:
            time.sleep(0.0002)
        t1 = time.perf_counter()
        got, dropped = eng.datagrams, eng.dropped
        drained = len(eng.read(n_dg * size))
    finally:
        eng.close()
        tx.close()
    print(f"  engine: UdpRxEngine took {got} of {n_dg} datagrams of {size} "
          f"bytes in {(t1 - t0) * 1e3:.1f} ms ({got / (t1 - t0):.0f} a "
          f"second, {got * size / (t1 - t0) / 1e6:.1f} MB/s), {dropped} "
          f"dropped at its ring, {drained} bytes read back", flush=True)
    if got != n_dg or dropped or drained != n_dg * size:
        raise RuntimeError(f"engine: {got} datagrams, {dropped} dropped, "
                           f"{drained} bytes")
    out["udp_rx_dps"] = got / (t1 - t0)
    return out


def headless_phase(dev, gen, done):
    """The headless service (slice 8) on the card, after the probes
    (probe_lines): (a) headless_service_phase, (b) mmdvm_headless_phase,
    (c) net_headless_phase, (d) engine_phase. done: the (kernel, shape)
    keys that have rows, which the rows made here join. Returns ({run:
    report}, rows)."""
    has_zmq = probe_lines()
    t0 = time.perf_counter()
    headless_service_phase(dev)
    reports, rows, _ = mmdvm_headless_phase(has_zmq, dev, gen, done)
    rep, net_rows, _ = net_headless_phase(dev, gen, done)
    reports.update(rep)
    rows += net_rows
    engine_phase()
    print(f"  headless phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return reports, rows


# ---------------------------------------------------------------------------
# slice 9: the application's audio, FreeDV vocoder, video and VOIP

FREEDV_STREAM = HERE / "tests" / "fixtures" / "freedv1600_modem.npz"
FREEDV_SNR_DB = 20.0       # tests/test_freedv.py:65
FREEDV_SECONDS = 3         # the stored stream's utterance
MIXER_READS = (1201, 2405, 599)   # 48 kHz samples a read, none a multiple of 6
MIXER_WRITES = (331, 800, 157)    # 8 kHz samples a write
MIXER_TOL = 1e-5           # the resamplers' float output, of the CPU's peak
PROC_BLOCK = 1_600         # 200 ms of 8 kHz audio a TX block
PROC_BLOCKS = 4            # the compressor's gain opens within ~0.4 s
PROC_MODES = {"FM": False, "USB": True, "4FSK2K": False}   # mode: denoise
PROC_TX_TOL = 6.25e-6      # the TX IQ against the CPU's, of its peak (not
#                            FM's: its f32 phase cumsum drifts, fm_drift)
VIDEO_PRE, VIDEO_TAIL = 600, 600   # bytes of 0xaa around the frame
VIDEO_BLOCK = 50_000       # tests/test_video.py's RX block
MUMBLE_SESSION = 42


def probe_av():
    """Prints which host libraries the slice's parts find here: Pillow,
    libcodec2 and its FreeDV API, libopus. Returns {name: found}."""
    import importlib.util

    from qradiolink_tpu_torch.audio import codecs, freedv

    found = {"pil": importlib.util.find_spec("PIL") is not None,
             "codec2": codecs.codec2_available(),
             "freedv": freedv.freedv_available(),
             "opus": codecs.opus_available()}
    print(f"  probe: libcodec2 {'loads' if found['codec2'] else 'is missing'}"
          f"; its FreeDV API (freedv_open) "
          f"{'is there' if found['freedv'] else 'is missing'}; libopus "
          f"{'loads' if found['opus'] else 'is missing'}; Pillow "
          f"{'imports' if found['pil'] else 'is missing'}", flush=True)
    if not found["pil"]:
        raise RuntimeError("video: Pillow is missing")
    return found


def lsb_flips(what, got, want):
    """int16 samples of got that differ from want's, every one by at most
    one LSB (a truncation toward zero of floats a rounding apart)."""
    if got.shape != want.shape:
        raise RuntimeError(f"{what}: {got.shape} int16 samples on the card, "
                           f"{want.shape} on the CPU")
    d = np.abs(got.astype(np.int32) - want)
    if d.max(initial=0) > 1:
        raise RuntimeError(f"{what}: int16 samples {int(d.max())} apart")
    return int((d > 0).sum())


def host_close(what, got, want, tol):
    """max |got - want| within tol x want's peak; returns it."""
    err = float(np.abs(got - want).max()) if got.shape == want.shape \
        else float("inf")
    peak = float(np.abs(want).max())
    if not err <= tol * peak:
        raise RuntimeError(f"{what}: {err:.3g} from the CPU's (peak "
                           f"{peak:.3g}, bound {tol:g} x the peak; shapes "
                           f"{got.shape}, {want.shape})")
    return err


def freedv_chain_run(device, usb, found, modem_in=None, iq_in=None):
    """One FreeDV 1600 transmission through the port on `device`: the
    stored utterance through FreeDvTx's band-pass (tx_audio_filter), x32765
    to int16 (what FreeDvTx hands to freedv_tx), freedv_tx (or, without the
    FreeDV API, the stored stream), FreeDvMod, ChannelModel at
    FREEDV_SNR_DB, FreeDvDemod, x32768 to int16 (what FreeDvRx hands to
    freedv_rx), freedv_rx (with the API). modem_in / iq_in: the modem
    samples and channel IQ to use instead of this run's own (the CPU's run
    takes the card's, so each stage sees the card's inputs). Returns a dict
    of every stage's output as numpy."""
    from qradiolink_tpu_torch.audio.freedv import FreeDV
    from qradiolink_tpu_torch.chains import freedv
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.core import get_iq, put_iq_pair

    stream = np.load(FREEDV_STREAM)
    speech = stream["speech"]
    out = {}
    af = freedv.tx_audio_filter(device)
    _, y = af(af.init_state(), torch.from_numpy(
        speech.astype(np.float32) / 32768.0).to(device))
    out["filtered"] = y.cpu().numpy()
    out["pcm_tx"] = np.clip(out["filtered"] * 32765.0, -32765,
                            32765).astype(np.int16)
    if modem_in is not None:
        out["modem"] = modem_in
    elif found["freedv"]:
        out["modem"] = FreeDV("1600").tx(out["pcm_tx"])
    else:
        out["modem"] = stream["modem"]
    mod = freedv.FreeDvMod(usb=usb, device=device)
    _, m = mod(mod.init_state(), torch.from_numpy(
        out["modem"].astype(np.float32) / 32765.0).to(device))
    out["iq"] = get_iq(m["iq"])
    if iq_in is None:
        iq = ChannelModel(1_000_000, snr_db=FREEDV_SNR_DB, seed=2)(m["iq"])
        iq_in = get_iq(iq)
    out["channel"] = iq_in
    dem = freedv.FreeDvDemod(usb=usb, device=device)
    _, d = dem(dem.init_state(), put_iq_pair(iq_in, device))
    out["passband"] = d["passband"].cpu().numpy()
    out["pcm_rx"] = np.clip(out["passband"] * 32768.0, -32767,
                            32767).astype(np.int16)
    if found["freedv"]:
        fd = FreeDV("1600")
        out["speech_out"] = fd.rx(out["pcm_rx"]).astype(np.float32) \
            / 32768.0 * 2.0
        out["sync"] = fd.sync
    return out


def freedv_events_close(run, want, got):
    """Controller events in FreeDV: the same kinds and sample times, rssi
    within 1e-3 dB, audio of the same length (decoded speech may draw from
    a generator the process shares, so it is compared by length)."""
    if [e.kind for e in got] != [e.kind for e in want]:
        raise RuntimeError(f"{run}: events {[e.kind for e in got]} on the "
                           f"card, {[e.kind for e in want]} on the CPU")
    for w, g in zip(want, got):
        if g.sample_time != w.sample_time or (
                w.rssi is not None and abs(g.rssi - w.rssi) > 1e-3) or (
                w.audio is not None and g.audio.shape != w.audio.shape):
            raise RuntimeError(f"{run}: event {w.kind} at {w.sample_time} "
                               f"differs")


def freedv_av_part(dev, gen, done, found):
    """FreeDV 1600, USB and LSB (freedv_chain_run on the card, counted, then
    on the CPU with the card's inputs): the band-pass within FIR_TOL of the
    CPU's peak and the int16 PCM for freedv_tx within one LSB (the flips
    counted), FreeDvMod's IQ on the same modem samples and FreeDvDemod's
    passband on the same channel IQ within FREEDV_TOL of the CPU's peak,
    the PCM for freedv_rx within one LSB; with the FreeDV API
    tests/test_freedv.py's gates (sync, more than half the speech, mean
    power above 1e-4). Then one RadioController in FreeDV1600USB RX over
    the USB channel IQ in APP_BLOCK blocks, its events the CPU's
    controller's. Returns ({run: report}, rows)."""
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings

    cpu = torch.device("cpu")
    run = "av_freedv"
    seen = {}
    t0 = time.perf_counter()
    with capture_into(seen, True):
        card, report = card_counted(run, lambda: [
            freedv_chain_run(dev, usb, found) for usb in (True, False)])
    wall = time.perf_counter() - t0
    cpu_runs = []
    want_calls = cpu_launch_table(lambda: cpu_runs.extend(
        freedv_chain_run(cpu, usb, found, c["modem"], c["channel"])
        for usb, c in zip((True, False), card)))
    require_exactly(report, want_calls, run)
    print_stages(run, report)
    flips = {"tx": 0, "rx": 0}
    for usb, c, w in zip(("USB", "LSB"), card, cpu_runs):
        e_bp = host_close(f"FreeDV {usb} band-pass", c["filtered"],
                          w["filtered"], FIR_TOL)
        flips["tx"] += lsb_flips(f"FreeDV {usb} PCM for freedv_tx",
                                 c["pcm_tx"], w["pcm_tx"])
        e_iq = host_close(f"FreeDV {usb} FreeDvMod IQ", c["iq"], w["iq"],
                          FREEDV_TOL)
        e_pb = host_close(f"FreeDV {usb} FreeDvDemod passband",
                          c["passband"], w["passband"], FREEDV_TOL)
        flips["rx"] += lsb_flips(f"FreeDV {usb} PCM for freedv_rx",
                                 c["pcm_rx"], w["pcm_rx"])
        gates = "no FreeDV API here: the stored modem stream, no speech"
        if found["freedv"]:
            n_sp = FREEDV_SECONDS * 8000
            p = float(np.mean(c["speech_out"] ** 2))
            if not (c["sync"] and c["speech_out"].size > n_sp // 2
                    and p > 1e-4):
                raise RuntimeError(f"FreeDV {usb}: sync {c['sync']}, "
                                   f"{c['speech_out'].size} samples, power "
                                   f"{p:.3g}")
            gates = (f"sync, {c['speech_out'].size} speech samples, mean "
                     f"power {p:.3g}")
        print(f"  FreeDV 1600 {usb}: band-pass within {e_bp:.3g} of the "
              f"CPU's, FreeDvMod IQ ({c['iq'].size} samples) within "
              f"{e_iq:.3g}, FreeDvDemod passband within {e_pb:.3g}; "
              f"{gates}", flush=True)
    stored = lsb_flips("FreeDV PCM for freedv_tx against the stored "
                       "stream's", card[0]["pcm_tx"],
                       np.load(FREEDV_STREAM)["pcm"])
    print(f"  FreeDV 1600: the card's PCM for freedv_tx {stored} samples "
          f"one LSB from the stored stream's (the JAX band-pass on a CPU); "
          f"{flips['tx']} of {2 * card[0]['pcm_tx'].size} "
          f"PCM samples for freedv_tx and {flips['rx']} of "
          f"{2 * card[0]['pcm_rx'].size} for freedv_rx one LSB from the "
          f"CPU's; {wall * 1e3 / (2 * FREEDV_SECONDS):.1f} ms of wall time "
          f"a second of audio, TX and RX ({CARD})", flush=True)
    rows = captured_rows(seen, launch_counts(report), run, done, dev, gen)
    reports = {run: report}

    iq = card[0]["channel"]
    iq = iq[:iq.size - iq.size % APP_BLOCK].reshape(-1, APP_BLOCK)

    def ctl_events(device):
        c = RadioController(Settings(rx_mode="FreeDV1600USB"),
                            device=device)
        c.toggle_rx_mode("FreeDV1600USB")
        return rx_blocks(c, iq)

    run = "av_freedv_rx_block"
    t0 = time.perf_counter()
    events, want = app_counted(run, lambda: ctl_events(dev),
                               lambda: ctl_events(cpu))
    wall = time.perf_counter() - t0
    freedv_events_close(run, want, events)
    audio = [e.audio.size for e in events if e.kind == "audio"]
    if found["freedv"] and not audio:
        raise RuntimeError(f"{run}: no audio event")
    print(f"  FreeDV1600USB through rx_block: {len(events)} events, the "
          f"CPU's: {sum(e.kind == 'rssi' for e in events)} rssi, "
          f"{len(audio)} audio ({sum(audio)} samples"
          f"{'' if found['freedv'] else ': no FreeDV API here'}); "
          f"{wall * 1e3 / (iq.size / 1e6):.1f} ms of wall time a second of "
          f"air, card and CPU ({CARD})", flush=True)
    return reports, rows


def mixer_run(device, pcms_48k, pcms_8k):
    """One UdpAudioClient on `device` (48 kHz wire): each 48 kHz read
    through the 48k -> 8k resampler and each 8 kHz write through the 8k ->
    48k one as the client runs them (_resample), beside the float output
    that it truncates. Returns [(floats, int16)] of the reads, then the
    writes."""
    from qradiolink_tpu_torch.audio.mixer import UdpAudioClient

    c = UdpAudioClient(listen_port=0, send_port=0, device=device)
    out = []
    try:
        for rs, M, pcms in ((c._rs_down, c._down[1], pcms_48k),
                            (c._rs_up, c._down[0], pcms_8k)):
            for pcm in pcms:
                x = pcm.astype(np.float32) / 32768.0
                x = np.concatenate([x, np.zeros((-x.size) % M, np.float32)])
                _, y = rs[0](rs[1].clone(), torch.from_numpy(x).to(device))
                out.append((y.cpu().numpy(), c._resample(rs, pcm, M)))
    finally:
        c.close()
    return out


def mixer_av_part(dev, gen, done):
    """UdpAudioClient's resamplers on the card (counted) and the CPU over
    MIXER_READS and MIXER_WRITES: each float output within MIXER_TOL of the
    CPU's peak, the int16 within one LSB (flips counted); then two card
    clients on 127.0.0.1 carry a 400 Hz tone 8k -> 48k -> UDP -> 8k, its
    peak within 20 Hz (tests/test_mixer.py:35-56). Returns ({run: report},
    rows)."""
    from qradiolink_tpu_torch.audio.mixer import UdpAudioClient

    rng = np.random.default_rng(11)

    def tone(n, rate):
        t = np.arange(n) / rate
        return (9000 * np.sin(2 * np.pi * 400 * t)
                + 2000 * rng.standard_normal(n)).astype(np.int16)

    pcms_48k = [tone(n, 48_000.0) for n in MIXER_READS]
    pcms_8k = [tone(n, 8000.0) for n in MIXER_WRITES]
    run = "av_mixer"
    seen = {}
    cpu_out = []
    want_calls = cpu_launch_table(lambda: cpu_out.extend(
        mixer_run(torch.device("cpu"), pcms_48k, pcms_8k)))
    with capture_into(seen, True):
        got, report = card_counted(run, lambda: mixer_run(dev, pcms_48k,
                                                          pcms_8k))
    require_exactly(report, want_calls, run)
    print_stages(run, report)
    errs, flips = [], 0
    for k, ((gf, gi), (wf, wi)) in enumerate(zip(got, cpu_out)):
        errs.append(host_close(f"mixer resampler call {k}", gf, wf,
                               MIXER_TOL) / float(np.abs(wf).max()))
        flips += lsb_flips(f"mixer resampler call {k}", gi, wi)
    rows = captured_rows(seen, launch_counts(report), run, done, dev, gen)

    rx = UdpAudioClient(listen_port=0, send_port=0, device=dev)
    tx = UdpAudioClient(listen_port=0, send_port=rx.port, device=dev)
    try:
        t0 = time.perf_counter()
        tx.write_audio(tone(8000, 8000.0))
        back = np.zeros(0, np.int16)
        end = time.monotonic() + PEER_WAIT_MS / 1000
        while back.size < 6000 and time.monotonic() < end:
            time.sleep(0.005)
            back = np.concatenate([back, rx.read_audio()])
        wall = time.perf_counter() - t0
    finally:
        rx.close()
        tx.close()
    x = back[1000:6000].astype(np.float64)
    f = np.fft.rfftfreq(x.size, 1 / 8000)
    peak = float(f[np.argmax(np.abs(np.fft.rfft(x * np.hanning(x.size)))[1:])
                   + 1]) if x.size else 0.0
    if back.size < 6000 or abs(peak - 400.0) >= 20.0:
        raise RuntimeError(f"mixer round trip: {back.size} samples, peak at "
                           f"{peak} Hz")
    print(f"  mixer: {len(got)} resampler calls ({len(MIXER_READS)} 48 kHz "
          f"reads of {list(MIXER_READS)} samples, {len(MIXER_WRITES)} 8 kHz "
          f"writes), each float output within {max(errs):.3g} of the CPU's "
          f"peak, {flips} int16 samples one LSB apart; the UDP round trip "
          f"8k -> 48k -> 8k: {back.size} samples, the tone at {peak:.1f} Hz, "
          f"{wall * 1e3:.1f} ms of wall time for its 1 s of audio ({CARD})",
          flush=True)
    return {run: report}, rows


def processor_run(device, mode, denoise, audio):
    """RadioController TX in `mode` on `device` with audio_compressor (and
    audio_denoise): PROC_BLOCKS blocks of `audio`. Returns (the IQ blocks,
    the processor's PCM out a block, its state leaves)."""
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.audio.processor import AudioProcessor
    from qradiolink_tpu_torch.config import Settings

    c = RadioController(Settings(tx_mode=mode, audio_compressor=True,
                                 audio_denoise=denoise, agc_attack=3,
                                 agc_decay=70), device=device)
    c.start_transmission()
    pcm, orig = [], AudioProcessor.write_preprocess

    def write_preprocess(self, *a, **k):
        y = orig(self, *a, **k)
        pcm.append(y)
        return y

    AudioProcessor.write_preprocess = write_preprocess
    try:
        iqs = [c.tx_audio_block(b) for b in
               np.split(audio[:PROC_BLOCK * PROC_BLOCKS], PROC_BLOCKS)]
    finally:
        AudioProcessor.write_preprocess = orig
    ap = c._audio_proc
    state = [ap._bp_tail] + [getattr(comp, n) for comp in ap._comp.values()
                             for n in ("detectoravg", "compgain",
                                       "maxcompdiffdb", "_delay", "_wr",
                                       "_rd")]
    if ap.denoiser is not None:
        state += [getattr(ap.denoiser, n) for n in
                  ("noise", "psd_s", "_in_tail", "_ola_tail", "agc_gain")]
    return iqs, pcm, state


def processor_av_part(dev, found):
    """The TX audio processor through RadioController.tx_audio_block:
    FM with audio_compressor, USB with audio_compressor and audio_denoise,
    and 4FSK2K (Codec2) with audio_compressor where libcodec2 loads, on
    the card and on the CPU (app_counted), on two tones keyed 120 ms in
    200 (silence first, the denoiser's noise estimate learning from the
    gaps) in light noise: the processor's PCM and every state leaf equal
    bit for bit (host numpy), the last block's PCM above 0.1 (the
    compressor's gain has opened), the IQ within PROC_TX_TOL of the CPU's
    peak; FM's IQ, whose f32 phase cumsum drifts from the CPU's (PR 20's
    finding), is printed (fm_drift) and held through the CPU's RX in
    recorder_av_part. Returns ({mode: the card's IQ}, {mode: the CPU's}),
    each one array."""
    rng = np.random.default_rng(13)
    t = np.arange(PROC_BLOCK * PROC_BLOCKS) / 8000.0
    audio = (((t % 0.2) >= 0.08) * (0.6 * np.sin(2 * np.pi * 440 * t)
                                    + 0.3 * np.sin(2 * np.pi * 1270 * t))
             + 0.01 * rng.standard_normal(t.size)).astype(np.float32)
    card_iq, cpu_iq = {}, {}
    for mode, denoise in PROC_MODES.items():
        if mode == "4FSK2K" and not found["codec2"]:
            print("  processor 4FSK2K (Codec2): not run, libcodec2 is "
                  "missing here (digital voice TX needs it)", flush=True)
            continue
        run = f"av_processor {mode}"
        t0 = time.perf_counter()
        (iqs, pcm, state), (w_iqs, w_pcm, w_state) = app_counted(
            run, lambda: processor_run(dev, mode, denoise, audio),
            lambda: processor_run("cpu", mode, denoise, audio))
        wall = time.perf_counter() - t0
        if len(pcm) != len(w_pcm) or not all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(pcm, w_pcm)):
            raise RuntimeError(f"{run}: the processor's PCM differs")
        if len(state) != len(w_state) or not all(
                np.array_equal(a, b) for a, b in zip(state, w_state)):
            raise RuntimeError(f"{run}: a processor state leaf differs")
        if not float(np.abs(pcm[-1]).max()) > 0.1:
            raise RuntimeError(f"{run}: the processor's last block peaks at "
                               f"{float(np.abs(pcm[-1]).max()):.3g}")
        card_iq[mode], cpu_iq[mode] = np.concatenate(iqs), \
            np.concatenate(w_iqs)
        if mode == "FM":
            held = fm_drift(card_iq[mode], cpu_iq[mode])
        else:
            err = max(host_close(f"{run} IQ block {k}", g, w, PROC_TX_TOL)
                      / float(np.abs(w).max())
                      for k, (g, w) in enumerate(zip(iqs, w_iqs)))
            held = f"within {err:.3g} of its peak"
        print(f"  processor {mode} (compressor"
              f"{', denoiser' if denoise else ''}): the PCM (last block's "
              f"peak {float(np.abs(pcm[-1]).max()):.3f}) and "
              f"{len(state)} state leaves the CPU's bit for bit, the IQ "
              f"({card_iq[mode].size} samples) {held}; "
              f"{wall * 1e3 / (audio.size / 8000):.1f} ms of wall time a "
              f"second of audio, card and CPU ({CARD})", flush=True)
    return card_iq, cpu_iq


def fm_drift(got, want):
    """How the card's FM IQ differs from the CPU's (as fm_phase_drift):
    the largest difference and the phase between the two, its largest
    value and its largest change a sample."""
    d = np.angle(got.astype(np.complex128) * np.conj(want))
    return (f"within {float(np.abs(got - want).max()):.3g} of the CPU's "
            f"(the phase between them at most {float(np.abs(d).max()):.3g} "
            f"rad, its change a sample at most "
            f"{float(np.abs(np.diff(d)).max()):.3g} rad; held through the "
            f"CPU's RX by the recorder)")


def recorder_run(device, blocks, tmp):
    """`setaudiorecorder 1` through a CommandProcessor in `tmp` (its
    AudioRecorder in the working directory), FM RX of `blocks`, then
    `setaudiorecorder 0`. Returns (answers, events, the FLAC's path)."""
    from qradiolink_tpu_torch.app.command import CommandProcessor
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings

    tmp.mkdir()
    cp = CommandProcessor(RadioController(Settings(rx_mode="FM"),
                                          device=device))
    with contextlib.chdir(tmp):
        answers = [cp.process(v) for v in ("recordstatus",
                                           "setaudiorecorder 1",
                                           "recordstatus")]
        cp.ctl.toggle_rx_mode("FM")
        events = rx_blocks(cp.ctl, blocks)
        answers += [cp.process("setaudiorecorder 0"),
                    cp.process("recordstatus")]
    (path,) = list(tmp.iterdir())
    return answers, events, path


def recorder_av_part(dev, fm_iq, fm_iq_cpu, tmp):
    """setaudiorecorder 1, FM RX of the processor part's card IQ (fm_iq)
    in APP_BLOCK blocks, setaudiorecorder 0, on the card and on the CPU
    (app_counted): the answers the CPU's; the FLAC decodes (read_flac) to
    exactly the int16 samples of the audio events the recorder was given;
    the card's within one LSB of the CPU's. Then the CPU's RX of the CPU's
    TX IQ (fm_iq_cpu): its FLAC within one LSB of the CPU's RX of the
    card's, which holds the card's FM TX to the CPU's. Returns the card's
    events."""
    from qradiolink_tpu_torch.audio.flac import read_flac

    def whole(iq):
        return iq[:iq.size - iq.size % APP_BLOCK].reshape(-1, APP_BLOCK)

    blocks = whole(fm_iq)
    run = "av_recorder"
    t0 = time.perf_counter()
    (answers, events, path), (w_answers, w_events, w_path) = app_counted(
        run, lambda: recorder_run(dev, blocks, tmp / "card"),
        lambda: recorder_run("cpu", blocks, tmp / "cpu"))
    wall = time.perf_counter() - t0
    if answers != w_answers or answers[1] != "Setting audio recording to 1":
        raise RuntimeError(f"{run}: answers {answers}, the CPU's "
                           f"{w_answers}")
    same_events(run, w_events, events)
    samples, rate = read_flac(path)
    want = np.concatenate([np.clip(e.audio * 32767.0, -32767, 32767).astype(
        np.int16) for e in events if e.kind == "audio"])
    if rate != 8000 or not np.array_equal(samples, want):
        raise RuntimeError(f"{run}: the FLAC holds {samples.size} samples at "
                           f"{rate} Hz, the events {want.size}")
    flips = lsb_flips(run, samples, read_flac(w_path)[0])
    _, _, cc_path = recorder_run("cpu", whole(fm_iq_cpu), tmp / "cpu_tx")
    tx_flips = lsb_flips("FM TX through the CPU's RX", read_flac(w_path)[0],
                         read_flac(cc_path)[0])
    print(f"  recorder: {answers}; {path.name} decodes to the "
          f"{samples.size} samples of the {len(blocks)} blocks' audio "
          f"events, {flips} one LSB from the CPU's file; the CPU's RX of "
          f"the CPU's FM TX IQ {tx_flips} one LSB from its RX of the "
          f"card's; "
          f"{wall * 1e3 / (samples.size / 8000):.1f} ms of wall time a "
          f"second of audio, card and CPU ({CARD})", flush=True)
    return events


def video_test_image():
    """tests/test_video.py:12-19: 320x240 gradient and blocks."""
    y, x = np.mgrid[0:240, 0:320]
    return np.stack([(x * 255 // 320).astype(np.uint8),
                     (y * 255 // 240).astype(np.uint8),
                     (((x // 40 + y // 40) % 2) * 200).astype(np.uint8)],
                    axis=-1)


def video_session(device, seen=None):
    """QPSKVideo through RadioControllers on `device`: VIDEO_PRE bytes,
    tx_video_frame of video_test_image, VIDEO_TAIL bytes (tx_bytes), then a
    clean channel into another controller's rx_block in VIDEO_BLOCK blocks.
    seen: call_capture's calls of the frame's TX and the first RX block.
    Returns a dict of the results."""
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings
    from qradiolink_tpu_torch.video import encode_jpeg_frame

    s = Settings(rx_mode="QPSKVideo", tx_mode="QPSKVideo")
    tx = RadioController(s, device=device)
    tx.toggle_tx_mode("QPSKVideo")
    t0 = time.perf_counter()
    parts = [tx.tx_bytes(b"\xaa" * VIDEO_PRE)]
    with capture_into(seen, True):
        t1 = time.perf_counter()
        parts.append(tx.tx_video_frame(video_test_image()))
        tx_ms = (time.perf_counter() - t1) * 1e3
    parts.append(tx.tx_bytes(b"\xaa" * VIDEO_TAIL))
    iq = np.concatenate(parts)
    rx = RadioController(Settings(rx_mode="QPSKVideo"), device=device)
    rx.toggle_rx_mode("QPSKVideo")
    events, rx_ms = [], []
    for k, i in enumerate(range(0, iq.size - iq.size % VIDEO_BLOCK,
                                VIDEO_BLOCK)):
        with capture_into(seen, k == 0):
            t1 = time.perf_counter()
            events += rx.rx_block(iq[i:i + VIDEO_BLOCK])
            rx_ms.append((time.perf_counter() - t1) * 1e3)
    return dict(parts=parts, events=events, tx_ms=tx_ms, rx_ms=rx_ms,
                wall_s=time.perf_counter() - t0,
                frame=encode_jpeg_frame(video_test_image()))


def video_cpu_twin():
    """video_session on the CPU and its calls (cpu_launch_table), in a
    process of its own (two threads; no card)."""
    torch.set_num_threads(2)
    out = []
    want = cpu_launch_table(lambda: out.append(video_session("cpu")))
    return want, out[0]


def video_av_part(dev, gen, done, twin):
    """video_session on the card (counted) against its CPU twin (`twin`, a
    future of video_cpu_twin): the launches the CPU's calls; the TX parts
    within NET_TX_TOL of the CPU's peak (QpskMod's bound); one `video`
    event whose JPEG bytes equal those sent and the CPU run's, decoding to
    a 240 x 320 image; the RX events the CPU's (same_events). A row for
    each kernel shape of the frame's TX and the first RX block that no
    earlier row has. Returns ({run: report}, rows)."""
    run = "av_video"
    seen = {}
    got, report = card_counted(run, lambda: video_session(dev.type, seen))
    print_stages(run, report)
    rows = captured_rows(seen, launch_counts(report), run, done, dev, gen)
    want_calls, want = twin.result(timeout=900)
    require_exactly(report, want_calls, run)
    if [p.shape for p in got["parts"]] != [p.shape for p in want["parts"]]:
        raise RuntimeError(f"{run}: TX parts differ in shape")
    err = max(host_close(f"{run} TX part {k}", g, w, NET_TX_TOL)
              / float(np.abs(w).max())
              for k, (g, w) in enumerate(zip(got["parts"], want["parts"])))
    vids = [e for e in got["events"] if e.kind == "video"]
    if len(vids) != 1 or vids[0].payload != got["frame"] \
            or got["frame"] != want["frame"] or vids[0].image is None \
            or vids[0].image.shape != (240, 320, 3):
        raise RuntimeError(f"{run}: {len(vids)} video events, the frame "
                           f"{'as sent' if vids and vids[0].payload == got['frame'] else 'not as sent'}")
    same_events(run, want["events"], got["events"])
    print(f"  video: one video event, its {len(got['frame'])} JPEG bytes "
          f"those sent and the CPU run's; the TX IQ ({len(got['parts'])} "
          f"parts) within {err:.3g} of the CPU's peak; tx_video_frame "
          f"{got['tx_ms']:.1f} ms, RX median "
          f"{statistics.median(got['rx_ms'][1:]):.3f} ms a {VIDEO_BLOCK}-"
          f"sample block; {got['wall_s'] * 1e3:.1f} ms of wall time for the "
          f"frame, TX and RX ({CARD})", flush=True)
    return {run: report}, rows


class MumblePeer:
    """A Mumble server on 127.0.0.1 for one client, plain TCP
    (tests/test_mumble.py's FakeServer): on Authenticate the channel tree
    and ServerSync (session MUMBLE_SESSION); it keeps every message it
    receives and sends what `say` queues. Its thread ends at `close`."""

    def __init__(self):
        import queue
        import socket
        import threading

        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(1)
        self.srv.settimeout(PEER_WAIT_MS / 1000)
        self.port = self.srv.getsockname()[1]
        self.received, self.outbox = [], queue.Queue()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def say(self, mtype, payload):
        self.outbox.put((mtype, payload))

    def _serve(self):
        import socket
        import struct

        from qradiolink_tpu_torch.framing.layer2 import _pb_str, _pb_uint
        from qradiolink_tpu_torch.voip import mumble

        c, _ = self.srv.accept()
        c.settimeout(0.01)
        buf = b""
        try:
            while not self.stop.is_set():
                while not self.outbox.empty():
                    t, p = self.outbox.get()
                    c.sendall(struct.pack(">HI", t, len(p)) + p)
                try:
                    chunk = c.recv(65536)
                except socket.timeout:
                    continue
                if not chunk:
                    break
                buf += chunk
                while len(buf) >= 6:
                    t, n = struct.unpack(">HI", buf[:6])
                    if len(buf) < 6 + n:
                        break
                    self.received.append((t, buf[6:6 + n]))
                    buf = buf[6 + n:]
                    if t == mumble.MSG_AUTHENTICATE:
                        self.say(mumble.MSG_CHANNELSTATE,
                                 _pb_uint(1, 0) + _pb_str(3, "Root"))
                        self.say(mumble.MSG_SERVERSYNC,
                                 _pb_uint(1, MUMBLE_SESSION))
        finally:
            c.close()
            self.srv.close()

    def texts(self):
        from qradiolink_tpu_torch.framing.layer2 import _pb_scan
        from qradiolink_tpu_torch.voip import mumble

        return [dict((k, v) for k, _w, v in _pb_scan(p)).get(5, b"").decode()
                for t, p in self.received if t == mumble.MSG_TEXTMESSAGE]

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)
        if self.thread.is_alive():
            raise RuntimeError("the Mumble peer's thread did not end")


def poll_until(client, done, what):
    end = time.monotonic() + PEER_WAIT_MS / 1000
    while not done() and time.monotonic() < end:
        client.poll()
        time.sleep(0.002)
    if not done():
        raise RuntimeError(f"voip: no {what} within {PEER_WAIT_MS} ms")


def voip_av_part(dev, audio_events, found):
    """VOIP through the port's MumbleClient (plain TCP) and a MumblePeer:
    `connectserver` through the CommandProcessor of a card controller
    with the client attached;
    the card's FM RX audio events (recorder_av_part's) through
    VoipForwarder.radio_rx_audio, leaving as Opus voice packets (where
    libopus loads; without it the forwarder has no codec and sends none, as
    the JAX forwarder); a private text `rxstatus` from the peer answered
    through the forwarder; `mumblemsg`, `mutemumble`, `disconnectserver`.
    Every answer equals a CPU controller's processor's for the same
    verb (rxstatus) or the JAX processor's text (the others,
    tests/test_torch_video_voip.py)."""
    from qradiolink_tpu_torch.app.command import CommandProcessor
    from qradiolink_tpu_torch.app.controller import RadioController
    from qradiolink_tpu_torch.config import Settings
    from qradiolink_tpu_torch.framing.layer2 import _pb_str, _pb_uint
    from qradiolink_tpu_torch.voip import VoipForwarder, mumble

    peer = MumblePeer()
    cl = mumble.MumbleClient("127.0.0.1", peer.port, username="N0TPU",
                             use_ssl=False)
    cp = CommandProcessor(RadioController(Settings(), device=dev), voip=cl)
    ref = CommandProcessor(RadioController(Settings(), device="cpu"))
    try:
        t0 = time.perf_counter()
        answers = [cp.process(f"connectserver 127.0.0.1 {peer.port}")]
        poll_until(cl, lambda: cl.synchronized, "ServerSync")
        fwd = VoipForwarder(cl, command_processor=cp)
        pcm = np.concatenate([e.audio for e in audio_events
                              if e.kind == "audio"])
        fwd.radio_rx_audio(pcm)
        n_voice = (pcm.size // 320) if fwd.codec is not None else 0
        poll_until(cl, lambda: sum(t == mumble.MSG_UDPTUNNEL for t, _ in
                                   peer.received) >= n_voice, "voice")
        peer.say(mumble.MSG_TEXTMESSAGE, _pb_uint(1, 33)
                 + _pb_uint(2, MUMBLE_SESSION) + _pb_str(5, "rxstatus"))
        want_text = ref.process("rxstatus")
        poll_until(cl, lambda: want_text in peer.texts(), "text answer")
        answers += [cp.process(v) for v in ("voipstatus", "mumblemsg hello",
                                            "mutemumble 1")]
        poll_until(cl, lambda: "hello" in peer.texts(), "mumblemsg")
        answers.append(cp.process("disconnectserver"))
        answers.append(cp.process("voipstatus"))
        wall = time.perf_counter() - t0
    finally:
        cl.close()
        peer.close()
    want = [f"Connecting to server 127.0.0.1 port {peer.port}",
            "VOIP connected", "Sending message: hello",
            "Setting Mumble mute to 1", "Disconnected from VOIP server",
            "VOIP disconnected"]
    if answers != want:
        raise RuntimeError(f"voip: answers {answers}, want {want}")
    voice = [p for t, p in peer.received if t == mumble.MSG_UDPTUNNEL]
    if len(voice) != n_voice or any(p[0] >> 5 != mumble.VOICE_OPUS
                                    for p in voice):
        raise RuntimeError(f"voip: {len(voice)} voice packets, want "
                           f"{n_voice}")
    print(f"  voip: connectserver, {len(voice)} Opus voice packets from "
          f"{pcm.size} samples of the card's FM RX audio"
          f"{'' if found['opus'] else ' (libopus is missing here: the forwarder has no codec and sends none, as the JAX one)'}"
          f", `rxstatus` by private text answered {want_text!r} (the CPU "
          f"controller's answer), mumblemsg, mutemumble, disconnectserver: "
          f"{answers}; {wall * 1e3:.1f} ms of wall time ({CARD})",
          flush=True)


def audio_video_voip_phase(dev, gen, done):
    """The application's audio, FreeDV vocoder, video and VOIP on the card
    (slice 9), each part against the same work on CPU tensors, after the
    probe (probe_av): freedv_av_part, mixer_av_part, processor_av_part,
    recorder_av_part, video_av_part (its CPU twin in a spawned process
    while the other parts run), voip_av_part. Returns ({run: report},
    rows)."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    found = probe_av()
    t0 = time.perf_counter()
    reports, rows = {}, []
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        twin = pool.submit(video_cpu_twin)
        rep, new = freedv_av_part(dev, gen, done, found)
        reports.update(rep)
        rows += new
        rep, new = mixer_av_part(dev, gen, done)
        reports.update(rep)
        rows += new
        card_iq, cpu_iq = processor_av_part(dev, found)
        (HERE / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
            events = recorder_av_part(dev, card_iq["FM"], cpu_iq["FM"],
                                      pathlib.Path(tmp))
        voip_av_part(dev, events, found)
        rep, new = video_av_part(dev, gen, done, twin)
        reports.update(rep)
        rows += new
    print(f"  audio_video_voip phase: {time.perf_counter() - t0:.1f} s",
          flush=True)
    return reports, rows


# -- slice 10: scale-out on torch.distributed, and the last parts ------------
SCALE_SEED = 2300
SCALE_STEPS = 2
SCALE_RANKS = 2
RANK_TIMEOUT_S = 420
TS_LOCAL, TS_HALO = 768_000, 64_000  # a multiple of one Viterbi tile; one
TS_BYTES = 400                       # tile (tests/test_time_sharded.py)
TSF_LOCAL = 1 << 20                  # the time-sharded FIR's samples a rank
TS_HEAD_MISMATCHES = 16              # tests/test_time_sharded.py:59
SYM_TOL = 1e-5                       # the channel-sharded symbols
MIXED_SYM_TOL = 1e-4                 # tests/test_torch_mixed.py OUT_TOL
TSF_TOL = 1e-4                       # tests/test_time_sharded.py:78
PARTS_ROWS = 256
PARTS_CPU_ROWS = 8
VV_CPU_ROWS = 64
VV_TOL = 1e-4                        # corrected IQ, of its peak, and rad


def scale_fsk_block(i, dev):
    """Step i's global block of the channel-sharded main path, made on the
    card from the phase's seed: the same numbers in every process."""
    from qradiolink_tpu_torch.core import IqPair

    g = torch.Generator(device=dev)
    g.manual_seed(SCALE_SEED + i)
    return IqPair(*(torch.randn((N_CH, T_STEP), generator=g, device=dev)
                    * 0.1 for _ in range(2)))


def scale_mixed_block(i, dev):
    """Step i's wideband block of the mixed config (bench.py:136-137:
    complex normal IQ at 0.05 RMS a plane)."""
    from qradiolink_tpu_torch.core import IqPair

    g = torch.Generator(device=dev)
    g.manual_seed(SCALE_SEED + 100 + i)
    return IqPair(*(torch.randn((MIX_M * MIX_T,), generator=g, device=dev)
                    * 0.05 for _ in range(2)))


def scale_fir_input(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(SCALE_SEED + 200)
    return torch.randn((SCALE_RANKS * TSF_LOCAL,), generator=g, device=dev)


def scale_fir_taps():
    from qradiolink_tpu_torch.ops import firdes

    return firdes.low_pass(1.0, 1e6, 100e3, 50e3)  # test_time_sharded.py:72


def event_ms(fn):
    """fn() between CUDA events: (its result, device ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    y = fn()
    end.record()
    end.synchronize()
    return y, round(start.elapsed_time(end), 3)


def steps_on_card(fn, state, blocks, keep):
    """state, out = fn(state, block()) for each block maker in turn, each
    step timed by CUDA events; returns (state, [{key: numpy}] a step, step
    ms)."""
    outs, ms = [], []
    for make in blocks:
        x = make()
        (state, out), t = event_ms(lambda: fn(state, x))
        outs.append(keep(out))
        ms.append(t)
        del x
    return state, outs, ms


def fsk_keep(out):
    return {"bits": out["bits"].cpu().numpy(),
            "symbols": out["symbols"].cpu().numpy()}


def mixed_keep(outs):
    """The mixed step's outputs a group (None where this rank holds no row
    of a group)."""
    fsk, nb = outs
    kept = {}
    if fsk is not None:
        kept.update(fsk_keep(fsk))
    if nb is not None:
        kept["audio"] = nb["audio"].cpu().numpy()
    return kept


def time_sharded_signal(dev):
    """tests/test_time_sharded.py's signal: 400 seeded bytes through the
    port's Fsk4Mod on the card, zero-padded or cut to the ranks' span."""
    from qradiolink_tpu_torch.chains.fsk import Fsk4Mod

    data = np.random.default_rng(5).integers(0, 256, TS_BYTES)
    mod = Fsk4Mod(device=dev)
    iq = mod(mod.init_state(), torch.from_numpy(data.astype(np.uint8)).to(
        dev))[1]["iq"].cpu().numpy()
    out = np.zeros(SCALE_RANKS * TS_LOCAL, np.complex64)
    out[:min(len(iq), out.size)] = iq[:out.size]
    return out


def pair_of(iq, dev):
    from qradiolink_tpu_torch.core import IqPair

    return IqPair(torch.from_numpy(np.ascontiguousarray(iq.real)).to(dev),
                  torch.from_numpy(np.ascontiguousarray(iq.imag)).to(dev))


def scale_out_references(dev, tmp):
    """The single-process runs the ranks are held to, on the card: the main
    path on all N_CH rows, the mixed config, the serial chain and FIR over
    the whole stream. Writes the time-sharded signal for the ranks."""
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.ops.fir import FirFilter
    from qradiolink_tpu_torch.parallel.sharding import MultichannelRx

    ref = {}
    chain = Fsk4DemodFF(lead_shape=(N_CH,), device=dev)
    _, ref["fsk"], ref["fsk_ms"] = steps_on_card(
        chain, chain.init_state(),
        [lambda i=i: scale_fsk_block(i, dev) for i in range(SCALE_STEPS)],
        fsk_keep)
    del chain
    rx = MultichannelRx(MIX_M, mixed_groups(), device=dev)
    _, ref["mixed"], ref["mixed_ms"] = steps_on_card(
        rx, rx.init_state(),
        [lambda i=i: scale_mixed_block(i, dev) for i in range(SCALE_STEPS)],
        mixed_keep)
    del rx
    iq = time_sharded_signal(dev)
    np.save(tmp / "ts_iq.npy", iq)
    chain = Fsk4DemodFF(sync_window=320, device=dev)
    out, ref["ts_ms"] = event_ms(
        lambda: chain(chain.init_state(), pair_of(iq, dev))[1])
    ref["ts_bits"] = out["bits"].cpu().numpy()
    fir = FirFilter(scale_fir_taps(), device=dev)
    x = scale_fir_input(dev)
    y, ref["tsf_ms"] = event_ms(lambda: fir(fir.init_state(), x)[1])
    ref["tsf"] = y.cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ref


def counted_part(reports, name, fn, every=(), never=()):
    """fn() with the launch counters zeroed just before and read just
    after: nothing may take a plain path, every op of `every` must launch
    on each of the SCALE_STEPS steps, no op of `never` at all."""
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    kernel_paths.reset()
    out = fn()
    torch.cuda.synchronize()
    report = kernel_paths.report()
    reports[name] = report
    if not kernel_paths.served_only():
        raise RuntimeError(f"{name}: a stage took the plain path on the "
                           f"card: {json.dumps(report)}")
    for op in every:
        if kernel_paths.launches(op) < SCALE_STEPS:
            raise RuntimeError(f"{name}: {op} did not launch every step")
    for op in never:
        if kernel_paths.launches(op):
            raise RuntimeError(f"{name}: {op} launched")
    return out


def scale_out_rank(rank, port, tmp, device):
    """One rank of scale_out_phase, in a process of its own on `device`
    (cuda:0 for every rank) over gloo: the channel-sharded main path
    (multihost: each rank ingests its rows of the global block),
    MultichannelRx over the mesh, the time-sharded chain and FIR. Saves
    its outputs, kernel reports and step ms under tmp."""
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.core import IqPair
    from qradiolink_tpu_torch.parallel import multihost, sharding

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = pathlib.Path(tmp)
    dev = multihost.init_process(f"127.0.0.1:{port}", SCALE_RANKS, rank,
                                 backend="gloo", device=device,
                                 timeout_s=RANK_TIMEOUT_S)
    reports, ms, saved = {}, {}, {}
    try:
        mesh = multihost.pod_mesh(device=dev)
        rows = multihost.local_channel_slice(N_CH)
        chain = Fsk4DemodFF(lead_shape=(N_CH // mesh.size,), device=dev)
        step = multihost.multihost_step(chain, mesh)

        def ingest(i):
            g = scale_fsk_block(i, dev)
            return multihost.distribute_channels(
                IqPair(g.re[rows], g.im[rows]), N_CH, mesh)

        _, outs, ms["fsk"] = counted_part(
            reports, "fsk", lambda: steps_on_card(
                step, chain.init_state(),
                [lambda i=i: ingest(i) for i in range(SCALE_STEPS)],
                fsk_keep), FSK_EVERY_STEP)
        for i, o in enumerate(outs):
            saved.update({f"fsk_{k}{i}": v for k, v in o.items()})
        del chain, step
        torch.cuda.empty_cache()

        mesh_ch = sharding.make_mesh(axis="ch", device=dev)
        rx = sharding.MultichannelRx(MIX_M, mixed_groups(), mesh=mesh_ch)
        _, outs, ms["mixed"] = counted_part(
            reports, "mixed", lambda: steps_on_card(
                rx.step(), rx.init_state(),
                [lambda i=i: scale_mixed_block(i, dev)
                 for i in range(SCALE_STEPS)], mixed_keep),
            MIXED_EVERY_STEP, ("fir_stream_f32", "pfb_channelize_f32"))
        for i, o in enumerate(outs):
            saved.update({f"mixed_{k}{i}": v for k, v in o.items()})
        saved["mixed_rows"] = np.concatenate([idxs for _, idxs in rx.groups])
        del rx
        torch.cuda.empty_cache()

        mesh_t = sharding.make_mesh(axis="t", device=dev)
        iq = np.load(tmp / "ts_iq.npy")
        lo = mesh_t.index * TS_LOCAL
        fn = sharding.time_sharded_chain(
            Fsk4DemodFF(sync_window=320, device=dev), mesh_t, halo=TS_HALO,
            out_keys=("bits",))
        x = pair_of(iq[lo:lo + TS_LOCAL], dev)
        out, ms["ts"] = counted_part(
            reports, "time_chain", lambda: event_ms(lambda: fn(x)))
        saved["ts_bits"] = out["bits"].cpu().numpy()
        fir = sharding.time_sharded_fir(scale_fir_taps(), mesh_t)
        x = scale_fir_input(dev)[mesh_t.index * TSF_LOCAL:
                                 (mesh_t.index + 1) * TSF_LOCAL]
        y, ms["tsf"] = counted_part(
            reports, "time_fir", lambda: event_ms(lambda: fir(x)))
        saved["tsf"] = y.cpu().numpy()
        np.savez(tmp / f"rank{rank}.npz", **saved)
        (tmp / f"rank{rank}.json").write_text(json.dumps(
            {"reports": reports, "ms": ms, "device": str(dev)}))
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    print(f"rank {rank}: done", flush=True)
    return 0


def spawn_ranks(tmp, device):
    """SCALE_RANKS processes of this script, each a rank on `device` over
    gloo; returns each rank's (arrays, json). Fails with their output where
    one fails; none outlives the call."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    logs = [open(tmp / f"rank{r}.log", "w+") for r in range(SCALE_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, str(HERE / "chip_smoke.py"), "--scale-out-rank",
         str(r), str(port), str(tmp), device], stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(SCALE_RANKS)]
    try:
        for p in procs:
            p.wait(timeout=RANK_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failed.append(f"rank {r} (exit {p.returncode}):\n"
                          + "\n".join(text.splitlines()[-40:]))
    if failed:
        raise RuntimeError("a rank failed:\n" + "\n".join(failed))
    out = []
    for r in range(SCALE_RANKS):
        with np.load(tmp / f"rank{r}.npz") as f:
            out.append((dict(f), json.loads(
                (tmp / f"rank{r}.json").read_text())))
    return out


def ts_contract(what, got, want, per_shard):
    """The time-sharded contract (tests/test_time_sharded.py:52-60): equal
    beyond the first shard (its first per_shard bits), at most
    TS_HEAD_MISMATCHES differences in it. Returns the head's
    differences."""
    if got.shape != want.shape:
        raise RuntimeError(f"{what}: shape {got.shape} != {want.shape}")
    n_rest = int((got[per_shard:] != want[per_shard:]).sum())
    head = int((got[:per_shard] != want[:per_shard]).sum())
    if n_rest or head > TS_HEAD_MISMATCHES:
        raise RuntimeError(f"{what}: {n_rest} bits differ beyond the first "
                           f"shard, {head} in it")
    return head


def scale_out_phase(dev):
    """Slice 10's scale-out on the card: two ranks on cuda:0 over gloo
    (NCCL refuses two ranks on one card), spawned once, each running the
    channel-sharded main path, MultichannelRx over the mesh and the
    time-sharded chain and FIR (scale_out_rank), held to the same work in
    this process (scale_out_references). Every rank's kernel reports must
    show kernels only."""
    import tempfile

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"  compute mode: {mode}", flush=True)
    if mode.splitlines()[0].strip() in ("Exclusive_Process", "Prohibited"):
        raise RuntimeError(f"compute mode {mode} forbids two processes on "
                           f"the card")
    t0 = time.perf_counter()
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        tmp = pathlib.Path(tmp)
        ref = scale_out_references(dev, tmp)
        t1 = time.perf_counter()
        # both ranks on the parent's card: cuda:0
        ranks = spawn_ranks(tmp, f"{dev.type}:0" if dev.type == "cuda"
                            else dev.type)
        t2 = time.perf_counter()
    per = N_CH // SCALE_RANKS
    half = MIX_M // 2
    errs = {"fsk": 0.0, "mixed": 0.0, "audio": 0.0, "tsf": 0.0}
    ts_bits = []
    for r, (arr, meta) in enumerate(ranks):
        rows = slice(r * per, (r + 1) * per)
        for i in range(SCALE_STEPS):
            want = ref["fsk"][i]
            if not np.array_equal(arr[f"fsk_bits{i}"], want["bits"][rows]):
                n = int((arr[f"fsk_bits{i}"] != want["bits"][rows]).sum())
                raise RuntimeError(f"rank {r} step {i}: {n} bits differ "
                                   f"from the single-process run")
            errs["fsk"] = max(errs["fsk"], float(np.abs(
                arr[f"fsk_symbols{i}"] - want["symbols"][rows]).max()))
            mrows = arr["mixed_rows"]
            fsk_rows, nb_rows = mrows[mrows < half], mrows[mrows >= half] \
                - half
            want = ref["mixed"][i]
            if not np.array_equal(arr[f"mixed_bits{i}"],
                                  want["bits"][fsk_rows]):
                raise RuntimeError(f"rank {r} mixed step {i}: bits differ")
            errs["mixed"] = max(errs["mixed"], float(np.abs(
                arr[f"mixed_symbols{i}"] - want["symbols"][fsk_rows]).max()))
            errs["audio"] = max(errs["audio"], float(np.abs(
                arr[f"mixed_audio{i}"] - want["audio"][nb_rows]).max())
                / float(np.abs(want["audio"]).max()))
        ts_bits.append(arr["ts_bits"])
        lo = r * TSF_LOCAL
        errs["tsf"] = max(errs["tsf"], float(np.abs(
            arr["tsf"] - ref["tsf"][lo:lo + TSF_LOCAL]).max()))
        for name, rep in meta["reports"].items():
            plain = {op: v["plain"] for op, v in rep.items() if v["plain"]}
            if plain:
                raise RuntimeError(f"rank {r} {name}: plain calls {plain}")
        print(f"  rank {r} on {meta['device']}: kernel launches "
              + "; ".join(f"{name} " + ", ".join(
                  f"{op} {v['cuda']}" for op, v in rep.items())
                  for name, rep in meta["reports"].items()), flush=True)
        print(f"  rank {r} step ms (CUDA events, a shared card): "
              f"{json.dumps(meta['ms'])}", flush=True)
    head = ts_contract("time-sharded chain", np.concatenate(ts_bits),
                       ref["ts_bits"], len(ts_bits[0]))
    bad = {k: v for k, v in errs.items() if not v <= {
        "fsk": SYM_TOL, "mixed": MIXED_SYM_TOL, "audio": FIR_TOL,
        "tsf": TSF_TOL}[k]}
    if bad:
        raise RuntimeError(f"ranks beyond the bounds: {bad}")
    print(f"  single process step ms (CUDA events): fsk "
          f"{ref['fsk_ms']} ({N_CH} rows), mixed {ref['mixed_ms']}, "
          f"time-sharded chain serial {ref['ts_ms']}, FIR serial "
          f"{ref['tsf_ms']}; {CARD}", flush=True)
    print(f"  ranks against one process: {N_CH} x {T_STEP} main path bits "
          f"equal, symbols max |diff| {errs['fsk']:.3e}; mixed bits equal, "
          f"symbols {errs['mixed']:.3e}, audio {errs['audio']:.3e} of its "
          f"peak; time-sharded chain {head} head differences, the rest "
          f"equal; FIR max |diff| {errs['tsf']:.3e}", flush=True)
    print(f"  scale_out phase: {time.perf_counter() - t0:.1f} s (references "
          f"{t1 - t0:.1f} s, ranks {t2 - t1:.1f} s)", flush=True)


def parts_phase(dev, gen):
    """Slice 10's parts of ported modules on the card, each held to the same
    call on CPU tensors: scan_stream of the main path, step_timer and
    annotate inside trace, vv_carrier_correct, the complex-tap
    RationalResampler."""
    import tempfile

    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF
    from qradiolink_tpu_torch.core import (IqPair, concat_stream_out,
                                           run_stream, scan_stream)
    from qradiolink_tpu_torch.ops.resample import RationalResampler
    from qradiolink_tpu_torch.sync.feedforward import vv_carrier_correct
    from qradiolink_tpu_torch.utils.profiling import (annotate, kernel_paths,
                                                      step_timer, trace)

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    # scan_stream: the capture, each row rolled by 2,000 samples more
    data = np.load(FIXTURE)
    n = 3 * T_STEP
    planes = []
    for key in ("iq_re", "iq_im"):
        full = torch.from_numpy(data[key].astype(np.float32)).to(dev)
        rows = torch.stack([torch.roll(full, -2000 * r)[:n]
                            for r in range(PARTS_ROWS)])
        planes.append(rows.reshape(PARTS_ROWS, 3, T_STEP).transpose(0, 1)
                      .contiguous())
    xs = IqPair(*planes)
    chain = Fsk4DemodFF(lead_shape=(PARTS_ROWS,), device=dev)
    (state, ys), report = card_counted(
        "scan_stream", lambda: scan_stream(chain, xs))
    for op in FSK_EVERY_STEP:
        if report.get(op, {}).get("cuda", 0) < 3:
            raise RuntimeError(f"scan_stream: {op} did not launch a block")
    outs = list(run_stream(chain, [IqPair(xs.re[i], xs.im[i])
                                   for i in range(3)]))
    for key in ("bits", "symbols"):
        if not torch.equal(ys[key], torch.stack([o[key] for o in outs])):
            raise RuntimeError(f"scan_stream's {key} differ from run_stream")
    bits = concat_stream_out(ys["bits"])
    if tuple(bits.shape) != (PARTS_ROWS, 3 * T_STEP // 500):
        raise RuntimeError(f"concat_stream_out shape {tuple(bits.shape)}")
    cchain = Fsk4DemodFF(lead_shape=(PARTS_CPU_ROWS,), device=cpu)
    _, cys = scan_stream(cchain, IqPair(
        xs.re[:, :PARTS_CPU_ROWS].cpu(), xs.im[:, :PARTS_CPU_ROWS].cpu()))
    n_diff = int((ys["bits"][:, :PARTS_CPU_ROWS].cpu() != cys["bits"]).sum())
    sym = float((ys["symbols"][:, :PARTS_CPU_ROWS].cpu()
                 - cys["symbols"]).abs().max())
    print(f"  scan_stream: {PARTS_ROWS} rows x 3 blocks of {T_STEP}, equal "
          f"to run_stream; on {PARTS_CPU_ROWS} rows against the CPU: "
          f"{n_diff} bits differ, symbols max |diff| {sym:.3e}", flush=True)
    if n_diff or not sym <= MIXED_SYM_TOL:
        raise RuntimeError("scan_stream on the card differs from the CPU")

    # step_timer, and annotate inside trace
    x0 = IqPair(xs.re[0], xs.im[0])
    stats = step_timer(chain, state, x0, iters=3,
                       samples_per_step=PARTS_ROWS * T_STEP)
    cstats = step_timer(cchain, cchain.init_state(), IqPair(
        x0.re[:PARTS_CPU_ROWS].cpu(), x0.im[:PARTS_CPU_ROWS].cpu()),
        iters=1, samples_per_step=PARTS_CPU_ROWS * T_STEP)
    if not set(stats) == set(cstats) == {"step_ms", "samples_per_s"}:
        raise RuntimeError(f"step_timer keys {set(stats)}, {set(cstats)}")
    (HERE / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        with trace(tmp):
            with annotate("slice10-region"):
                chain(state, x0)
                torch.cuda.synchronize()
        events = json.loads(pathlib.Path(tmp, "trace.json").read_text())
    names = {e.get("name") for e in events.get("traceEvents", [])}
    n_dev = sum(1 for e in events.get("traceEvents", [])
                if e.get("cat") == "kernel")
    if "slice10-region" not in names:
        raise RuntimeError("the trace lacks the annotated region")
    print(f"  step_timer: {stats['step_ms']:.3f} ms a step "
          f"({stats['samples_per_s'] / 1e6:.1f} Msamples/s, CUDA events; "
          f"CPU {cstats['step_ms']:.1f} ms at {PARTS_CPU_ROWS} rows); "
          f"trace: the region and {n_dev} kernel events", flush=True)
    del chain, cchain, state, ys, outs, xs, planes
    torch.cuda.empty_cache()

    # vv_carrier_correct: BPSK at sps 10, a phase and a slow carrier
    # offset a row, noise at 0.1 a plane
    C, T = N_CH, T_STEP
    syms = torch.randint(0, 2, (C, T // 10), generator=gen, device=dev)
    bpsk = (2.0 * syms.float() - 1.0).repeat_interleave(10, dim=1)
    ph0 = torch.rand((C, 1), generator=gen, device=dev) * 6.0 - 3.0
    cfo = (torch.rand((C, 1), generator=gen, device=dev) - 0.5) * 2e-5
    t = torch.arange(T, device=dev, dtype=torch.float32)
    phase = ph0 + 2 * np.pi * cfo * t
    noise = [torch.randn((C, T), generator=gen, device=dev) * 0.1
             for _ in range(2)]
    x = torch.complex(bpsk * torch.cos(phase) + noise[0],
                      bpsk * torch.sin(phase) + noise[1])
    del bpsk, phase, noise
    (y, ph), vv_ms = event_ms(lambda: vv_carrier_correct(x, 2, 16))
    cy, cph = vv_carrier_correct(x[:VV_CPU_ROWS].cpu(), 2, 16)
    y_err = float((y[:VV_CPU_ROWS].cpu() - cy).abs().max()) / float(
        cy.abs().max())
    ph_err = float((ph[:VV_CPU_ROWS].cpu() - cph).abs().max())
    rot = torch.angle(y[:, ::10]).abs()
    rot = torch.minimum(rot, np.pi - rot).median().item()
    print(f"  vv_carrier_correct: {C} x {T} in {vv_ms} ms (CUDA events); "
          f"on {VV_CPU_ROWS} rows against the CPU: corrected max |diff| "
          f"{y_err:.3e} of its peak, phases {ph_err:.3e} rad; median "
          f"residual rotation {rot:.3f} rad", flush=True)
    if not (y_err <= VV_TOL and ph_err <= VV_TOL and rot < 0.2):
        raise RuntimeError("vv_carrier_correct differs from the CPU")
    del x, y, ph
    torch.cuda.empty_cache()

    # the complex-tap resampler: two tap planes, each a launch a block
    from qradiolink_tpu_torch.ops import firdes
    lp = np.asarray(firdes.low_pass(1.0, 1.0, 0.15, 0.05), np.float64)
    taps = (lp * np.exp(2j * np.pi * 0.05 * np.arange(len(lp)))).astype(
        np.complex64)
    for L, M in ((3, 2), (1, 5)):
        rs = {d.type: RationalResampler(L, M, taps=taps, lead_shape=(64,),
                                        device=d) for d in (dev, cpu)}
        blocks = [IqPair(*(torch.randn((64, 100_000), generator=gen,
                                       device=dev) for _ in range(2)))
                  for _ in range(2)]

        def stream(d):
            s, out = rs[d.type].init_state(), []
            for b in blocks:
                s, y = rs[d.type](s, IqPair(b.re.to(d), b.im.to(d)))
                out.append(y)
            return s, out

        run = f"complex-tap resampler L{L} M{M}"
        (s_card, y_card), (s_cpu, y_cpu) = app_counted(
            run, lambda: stream(dev), lambda: stream(cpu))
        report = kernel_paths.report()   # the card run's, app_counted's last
        launches = sum(v["cuda"] for v in report.values())
        if launches < 2 * len(blocks):
            raise RuntimeError(f"{run}: {launches} launches, not one a tap "
                               f"plane a block")
        err = max(peak_err(run, (a.re.cpu(), a.im.cpu()), (b.re, b.im),
                           FIR_TOL) for a, b in zip(y_card, y_cpu))
        if not torch.equal(s_card.cpu(), s_cpu):
            raise RuntimeError(f"{run}: state differs from the CPU's")
        print(f"  {run} K{len(taps)}, 64 x 2 blocks of 100,000: "
              + ", ".join(f"{op} x{v['cuda']}" for op, v in report.items())
              + f"; max |diff| {err:.3e} against the CPU, state equal",
              flush=True)
    print(f"  parts phase: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--scale-out-rank"]:
        return scale_out_rank(int(sys.argv[2]), int(sys.argv[3]),
                              sys.argv[4], sys.argv[5])
    from qradiolink_tpu_torch.utils import kernels

    # the reference computes in full f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    global CARD
    CARD = smi
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = kernels.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{', '.join(kernels.sources())}", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    # fir_decim_f32, fir_long_f32, fir_cols_f32, fir_s1_f32 and
    # resample_up_f32 keep their rings in registers, resample_rat_f32 and
    # resample_dec_f32 their taps and accumulators, viterbi_bfly_k7 its
    # path metrics, pfb_fft_f32 and depthwise_run_f32 their taps,
    # resample_poly_f32 and agc2_gain_f32 their loads in flight, agc2_f32
    # its rows' loads, the PSK loops (costas_loop_f32, symbol_sync_mm_f32,
    # the viterbi_stream kernels) their state;
    # fll_band_edge_f32 and resample_x2_f32 their rings and accumulators
    for name in ("fir_decim", "fir_long", "fir_cols", "fir_s1",
                 "viterbi_bfly", "pfb_fft", "depthwise_run", "resample_poly",
                 "resample_up", "agc2", "costas", "symbol_sync",
                 "viterbi_stream", "viterbi_stream_warp",
                 "viterbi_stream_redux", "fll_band_edge", "resample_x2",
                 "resample_rat", "resample_dec"):
        if re.search(r"[1-9]\d* bytes spill", logs.get(name, "")):
            raise RuntimeError(f"ptxas spilled registers in csrc/{name}.cu")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows, reports = earlier_phases(dev, gen)
    print("the FFT form against the direct kernels, in turns:", flush=True)
    fft_route_phase(dev, gen)
    torch.cuda.empty_cache()
    rep6, rows6 = slice6_phase(dev, gen, rows)
    reports.update(rep6)
    rows += rows6
    torch.cuda.empty_cache()
    print("fsk10k: the 2/25 K561 head's taps-in-order form, GMSK10K and "
          "2FSK10K card against CPU:", flush=True)
    fsk10k_head_phase(dev)
    print("app: the application on the card (CLI, RadioController):",
          flush=True)
    app_phase(dev)
    print(f"dmr_call: {N_CH} rows' late-entry calls, DmrMod -> 10 dB -> "
          f"DmrDemod, {CALL_STEPS} steps, the call stack on {CALL_ROWS} "
          f"rows", flush=True)
    dmr_call_phase(dev)
    print("headless: the headless service on the card (UDP IQ, telnet, "
          "MMDVM's session, IP-over-radio, the C++ engine):", flush=True)
    done = set()
    rep8, rows8 = headless_phase(dev, gen, done)
    reports.update(rep8)
    rows += rows8
    print("audio_video_voip: the application's audio, FreeDV vocoder, "
          "video and VOIP on the card:", flush=True)
    rep9, rows9 = audio_video_voip_phase(dev, gen, done)
    reports.update(rep9)
    rows += rows9
    torch.cuda.empty_cache()
    print(f"scale_out: {SCALE_RANKS} ranks on cuda:0 over gloo (the "
          f"channel-sharded main path, MultichannelRx over the mesh, the "
          f"time-sharded chain and FIR):", flush=True)
    scale_out_phase(dev)
    print("parts: scan_stream, step_timer and trace, vv_carrier_correct, "
          "the complex-tap resampler on the card:", flush=True)
    parts_phase(dev, gen)

    # each kernel's launches at its shape in the run of the path that
    # gives it that shape: one a step for the kernel that the route picks
    # (the slice-6 rows: the count their launch table gives, "want"), none
    # for the one it replaced (a row with no path)
    steps = {"fsk": N_STEPS, "mixed": N_STEPS, "round_trip": RT_STEPS,
             "ssb": N_STEPS, "wbfm": N_STEPS, "tx": N_STEPS,
             "am_tx": N_STEPS, "am": N_STEPS, "qpsk": N_STEPS,
             "bpsk": BPSK_STEPS, "psk_tx": N_STEPS, "m17": N_STEPS,
             "dmr": N_STEPS, "fsk4_tx": N_STEPS}
    for r in rows:
        run, shape = r.pop("run"), r.pop("shape")
        per_step = r.pop("per_step", 1)
        op = r["name"].split("/")[0]
        r["launches"] = reports[run].get(op, {}).get("shapes", {}).get(
            f"cuda {shape}", 0)
        want = r.pop("want", None)
        if r["path"] is None:
            want = 0
        elif want is None:
            want = per_step * steps[run]
        if r["launches"] != want:
            raise RuntimeError(f"{r['name']} launched {r['launches']} "
                               f"times at {shape} on the {run} path, not "
                               f"{want}")
    # the kernels on a path against their library call: none slower by
    # more than an empty launch (printed, not gated)
    floor_ms = launch_floor(dev)
    slow = [f"{r['name']} {r['ms']:.4f} ms against {r['library_ms']:.4f}"
            for r in rows if r["path"] is not None
            and r["library_ms"] is not None
            and r["ms"] - r["library_ms"] > floor_ms]
    print(f"library: {len(slow)} path kernels slower than their library "
          f"call by more than an empty launch ({floor_ms:.4f} ms)"
          + "".join(f"; {x}" for x in slow) + f" ({CARD})", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
