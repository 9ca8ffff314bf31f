"""qradiolink_tpu_torch: the PyTorch and CUDA port of qradiolink_tpu.

Same blocks, same state layout, same results as the JAX package (which
stays the reference), on an NVIDIA H100. Plain tensor code is PyTorch; the
kernels the JAX package wrote in Pallas for the TPU are CUDA C++ kernels
written for Hopper (`csrc/`), built with nvcc at first use and loaded with
ctypes (`utils/kernels.py`). Every kernel wrapper takes its plain PyTorch
version for tensors on the CPU, which is how the tests run it, and records
which path each call took (`utils/profiling.kernel_paths`).

This package imports torch and never jax, and nothing of qradiolink_tpu.

Ported so far (slice 1, the 4FSK feedforward RX chain
`chains.fsk.Fsk4DemodFF`; slice 2, the mixed 64-channel receiver
`parallel.sharding.MultichannelRx` with `chains.nbfm.NbfmDemod`; slice 3,
the analog voice chains; slice 4, the PSK modems; slice 5, M17 and DMR
with their frame layers; slice 6, every other modem and the mode
registry `models.registry`, whose `rx_chain` / `tx_chain` build any of
the 41 modes; slice 7, the application: `python -m qradiolink_tpu_torch
modes | rx | tx | loopback` and `RadioController` over the registry, with
the DMR call layer they dispatch to; slice 8, the headless service:
`headless` (UDP IQ, telnet and GPredict control, IP-over-radio) and
`mmdvm-proxy`, MMDVM's session and transports, the C++ host-IO engine):
  core        blocks, IqPair, state trees and npz snapshots
  ops/        firdes, fir (FirFilter, conv1d_valid; real or complex taps;
              the FFT form fft_fir_block, FftFirFilter, fir_filter),
              resample (with the default Kaiser taps), analog
              (QuadratureDemod, FrequencyMod, PhaseMod, Emphasis,
              DcBlocker, ComplexToMag, ComplexToReal, Scale), agc (Agc2),
              cessb (CessbClipper, CessbStretcher), rotator, iir, squelch
              (PowerSquelch, CtcssSquelch), spectrum (rssi_dbm,
              rssi_dbm_slots, RssiProbe, SpectrumProbe),
              channelizer (PfbChannelizer, PfbSynthesizer), and the
              kernels cuda_fir, cuda_resample, cuda_agc, cuda_depthwise,
              cuda_pfb
  sync/       feedforward (FeedforwardSymbolSync), costas (CostasLoop),
              symbol_sync (SymbolSync), fll (FllBandEdge), slicer, and
              the kernels cuda_costas, cuda_symbol_sync
  fec/        conv (ConvCode, viterbi_decode, StreamingViterbi,
              depuncture), conv_ff (TiledViterbi), scrambler (Scrambler,
              Descrambler), bch (BCH(63,16)), ambe (DMR's AMBE voice FEC),
              and the kernels viterbi_cuda, viterbi_stream_cuda
  chains/     digital_common (TxFecHead, RxFecTail, RxFecTailFF), fsk
              (Fsk4Demod, Fsk4DemodFF, Fsk4FbDemod, Fsk4Mod, Fsk2Demod,
              Fsk2FbDemod, GmskDemod, Fsk2Mod, GmskMod), psk (BpskDemod,
              BpskMod, QpskDemod, QpskMod), nbfm (NbfmDemod, NbfmMod), ssb
              (SsbDemod, SsbMod), am (AmDemod, AmMod), wbfm (WbfmDemod),
              m17, dmr, dsss (DsssBpskDemod, DsssBpskMod, CwMod), freedv
              (FreeDvDemod, FreeDvMod: the DSP ends), mmdvm (MmdvmDemod,
              MmdvmMod, MmdvmMultiRx, MmdvmMultiTx), channel (ChannelModel)
  framing/    layer1 (Layer1Framer, Deframer), layer2 (layer-2 frames,
              their protobuf wire form), tdma (BurstTimer, slot_mask)
  protocols/  m17, dmr (the M17 and DMR frame layers) and DMR's call
              layer: dmr_stream (DmrRxStream, DmrTxStream), dmr_control
              (DmrControl, DmrTiming), dmr_data, dmr_signalling, dmr_utils
  models/     registry (ModeSpec, MODES, MODEM_TYPE_MAP, rx_chain, tx_chain)
  parallel/   sharding (MultichannelRx, one card)
  app/        controller (RadioController, RxEvent, FrequencyScanner,
              RepeaterForwarder, beacon_frame), mmdvm_session
              (MmdvmSession), command (CommandProcessor), telnet
              (TelnetServer), gpredict (GPredictControl, GPredictServer),
              cli (modes, rx, tx, loopback, headless, mmdvm-proxy;
              `--device`), limits; `__main__` runs the CLI
  io/         iq (read_iq, write_iq, IqFileSource, IqFileSink,
              UdpIqSource, UdpIqSink, SignalSource; cs16 and cu8 through
              the engine), native (the C++ host-IO engine,
              native/qrl_native.cpp built with g++: conversions,
              RingBuffer, UdpRxEngine, UdpTxEngine), mmdvm_transport
              (MMDVMHost's wire format, MmdvmRxPublisher, MmdvmTxPoller),
              zmq_proxy (ZmqUdpProxy), wav
  net/        netdev (IP-over-radio frames, LoopbackNetDevice,
              TunTapDevice, NetPump)
  audio/      codecs (Codec2 and Opus through the system libraries, when
              present)
  config, logger  Settings and RadioChannels (the JAX package's JSON
              schema), the log format
"""
