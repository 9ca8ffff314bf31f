"""Command-line interface: run qradiolink_tpu_torch as a program (port of
qradiolink_tpu/app/cli.py).

Equivalent of reference src/main.cpp:83-107 headless flags
(--headless --start-trx --ptt --mmdvm ...) reshaped for file/network
IQ: subcommands rx / tx / loopback / modes / headless / mmdvm-proxy.

  python -m qradiolink_tpu_torch rx --mode NBFM --iq-in sig.cf32 \
      --wav-out out.wav
  python -m qradiolink_tpu_torch tx --mode 4FSK2K --text "hello" \
      --iq-out tx.cf32
  python -m qradiolink_tpu_torch loopback --mode 4FSK2K --text "hello"
  python -m qradiolink_tpu_torch modes
  python -m qradiolink_tpu_torch headless --udp --start-trx \
      --rx-mode 4FSK2K
  python -m qradiolink_tpu_torch mmdvm-proxy --channel 1

rx, tx, loopback and headless run their chains on the card; `--device
cpu` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from qradiolink_tpu_torch.config import Settings
from qradiolink_tpu_torch.logger import get_logger
from qradiolink_tpu_torch.models.registry import MODES
from qradiolink_tpu_torch.app.controller import RadioController


def _lcm_block(mode: str, rate: int) -> int:
    """A block length compatible with the mode's decimators (~125 ms)."""
    base = 125_000 if rate >= 1_000_000 else rate // 8
    quantum = 2500  # covers 1/50, 3/125, 12/125 decimations and sps 2..20
    return max(quantum, (base // quantum) * quantum)


def cmd_modes(_args):
    print(f"{'mode':10} {'kind':14} {'bitrate':>8}  framing")
    for name, spec in MODES.items():
        print(f"{name:10} {spec.kind:14} {spec.bit_rate:>8}  "
              f"{spec.framing or '-'}")
    return 0


def cmd_rx(args):
    from qradiolink_tpu_torch.io.iq import IqFileSource
    from qradiolink_tpu_torch.io.wav import write_wav
    s = Settings.load(args.config)
    s.rx_mode = args.mode
    s.rx_sample_rate = int(args.rate)
    s.demod_offset = int(args.offset)
    if args.squelch is not None:
        s.squelch_db = args.squelch
    ctl = RadioController(s, logger=get_logger(logfile=args.log),
                          device=_device(args))
    ctl.toggle_rx_mode(args.mode)
    block_len = _lcm_block(args.mode, s.rx_sample_rate)
    src = IqFileSource(args.iq_in, block_len, fmt=args.format)
    audio, texts, n_frames = [], [], 0
    for ev in ctl.run_rx(src):
        if ev.kind == "audio":
            audio.append(ev.audio)
        elif ev.kind == "text":
            texts.append(ev.text)
            print(f"[text] {ev.text}")
        elif ev.kind == "callsign":
            print(f"[callsign] {ev.text}")
        elif ev.kind == "frame":
            n_frames += 1
        elif ev.kind == "receive_end":
            print("[end of transmission]")
    if audio and args.wav_out:
        out = np.concatenate(audio)
        write_wav(args.wav_out, out, rate=8000)
        print(f"wrote {out.size} audio samples -> {args.wav_out}")
    if n_frames:
        print(f"{n_frames} data frames received")
    if ctl._deframer is not None:
        print(f"frames synced: {ctl._deframer.frames_synced}")
    return 0


def cmd_tx(args):
    from qradiolink_tpu_torch.io.iq import IqFileSink
    from qradiolink_tpu_torch.io.wav import read_wav
    s = Settings.load(args.config)
    s.tx_mode = args.mode
    ctl = RadioController(s, logger=get_logger(logfile=args.log),
                          device=_device(args))
    ctl.toggle_tx_mode(args.mode)
    ctl.start_transmission()
    if args.text:
        iq = ctl.tx_text(args.text)
    elif args.wav_in:
        pcm, rate = read_wav(args.wav_in)
        if rate != 8000:
            raise SystemExit("TX audio must be 8 kHz WAV")
        iq = ctl.tx_audio_block(pcm)
    else:
        raise SystemExit("tx needs --text or --wav-in")
    with IqFileSink(args.iq_out, fmt=args.format) as sink:
        sink.write(iq)
    print(f"wrote {iq.size} IQ samples -> {args.iq_out}")
    return 0


class HeadlessService:
    """The headless transceiver service (reference src/main.cpp headless
    mode): UDP IQ in/out + telnet control (port 4939) + optional GPredict
    Doppler server + IP-over-radio pump, set up from the `headless`
    arguments. step() is one pass of the service loop, run() loops until
    the telnet 'shutdown' verb or Ctrl-C and closes; cmd_headless runs
    it. The bound ports (`--udp-port 0`, `--control-port 0` take free
    ones) are `src.sock.getsockname()[1]` and `telnet.port`."""

    def __init__(self, args):
        from qradiolink_tpu_torch.io.iq import UdpIqSource, UdpIqSink
        from qradiolink_tpu_torch.app.command import CommandProcessor
        from qradiolink_tpu_torch.app.telnet import TelnetServer
        from qradiolink_tpu_torch.config import RadioChannels

        s = Settings.load(args.config)
        if args.rx_mode:
            s.rx_mode = args.rx_mode
        if args.tx_mode:
            s.tx_mode = args.tx_mode
        log = self.log = get_logger(logfile=args.log)
        ctl = self.ctl = RadioController(s, logger=log, device=_device(args))
        self.proc = CommandProcessor(ctl, channels=RadioChannels.load())
        telnet = self.telnet = TelnetServer(self.proc,
                                            port=args.control_port)
        telnet.start()
        log.info("telnet control on port %d", telnet.port)
        self.gp = None
        if args.gpredict:
            from qradiolink_tpu_torch.app.gpredict import GPredictServer
            self.gp = GPredictServer(ctl, port=args.gpredict_port)
            self.gp.start()
            log.info("gpredict rigctld on port %d", self.gp.port)
        self.pump = None
        if args.net:
            from qradiolink_tpu_torch.net import (NetPump, TunTapDevice,
                                                  LoopbackNetDevice)
            try:
                dev = TunTapDevice(args.net_ip)
            except (PermissionError, OSError) as e:
                log.warning("TUN/TAP unavailable (%s), loopback device", e)
                dev = LoopbackNetDevice()
            self.pump = NetPump(dev, s.tx_mode if s.tx_mode in
                                ("QPSK250K", "4FSK100K") else "QPSK250K")
            ctl.attach_net(self.pump)
        if args.mmdvm:
            # reference --mmdvm: headless MMDVM service with TRX and PTT on
            # (main.cpp:100-107); MMDVM modes unless explicitly overridden
            if not args.rx_mode:
                s.rx_mode = "MMDVM"
            if not args.tx_mode:
                s.tx_mode = "MMDVM"
            args.start_trx = True
            args.ptt = True
        if args.start_trx:
            ctl.toggle_rx_mode(s.rx_mode)
            ctl.toggle_tx_mode(s.tx_mode)
            if args.ptt:
                ctl.start_transmission()
        block = _lcm_block(s.rx_mode, s.rx_sample_rate)
        self.src = UdpIqSource(args.udp_port, block, timeout=0.5) \
            if args.udp else None
        self.sink = UdpIqSink(args.udp_out_port) if args.udp else None
        log.info("headless loop running (Ctrl-C to stop)")

    def step(self):
        """One pass of the service loop: an IQ block from UDP through RX,
        a net-pump TX tick; sleeps 20 ms when neither had work."""
        ctl, log = self.ctl, self.log
        did = False
        if self.src is not None and ctl._rx is not None:
            try:
                blk = self.src.read_block()
            except (TimeoutError, OSError):
                blk = None
            if blk is not None:
                for ev in ctl.rx_block(blk):
                    if ev.kind == "text":
                        log.info("[text] %s", ev.text)
                did = True
        if self.pump is not None and ctl.transmitting:
            iq = ctl.tx_net_poll(self.pump, 0.05)
            if iq is not None and self.sink is not None:
                self.sink.write(iq)
                did = True
        if not did:
            time.sleep(0.02)

    def run(self) -> int:
        try:
            while not self.telnet.shutdown_requested:
                self.step()
        except KeyboardInterrupt:
            pass
        finally:
            self.close()
        return 0

    def close(self):
        self.telnet.stop()
        if self.gp:
            self.gp.stop()
        if self.src:
            self.src.close()
        if self.sink:
            self.sink.close()


def cmd_headless(args):
    """Headless transceiver service (reference src/main.cpp headless
    mode): UDP IQ in/out + telnet control (port 4939) + optional
    GPredict Doppler server + IP-over-radio pump. Runs until the
    telnet 'shutdown' verb or Ctrl-C."""
    return HeadlessService(args).run()


def cmd_mmdvm_proxy(args) -> int:
    """The reference's `--mmdvm --udp` service mode: bridge MMDVMHost's
    ZeroMQ ipc baseband sockets to UDP datagrams."""
    from qradiolink_tpu_torch.io.zmq_proxy import ZmqUdpProxy

    proxy = ZmqUdpProxy(
        udp_listen_port=args.udp_listen_port,
        udp_send_port=args.udp_send_port,
        udp_host=args.udp_host,
        rx_path=f"ipc:///tmp/mmdvm-rx{args.channel}.ipc",
        tx_path=f"ipc:///tmp/mmdvm-tx{args.channel}.ipc")
    try:
        n = 0
        while args.ticks == 0 or n < args.ticks:
            fwd, back = proxy.pump()
            if not (fwd or back):
                time.sleep(0.005)
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        proxy.close()
    return 0


def cmd_loopback(args):
    """TX -> (AWGN) -> RX in one process: the smoke test that proves an
    installation works (the reference's equivalent is a hardware
    loopback)."""
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.core import get_iq, put_iq
    s = Settings()
    s.rx_mode = s.tx_mode = args.mode
    dev = _device(args)
    ctl = RadioController(s, device=dev)
    ctl.toggle_tx_mode(args.mode)
    ctl.start_transmission()
    # preamble frames let the loops lock before the message; trailing
    # zeros flush the message through the RX chain's group delay
    pre = ctl._framer.frame(b"\xaa" * 64, _voice_type(args.mode)) * 30
    iq = np.concatenate([
        ctl.tx_bytes(pre),
        ctl.tx_text(args.text),
        np.zeros(50_000, np.complex64),
    ])
    if args.snr is not None:
        iq = get_iq(ChannelModel(1_000_000, snr_db=args.snr)(
            put_iq(iq, ctl.device)))
    ctl2 = RadioController(s, device=dev)
    ctl2.toggle_rx_mode(args.mode)
    block = _lcm_block(args.mode, 1_000_000)
    pad = (-len(iq)) % block
    iq = np.concatenate([iq, np.zeros(pad, np.complex64)])
    got = []
    for ev in ctl2.run_rx(iq.reshape(-1, block)):
        if ev.kind == "text":
            got.append(ev.text)
    joined = "".join(got)
    ok = args.text in joined
    print(f"loopback {'OK' if ok else 'FAILED'}: received {joined!r}")
    return 0 if ok else 1


def _voice_type(mode):
    from qradiolink_tpu_torch.framing.layer1 import (FrameType,
                                                     MODE_FRAME_CONFIG)
    return FrameType.VOICE_1 if MODE_FRAME_CONFIG[mode].narrowband \
        else FrameType.VOICE_2


def _device(args):
    """--device: "cuda" (the default) is core.resolve_device's None, which
    raises without a card; any other name is passed on."""
    return None if args.device == "cuda" else torch.device(args.device)


def _add_device(sub):
    sub.add_argument("--device", default="cuda",
                     help="torch device of the chains (default: the card, "
                          "cuda; cpu runs them on the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qradiolink_tpu_torch",
        description="SDR transceiver framework on PyTorch and CUDA")
    p.add_argument("--config", default=None, help="settings JSON path")
    p.add_argument("--log", default=None, help="log file path")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("modes", help="list operating modes")
    m.set_defaults(fn=cmd_modes)

    r = sub.add_parser("rx", help="demodulate an IQ file")
    r.add_argument("--mode", required=True, choices=sorted(MODES))
    r.add_argument("--iq-in", required=True)
    r.add_argument("--format", default="cf32", choices=["cf32", "cs16", "cu8"])
    r.add_argument("--rate", type=float, default=1_000_000)
    r.add_argument("--offset", type=float, default=0.0,
                   help="carrier offset Hz (rotator front-end)")
    r.add_argument("--squelch", type=float, default=None)
    r.add_argument("--wav-out", default=None)
    _add_device(r)
    r.set_defaults(fn=cmd_rx)

    t = sub.add_parser("tx", help="modulate to an IQ file")
    t.add_argument("--mode", required=True, choices=sorted(MODES))
    t.add_argument("--iq-out", required=True)
    t.add_argument("--format", default="cf32", choices=["cf32", "cs16", "cu8"])
    t.add_argument("--text", default=None)
    t.add_argument("--wav-in", default=None)
    _add_device(t)
    t.set_defaults(fn=cmd_tx)

    lb = sub.add_parser("loopback", help="TX->channel->RX smoke test")
    lb.add_argument("--mode", default="4FSK2K",
                    choices=[m for m, s in MODES.items() if s.framing])
    lb.add_argument("--text", default="qradiolink_tpu loopback test")
    lb.add_argument("--snr", type=float, default=None)
    _add_device(lb)
    lb.set_defaults(fn=cmd_loopback)

    h = sub.add_parser("headless",
                       help="run as a service: UDP IQ + telnet control")
    h.add_argument("--rx-mode", default=None, choices=sorted(MODES))
    h.add_argument("--tx-mode", default=None, choices=sorted(MODES))
    h.add_argument("--ptt", action="store_true",
                   help="engage PTT at startup (reference --headless "
                        "--start-trx --ptt, main.cpp:87-93)")
    h.add_argument("--mmdvm", action="store_true",
                   help="MMDVM service shorthand: implies --start-trx "
                        "and --ptt with the MMDVM modes (reference "
                        "--mmdvm, main.cpp:100-107)")
    h.add_argument("--start-trx", action="store_true",
                   help="initialize RX+TX at startup (reference --start-trx)")
    h.add_argument("--udp", action="store_true",
                   help="UDP IQ in/out (reference --udp)")
    h.add_argument("--udp-port", type=int, default=4940)
    h.add_argument("--udp-out-port", type=int, default=4941)
    h.add_argument("--control-port", type=int, default=4939)
    h.add_argument("--gpredict", action="store_true",
                   help="rigctld Doppler server")
    h.add_argument("--gpredict-port", type=int, default=4532)
    h.add_argument("--net", action="store_true",
                   help="IP-over-radio TAP device + pump")
    h.add_argument("--net-ip", default="10.0.1.2")
    _add_device(h)
    h.set_defaults(fn=cmd_headless)

    mp = sub.add_parser(
        "mmdvm-proxy",
        help="UDP audio <-> MMDVM ZeroMQ bridge (reference --mmdvm --udp "
             "mode, src/zeromqclient.cpp)")
    mp.add_argument("--udp-listen-port", type=int, default=4942)
    mp.add_argument("--udp-send-port", type=int, default=4941)
    mp.add_argument("--udp-host", default="127.0.0.1")
    mp.add_argument("--channel", type=int, default=1,
                    help="MMDVM ipc channel number (zmq_proxy_channel)")
    mp.add_argument("--ticks", type=int, default=0,
                    help="pump iterations (0 = run until interrupted)")
    mp.set_defaults(fn=cmd_mmdvm_proxy)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
