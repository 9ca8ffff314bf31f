"""Host I/O boundary: IQ sources/sinks (file, UDP, synthetic), WAV
audio, the C++ host-IO engine (native) and the MMDVM ZeroMQ transport
(port of qradiolink_tpu/io).

Replaces the reference's L0 hardware layer (osmosdr/UHD/LimeSDR device
blocks) with file/network sample transports: host-side streams of IQ
blocks that the controller moves to the card.
"""

from qradiolink_tpu_torch.io.iq import (  # noqa: F401
    IqFileSource, IqFileSink, UdpIqSource, UdpIqSink, SignalSource,
    read_iq, write_iq,
)
from qradiolink_tpu_torch.io.wav import read_wav, write_wav  # noqa: F401
