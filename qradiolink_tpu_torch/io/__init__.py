"""Host I/O boundary (port of qradiolink_tpu/io: the IQ file path, the
synthetic source and WAV audio; the UDP transports, the native engine and
the MMDVM transport are not ported yet).

Replaces the reference's L0 hardware layer (osmosdr/UHD/LimeSDR device
blocks) with file sample transports: host-side streams of IQ blocks that
the controller moves to the card.
"""

from qradiolink_tpu_torch.io.iq import (  # noqa: F401
    IqFileSource, IqFileSink, SignalSource, read_iq, write_iq,
)
from qradiolink_tpu_torch.io.wav import read_wav, write_wav  # noqa: F401
