"""Audio subsystem (port of qradiolink_tpu/audio): voice codecs
(Codec2/Opus via system C libraries), FreeDV's vocoder-modem bridge,
processing, mixing and recording (reference src/audio/)."""

from qradiolink_tpu_torch.audio.codecs import (  # noqa: F401
    AudioEncoder, codec2_available, opus_available,
)
