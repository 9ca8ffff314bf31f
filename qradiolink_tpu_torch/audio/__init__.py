"""Audio subsystem (port of qradiolink_tpu/audio: the voice codecs only,
Codec2/Opus over the system C libraries; processing, mixing, recording
and FreeDV's host vocoder are not ported yet)."""

from qradiolink_tpu_torch.audio.codecs import (  # noqa: F401
    AudioEncoder, codec2_available, opus_available,
)
