"""Video over DQPSK: JPEG codec with the reference's frame budget (port of
qradiolink_tpu/video)."""

from qradiolink_tpu_torch.video.jpeg import (   # noqa: F401
    VideoEncoder, VIDEO_FRAME_BYTES, encode_jpeg_frame, decode_jpeg_frame,
)
