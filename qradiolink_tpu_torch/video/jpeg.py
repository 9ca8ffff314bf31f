"""JPEG video codec for the QPSKVideo mode (port of
qradiolink_tpu/video/jpeg.py, the same host code over Pillow: the frames
it writes equal that module's byte for byte).

Equivalent of reference src/video/videoencoder.cpp:1-273: 320x240
frames JPEG-compressed to fit the mode's fixed air budget of 3122
bytes per frame at ~10 fps (<250 kbit/s, reference gr_modem.cpp:159-162
and docs/about.md:38). The reference drops quality until the frame
fits; same strategy here via Pillow (libjpeg underneath — a host C
library, like the audio codecs). V4L2 capture is physical-hardware
scope; frames enter as numpy arrays (file/synthetic sources).

Air frame layout (videoencoder.cpp encode path): [u32 jpeg_size LE]
[jpeg bytes] [zero fill to budget]. The decoder validates the size
field and tolerates bit errors by letting libjpeg bail on corrupt
entropy data (returns None -> caller repeats last good frame).
"""

from __future__ import annotations

import io
import struct

import numpy as np

VIDEO_FRAME_BYTES = 3122       # reference gr_modem.cpp:159-162
VIDEO_W, VIDEO_H = 320, 240


def encode_jpeg_frame(rgb: np.ndarray,
                      budget: int = VIDEO_FRAME_BYTES) -> bytes:
    """(H, W, 3) uint8 RGB -> fixed `budget`-byte air frame.

    Steps quality down until the JPEG fits budget-4 bytes
    (videoencoder.cpp's loop)."""
    from PIL import Image
    img = Image.fromarray(np.asarray(rgb, np.uint8), "RGB")
    if img.size != (VIDEO_W, VIDEO_H):
        img = img.resize((VIDEO_W, VIDEO_H))
    data = None
    for q in (70, 60, 50, 40, 30, 20, 10, 5):
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=q)
        if buf.tell() <= budget - 4:
            data = buf.getvalue()
            break
    if data is None:  # pathological frame: send grey
        buf = io.BytesIO()
        Image.new("RGB", (VIDEO_W, VIDEO_H), (128, 128, 128)).save(
            buf, "JPEG", quality=5)
        data = buf.getvalue()
    out = struct.pack("<I", len(data)) + data
    return out + b"\x00" * (budget - len(out))


def decode_jpeg_frame(frame: bytes) -> np.ndarray | None:
    """Air frame -> (240, 320, 3) uint8 RGB, or None on corruption."""
    from PIL import Image
    if len(frame) < 4:
        return None
    (n,) = struct.unpack("<I", frame[:4])
    if n == 0 or n > len(frame) - 4:
        return None
    try:
        img = Image.open(io.BytesIO(frame[4:4 + n]))
        img.load()
        return np.asarray(img.convert("RGB"), np.uint8)
    except Exception:
        return None


class VideoEncoder:
    """Streaming frame source/sink wrapper (the VideoEncoder class
    surface of the reference, minus V4L2 capture)."""

    def __init__(self, budget: int = VIDEO_FRAME_BYTES):
        self.budget = int(budget)
        self.last_good: np.ndarray | None = None

    def encode(self, rgb: np.ndarray) -> bytes:
        return encode_jpeg_frame(rgb, self.budget)

    def decode(self, frame: bytes) -> np.ndarray | None:
        img = decode_jpeg_frame(frame)
        if img is not None:
            self.last_good = img
        return img if img is not None else self.last_good
