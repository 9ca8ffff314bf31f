"""RX audio recorder (port of qradiolink_tpu/audio/recorder.py; reference
src/audio/audiorecorder.cpp:1-80). Host-side: it touches no tensor.

The reference records decoded RX audio to timestamped FLAC files via
libsndfile. The recorder supports two formats with the same surface
(start / append PCM / stop), neither needing libsndfile:

  * "wav"  — stdlib `wave`
  * "flac" — the native FLAC encoder in audio/flac.py (lossless
    CONSTANT/VERBATIM subframes; matches the reference's FLAC output
    format, audiorecorder.cpp:24,39)

File naming matches the reference's rec-<timestamp> pattern in a
configurable directory.
"""

from __future__ import annotations

import time
import wave
from pathlib import Path

import numpy as np

from qradiolink_tpu_torch.audio.flac import write_flac


class AudioRecorder:
    def __init__(self, directory: str | Path = ".", rate: int = 8000,
                 fmt: str = "flac"):
        if fmt not in ("wav", "flac"):
            raise ValueError(f"unsupported recording format {fmt!r}")
        self.dir = Path(directory)
        self.rate = int(rate)
        self.fmt = fmt
        self._wav: wave.Wave_write | None = None
        self._flac_buf: list[np.ndarray] | None = None
        self.path: Path | None = None

    @property
    def recording(self) -> bool:
        return self._wav is not None or self._flac_buf is not None

    def start(self, name: str | None = None) -> Path:
        if self.recording:
            self.stop()
        stamp = name or time.strftime("rec-%Y-%m-%d-%H%M%S")
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / f"{stamp}.{self.fmt}"
        if self.fmt == "wav":
            self._wav = wave.open(str(self.path), "wb")
            self._wav.setnchannels(1)
            self._wav.setsampwidth(2)
            self._wav.setframerate(self.rate)
        else:
            self._flac_buf = []
        return self.path

    def write(self, pcm: np.ndarray):
        """Append float [-1,1] or int16 PCM."""
        x = np.asarray(pcm)
        if x.dtype != np.int16:
            x = np.clip(x * 32767.0, -32767, 32767).astype(np.int16)
        if self._wav is not None:
            self._wav.writeframes(x.tobytes())
        elif self._flac_buf is not None:
            self._flac_buf.append(x.ravel())

    def stop(self) -> Path | None:
        if self._wav is not None:
            self._wav.close()
            self._wav = None
            return self.path
        if self._flac_buf is not None:
            samples = (np.concatenate(self._flac_buf)
                       if self._flac_buf else np.zeros(0, np.int16))
            write_flac(self.path, samples, self.rate)
            self._flac_buf = None
            return self.path
        return None
