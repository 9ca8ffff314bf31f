"""WAV audio read/write, 16-bit PCM (a copy of qradiolink_tpu/io/wav.py):
the framework's audio file boundary, which replaces the reference's
PulseAudio interface (src/audio/audiointerface.cpp) for offline
processing."""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path):
    """-> (float32 samples in [-1, 1] shaped (T,) or (C, T), rate)."""
    with wave.open(str(path), "rb") as w:
        nch = w.getnchannels()
        rate = w.getframerate()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width != 2:
        raise ValueError(f"only 16-bit PCM supported, got width {width}")
    x = np.frombuffer(raw, np.int16).astype(np.float32) / 32767.0
    if nch > 1:
        x = x.reshape(-1, nch).T
    return x, rate


def write_wav(path, samples, rate: int = 8000) -> None:
    """samples: float in [-1, 1], (T,) mono or (C, T) multichannel."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 2:
        x = x.T.reshape(-1)
        nch = np.asarray(samples).shape[0]
    else:
        nch = 1
    pcm = np.clip(x * 32767.0, -32767, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(nch)
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(pcm.tobytes())
