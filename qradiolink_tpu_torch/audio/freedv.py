"""FreeDV vocoder-modem bridge over libcodec2's freedv API (port of
qradiolink_tpu/audio/freedv.py: the same ctypes calls, the library loaded
through the port's audio/codecs.py `_load`). Host-side: it touches no
tensor.

The reference reaches FreeDV through gr-vocoder's freedv_tx_ss /
freedv_rx_ss blocks (reference src/gr/gr_mod_freedv.cpp:42,
gr_demod_freedv.cpp:64), which are thin wrappers over the same
libcodec2 freedv_api this module binds with ctypes — the pattern of
audio/codecs.py: codecs are host C libraries, not DSP to port
(SURVEY §7.9).

freedv_tx consumes n_speech_samples of 8 kHz speech and produces
n_nom_modem_samples of real passband modem signal; freedv_rx consumes
freedv_nin() samples per call (the modem adjusts it for timing slip)
and produces up to n_max_speech_samples. Both sides are chunked here
so arbitrary-length streams work.
"""

from __future__ import annotations

import ctypes

import numpy as np

from qradiolink_tpu_torch.audio.codecs import _load

_c2 = _load("libcodec2.so.1.0", "libcodec2.so", "libcodec2.so.0.9")

# freedv_api.h mode constants
FREEDV_MODE_1600 = 0
FREEDV_MODE_2400A = 3
FREEDV_MODE_2400B = 4
FREEDV_MODE_800XA = 5
FREEDV_MODE_700C = 6
FREEDV_MODE_700D = 7
FREEDV_MODE_700E = 13

MODE_IDS = {
    "1600": FREEDV_MODE_1600,
    "700C": FREEDV_MODE_700C,
    "700D": FREEDV_MODE_700D,
    "800XA": FREEDV_MODE_800XA,
    "2400A": FREEDV_MODE_2400A,
    "2400B": FREEDV_MODE_2400B,
    "700E": FREEDV_MODE_700E,
}

if _c2 is not None and hasattr(_c2, "freedv_open"):
    _c2.freedv_open.restype = ctypes.c_void_p
    _c2.freedv_open.argtypes = [ctypes.c_int]
    _c2.freedv_close.argtypes = [ctypes.c_void_p]
    for f in ("freedv_get_n_speech_samples", "freedv_get_n_nom_modem_samples",
              "freedv_get_n_max_modem_samples", "freedv_nin",
              "freedv_get_n_max_speech_samples",
              "freedv_get_modem_sample_rate", "freedv_get_sync"):
        fn = getattr(_c2, f, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
    _c2.freedv_tx.restype = None
    _c2.freedv_tx.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_short),
                              ctypes.POINTER(ctypes.c_short)]
    _c2.freedv_rx.restype = ctypes.c_int
    _c2.freedv_rx.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_short),
                              ctypes.POINTER(ctypes.c_short)]


def freedv_available() -> bool:
    return _c2 is not None and hasattr(_c2, "freedv_open")


def _sp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_short))


class FreeDV:
    """One FreeDV modem instance (mode '1600', '700C', '700D', '800XA',
    '2400A', '2400B', '700E')."""

    def __init__(self, mode: str = "1600"):
        if not freedv_available():
            raise RuntimeError("libcodec2 freedv API not available")
        self.mode = mode
        self._h = _c2.freedv_open(MODE_IDS[mode])
        if not self._h:
            raise RuntimeError(f"freedv_open({mode}) failed")
        self.n_speech = _c2.freedv_get_n_speech_samples(self._h)
        self.n_nom_modem = _c2.freedv_get_n_nom_modem_samples(self._h)
        self.n_max_modem = _c2.freedv_get_n_max_modem_samples(self._h)
        self.n_max_speech = _c2.freedv_get_n_max_speech_samples(self._h)
        self.modem_rate = _c2.freedv_get_modem_sample_rate(self._h)
        self._rx_buf = np.zeros(0, np.int16)
        self._tx_buf = np.zeros(0, np.int16)

    def close(self):
        if self._h:
            _c2.freedv_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    @property
    def sync(self) -> bool:
        return bool(_c2.freedv_get_sync(self._h))

    def tx(self, speech: np.ndarray) -> np.ndarray:
        """8 kHz int16 speech -> real passband modem samples (int16,
        modem_rate). Buffers partial frames between calls."""
        self._tx_buf = np.concatenate(
            [self._tx_buf, np.asarray(speech, np.int16).ravel()])
        out = []
        while self._tx_buf.size >= self.n_speech:
            sp_in = np.ascontiguousarray(self._tx_buf[:self.n_speech])
            self._tx_buf = self._tx_buf[self.n_speech:]
            mod = np.zeros(self.n_nom_modem, np.int16)
            _c2.freedv_tx(self._h, _sp(mod), _sp(sp_in))
            out.append(mod)
        return np.concatenate(out) if out else np.zeros(0, np.int16)

    def rx(self, modem: np.ndarray) -> np.ndarray:
        """Passband modem samples (int16) -> decoded 8 kHz speech
        (int16). Chunked by the modem's freedv_nin()."""
        self._rx_buf = np.concatenate(
            [self._rx_buf, np.asarray(modem, np.int16).ravel()])
        out = []
        while True:
            nin = _c2.freedv_nin(self._h)
            if self._rx_buf.size < nin:
                break
            chunk = np.ascontiguousarray(self._rx_buf[:nin])
            self._rx_buf = self._rx_buf[nin:]
            speech = np.zeros(self.n_max_speech, np.int16)
            nout = _c2.freedv_rx(self._h, _sp(speech), _sp(chunk))
            if nout > 0:
                out.append(speech[:nout].copy())
        return np.concatenate(out) if out else np.zeros(0, np.int16)
