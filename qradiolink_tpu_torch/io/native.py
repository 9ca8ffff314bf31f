"""ctypes bindings for the native host-IO engine (port of
qradiolink_tpu/io/native.py).

Builds qradiolink_tpu_torch/native/qrl_native.cpp (a copy of the JAX
package's engine) with g++ on first use and exposes: the vectorized IQ
sample-format conversions, the lock-free SPSC ring buffer, the background
UDP receiver and the paced UDP sender.

The library goes to `build/native/<hash>/libqrl_native.so` at the
repository root, keyed by a hash of the source and the flags, the way
utils/kernels.py builds the CUDA sources: g++ writes a temporary name that
os.replace moves into place, so a process never loads a half-written
library. Nothing is built when the module is imported. Unlike the JAX
module there is no fallback: where g++ fails, the first call raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

SRC = pathlib.Path(__file__).resolve().parents[1] / "native" / "qrl_native.cpp"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
# the JAX package's flags (qradiolink_tpu/io/native.py:36): the same code
# gives the same bits
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_LIB = None
_LOCK = threading.Lock()


def lib_path() -> pathlib.Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libqrl_native.so"


def build() -> pathlib.Path:
    """Build the engine unless its library exists; returns its path.
    Raises RuntimeError with g++'s output where the build fails."""
    so = lib_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build {SRC.name}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name} (exit "
                           f"{res.returncode}):\n{res.stderr}{res.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent build sees all or nothing
    return so


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        for name in ("qrl_cs16_to_f32", "qrl_f32_to_cs16",
                     "qrl_cu8_to_f32", "qrl_f32_to_cu8"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.qrl_ring_create.restype = ctypes.c_void_p
        lib.qrl_ring_create.argtypes = [ctypes.c_uint64]
        lib.qrl_ring_destroy.argtypes = [ctypes.c_void_p]
        for name in ("qrl_ring_readable", "qrl_ring_writable"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        for name in ("qrl_ring_write", "qrl_ring_read"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.qrl_udp_rx_start.restype = ctypes.c_void_p
        lib.qrl_udp_rx_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.qrl_udp_rx_stop.argtypes = [ctypes.c_void_p]
        for name in ("qrl_udp_rx_datagrams", "qrl_udp_rx_dropped"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        lib.qrl_udp_tx_start.restype = ctypes.c_void_p
        lib.qrl_udp_tx_start.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                         ctypes.c_void_p, ctypes.c_uint64,
                                         ctypes.c_uint64]
        lib.qrl_udp_tx_stop.argtypes = [ctypes.c_void_p]
        for name in ("qrl_udp_tx_datagrams", "qrl_udp_tx_starved"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_uint64
            fn.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def native_available() -> bool:
    """True when the engine builds (or is built) and loads. Every call of
    the engine still raises with g++'s output where it does not."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def cs16_to_f32(x: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.size, np.float32)
    lib.qrl_cs16_to_f32(_ptr(x), _ptr(out), x.size)
    return out


def f32_to_cs16(x: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.size, np.int16)
    lib.qrl_f32_to_cs16(_ptr(x), _ptr(out), x.size)
    return out


def cu8_to_f32(x: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.uint8)
    out = np.empty(x.size, np.float32)
    lib.qrl_cu8_to_f32(_ptr(x), _ptr(out), x.size)
    return out


def f32_to_cu8(x: np.ndarray) -> np.ndarray:
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.size, np.uint8)
    lib.qrl_f32_to_cu8(_ptr(x), _ptr(out), x.size)
    return out


class RingBuffer:
    """Lock-free SPSC byte ring (native)."""

    def __init__(self, capacity: int):
        self._lib = _load()
        self._h = self._lib.qrl_ring_create(capacity)

    def write(self, data: bytes) -> int:
        buf = np.frombuffer(data, np.uint8)
        return int(self._lib.qrl_ring_write(self._h, _ptr(buf), buf.size))

    def read(self, n: int) -> bytes:
        out = np.empty(n, np.uint8)
        got = int(self._lib.qrl_ring_read(self._h, _ptr(out), n))
        return out[:got].tobytes()

    @property
    def readable(self) -> int:
        return int(self._lib.qrl_ring_readable(self._h))

    def close(self):
        if self._h:
            self._lib.qrl_ring_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class UdpRxEngine:
    """Background native UDP receiver feeding a ring buffer (the
    reference's network source threads, without the GIL)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 ring_bytes: int = 1 << 22):
        self._lib = _load()
        self.ring = RingBuffer(ring_bytes)
        bound = ctypes.c_int(0)
        self._h = self._lib.qrl_udp_rx_start(
            host.encode(), int(port), self.ring._h, ctypes.byref(bound))
        if not self._h:
            self.ring.close()
            raise OSError(f"could not bind UDP {host}:{port}")
        self.port = bound.value

    @property
    def datagrams(self) -> int:
        return int(self._lib.qrl_udp_rx_datagrams(self._h))

    @property
    def dropped(self) -> int:
        return int(self._lib.qrl_udp_rx_dropped(self._h))

    def read(self, n: int) -> bytes:
        return self.ring.read(n)

    def close(self):
        if self._h:
            self._lib.qrl_udp_rx_stop(self._h)
            self._h = None
        self.ring.close()


class UdpTxEngine:
    """Background native PACED UDP sender draining a ring buffer — the
    egress twin of UdpRxEngine (the reference's timed sample sink / UDP
    audio out role, udpclient.cpp; pacing via CLOCK_MONOTONIC absolute
    sleeps, one chunk-sized datagram per tick, GIL-free).

    chunk_bytes/ns_per_chunk set the pace: e.g. 1 Msps cs16 IQ in
    4096-byte datagrams -> 1024 samples/datagram -> ns_per_chunk =
    1_024_000.
    """

    def __init__(self, host: str, port: int, chunk_bytes: int,
                 ns_per_chunk: int, ring_bytes: int = 1 << 22):
        self._lib = _load()
        self.ring = RingBuffer(ring_bytes)
        self._h = self._lib.qrl_udp_tx_start(
            host.encode(), int(port), self.ring._h,
            int(chunk_bytes), int(ns_per_chunk))
        if not self._h:
            self.ring.close()
            raise OSError(f"could not connect UDP {host}:{port}")

    def write(self, data: bytes) -> int:
        return self.ring.write(data)

    @property
    def datagrams(self) -> int:
        return int(self._lib.qrl_udp_tx_datagrams(self._h))

    @property
    def starved(self) -> int:
        return int(self._lib.qrl_udp_tx_starved(self._h))

    def close(self):
        if self._h:
            self._lib.qrl_udp_tx_stop(self._h)
            self._h = None
        self.ring.close()
