"""IQ sample sources and sinks: raw files, UDP datagrams, synthesizers
(port of qradiolink_tpu/io/iq.py).

The reference reads complex baseband from SDR hardware (gr-osmosdr /
UHD / LimeSDR blocks selected in src/gr/gr_demod_base.cpp:96-163); the
framework ingests from files or the network instead. Formats follow SDR
conventions:

  cf32 — interleaved float32 I/Q (GNU Radio file_sink default)
  cs16 — interleaved int16 I/Q (UHD/LimeSDR wire format), full scale
         32767
  cu8  — offset uint8 I/Q (RTL-SDR), zero at 127.5

cs16 and cu8 convert through the C++ host-IO engine (io/native.py), as
the JAX module does wherever g++ builds its engine, so the two packages
read and write the same bytes and samples. All sources yield
fixed-length complex64 numpy blocks sized for the chains' decimator
contracts; the last partial block is zero-padded (a
flushed stream tail, like stopping an SDR stream mid-buffer). The blocks
reach the card in the controller (core.put_iq_pair).
"""

from __future__ import annotations

import socket
from pathlib import Path

import numpy as np

from qradiolink_tpu_torch.io import native

_FORMATS = ("cf32", "cs16", "cu8")


def _decode(buf: bytes, fmt: str) -> np.ndarray:
    if fmt == "cf32":
        x = np.frombuffer(buf, np.float32)
    elif fmt == "cs16":
        x = native.cs16_to_f32(np.frombuffer(buf, np.int16))
    elif fmt == "cu8":
        x = native.cu8_to_f32(np.frombuffer(buf, np.uint8))
    else:
        raise ValueError(f"unknown IQ format {fmt!r}; expected {_FORMATS}")
    return x[0::2] + 1j * x[1::2]


def _encode(x: np.ndarray, fmt: str) -> bytes:
    inter = np.empty(2 * x.size, np.float32)
    inter[0::2] = x.real
    inter[1::2] = x.imag
    if fmt == "cf32":
        return inter.tobytes()
    if fmt == "cs16":
        return native.f32_to_cs16(inter).tobytes()
    if fmt == "cu8":
        return native.f32_to_cu8(inter).tobytes()
    raise ValueError(f"unknown IQ format {fmt!r}; expected {_FORMATS}")


def _item_bytes(fmt: str) -> int:
    return {"cf32": 8, "cs16": 4, "cu8": 2}[fmt]


def read_iq(path, fmt: str = "cf32") -> np.ndarray:
    """Whole-file read -> complex64 array."""
    return _decode(Path(path).read_bytes(), fmt).astype(np.complex64)


def write_iq(path, x, fmt: str = "cf32") -> None:
    Path(path).write_bytes(_encode(np.asarray(x), fmt))


class IqFileSource:
    """Iterate fixed-length complex64 blocks from a raw IQ file.

    repeat=True loops the file (like gr file_source repeat) for
    benching/soak runs."""

    def __init__(self, path, block_len: int, fmt: str = "cf32",
                 repeat: bool = False):
        self.path = Path(path)
        self.block_len = int(block_len)
        self.fmt = fmt
        self.repeat = repeat
        self._ib = _item_bytes(fmt)

    def __iter__(self):
        blk_bytes = self.block_len * self._ib
        while True:
            with open(self.path, "rb") as f:
                while True:
                    buf = f.read(blk_bytes)
                    if not buf:
                        break
                    x = _decode(buf, self.fmt).astype(np.complex64)
                    if x.size < self.block_len:
                        x = np.pad(x, (0, self.block_len - x.size))
                    yield x
            if not self.repeat:
                return


class IqFileSink:
    def __init__(self, path, fmt: str = "cf32"):
        self.fmt = fmt
        self._f = open(path, "wb")

    def write(self, x) -> None:
        self._f.write(_encode(np.asarray(x), self.fmt))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class UdpIqSource:
    """Receive IQ blocks over UDP datagrams (reference: network sample
    transport boundary, SURVEY §2.9). Reassembles datagrams into
    fixed-length blocks."""

    def __init__(self, port: int, block_len: int, fmt: str = "cf32",
                 host: str = "127.0.0.1", timeout: float | None = 5.0):
        self.block_len = int(block_len)
        self.fmt = fmt
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, port))
        if timeout is not None:
            self.sock.settimeout(timeout)
        self._buf = np.zeros(0, np.complex64)

    def read_block(self) -> np.ndarray:
        while self._buf.size < self.block_len:
            data, _ = self.sock.recvfrom(65536)
            self._buf = np.concatenate(
                [self._buf, _decode(data, self.fmt).astype(np.complex64)])
        out, self._buf = self._buf[:self.block_len], self._buf[self.block_len:]
        return out

    def close(self):
        self.sock.close()


class UdpIqSink:
    """Send IQ blocks as UDP datagrams (chunked under the MTU).

    The default chunk is sized from the sample format so each datagram
    stays under the 1472-byte UDP payload of a standard 1500-byte-MTU
    link (cf32 -> 184 samples/datagram), avoiding IP fragmentation."""

    def __init__(self, port: int, fmt: str = "cf32",
                 host: str = "127.0.0.1", chunk: int | None = None):
        self.addr = (host, port)
        self.fmt = fmt
        self.chunk = int(chunk) if chunk is not None \
            else 1472 // _item_bytes(fmt)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def write(self, x) -> None:
        x = np.asarray(x).ravel()
        for i in range(0, x.size, self.chunk):
            self.sock.sendto(_encode(x[i:i + self.chunk], self.fmt), self.addr)

    def close(self):
        self.sock.close()


class SignalSource:
    """Synthetic IQ: tone(s) + AWGN at a given SNR — the test/bench
    stand-in for an antenna."""

    def __init__(self, block_len: int, sample_rate: float,
                 tone_hz: float | list = 0.0, amplitude: float = 0.5,
                 noise_db: float | None = None, seed: int = 1234):
        self.block_len = int(block_len)
        self.fs = float(sample_rate)
        self.tones = np.atleast_1d(np.asarray(tone_hz, np.float64))
        self.amp = float(amplitude)
        self.noise_db = noise_db
        self._rng = np.random.default_rng(seed)
        self._n = 0

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        t = (self._n + np.arange(self.block_len)) / self.fs
        x = sum(self.amp * np.exp(2j * np.pi * f * t) for f in self.tones)
        if self.noise_db is not None:
            s = 10 ** (self.noise_db / 20.0)
            x = x + s * (self._rng.standard_normal(self.block_len)
                         + 1j * self._rng.standard_normal(self.block_len)) \
                / np.sqrt(2)
        self._n += self.block_len
        return x.astype(np.complex64)
