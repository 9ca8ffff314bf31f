"""TUN/TAP network device + IP-over-radio frame pump (port of
qradiolink_tpu/net/netdev.py; host-side, numpy).

TunTapDevice mirrors reference src/net/netdevice.cpp:39-180: a TAP
interface `tapifN` (IFF_TAP | IFF_NO_PI) opened non-blocking, address +
netmask + MTU configured through socket ioctls, raw IP/Ethernet frames
read and written through the tun fd. LoopbackNetDevice is the CI-safe
stand-in (an in-memory queue pair) for hosts without CAP_NET_ADMIN.

The air frame format matches the reference's processInputNetStream /
receiveNetData (src/radiocontroller.cpp:783-800,1669-1704):

  [len u32 LE] x3  |  [crc32 u32 LE]  |  payload  |  random fill

— the length is sent three times and majority-voted on RX (the
reference's getFrameLength), the CRC32 covers the payload only, and
the frame is padded to the mode's fixed frame size with deterministic
pseudo-random filler (never zeros, to keep symbol transitions).

NetPump drives the two directions against a modem controller and
implements the data-modem periodic reset (300 s running -> 2 s idle ->
restart, src/radiocontroller.cpp:1260-1290), with sample-time-driven
timers (offline-reproducible, like app/controller.py).
"""

from __future__ import annotations

import fcntl
import os
import socket
import struct
from collections import deque

import numpy as np

from qradiolink_tpu_torch.fec.crc import crc32

# ioctl numbers (linux/if_tun.h, linux/sockios.h)
TUNSETIFF = 0x400454CA
IFF_TUN = 0x0001
IFF_TAP = 0x0002
IFF_NO_PI = 0x1000
SIOCSIFADDR = 0x8916
SIOCSIFNETMASK = 0x891C
SIOCGIFFLAGS = 0x8913
SIOCSIFFLAGS = 0x8914
SIOCSIFMTU = 0x8922
IFF_UP = 0x1
IFF_RUNNING = 0x40

# per-TX-mode frame parameters (reference processInputNetStream:752-767)
# mode -> (max_frame_size, read_size, ns_per_frame)
IP_MODE_PARAMS = {
    "QPSK250K": (1516, 1500, 48_000_000),
    "4FSK100K": (622, 606, 50_000_000),
}

_HEADER = 16  # 3x len + crc


def _fill_bytes(n: int, seed: int = 7) -> np.ndarray:
    """Deterministic non-zero filler (the reference uses one random
    buffer generated at startup, radiocontroller.cpp rand_frame_data)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 255, n, dtype=np.uint8)


_FILL = _fill_bytes(4096)


def ip_frame_encode(payload: bytes, max_frame_size: int) -> bytes:
    """IP payload -> fixed-size air frame (len x3, crc32, fill)."""
    n = len(payload)
    if n > max_frame_size - _HEADER:
        raise ValueError(f"payload {n} exceeds frame budget "
                         f"{max_frame_size - _HEADER}")
    crc = crc32(payload) if n else 0
    head = struct.pack("<III", n, n, n) + struct.pack("<I", crc)
    body = head + payload
    pad = max_frame_size - len(body)
    return body + _FILL[:pad].tobytes()


def idle_frame(max_frame_size: int) -> bytes:
    """The keep-the-modem-fed frame sent when the TAP has no data
    (len==0; RX drops it, radiocontroller.cpp:805-820)."""
    head = struct.pack("<III", 0, 0, 0)
    return head + _FILL[:max_frame_size - 12].tobytes()


def _majority_len(frame: bytes) -> int:
    """Majority vote over the three length copies (reference
    getFrameLength)."""
    a, b, c = struct.unpack("<III", frame[:12])
    if a == b or a == c:
        return a
    if b == c:
        return b
    return a


def ip_frame_decode(frame: bytes, mtu: int = 1500) -> bytes | None:
    """Air frame -> IP payload, or None (idle frame / bad CRC / bad
    length) (reference receiveNetData:1669-1704)."""
    if len(frame) < 12:
        return None
    n = _majority_len(frame)
    if n == 0 or n > mtu or len(frame) < _HEADER + n:
        return None
    (crc,) = struct.unpack("<I", frame[12:16])
    payload = frame[_HEADER:_HEADER + n]
    if crc32(payload) != crc:
        return None
    return payload


class LoopbackNetDevice:
    """In-memory NetDevice: frames written by the 'kernel side' appear
    on read() and vice versa. CI-safe stand-in for TunTapDevice."""

    def __init__(self, mtu: int = 1480):
        self.mtu = mtu
        self._to_radio: deque[bytes] = deque()
        self._from_radio: deque[bytes] = deque()

    # radio side (NetDevice API)
    def read(self, size: int = 1500) -> bytes | None:
        return self._to_radio.popleft() if self._to_radio else None

    def write(self, frame: bytes) -> int:
        self._from_radio.append(bytes(frame))
        return len(frame)

    # "kernel" side for tests
    def inject(self, frame: bytes):
        self._to_radio.append(bytes(frame))

    def delivered(self) -> list[bytes]:
        out = list(self._from_radio)
        self._from_radio.clear()
        return out

    def close(self):
        pass


class TunTapDevice:
    """Real TAP device (requires CAP_NET_ADMIN). API-compatible with
    LoopbackNetDevice's radio side."""

    def __init__(self, ip_address: str = "10.0.1.2", mtu: int = 1480,
                 tap: bool = True, name: str | None = None):
        self.mtu = int(mtu)
        if name is None:
            name = f"tapif{ip_address.split('.')[-1][-1]}"
        self.name = name
        self.fd = os.open("/dev/net/tun", os.O_RDWR)
        os.set_blocking(self.fd, False)
        flags = (IFF_TAP if tap else IFF_TUN) | IFF_NO_PI
        ifr = struct.pack("16sH", name.encode()[:15], flags) + b"\x00" * 22
        fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            def addr_ifr(ip):
                return struct.pack(
                    "16sH2s4s8s", name.encode()[:15], socket.AF_INET,
                    b"\x00\x00", socket.inet_aton(ip), b"\x00" * 8)
            fcntl.ioctl(s, SIOCSIFADDR, addr_ifr(ip_address))
            fcntl.ioctl(s, SIOCSIFNETMASK, addr_ifr("255.255.255.0"))
            ifr_fl = struct.pack("16sH", name.encode()[:15], 0) + b"\x00" * 22
            got = fcntl.ioctl(s, SIOCGIFFLAGS, ifr_fl)
            (fl,) = struct.unpack_from("H", got, 16)
            ifr_fl = struct.pack("16sH", name.encode()[:15],
                                 fl | IFF_UP | IFF_RUNNING) + b"\x00" * 22
            fcntl.ioctl(s, SIOCSIFFLAGS, ifr_fl)
            ifr_mtu = struct.pack("16si", name.encode()[:15], self.mtu) \
                + b"\x00" * 20
            fcntl.ioctl(s, SIOCSIFMTU, ifr_mtu)
        finally:
            s.close()

    def read(self, size: int = 1500) -> bytes | None:
        try:
            return os.read(self.fd, size)
        except BlockingIOError:
            return None

    def write(self, frame: bytes) -> int:
        return os.write(self.fd, frame)

    def close(self):
        os.close(self.fd)


class NetPump:
    """IP modem pump: TAP <-> layer-1 framed modem data.

    TX direction (reference processInputNetStream): every frame period,
    read up to read_size bytes from the device; build the air frame
    (idle filler when the device is dry, unless burst mode) and hand it
    to the controller's IP TX. RX direction (receiveNetData): decode,
    CRC-check, write to the device. The data-modem reset mirrors
    updateDataModemReset: after 300 s of continuous TX the modem idles
    2 s to cap GNU-Radio-style latency buildup; our chains have no such
    buildup but the flow-control contract (and its observable gap) is
    kept for parity.
    """

    RESET_AFTER_S = 300.0
    SLEEP_S = 2.0

    def __init__(self, device, mode: str = "QPSK250K",
                 burst_mode: bool = False):
        if mode not in IP_MODE_PARAMS:
            raise ValueError(f"{mode} is not an IP modem mode")
        self.device = device
        self.mode = mode
        self.burst = bool(burst_mode)
        self.max_frame, self.read_size, self.ns_per_frame = \
            IP_MODE_PARAMS[mode]
        self._run_time = 0.0
        self._sleep_left = 0.0
        self.resets = 0

    def poll_tx(self, dt: float = 0.05) -> bytes | None:
        """Advance time by dt seconds; return the next air frame to
        transmit, or None (modem sleeping / burst mode idle)."""
        if self._sleep_left > 0.0:
            self._sleep_left -= dt
            if self._sleep_left <= 0.0:
                self._sleep_left = 0.0
                self._run_time = 0.0
            return None
        self._run_time += dt
        if self._run_time > self.RESET_AFTER_S:
            self._sleep_left = self.SLEEP_S
            self.resets += 1
            return None
        data = self.device.read(self.read_size)
        if data:
            return ip_frame_encode(data, self.max_frame)
        if self.burst:
            return None
        return idle_frame(self.max_frame)

    def push_rx(self, frame: bytes) -> bool:
        """Deliver one received air frame to the device; True if an IP
        payload was written."""
        payload = ip_frame_decode(bytes(frame), mtu=self.device.mtu + 20)
        if payload is None:
            return False
        self.device.write(payload)
        return True
