"""DMR utilities: group-number conversions, text parsing, privacy
challenge, ID lookup (a copy of qradiolink_tpu/protocols/dmr_utils.py,
pure numpy and stdlib).

Re-derivation of reference src/DMR/dmrutils.cpp (Tier III base-11
group-number arithmetic, ISO7/UTF-16 text unpacking),
src/DMR/rc4.cpp (the ETSI TS 102 361-4 §6.4.8 MS authentication
challenge-response over RC4), and src/DMR/dmridlookup.cpp (DMR ID ->
callsign CSV database).
"""

from __future__ import annotations

import secrets
from pathlib import Path

import numpy as np


# ------------------------------------------------------------ group numbers
def base11(value: int) -> int:
    """Digit-wise base-11 expansion (dmrutils.cpp:60-65)."""
    if value < 1:
        return 0
    return (value % 11) + 10 * base11(value // 11)


def base11_group_to_base10(group_number: int) -> int:
    """Tier III base-11 talkgroup id -> decimal (dmrutils.cpp:25-42)."""
    if group_number < 1:
        return 0
    b = base11(group_number)
    if b < 99_999:
        return b
    digit = [(b // 10 ** i) % 10 for i in range(7)]
    big_three = (digit[6] * 121 + digit[5] * 11 + digit[4]) * 10_000
    small_four = (digit[3] * 1000 + digit[2] * 100
                  + digit[1] * 10 + digit[0])
    return big_three + small_four


def base10_group_to_base11(gid: int) -> int:
    """Decimal talkgroup -> base-11 wire value (dmrutils.cpp:67-79)."""
    if gid > 9_999_999 or gid < 1:
        return 0
    digit = [(gid // 10 ** i) % 10 for i in range(7)]
    # the reference's coefficients are NOT pure 11^i above digit 4:
    # 146410 = 14641*10 and 1464100 = 14641*100 (the "big three" digits
    # stay decimal-scaled; dmrutils.cpp:77)
    coeff = (1, 11, 121, 1331, 14641, 146410, 1464100)
    return sum(d * c for d, c in zip(digit, coeff))


def p3_group_to_cai(group_number: int) -> int:
    """Capacity+ P3 group number -> CAI (dmrutils.cpp:16-23)."""
    np_ = group_number // 100_000
    fgn = (group_number - np_ * 100_000) // 10_000
    gn = (group_number - np_ * 100_000) - fgn * 1000
    return (np_ - 328) * 0x8000 + (fgn - 20) * 100 + (gn - 900) + 1_048_577


# ----------------------------------------------------------------- text
def parse_utf16(data: bytes) -> str:
    """Big-endian UTF-16 text payload (dmrutils.cpp parseUTF16)."""
    return data.decode("utf-16-be", errors="replace").rstrip("\x00")


def parse_iso7(data: bytes, n_chars: int | None = None) -> str:
    """Packed 7-bit ISO text -> string (dmrutils.cpp
    parseISO7bitToISO8bit semantics via bit unpacking)."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    usable = (len(bits) // 7) * 7
    chars = (bits[:usable].reshape(-1, 7)
             * (1 << np.arange(6, -1, -1))).sum(1)
    if n_chars is not None:
        chars = chars[:n_chars]
    return "".join(chr(int(c)) for c in chars if c)


# ------------------------------------------------------------ RC4 privacy
def _rc4_keystream(key: bytes, n: int) -> bytes:
    """Plain RC4 (KSA + PRGA) — the standard cipher the reference's
    rc4.cpp implements."""
    s = list(range(256))
    j = 0
    for i in range(256):
        j = (j + s[i] + key[i % len(key)]) % 256
        s[i], s[j] = s[j], s[i]
    out = bytearray()
    i = j = 0
    for _ in range(n):
        i = (i + 1) % 256
        j = (j + s[i]) % 256
        s[i], s[j] = s[j], s[i]
        out.append(s[(s[i] + s[j]) % 256])
    return bytes(out)


def auth_challenge_response(auth_key: bytes,
                            challenge: int | None = None
                            ) -> tuple[int, int]:
    """ETSI TS 102 361-4 §6.4.8 MS authentication: a 24-bit random
    challenge is concatenated with the 128-bit MS key; the response is
    the last 3 bytes of a 24-byte RC4 keystream (reference
    rc4.cpp arc4_get_challenge_response)."""
    if challenge is None:
        challenge = secrets.randbelow(0xFFFCDF + 1)
    if challenge > 0xFFFCDF:
        challenge = 0xFFFCDF
    key = challenge.to_bytes(3, "big") + bytes(auth_key[:16])
    ks = _rc4_keystream(key, 24)
    response = int.from_bytes(ks[-3:], "big")
    return challenge, response


def auth_check(auth_key: bytes, challenge: int, response: int) -> bool:
    """Verify an MS auth response against the shared key."""
    _, want = auth_challenge_response(auth_key, challenge)
    return want == response


# ------------------------------------------------------------- ID lookup
class DmrIdLookup:
    """DMR ID -> callsign/name database (reference dmridlookup.cpp:
    DMRIds.dat with tab- or comma-separated 'id,callsign,name'
    lines)."""

    def __init__(self, path: str | Path | None = None):
        self._ids: dict[int, str] = {}
        if path is not None and Path(path).exists():
            self.load(path)

    def load(self, path: str | Path):
        for line in Path(path).read_text(errors="replace").splitlines():
            fields = line.replace("\t", ",").split(",")
            if len(fields) < 3:
                continue
            try:
                dmr_id = int(fields[0])
            except ValueError:
                continue
            self._ids[dmr_id] = (f"{fields[0]} - {fields[1]} - "
                                 f"{fields[2]}")

    def add(self, dmr_id: int, callsign: str, name: str = ""):
        self._ids[int(dmr_id)] = f"{dmr_id} - {callsign} - {name}"

    def lookup(self, dmr_id: int) -> str:
        """-> 'id - callsign - name', or the bare id when unknown
        (reference DMRIdLookup::lookup)."""
        return self._ids.get(int(dmr_id), str(dmr_id))

    def __len__(self):
        return len(self._ids)
