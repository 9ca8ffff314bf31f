"""The port's C++ host-IO engine (io/native.py, native/qrl_native.cpp)
against the JAX package's (qradiolink_tpu/io/native.py), on the CPU: the
four conversions bit for bit over every int16 and uint8 code and over
random and half-step floats, the ring buffer, the UDP receiver and the
paced sender (tests/test_native.py's cases; the sender's datagrams are
checked, not its pacing), the build into build/native/ and its failure;
and the UDP IQ transports of io/iq.py (UdpIqSource, UdpIqSink) against
the JAX module's."""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu.io import iq as jiq  # noqa: E402
from qradiolink_tpu.io import native as jnative  # noqa: E402
from qradiolink_tpu_torch.io import iq, native  # noqa: E402

needs_jax_engine = pytest.mark.skipif(
    not jnative.native_available(), reason="the JAX engine did not build")


def _deadline(pred, seconds=20.0):
    """Poll pred() until it holds or the deadline passes; its last value."""
    end = time.monotonic() + seconds
    while not pred() and time.monotonic() < end:
        time.sleep(0.005)
    return pred()


@needs_jax_engine
@pytest.mark.parametrize("conv", ["cs16_to_f32", "cu8_to_f32"])
def test_reads_equal_the_jax_engine_on_every_code(conv):
    x = np.arange(-32768, 32768, dtype=np.int16) if conv == "cs16_to_f32" \
        else np.arange(256, dtype=np.uint8)
    got, want = getattr(native, conv)(x), getattr(jnative, conv)(x)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@needs_jax_engine
@pytest.mark.parametrize("conv,scale,offset", [("f32_to_cs16", 32767.0, 0.0),
                                               ("f32_to_cu8", 127.5, 127.5)])
def test_writes_equal_the_jax_engine(conv, scale, offset):
    """Random floats past full scale, every half step (the ties the engine
    rounds away from zero) and its neighbours one ulp either side."""
    rng = np.random.default_rng(0)
    half = ((np.arange(-520, 520) + 0.5 - offset) / scale).astype(np.float32)
    x = np.concatenate([rng.uniform(-1.3, 1.3, 20_000).astype(np.float32),
                        half, np.nextafter(half, np.float32(2)),
                        np.nextafter(half, np.float32(-2)),
                        np.float32([0.0, -0.0, 1.0, -1.0, 7.0, -7.0])])
    got, want = getattr(native, conv)(x), getattr(jnative, conv)(x)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_conversion_parity_with_numpy():
    """tests/test_native.py:18-34 on the port's engine."""
    rng = np.random.default_rng(0)
    s16 = rng.integers(-32767, 32768, 10_000).astype(np.int16)
    np.testing.assert_allclose(native.cs16_to_f32(s16),
                               s16.astype(np.float32) / 32767.0,
                               rtol=0, atol=1e-7)
    f = rng.uniform(-1.2, 1.2, 10_000).astype(np.float32)
    want = np.round(np.clip(f * 32767.0, -32767, 32767)).astype(np.int16)
    got = native.f32_to_cs16(f).astype(np.int32)
    assert np.abs(got - want.astype(np.int32)).max() <= 1
    u8 = rng.integers(0, 256, 10_000).astype(np.uint8)
    np.testing.assert_allclose(native.cu8_to_f32(u8),
                               (u8.astype(np.float32) - 127.5) / 127.5,
                               rtol=0, atol=1e-7)
    want8 = np.round(np.clip(f * 127.5 + 127.5, 0, 255)).astype(np.uint8)
    got8 = native.f32_to_cu8(f).astype(np.int32)
    assert np.abs(got8 - want8.astype(np.int32)).max() <= 1


def test_iq_codec_uses_native_and_roundtrips(monkeypatch):
    """io/iq.py converts cs16 and cu8 through the engine (its calls are
    counted), and a round trip stays within a step of the format."""
    calls = []
    for name in ("cs16_to_f32", "f32_to_cs16", "cu8_to_f32", "f32_to_cu8"):
        fn = getattr(native, name)
        monkeypatch.setattr(native, name,
                            lambda x, fn=fn, name=name: calls.append(name)
                            or fn(x))
    rng = np.random.default_rng(1)
    x = (rng.uniform(-0.9, 0.9, 2000)
         + 1j * rng.uniform(-0.9, 0.9, 2000)).astype(np.complex64)
    for fmt, tol in (("cs16", 1e-4), ("cu8", 1e-2)):
        y = iq._decode(iq._encode(x, fmt), fmt)
        np.testing.assert_allclose(y, x, atol=tol)
    assert calls == ["f32_to_cs16", "cs16_to_f32", "f32_to_cu8",
                     "cu8_to_f32"]


def test_ring_buffer_wrap_and_backpressure():
    r = native.RingBuffer(256)       # rounded to a power of two
    data = bytes(range(200))
    assert r.write(data) == 200
    assert r.read(200) == data
    assert r.write(data) == 200
    assert r.read(100) == data[:100]
    assert r.write(data) == 156      # only free space accepted
    assert r.readable == 256
    got = r.read(1000)
    assert got == data[100:] + data[:156]
    r.close()


def test_ring_buffer_threaded_spsc():
    r = native.RingBuffer(1 << 16)
    total = 2_000_000
    src = np.random.default_rng(2).integers(0, 256, total,
                                            dtype=np.uint8).tobytes()

    def producer():
        pos = 0
        while pos < total:
            pos += r.write(src[pos:pos + 4096])

    t = threading.Thread(target=producer)
    t.start()
    out = bytearray()
    deadline = time.monotonic() + 60
    while len(out) < total and time.monotonic() < deadline:
        out += r.read(8192)
    t.join(timeout=60)
    assert bytes(out) == src
    r.close()


def test_udp_rx_engine():
    """Ten datagrams to the receiver's ephemeral port; the reader waits
    for them with a generous deadline."""
    eng = native.UdpRxEngine(port=0)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    payload = bytes(range(256)) * 4
    try:
        for _ in range(10):
            tx.sendto(payload, ("127.0.0.1", eng.port))
        got = bytearray()

        def done():
            got.extend(eng.read(65536))
            return len(got) >= 10 * len(payload)
        assert _deadline(done)
        assert eng.datagrams == 10 and eng.dropped == 0
        assert bytes(got) == payload * 10
    finally:
        eng.close()
        tx.close()


def test_udp_tx_engine_sends_each_chunk():
    """The paced sender's datagrams arrive whole and in order; its cadence
    is not gated on (the suite runs loaded)."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(20.0)
    chunk = 512
    tx = native.UdpTxEngine("127.0.0.1", rx.getsockname()[1],
                            chunk_bytes=chunk, ns_per_chunk=2_000_000)
    try:
        payloads = [bytes([k]) * chunk for k in range(10)]
        for p in payloads:
            assert tx.write(p) == chunk
        got = [rx.recvfrom(65536)[0] for _ in payloads]
        assert got == payloads
        assert _deadline(lambda: tx.datagrams >= 10)
    finally:
        tx.close()
        rx.close()


def test_build_goes_to_build_native_and_fails_loudly(tmp_path, monkeypatch):
    """The library lives under build/native/<hash of source and flags>/;
    a source g++ refuses raises with the compiler's message, and nothing
    is left at the library's path."""
    so = native.build()
    assert so == native.lib_path() and so.exists()
    assert so.parent.parent == native.BUILD_ROOT
    assert native.BUILD_ROOT.parts[-2:] == ("build", "native")
    bad = tmp_path / "qrl_native.cpp"
    bad.write_text("extern \"C\" void qrl_broken( { }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed") as e:
        native.build()
    assert "error" in str(e.value)     # the compiler's own message
    assert not native.lib_path().exists()
    assert not list((tmp_path / "build").rglob("*.so*"))


def test_udp_iq_roundtrip_and_chunks_match_jax():
    """tests/test_io.py:42-53 on the port's UdpIqSource / UdpIqSink, and
    the sink's datagrams equal the JAX sink's byte for byte in each
    format (the 1472-byte rule: 184 cf32, 368 cs16, 736 cu8 samples)."""
    x = (np.arange(600) * (1 + 1j)).astype(np.complex64) / 600.0
    src = iq.UdpIqSource(port=0, block_len=600, timeout=20.0)
    sink = iq.UdpIqSink(port=src.sock.getsockname()[1])
    try:
        t = threading.Thread(target=sink.write, args=(x,))
        t.start()
        blk = src.read_block()
        t.join()
        np.testing.assert_allclose(blk, x, atol=1e-6)
        assert blk.dtype == np.complex64 and blk.shape == (600,)
    finally:
        src.close()
        sink.close()
    rng = np.random.default_rng(4)
    y = ((rng.standard_normal(2000) + 1j * rng.standard_normal(2000))
         * 0.3).astype(np.complex64)
    for fmt in ("cf32", "cs16", "cu8"):
        got = []
        for mod in (iq, jiq):
            rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            rx.bind(("127.0.0.1", 0))
            rx.settimeout(20.0)
            s = mod.UdpIqSink(rx.getsockname()[1], fmt=fmt)
            s.write(y)
            n = -(-y.size // s.chunk)
            got.append((s.chunk, [rx.recvfrom(65536)[0] for _ in range(n)]))
            s.close()
            rx.close()
        assert got[0] == got[1]
        assert max(len(d) for d in got[0][1]) <= 1472


def test_udp_iq_source_reassembles_like_jax():
    """Datagrams of uneven sizes reassemble into the same blocks in both
    packages (cs16, through the engines)."""
    rng = np.random.default_rng(5)
    y = ((rng.standard_normal(3000) + 1j * rng.standard_normal(3000))
         * 0.3).astype(np.complex64)
    wire = jiq._encode(y, "cs16")
    cuts = [0, 400, 404, 1600, 5200, 9000, len(wire)]
    blocks = []
    for mod in (iq, jiq):
        src = mod.UdpIqSource(port=0, block_len=1000, fmt="cs16",
                              timeout=20.0)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for a, b in zip(cuts, cuts[1:]):
            tx.sendto(wire[a:b], src.sock.getsockname())
        blocks.append([src.read_block() for _ in range(3)])
        src.close()
        tx.close()
    for g, w in zip(*blocks):
        assert g.tobytes() == w.tobytes()
