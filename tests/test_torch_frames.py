"""The frame layers of the port against the JAX package's and the golden
vectors, bit for bit, on the CPU: crc, the block codes, BPTC(196,96),
RS(12,9) and the rate-3/4 trellis against tests/fixtures/dmr_golden.json
(vectors of the reference MMDVM library, see tests/test_dmr_fec.py);
protocols/m17 against tests/fixtures/m17_golden.json (tests/
test_m17_golden.py); the DMR field codecs against dmr_golden.json; and
the layer-1 Deframer, the DMR sync hunt (find_bursts) and burst decode
(decode_burst) against the JAX modules on the same bits.

The block codes and BPTC are torch in the port (plain PyTorch, run here
on CPU tensors); the rest are copies of the JAX package's numpy modules.
"""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu.fec import block_codes as jbc  # noqa: E402
from qradiolink_tpu.fec import bptc as jbptc  # noqa: E402
from qradiolink_tpu.fec import crc as jcrc  # noqa: E402
from qradiolink_tpu.fec import rs129 as jrs  # noqa: E402
from qradiolink_tpu.fec import trellis34 as jtr  # noqa: E402
from qradiolink_tpu.framing import layer1 as jl1  # noqa: E402
from qradiolink_tpu.protocols import dmr as jdmr  # noqa: E402
from qradiolink_tpu.protocols import m17 as jm17  # noqa: E402
from qradiolink_tpu_torch.fec import block_codes as bc  # noqa: E402
from qradiolink_tpu_torch.fec import bptc, crc, rs129, trellis34  # noqa: E402
from qradiolink_tpu_torch.framing import layer1  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr, m17  # noqa: E402
import tests.torch_parity  # noqa: E402,F401  (the 2-thread cap)

FIX = pathlib.Path(__file__).parent / "fixtures"
DMR_GOLD = json.loads((FIX / "dmr_golden.json").read_text())
M17_GOLD = json.loads((FIX / "m17_golden.json").read_text())
CPU = "cpu"

CODES = ["HAMMING_15_11", "HAMMING_15_11_2", "HAMMING_13_9", "HAMMING_10_6",
         "HAMMING_16_11", "HAMMING_17_12", "GOLAY_23_12", "GOLAY_24_12",
         "GOLAY_20_8", "QR_16_7"]


def hex_bits(h: str) -> np.ndarray:
    return np.unpackbits(np.frombuffer(bytes.fromhex(h), np.uint8))


def info_bits(frame_hex: str) -> np.ndarray:
    """A 33-byte DMR burst's 196 info bits (bits 0..97 and 166..263)."""
    bits = hex_bits(frame_hex)
    return np.concatenate([bits[:98], bits[166:264]])


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint8))


# -- crc ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["crc32", "crc16_ccitt", "crc16_m17",
                                  "crc8", "crc9_dmr"])
def test_crc_matches_jax(rng, name):
    """Bytes of 0-257 (crc9_dmr: bits of 0-2,056) as the JAX CRCs give."""
    for n in (0, 1, 9, 30, 257):
        data = rng.integers(0, 256, n).astype(np.uint8)
        data = np.unpackbits(data) if name == "crc9_dmr" else bytes(data)
        assert getattr(crc, name)(data) == getattr(jcrc, name)(data), n


def test_crc_ccitt162_golden():
    for case in DMR_GOLD["crc_ccitt162"]:
        want = int.from_bytes(bytes.fromhex(case["crc"]), "big")
        got = crc.crc16_ccitt(bytes.fromhex(case["data"]), init=0) ^ 0xFFFF
        assert got == want


# -- block codes ----------------------------------------------------------

@pytest.mark.parametrize("name", CODES)
def test_block_code_matches_jax(rng, name):
    """Encode 64 random words, then decode them with 0..t+1 bit errors a
    word (beyond t the syndrome table's guess and its ok flag): codewords,
    data and ok equal to the JAX code's."""
    code, jcode = getattr(bc, name), getattr(jbc, name)
    u = rng.integers(0, 2, (64, code.k)).astype(np.uint8)
    c = code.encode(t(u))
    assert c.dtype == torch.uint8
    np.testing.assert_array_equal(c.numpy(), np.asarray(jcode.encode(
        jnp.asarray(u))))
    r = c.numpy().copy()
    for i in range(64):
        r[i, rng.choice(code.n, i % (code.t + 2), replace=False)] ^= 1
    for fn in ("decode", "decode_codeword"):
        got = getattr(code, fn)(t(r))
        want = getattr(jcode, fn)(jnp.asarray(r))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=f"{name} {fn}")


def test_block_code_golden():
    """The first entries of the reference's QR(16,7) and Golay(24,12)
    encoding tables (tests/test_block_codes.py)."""
    qr = [0x0000, 0x0273, 0x04E5, 0x0696, 0x09C9, 0x0BBA]
    golay = [0x000000, 0x0018EA, 0x00293E, 0x0031D4, 0x004A96, 0x00527C]
    for v, (q, g) in enumerate(zip(qr, golay)):
        cq = bc.encode_bits(bc.QR_16_7, [(v >> (6 - i)) & 1
                                         for i in range(7)], CPU)
        cg = bc.encode_bits(bc.GOLAY_23_12, [(v >> (11 - i)) & 1
                                             for i in range(12)], CPU)
        assert int("".join(map(str, cq.tolist())), 2) == q
        assert int("".join(map(str, cg.tolist())), 2) == g >> 1


def test_block_code_tables_per_device():
    """The tables reach a device at its first call and stay there."""
    code = bc.HAMMING_13_9
    code.encode(t(np.zeros((1, 9))))
    tab = code.tables("cpu")
    assert tab["err"].device.type == "cpu"
    assert code.tables(torch.device("cpu"))["err"] is tab["err"]


# -- BPTC, RS(12,9), trellis ---------------------------------------------

def test_bptc_golden():
    for case in DMR_GOLD["bptc"]:
        data = hex_bits(case["data"])
        np.testing.assert_array_equal(bptc.encode(data, device=CPU).numpy(),
                                      info_bits(case["frame"]))
        dec, ok = bptc.decode(info_bits(case["frame"]), device=CPU)
        np.testing.assert_array_equal(dec.numpy(), data)
        assert bool(ok)


@pytest.mark.parametrize("n_err", [0, 1, 2, 3, 6])
def test_bptc_matches_jax(rng, n_err):
    """8 random payloads with n_err random bit errors each: data and ok
    equal to the JAX decode's, the encode equal."""
    data = rng.integers(0, 2, (8, 96)).astype(np.uint8)
    enc = bptc.encode(t(data))
    np.testing.assert_array_equal(enc.numpy(),
                                  np.asarray(jbptc.encode(data)))
    noisy = enc.numpy().copy()
    for i in range(8):
        noisy[i, rng.choice(196, n_err, replace=False)] ^= 1
    dec, ok = bptc.decode(t(noisy))
    jdec, jok = jbptc.decode(noisy)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jdec))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))


def test_rs129_golden_and_jax():
    for case in DMR_GOLD["rs129"]:
        msg = np.frombuffer(bytes.fromhex(case["msg"]), np.uint8)
        par = np.frombuffer(bytes.fromhex(case["parity"]), np.uint8)
        got = rs129.encode(msg)
        np.testing.assert_array_equal(got, par[::-1])
        np.testing.assert_array_equal(got, jrs.encode(msg))
        cw = np.concatenate([msg, par[::-1]])
        assert bool(rs129.check(cw)) and bool(jrs.check(cw))
        cw[3] ^= 0x40
        assert not bool(rs129.check(cw))


def test_trellis_golden_and_jax(rng):
    for case in DMR_GOLD["trellis"]:
        payload = hex_bits(case["payload"])
        np.testing.assert_array_equal(trellis34.encode(payload),
                                      info_bits(case["frame"]))
    payload = rng.integers(0, 2, (4, 144)).astype(np.uint8)
    enc = trellis34.encode(payload)
    noisy = enc.copy()
    noisy[:, 40] ^= 1
    for x in (enc, noisy):
        dec, ok = trellis34.decode(x)
        jdec, jok = jtr.decode(x)
        np.testing.assert_array_equal(dec, jdec)
        np.testing.assert_array_equal(ok, jok)


# -- DMR field codecs ------------------------------------------------------

@pytest.mark.parametrize("kind", ["slottype", "emb", "fulllc", "shortlc"])
def test_dmr_fields_golden(kind):
    for case in DMR_GOLD[kind]:
        if kind == "slottype":
            st = dmr.extract_slot_type(hex_bits(case["frame"]))
            np.testing.assert_array_equal(
                st, dmr.slot_type_encode(case["cc"], case["dt"], CPU))
            cc, dt, ok = dmr.slot_type_decode(st, CPU)
            assert (int(cc), int(dt), bool(ok)) == (case["cc"], case["dt"],
                                                    True)
        elif kind == "emb":
            emb = dmr.extract_emb(hex_bits(case["frame"]))
            np.testing.assert_array_equal(emb, dmr.emb_encode(
                case["cc"], bool(case["pi"]), case["lcss"], CPU))
            cc, pi, lcss, ok = dmr.emb_decode(emb, CPU)
            assert (int(cc), bool(pi), int(lcss), bool(ok)) == \
                (case["cc"], bool(case["pi"]), case["lcss"], True)
        elif kind == "fulllc":
            lc9 = np.frombuffer(bytes.fromhex(case["lc"]), np.uint8)
            info = dmr.extract_info(hex_bits(case["frame"]))
            np.testing.assert_array_equal(dmr.full_lc_encode(
                lc9, dmr.DT_VOICE_LC_HEADER, CPU), info)
            dec, ok = dmr.full_lc_decode(info, dmr.DT_VOICE_LC_HEADER, CPU)
            np.testing.assert_array_equal(dec.reshape(-1), lc9)
            assert bool(np.asarray(ok).reshape(-1)[0])
        else:
            payload = hex_bits(case["in"])[4:40]
            want = hex_bits(case["out"])[:68]
            np.testing.assert_array_equal(dmr.short_lc_encode(payload, CPU),
                                          want)
            dec, ok = dmr.short_lc_decode(want, CPU)
            np.testing.assert_array_equal(dec, payload)
            assert ok


def test_embedded_lc_matches_jax():
    lc = dmr.LinkControl(flco=dmr.FLCO_GROUP, dst_id=2351, src_id=2405123)
    frags = dmr.embedded_lc_encode(lc.to_bytes(), CPU)
    np.testing.assert_array_equal(frags, jdmr.embedded_lc_encode(
        lc.to_bytes()))
    noisy = frags.copy()
    noisy[1, 7] ^= 1
    for f in (frags, noisy):
        got, jgot = dmr.embedded_lc_decode(f, CPU), \
            jdmr.embedded_lc_decode(f)
        np.testing.assert_array_equal(got[0], jgot[0])
        assert got[1] == jgot[1]


def test_block_codes_default_to_the_card(monkeypatch):
    """Without a device the protocol layer's block codes ask for CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dmr.slot_type_encode(1, dmr.DT_VOICE_LC_HEADER)


# -- M17 ------------------------------------------------------------------

def m17_lsf(mod):
    return mod.LinkSetupFrame.for_stream("AB1CDE", "QRADIO", can=3)


def test_m17_golden_frames():
    """Callsigns, Golay24, the LSF and the stream frames bit for bit as
    the reference encoder gives them; the decoder on the noisy frames."""
    for case in M17_GOLD["callsigns"]:
        assert m17.encode_callsign(case["call"]).hex() == case["encoded"]
    for case in M17_GOLD["golay24"]:
        assert int(m17.golay24_encode(np.asarray([case["data"]]))[0]) == \
            case["codeword"]
    assert m17_lsf(m17).to_bytes().hex() == M17_GOLD["lsf_raw"]
    enc = m17.FrameEncoder(m17_lsf(m17))
    assert np.packbits(enc.encode_lsf()).tobytes().hex() == \
        M17_GOLD["lsf_frame"]
    for case in M17_GOLD["stream_frames"]:
        frame = enc.encode_stream(bytes.fromhex(case["payload"]))
        assert np.packbits(frame).tobytes().hex() == case["frame"]
    dec = m17.FrameDecoder()
    for case in M17_GOLD["decode_cases"]:
        bits = hex_bits(case["noisy_frame"])[16:]
        if case["kind"] == "lsf":
            lsf = dec.decode_lsf(bits)
            assert (lsf.source, lsf.destination, lsf.valid()) == \
                (case["src"], case["dst"], case["valid"])
        else:
            sf = dec.decode_stream(bits)
            assert (sf.frame_number, sf.payload.hex()) == \
                (case["fn"], case["payload"])


def m17_stream_bits(mod, rng, n_payloads=4, flips=0):
    """A preamble, the LSF and stream frames between random bits, `flips`
    random bit errors."""
    enc = mod.FrameEncoder(m17_lsf(mod))
    frames = [rng.integers(0, 2, 301).astype(np.uint8),
              enc.encode_preamble(), enc.encode_lsf()]
    for i in range(n_payloads):
        frames.append(enc.encode_stream(bytes([i] * 16),
                                        last=i == n_payloads - 1))
    bits = np.concatenate(frames + [rng.integers(0, 2, 77).astype(
        np.uint8)])
    bits[rng.choice(bits.size, flips, replace=False)] ^= 1
    return bits


@pytest.mark.parametrize("flips", [0, 12])
def test_m17_deframe_and_decode_match_jax(rng, flips):
    """Deframer("M17") over the same bits, fed in two uneven pieces (its
    carried state), gives the JAX Deframer's hits; FrameDecoder gives the
    JAX decoder's LSF and payloads."""
    bits = m17_stream_bits(m17, rng, flips=flips)
    cut = 1001
    ours, theirs = layer1.Deframer("M17"), jl1.Deframer("M17")
    hits = ours.process(bits[:cut]) + ours.process(bits[cut:])
    jhits = theirs.process(bits[:cut]) + theirs.process(bits[cut:])
    assert [(int(f), bytes(b)) for f, b in hits] == \
        [(int(f), bytes(b)) for f, b in jhits]
    assert len(hits) >= (5 if flips == 0 else 1)
    dec, jdec = m17.FrameDecoder(), jm17.FrameDecoder()
    for (ftype, fb), (_, jfb) in zip(hits, jhits):
        fbits = np.unpackbits(np.frombuffer(fb, np.uint8))
        if ftype == layer1.FrameType.M17_LSF:
            a, b = dec.decode_lsf(fbits), jdec.decode_lsf(fbits)
            assert (a is None) == (b is None)
            assert a is None or (a.source, a.destination) == \
                (b.source, b.destination)
        elif ftype == layer1.FrameType.M17_STREAM:
            a, b = dec.decode_stream(fbits), jdec.decode_stream(fbits)
            assert (a.frame_number, a.payload) == (b.frame_number, b.payload)


# -- DMR sync hunt and burst decode --------------------------------------

def dmr_stream(rng, flips):
    """Idle bits, a voice LC header, a superframe, a rate-1/2 and a
    rate-3/4 data burst and the terminator (the port's encoders, held to
    the JAX ones' bits on the way), `flips` random bit errors."""
    lc = dmr.LinkControl(flco=dmr.FLCO_GROUP, dst_id=91, src_id=2405321)
    voice = rng.integers(0, 2, (6, 216)).astype(np.uint8)
    bursts = [dmr.make_lc_burst(lc, 1, dmr.DT_VOICE_LC_HEADER, device=CPU),
              *dmr.make_voice_superframe(voice, lc, 1, device=CPU),
              dmr.make_rate12_burst(np.arange(12), 1, device=CPU),
              dmr.make_rate34_burst(np.arange(18), 1, device=CPU),
              dmr.make_lc_burst(lc, 1, dmr.DT_TERMINATOR_WITH_LC,
                                device=CPU)]
    jbursts = [jdmr.make_lc_burst(lc, 1, jdmr.DT_VOICE_LC_HEADER),
               *jdmr.make_voice_superframe(voice, lc, 1),
               jdmr.make_rate12_burst(np.arange(12), 1),
               jdmr.make_rate34_burst(np.arange(18), 1),
               jdmr.make_lc_burst(lc, 1, jdmr.DT_TERMINATOR_WITH_LC)]
    for a, b in zip(bursts, jbursts):
        np.testing.assert_array_equal(a, b)
    gap = [rng.integers(0, 2, 24).astype(np.uint8) for _ in bursts]
    bits = np.concatenate([rng.integers(0, 2, 500).astype(np.uint8)]
                          + [x for pair in zip(bursts, gap) for x in pair])
    bits[rng.choice(bits.size, flips, replace=False)] ^= 1
    return bits


def same_burst(a, b):
    """Two DecodedBursts field by field (arrays equal, LCs equal)."""
    for k in ("kind", "data_type", "color_code", "emb_lcss", "ok"):
        assert getattr(a, k) == getattr(b, k), k
    assert (a.lc is None) == (b.lc is None)
    assert a.lc is None or vars(a.lc) == vars(b.lc)
    for k in ("payload", "voice_bits", "embedded_fragment"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("flips", [0, 20])
def test_dmr_find_and_decode_match_jax(rng, flips):
    """find_bursts gives the JAX hunt's hits, and decode_burst at every
    264-bit window after each hit (dead reckoning over the voice frames,
    as tests/test_chains_dmr.py) the JAX decode's fields."""
    bits = dmr_stream(rng, flips)
    hits = dmr.find_bursts(bits)
    assert hits == jdmr.find_bursts(bits)
    assert len(hits) >= (4 if flips == 0 else 1)
    starts = sorted({s + k * 288 for s, _ in hits for k in range(6)
                     if s + k * 288 + dmr.FRAME_BITS <= bits.size})
    kinds = set()
    for s in starts:
        burst = bits[s:s + dmr.FRAME_BITS]
        got = dmr.decode_burst(burst, CPU)
        same_burst(got, jdmr.decode_burst(burst))
        kinds.add(got.kind)
    if flips == 0:
        assert {"data", "voice_sync", "voice"} <= kinds
