"""The port's BCH(63,16) and AMBE voice FEC (fec/bch.py, fec/ambe.py)
against the JAX package's and the golden vectors of the compiled reference
(tests/fixtures/bch_golden.json, ambe_golden.json), bit for bit, on CPU
tensors."""

import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu.fec import ambe as jambe  # noqa: E402
from qradiolink_tpu.fec import bch as jbch  # noqa: E402
from qradiolink_tpu_torch.fec import ambe, bch  # noqa: E402

FIX = pathlib.Path(__file__).parent / "fixtures"
BCH = json.loads((FIX / "bch_golden.json").read_text())
AMBE = json.loads((FIX / "ambe_golden.json").read_text())


def _burst_voice_bits(hex33: str) -> np.ndarray:
    """33-byte burst -> (216,) voice bits (bits 0..107 and 156..263)."""
    bits = np.unpackbits(np.frombuffer(bytes.fromhex(hex33), np.uint8))
    return np.concatenate([bits[:108], bits[156:264]])


def test_encode_nid_matches_golden_and_jax():
    for case in BCH["cases"]:
        nid = bytes.fromhex(case["in"])
        out = bch.encode_nid(nid, device="cpu")
        assert out.hex() == case["out"], case
        assert out == jbch.encode_nid(nid)


@pytest.mark.parametrize("shape", [(16,), (32, 16), (3, 5, 16)])
def test_bch_encode_matches_jax(shape):
    data = np.random.default_rng(sum(shape)).integers(0, 2, shape)
    want = np.asarray(jbch.bch_encode(data.astype(np.float32)))
    got = bch.bch_encode(torch.from_numpy(data.astype(np.uint8)))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        bch.bch_encode(data, device="cpu").numpy(), want)
    np.testing.assert_array_equal(bch.parity_matrix(), jbch.parity_matrix())


def test_golay_words_match_golden_and_jax():
    for case in AMBE["golay24128"]:
        d = case["data"]
        assert int(ambe.golay24_encode_word(d, "cpu")) == case["enc24"]
        assert int(ambe.golay23_encode_word(d, "cpu")) << 1 == case["enc23"]
    words = np.arange(4096)
    np.testing.assert_array_equal(ambe.golay24_encode_word(words, "cpu"),
                                  jambe.golay24_encode_word(words))
    np.testing.assert_array_equal(ambe.PRNG_TABLE, jambe.PRNG_TABLE)


def test_regenerate_matches_golden_and_jax():
    ins = np.stack([_burst_voice_bits(c["in"]) for c in AMBE["ambe_regen"]])
    outs = np.stack([_burst_voice_bits(c["out"])
                     for c in AMBE["ambe_regen"]])
    errs = np.array([c["errors"] for c in AMBE["ambe_regen"]])
    got, got_errs = ambe.regenerate_voice(ins, "cpu")
    np.testing.assert_array_equal(got_errs, errs)
    np.testing.assert_array_equal(got, outs)
    want, want_errs = jambe.regenerate_voice(ins)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_errs, want_errs)


@pytest.mark.parametrize("flips", [0, 2, 5, 12])
def test_encode_decode_regenerate_match_jax(flips):
    """Random payloads, with `flips` bit errors a 72-bit frame placed
    anywhere (past the Golay codes' reach at 5 and 12, so the silence
    substitution and the undecodable-a path run too): encode, decode and
    regenerate equal the JAX functions bit for bit."""
    rng = np.random.default_rng(100 + flips)
    payloads = rng.integers(0, 2, (6, 3, 49)).astype(np.uint8)
    voice = ambe.voice_encode(payloads, "cpu")
    np.testing.assert_array_equal(voice, jambe.voice_encode(payloads))
    noisy = voice.reshape(6, 3, 72).copy()
    for i in range(6):
        for k in range(3):
            noisy[i, k, rng.choice(72, flips, replace=False)] ^= 1
    noisy = noisy.reshape(6, 216)
    for fn in ("voice_decode", "regenerate_voice"):
        got = getattr(ambe, fn)(noisy, "cpu")
        want = getattr(jambe, fn)(noisy)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=fn)
    if flips == 0:
        dec, errs = ambe.voice_decode(voice, "cpu")
        np.testing.assert_array_equal(dec, payloads)
        assert errs.sum() == 0


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bch.bch_encode(np.zeros(16, np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        ambe.voice_encode(np.zeros((3, 49), np.uint8))
