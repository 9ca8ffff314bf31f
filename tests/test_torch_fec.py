"""FEC tail of the port against the JAX package, bit-exact: the tiled
Viterbi (the plain version of the `viterbi_tiled_k7` kernel) against the
JAX jnp path and against the JAX Pallas kernel decode_windows in interpret
mode, on integer and on non-integer soft values; TiledViterbi, Descrambler
and RxFecTailFF streamed with state."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import qradiolink_tpu.fec.viterbi_pallas as vp  # noqa: E402
from qradiolink_tpu.fec import conv as jconv, conv_ff as jconv_ff  # noqa: E402
from qradiolink_tpu.fec.scrambler import Descrambler as JaxDescr  # noqa: E402
from qradiolink_tpu.chains.digital_common import (  # noqa: E402
    RxFecTailFF as JaxRxFecTailFF, bits_to_bytes as j_b2b,
    bytes_to_bits as j_b2b_inv, pack_dibits as j_pack)
from qradiolink_tpu_torch.fec import conv, conv_ff, viterbi_cuda  # noqa: E402
from qradiolink_tpu_torch.fec.scrambler import Descrambler  # noqa: E402
from qradiolink_tpu_torch.chains.digital_common import (  # noqa: E402
    RxFecTailFF, bits_to_bytes, bytes_to_bits, pack_dibits)
from tests.torch_parity import assert_same, stream_both  # noqa: E402


def _soft(rng, shape, kind):
    """Integer soft values, or non-integer ones shaped like the 4FSK chain's
    clip(sin/cos(pi/2 * sym) * 128 + 128)."""
    if kind == "integer":
        return rng.integers(0, 256, shape).astype(np.float32)
    ph = (np.pi / 2) * (1.5 * rng.standard_normal(shape[:-1])).astype(
        np.float32)
    s = np.stack([np.sin(ph), np.cos(ph)], -1).astype(np.float32)
    return np.clip(s * 128.0 + 128.0, 0.0, 255.0).astype(np.float32)


@pytest.fixture
def pallas_interp(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(vp, "available", lambda: True)
    yield


def test_conv_code_tables_and_encoder(rng):
    for name in ("next_state", "outputs", "pred", "pred_bit", "edge_out"):
        np.testing.assert_array_equal(getattr(conv.CCSDS_K7, name),
                                      getattr(jconv.CCSDS_K7, name))
    bits = rng.integers(0, 2, (3, 200)).astype(np.uint8)
    assert_same(jconv.conv_encode(jconv.CCSDS_K7, jnp.asarray(bits), 5),
                conv.conv_encode(conv.CCSDS_K7, torch.from_numpy(bits), 5))


@pytest.mark.parametrize("kind", ["integer", "chain"])
def test_viterbi_tiled_matches_jnp_path(rng, kind):
    soft = _soft(rng, (4, 512, 2), kind)
    ref = jconv_ff.viterbi_decode_tiled(jconv.CCSDS_K7, jnp.asarray(soft))
    got = conv_ff.viterbi_decode_tiled(conv.CCSDS_K7, torch.from_numpy(soft))
    assert_same(ref, got)


@pytest.mark.parametrize("kind", ["integer", "chain"])
def test_plain_viterbi_matches_pallas_kernel(pallas_interp, rng, kind):
    """decode_windows_plain against the Pallas decode_windows on the same
    (R, S, 2) windows, R = 12 tile rows of S = 192 steps."""
    win = _soft(rng, (12, 192, 2), kind)
    ref = vp.decode_windows(jconv.CCSDS_K7, jnp.asarray(win), 32, min_rows=1)
    assert ref is not None, "Pallas Viterbi did not run"
    got = viterbi_cuda.decode_windows(conv.CCSDS_K7, torch.from_numpy(win),
                                      32)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref)[:, 32:].astype(np.uint8))


def test_viterbi_decodes_real_codewords(rng):
    bits = rng.integers(0, 2, 600).astype(np.uint8)
    coded = conv.conv_encode(conv.CCSDS_K7, torch.from_numpy(bits))
    soft = torch.where(coded > 0, 255.0, 0.0).reshape(1, 600, 2)
    soft = torch.nn.functional.pad(soft, (0, 0, 0, 40), value=128.0)
    dec = conv_ff.viterbi_decode_tiled(conv.CCSDS_K7, soft)[0].numpy()
    np.testing.assert_array_equal(dec[32:568], bits[32:568])


def test_tiled_viterbi_streamed(rng):
    blocks = [_soft(rng, (3, 400, 2), "chain") for _ in range(2)]
    stream_both(jconv_ff.TiledViterbi(lead_shape=(3,), chunk=128),
                conv_ff.TiledViterbi(lead_shape=(3,), device="cpu"), blocks,
                rtol=0, atol=0)


def test_descrambler_streamed(rng):
    blocks = [rng.integers(0, 2, (3, 300)).astype(np.uint8)
              for _ in range(2)]
    stream_both(JaxDescr(lead_shape=(3,)),
                Descrambler(lead_shape=(3,), device="cpu"), blocks)


def test_rx_fec_tail_ff_streamed(rng):
    blocks = [_soft(rng, (3, 400, 2), "chain").reshape(3, 800)
              for _ in range(2)]
    stream_both(JaxRxFecTailFF(lead_shape=(3,)),
                RxFecTailFF(lead_shape=(3,), device="cpu"), blocks,
                rtol=0, atol=0)


def test_bit_packing_helpers(rng):
    data = rng.integers(0, 256, (2, 16)).astype(np.uint8)
    bits = rng.integers(0, 2, (2, 64)).astype(np.uint8)
    assert_same(j_b2b_inv(jnp.asarray(data)),
                bytes_to_bits(torch.from_numpy(data)))
    assert_same(j_b2b(jnp.asarray(bits)),
                bits_to_bytes(torch.from_numpy(bits)))
    assert_same(j_pack(jnp.asarray(bits)), pack_dibits(torch.from_numpy(bits)))
