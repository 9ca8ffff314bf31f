"""The slice as a whole: the port's Fsk4DemodFF against the JAX chain on the
CPU. On the frozen capture the bits must be equal and the symbols within
atol 1e-5 (the JAX package's own spread between its FFT and direct-form RRC
is 1.4e-6 there); state leaves are compared after every block, and a stream
can be handed from the JAX chain to the port mid-way."""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu.chains.fsk import Fsk4DemodFF as JaxFsk4  # noqa: E402
from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF  # noqa: E402
from qradiolink_tpu_torch.chains.digital_common import bytes_to_bits  # noqa
from qradiolink_tpu_torch.core import state_from_numpy  # noqa: E402
from tests.test_chains_digital import best_ber  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_same, assert_states_same, stream_both, to_torch)

FIX = pathlib.Path(__file__).parent / "fixtures" / "iq_4fsk2k_-6db.npz"
# state leaves: the sync's bin accumulator sums ~1e3 squared samples and the
# Viterbi tail holds soft values in [0, 255]
STATE_RTOL, STATE_ATOL = 1e-5, 1e-3
# outputs: symbols (scale ~5) within 1e-5 + 1e-5 |s|; the constellation is
# cos/sin(pi/2 * s), so pi/2 times that at |s| ~ 5; rssi in dB
OUT_TOL = {"symbols": (1e-5, 1e-5), "constellation": (0, 1e-4),
           "rssi": (0, 1e-4)}


def _fixture_blocks():
    data = np.load(FIX)
    re = data["iq_re"].astype(np.float32)
    im = data["iq_im"].astype(np.float32)
    half = len(re) // 2
    return [(re[:half], im[:half]), (re[half:], im[half:])], data["payload"]


@pytest.fixture(scope="module")
def jax_fixture_run():
    """The JAX chain over the capture in two complex blocks: per-block
    outputs and the state after each block."""
    blocks, payload = _fixture_blocks()
    chain = JaxFsk4()
    states, outs = [chain.init_state()], []
    for re, im in blocks:
        st, out = chain(states[-1], jnp.asarray(
            (re + 1j * im).astype(np.complex64)))
        states.append(st)
        outs.append(out)
    return blocks, payload, states, outs


def test_fixture_matches_jax(jax_fixture_run):
    blocks, payload, jstates, jouts = jax_fixture_run
    chain = Fsk4DemodFF(device="cpu")
    st = chain.init_state()
    bits = []
    for i, blk in enumerate(blocks):
        st, out = chain(st, to_torch(blk))
        assert_same(jouts[i]["bits"], out["bits"], what=f"block {i} bits")
        assert_same(jouts[i]["symbols"], out["symbols"], rtol=0, atol=1e-5,
                    what=f"block {i} symbols")
        assert_same(jouts[i]["rssi"], out["rssi"], rtol=0, atol=1e-4,
                    what=f"block {i} rssi")
        assert_same(jouts[i]["constellation"], out["constellation"], 0,
                    2e-5, what=f"block {i} constellation")
        assert_states_same(jstates[i + 1], st, STATE_RTOL, STATE_ATOL)
        bits.append(out["bits"].numpy())
    sent = bytes_to_bits(torch.from_numpy(payload)).numpy()
    assert best_ber(np.concatenate(bits), sent) < 0.01


def test_mid_stream_hand_off(jax_fixture_run):
    """Block 1 in JAX, its state carried across, block 2 in the port."""
    blocks, _, jstates, jouts = jax_fixture_run
    chain = Fsk4DemodFF(device="cpu")
    st = state_from_numpy(jax.tree_util.tree_map(np.asarray, jstates[1]),
                          "cpu")
    st, out = chain(st, to_torch(blocks[1]))
    assert_same(jouts[1]["bits"], out["bits"])
    assert_same(jouts[1]["symbols"], out["symbols"], rtol=0, atol=1e-5)
    assert_states_same(jstates[2], st, STATE_RTOL, STATE_ATOL)


def test_four_channels_streamed():
    """lead_shape=(4,) over two 20,000-sample blocks: four different
    stretches of the capture as four channels."""
    re, im = _fixture_blocks()[0][0]
    chans = [(re[k * 40_000:(k + 1) * 40_000], im[k * 40_000:(k + 1) * 40_000])
             for k in range(4)]
    x_re = np.stack([c[0] for c in chans])
    x_im = np.stack([c[1] for c in chans])
    blocks = [(x_re[:, :20_000], x_im[:, :20_000]),
              (x_re[:, 20_000:], x_im[:, 20_000:])]
    stream_both(JaxFsk4(lead_shape=(4,)),
                Fsk4DemodFF(lead_shape=(4,), device="cpu"), blocks,
                state_rtol=STATE_RTOL, state_atol=STATE_ATOL, key_tol=OUT_TOL)


@pytest.mark.parametrize("variant,block", [
    ("2K", 4000), ("1KFM", 8000), ("10KFM", 1600), ("96K", 400)])
def test_variants_match_jax(rng, variant, block):
    """Every 4FSK variant, two blocks of the shortest legal length (a
    multiple of M * n_sub * sps), on noisy IQ."""
    x = (rng.standard_normal((2, block))
         + 1j * rng.standard_normal((2, block))).astype(np.complex64) * 0.1
    stream_both(JaxFsk4(variant=variant),
                Fsk4DemodFF(variant=variant, device="cpu"),
                [(x[i].real.copy(), x[i].imag.copy()) for i in range(2)],
                state_rtol=STATE_RTOL, state_atol=STATE_ATOL, key_tol=OUT_TOL)
