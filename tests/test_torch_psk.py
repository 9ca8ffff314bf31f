"""The PSK chains of the port against the JAX package's on the CPU, and the
port's own loopbacks.

The demodulators (QPSK250K, QPSK20K, BPSK2K) are fed a modulator's IQ
with a 1 kHz carrier offset and seeded noise, the first samples at
~1e-20, as IqPair planes, in two blocks; the QPSK250K case is the frozen
capture tests/fixtures/iq_qpsk250k_10db.npz (scripts/make_qpsk_capture.py:
the JAX QpskMod(125_000), 1 kHz offset, AWGN at 10 dB from a fixed seed,
float16 IQ), which also pins the card to the CPU path in chip_smoke.py.
After each block the decoded bits must equal the JAX chain's; the
constellation within 5e-5 of its peak and rssi within 1e-5 dB
(the loops' bounds of tests/test_torch_sync_loops.py, carried through the
chain); every state leaf within 1e-4 of its peak (the Viterbi's path
metrics and pending soft pairs take the soft values' differences, x48).
The modulators' IQ is held to 1e-6 of its peak (XLA's cos/sin and the
interpolators' sums round apart from PyTorch's).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.chains import psk as jpsk  # noqa: E402
from qradiolink_tpu_torch.chains import psk  # noqa: E402
from qradiolink_tpu_torch.chains.channel import ChannelModel  # noqa: E402
from qradiolink_tpu_torch.chains.digital_common import (  # noqa: E402
    bytes_to_bits)
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from tests.test_chains_digital import best_ber  # noqa: E402
from tests.torch_parity import (assert_states_same, stream_both,  # noqa: E402
                                to_jax, to_torch)

FIX = pathlib.Path(__file__).parent / "fixtures" / "iq_qpsk250k_10db.npz"
CAPTURE_BLOCK = 40_000
OUT_TOL = {"bits": (0.0, 0.0), "bits_alt": (0.0, 0.0),
           "constellation": (5e-5, 0.0), "rssi": (0.0, 1e-5)}


def capture_blocks():
    """The capture as two (re, im) blocks of one channel, f32."""
    data = np.load(FIX)
    re = data["iq_re"].astype(np.float32)[None, :]
    im = data["iq_im"].astype(np.float32)[None, :]
    return [(re[:, i: i + CAPTURE_BLOCK].copy(),
             im[:, i: i + CAPTURE_BLOCK].copy())
            for i in range(0, re.shape[1], CAPTURE_BLOCK)]


def test_capture_shape():
    """Two blocks of 40,000 samples (a multiple of the head's 2), the
    1,250 payload bytes; under 1 MB on disk."""
    data = np.load(FIX)
    assert data["iq_re"].dtype == np.float16 == data["iq_im"].dtype
    assert data["iq_re"].shape == (2 * CAPTURE_BLOCK,) == data["iq_im"].shape
    assert data["payload"].shape == (1_250,)
    assert FIX.stat().st_size < 1_000_000


def tx_blocks(mod, n_bytes, C, T, seed):
    """The port's modulator's IQ (its own test holds it to the JAX one's)
    on seeded bytes, 1 kHz offset, noise at 0.05 a plane, the first 200
    samples at ~1e-20, as two (re, im) blocks of T."""
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (C, n_bytes)).astype(np.uint8)
    iq = mod(mod.init_state(), torch.from_numpy(data))[1]["iq"].numpy()
    iq = iq[:, :2 * T] * np.exp(2j * np.pi * 1e-3 * np.arange(2 * T))
    iq = iq + 0.05 * (rng.standard_normal(iq.shape)
                      + 1j * rng.standard_normal(iq.shape))
    iq = iq.astype(np.complex64)
    iq[:, :200] *= 1e-20
    return [(b.real.copy(), b.imag.copy()) for b in np.split(iq, 2, axis=-1)]


CHAINS = {
    "qpsk250k_capture": (lambda: jpsk.QpskDemod(125_000, 500_000,
                                                lead_shape=(1,)),
                         lambda: psk.QpskDemod(125_000, 500_000,
                                               lead_shape=(1,),
                                               device="cpu"),
                         None),
    "qpsk20k": (lambda: jpsk.QpskDemod(10_000, 40_000, lead_shape=(2,)),
                lambda: psk.QpskDemod(10_000, 40_000, lead_shape=(2,),
                                      device="cpu"),
                lambda: tx_blocks(psk.QpskMod(10_000, lead_shape=(2,),
                                              device="cpu"),
                                  250, 2, 20_000, 1)),
    "bpsk2k": (lambda: jpsk.BpskDemod(lead_shape=(2,)),
               lambda: psk.BpskDemod(lead_shape=(2,), device="cpu"),
               lambda: tx_blocks(psk.BpskMod(lead_shape=(2,), device="cpu"),
                                 25, 2, 20_000, 2)),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_demod_matches_jax(name):
    make_jax, make_torch, blocks = CHAINS[name]
    blocks = capture_blocks() if blocks is None else blocks()
    jd, td = make_jax(), make_torch()
    js, ts = jd.init_state(), td.init_state()
    bits = []
    for i, blk in enumerate(blocks):
        js, jy = jd(js, to_jax(blk))
        ts, ty = td(ts, to_torch(blk))
        assert set(jy) == set(ty)
        for k, (rtol, atol) in OUT_TOL.items():
            if k not in jy:
                continue
            a, b = np.asarray(jy[k]), ty[k].numpy()
            assert a.shape == b.shape and a.dtype == b.dtype, (i, k)
            err = float(np.abs(b - a).max()) if a.size else 0.0
            assert err <= atol + rtol * float(np.abs(a).max()), (i, k, err)
        assert_states_same(js, ts, rtol=1e-4, atol=0.0, peak=True)
        bits.append(ty["bits"].numpy())
    if name == "qpsk250k_capture":
        sent = bytes_to_bits(torch.from_numpy(np.load(FIX)["payload"]))
        ber = best_ber(np.concatenate(bits, axis=-1)[0], sent.numpy(),
                       max_offset=1000)
        assert ber < 0.01, ber


@pytest.mark.parametrize("name,n_bytes", [("qpsk250k", 250),
                                          ("bpsk2k", 5)])
def test_mod_matches_jax(rng, name, n_bytes):
    """Two blocks of bytes: IQ within 1e-6 of its peak, every state leaf
    (registers, interpolator tails, the differential phase) likewise."""
    if name == "qpsk250k":
        jm, tm = jpsk.QpskMod(125_000, lead_shape=(2,)), psk.QpskMod(
            125_000, lead_shape=(2,), device="cpu")
    else:
        jm, tm = jpsk.BpskMod(lead_shape=(2,)), psk.BpskMod(
            lead_shape=(2,), device="cpu")
    data = rng.integers(0, 256, (2, 2 * n_bytes)).astype(np.uint8)
    stream_both(jm, tm, np.split(data, 2, axis=-1), rtol=1e-6, atol=0.0,
                peak=True)


def _loopback(mod, dem, n_bytes, snr_db, seed, block):
    rng = np.random.default_rng(seed)
    data = torch.from_numpy(rng.integers(0, 256, (2, n_bytes)).astype(
        np.uint8))
    iq = mod(mod.init_state(), data)[1]["iq"]
    iq = ChannelModel(1_000_000, snr_db=snr_db, freq_offset_hz=500.0)(iq)
    m = iq.shape[-1] - iq.shape[-1] % block
    st, outs = dem.init_state(), []
    for i in range(0, m, block):
        st, out = dem(st, IqPair(iq.real[:, i:i + block].contiguous(),
                                 iq.imag[:, i:i + block].contiguous()))
        outs.append(out)
    sent = bytes_to_bits(data).numpy()
    return sent, {k: np.concatenate([o[k].numpy() for o in outs], axis=-1)
                  for k in ("bits", "bits_alt") if k in outs[0]}


def test_qpsk20k_loopback():
    """QpskMod -> 500 Hz offset, 15 dB -> QpskDemod, two channels, 625
    bytes in blocks of 50,000 samples: steady-state BER < 0.01."""
    sent, out = _loopback(psk.QpskMod(10_000, lead_shape=(2,), device="cpu"),
                          psk.QpskDemod(10_000, 40_000, lead_shape=(2,),
                                        device="cpu"),
                          625, 15.0, 3, 50_000)
    for c in range(2):
        assert best_ber(out["bits"][c], sent[c]) < 0.01


def test_bpsk2k_loopback():
    """BpskMod -> 500 Hz offset, 10 dB -> BpskDemod, two channels, 250
    bytes (1 s) in blocks of 200,000 samples: the better of bits and
    bits_alt at steady-state BER < 0.01."""
    sent, out = _loopback(psk.BpskMod(lead_shape=(2,), device="cpu"),
                          psk.BpskDemod(lead_shape=(2,), device="cpu"),
                          250, 10.0, 4, 200_000)
    for c in range(2):
        ber = min(best_ber(out["bits"][c], sent[c]),
                  best_ber(out["bits_alt"][c], sent[c]))
        assert ber < 0.01, ber


@pytest.mark.parametrize("name", ["qpsk_demod", "bpsk_demod", "qpsk_mod",
                                  "bpsk_mod"])
def test_state_trees_cross(name):
    """The JAX chain's initial state crosses into the port
    (state_from_numpy) and the port's back (state_to_numpy): the same
    leaves in the same depth-first order with the same dtypes and shapes,
    complex leaves complex; the port runs a block from the crossed
    state."""
    import jax

    from qradiolink_tpu_torch.core import state_from_numpy, state_to_numpy

    make = {"qpsk_demod": (lambda: jpsk.QpskDemod(lead_shape=(2,)),
                           lambda: psk.QpskDemod(lead_shape=(2,),
                                                 device="cpu")),
            "bpsk_demod": (lambda: jpsk.BpskDemod(lead_shape=(2,)),
                           lambda: psk.BpskDemod(lead_shape=(2,),
                                                 device="cpu")),
            "qpsk_mod": (lambda: jpsk.QpskMod(lead_shape=(2,)),
                         lambda: psk.QpskMod(lead_shape=(2,), device="cpu")),
            "bpsk_mod": (lambda: jpsk.BpskMod(lead_shape=(2,)),
                         lambda: psk.BpskMod(lead_shape=(2,), device="cpu"))}
    jc, tc = (f() for f in make[name])
    js = jax.tree_util.tree_map(np.asarray, jc.init_state())
    ts = state_from_numpy(js, "cpu")
    assert_states_same(js, ts, rtol=0.0, atol=0.0)
    back = state_to_numpy(tc.init_state())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(js))
    for a, b in zip(jax.tree_util.tree_leaves(js),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
    if name.endswith("_mod"):
        x = torch.zeros((2, 8), dtype=torch.uint8)
    else:
        x = IqPair(torch.zeros((2, 8_000)), torch.zeros((2, 8_000)))
    tc(ts, x)
