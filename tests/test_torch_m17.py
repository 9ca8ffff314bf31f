"""The M17 chains of the port against the JAX package's on the CPU, and the
port's own M17 loopback.

The demodulators (M17Demod, M17DemodFF) are fed the port's M17Mod IQ on
seeded random bits (its own test holds it to the JAX one's) with noise at
0.05 a plane, as IqPair planes: 2 rows, two blocks of 25,000 samples.
After each block every output and state leaf is compared. The JAX RRC
(K251) runs as an FFT on the CPU (impl="auto"), the port's in direct
form, so each chain is compared twice:

  * "direct": the JAX chain's RRC swapped for its direct form
    (impl="conv"), the first 200 samples at ~1e-20 (the quadrature
    demod's denormal flush): every bit equal;
  * "fft": the JAX chain as it is, on the same IQ without the ~1e-20
    start (there the FFT leaves noise of ~1e-7 where the direct form
    gives exact zeros, which flips the M&M loop's decisions on the silent
    symbols, 0 being halfway between two levels): bits equal wherever the
    JAX decision is not within the symbol bound of its threshold (0, or
    the magnitude 1).

Bounds, from the measured differences with a margin of about 3: symbols
and constellation within 5e-6 of the symbols' peak (measured 1.3e-6),
rssi within 1e-5 dB, every state leaf within 5e-6 of its peak (measured
1.0e-6; the FF accumulator's 1.9e-5 of a peak of 36).

The modulator's IQ and every state leaf within 2e-4 (measured 8.6e-5):
FrequencyMod's phase is a cumulative sum over the block's 24,000 samples,
summed in another order, and f32's spacing at a phase of 1,000 rad is
6e-5; XLA's cos/sin and the interpolators' sums round apart from
PyTorch's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.chains import m17 as jm17  # noqa: E402
from qradiolink_tpu.ops.fir import FirFilter as JaxFir  # noqa: E402
from qradiolink_tpu_torch.chains import m17  # noqa: E402
from qradiolink_tpu_torch.chains.channel import ChannelModel  # noqa: E402
from qradiolink_tpu_torch.framing.layer1 import (Deframer,  # noqa: E402
                                                 FrameType)
from qradiolink_tpu_torch.protocols.m17 import (FrameDecoder,  # noqa: E402
                                                FrameEncoder,
                                                LinkSetupFrame)
from tests.torch_parity import (assert_same, assert_states_same,  # noqa: E402
                                stream_both, to_jax, to_numpy, to_torch)

SYM_TOL = 5e-6       # relative to the block's peak
RSSI_TOL = 1e-5      # dB
BLOCK = 25_000       # samples: a multiple of 625 (M&M) and 2,500 (FF)
TX_TOL = 2e-4


def rx_blocks(mod, C, T, seed, tiny):
    """The port's modulator's IQ on seeded bits, noise at 0.05 a plane, the
    first `tiny` samples at ~1e-20, as two (re, im) blocks of T."""
    rng = np.random.default_rng(seed)
    # n symbols give 625 n / 3 IQ samples (x5, then 125/3)
    n_sym = 3 * -(-2 * T // 625)
    bits = rng.integers(0, 2, (C, 2 * n_sym)).astype(np.uint8)
    iq = mod(mod.init_state(), torch.from_numpy(bits))[1]["iq"].numpy()
    iq = iq[:, :2 * T] + 0.05 * (rng.standard_normal((C, 2 * T))
                                 + 1j * rng.standard_normal((C, 2 * T)))
    iq = iq.astype(np.complex64)
    iq[:, :tiny] *= 1e-20
    return [(b.real.copy(), b.imag.copy()) for b in np.split(iq, 2, axis=-1)]


def direct_rrc(chain):
    """The JAX chain with its RRC in direct form, not the CPU's FFT."""
    chain.shaping = JaxFir(np.asarray(chain.shaping.taps), impl="conv",
                           lead_shape=chain.shaping.lead_shape)
    return chain


def compare_demod(jd, td, blocks, mag, exact_bits, tol=SYM_TOL):
    """Stream `blocks` through both chains; compare after each block (see
    the module docstring; `tol` is the symbol bound, relative to the
    symbols' peak). Returns the number of bits whose JAX decision was
    within the bound of its threshold."""
    js, ts = jd.init_state(), td.init_state()
    assert_states_same(js, ts)
    near = 0
    for i, blk in enumerate(blocks):
        js, jy = jd(js, to_jax(blk))
        ts, ty = td(ts, to_torch(blk))
        assert set(jy) == set(ty)
        sj = to_numpy(jy["symbols"])
        peak = float(np.abs(sj).max())
        for k in ("symbols", "constellation", "soft"):
            if k in jy:
                assert_same(jy[k], ty[k], 0.0, tol * max(peak, 1.0),
                            what=f"block {i} {k}")
        assert_same(jy["rssi"], ty["rssi"], 0.0, RSSI_TOL,
                    what=f"block {i} rssi")
        assert_states_same(js, ts, rtol=tol, atol=0.0, peak=True)
        bj, bt = to_numpy(jy["bits"]), to_numpy(ty["bits"])
        assert bj.shape == bt.shape and bt.dtype == np.uint8
        lim = tol * peak
        clear = np.repeat((np.abs(sj) > lim)
                          & (np.abs(np.abs(sj) - mag) > lim), 2, axis=-1)
        if exact_bits:
            np.testing.assert_array_equal(bt, bj, err_msg=f"block {i}")
        else:
            np.testing.assert_array_equal(bt[clear], bj[clear],
                                          err_msg=f"block {i}")
        near += int((~clear).sum())
    return near


CHAINS = {"m17": (jm17.M17Demod, m17.M17Demod),
          "m17_ff": (jm17.M17DemodFF, m17.M17DemodFF)}


@pytest.fixture(scope="module")
def m17_blocks():
    mod = m17.M17Mod(lead_shape=(2,), device="cpu")
    return {"direct": rx_blocks(mod, 2, BLOCK, 5, 200),
            "fft": rx_blocks(mod, 2, BLOCK, 5, 0)}


@pytest.mark.parametrize("rrc", ["fft", "direct"])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_demod_matches_jax(m17_blocks, name, rrc):
    make_jax, make_torch = CHAINS[name]
    jd = make_jax(lead_shape=(2,))
    if rrc == "direct":
        jd = direct_rrc(jd)
    near = compare_demod(jd, make_torch(lead_shape=(2,), device="cpu"),
                         m17_blocks[rrc], 1.0, exact_bits=rrc == "direct")
    # within the bound of a threshold: the loop's first symbols, read from
    # its zero initial tail, and the ~1e-20 start's (2 bits a symbol)
    assert near <= 32, near


@pytest.mark.parametrize("pair", [False, True])
def test_mod_matches_jax(rng, pair):
    """Two blocks of 9,600 bits a row (24,000 samples at 24 ksps, a
    multiple of the 125/3 interpolator's 3): IQ and every state leaf
    within 2e-4."""
    bits = rng.integers(0, 2, (2, 2 * 9_600)).astype(np.uint8)
    stream_both(jm17.M17Mod(lead_shape=(2,), pair=pair),
                m17.M17Mod(lead_shape=(2,), pair=pair, device="cpu"),
                np.split(bits, 2, axis=-1), rtol=0.0, atol=TX_TOL)


def test_m17_loopback_10db():
    """M17Mod -> ChannelModel at 10 dB -> M17Demod -> Deframer("M17") ->
    FrameDecoder on the port alone, as tests/test_m17.py's end-to-end
    test: the LSF (directly or by late entry from the LICH chunks) and at
    least 5 of 6 stream payloads."""
    lsf = LinkSetupFrame.for_stream("SP5WWP", "AB1CDE", can=3)
    enc = FrameEncoder(lsf)
    frames = [enc.encode_preamble(), enc.encode_preamble(), enc.encode_lsf()]
    payloads = [bytes([17 * i % 251] * 16) for i in range(6)]
    for i, p in enumerate(payloads):
        frames.append(enc.encode_stream(p, last=(i == 5)))
    bits = np.concatenate(frames + [np.zeros(2000, np.uint8)])
    bits = np.concatenate([bits, np.zeros((-len(bits)) % 48, np.uint8)])
    mod, dem = m17.M17Mod(device="cpu"), m17.M17Demod(device="cpu")
    iq = mod(mod.init_state(), torch.from_numpy(bits))[1]["iq"]
    iq = iq[: iq.shape[-1] - iq.shape[-1] % 625]
    rx = ChannelModel(1_000_000, snr_db=10.0, seed=11)(iq)
    out = dem(dem.init_state(), rx)[1]
    dec, got_lsf, ok = FrameDecoder(), None, 0
    for ftype, fb in Deframer("M17").process(out["bits"].numpy()):
        fbits = np.unpackbits(np.frombuffer(fb, np.uint8))
        if ftype == FrameType.M17_LSF:
            got_lsf = dec.decode_lsf(fbits)
        elif ftype == FrameType.M17_STREAM:
            ok += dec.decode_stream(fbits).payload in payloads
    if got_lsf is None and dec.lsf_valid:
        got_lsf = dec.lsf
    assert ok >= 5, f"only {ok}/6 payloads at 10 dB"
    assert got_lsf is not None and got_lsf.source == "SP5WWP"
    assert got_lsf.destination == "AB1CDE"
