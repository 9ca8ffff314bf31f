"""The port's streaming Viterbi and digital TX/RX heads and tails against the
JAX package's on the CPU, bit for bit: StreamingViterbi, viterbi_decode,
depuncture, Scrambler, TxFecHead and RxFecTail; and a numpy model of the
kernel `viterbi_stream_k7` (csrc/viterbi_stream.cu) against its plain
loop.

Every comparison here is exact: bits, registers, path metrics and pending
soft pairs. The soft values are non-integer floats, so the branch metrics'
rounding order is exercised (each add rounded on its own, in the JAX
package's order).
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu.chains import digital_common as jdc  # noqa: E402
from qradiolink_tpu.fec import conv as jconv  # noqa: E402
from qradiolink_tpu.fec import scrambler as jscr  # noqa: E402
from qradiolink_tpu_torch.chains import digital_common as dc  # noqa: E402
from qradiolink_tpu_torch.fec import conv, scrambler  # noqa: E402
from qradiolink_tpu_torch.fec import viterbi_stream_cuda as vs  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.torch_parity import stream_both  # noqa: E402

SRC = (pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch"
       / "csrc" / "viterbi_stream.cu")


def noisy_soft(rng, lead, T, sigma=60.0):
    """Soft pairs of a CCSDS-coded random stream: 128 +/- 90 plus Gaussian
    noise, clipped to [0, 255], f32 (..., T, 2)."""
    bits = rng.integers(0, 2, lead + (T,)).astype(np.uint8)
    coded = np.asarray(jconv.conv_encode(jconv.CCSDS_K7, jnp.asarray(bits)))
    soft = 128.0 + 90.0 * (2.0 * coded - 1.0) + sigma * rng.standard_normal(
        coded.shape)
    return np.clip(soft, 0, 255).astype(np.float32).reshape(lead + (T, 2))


@pytest.mark.parametrize("lag,splits", [(64, (100, 130, 135)),
                                        (16, (40, 45)), (64, (30,))])
def test_streaming_viterbi_matches_jax(rng, lag, splits):
    """Blocks above, below and at the lag: bits, metrics and pending pairs
    equal after every block."""
    soft = noisy_soft(rng, (3,), 300)
    stream_both(jconv.StreamingViterbi(lag=lag, lead_shape=(3,)),
                conv.StreamingViterbi(lag=lag, lead_shape=(3,),
                                      device="cpu"),
                np.split(soft, splits, axis=1), rtol=0.0, atol=0.0)


def test_streaming_viterbi_is_blocking_invariant(rng):
    """One block of 300 pairs against three (100, 37, 163): the same bits
    and the same final state."""
    soft = torch.from_numpy(noisy_soft(rng, (2, 3), 300))
    sv = conv.StreamingViterbi(lead_shape=(2, 3), device="cpu")
    s1, b1 = sv(sv.init_state(), soft)
    st, parts = sv.init_state(), []
    for blk in torch.split(soft, [100, 37, 163], dim=-2):
        st, b = sv(st, blk)
        parts.append(b)
    assert torch.equal(b1, torch.cat(parts, dim=-1))
    assert all(torch.equal(a, b) for a, b in zip(s1, st))


def test_streaming_viterbi_decodes_clean_input(rng):
    """Noiseless soft pairs decode to the sent bits, delayed by the lag."""
    bits = rng.integers(0, 2, (2, 400)).astype(np.uint8)
    coded = conv.conv_encode(conv.CCSDS_K7, torch.from_numpy(bits))
    soft = (coded.float() * 255.0).reshape(2, 400, 2)
    sv = conv.StreamingViterbi(lead_shape=(2,), device="cpu")
    _, out = sv(sv.init_state(), soft)
    assert np.array_equal(out.numpy()[:, 64:], bits[:, :336])


@pytest.mark.parametrize("start", [False, True])
def test_viterbi_decode_matches_jax(rng, start):
    soft = noisy_soft(rng, (3,), 150)
    sm = None
    if start:
        sm = np.full(64, 1e4, np.float32)
        sm[0] = 0.0
    jb, jm = jconv.viterbi_decode(jconv.CCSDS_K7, jnp.asarray(soft),
                                  None if sm is None else jnp.asarray(sm))
    tb, tm = conv.viterbi_decode(conv.CCSDS_K7, torch.from_numpy(soft),
                                 None if sm is None else torch.from_numpy(sm))
    assert np.array_equal(np.asarray(jb), tb.numpy())
    assert np.array_equal(np.asarray(jm), tm.numpy())


@pytest.mark.parametrize("pattern", [[1, 1, 0, 1], [1, 0, 1, 1, 1, 0]])
def test_depuncture_matches_jax(rng, pattern):
    kept = sum(pattern)
    soft = rng.uniform(0, 255, (2, 5 * kept)).astype(np.float32)
    a = np.asarray(jconv.depuncture(jnp.asarray(soft), pattern))
    b = conv.depuncture(torch.from_numpy(soft), pattern).numpy()
    assert a.shape == b.shape and np.array_equal(a, b)
    with pytest.raises(ValueError):
        conv.depuncture(torch.zeros(2, kept + 1), pattern)


@pytest.mark.parametrize("sizes", [(1, 5, 7, 8), (100, 1000), (3000,)])
def test_scrambler_matches_jax(rng, sizes):
    """The port's shifted-XOR form against the JAX per-bit scan: outputs
    and registers over blocks of every length from 1 up."""
    bits = rng.integers(0, 2, (3, sum(sizes))).astype(np.uint8)
    stream_both(jscr.Scrambler(lead_shape=(3,)),
                scrambler.Scrambler(lead_shape=(3,), device="cpu"),
                np.split(bits, np.cumsum(sizes)[:-1], axis=-1))


def test_scrambler_round_trip(rng):
    bits = torch.from_numpy(rng.integers(0, 2, (2, 500)).astype(np.uint8))
    s = scrambler.Scrambler(lead_shape=(2,), device="cpu")
    d = scrambler.Descrambler(lead_shape=(2,), device="cpu")
    _, y = s(s.init_state(), bits)
    _, back = d(d.init_state(), y)
    assert torch.equal(back, bits)


def test_tx_fec_head_matches_jax(rng):
    bits = rng.integers(0, 2, (2, 3, 200)).astype(np.uint8)
    stream_both(jdc.TxFecHead(lead_shape=(2, 3)),
                dc.TxFecHead(lead_shape=(2, 3), device="cpu"),
                np.split(bits, [50, 57], axis=-1))


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_rx_fec_tail_matches_jax(rng, lead):
    """lead (2, C) is the BPSK chain's delay-diversity pair."""
    soft = noisy_soft(rng, lead, 250).reshape(lead + (500,))
    stream_both(jdc.RxFecTail(lead_shape=lead),
                dc.RxFecTail(lead_shape=lead, device="cpu"),
                np.split(soft, [200], axis=-1), rtol=0.0, atol=0.0)


def test_tx_head_to_rx_tail(rng):
    """TxFecHead -> hard soft values -> RxFecTail gives the bits back,
    delayed by the lag."""
    bits = torch.from_numpy(rng.integers(0, 2, (2, 600)).astype(np.uint8))
    tx = dc.TxFecHead(lead_shape=(2,), device="cpu")
    rx = dc.RxFecTail(lead_shape=(2,), device="cpu")
    _, coded = tx(tx.init_state(), bits)
    _, out = rx(rx.init_state(), coded.float() * 255.0)
    # the descrambler resynchronizes within its depth after the lag
    assert torch.equal(out[:, 64 + 7:], bits[:, 7:600 - 64])


def test_viterbi_stream_records_and_checks(rng):
    soft = torch.from_numpy(noisy_soft(rng, (3,), 20))
    pm = torch.zeros(3, 64)
    kernel_paths.reset()
    vs.viterbi_stream(conv.CCSDS_K7, pm, torch.full((3, 64, 2), 128.0),
                      soft)
    assert kernel_paths.report()[vs.OP]["shapes"] == {
        "plain R3 T20 lag64": 1}
    with pytest.raises(ValueError):
        vs.viterbi_stream(conv.CCSDS_K7, pm[:2], torch.zeros(3, 4, 2), soft)


# -- a numpy model of the kernel ----------------------------------------------

WARP, CHUNK = 32, 32
F = np.float32


def viterbi_stream_model(tail, soft, pm0, polys=(109, 79)):
    """viterbi_stream_k7 in numpy, one row (a warp) at a time: lane l owns
    states 2l, 2l+1 and takes pm[l], pm[l+32] from the lanes holding them;
    the four pattern metrics of each step; cand, the compare and the select
    of each of the lane's states; the minimum over the 64 states; the
    decisions as one 64-bit word a step (even states in the low half); the
    soft pairs and the words in chunks of CHUNK steps; the end state the
    lowest-index minimum; the traceback a chunk at a time from the end.
    f32 arithmetic, each operation rounded on its own."""
    B, lag, _ = tail.shape
    T = soft.shape[1]
    S = lag + T
    lanes = np.arange(WARP)

    def parity(v):
        return np.array([bin(int(u)).count("1") & 1 for u in v])

    pat = np.zeros((2, 2, WARP), np.int64)  # [state 2l + j][hi][lane]
    for j in range(2):
        for hi in range(2):
            w = ((lanes | (hi << 5)) << 1) | j
            pat[j, hi] = 2 * parity(w & polys[0]) + parity(w & polys[1])
    pm1 = np.zeros((B, 64), F)
    bits = np.full((B, T), 255, np.uint8)
    for b in range(B):
        pmA, pmB = pm0[b, 0::2].copy(), pm0[b, 1::2].copy()
        if T == 0:
            pm1[b] = pm0[b]
        words = np.zeros(S, np.uint64)
        for t0 in range(0, S, CHUNK):
            for j in range(min(CHUNK, S - t0)):
                t = t0 + j
                s0, s1 = (tail[b, t] if t < lag else soft[b, t - lag])
                f0, f1 = F(F(255) - s0), F(F(255) - s1)
                bm = np.array([F(s0 + s1), F(s0 + f1), F(f0 + s1),
                               F(f0 + f1)], F)
                a0, a1 = pmA[lanes >> 1], pmB[lanes >> 1]
                b0, b1 = pmA[16 + (lanes >> 1)], pmB[16 + (lanes >> 1)]
                pLo = np.where(lanes & 1, a1, a0)
                pHi = np.where(lanes & 1, b1, b0)
                cA0, cA1 = (pLo + bm[pat[0, 0]]).astype(F), (
                    pHi + bm[pat[0, 1]]).astype(F)
                cB0, cB1 = (pLo + bm[pat[1, 0]]).astype(F), (
                    pHi + bm[pat[1, 1]]).astype(F)
                dA, dB = cA1 < cA0, cB1 < cB0
                nA, nB = np.where(dA, cA1, cA0), np.where(dB, cB1, cB0)
                m = min(nA.min(), nB.min())
                pmA, pmB = (nA - m).astype(F), (nB - m).astype(F)
                lo = int(np.sum(dA.astype(np.uint64) << lanes.astype(
                    np.uint64)))
                hi = int(np.sum(dB.astype(np.uint64) << lanes.astype(
                    np.uint64)))
                words[t] = np.uint64((hi << 32) | lo)
                if t == T - 1:
                    pm1[b, 0::2], pm1[b, 1::2] = pmA, pmB
        full = np.empty(64, F)
        full[0::2], full[1::2] = pmA, pmB
        s = int(np.flatnonzero(full == full.min())[0])
        t_hi = S
        while t_hi > 0:
            t0 = max(0, t_hi - CHUNK)
            for t in range(t_hi - 1, t0 - 1, -1):
                if t < T:
                    assert bits[b, t] == 255
                    bits[b, t] = s & 1
                w = int(words[t])
                half = (w >> 32) if s & 1 else (w & 0xffffffff)
                s = (s >> 1) | (((half >> (s >> 1)) & 1) << 5)
            t_hi = t0
    return pm1, bits


# (B, T, lag): ragged chunks, a block shorter than the lag, lag 0
# (viterbi_decode's form), one pair
MODEL_CASES = [(2, 70, 64), (1, 30, 64), (2, 45, 0), (1, 1, 64)]


@pytest.mark.parametrize("B,T,lag", MODEL_CASES)
def test_viterbi_stream_model_matches_plain(rng, B, T, lag):
    """The kernel's lanes, ballots, chunks and traceback give the plain
    loop's bits and metrics bit for bit, over two chained blocks."""
    soft = noisy_soft(rng, (B,), 2 * T)
    pm = np.zeros((B, 64), F)
    tail = np.full((B, lag, 2), 128.0, F)
    for blk in range(2):
        sb = np.ascontiguousarray(soft[:, blk * T:(blk + 1) * T])
        want_pm, want_bits = vs.viterbi_stream_plain(
            conv.CCSDS_K7, torch.from_numpy(pm), torch.from_numpy(tail),
            torch.from_numpy(sb))
        got_pm, got_bits = viterbi_stream_model(tail, sb, pm)
        np.testing.assert_array_equal(got_pm, want_pm.numpy())
        np.testing.assert_array_equal(got_bits, want_bits.numpy())
        pm = got_pm
        tail = np.concatenate([tail, sb], axis=1)[:, T:]


def test_viterbi_model_follows_the_source():
    src = SRC.read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == CHUNK
    assert "__reduce_min_sync" in src and "__fadd_rn" in src
    assert "(lane | (hi << 5)) << 1) | j" in src
