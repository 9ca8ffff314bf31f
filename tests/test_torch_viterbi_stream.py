"""The port's streaming Viterbi and digital TX/RX heads and tails against the
JAX package's on the CPU, bit for bit: StreamingViterbi, viterbi_decode,
depuncture, Scrambler, TxFecHead and RxFecTail; and numpy models of the
kernels `viterbi_stream_k7` (csrc/viterbi_stream.cu),
`viterbi_stream_redux_k7` (csrc/viterbi_stream_redux.cu) and
`viterbi_stream_warp_k7` (csrc/viterbi_stream_warp.cu) against their plain
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
from tests.test_torch_fec import (  # noqa: E402
    _insert0, _slot_natural, bfly_schedule)
from tests.torch_parity import stream_both  # noqa: E402

CSRC = pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch" \
    / "csrc"
SRC = CSRC / "viterbi_stream.cu"
WARP_SRC = CSRC / "viterbi_stream_warp.cu"
REDUX_SRC = CSRC / "viterbi_stream_redux.cu"


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


def test_viterbi_stream_routes_by_code(rng):
    """The CCSDS code goes to viterbi_stream_k7, another K=7 code to
    viterbi_stream_warp_k7, on the CPU too (the plain version recorded
    under the routed name); both equal the plain version there."""
    other = conv.ConvCode(7, OTHER_POLYS)
    assert vs.route(conv.CCSDS_K7) == vs.OP
    assert vs.route(other) == vs.OP_WARP
    soft = torch.from_numpy(noisy_soft(rng, (2,), 30))
    pm, tail = torch.zeros(2, 64), torch.full((2, 64, 2), 128.0)
    kernel_paths.reset()
    got = vs.viterbi_stream(other, pm, tail, soft)
    want = vs.viterbi_stream_plain(other, pm, tail, soft)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kernel_paths.report()[vs.OP_WARP]["shapes"] == {
        "plain R2 T30 lag64": 1}


# -- numpy models of the kernels ----------------------------------------------

WARP, CHUNK = 32, 32
F = np.float32
# a second K=7 code: NASA's (171, 133) octal
OTHER_POLYS = (121, 91)


def viterbi_stream_warp_model(tail, soft, pm0, polys=(109, 79)):
    """viterbi_stream_warp_k7 in numpy, one row (a warp) at a time: lane l owns
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


# the new kernel's layout: lanes a row, metrics a lane, lane slots, the
# schedule's period, steps a chunk
G8, NR8, LB8, PERIOD, CHUNK60 = 8, 8, 3, 15, 60


def _parity_bits(v):
    v = np.asarray(v, np.int64)
    out = np.zeros_like(v)
    for k in range(8):
        out ^= (v >> k) & 1
    return out


def viterbi_stream_model(tail, soft, pm0, polys=(109, 79)):
    """viterbi_stream_k7 in numpy, all rows at once, line for line: G8
    lanes a row, 8 metrics a lane in slot order (viterbi_bfly_k7's schedule,
    bfly_schedule(8)), the metrics of pm0 placed by the period's last row;
    each step the four pattern metrics, permuted by the lane's share of the
    hi = 0 pattern (linear in the state's bits: natural bit k adds
    contrib[k]), the schedule's exchange (partner lane ^ (1 << slot)), the
    register pairs' add-compare-select with the hi = 1 pattern that xor
    contrib[6], the decision byte (bit r for register r) into the chunk's
    buffer, the minimum as each lane's tree of 8 then the row's
    xor-shuffle, the subtraction, pm1 after step T - 1 in natural order;
    each chunk's
    decision words flushed to the scratch (S rounded up to CHUNK60 steps a
    row, byte g for lane g); the end state the lowest natural index among
    the minima (per lane, then the xor-tree); the traceback by one lane a
    row in slot coordinates from the scratch: the bit at the step's
    register slot m, m replaced by the decision bit, the exchange's two
    index bits swapped back. f32 arithmetic, each operation rounded on its
    own."""
    B, lag, _ = tail.shape
    T = soft.shape[1]
    S = lag + T
    x = np.concatenate([tail, soft], axis=1).astype(F)
    sched = bfly_schedule(G8)
    assert len(sched) == PERIOD
    contrib = [2 * ((polys[0] >> k) & 1) + ((polys[1] >> k) & 1)
               for k in range(7)]
    D = contrib[6]
    nat = [_slot_natural(row, G8) for row in sched]          # (G8, NR8)
    lanes = np.arange(G8)
    regs = np.arange(NR8)
    lane_pat, reg_pat = [], []
    for ph, row in enumerate(sched):
        lp = np.zeros(G8, np.int64)
        rp = np.zeros(NR8, np.int64)
        for i in range(LB8):
            lp ^= ((lanes >> i) & 1) * contrib[row[2 + i]]
            rp ^= ((regs >> i) & 1) * contrib[row[2 + LB8 + i]]
        # the pattern is linear: the lane's share xor the register's
        p0 = (2 * _parity_bits(nat[ph] & polys[0])
              + _parity_bits(nat[ph] & polys[1]))
        assert np.array_equal(lp[:, None] ^ rp[None, :], p0)
        lane_pat.append(lp)
        reg_pat.append(rp)
    rows = np.arange(B)
    pm = pm0[:, nat[PERIOD - 1]].astype(F)                   # (B, G8, NR8)
    pm1 = pm0.copy() if T == 0 else np.full((B, 64), np.nan, F)
    s_pad = -(-S // CHUNK60) * CHUNK60
    scratch = np.full((B, s_pad, G8), 0xAA, np.uint8)
    s_dec = np.zeros((B, CHUNK60, G8), np.uint8)
    for t in range(S):
        ph = t % PERIOD
        sj, si = sched[ph][:2]
        s0, s1 = x[:, t, 0], x[:, t, 1]
        f0, f1 = F(255) - s0, F(255) - s1
        # X[p] = bm[p ^ l]: each term chosen by a bit of the lane's share
        l0 = (lane_pat[ph] & 1).astype(bool)[None, :]
        l1 = (lane_pat[ph] >> 1).astype(bool)[None, :]
        a0 = np.where(l1, f0[:, None], s0[:, None])
        a1 = np.where(l1, s0[:, None], f0[:, None])
        b0 = np.where(l0, f1[:, None], s1[:, None])
        b1 = np.where(l0, s1[:, None], f1[:, None])
        X = np.stack([a0 + b0, a0 + b1, a1 + b0, a1 + b1], -1).astype(F)
        bm = np.stack([s0 + s1, s0 + f1, f0 + s1, f0 + f1], -1).astype(F)
        assert np.array_equal(
            X, bm[:, np.arange(4)[None, :] ^ lane_pat[ph][:, None]])
        if sj >= 0:
            y = ((lanes >> sj) & 1).astype(bool)
            for b in range(NR8 // 2):
                r0 = _insert0(b, si)
                r1 = r0 | (1 << si)
                send = np.where(y, pm[:, :, r0], pm[:, :, r1])
                recv = send[:, lanes ^ (1 << sj)]
                pm[:, :, r0] = np.where(y, recv, pm[:, :, r0])
                pm[:, :, r1] = np.where(y, pm[:, :, r1], recv)
        m = sched[ph][2 + LB8:].index(0)
        d = np.zeros((B, G8), np.int64)
        for b in range(NR8 // 2):
            r0 = _insert0(b, m)
            r1 = r0 | (1 << m)
            lo, hi = pm[:, :, r0].copy(), pm[:, :, r1].copy()
            for r in (r0, r1):
                p = reg_pat[ph][r]
                c0 = (lo + X[:, :, p]).astype(F)
                c1 = (hi + X[:, :, p ^ D]).astype(F)
                dec = c1 < c0
                pm[:, :, r] = np.where(dec, c1, c0)
                d |= dec.astype(np.int64) << r
        s_dec[:, t % CHUNK60] = d
        mn = np.minimum(np.minimum(np.minimum(pm[..., 0], pm[..., 1]),
                                   np.minimum(pm[..., 2], pm[..., 3])),
                        np.minimum(np.minimum(pm[..., 4], pm[..., 5]),
                                   np.minimum(pm[..., 6], pm[..., 7])))
        for off in (1, 2, 4):
            mn = np.minimum(mn, mn[:, lanes ^ off])
        pm = (pm - mn[:, :, None]).astype(F)
        if t == T - 1:
            pm1[:, nat[ph].reshape(-1)] = pm.reshape(B, -1)
        if t % CHUNK60 == CHUNK60 - 1 or t == S - 1:
            t0 = t - t % CHUNK60
            scratch[:, t0:t + 1] = s_dec[:, :t - t0 + 1]
    # the end state
    nat_e = nat[(S - 1) % PERIOD]
    best = pm[:, :, 0].copy()
    s_end = np.broadcast_to(nat_e[:, 0], (B, G8)).copy()
    for r in range(1, NR8):
        take = (pm[:, :, r] < best) | ((pm[:, :, r] == best)
                                       & (nat_e[:, r] < s_end))
        best = np.where(take, pm[:, :, r], best)
        s_end = np.where(take, nat_e[:, r], s_end)
    for off in (1, 2, 4):
        ob, os_ = best[:, lanes ^ off], s_end[:, lanes ^ off]
        take = (ob < best) | ((ob == best) & (os_ < s_end))
        best, s_end = np.where(take, ob, best), np.where(take, os_, s_end)
    s = s_end[:, 0]
    idx = np.argsort(nat_e.reshape(-1))[s]        # natural -> g << 3 | r
    bits = np.full((B, T), 255, np.uint8)
    for t in range(S - 1, -1, -1):
        ph = t % PERIOD
        sj, si = sched[ph][:2]
        m = sched[ph][2 + LB8:].index(0)
        # the slot index names the state the natural tables name
        assert np.array_equal(nat[ph].reshape(-1)[idx], s)
        if t < T:
            assert (bits[:, t] == 255).all()
            bits[:, t] = (idx >> m) & 1
        d = (scratch[rows, t, idx >> 3].astype(np.int64) >> (idx & 7)) & 1
        s = (s >> 1) | (d << 5)
        if sj >= 0:
            # the exchange put bit 5 in register slot si = m: the decision
            # goes to the lane slot's index bit a, that bit to m
            assert si == m
            a = LB8 + sj
            rest = (idx & ~((1 << m) | (1 << a))) | (((idx >> a) & 1) << m)
            idx = rest | (d << a)
        else:
            idx = (idx & ~(1 << m)) | (d << m)
    return pm1, bits


def viterbi_stream_redux_model(tail, soft, pm0, polys=(109, 79)):
    """viterbi_stream_redux_k7 in numpy, all rows at once, line for line:
    lane l
    holds states 2l (A) and 2l + 1 (B) and takes pm[l] and pm[l + 32] from
    lanes l >> 1 and 16 + (l >> 1), A or B by l's parity; the four pattern
    metrics and, by the lane's selects, u = bm[p] and w = bm[p ^ 3] for
    state 2l's pattern p (state 2l + 1's are w and u); the candidates,
    decisions and new metrics; the step's minimum from the two class
    minima the step before left (class of state j: the parity of j under
    the mask where the polynomials differ, shifted by one; state 2l's is
    bit 3 of l), less that step's minimum, plus each class's least pattern
    metric, asserted equal to the minimum over the 64 new metrics; the new
    metrics' class minima (each lane's A and B by its class, then the
    warp's minimum); the subtraction; the step's decisions as one word
    (bit l: state 2l, bit 32 + l: state 2l + 1) into the chunk's buffer,
    flushed to the scratch after each chunk of 32 steps; pm1 after step
    T - 1; the end state the lowest index among the minima; the traceback
    a chunk of words at a time from the scratch. f32 arithmetic, each
    operation rounded on its own."""
    B, lag, _ = tail.shape
    T = soft.shape[1]
    S = lag + T
    x = np.concatenate([tail, soft], axis=1).astype(F)
    contrib = [2 * ((polys[0] >> k) & 1) + ((polys[1] >> k) & 1)
               for k in range(7)]
    assert contrib[0] == 3 and contrib[6] == 3
    cls_mask = ((polys[0] ^ polys[1]) >> 1) & 31
    lanes = np.arange(WARP)
    states = np.arange(64)
    cls = _parity_bits(states & cls_mask)
    lc = (lanes >> 3) & 1
    assert np.array_equal(cls[2 * lanes], lc) and cls_mask == 17
    sA = 2 * lanes
    e0 = _parity_bits(sA & polys[0])
    e1 = _parity_bits(sA & polys[1])
    par = (e0 != e1)
    src_lo, src_hi, odd = lanes >> 1, 16 + (lanes >> 1), (lanes & 1) == 1

    def class_minima(a, b):
        c0 = np.where(lc == 1, b, a)
        c1 = np.where(lc == 1, a, b)
        return c0.min(axis=1), c1.min(axis=1)

    pmA, pmB = pm0[:, 0::2].astype(F), pm0[:, 1::2].astype(F)
    pm1 = pm0.copy() if T == 0 else np.full((B, 64), np.nan, F)
    n0, n1 = class_minima(pmA, pmB)
    m_prev = np.zeros(B, F)
    scratch = np.full((B, S), 0xAAAAAAAAAAAAAAAA, np.uint64)
    s_w = np.zeros((B, CHUNK), np.uint64)
    for t in range(S):
        s0, s1 = x[:, t, 0], x[:, t, 1]
        f0, f1 = F(255) - s0, F(255) - s1
        bm0, bm1 = (s0 + s1).astype(F), (s0 + f1).astype(F)
        bm2, bm3 = (f0 + s1).astype(F), (f0 + f1).astype(F)
        m = np.minimum(((n0 - m_prev).astype(F)
                        + np.minimum(bm0, bm3)).astype(F),
                       ((n1 - m_prev).astype(F)
                        + np.minimum(bm1, bm2)).astype(F))
        P = np.where(par[None, :], bm1[:, None], bm0[:, None])
        Q = np.where(par[None, :], bm2[:, None], bm3[:, None])
        u = np.where(e0[None, :] == 1, Q, P)
        w = np.where(e0[None, :] == 1, P, Q)
        p_lo = np.where(odd, pmB[:, src_lo], pmA[:, src_lo])
        p_hi = np.where(odd, pmB[:, src_hi], pmA[:, src_hi])
        cA0, cA1 = (p_lo + u).astype(F), (p_hi + w).astype(F)
        cB0, cB1 = (p_lo + w).astype(F), (p_hi + u).astype(F)
        dA, dB = cA1 < cA0, cB1 < cB0
        nA, nB = np.where(dA, cA1, cA0), np.where(dB, cB1, cB0)
        np.testing.assert_array_equal(
            m, np.minimum(nA.min(axis=1), nB.min(axis=1)))
        n0, n1 = class_minima(nA, nB)
        m_prev = m
        pmA, pmB = (nA - m[:, None]).astype(F), (nB - m[:, None]).astype(F)
        lo = (dA.astype(np.uint64) << lanes.astype(np.uint64)).sum(axis=1)
        hi = (dB.astype(np.uint64) << lanes.astype(np.uint64)).sum(axis=1)
        s_w[:, t % CHUNK] = (hi << np.uint64(32)) | lo
        if t == T - 1:
            pm1[:, 0::2], pm1[:, 1::2] = pmA, pmB
        if t % CHUNK == CHUNK - 1 or t == S - 1:
            t0 = t - t % CHUNK
            scratch[:, t0:t + 1] = s_w[:, :t - t0 + 1]
    full = np.empty((B, 64), F)
    full[:, 0::2], full[:, 1::2] = pmA, pmB
    s = np.argmin(full, axis=1)       # the lowest index among the minima
    rows = np.arange(B)
    bits = np.full((B, T), 255, np.uint8)
    for t in range(S - 1, -1, -1):
        if t < T:
            assert (bits[:, t] == 255).all()
            bits[:, t] = s & 1
        word = scratch[rows, t].astype(np.uint64)
        half = np.where(s & 1, word >> np.uint64(32),
                        word & np.uint64(0xFFFFFFFF))
        d = ((half >> (s >> 1).astype(np.uint64)) & np.uint64(1)).astype(
            np.int64)
        s = (s >> 1) | (d << 5)
    return pm1, bits


# (B, T, lag): ragged chunks and periods, a block shorter than the lag, lag
# 0 (viterbi_decode's form), one pair, no pair (T = 0), rows that do not
# fill a warp
MODEL_CASES = [(2, 70, 64), (1, 30, 64), (2, 45, 0), (1, 1, 64),
               (2, 0, 64), (5, 131, 64)]


def _model_blocks(rng, model, B, T, lag, polys, kind):
    """Two chained blocks through the model and the plain version: bits and
    metrics equal bit for bit."""
    code = conv.ConvCode(7, polys)
    if kind == "noisy":
        soft = noisy_soft(rng, (B,), 2 * T)
    else:  # integer soft values: many ties
        soft = rng.integers(0, 256, (B, 2 * T, 2)).astype(F)
    pm = np.zeros((B, 64), F)
    tail = np.full((B, lag, 2), 128.0, F)
    for blk in range(2):
        sb = np.ascontiguousarray(soft[:, blk * T:(blk + 1) * T])
        want_pm, want_bits = vs.viterbi_stream_plain(
            code, torch.from_numpy(pm), torch.from_numpy(tail),
            torch.from_numpy(sb))
        got_pm, got_bits = model(tail, sb, pm, polys)
        np.testing.assert_array_equal(got_pm, want_pm.numpy())
        np.testing.assert_array_equal(got_bits, want_bits.numpy())
        pm = got_pm
        tail = np.concatenate([tail, sb], axis=1)[:, T:]


@pytest.mark.parametrize("kind", ["noisy", "integer"])
@pytest.mark.parametrize("polys", [(109, 79), OTHER_POLYS])
@pytest.mark.parametrize("B,T,lag", MODEL_CASES)
def test_viterbi_stream_model_matches_plain(rng, B, T, lag, polys, kind):
    """viterbi_stream_k7's lanes, schedule, minimum, chunks and slot-space
    traceback give the plain loop's bits and metrics bit for bit, over two
    chained blocks, on non-integer and on integer soft values (ties), for
    the CCSDS code the kernel is built for and another K=7 code."""
    _model_blocks(rng, viterbi_stream_model, B, T, lag, polys, kind)


@pytest.mark.parametrize("kind", ["noisy", "integer"])
@pytest.mark.parametrize("polys", [(109, 79), OTHER_POLYS])
@pytest.mark.parametrize("B,T,lag", MODEL_CASES)
def test_viterbi_stream_redux_model_matches_plain(rng, B, T, lag, polys,
                                                  kind):
    """viterbi_stream_redux_k7's lanes, picks, class minima, chunks and
    traceback give the plain loop's bits and metrics bit for bit, over two
    chained blocks, on non-integer and integer soft values, for the CCSDS
    code it is built for and another K=7 code."""
    _model_blocks(rng, viterbi_stream_redux_model, B, T, lag, polys, kind)


@pytest.mark.parametrize("B,T,lag", MODEL_CASES[:4])
def test_viterbi_stream_warp_model_matches_plain(rng, B, T, lag):
    """viterbi_stream_warp_k7's lanes, ballots, chunks and traceback give
    the plain loop's bits and metrics bit for bit, over two chained
    blocks."""
    _model_blocks(rng, viterbi_stream_warp_model, B, T, lag, (109, 79),
                  "noisy")


def test_viterbi_model_follows_the_source():
    """viterbi_stream_model's layout, schedule and operations are the
    kernel's."""
    src = SRC.read_text()
    assert int(re.search(r"kG = (\d+);", src).group(1)) == G8
    assert int(re.search(r"kP = (\d+);", src).group(1)) == PERIOD
    assert "kChunk = 4 * kP;" in src and CHUNK60 == 4 * PERIOD
    assert "kPoly0 = 109, kPoly1 = 79;" in src
    body = re.search(r"kSched\[kP\]\[8\] = \{(.*?)\n\};", src, re.S)
    table = [tuple(int(v) for v in re.findall(r"-?\d+", line))
             for line in body.group(1).strip().splitlines()]
    assert table == [tuple(r) for r in bfly_schedule(G8)]
    for line in ("const float a0 = l1 ? f0 : v.x, a1 = l1 ? v.x : f0;",
                 "const float b0 = l0 ? f1 : v.y, b1 = l0 ? v.y : f1;",
                 "const float c0 = __fadd_rn(lo, X[p]);",
                 "const float c1 = __fadd_rn(hi, X[p ^ kD]);",
                 "const bool dec = c1 < c0;",
                 "m = fminf(m, __shfl_xor_sync(kFull, m, o));",
                 "pm[r] = __fsub_rn(pm[r], m);",
                 "idx = rest | ((w & 1) << a);",
                 "idx = (idx & ~(1 << M)) | ((w & 1) << M);",
                 "if (!Check || t < T) out[j] = (uint8_t)((idx >> M) & 1);"):
        assert line in src, line


def test_viterbi_redux_model_follows_the_source():
    """viterbi_stream_redux_model's chunk, picks, class minima and
    traceback are the kernel's."""
    src = REDUX_SRC.read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == CHUNK
    assert "kPoly0 = 109, kPoly1 = 79;" in src
    for line in ("const float P = L.par ? bm1 : bm0, Q = L.par ? bm2 : bm3;",
                 "const float u = L.e0 ? Q : P, w = L.e0 ? P : Q;",
                 "const float cA0 = __fadd_rn(pLo, u), "
                 "cA1 = __fadd_rn(pHi, w);",
                 "const float cB0 = __fadd_rn(pLo, w), "
                 "cB1 = __fadd_rn(pHi, u);",
                 "fminf(__fadd_rn(__fsub_rn(mn.n0, mn.m), fminf(bm0, bm3)),",
                 "__fadd_rn(__fsub_rn(mn.n1, mn.m), fminf(bm1, bm2)));",
                 "L.lc = (lane >> 3) & 1;",
                 "const float c0 = lc ? b : a, c1 = lc ? a : b;",
                 "pmA = __fsub_rn(nA, m);",
                 "if (L.zero) s_w[j] = ((unsigned long long)hi << 32) | lo;"):
        assert line in src, line


def test_viterbi_warp_model_follows_the_source():
    src = WARP_SRC.read_text()
    assert int(re.search(r"kChunk = (\d+);", src).group(1)) == CHUNK
    assert "__reduce_min_sync" in src and "__fadd_rn" in src
    assert "(lane | (hi << 5)) << 1) | j" in src
