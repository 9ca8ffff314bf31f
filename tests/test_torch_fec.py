"""FEC tail of the port against the JAX package, bit-exact: the tiled
Viterbi (the plain version of the `viterbi_tiled_k7` kernel) against the
JAX jnp path and against the JAX Pallas kernel decode_windows in interpret
mode, on integer and on non-integer soft values; TiledViterbi, Descrambler
and RxFecTailFF streamed with state. `bfly_model`, a numpy model of the
`viterbi_bfly_k7` kernel's loop, and the kernel's in-place index map
against the plain versions."""

import functools
import pathlib
import re

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


@pytest.mark.parametrize("T", [400, 10])
def test_tiled_viterbi_streamed(rng, T):
    """Two streamed blocks against JAX; T = 10 < W takes the new tail
    partly from the carried one."""
    blocks = [_soft(rng, (3, T, 2), "chain") for _ in range(2)]
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


# ---- viterbi_bfly_k7 (csrc/viterbi_bfly.cu): a numpy model of its loop ---

BFLY_CU = (pathlib.Path(conv.__file__).parent.parent / "csrc"
           / "viterbi_bfly.cu")
POLYS = (109, 79)


def bfly_schedule(G):
    """The kernel's slot schedule for G threads a row: rows of [swapped lane
    slot or -1, swapped register slot or -1, natural bit of slots 0..5
    after the step], one a step of the period. Slots below log2(G) are lane
    bits. Greedy: when state bit 5 sits in a lane slot, swap that slot with
    the register slot of the lowest bit; the step then moves every bit up
    by one and puts the new bit 0 where bit 5 was."""
    lb = G.bit_length() - 1
    start = [3, 4, 5, 0, 1, 2]
    nat = list(start)
    rows = []
    while True:
        swap = (-1, -1)
        j = nat.index(5)
        if j < lb:
            i = min(range(lb, 6), key=lambda k: nat[k])
            nat[j], nat[i] = nat[i], nat[j]
            swap = (j, i - lb)
        nat = [(v + 1) % 6 for v in nat]
        rows.append((*swap, *nat))
        if nat == start:
            return rows


def _pattern(s):
    """Branch-metric pattern of natural state(s) s: bit i = parity of
    poly_i & s."""
    s = np.asarray(s)
    out = np.zeros_like(s)
    for i, poly in enumerate(POLYS):
        v = s & poly
        par = np.zeros_like(s)
        for k in range(7):
            par ^= (v >> k) & 1
        out |= par << i
    return out


def _slot_natural(row, G):
    """(G, 64/G) natural state of each (lane, register) slot for one
    schedule row."""
    lb = G.bit_length() - 1
    g = np.arange(G)[:, None]
    r = np.arange(64 // G)[None, :]
    s = np.zeros((G, 64 // G), np.int64)
    for k in range(6):
        bit = (g >> k) & 1 if k < lb else (r >> (k - lb)) & 1
        s = s | (bit << row[2 + k])
    return s


def _insert0(b, i):
    return ((b >> i) << (i + 1)) | (b & ((1 << i) - 1))


def bfly_model(win, keep_from, G=8):
    """numpy model of viterbi_bfly_k7's loop on windows win (R, S, 2) f32,
    line for line: G lanes a row, 64/G metrics a lane in slot order, the 4
    branch-metric patterns a step permuted by the lane's share of the
    pattern, the schedule's shuffle exchanges (a lane's partner is
    lane ^ (1 << slot)), the butterfly ACS in register pairs, the decision
    words (one a lane a step, bit r for register r), the end state as a
    per-lane min then a xor-tree over the row's lanes with the lowest
    natural index on ties, and the traceback through the slot tables.
    Returns bits (R, S - keep_from) uint8 for steps keep_from .. S-1."""
    R, S, _ = win.shape
    lb = G.bit_length() - 1
    NR = 64 // G
    sched = bfly_schedule(G)
    P = len(sched)
    s_inv = np.stack([_slot_natural(row, G).reshape(-1) for row in sched])
    s_map = np.argsort(s_inv, axis=1)
    lane_patt = np.stack([_pattern(_slot_natural(row, G)[:, 0])
                          for row in sched])                     # (P, G)
    lanes = np.arange(G)
    f32 = np.float32
    pm = np.zeros((R, G, NR), f32)
    dec = np.zeros((S, R, G), np.int64)
    for t in range(S):
        ph = t % P
        sj, si = sched[ph][:2]
        s0, s1 = win[:, t, 0], win[:, t, 1]
        bm = np.stack([(f32(255.0 * ((p & 1) + (p >> 1)))
                        + f32(1 - 2 * (p & 1)) * s0)
                       + f32(1 - 2 * (p >> 1)) * s1 for p in range(4)])
        X = bm[np.arange(4)[None, :] ^ lane_patt[ph][:, None]]   # (G, 4, R)
        if sj >= 0:
            y = ((lanes >> sj) & 1).astype(bool)
            for b in range(NR // 2):
                r0 = _insert0(b, si)
                r1 = r0 | (1 << si)
                send = np.where(y, pm[:, :, r0], pm[:, :, r1])
                recv = send[:, lanes ^ (1 << sj)]
                pm[:, :, r0] = np.where(y, recv, pm[:, :, r0])
                pm[:, :, r1] = np.where(y, pm[:, :, r1], recv)
        m = sched[ph][2 + lb:].index(0)
        reg_patt = _pattern(_slot_natural(sched[ph], G)[0])      # (NR,)
        d = np.zeros((R, G), np.int64)
        for b in range(NR // 2):
            r0 = _insert0(b, m)
            r1 = r0 | (1 << m)
            lo, hi = pm[:, :, r0].copy(), pm[:, :, r1].copy()
            for r in (r0, r1):
                bmv = X[:, reg_patt[r], :].T                     # (R, G)
                c0 = lo + bmv
                c1 = (hi - bmv) + f32(510.0)
                pm[:, :, r] = np.minimum(c0, c1)
                d |= (c1 < c0).astype(np.int64) << r
        dec[t] = d
    # end state
    ph_end = (S - 1) % P
    nat = s_inv[ph_end].reshape(G, NR)
    best = pm[:, :, 0].copy()
    idx = np.broadcast_to(nat[:, 0], (R, G)).copy()
    for r in range(1, NR):
        take = (pm[:, :, r] < best) | ((pm[:, :, r] == best)
                                       & (nat[:, r] < idx))
        best = np.where(take, pm[:, :, r], best)
        idx = np.where(take, nat[:, r], idx)
    off = 1
    while off < G:
        ob, oi = best[:, lanes ^ off], idx[:, lanes ^ off]
        take = (ob < best) | ((ob == best) & (oi < idx))
        best, idx = np.where(take, ob, best), np.where(take, oi, idx)
        off <<= 1
    s = idx[:, 0]
    rows = np.arange(R)
    bits = np.full((R, S - keep_from), 255, np.uint8)
    for t in range(S - 1, keep_from - 1, -1):
        bits[:, t - keep_from] = s & 1
        slot = s_map[t % P, s]
        w = dec[t, rows, slot // NR]
        s = (s >> 1) | (((w >> (slot % NR)) & 1) << 5)
    return bits


def test_bfly_schedule_matches_kernel_and_covers_every_state():
    """The kernel's table is the schedule; at every step each state sits in
    exactly one (lane, register) slot, bit 5 sits in a register slot when
    the step runs, and the layout repeats after the period."""
    text = BFLY_CU.read_text()
    for G, P, n_swaps in ((8, 15, 9),):
        body = re.search(rf"kSched{G}\[{P}\]\[8\] = \{{(.*?)\n\}};", text,
                         re.S)
        table = [tuple(int(v) for v in re.findall(r"-?\d+", line))
                 for line in body.group(1).strip().splitlines()]
        sched = bfly_schedule(G)
        assert table == [tuple(r) for r in sched]
        assert len(sched) == P and sum(r[0] >= 0 for r in sched) == n_swaps
    for G in (8, 4):
        sched = bfly_schedule(G)
        lb = G.bit_length() - 1
        pre = list(sched[-1][2:])
        for row in sched:
            assert sorted(_slot_natural(row, G).reshape(-1)) == list(
                range(64))
            if row[0] >= 0:  # the swap
                j, i = row[0], row[1] + lb
                assert pre[j] == 5 and i >= lb
                pre[j], pre[i] = pre[i], pre[j]
            assert pre.index(5) >= lb
            assert list(row[2:]) == [(v + 1) % 6 for v in pre]
            pre = list(row[2:])


@pytest.mark.parametrize("G", [8, 4])
@pytest.mark.parametrize("kind", ["integer", "chain"])
def test_bfly_model_matches_plain(rng, kind, G):
    """The kernel's loop, bit for bit, against decode_windows_plain on
    R = 12 rows of S = 192 steps, at 8 and 4 threads a row."""
    win = _soft(rng, (12, 192, 2), kind)
    ref = viterbi_cuda.decode_windows_plain(conv.CCSDS_K7,
                                            torch.from_numpy(win), 32)
    np.testing.assert_array_equal(bfly_model(win, 32, G), ref.numpy())


def stream_window_map(T, L, W):
    """The kernel's in-place index map: for window c and step t, the source
    of xp index p = c*L + t as (kind, index), kind 0 = 128, 1 = state,
    2 = soft. Returns kind and index, each (C, L + 2W)."""
    C = -(-(T + W) // L)
    p = np.arange(C)[:, None] * L + np.arange(L + 2 * W)[None, :]
    kind = np.where(p < W, 0, np.where(p < 2 * W, 1,
                                       np.where(p < 2 * W + T, 2, 0)))
    idx = np.where(kind == 1, p - W, np.where(kind == 2, p - 2 * W, 0))
    return kind, idx


def stream_windows_model(state, soft, L, W):
    """(N, W, 2), (N, T, 2) -> windows (N * C, L + 2W, 2) read through the
    index map."""
    N, T, _ = soft.shape
    kind, idx = stream_window_map(T, L, W)
    src = [np.full_like(state, 128.0)[:, :1], state, soft]
    win = np.full((N,) + kind.shape + (2,), 128.0, np.float32)
    for k in (1, 2):
        win[:, kind == k] = src[k][:, idx[kind == k]]
    return win.reshape(-1, L + 2 * W, 2)


def bfly_stream_model(state, soft, L=128, W=32):
    """viterbi_bfly_k7 as a whole: windows read in place, bfly_model, the
    bit of step t of window c stored at c*L + t - 2W when W <= t < W + L
    and that index lies in [0, T); the new tail x[T : T + W]."""
    N, T, _ = soft.shape
    C = -(-(T + W) // L)
    got = bfly_model(stream_windows_model(state, soft, L, W), W)
    bits = np.full((N, T), 255, np.uint8)
    t = np.arange(W, W + L)
    for c in range(C):
        o = c * L + t - 2 * W
        ok = (o >= 0) & (o < T)
        bits[:, o[ok]] = got.reshape(N, C, -1)[:, c, t[ok] - W]
    x = np.concatenate([state, soft], axis=1)
    return x[:, T: T + W], bits


@pytest.mark.parametrize("T", [400, 200, 224, 10])
def test_stream_index_map_matches_window_composition(rng, T):
    """The in-place index map gives the windows of the composition
    overlap_windows(cat([state, soft, pad])) (T 400 and 200: the two path
    shapes; 224: T + W = 256, no pad; 10: T < W), and the output map gives
    bits[..., W : W + T] of the tiled decode of x."""
    L, W, N = 128, 32, 3
    state = _soft(rng, (N, W, 2), "chain")
    soft = _soft(rng, (N, T, 2), "chain")
    pad = (-(T + W)) % L
    x = torch.cat([torch.from_numpy(state), torch.from_numpy(soft),
                   torch.full((N, pad, 2), 128.0)], dim=1)
    ref_win = viterbi_cuda.overlap_windows(x, L, W).reshape(-1, L + 2 * W, 2)
    np.testing.assert_array_equal(stream_windows_model(state, soft, L, W),
                                  ref_win.numpy())
    ref_bits = viterbi_cuda.decode_tiled(conv.CCSDS_K7, x, L, W,
                                         viterbi_cuda.decode_windows_plain)
    ref_bits = ref_bits[:, W: W + T].numpy()
    # the output map on a stand-in decode: each window's kept steps carry
    # their own x index, which must land where the composition puts it
    C = -(-(T + W) // L)
    o = np.arange(C)[:, None] * L + np.arange(W, W + L)[None, :] - 2 * W
    placed = np.full(T, -1)
    ok = (o >= 0) & (o < T)
    placed[o[ok]] = (o + W)[ok]
    np.testing.assert_array_equal(placed, np.arange(W, W + T))
    tail, bits = bfly_stream_model(state, soft, L, W)
    np.testing.assert_array_equal(bits, ref_bits)
    np.testing.assert_array_equal(tail, x[:, T: T + W].numpy())


@pytest.mark.parametrize("T", [400, 10])
def test_decode_stream_cpu_is_the_window_composition(rng, T):
    """decode_stream on the CPU: today's TiledViterbi composition (pad,
    cat, overlap_windows, decode_windows_plain) over two chained blocks,
    recorded as viterbi_bfly_k7's plain path."""
    from qradiolink_tpu_torch.utils.profiling import kernel_paths
    L, W, N = 128, 32, 3
    state = torch.full((N, W, 2), 128.0)
    ref_state = state
    for _ in range(2):
        soft = torch.from_numpy(_soft(rng, (N, T, 2), "integer"))
        kernel_paths.reset()
        state, bits = viterbi_cuda.decode_stream(conv.CCSDS_K7, state, soft,
                                                 L, W)
        C = -(-(T + W) // L)
        assert kernel_paths.report() == {"viterbi_bfly_k7": {
            "cuda": 0, "plain": 1, "shapes": {f"plain R{N * C} S192": 1}}}
        pad = (-(T + W)) % L
        x = torch.cat([ref_state, soft, torch.full((N, pad, 2), 128.0)], 1)
        ref = conv_ff.viterbi_decode_tiled(conv.CCSDS_K7, x, L, W)
        assert torch.equal(bits, ref[:, W: W + T])
        ref_state = x[:, T: T + W]
        assert torch.equal(state, ref_state)
        m_tail, m_bits = bfly_stream_model(x[:, :W].numpy(), soft.numpy(),
                                           L, W)
        np.testing.assert_array_equal(m_bits, bits.numpy())
        np.testing.assert_array_equal(m_tail, state.numpy())
