"""The rational resampler at L > 1: numpy models of the kernels' blocks
(`resample_poly_f32`, `resample_up_f32`, `resample_x2_f32`,
`resample_rat_f32`) held against the plain version, the port's
RationalResampler against the JAX package's on real, complex and IqPair
input, and the route each call records on the CPU. Tolerance: 1e-5, the
bound the JAX package holds its FIR kernels to; the carried state is
copied, not computed, and must be equal."""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.ops.resample import (  # noqa: E402
    RationalResampler as JaxResampler)
from qradiolink_tpu_torch.ops import cuda_fir  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_resample import (  # noqa: E402
    DEC_OP, OP, RAT_OP, UP_OP, X2_OP, phase_offsets, resample_poly,
    resample_poly_plain, route)
from qradiolink_tpu_torch.models import registry  # noqa: E402
from qradiolink_tpu_torch.ops.resample import RationalResampler  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.torch_parity import stream_both  # noqa: E402

CSRC = pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch" \
    / "csrc"
SRC = CSRC / "resample_poly.cu"
UP_SRC = CSRC / "resample_up.cu"
X2_SRC = CSRC / "resample_x2.cu"
RAT_SRC = CSRC / "resample_rat.cu"
THREADS, WARP = 128, 32
# resample_up_f32's block, tile target, span cap and outputs a job
UP_THREADS, UP_ROUNDS, UP_MAX_SPAN = 256, 24, 8192

# (L, M) of the ported and planned resamplers: the NBFM audio resampler,
# M17's 3/125 and the TX resamplers 25/4, 20/1 and 125/1 (SsbMod, AmMod);
# block lengths leave a ragged last tile: n_pp = 150 (64 + 64 + 22), 45
# (32 + 13), 50 (32 + 18), 70 (32 + 32 + 6), 40 (32 + 8); and
# resample_rat_f32's four shapes with their chains' taps (RAT_CASES)
CASES = {(2, 5): 750, (3, 125): 125 * 45, (25, 4): 200, (20, 1): 70,
         (125, 1): 40, (125, 12): 12 * 40, (50, 13): 13 * 70,
         (25, 24): 24 * 50, (24, 25): 25 * 40}
# resample_rat_f32's shapes: (L, M): (K a phase, the chain's block, the
# output times a row of its path's block): 125/12 MmdvmMod's up (the
# sweep_MMDVM step, 24,000 -> 250,000); 50/13 DsssBpskMod's up_if (the
# DSSS sweep, 5,200 -> 20,000); 25/24 MmdvmMultiTx's resamp and 24/25
# MmdvmMultiRx's (one site, 24,000 <-> 25,000)
RAT_CASES = {(125, 12): (51, "MmdvmMod.up", 2000),
             (50, 13): (2, "DsssBpskMod.up_if", 400),
             (25, 24): (51, "MmdvmMultiTx.resamp", 1000),
             (24, 25): (53, "MmdvmMultiRx.resamp", 1000)}


def chain_taps(L, M):
    """The prototype taps of the chain that runs L/M at a resample_rat_f32
    shape (qradiolink_tpu_torch/chains/mmdvm.py, dsss.py), None
    elsewhere (the default design)."""
    from qradiolink_tpu_torch.chains import dsss, mmdvm
    from qradiolink_tpu_torch.ops import firdes

    fw = mmdvm.FILTER_WIDTH
    make = {(125, 12): lambda: mmdvm._lp(125.0, 12 * mmdvm.DEVICE_RATE, fw),
            (25, 24): lambda: mmdvm._lp(25.0, 600_000, fw),
            (24, 25): lambda: mmdvm._lp(1.0, 600_000, fw),
            (50, 13): lambda: firdes.low_pass(50.0, dsss.IF_RATE * 50,
                                              1700.0, 1700.0 * 5)}
    return make[(L, M)]() if (L, M) in make else None


def block_t(L):
    """Output times a block covers (kTB in the source)."""
    return WARP * (1 if L >= 4 else 4 // L)


def poly_model(xs, taps, L, M, tails):
    """resample_poly_f32's blocks in numpy. Block (tile, row, plane) stages
    the taps of all phases, rows K|1 floats apart, and its span of
    xc = [tail | x] with the seam resolved per element; warp jobs (phase
    r = w mod L, 32 consecutive output times) each compute their outputs
    from the span at i*M + q_r and write them to t*L + r; the row's first
    block copies xc[T .. T+K-2] into the new state (zeros in the im plane of
    one plane). xs, tails: lists of (C, T) and (C, K-1) f32 planes; taps
    (L, K) flipped. Returns (state (C, 2, K-1), outputs (planes, C, n)),
    asserting that every value is written once."""
    planes, (C, T), K = len(xs), xs[0].shape, taps.shape[1]
    k1, n_pp, tb, ks = K - 1, T // M, block_t(L), K | 1
    q_max = (L - 1) * M // L
    y = np.full((planes, C, n_pp * L), np.nan, np.float32)
    state = np.full((C, 2, k1), np.nan, np.float32)
    for p in range(planes):
        for row in range(C):
            xc_tail, x = tails[p][row], xs[p][row]

            def load(v):
                return np.where(v < k1, xc_tail[np.minimum(v, k1 - 1)],
                                x[np.maximum(v - k1, 0)])

            for tile in range(max(1, -(-n_pp // tb))):
                if tile == 0:
                    assert np.isnan(state[row, p]).all()
                    state[row, p] = load(T + np.arange(k1))
                    if planes == 1:
                        state[row, 1] = 0.0
                t0 = tile * tb
                nt = min(tb, n_pp - t0)
                if nt <= 0:
                    continue
                s_tap = np.full(L * ks, np.nan, np.float32)
                for r in range(L):
                    s_tap[r * ks:r * ks + K] = taps[r]
                span = (nt - 1) * M + q_max + K
                s_x = load(t0 * M + np.arange(span))
                jobs = L * (tb // WARP)
                for warp in range(THREADS // WARP):
                    for w in range(warp, jobs, THREADS // WARP):
                        r = w % L
                        i = (w // L) * WARP + np.arange(WARP)
                        i = i[i < nt]
                        win = s_x[i[:, None] * M + r * M // L
                                  + np.arange(K)]
                        out = win.astype(np.float64) @ \
                            s_tap[r * ks:r * ks + K].astype(np.float64)
                        pos = (t0 + i) * L + r
                        assert np.isnan(y[p, row, pos]).all()
                        y[p, row, pos] = out
    assert not np.isnan(y).any() and not np.isnan(state).any()
    return state, y


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("L,M", sorted(CASES))
def test_poly_model_matches_plain(rng, L, M, planes):
    """Two chained blocks with the default taps (resample_rat_f32's shapes:
    their chains'): the model's outputs within 1e-5 of resample_poly_plain's,
    its state equal."""
    rs = RationalResampler(L, M, taps=chain_taps(L, M), lead_shape=(2,),
                           device="cpu")
    taps = rs.poly_taps.numpy()
    T = CASES[(L, M)]
    st = rng.standard_normal((2, 2, rs.kp - 1)).astype(np.float32)
    for _ in range(2):
        xs = [rng.standard_normal((2, T)).astype(np.float32)
              for _ in range(planes)]
        tails = [st[:, p] for p in range(planes)]
        got_state, got = poly_model(xs, taps, L, M, tails)
        want_state, want = resample_poly_plain(
            [torch.from_numpy(x) for x in xs], rs.poly_taps, L, M,
            [torch.from_numpy(t.copy()) for t in tails])
        for g, w in zip(got, want):
            _close(g, w.numpy())
        assert np.array_equal(got_state, want_state.numpy())
        st = got_state


def test_poly_model_short_block(rng):
    """A block shorter than the tail (T 50 < K-1 112): the new state is
    part old tail, part block."""
    rs = RationalResampler(2, 5, lead_shape=(3,), device="cpu")
    st = rng.standard_normal((3, 2, rs.kp - 1)).astype(np.float32)
    x = rng.standard_normal((3, 50)).astype(np.float32)
    got_state, got = poly_model([x], rs.poly_taps.numpy(), 2, 5, [st[:, 0]])
    want_state, (want,) = resample_poly_plain(
        (torch.from_numpy(x),), rs.poly_taps, 2, 5,
        (torch.from_numpy(st[:, 0].copy()),))
    _close(got[0], want.numpy())
    assert np.array_equal(got_state, want_state.numpy())
    assert np.array_equal(got_state[:, 0, :62], st[:, 0, 50:])


def test_poly_model_follows_the_kernel_source():
    """The model's block size, warp jobs and tap stride are the kernel's."""
    src = SRC.read_text()
    assert f"constexpr int kThreads = {THREADS};" in src
    assert f"constexpr int kWarp = {WARP};" in src
    assert "return kWarp * (L >= 4 ? 1 : 4 / L);" in src
    assert "__host__ __device__ constexpr int kTapStride(int K) { return " \
        "K | 1; }" in src
    assert "const int r = w % L;" in src
    assert "const int i = (w / L) * kWarp + lane;" in src
    # the seam, and the state as the K-1 words of xc from T on
    assert "val[k] = v < k1 ? tail[v] : x[v - k1];" in src
    assert ": (long long)T + (w - n_tap - span);" in src


def up_r(M):
    """Consecutive output times a job of resample_up_f32 (kR in the
    source)."""
    return 16 if M <= 2 else 8


def up_ring(M):
    """The ring's length: the samples a job's outputs read at one tap."""
    return (up_r(M) - 1) * M + 1


def up_tile_times(L, M, n_pp):
    """resample_up_f32's tile width (tile_times in the source): about
    UP_ROUNDS jobs a thread, at most UP_MAX_SPAN samples of span, whole
    jobs, equal tiles across the row."""
    if n_pp <= 0:
        return 0
    r = up_r(M)
    tb = UP_ROUNDS * UP_THREADS // L
    if tb * r * M > UP_MAX_SPAN:
        tb = UP_MAX_SPAN // (r * M)
    tb = max(tb, 1)
    tiles = -(-n_pp // (tb * r))
    per = -(-n_pp // tiles)
    return -(-per // r) * r


def up_jobs(L, n_tb):
    """Each thread's jobs (time block, phase) in the order the kernel's loop
    steps them: from (t // L, t % L), by kThreads without a division."""
    dtb, dr = UP_THREADS // L, UP_THREADS % L
    jobs = []
    for t in range(UP_THREADS):
        tb, r = t // L, t % L
        while tb < n_tb:
            jobs.append((tb, r))
            tb, r = tb + dtb, r + dr
            if r >= L:
                tb, r = tb + 1, r - L
    return jobs


def up_ring_reads(M, K):
    """The samples each FMA of a job reads, by running the kernel's ring:
    the fill of N - 1 slots, K // N groups of N steps with the window
    pointer advanced by N a group, then K mod N steps under `s < rem`; in
    each step the new sample enters slot (s + N - 1) mod N and output u
    reads slot (s + u M) mod N. Returns [(j, u, sample)] in issue order."""
    N, R = up_ring(M), up_r(M)
    ring = {s: s for s in range(N - 1)}  # slot -> sample index
    reads, base, j = [], 0, 0
    n_grp, rem = K // N, K % N
    for s_list in [range(N)] * n_grp + [range(rem)]:
        for s in s_list:
            ring[(s + N - 1) % N] = base + s + N - 1
            for u in range(R):
                reads.append((j, u, ring[(s + u * M) % N]))
            j += 1
        base += N
    return reads


def up_model(xs, taps, L, M, tails):
    """resample_up_f32's blocks in numpy. Block (tile, row, plane) stages
    the taps of all phases, rows K|1 floats apart, and the span of
    xc = [tail | x] that its whole jobs read (zeros past the stream's end),
    the seam resolved per element; each thread's jobs (time block tb, phase
    r) compute kR consecutive output times of phase r from the span at
    tb kR M + q_r and store those before the tile's end at t*L + r; the
    row's first tile copies xc[T .. T+K-2] into the new state (zeros in the
    im plane of one plane). Returns (state (C, 2, K-1), outputs (planes, C,
    n)), asserting that every value is written once."""
    planes, (C, T), K = len(xs), xs[0].shape, taps.shape[1]
    k1, n_pp, R, ks = K - 1, T // M, up_r(M), K | 1
    q_max = (L - 1) * M // L
    tt = up_tile_times(L, M, n_pp)
    n_tiles = -(-n_pp // tt) if n_pp else 1
    y = np.full((planes, C, n_pp * L), np.nan, np.float32)
    state = np.full((C, 2, k1), np.nan, np.float32)
    s_tap = np.full((L, ks), np.nan, np.float32)
    s_tap[:, :K] = taps
    jobs = {}
    for p in range(planes):
        for row in range(C):
            xc = np.concatenate([tails[p][row], xs[p][row]])

            def load(v):
                return np.where(v < k1 + T, xc[np.minimum(v, k1 + T - 1)],
                                np.float32(0.0))

            for tile in range(n_tiles):
                if tile == 0:
                    assert np.isnan(state[row, p]).all()
                    state[row, p] = load(T + np.arange(k1))
                    if planes == 1:
                        state[row, 1] = 0.0
                t0 = tile * tt
                nt = max(0, min(tt, n_pp - t0))
                if nt == 0:
                    continue
                n_tb = -(-nt // R)
                span = (n_tb * R - 1) * M + q_max + K
                s_x = load(t0 * M + np.arange(span))
                if n_tb not in jobs:
                    jobs[n_tb] = np.array(up_jobs(L, n_tb))
                tb, r = jobs[n_tb][:, 0], jobs[n_tb][:, 1]
                # job, u, j -> span word (tb R + u) M + q_r + j
                win = ((tb[:, None, None] * R + np.arange(R)[None, :, None])
                       * M + (r * M // L)[:, None, None]
                       + np.arange(K)[None, None, :])
                assert win.max() < span
                out = np.einsum("juk,jk->ju", s_x[win].astype(np.float64),
                                s_tap[r, :K].astype(np.float64))
                t = t0 + tb[:, None] * R + np.arange(R)[None, :]
                keep = t < t0 + nt
                pos = (t * L + r[:, None])[keep]
                assert np.isnan(y[p, row, pos]).all()
                assert len(np.unique(pos)) == len(pos)
                y[p, row, pos] = out[keep]
    assert not np.isnan(y).any() and not np.isnan(state).any()
    return state, y


def _up_case(rng, L, M, planes, T, C=2, blocks=2):
    """Blocks chained through up_model with the default taps, each held
    against resample_poly_plain: outputs within 1e-5, state equal."""
    rs = RationalResampler(L, M, lead_shape=(C,), device="cpu")
    taps = rs.poly_taps.numpy()
    st = rng.standard_normal((C, 2, rs.kp - 1)).astype(np.float32)
    for _ in range(blocks):
        xs = [rng.standard_normal((C, T)).astype(np.float32)
              for _ in range(planes)]
        tails = [st[:, p] for p in range(planes)]
        got_state, got = up_model(xs, taps, L, M, tails)
        want_state, want = resample_poly_plain(
            [torch.from_numpy(x) for x in xs], rs.poly_taps, L, M,
            [torch.from_numpy(t.copy()) for t in tails])
        for g, w in zip(got, want):
            _close(g, w.numpy())
        assert np.array_equal(got_state, want_state.numpy())
        st = got_state
    return st


# (L, M): block length; each leaves a ragged last tile that ends inside a
# job: L 125 M 1, n_pp 850 -> tiles of 432 + 418; L 20 M 1, n_pp 5,000 ->
# 2,512 + 2,488; L 25 M 4, n_pp 2,001 -> 1,008 + 993 (M 4: a ring of 29
# registers); L 125 M 3 (the M17 and DMR TX interpolators), n_pp 1,001 ->
# 336 + 336 + 329 (a ring of 22)
UP_CASES = {(125, 1): 850, (20, 1): 5000, (25, 4): 8004, (125, 3): 3003}


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("L,M", sorted(UP_CASES))
def test_up_model_matches_plain(rng, L, M, planes):
    """The TX interpolators' shapes over two chained blocks: the model's
    outputs within 1e-5 of resample_poly_plain's, its state equal."""
    n_pp = UP_CASES[(L, M)] // M
    tt = up_tile_times(L, M, n_pp)
    assert n_pp > tt and n_pp % tt and (n_pp % tt) % up_r(M)
    _up_case(rng, L, M, planes, UP_CASES[(L, M)])


@pytest.mark.parametrize("L,M,T", [
    (25, 4, 4004),    # one tile of 1,001 of 1,008 times, the M 4 ring
    (5, 2, 2 * 611),  # L not dividing 32 nor the 256 threads; M 2: N 31
    (8, 5, 5 * 97),   # M 5 (N 36), a tile shorter than a job round
    (4, 3, 3 * 9),    # one ragged job (9 of 8 + 1), M 3 (N 22)
])
def test_up_model_edges(rng, L, M, T):
    _up_case(rng, L, M, 2, T)


@pytest.mark.parametrize("planes", [1, 2])
def test_up_model_state_only(rng, planes):
    """T = 0: the launch only copies the tail into the new state, which
    equals the old one."""
    st = _up_case(rng, 125, 1, planes, 0, blocks=1)
    assert st.shape == (2, 2, 44)


@pytest.mark.parametrize("M", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("K", [1, 2, 13, 45, 46, 113])
def test_up_ring_reads_every_tap_in_order(M, K):
    """Every FMA of a job reads sample j + u M at tap j, and each output
    adds its taps j = 0 .. K-1 in order (resample_poly_f32's order)."""
    reads = up_ring_reads(M, K)
    assert len(reads) == K * up_r(M)
    for j, u, sample in reads:
        assert sample == j + u * M
    for u in range(up_r(M)):
        assert [j for j, uu, _ in reads if uu == u] == list(range(K))


@pytest.mark.parametrize("L,n_tb", [(125, 34), (20, 209), (25, 50),
                                    (300, 3), (256, 2), (7, 1)])
def test_up_jobs_cover_each_job_once(L, n_tb):
    """The kernel's division-free stepping gives every (time block, phase)
    of a tile to exactly one thread."""
    jobs = up_jobs(L, n_tb)
    assert sorted(jobs) == [(tb, r) for tb in range(n_tb)
                            for r in range(L)]


def test_up_tile_widths():
    """The TX shapes' tiles (the kernel's header quotes them)."""
    assert up_tile_times(125, 1, 1600) == 544
    assert up_tile_times(20, 1, 10_000) == 3344
    assert up_tile_times(25, 4, 400) == 400
    # the M17 and DMR TX shapes: 125/3 over 4,800 samples in 5 tiles of
    # 320 times (40 jobs a phase, 20 a thread), 5/1 over 960 in one tile
    assert up_tile_times(125, 3, 1600) == 320
    assert up_tile_times(5, 1, 960) == 960


def test_up_model_follows_the_kernel_source():
    """The model's constants, tiles, job stepping, ring, span and seam are
    the kernel's."""
    src = UP_SRC.read_text()
    for line in [
            f"constexpr int kThreads = {UP_THREADS};",
            f"constexpr int kRounds = {UP_ROUNDS};",
            f"constexpr int kMaxSpan = {UP_MAX_SPAN};",
            "constexpr int kR1 = 16;", "constexpr int kR3 = 8;",
            "constexpr int kR(int M) { return M <= 2 ? kR1 : kR3; }",
            "constexpr int kRing(int M) { return (kR(M) - 1) * M + 1; }",
            "constexpr int kTapStride(int K) { return K | 1; }",
            # tile_times
            "long long tb = (long long)kRounds * kThreads / L;",
            "if (tb * r * M > kMaxSpan) tb = kMaxSpan / (r * M);",
            "const long long tiles = (n_pp + tt_max - 1) / tt_max;",
            "return (int)((per + r - 1) / r * r);",
            # span of whole jobs, zeros past the stream's end, the seam
            "nt > 0 ? (long long)(((nt + kR(M) - 1) / kR(M)) * kR(M) - 1) * M",
            "if (v < n_in) val[k] = v < k1 ? tail[v] : x[v - k1];",
            ": (long long)T + (w - n_tap - span);",
            # jobs
            "const int dtb = kThreads / L;",
            "const int dr = kThreads - dtb * L;",
            "for (int tb = threadIdx.x / L, r = threadIdx.x % L; tb < n_tb;) {",
            "const float* p = s_x + i0 * M + (M == 1 ? 0 : r * M / L);",
            "const float* h = s_tap + r * ks;",
            # the ring
            "for (int s = 0; s < N - 1; ++s) w[s] = p[s];",
            "w[(j + N - 1) % N] = p[j + N - 1];",
            "acc[u] = fmaf(tap, w[(j + u * M) % N], acc[u]);",
            "for (int b = 0; b < n_grp; ++b, p += N, h += N) {",
            "if (s < rem) step(s);",
            # stores
            "float* yo = y + (size_t)(t0 + i0) * L + r;",
            "if (i0 + u < nt) yo[(size_t)u * L] = acc[u];"]:
        assert line in src, line


# resample_x2_f32's block, outputs a job, rounds a tile (at most)
X2_THREADS, X2_R, X2_ROUNDS = 256, 16, 6
X2_ROUND = X2_THREADS * X2_R
X2_OUT_LD = 2 * X2_R + 1


def x2_padded(i):
    """Shared-memory word of logical span word i: a pad after every kR."""
    return i + i // X2_R


def x2_tile_times(n_pp):
    """resample_x2_f32's tile width (tile_times in the source): at most
    X2_ROUNDS rounds, whole jobs, equal tiles across the row."""
    if n_pp <= 0:
        return 0
    tt_max = X2_ROUNDS * X2_ROUND
    tiles = -(-n_pp // tt_max)
    per = -(-n_pp // tiles)
    return -(-per // X2_R) * X2_R


def x2_ring_reads(K):
    """The span words each FMA of job g = 0 reads, by running the kernel's
    ring over the padded layout: the fill of kR - 1 slots from p, K // kR
    groups of kR steps with q advanced by kR + 1 words a group, then
    K mod kR steps under `u < rem`; in step u the word q[c + c // kR],
    c = u + kR - 1, enters slot (u + kR - 1) mod kR, and output v reads
    slot (u + v) mod kR. Returns [(j, v, logical word)] in issue order."""
    R = X2_R
    unpad = {x2_padded(i): i for i in range(4 * R + K)}
    ring = {s: unpad[s] for s in range(R - 1)}
    reads, q, j = [], 0, 0
    n_grp, rem = K // R, K % R
    for us in [range(R)] * n_grp + [range(rem)]:
        for u in us:
            c = u + R - 1
            ring[(u + R - 1) % R] = unpad[q + c + c // R]
            for v in range(R):
                reads.append((j, v, ring[(u + v) % R]))
            j += 1
        q += R + 1
    return reads


def x2_model(xs, taps, tails):
    """resample_x2_f32's blocks in numpy. Block (tile, row, plane) stages
    both phases' taps, then, a round of up to 4,096 output times at a
    time, the span its whole jobs read (the round's times + K - 1 words of
    xc = [tail | x], zeros past the stream's end) into the padded layout
    (NaN elsewhere, so a wrong index shows); job g of a round (thread g)
    computes output times g kR .. g kR + kR - 1 of both phases from the
    words x2_ring_reads names, writes them to row g mod 32 of its warp's
    buffer (2 u + r), and the warp stores buffer entry (k, lane) to round
    output warp * 1,024 + 32 k + lane where that lies before the tile's
    end; the row's first tile copies xc[T .. T+K-2] into the new state
    (zeros in the im plane of one plane). Returns (state (C, 2, K-1),
    outputs (planes, C, 2T)), asserting that every value is written
    once."""
    planes, (C, T), K = len(xs), xs[0].shape, taps.shape[1]
    k1, R = K - 1, X2_R
    tt = x2_tile_times(T)
    n_tiles = -(-T // tt) if T else 1
    reads = np.array(x2_ring_reads(K))
    assert all(w == j + v for j, v, w in reads)
    y = np.full((planes, C, 2 * T), np.nan, np.float32)
    state = np.full((C, 2, k1), np.nan, np.float32)
    jobs = np.arange(X2_THREADS)
    for p in range(planes):
        for row in range(C):
            xc = np.concatenate([tails[p][row], xs[p][row]])

            def load(v):
                return np.where(v < k1 + T, xc[np.minimum(v, k1 + T - 1)],
                                np.float32(0.0))

            for tile in range(n_tiles):
                if tile == 0:
                    assert np.isnan(state[row, p]).all()
                    state[row, p] = load(T + np.arange(k1))
                    if planes == 1:
                        state[row, 1] = 0.0
                t0 = tile * tt
                nt = max(0, min(tt, T - t0))
                for r0 in range(0, nt, X2_ROUND):
                    n_here = min(X2_ROUND, nt - r0)
                    nj = -(-n_here // R)
                    span = nj * R + k1
                    s_x = np.full(x2_padded(X2_ROUND + k1 - 1) + 1, np.nan,
                                  np.float32)
                    s_x[x2_padded(np.arange(span))] = load(
                        t0 + r0 + np.arange(span))
                    g = jobs[:nj]
                    # job g, output v, tap j: the word g kR + j + v
                    words = g[:, None, None] * R + reads[None, :, 2]
                    vals = s_x[x2_padded(words)].reshape(nj, K, R)
                    assert not np.isnan(vals).any()
                    acc = np.einsum("gjv,rj->grv", vals.astype(np.float64),
                                    taps.astype(np.float64))
                    buf = np.full((X2_THREADS, X2_OUT_LD), np.nan,
                                  np.float32)
                    u = np.arange(R)
                    for r in (0, 1):
                        buf[g[:, None], 2 * u[None, :] + r] = acc[:, r, :]
                    out0 = 2 * (t0 + r0)
                    for warp in range(-(-nj // 32)):
                        n_out = 2 * (n_here - warp * 32 * R)
                        for k in range(32):
                            e = k * 32 + np.arange(32)
                            keep = e < n_out
                            pos = out0 + warp * 32 * 2 * R + e[keep]
                            assert np.isnan(y[p, row, pos]).all()
                            y[p, row, pos] = buf[warp * 32 + k,
                                                 np.arange(32)[keep]]
    assert not np.isnan(y).any() and not np.isnan(state).any()
    return state, y


def _x2_case(rng, planes, T, C=2, blocks=2):
    """Blocks chained through x2_model with QpskMod's x2 taps (the default
    2/1 taps, 46 a phase), each held against resample_poly_plain: outputs
    within 1e-5, state equal."""
    rs = RationalResampler(2, 1, lead_shape=(C,), device="cpu")
    taps = rs.poly_taps.numpy()
    st = rng.standard_normal((C, 2, rs.kp - 1)).astype(np.float32)
    for _ in range(blocks):
        xs = [rng.standard_normal((C, T)).astype(np.float32)
              for _ in range(planes)]
        tails = [st[:, p] for p in range(planes)]
        got_state, got = x2_model(xs, taps, tails)
        want_state, want = resample_poly_plain(
            [torch.from_numpy(x) for x in xs], rs.poly_taps, 2, 1,
            [torch.from_numpy(t.copy()) for t in tails])
        for g, w in zip(got, want):
            _close(g, w.numpy())
        assert np.array_equal(got_state, want_state.numpy())
        st = got_state
    return st


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("T", [
    30_007,  # tiles of 15,008 + 14,999: ragged rounds, a ragged last job
    4_096,   # one full round
    1_000,   # one round of 63 jobs (62 + 8 times), a part-filled warp
    20,      # shorter than the tail (45): the state is part old tail
    1,
])
def test_x2_model_matches_plain(rng, planes, T):
    """QpskMod's L2 M1 over two chained blocks and at the edges: the
    model's outputs within 1e-5 of resample_poly_plain's, its state
    equal."""
    _x2_case(rng, planes, T)


def test_x2_model_state_only(rng):
    """T = 0: the launch only copies the tail into the new state."""
    assert _x2_case(rng, 2, 0, blocks=1).shape == (2, 2, 45)


@pytest.mark.parametrize("K", [1, 2, 15, 16, 17, 46, 113])
def test_x2_ring_reads_every_tap_in_order(K):
    """Every FMA of a job reads sample j + v at tap j, and each output adds
    its taps j = 0 .. K-1 in order (resample_poly_f32's order)."""
    reads = x2_ring_reads(K)
    assert len(reads) == K * X2_R
    for v in range(X2_R):
        assert [j for j, vv, _ in reads if vv == v] == list(range(K))


def test_x2_tile_widths():
    """QpskMod's x2 at QPSK250K: 5 tiles of 20,000 output times a row."""
    assert x2_tile_times(100_000) == 20_000
    assert x2_tile_times(30_007) == 15_008
    assert x2_tile_times(X2_ROUNDS * X2_ROUND) == X2_ROUNDS * X2_ROUND


def test_x2_model_follows_the_kernel_source():
    """The model's constants, tiles, span, ring, buffer and stores are the
    kernel's."""
    src = X2_SRC.read_text()
    for line in [
            f"constexpr int kThreads = {X2_THREADS};",
            f"constexpr int kR = {X2_R};",
            f"constexpr int kRounds = {X2_ROUNDS};",
            "constexpr int kRound = kThreads * kR;",
            "constexpr int kOutLd = 2 * kR + 1;",
            "constexpr int padded(int i) { return i + i / kR; }",
            "return nj * kR + K - 1;",
            # tile_times
            "const long long tt_max = (long long)kRounds * kRound;",
            "const long long tiles = (n_pp + tt_max - 1) / tt_max;",
            "return (int)((per + kR - 1) / kR * kR);",
            # the span: zeros past the stream's end, the seam
            "if (w < span && v < n_in)",
            "val[k] = v < k1 ? tail[v] : x[v - k1];",
            "if (w < span) s_x[padded(w)] = val[k];",
            "st[j] = v < k1 ? tail[v] : x[v - k1];",
            # the ring
            "const float* q = s_x + g * (kR + 1);",
            "for (int s = 0; s < kR - 1; ++s) w[s] = q[s];",
            "w[(u + kLast) % kR] = q[c + c / kR];",
            "a0[v] = fmaf(tap.x, w[(u + v) % kR], a0[v]);",
            "a1[v] = fmaf(tap.y, w[(u + v) % kR], a1[v]);",
            "for (int b = 0; b < n_grp; ++b, q += kR + 1, h += kR) {",
            "if (u < rem) {",
            # the buffer and the stores
            "s_o[lane * kOutLd + 2 * u] = a0[u];",
            "s_o[lane * kOutLd + 2 * u + 1] = a1[u];",
            "float* yo = y + 2 * (t0 + r0) + warp * 32 * 2 * kR;",
            "const int n_out = 2 * (n_here - warp * 32 * kR);",
            "if (e < n_out) yo[e] = s_o[k * kOutLd + lane];"]:
        assert line in src, line


# resample_rat_f32's block, blocks an SM its tile rule aims at, samples a
# group stages a chunk (about), output times a group at most per ring slot
RAT_THREADS, RAT_RULE_BLOCKS, RAT_CHUNK_WORDS, RAT_TIMES_A = 128, 4, 768, 64
H100_SMS = 132


def rat_ring(M, K):
    """The accumulators a thread rings through: the outputs whose windows
    hold one sample (ring_len in the source)."""
    return -(-K // M)


def rat_unroll(M, K):
    """Iterations an unrolled step (unroll_len): a multiple of A, at least
    3."""
    A = rat_ring(M, K)
    return A if A >= 3 else 4


def rat_chunk(M, K):
    """Iterations a chunk (chunk_iters)."""
    ua = rat_unroll(M, K)
    return ua * max(1, RAT_CHUNK_WORDS // (M * ua))


def rat_region(L, M, K):
    """Words between two groups' regions of a chunk buffer (region_words):
    the chunk's samples, padded to q_max + 1 (mod 32)."""
    qm = (L - 1) * M // L
    cw = rat_chunk(M, K) * M + qm
    return cw + (qm + 1 - cw) % 32


def rat_lane_words(L, M, K):
    """Each thread's first word in a chunk buffer, (G, L): its group's
    region, then q_r."""
    G, sp = RAT_THREADS // L, rat_region(L, M, K)
    q = np.array(phase_offsets(L, M))
    return (np.arange(G) * sp)[:, None] + q[None, :]


def rat_tile_times(L, M, K, row_planes, n_pp, n_sm=H100_SMS):
    """resample_rat_f32's output times a group (tile_times): the least that
    gives RAT_RULE_BLOCKS blocks an SM, at least 1 and at most RAT_TIMES_A
    per ring slot, evened over the row's tiles."""
    if n_pp <= 0:
        return 0
    G = RAT_THREADS // L
    per = -(-row_planes * n_pp // (G * n_sm * RAT_RULE_BLOCKS))
    per = max(1, min(per, RAT_TIMES_A * rat_ring(M, K)))
    tiles = -(-n_pp // (G * per))
    return -(-n_pp // (tiles * G))


def rat_ring_reads(M, K, times):
    """Each stored output's FMAs, by running one thread's ring over a
    group's times + A - 1 iterations in the kernel's order: iteration c
    starts output c in slot c mod A, each of its min(M, K) samples i (the
    c M + i-th of the group's stream) serves output c - b at tap i + b M
    (b < A, i + b M < K) in slot (c - b) mod A, and output c - A + 1 is
    stored from slot (c + 1) mod A where it is one of the group's times.
    Returns {output: [(tap, sample)]} in the kernel's order."""
    A = rat_ring(M, K)
    slots = [[None, []] for _ in range(A)]  # [output, reads]
    stored = {}
    for c in range(times + A - 1):
        slots[c % A] = [c, []]
        for i in range(min(M, K)):
            for b in range(A):
                if i + b * M < K:
                    out, reads = slots[(c - b) % A]
                    assert c - b < 0 or out == c - b
                    reads.append((i + b * M, c * M + i))
        o = c - (A - 1)
        if 0 <= o < times:
            out, reads = slots[(c + 1) % A]
            assert out == o
            stored[o] = reads
    return stored


def rat_jobs(L, n_pp, times):
    """(output time, phase) of every store, by block (tile), group and
    thread, as the kernel's grid and threads give them."""
    G = RAT_THREADS // L
    n_tiles = -(-n_pp // (G * times)) if n_pp else 1
    jobs = []
    for tile in range(n_tiles):
        t0 = tile * G * times
        for k in range(RAT_THREADS):
            r, g = k % L, k // L
            if g >= G:
                continue
            tg = t0 + g * times
            jobs += [(tg + o, r) for o in range(max(0, min(times,
                                                           n_pp - tg)))]
    return jobs


def rat_model(xs, taps, L, M, tails, times):
    """resample_rat_f32's blocks in numpy. Block (tile, row, plane) stages the
    taps of all phases (rows K|1 floats apart; each thread reads its
    phase's row into its registers), then, over a group's times + A - 1
    iterations rounded up to whole unrolled steps, for chunk k of CC
    iterations stages each group's words from (t0 + g times + k CC) M on
    into region g (sp words apart; NaN elsewhere, so a wrong index shows;
    zeros past the stream's end, the seam resolved per word); thread (phase
    r, group g) runs iteration c: slot c mod A from 0, sample i of the
    iteration (word c_local M + q_r + i of its region, rat_lane_words) into
    slot (c - b) mod A at tap i + b M, then stores slot (c + 1) mod A as
    output o = c - A + 1 of its group at (tg + o) L + r; the row's first
    tile copies xc[T .. T+K-2] into the new state (zeros in the im plane of
    one plane). Vectorised over rows, groups and phases. Returns (state (C,
    2, K-1), outputs (planes, C, n)), asserting that every value is written
    once."""
    planes, (C, T), K = len(xs), xs[0].shape, taps.shape[1]
    k1, n_pp = K - 1, T // M
    A, CC = rat_ring(M, K), rat_chunk(M, K)
    G, sp, ks = RAT_THREADS // L, rat_region(L, M, K), K | 1
    qm = (L - 1) * M // L
    n_tiles = -(-n_pp // (G * times)) if n_pp else 1
    ua = rat_unroll(M, K)
    n_it = -(-(times + A - 1) // ua) * ua  # whole unrolled steps
    n_ch = -(-n_it // CC)
    assert CC % ua == 0 and ua % A == 0
    y = np.full((planes, C, n_pp * L), np.nan, np.float32)
    state = np.full((C, 2, k1), np.nan, np.float32)
    s_tap = np.full(L * ks, np.nan, np.float32)
    for r in range(L):
        s_tap[r * ks:r * ks + K] = taps[r]
    h = s_tap[(np.arange(L) * ks)[:, None] + np.arange(K)].astype(np.float64)
    assert not np.isnan(h).any()
    regions = rat_lane_words(L, M, K)  # (G, L)
    for p in range(planes):
        xc = np.concatenate([tails[p], xs[p]], axis=1)
        n_in = k1 + T

        def load(v):
            return np.where(v < n_in, xc[:, np.minimum(v, n_in - 1)],
                            np.float32(0.0))

        for tile in range(n_tiles):
            if tile == 0:
                assert np.isnan(state[:, p]).all()
                state[:, p] = load(T + np.arange(k1))
                if planes == 1:
                    state[:, 1] = 0.0
            t0 = tile * G * times
            if n_pp - t0 <= 0:
                continue
            tg = t0 + np.arange(G) * times
            n_g = np.clip(n_pp - tg, 0, times)
            acc = np.zeros((C, G, L, A))
            for k in range(n_ch):
                n_itk = min(CC, n_it - k * CC)
                n_w = n_itk * M + qm
                assert n_w <= sp
                buf = np.full((C, G * sp), np.nan)
                for g in range(G):
                    buf[:, g * sp:g * sp + n_w] = load(
                        (tg[g] + k * CC) * M + np.arange(n_w))
                for cl in range(n_itk):
                    c = k * CC + cl
                    assert (cl % ua) % A == c % A
                    acc[..., c % A] = 0.0
                    for i in range(min(M, K)):
                        v = buf[:, regions + cl * M + i]
                        assert not np.isnan(v).any()
                        for b in range(A):
                            if i + b * M < K:
                                s = (c - b) % A
                                acc[..., s] += h[:, i + b * M] * v
                    o = c - (A - 1)
                    keep = (o >= 0) & (o < n_g)
                    if keep.any():
                        pos = ((tg + o)[:, None] * L
                               + np.arange(L)[None, :])[keep]
                        assert np.isnan(y[p][:, pos]).all()
                        y[p][:, pos] = acc[..., (c + 1) % A][:, keep]
    assert not np.isnan(y).any() and not np.isnan(state).any()
    return state, y


def _rat_case(rng, L, M, planes, T, times, C=2, blocks=2):
    """Blocks chained through rat_model with the chain's taps, each held
    against resample_poly_plain: outputs within 1e-5, state equal."""
    rs = RationalResampler(L, M, taps=chain_taps(L, M), lead_shape=(C,),
                           device="cpu")
    assert rs.kp == RAT_CASES[(L, M)][0]
    taps = rs.poly_taps.numpy()
    st = rng.standard_normal((C, 2, rs.kp - 1)).astype(np.float32)
    for _ in range(blocks):
        xs = [rng.standard_normal((C, T)).astype(np.float32)
              for _ in range(planes)]
        tails = [st[:, p] for p in range(planes)]
        got_state, got = rat_model(xs, taps, L, M, tails, times)
        want_state, want = resample_poly_plain(
            [torch.from_numpy(x) for x in xs], rs.poly_taps, L, M,
            [torch.from_numpy(t.copy()) for t in tails])
        for g, w in zip(got, want):
            _close(g, w.numpy())
        assert np.array_equal(got_state, want_state.numpy())
        st = got_state
    return st


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("rows", [1, 7, 256])
@pytest.mark.parametrize("L,M", sorted(RAT_CASES))
def test_rat_model_matches_plain(rng, L, M, rows, planes):
    """resample_rat_f32's four shapes over two chained blocks of 2 rows at
    the tile width the rule gives the path's block at `rows` rows (2
    planes, 132 SMs), with a ragged last tile (one group of times // 2 + 1
    times, the others empty) and, from 30 times a group, several chunks
    and a ragged last one: the model's outputs within 1e-5 of
    resample_poly_plain's, its state equal."""
    G = RAT_THREADS // L
    times = rat_tile_times(L, M, RAT_CASES[(L, M)][0], 2 * rows,
                           RAT_CASES[(L, M)][2])
    n_pp = G * times + times // 2 + 1
    _rat_case(rng, L, M, planes, n_pp * M, times)


@pytest.mark.parametrize("L,M,n_pp,times", [
    (24, 25, 1, 3),      # T < K-1 (25 < 52): the new state part old tail
    (125, 12, 7, 143),   # one group of 7 of 143 times, one chunk
    (50, 13, 300, 29),   # A 1: no ring; 2 taps a phase, chunks of 28
    (25, 24, 37, 2),     # two times a group, 2 tiles
])
def test_rat_model_edges(rng, L, M, n_pp, times):
    _rat_case(rng, L, M, 2, n_pp * M, times)


@pytest.mark.parametrize("planes", [1, 2])
def test_rat_model_state_only(rng, planes):
    """T = 0: the launch only copies the tail into the new state, which
    equals the old one."""
    st = _rat_case(rng, 125, 12, planes, 0, 1, blocks=1)
    assert st.shape == (2, 2, 50)


@pytest.mark.parametrize("M,K", [(12, 51), (13, 2), (24, 51), (25, 53),
                                 (12, 12), (12, 13), (5, 51)])
@pytest.mark.parametrize("times", [1, 2, 7, 143])
def test_rat_ring_reads_every_tap_in_order(M, K, times):
    """Each stored output adds taps j = 0 .. K-1 in order (resample_poly_f32's
    order), tap j times sample o M + j of the group's stream, and every
    output time of the group is stored once."""
    stored = rat_ring_reads(M, K, times)
    assert sorted(stored) == list(range(times))
    for o, reads in stored.items():
        assert reads == [(j, o * M + j) for j in range(K)]


@pytest.mark.parametrize("L,n_pp,times", [
    (125, 2000, 286), (125, 240, 1), (50, 400, 50), (25, 1000, 6),
    (25, 120, 1), (24, 1000, 100), (24, 1001, 100), (25, 3, 7),
    (125, 5, 2)])
def test_rat_jobs_cover_each_output_once(L, n_pp, times):
    """The grid's tiles, groups and phases store every (output time,
    phase) of a row-plane exactly once."""
    jobs = rat_jobs(L, n_pp, times)
    assert len(jobs) == n_pp * L
    assert sorted(jobs) == [(t, r) for t in range(n_pp) for r in range(L)]


@pytest.mark.parametrize("L,M", sorted(RAT_CASES))
def test_rat_sample_loads_are_conflict_free(L, M):
    """Every warp's sample load (thread k: phase k mod L, group k // L,
    from its first word, rat_lane_words) reads distinct words from distinct
    banks: the regions' pad to q_max + 1 (mod 32) puts consecutive groups
    on one run of banks."""
    K = RAT_CASES[(L, M)][0]
    G, sp = RAT_THREADS // L, rat_region(L, M, K)
    assert sp % 32 == ((L - 1) * M // L + 1) % 32
    base = rat_lane_words(L, M, K)
    for w in range(RAT_THREADS // 32):
        ks = [k for k in range(32 * w, 32 * w + 32) if k // L < G]
        for c in (0, 1, 7):
            for i in range(min(M, K)):
                words = {base[k // L, k % L] + c * M + i for k in ks}
                assert len({a % 32 for a in words}) == len(words)


def test_rat_tile_widths():
    """The tile rule at the paths' blocks (the kernel's header quotes
    them): (output times a group, tiles a row-plane) on 132 SMs."""
    def grid(L, M, K, rows, n_pp):
        t = rat_tile_times(L, M, K, 2 * rows, n_pp)
        return t, -(-n_pp // (RAT_THREADS // L * t))

    assert grid(125, 12, 51, 256, 2000) == (286, 7)
    assert grid(125, 12, 51, 1, 240) == (1, 240)
    assert grid(50, 13, 2, 256, 400) == (50, 4)
    for L, M, K in ((25, 24, 51), (24, 25, 53)):
        assert grid(L, M, K, 7, 1000) == (6, 34)
        assert grid(L, M, K, 7, 120) == (1, 24)
        assert grid(L, M, K, 448, 1000) == (100, 2)


def test_rat_model_follows_the_kernel_source():
    """The model's constants, tile rule, chunks, regions, ring, seam and
    stores are the kernel's, and its instances are the route's."""
    src = RAT_SRC.read_text()
    for line in [
            f"constexpr int kThreads = {RAT_THREADS};",
            f"constexpr int kRuleBlocks = {RAT_RULE_BLOCKS};",
            f"constexpr int kChunkWords = {RAT_CHUNK_WORDS};",
            f"constexpr int kTimesA = {RAT_TIMES_A};",
            "return (K + M - 1) / M;",
            "return ring_len(M, K) >= 3 ? ring_len(M, K) : 4;",
            "return unroll_len(M, K) * (kChunkWords / (M * unroll_len(M, K))",
            "constexpr int kTapStride(int K) { return K | 1; }",
            "return n + ((t - n) % 32 + 32) % 32;",
            "return pad_to(chunk_iters(M, K) * M + q_max(L, M), "
            "q_max(L, M) + 1);",
            # tile_times
            "const long long want = G * n_sm * kRuleBlocks;",
            "long long per = (row_planes * n_pp + want - 1) / want;",
            "const long long most = (long long)kTimesA * ring_len(M, K);",
            "const long long tiles = (n_pp + G * per - 1) / (G * per);",
            "return (int)((n_pp + tiles * G - 1) / (tiles * G));",
            # the state, the chunks, the seam
            "st[j] = v < k1 ? tail[v] : x[v - k1];",
            "const int n_it = (times + A - 1 + UA - 1) / UA * UA;",
            "const int n_w = min(CC, n_it - k * CC) * M + qm;",
            "const long long v = v0 + w;",
            "const bool ok = v < n_in;",
            "cp_async(dst + g * sp + w,",
            "v < k1 ? tail + v : x + (ok ? v - k1 : 0), ok);",
            # threads and the ring
            "const int r = threadIdx.x % L;",
            "const int g = threadIdx.x / L;",
            "h[j] = active ? s_tap[r * ks + j] : 0.0f;",
            "const float* p = s_buf + (k & 1) * G * sp + g * sp + q_r;",
            "for (int c0 = 0; c0 < n_itk; c0 += UA, p += UA * M) {",
            "acc[a % A] = 0.0f;",
            "const float v = p[a * M + i];",
            "const int s = (a - b + UA * A) % A;",
            "acc[s] = fmaf(h[i + b * M], v, acc[s]);",
            "const int o0 = k * CC + c0 - (A - 1);",
            "float* ys = yo + (long long)o0 * L;",
            "if ((unsigned)(o0 + a) < (unsigned)n_g)",
            "ys[a * L] = acc[(a + 1) % A];"]:
        assert line in src, line
    for M, K in cuda_resample.RAT_SHAPES:
        assert f"(M == {M} && K == {K})" in src
        assert f"launch<{M}, {K}>(" in src
    assert cuda_resample.RAT_MIN_L == 24
    assert cuda_resample.RAT_MAX_L == RAT_THREADS


# -- resample_dec_f32 ------------------------------------------------------

DEC_SRC = CSRC / "resample_dec.cu"
# resample_dec_f32's tile (output times a warp's tile, rows a chunk), warps
# a block at most, transpose-tile row, partials ring and the piece rule's
# blocks an SM
DEC_TILE, DEC_MAX_WARPS = 32, 16
DEC_TILE_STRIDE, DEC_OUT_RING, DEC_RULE_BLOCKS = 36, 128, 4
# the instances, (L, M, K): (tap rows a segment, columns a lane, chunk
# buffers, blocks an SM the registers must allow, the chain whose RX head
# it is, its block's output times a row at the path's shape); the L 1
# instances, the K2239 D50 head (GMSK2K's) and SSB's K5597 D125 head (USB's),
# are the strided FIR's (ops/cuda_fir.route), which no resampler route names
DEC_CASES = {(3, 125, 2091): (9, 2, 3, 2, "DMR", 1600),
             (3, 125, 349): (3, 4, 3, 2, "M17", 1600),
             (12, 125, 523): (5, 4, 3, 2, "MMDVM", 2000),
             (2, 25, 105): (5, 1, 4, 8, "4FSK10KFM", 8000),
             (1, 50, 2239): (15, 2, 4, 4, "GMSK2K", 4000),
             (1, 125, 5597): (15, 2, 3, 2, "USB", 1600)}
# the instances whose pieces the waves rule picks (piece_waves), the
# others' piece_len; and the most pieces a row-plane it tries
DEC_WAVES = {(1, 50, 2239), (1, 125, 5597)}
DEC_MAX_PIECES = 64
# the taps-in-order instances (QRL_DEC_SEQ_INSTANCES), (L, M, K): (rows a
# lane, rows of M a chunk, chunk buffers, blocks an SM the registers must
# allow, the chain whose RX head it is, its block's output times a row at
# the path's shape): the 2/25 head of 2FSK10K and GMSK10K, whose card run
# must keep the CPU path's bits (tests/test_torch_cuda.py
# test_new_mode_on_card_matches_cpu[GMSK10K])
SEQ_CASES = {(2, 25, 561): (1, 4, 2, 8, "2FSK10K", 8000)}
SEQ_MAX_PIECES = 256
# seq_piece at the 2/25 head's shapes: (rows, n_pp, slots, piece, pieces)
# at 6 blocks an SM (the form's 33,984 bytes of shared memory a block)
SEQ_PIECE_CASES = [
    (256, 8000, 792, 164, 49),    # the sweep's 2FSK10K / GMSK10K
    (2048, 8000, 792, 1334, 6),   # 2048 rows: 64 groups x 2 planes
    (2, 400, 792, 2, 200),        # the card test's 2 rows: one wave
    (1, 5000, 792, 22, 228),      # one radio's 125,000-sample block
    (4, 0, 792, 1, 1)]            # no output
# every instance of resample_dec_f32, either form
DEC_ALL = {**DEC_CASES, **SEQ_CASES}


def dec_layout(L, M, K):
    """(tap rows a segment AS, columns a lane CW, segments S a phase,
    column groups G of 32 CW columns, warps a phase G S, warps L G S) of
    an instance: A = ceil(K/M) tap rows a phase, each row starting q_r
    samples into a row of M."""
    AS, CW = DEC_CASES[(L, M, K)][:2]
    S = -(-(-(-K // M)) // AS)
    G = -(-M // (32 * CW))
    return AS, CW, S, G, G * S, L * G * S


def dec_piece_len(row_planes, n_pp, n_sm=H100_SMS):
    """resample_dec_f32's output times a block (piece_len): a whole
    row-plane, or whole chunks evened over the row where the row-planes
    alone give fewer than DEC_RULE_BLOCKS blocks an SM."""
    if n_pp <= 0:
        return 1
    per = -(-row_planes * n_pp // (n_sm * DEC_RULE_BLOCKS))
    per = -(-per // DEC_TILE) * DEC_TILE
    if per >= n_pp:
        return n_pp
    pieces = -(-n_pp // per)
    return -(-(-(-n_pp // pieces)) // DEC_TILE) * DEC_TILE


def dec_piece_waves(row_planes, n_pp, a_last, slots):
    """resample_dec_f32's waves rule (piece_waves): of the pieces of whole
    chunks, the count that least costs waves of `slots` resident blocks
    times chunks a block (its piece and the a_last rows before it); the
    fewest pieces on a tie."""
    if n_pp <= 0:
        return 1
    best, best_piece = None, n_pp
    for p in range(1, min(DEC_MAX_PIECES, -(-n_pp // DEC_TILE)) + 1):
        piece = min(n_pp, -(-(-(-n_pp // p)) // DEC_TILE) * DEC_TILE)
        pieces = -(-n_pp // piece)
        cost = -(-row_planes * pieces // slots) * \
            -(-(piece + a_last) // DEC_TILE)
        if best is None or cost < best:
            best, best_piece = cost, piece
    return best_piece


def dec_taps(taps, M, r, g, a0, AS, CW):
    """Warp (phase r, column group g, segment from row a0)'s registers:
    h[a, lane, k] = tf_r[(a0 + a) M + c], c = 32 CW g + lane + 32 k, zero
    past K or M."""
    K = taps.shape[1]
    c = 32 * CW * g + np.arange(32)[:, None] + 32 * np.arange(CW)[None, :]
    u = (a0 + np.arange(AS))[:, None, None] * M + c[None]
    ok = (c[None] < M) & (u < K)
    return np.where(ok, taps[r][np.clip(u, 0, K - 1)], np.float32(0.0))


def dec_lane_sum(v):
    """Lane sums in the kernel's order, lanes 0 .. 31 from 0.0f; v (...,
    32) float32."""
    out = np.zeros(v.shape[:-1], np.float32)
    for lane in range(32):
        out = out + v[..., lane]
    return out


def dec_model(xs, taps, L, M, tails, piece=None):
    """resample_dec_f32's blocks in numpy, float32 in the kernel's order
    (each product rounded before its add: the card fuses them). Block
    (piece, row, plane) stages chunk j (DEC_TILE rows of M samples from
    row t_lo + j DEC_TILE, a lead of 0-3 words putting x's words on 16-byte
    boundaries, then the q_max + lane columns past M of the next row that
    the phases read; zeros outside [0, K-1+T), NaN in the rest of the
    buffer) into buffer j mod R (the instance's chunk buffers): chunks
    0 .. R - 2 first, chunk j + R - 1 after the barrier of chunk j; warp
    (r, g, s) computes its segment's outputs R0 + o - s AS from rows R0 ..
    R0 + DEC_TILE + AS - 2 of buffers j and j + 1, each row read from q_r
    on (one row fewer where the last segments' last row is empty and S <=
    2; lanes past M read the next row's samples against zero taps), and
    sums its lanes (dec_lane_sum) into its ring of DEC_OUT_RING partials;
    after the next barrier the block adds each finished (output, phase)'s
    G S partials in order w = g S + s. Vectorised over rows and lanes.
    Returns (state (C, 2, K-1), outputs (planes, C, n)), asserting that
    every output is written once and no NaN word is read. The
    taps-in-order instances (SEQ_CASES) are seq_model's."""
    if (L, M, taps.shape[1]) in SEQ_CASES:
        return seq_model(xs, taps, L, M, tails, piece)
    planes, (C, T), K = len(xs), xs[0].shape, taps.shape[1]
    k1, n_pp = K - 1, T // M
    AS, CW, S, G, WP, W = dec_layout(L, M, K)
    ring = DEC_CASES[(L, M, K)][2]
    A = -(-K // M)
    assert W <= DEC_MAX_WARPS and W * 32 >= DEC_TILE * L
    a_last = (S - 1) * AS
    assert a_last + 2 * DEC_TILE <= DEC_OUT_RING
    shorten = A - a_last < AS and S <= 2
    piece = piece or dec_piece_len(C * planes, n_pp)
    n_pieces = -(-n_pp // piece) if n_pp else 1
    staged = DEC_TILE * M + (L - 1) * M // L + 32 * CW * G - M
    bw = (staged + 6) // 4 * 4
    y = np.full((planes, C, n_pp * L), np.nan, np.float32)
    state = np.full((C, 2, k1), np.nan, np.float32)
    col = np.arange(32)[:, None] + 32 * np.arange(CW)[None, :]
    for p in range(planes):
        xc = np.concatenate([tails[p], xs[p]], axis=1)
        n_in = k1 + T
        state[:, p] = xc[:, T:]
        if planes == 1:
            state[:, 1] = 0.0
        for pc in range(n_pieces):
            t_lo = pc * piece
            if t_lo >= n_pp:
                continue
            t_hi = min(n_pp, t_lo + piece)
            n_c = -(-(t_hi - t_lo + a_last) // DEC_TILE)
            vb = t_lo * M
            lead = (vb - k1) % 4
            assert (DEC_TILE * M) % 4 == 0
            bufs = [np.full((C, bw), np.nan, np.float32)
                    for _ in range(ring)]

            def stage(j):
                v = vb + j * DEC_TILE * M - lead + np.arange(
                    -(-(lead + staged) // 4) * 4)
                assert (v[0] - k1) % 4 == 0 and len(v) <= bw
                ok = (v >= 0) & (v < n_in)
                bufs[j % ring][:, :len(v)] = np.where(
                    ok, xc[:, np.clip(v, 0, n_in - 1)], np.float32(0.0))

            for j in range(ring - 1):
                if j <= n_c:
                    stage(j)
            part = np.full((L, WP, C, DEC_OUT_RING), np.nan, np.float32)

            def finish(j):
                t = t_lo + j * DEC_TILE - a_last + np.arange(DEC_TILE)
                t = t[(t >= t_lo) & (t < t_hi)]
                for r in range(L):
                    v = part[r, 0][:, t % DEC_OUT_RING]
                    for w in range(1, WP):
                        v = v + part[r, w][:, t % DEC_OUT_RING]
                    assert not np.isnan(v).any()
                    assert np.isnan(y[p][:, t * L + r]).all()
                    y[p][:, t * L + r] = v

            for j in range(n_c):
                if j + ring - 1 <= n_c:
                    stage(j + ring - 1)
                if j > 0:
                    finish(j - 1)
                pa, pb = bufs[j % ring], bufs[(j + 1) % ring]
                for r in range(L):
                    q = r * M // L
                    for g in range(G):
                        for s in range(S):
                            hw = dec_taps(taps, M, r, g, s * AS, AS, CW)
                            nr = AS - 1 if shorten and s == S - 1 else AS
                            acc = np.zeros((C, DEC_TILE, 32), np.float32)
                            for i in range(DEC_TILE + nr - 1):
                                buf, base = (pa, i * M) if i < DEC_TILE \
                                    else (pb, (i - DEC_TILE) * M)
                                xv = buf[:, lead + q + 32 * CW * g + base
                                         + col]
                                assert not np.isnan(xv).any()
                                a = np.arange(nr)
                                a = a[(i - a >= 0) & (i - a < DEC_TILE)]
                                for k in range(CW):
                                    acc[:, i - a] += hw[a, :, k] * \
                                        xv[:, None, :, k]
                            t = t_lo + j * DEC_TILE + np.arange(DEC_TILE) \
                                - s * AS
                            part[r, g * S + s][:, t % DEC_OUT_RING] = \
                                dec_lane_sum(acc)
            finish(n_c - 1)
    assert not np.isnan(y).any() and not np.isnan(state).any()
    return state, y


def seq_words(L, M, CR):
    """Words a row of a chunk of the taps-in-order form: CR rows of M and
    the q_max samples phase L-1 reads past them."""
    return CR * M + (L - 1) * M // L


def seq_stride(L, M, CR):
    """A chunk buffer's row stride: the least 2 x odd >= seq_words."""
    return ((seq_words(L, M, CR) + 1) // 2 | 1) * 2


def seq_taps(taps, M):
    """The taps-in-order form's transposed taps in shared memory, (L, M,
    AP): [r, c, a] = tf_r[a M + c], zero past K, AP = A padded to whole
    float4s."""
    L, K = taps.shape
    A = -(-K // M)
    AP = -(-A // 4) * 4
    a = np.arange(AP)[None, :]
    c = np.arange(M)[:, None]
    u = a * M + c
    ok = (a < A) & (u < K)
    return np.where(ok[None], taps[:, np.clip(u, 0, K - 1)], np.float32(0))


def seq_slot_taps(M, K):
    """The taps-in-order form's (slot, column) -> tap index table, (A, M):
    [a, c] = a M + c, -1 where no tap meets (slot A - 1 past K)."""
    A = -(-K // M)
    u = np.arange(A)[:, None] * M + np.arange(M)[None, :]
    return np.where(u < K, u, -1)


def seq_piece(units, n_pp, a_last, CR, slots):
    """The taps-in-order form's output times a block (seq_piece): of the
    piece counts, the one that least costs waves of `slots` blocks times
    the rows a block walks (its piece and a_last rows, in chunks of CR);
    pieces whole multiples of 2; the fewest pieces on a tie."""
    if n_pp <= 0:
        return 1
    best, best_piece = None, n_pp
    for p in range(1, min(n_pp, SEQ_MAX_PIECES) + 1):
        piece = min(n_pp, -(-(-(-n_pp // p)) // 2) * 2)
        pieces = -(-n_pp // piece)
        cost = -(-units * pieces // slots) * -(-(piece + a_last) // CR)
        if best is None or cost < best:
            best, best_piece = cost, piece
    return best_piece


def seq_model(xs, taps, L, M, tails, piece=None):
    """resample_dec_f32's taps-in-order form in numpy, float32 (each
    product rounded before its add: the card fuses them). Block (piece,
    group of 32 RPL rows, plane) stages chunk j (CR rows of M from row
    t_lo + j CR, seq_words per row; zeros past K-1+T, NaN in the rest of
    the buffer) into buffer j mod R: chunks 0 .. R - 2 first, chunk j + R
    - 1 after the barrier of chunk j. Warp r walks the rows m of its piece
    and the A - 1 after it, keeping A slots (slot a: output m - a, at tap
    row a): column c of row m, the sample xc[m M + q_r + c], meets tap
    tf_r[a M + c] of each slot a (seq_slot_taps; the last only for c < K -
    (A-1) M); after the
    row slot A - 1 is output m - (A - 1), stored if it is in the piece,
    and the slots move up, slot 0 from 0. Asserts that every stored output
    added taps 0 .. K-1 once each, in order, that each output is written
    once and that no NaN word is read. Vectorised over rows. Returns
    (state (C, 2, K-1), outputs (planes, C, n))."""
    planes, (C, T), K = len(xs), xs[0].shape, taps.shape[1]
    RPL, CR, R, B, _, _ = SEQ_CASES[(L, M, K)]
    k1, n_pp = K - 1, T // M
    A = -(-K // M)
    KL = K - (A - 1) * M
    W, RS = seq_words(L, M, CR), seq_stride(L, M, CR)
    assert RS >= W and RS % 2 == 0 and (RS // 2) % 2 == 1
    st_tab = seq_slot_taps(M, K)
    tt = seq_taps(taps, M)
    n_groups = -(-C // (32 * RPL))
    if piece is None:
        piece = seq_piece(n_groups * planes, n_pp, A - 1, CR, H100_SMS * B)
    n_pieces = -(-n_pp // piece) if n_pp else 1
    y = np.full((planes, C, n_pp * L), np.nan, np.float32)
    state = np.full((C, 2, k1), np.nan, np.float32)
    for p in range(planes):
        xc = np.concatenate([tails[p], xs[p]], axis=1)
        n_in = k1 + T
        state[:, p] = xc[:, T:]
        if planes == 1:
            state[:, 1] = 0.0
        for pc in range(n_pieces):
            t_lo = pc * piece
            if t_lo >= n_pp:
                continue
            t_hi = min(n_pp, t_lo + piece)
            n_c = -(-(t_hi - t_lo + A - 1) // CR)
            bufs = [np.full((C, RS), np.nan, np.float32) for _ in range(R)]

            def stage(j):
                v = t_lo * M + j * CR * M + np.arange(W)
                bufs[j % R][:, :W] = np.where(
                    v < n_in, xc[:, np.clip(v, 0, n_in - 1)],
                    np.float32(0.0))

            for j in range(R - 1):
                if j < n_c:
                    stage(j)
            acc = np.zeros((L, C, A), np.float32)
            # each slot's next tap, -1 for the slots of outputs before t_lo
            nxt = np.full((L, A), -1, np.int64)
            nxt[:, 0] = 0
            for j in range(n_c):
                if j + R - 1 < n_c:
                    stage(j + R - 1)
                buf = bufs[j % R]
                for r in range(L):
                    q = r * M // L
                    for k in range(CR):
                        m = t_lo + j * CR + k
                        for c in range(M):
                            xv = buf[:, k * M + q + c]
                            assert not np.isnan(xv).any()
                            na = A if c < KL else A - 1
                            u = st_tab[:na, c]
                            assert (u >= 0).all()
                            h = tt[r, c, :na]
                            assert np.array_equal(h, taps[r, u])
                            acc[r, :, :na] += h[None, :] * xv[:, None]
                            live = nxt[r, :na] >= 0
                            assert (nxt[r, :na][live] ==
                                    (np.arange(na) * M + c)[live]).all()
                            nxt[r, :na][live] += 1
                        t = m - (A - 1)
                        if t_lo <= t < t_hi:
                            assert nxt[r, A - 1] == K
                            assert np.isnan(y[p][:, t * L + r]).all()
                            y[p][:, t * L + r] = acc[r, :, A - 1]
                        acc[r, :, 1:] = acc[r, :, :-1].copy()
                        acc[r, :, 0] = 0.0
                        nxt[r, 1:] = nxt[r, :-1].copy()
                        nxt[r, 0] = 0
    assert not np.isnan(y).any() and not np.isnan(state).any()
    return state, y


def dec_chain_taps(L, M, K):
    """The chain's phase taps at a resample_dec_f32 instance (its RX head
    through the registry)."""
    rs = registry.rx_chain(DEC_ALL[(L, M, K)][4], device="cpu").resamp
    assert (rs.L, rs.M, rs.kp) == (L, M, K)
    return rs.poly_taps


def _dec_case(rng, L, M, K, planes, T, piece=None, C=2, blocks=2,
              tail_len=None):
    """Blocks chained through dec_model with the chain's taps, each held
    against resample_poly_plain: outputs within 1e-5, state equal."""
    taps = dec_chain_taps(L, M, K)
    st = rng.standard_normal((C, 2, K - 1)).astype(np.float32)
    for _ in range(blocks):
        xs = [rng.standard_normal((C, T)).astype(np.float32)
              for _ in range(planes)]
        tails = [st[:, p] for p in range(planes)]
        got_state, got = dec_model(xs, taps.numpy(), L, M, tails, piece)
        want_state, want = resample_poly_plain(
            [torch.from_numpy(x) for x in xs], taps, L, M,
            [torch.from_numpy(t.copy()) for t in tails])
        for g, w in zip(got, want):
            _close(g, w.numpy())
        assert np.array_equal(got_state, want_state.numpy())
        st = got_state
    return st


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("L,M,K", sorted(DEC_ALL))
def test_dec_model_matches_plain(rng, L, M, K, planes):
    """resample_dec_f32's instances with their chains' taps over two
    chained blocks of 2 rows, in pieces of two chunks and an odd tail
    (the last piece 2 chunks + 5 output times; every chunk's lead): the
    model's outputs within 1e-5 of resample_poly_plain's, its state
    equal."""
    n_pp = 2 * DEC_TILE + 5 + 2 * DEC_TILE
    _dec_case(rng, L, M, K, planes, n_pp * M, piece=2 * DEC_TILE)


@pytest.mark.parametrize("L,M,K,n_pp,piece", [
    (3, 125, 2091, 7, None),     # T < K-1: the new state part old tail
    (12, 125, 523, 240, None),   # MMDVM's headless block, pieces of 32
    (2, 25, 561, 33, 32),        # a piece of one output time
    (1, 50, 2239, 101, None),    # one piece: the row, 101 output times
    (1, 125, 5597, 40, None),    # SSB's head, T < K-1: one chunk and a bit
    (2, 25, 105, 64, 64),        # whole chunks, no ragged piece
])
def test_dec_model_edges(rng, L, M, K, n_pp, piece):
    _dec_case(rng, L, M, K, 2, n_pp * M, piece=piece)


@pytest.mark.parametrize("planes", [1, 2])
def test_dec_model_state_only(rng, planes):
    """T = 0: the launch only copies the tail into the new state, which
    equals the old one."""
    st = _dec_case(rng, 3, 125, 349, planes, 0, blocks=1)
    assert st.shape == (2, 2, 348)


@pytest.mark.parametrize("L,M,K", sorted(DEC_ALL))
def test_dec_segments_read_every_tap_once(L, M, K):
    """The warps' registers hold every tap of every phase once, tap j at
    row j // M and column j % M of the phase's rows, and zeros elsewhere;
    rows of the last segment past a phase's taps are zero. In the
    taps-in-order form a row's (slot, column) pairs (seq_slot_taps) meet
    each tap once, tap j at slot j // M, column j % M, and the transposed
    taps in shared memory (seq_taps) hold each tap once, at [r, j % M,
    j // M]."""
    taps = np.arange(1, L * K + 1, dtype=np.float32).reshape(L, K)
    if (L, M, K) in SEQ_CASES:
        tab = seq_slot_taps(M, K)
        assert sorted(tab[tab >= 0]) == list(range(K))
        tt = seq_taps(taps, M)
        for r in range(L):
            assert sorted(tt[r][tt[r] != 0]) == list(taps[r])
        for j in (0, K // 2, K - 1):
            assert tab[j // M, j % M] == j
            assert all(tt[r, j % M, j // M] == taps[r, j] for r in range(L))
        return
    AS, CW, S, G, WP, W = dec_layout(L, M, K)
    for r in range(L):
        h = np.stack([np.concatenate([dec_taps(taps, M, r, g, s * AS, AS,
                                               CW) for s in range(S)])
                      for g in range(G)])   # (G, S AS, 32, CW)
        vals = h[h != 0]
        assert sorted(vals) == list(taps[r])
        for j in (0, K // 2, K - 1):
            c = j % M
            assert h[c // (32 * CW), j // M, c % 32,
                     (c % (32 * CW)) // 32] == taps[r, j]


@pytest.mark.parametrize("L,M,K", sorted(DEC_ALL))
def test_dec_model_sums_integers_exactly(rng, L, M, K):
    """Integer taps and samples, whose sums are exact in f32: the model's
    outputs equal resample_poly_plain's bit for bit over two chained
    blocks, at the path's pieces and at pieces of one chunk (no tap is
    lost or counted twice at a seam, a row's end or a piece's edge)."""
    for piece in (None, DEC_TILE):
        taps = rng.integers(-3, 4, (L, K)).astype(np.float32)
        st = rng.integers(-3, 4, (3, 2, K - 1)).astype(np.float32)
        for _ in range(2):
            xs = [rng.integers(-3, 4, (3, 75 * M)).astype(np.float32)
                  for _ in range(2)]
            tails = [st[:, p] for p in range(2)]
            got_state, got = dec_model(xs, taps, L, M, tails, piece)
            want_state, want = resample_poly_plain(
                [torch.from_numpy(x) for x in xs], torch.from_numpy(taps),
                L, M, [torch.from_numpy(t.copy()) for t in tails])
            for g, w in zip(got, want):
                assert np.array_equal(g, w.numpy())
            assert np.array_equal(got_state, want_state.numpy())
            st = got_state


@pytest.mark.parametrize("L,n_pp,rows,piece,pieces", [
    (3, 1600, 2048, 1600, 1),    # DMR / M17 at the path: a row a block
    (12, 2000, 256, 1024, 2),    # MMDVM RX at 256 rows
    (12, 240, 1, 32, 8),         # MMDVM's headless block
    (2, 8000, 256, 4000, 2),     # 4FSK10KFM at 256 rows
    (1, 4000, 2048, 1344, 3)])   # GMSK2K's head: the waves rule
def test_dec_piece_widths(L, n_pp, rows, piece, pieces):
    """The piece rule at the paths' blocks (2 planes, 132 SMs); the K2239
    D50 head's waves rule at 5 resident blocks an SM."""
    if L == 1:
        got = dec_piece_waves(2 * rows, n_pp, 30, H100_SMS * 5)
    else:
        got = dec_piece_len(2 * rows, n_pp)
    assert (got, -(-n_pp // got)) == (piece, pieces)


@pytest.mark.parametrize("rows,n_pp,slots,piece,pieces", [
    (2048, 4000, 660, 1344, 3),   # GMSK2K: 18.6 waves of 43 chunks
    (2048, 4000, 528, 4000, 1),   # 4 blocks an SM: 7.8 waves of rows
    (256, 20000, 660, 2240, 9),   # 2FSK2K: 6.98 waves of 71 chunks
    (256, 20000, 528, 20000, 1),  # 512 rows on 528 slots: one wave
    (32, 2000, 660, 224, 9),      # the mixed NBFM head: one wave
    (2048, 1600, 264, 1600, 1),   # SSB's head, 2 blocks an SM: 15.5 waves
    (256, 1600, 264, 1600, 1),    # the sweep's USB / LSB: 1.9 waves
    (1, 1600, 264, 32, 50),       # one radio's block: pieces of a chunk
    (1, 101, 660, 32, 4),         # a row: pieces of one chunk
    (4096, 0, 660, 1, 1)])        # no output
def test_dec_piece_waves(rows, n_pp, slots, piece, pieces):
    """The waves rule at the L 1 heads' shapes (2 planes, segments 3 x 15
    rows: a_last 30; K2239 D50 at 5 resident blocks an SM, SSB's K5597
    D125 at 2), against a brute count of waves x chunks."""
    got = dec_piece_waves(2 * rows, n_pp, 30, slots)
    assert (got, -(-n_pp // got) if n_pp else 1) == (piece, pieces)
    if n_pp:
        def cost(pc):
            return -(-2 * rows * -(-n_pp // pc) // slots) * \
                -(-(pc + 30) // DEC_TILE)
        assert all(cost(got) <= cost(pc) for pc in
                   range(DEC_TILE, n_pp + DEC_TILE, DEC_TILE)
                   if -(-n_pp // pc) <= DEC_MAX_PIECES)


@pytest.mark.parametrize("rows,n_pp,slots,piece,pieces", SEQ_PIECE_CASES)
def test_seq_piece_widths(rows, n_pp, slots, piece, pieces):
    """The taps-in-order form's rule (seq_piece) at the 2/25 head's shapes
    (2 planes, groups of 32 rows, 22 rows of slots to fill, chunks of 4
    rows), against a brute count of waves x rows a block."""
    L, M, K = 2, 25, 561
    RPL, CR = SEQ_CASES[(L, M, K)][:2]
    units = -(-rows // (32 * RPL)) * 2
    got = seq_piece(units, n_pp, 22, CR, slots)
    assert (got, -(-n_pp // got) if n_pp else 1) == (piece, pieces)
    if n_pp:
        def cost(pc):
            return -(-units * -(-n_pp // pc) // slots) * -(-(pc + 22) // CR)
        assert all(cost(got) <= cost(pc) for pc in range(2, n_pp + 2, 2)
                   if -(-n_pp // pc) <= SEQ_MAX_PIECES)


def test_seq_model_follows_the_kernel_source():
    """The taps-in-order model's constants, instances, staging, slots and
    sum order are the kernel's."""
    src = DEC_SRC.read_text()
    for line in [
            f"constexpr int kSeqMaxPieces = {SEQ_MAX_PIECES};",
            "return CR * M + q_max(L, M);",
            "return ((seq_words(L, M, CR) + 1) / 2 | 1) * 2;",
            "return (tap_rows(M, K) + 3) / 4 * 4;",
            "return (long long)L * M * seq_tap_pad(M, K) +",
            "(long long)R * 32 * RPL * seq_stride(L, M, CR);",
            # seq_piece
            "piece = (piece + 1) / 2 * 2;",
            "const long long cost = waves * ((piece + a_last + CR - 1) / CR);",
            "const int piece = seq_piece(n_groups * planes, n_pp, A - 1, CR,",
            # the taps, the chunks and the staging
            "s_taps[i] = a < A && u < K ? taps[(size_t)r * K + u] : 0.0f;",
            "const int n_c = (t_hi - t_lo + A - 1 + CR - 1) / CR;",
            "const long long v0 = vb + (long long)j * CR * M;",
            "const bool ok = row < C && ve < n_in;",
            "if (j < n_c) stage(j);",
            "if (j + R - 1 < n_c) stage(j + R - 1);",
            "asm volatile(\"cp.async.wait_group %0;\\n\" ::\"n\"(R - 2) : \"memory\");",
            # the slots
            "constexpr int KL = K - (A - 1) * M;  // columns of the last tap row",
            "const float* b = s_buf + (j % R) * (GR * RS) + lane * RS + q_r;",
            "for (int c = 0; c < KL; ++c) {",
            "seq_column<A, RPL, AP>(tp + c * AP, xv, acc);",
            "for (int c = KL; c < M; ++c) {",
            "seq_column<A - 1, RPL, AP>(tp + c * AP, xv, acc);",
            "for (int q = 0; q < RPL; ++q) xv[q] = p[q * 32 * RS + c];",
            "acc[q][4 * a4 + i] = fmaf(hv[i], x[q], acc[q][4 * a4 + i]);",
            "const int t = t_lo + j * CR + k - (A - 1);",
            "if (t >= t_lo && t < t_hi) {",
            "for (int a = A - 1; a > 0; --a) acc[q][a] = acc[q][a - 1];",
            "acc[q][0] = 0.0f;"]:
        assert line in src, line
    for (L, M, K), (RPL, CR, R, B, _, _) in SEQ_CASES.items():
        assert f"X({L}, {M}, {K}, {RPL}, {CR}, {R}, {B})" in src
        assert seq_stride(L, M, CR) >= seq_words(L, M, CR)


def test_dec_model_follows_the_kernel_source():
    """The model's constants, instances, staging, ring, schedule and sum
    order are the kernel's, and its instances are the route's."""
    src = DEC_SRC.read_text()
    for line in [
            f"constexpr int kTile = {DEC_TILE};",
            f"constexpr int kMaxWarps = {DEC_MAX_WARPS};",
            f"constexpr int kTileStride = {DEC_TILE_STRIDE};",
            f"constexpr int kOutRing = {DEC_OUT_RING};",
            f"constexpr int kRuleBlocks = {DEC_RULE_BLOCKS};",
            "return (K + M - 1) / M;",
            "return (M + 32 * CW - 1) / (32 * CW);",
            "return 32 * CW * col_groups(M, CW) - M;",
            "return kTile * M + q_max(L, M) + over_cols(M, CW);",
            "return (stage_words(L, M, CW) + 6) / 4 * 4;",
            "return col_groups(M, CW) * ((tap_rows(M, K) + AS - 1) / AS);",
            "return (long long)R * buf_words(L, M, CW) +",
            "(long long)W * (kTile * kTileStride + kOutRing);",
            # piece_len
            "const long long want = (long long)n_sm * kRuleBlocks;",
            "long long per = (row_planes * n_pp + want - 1) / want;",
            "per = (per + kTile - 1) / kTile * kTile;",
            "if (per >= n_pp) return n_pp;",
            "const long long even = (n_pp + pieces - 1) / pieces;",
            "return (int)((even + kTile - 1) / kTile * kTile);",
            # piece_waves
            f"constexpr int kMaxPieces = {DEC_MAX_PIECES};",
            "const int max_p = chunks < kMaxPieces ? chunks : kMaxPieces;",
            "piece = (piece + kTile - 1) / kTile * kTile;",
            "const long long waves = (row_planes * pieces + slots - 1) / slots;",
            "const long long cost = waves * ((piece + a_last + kTile - 1) / kTile);",
            "if (best < 0 || cost < best) {",
            "piece = piece_waves((long long)C * planes, n_pp, (S - 1) * AS,",
            "(long long)n_sm * held);",
            # the state, chunks and the staging
            "st[j] = v < k1 ? tail[v] : x[v - k1];",
            "const int a_last = (S - 1) * AS;",
            "const int n_c = (t_hi - t_lo + a_last + kTile - 1) / kTile;",
            "const int lead = (int)(((vb - k1) % 4 + 4) % 4);",
            "const int n_g = (lead + stage_words(L, M, CW) + 3) / 4;",
            "const long long v0 = vb + (long long)j * kTile * M - lead;",
            "if (aligned && v >= k1 && v + 4 <= n_in) {",
            "const bool ok = vi >= 0 && vi < n_in;",
            "for (int j = 0; j < R - 1; ++j) {",
            "if (j <= n_c) stage(j);",
            "asm volatile(\"cp.async.wait_group %0;\\n\" ::\"n\"(R - 3) : \"memory\");",
            "if (j + R - 1 <= n_c) stage(j + R - 1);",
            "if (j > 0) finish(j - 1);",
            # the warps' taps and rows
            "const int r = warp / WP;",
            "const int g = (warp - r * WP) / S;",
            "const int a0 = (warp - r * WP - g * S) * AS;",
            "const int c0 = 32 * CW * g + lane;",
            "const int u = (a0 + a) * M + c;",
            "h[a][k] = c < M && u < K ? taps[(size_t)r * K + u] : 0.0f;",
            "constexpr bool shorten = tap_rows(M, K) - (S - 1) * AS < AS && S <= 2;",
            "const bool short_rows = shorten && tap_rows(M, K) - a0 < AS;",
            "const int t = w0 + i / L;",
            "const int ph = i - (i / L) * L;",
            "const int L = LC ? LC : L_rt;",
            "const int S = SC ? SC : S_rt;",
            "L == 1 ? L : 0, L == 1 ? S : 0>;",
            "const float* pa = s_buf + (j % R) * BW + lead + q_r + c0;",
            "const float* pb = s_buf + ((j + 1) % R) * BW + lead + q_r + c0;",
            "row_sums<CW, AS, AS - 1, M>(pa, pb, h, acc);",
            "for (int i = 0; i < kTile + NR - 1; ++i) {",
            "const float* p = i < kTile ? pa + i * M : pb + (i - kTile) * M;",
            "for (int k = 0; k < CW; ++k) xv[k] = p[32 * k];",
            "for (int a = 0; a < NR; ++a) {",
            "const int o = i - a;",
            "acc[o] = fmaf(h[a][k], xv[k], acc[o]);",
            "for (int o = 0; o < kTile; ++o) tile[o * kTileStride + lane] = acc[o];",
            # the lane sum, the partials ring and the window
            "float v = 0.0f;",
            "v += q.x;",
            "v += q.w;",
            "for (int o0 = 0; o0 < kTile; o0 += 32) {",
            "tile + (o0 + lane) * kTileStride);",
            "part[(t_lo + j * kTile + o0 + lane - a0) & (kOutRing - 1)] = v;",
            "const int w0 = t_lo + j * kTile - a_last;",
            "for (int w = 1; w < WP; ++w) v += p[w * kOutRing];",
            "y[(size_t)t * L + ph] = v;"]:
        assert line in src, line
    for (L, M, K), (AS, CW, R, B, _, _) in DEC_CASES.items():
        rule = int((L, M, K) in DEC_WAVES)
        assert f"X({L}, {M}, {K}, {AS}, {CW}, {R}, {B}, {rule})" in src
        _, _, S, G, WP, W = dec_layout(L, M, K)
        assert W <= DEC_MAX_WARPS and (S - 1) * AS + 2 * DEC_TILE \
            <= DEC_OUT_RING and R >= 3 and AS <= DEC_TILE
    assert set(DEC_ALL) == set(cuda_resample.DEC_SHAPES)
    assert not set(DEC_CASES) & set(SEQ_CASES)
    assert (cuda_resample.DEC_MIN_L, cuda_resample.DEC_MIN_M) == (2, 25)


def test_dec_takes_fir_long_layout_at_dmr_and_gmsk():
    """DMR's, GMSK2K's and SSB's instances take fir_long_f32's shape of
    the same FIR (ops/cuda_fir.py, csrc/fir_long.cu): segments of
    ceil(A / ceil(A/16)) rows, column groups of 64, two columns a lane;
    with its sum order (a lane's rows in order, both columns of a row,
    lanes 0 .. 31, warps g S + s) their outputs equal the per-phase
    route's (at L 1, fir_long_f32's) bit for bit."""
    for L, M, K in ((3, 125, 2091), (1, 50, 2239), (1, 125, 5597)):
        A = -(-K // M)
        S_long = -(-A // 16)
        AS, CW, S, G, _, _ = dec_layout(L, M, K)
        assert cuda_fir.fir_route(K, M) == cuda_fir.LONG_OP
        assert (AS, S, CW, G) == (-(-A // S_long), S_long, 2,
                                  -(-M // cuda_fir.LONG_GROUP_COLS))


@pytest.mark.parametrize("L,M,K,want", [
    (3, 125, 2091, DEC_OP), (3, 125, 349, DEC_OP), (12, 125, 523, DEC_OP),
    (2, 25, 105, DEC_OP), (2, 25, 561, DEC_OP),
    (3, 125, 113, OP),    # no instance at K 113
    (2, 5, 113, OP),      # the NBFM audio resampler: M below 25
    (13, 50, 3, OP),      # DSSS's RX: no instance
    (1, 50, 2239, OP),    # GMSK2K's head: an instance, but L 1
    (1, 125, 5597, OP)])  # SSB's head: the same
def test_resample_route_dec_shapes(L, M, K, want):
    """resample_dec_f32 at L >= 2, M >= 25 and an (L, M, K) it has an
    instance for, at any row count but the taps-in-order instances' few
    (test_resample_route_in_order_few_rows)."""
    for rows in (None, 1, 7, 256):
        few = (L, M, K) in cuda_resample.DEC_IN_ORDER and rows is not None \
            and rows <= cuda_resample.IN_ORDER_FEW_ROWS
        assert route(L, M, K, rows) == (OP if few else want)


@pytest.mark.parametrize("rows,want", [
    (1, OP), (2, OP), (64, OP),          # one radio, the card test, 64
    (65, DEC_OP), (256, DEC_OP),         # the sweep's 256 rows
    (None, DEC_OP)])
def test_resample_route_in_order_few_rows(rows, want):
    """The 2/25 K561 head (the taps-in-order instance of resample_dec_f32)
    takes resample_poly_f32, whose bits it keeps, on calls of at most
    IN_ORDER_FEW_ROWS rows (faster there in turns), resample_dec_f32 on
    more."""
    assert (2, 25, 561) in cuda_resample.DEC_IN_ORDER
    assert cuda_resample.IN_ORDER_FEW_ROWS == 64
    assert route(2, 25, 561, rows) == want


@pytest.mark.parametrize("L,M,K,rows,want", [
    (4, 1, 12, 1, OP), (2, 1, 46, 1, OP), (6, 1, 45, 1, OP),
    (5, 1, 51, 1, OP),
    (4, 1, 12, 7, UP_OP), (2, 1, 46, 7, X2_OP), (6, 1, 45, 7, UP_OP),
    (4, 1, 12, 256, UP_OP), (2, 1, 46, 256, X2_OP),
    (4, 1, 12, None, UP_OP), (2, 1, 46, None, X2_OP),
    (125, 1, 17, 1, UP_OP),   # FreeDvMod's x125: resample_up_f32 wins
    (7, 1, 45, 1, UP_OP),     # above FEW_ROWS_MAX_L
    (5, 2, 45, 1, UP_OP),     # M 2
    (125, 12, 51, 1, RAT_OP)])
def test_resample_route_few_rows(L, M, K, rows, want):
    """At M 1 and L up to FEW_ROWS_MAX_L, calls of FEW_ROWS_MAX rows or
    fewer go to resample_poly_f32 (the net path's L4 K12 and L2 K46, the
    mixer's L6 K45 at one row), more rows to resample_up_f32 or
    resample_x2_f32."""
    assert route(L, M, K, rows) == want
    assert (cuda_resample.FEW_ROWS_MAX,
            cuda_resample.FEW_ROWS_MAX_L) == (1, 6)


@pytest.mark.parametrize("mode", ["M17", "DMR", "MMDVM", "4FSK10KFM",
                                  "2FSK10K"])
def test_chains_record_resample_dec(rng, mode):
    """The five RX chains built through both registries on the CPU, 2 rows,
    two blocks of IqPair input: every output and state leaf matches the JAX
    chain's (the bounds of their own parity tests), and the head records
    its routed kernel once a block at its shape, fir_long_f32 never there:
    resample_dec_f32, resample_poly_f32 never; at 2FSK10K's taps-in-order
    instance, on 2 rows, resample_poly_f32 (IN_ORDER_FEW_ROWS)."""
    from qradiolink_tpu.models import registry as jregistry

    rx = registry.rx_chain(mode, lead_shape=(2,), device="cpu")
    rs = rx.resamp
    T = {"M17": 125 * 48, "DMR": 125 * 48, "MMDVM": 125 * 40,
         "4FSK10KFM": 25 * 400, "2FSK10K": 25 * 400}[mode]
    blocks = [tuple((rng.standard_normal((2, T)) * 0.3).astype(np.float32)
                    for _ in range(2)) for _ in range(2)]
    kernel_paths.reset()
    stream_both(jregistry.rx_chain(mode, lead_shape=(2,)), rx, blocks,
                1e-3, 1e-3, peak=True)
    rep = kernel_paths.report()
    key = f"plain L{rs.L} K{rs.kp} D{rs.M} tail 2x2"
    assert (rs.L, rs.M, rs.kp) in DEC_ALL
    want = route(rs.L, rs.M, rs.kp, 2)
    assert want == (OP if mode == "2FSK10K" else DEC_OP)
    assert rep[want]["shapes"] == {key: 2}, rep
    other = DEC_OP if want == OP else OP
    assert key not in rep.get(other, {}).get("shapes", {})
    assert cuda_fir.LONG_OP not in rep or all(
        f"K{rs.kp} D{rs.M}" not in k for k in rep[cuda_fir.LONG_OP]["shapes"])


@pytest.mark.parametrize("L,M,K,want", [
    (125, 12, 51, RAT_OP), (25, 24, 51, RAT_OP), (24, 25, 53, RAT_OP),
    (50, 13, 2, RAT_OP), (128, 13, 2, RAT_OP),
    (129, 13, 2, OP),     # more phases than the block's threads
    (125, 12, 45, OP),    # no instance at K 45
    (23, 25, 53, OP),     # below 24 phases
    (125, 7, 51, OP),     # no instance at M 7
    (12, 125, 523, DEC_OP),   # MMDVM's RX, decimating: resample_dec_f32
    (13, 50, 3, OP), (2, 25, 105, DEC_OP), (2, 25, 561, DEC_OP),
    (3, 125, 349, DEC_OP), (125, 4, 51, UP_OP)])
def test_resample_route_rat_shapes(L, M, K, want):
    """resample_rat_f32 at 24 to 128 phases and an (M, K) it has an
    instance for; the decimating M > 5 shapes the paths run on
    resample_dec_f32 where it has an instance, resample_poly_f32
    elsewhere."""
    assert route(L, M, K) == want


@pytest.mark.parametrize("mode,rx,rows", [("MMDVM", False, (2,)),
                                          ("MMDVMmulti", False, ()),
                                          ("MMDVMmulti", True, ()),
                                          ("BPSKDSSS8", False, (2,))])
def test_chains_record_resample_rat(rng, mode, rx, rows):
    """MMDVM's and DSSS's TX and MMDVMmulti's TX and RX, built through the
    registry on the CPU, record resample_rat_f32 once a block at their
    resampler's shape, and resample_poly_f32 never there."""
    lead = {} if mode == "MMDVMmulti" else {"lead_shape": rows}
    chain = (registry.rx_chain if rx else registry.tx_chain)(
        mode, device="cpu", **lead)
    if rx:
        x = (rng.standard_normal(rows + (2500,))
             + 1j * rng.standard_normal(rows + (2500,))) * 0.1
        x, rs, n = torch.from_numpy(x.astype(np.complex64)), chain.resamp, 7
    elif mode == "MMDVMmulti":
        x = torch.from_numpy(
            (rng.standard_normal((7, 2400)) * 0.3).astype(np.float32))
        rs, n = chain.resamp, 7
    elif mode == "MMDVM":
        x = torch.from_numpy(
            (rng.standard_normal(rows + (2400,)) * 0.3).astype(np.float32))
        rs, n = chain.up, 2
    else:
        x = torch.from_numpy(rng.integers(0, 256, rows + (2,)).astype(
            np.uint8))
        rs, n = chain.up_if, 2
    kernel_paths.reset()
    chain(chain.init_state(), x)
    rep = kernel_paths.report()
    key = f"plain L{rs.L} K{rs.kp} D{rs.M} tail 2x{n}"
    assert (rs.L, rs.M, rs.kp) in {(L, M, v[0])
                                   for (L, M), v in RAT_CASES.items()}
    assert rep[RAT_OP] == {"cuda": 0, "plain": 1, "shapes": {key: 1}}
    assert key not in rep.get(OP, {}).get("shapes", {})


@pytest.mark.parametrize("L,M,want", [
    (2, 5, OP), (2, 1, X2_OP), (3, 125, OP), (3, 1, UP_OP), (3, 5, UP_OP),
    (4, 1, UP_OP), (4, 5, UP_OP), (5, 4, UP_OP), (20, 1, UP_OP),
    (25, 4, UP_OP), (125, 1, UP_OP), (125, 4, UP_OP), (3, 7, OP),
    (4, 6, OP), (125, 7, OP),
    # resample_rat_f32's (L, M) at a K it has no instance for
    (125, 12, OP), (50, 13, OP), (25, 24, OP), (24, 25, OP)])
def test_resample_route_at_the_sweep_edges(L, M, want):
    """resample_x2_f32 at L 2 M 1 (QpskMod's x2), resample_up_f32 from L 3
    (the sweep's lowest L) at M <= 5 (the decimations with a ring
    instance), resample_poly_f32 elsewhere (L 2 M 5, M17's 3/125), at K 45
    and 113: no resample_rat_f32 instance has those K, so its (L, M) stay
    on resample_poly_f32 there (test_resample_route_rat_shapes has its
    K)."""
    for K in (45, 113):
        assert route(L, M, K) == want
    assert cuda_resample.UP_MIN_L == 3 and cuda_resample.UP_MAX_M == 5
    src = UP_SRC.read_text()
    assert "constexpr int kMaxM = 5;" in src
    assert "case 4: return launch<4>(" in src
    assert "default: return launch<5>(" in src


@pytest.mark.parametrize("L,M", [(2, 5), (3, 125), (25, 4), (20, 1)])
def test_phase_offsets(L, M):
    q = phase_offsets(L, M)
    assert q == [r * M // L for r in range(L)]
    assert RationalResampler(L, M, device="cpu").offsets == q


@pytest.mark.parametrize("kind", ["real", "pair", "complex"])
@pytest.mark.parametrize("L,M", sorted(CASES))
def test_rational_resampler_matches_jax(rng, L, M, kind):
    """RationalResampler with the default taps (resample_rat_f32's shapes:
    their chains'), lead shape (2,), two blocks, against the JAX package's:
    every output and every state leaf (on real input the im plane of the
    state stays zero)."""
    T = CASES[(L, M)]
    taps = chain_taps(L, M)
    blocks = []
    for _ in range(2):
        re_ = rng.standard_normal((2, T)).astype(np.float32)
        im = rng.standard_normal((2, T)).astype(np.float32)
        blocks.append({"real": re_, "pair": (re_, im),
                       "complex": (re_ + 1j * im).astype(np.complex64)}[kind])
    kernel_paths.reset()
    stream_both(JaxResampler(L, M, taps=taps, lead_shape=(2,)),
                RationalResampler(L, M, taps=taps, lead_shape=(2,),
                                  device="cpu"),
                blocks)
    planes = 1 if kind == "real" else 2
    rs_kp = RationalResampler(L, M, taps=taps, device="cpu").kp
    if (L, M) in RAT_CASES:
        assert (rs_kp, route(L, M, rs_kp)) == (RAT_CASES[(L, M)][0], RAT_OP)
    assert kernel_paths.report() == {route(L, M, rs_kp): {
        "cuda": 0, "plain": 2,
        "shapes": {f"plain L{L} K{rs_kp} D{M} tail {planes}x2": 2}}}


@pytest.mark.parametrize("L,M", [(1, 50), (1, 125), (2, 5), (3, 125),
                                 (25, 4), (20, 1), (4, 2)])
@pytest.mark.parametrize("kind", ["real", "pair"])
def test_resampler_route_recorded_on_cpu(L, M, kind):
    """Every L > 1 call records the kernel route(L, M, K) picks alone,
    once (resample_up_f32 at 25/4 and 20/1, resample_poly_f32 at 2/5 and
    3/125, resample_x2_f32 at 4/2, which reduces to 2/1); L = 1 the
    strided FIR kernel
    cuda_fir.route picks for the head."""
    rs = RationalResampler(L, M, device="cpu")
    x = torch.zeros((2, 250 * rs.M))
    x = IqPair(x, x) if kind == "pair" else x
    kernel_paths.reset()
    rs(torch.zeros((2, 2, rs.kp - 1)), x)
    want = route(rs.L, rs.M, rs.kp) if rs.L > 1 \
        else cuda_fir.route(rs.kp, rs.M)
    rep = kernel_paths.report()
    assert set(rep) == {want} and rep[want]["plain"] == 1, rep


@pytest.mark.parametrize("L,M", [(2, 5), (125, 1)])
def test_resample_poly_state_only_on_cpu(rng, L, M):
    """A block of 0 samples: no output, and the new state is the old tail
    (the plain version once failed here, its F.conv1d given fewer samples
    than taps)."""
    rs = RationalResampler(L, M, lead_shape=(3,), device="cpu")
    st = torch.from_numpy(
        rng.standard_normal((3, 2, rs.kp - 1)).astype(np.float32))
    new_state, y = rs(st, IqPair(torch.zeros((3, 0)), torch.zeros((3, 0))))
    assert y.re.shape == (3, 0) and y.im.shape == (3, 0)
    assert torch.equal(new_state, st)


def test_resample_poly_rejects_bad_input():
    taps = torch.zeros((2, 5))
    x, t = torch.zeros((3, 10)), torch.zeros((3, 4))
    for args in [((x,), taps, 2, 3, (t,)),           # T % M
                 ((x,), taps, 3, 5, (t,)),           # taps rows != L
                 ((x,), taps, 2, 5, (t, t)),         # a tail per plane
                 ((x,), taps, 2, 5, (torch.zeros((3, 3)),)),
                 ((x.double(),), taps, 2, 5, (t,))]:
        with pytest.raises(ValueError):
            resample_poly(*args)


def test_resample_route_per_phase_where_fir_long_takes_a_phase(rng):
    """DMR's 3/125 head (K2091 a phase: 17 rows of 125 taps), which took
    the per-phase route (cuda_resample.resample_phases: fir_long_f32 once a
    phase) until resample_dec_f32, now routes to resample_dec_f32, as M17's
    (K349) does; the NBFM audio resampler stays on resample_poly_f32. On
    the CPU the head records resample_dec_f32's plain version once a block
    and matches the JAX resampler over two blocks (IqPair); the per-phase
    route, timed in turns on the card, still equals the plain version and
    records the FIR once a phase."""
    from qradiolink_tpu_torch.ops import firdes

    assert route(3, 125, 2091) == DEC_OP
    assert route(3, 125, 349) == DEC_OP and route(2, 5, 113) == OP
    assert cuda_fir.route(2091, 125) == cuda_fir.LONG_OP
    # DmrDemod's head (qradiolink_tpu/chains/dmr.py:58)
    taps = firdes.low_pass(3.0, 3_000_000, 5000.0, 2000.0,
                           firdes.WIN_BLACKMAN_HARRIS)
    rs = RationalResampler(3, 125, taps=taps, lead_shape=(2,), device="cpu")
    assert rs.kp == 2091
    blocks = [tuple(rng.standard_normal((2, 125 * 45)).astype(np.float32)
                    for _ in range(2)) for _ in range(2)]
    kernel_paths.reset()
    stream_both(JaxResampler(3, 125, taps=taps, lead_shape=(2,)), rs, blocks)
    assert kernel_paths.report() == {DEC_OP: {
        "cuda": 0, "plain": 2,
        "shapes": {"plain L3 K2091 D125 tail 2x2": 2}}}
    xs = [torch.from_numpy(b) for b in blocks[0]]
    st = torch.from_numpy(rng.standard_normal((2, 2, 2090)).astype(
        np.float32))
    kernel_paths.reset()
    got_state, got = cuda_resample.resample_phases(
        xs, rs.poly_taps, 3, 125, (st[:, 0], st[:, 1]))
    assert kernel_paths.report() == {cuda_fir.LONG_OP: {
        "cuda": 0, "plain": 3, "shapes": {"plain K2091 D125 tail 2x2": 3}}}
    want_state, want = resample_poly_plain(xs, rs.poly_taps, 3, 125,
                                           (st[:, 0], st[:, 1]))
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())
    assert torch.equal(got_state, want_state)
