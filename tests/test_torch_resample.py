"""The rational resampler at L > 1 on `resample_poly_f32`'s route: a numpy
model of the kernel's blocks held against the plain version, the port's
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
from qradiolink_tpu_torch.ops.cuda_resample import (  # noqa: E402
    OP, phase_offsets, resample_poly, resample_poly_plain)
from qradiolink_tpu_torch.ops.resample import RationalResampler  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.torch_parity import stream_both  # noqa: E402

SRC = (pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch"
       / "csrc" / "resample_poly.cu")
THREADS, WARP = 128, 32

# (L, M) of the ported and planned resamplers: the NBFM audio resampler,
# M17's 3/125 and the TX resamplers 25/4, 20/1 and 125/1 (SsbMod, AmMod);
# block lengths leave a ragged last tile: n_pp = 150 (64 + 64 + 22), 45
# (32 + 13), 50 (32 + 18), 70 (32 + 32 + 6), 40 (32 + 8)
CASES = {(2, 5): 750, (3, 125): 125 * 45, (25, 4): 200, (20, 1): 70,
         (125, 1): 40}


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
    """Two chained blocks with the default taps: the model's outputs within
    1e-5 of resample_poly_plain's, its state equal."""
    rs = RationalResampler(L, M, lead_shape=(2,), device="cpu")
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


@pytest.mark.parametrize("L,M", [(2, 5), (3, 125), (25, 4), (20, 1)])
def test_phase_offsets(L, M):
    q = phase_offsets(L, M)
    assert q == [r * M // L for r in range(L)]
    assert RationalResampler(L, M, device="cpu").offsets == q


@pytest.mark.parametrize("kind", ["real", "pair", "complex"])
@pytest.mark.parametrize("L,M", sorted(CASES))
def test_rational_resampler_matches_jax(rng, L, M, kind):
    """RationalResampler with the default taps, lead shape (2,), two
    blocks, against the JAX package's: every output and every state leaf
    (on real input the im plane of the state stays zero)."""
    T = CASES[(L, M)]
    blocks = []
    for _ in range(2):
        re_ = rng.standard_normal((2, T)).astype(np.float32)
        im = rng.standard_normal((2, T)).astype(np.float32)
        blocks.append({"real": re_, "pair": (re_, im),
                       "complex": (re_ + 1j * im).astype(np.complex64)}[kind])
    kernel_paths.reset()
    stream_both(JaxResampler(L, M, lead_shape=(2,)),
                RationalResampler(L, M, lead_shape=(2,), device="cpu"),
                blocks)
    planes = 1 if kind == "real" else 2
    rs_kp = RationalResampler(L, M, device="cpu").kp
    assert kernel_paths.report() == {OP: {
        "cuda": 0, "plain": 2,
        "shapes": {f"plain L{L} K{rs_kp} D{M} tail {planes}x2": 2}}}


@pytest.mark.parametrize("L,M", [(1, 50), (1, 125), (2, 5), (3, 125),
                                 (25, 4), (20, 1), (4, 2)])
@pytest.mark.parametrize("kind", ["real", "pair"])
def test_resampler_route_recorded_on_cpu(L, M, kind):
    """Every L > 1 call records resample_poly_f32 alone, once; L = 1 (and
    4/2, which reduces to 2/1) the strided FIR kernel cuda_fir.route
    picks for the head."""
    rs = RationalResampler(L, M, device="cpu")
    x = torch.zeros((2, 250 * rs.M))
    x = IqPair(x, x) if kind == "pair" else x
    kernel_paths.reset()
    rs(torch.zeros((2, 2, rs.kp - 1)), x)
    want = OP if rs.L > 1 else cuda_fir.route(rs.kp, rs.M)
    rep = kernel_paths.report()
    assert set(rep) == {want} and rep[want]["plain"] == 1, rep


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
