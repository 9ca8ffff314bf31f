"""Agc2 of the port against the JAX package's on the CPU, and the numpy
models of its kernels (csrc/agc2.cu), `agc2_f32` (the stage in one launch,
`agc2_fused_model`) and `agc2_gain_f32` (the recurrence, `agc2_model`),
against the plain versions.

Tolerances: the plain loop repeats the reference's operations in its
order, each rounded on its own; the magnitude of complex input is
torch.abs (a hypot) where XLA scales by the larger plane, which can differ
in the last bit. Outputs and the carried gain are held to 1e-6 relative.
The kernels' models are held to the plain versions bit for bit, as the
kernels are on the card (tests/test_torch_cuda.py); so is the stage's plain
version to the stage as it was computed before (torch.abs, the recurrence,
the plane products).
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.ops.agc import Agc2 as JaxAgc2  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_agc  # noqa: E402
from qradiolink_tpu_torch.ops.agc import Agc2  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.torch_parity import stream_both  # noqa: E402

SRC = (pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch"
       / "csrc" / "agc2.cu")
ROWS, TILE = 32, 32

# (attack, decay, reference): the SSB chain's and the AM chain's AGCs
PARAMS = {"ssb": (1e-1, 1e-1, 0.25), "am": (1e-1, 1e-2, 1.0)}


def _bursty(rng, shape, kind):
    """Loud and quiet stretches of 150 samples, so the gain both attacks
    and decays inside a block."""
    amp = np.where((np.arange(shape[-1]) // 150) % 2 == 0, 2.0, 0.02)
    re = rng.standard_normal(shape) * amp
    if kind == "real":
        return re.astype(np.float32)
    im = rng.standard_normal(shape) * amp
    if kind == "complex":
        return (re + 1j * im).astype(np.complex64)
    return re.astype(np.float32), im.astype(np.float32)


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("kind", ["real", "complex", "pair"])
def test_agc2_streamed(rng, params, kind):
    """Two blocks: outputs (complex for IqPair input, as in JAX) and the
    carried gain."""
    a, d, ref = PARAMS[params]
    x = _bursty(rng, (3, 1200), kind)
    blocks = ([tuple(np.split(p, 2, axis=-1)[i] for p in x) for i in (0, 1)]
              if kind == "pair" else np.split(x, 2, axis=-1))
    stream_both(JaxAgc2(a, d, reference=ref, lead_shape=(3,)),
                Agc2(a, d, reference=ref, lead_shape=(3,), device="cpu"),
                blocks, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_agc2_tiny_first_samples(rng, kind):
    """A block whose first samples are ~1e-20 (the output of a quiet
    channel): the gain climbs at the decay rate, as in the reference."""
    x = _bursty(rng, (2, 800), kind)
    x[..., :200] *= 1e-20
    stream_both(JaxAgc2(1e-1, 1e-2, lead_shape=(2,)),
                Agc2(1e-1, 1e-2, lead_shape=(2,), device="cpu"),
                np.split(x, 2, axis=-1), rtol=1e-6, atol=1e-6)


def test_agc2_records_the_plain_path_on_cpu(rng):
    agc = Agc2(lead_shape=(3,), device="cpu")
    kernel_paths.reset()
    agc(agc.init_state(), torch.from_numpy(_bursty(rng, (3, 40), "real")))
    rep = kernel_paths.report()[cuda_agc.OP_FUSED]
    assert rep["cuda"] == 0 and rep["shapes"] == {"plain real 3x40": 1}
    assert cuda_agc.OP not in kernel_paths.report()


def _stage_as_before(x, g0, a, d, ref, max_gain):
    """The Agc2 stage as the port computed it before agc2_f32: torch.abs,
    the recurrence on its own, the products plane by plane."""
    gains, g_last = cuda_agc.agc2_gain_plain(torch.abs(x).float(), g0, a, d,
                                             ref, max_gain)
    if torch.is_complex(x):
        return torch.complex(x.real * gains, x.imag * gains), g_last
    return x * gains, g_last


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_agc2_plain_equals_the_stage_as_before(rng, params, kind):
    """Two streamed blocks: agc2 (its plain version on the CPU) and the
    Agc2 block give the stage's former outputs and gain bit for bit."""
    a, d, ref = PARAMS[params]
    x = torch.from_numpy(_bursty(rng, (3, 900), kind))
    agc = Agc2(a, d, reference=ref, lead_shape=(3,), device="cpu")
    g_old = g_new = g_blk = agc.init_state()
    for blk in torch.split(x, [500, 400], dim=-1):
        y_old, g_old = _stage_as_before(blk, g_old, a, d, ref, 65536.0)
        y_new, g_new = cuda_agc.agc2(blk, g_new, a, d, ref, 65536.0)
        g_blk, y_blk = agc(g_blk, blk)
        for y in (y_new, y_blk):
            assert y.dtype == y_old.dtype and torch.equal(y, y_old)
        assert torch.equal(g_new, g_old) and torch.equal(g_blk, g_old)


def test_agc2_gain_checks_its_inputs():
    m = torch.zeros((3, 10))
    for g0 in (torch.zeros(4), torch.zeros(3, dtype=torch.float64)):
        with pytest.raises(ValueError):
            cuda_agc.agc2_gain(m, g0, 0.1, 0.1, 1.0, 65536.0)


def agc2_model(m, g0, attack, decay, ref, max_gain):
    """agc2_gain_f32 in numpy: blocks of ROWS rows, lane i owning row
    row0 + i; tiles of TILE samples loaded lane-wise (lane i takes sample
    t0 + i of every row, 0 past the end), the next tile's loads taken
    before the current tile's recurrence runs; each lane walks its row
    across the tile, storing the gain before each update into the output
    tile, which the block stores lane-wise; the gain after the last
    sample goes to g_last. f32 arithmetic, each operation rounded on its
    own. Asserts that every gain is written once."""
    f = np.float32
    ref, attack, decay = f(ref), f(attack), f(decay)
    lo, hi = f(cuda_agc.MIN_GAIN), f(max_gain)
    C, T = m.shape
    gains = np.full((C, T), np.nan, np.float32)
    g_last = np.full(C, np.nan, np.float32)
    for row0 in range(0, C, ROWS):
        n_rows = min(ROWS, C - row0)
        lanes = np.arange(ROWS)
        mine = lanes < n_rows
        g = np.where(mine, g0[np.minimum(row0 + lanes, C - 1)], f(0))

        def load(t0):
            v = np.zeros((ROWS, ROWS), np.float32)  # [row r, lane]
            for r in range(n_rows):
                t = t0 + lanes
                ok = t < T
                v[r, ok] = m[row0 + r, t[ok]]
            return v

        v = load(0)
        for t0 in range(0, T, TILE):
            s_m = v.copy()           # s_m[r][lane] = v[r] of that lane
            v = load(t0 + TILE)
            n = min(TILE, T - t0)
            s_g = np.full((ROWS, TILE), np.nan, np.float32)
            for j in range(n):
                s_g[mine, j] = g[mine]
                mj = s_m[lanes, j]   # lane reads its row's sample j
                err = (ref - (mj * g).astype(f)).astype(f)
                rate = np.where(err < 0, attack, decay)
                g = np.where(mine, np.minimum(np.maximum(
                    (g + (rate * err).astype(f)).astype(f), lo), hi), g)
            for r in range(n_rows):
                for lane in range(n):
                    assert np.isnan(gains[row0 + r, t0 + lane])
                    gains[row0 + r, t0 + lane] = s_g[r, lane]
        g_last[row0:row0 + n_rows] = g[:n_rows]
    assert not np.isnan(gains).any() and not np.isnan(g_last).any()
    return gains, g_last


# (C, T): full and ragged row blocks and tiles, a one-sample block, the
# chains' rates in miniature
MODEL_CASES = [(32, 64), (45, 100), (3, 31), (70, 1), (33, 33), (2, 200)]


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("C,T", MODEL_CASES)
def test_agc2_model_matches_plain(rng, params, C, T):
    """The kernel's tiling computes the plain loop's gains bit for bit,
    from a carried gain (the second of two chained blocks)."""
    a, d, ref = PARAMS[params]
    m = np.abs(_bursty(rng, (C, 2 * T), "real"))
    g0 = np.full(C, 1.0, np.float32)
    for blk in range(2):
        mb = np.ascontiguousarray(m[:, blk * T:(blk + 1) * T])
        want, want_last = cuda_agc.agc2_gain_plain(
            torch.from_numpy(mb), torch.from_numpy(g0), a, d, ref, 65536.0)
        got, got_last = agc2_model(mb, g0, a, d, ref, 65536.0)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got_last, want_last.numpy())
        g0 = got_last


def test_agc2_model_follows_the_source():
    """The model's block and tile sizes are the kernel's."""
    src = SRC.read_text()
    assert int(re.search(r"kRows = (\d+);", src).group(1)) == ROWS
    assert int(re.search(r"kTile = (\d+);", src).group(1)) == TILE
    assert "__fmul_rn" in src and "__fadd_rn" in src


# -- agc2_f32: the stage in one launch ----------------------------------------

HELPERS, XBUF, FTILE = 4, 4, 64
HELPER_ROWS = -(-ROWS // HELPERS)  # a memory warp's rows, at most


def agc2_fused_model(x, g0, attack, decay, ref, max_gain):
    """agc2_f32 in numpy: blocks of ROWS rows, a chain warp (lane i runs
    row row0 + i) and HELPERS memory warps of HELPER_ROWS rows each;
    tiles of FTILE samples. A memory warp copies its rows' x tiles into a
    ring of XBUF tile slots XBUF tiles ahead (lane i takes samples t0 + i,
    t0 + 32 + i, ...; zeros past the end), computes |x| (torch.abs: the
    kernel's hypotf,
    held to torch.abs's bits on the card) of the tile two ahead of the
    chain into a magnitude tile of 2, and, after the chain has turned tile
    t's magnitudes into gains in place, writes y = x g (plane by plane)
    from slot t % XBUF and the gain tile. The events run in an order the
    named barriers allow; every read asserts the tile its slot holds. f32
    arithmetic, each operation rounded on its own."""
    f = np.float32
    ref, attack, decay = f(ref), f(attack), f(decay)
    lo, hi = f(cuda_agc.MIN_GAIN), f(max_gain)
    C, T = x.shape
    cplx = np.iscomplexobj(x)
    mags = torch.abs(torch.from_numpy(x)).numpy()
    y = np.full(x.shape, np.nan, x.dtype)
    g_last = np.full(C, np.nan, np.float32)
    n_tiles = -(-T // FTILE)
    for row0 in range(0, C, ROWS):
        n_rows = min(ROWS, C - row0)
        s_x = [(-1, None)] * XBUF            # (tile, (ROWS, FTILE) samples)
        s_mg = [("", -1, None)] * 2          # (kind, tile, (ROWS, FTILE))

        def stage(t):
            if t >= n_tiles:
                return
            tile = np.zeros((ROWS, FTILE), x.dtype)
            t0 = t * FTILE
            n = min(FTILE, T - t0)
            for h in range(HELPERS):
                r0 = h * HELPER_ROWS
                for r in range(r0, min(r0 + HELPER_ROWS, n_rows)):
                    tile[r, :n] = x[row0 + r, t0:t0 + n]
            s_x[t % XBUF] = (t, tile)

        def magnitudes(t):
            assert s_x[t % XBUF][0] == t
            m = np.full((ROWS, FTILE), np.nan, np.float32)
            t0 = t * FTILE
            n = min(FTILE, T - t0)
            m[:n_rows, :n] = mags[row0:row0 + n_rows, t0:t0 + n]
            s_mg[t % 2] = ("m", t, m)

        def chain(t, g):
            kind, tt, m = s_mg[t % 2]
            assert kind == "m" and tt == t
            n = min(FTILE, T - t * FTILE)
            gt = np.full((ROWS, FTILE), np.nan, np.float32)
            for j in range(FTILE):
                gt[:, j] = g
                if j < n:
                    err = (ref - (m[:, j] * g).astype(f)).astype(f)
                    ga = (g + (attack * err).astype(f)).astype(f)
                    gd = (g + (decay * err).astype(f)).astype(f)
                    g = np.minimum(np.maximum(np.where(err < 0, ga, gd), lo),
                                   hi)
            s_mg[t % 2] = ("g", t, gt)
            return g

        def outputs(t):
            tx, xs = s_x[t % XBUF]
            kind, tg, gt = s_mg[t % 2]
            assert tx == t and kind == "g" and tg == t
            t0 = t * FTILE
            n = min(FTILE, T - t0)
            gs = gt[:n_rows, :n]
            xs = xs[:n_rows, :n]
            if cplx:
                yt = ((xs.real * gs).astype(f)
                      + 1j * (xs.imag * gs).astype(f)).astype(x.dtype)
            else:
                yt = (xs * gs).astype(f)
            assert np.isnan(y[row0:row0 + n_rows, t0:t0 + n]).all()
            y[row0:row0 + n_rows, t0:t0 + n] = yt

        g = np.zeros(ROWS, np.float32)
        g[:n_rows] = g0[row0:row0 + n_rows]
        for t in range(XBUF):
            stage(t)
        for t in range(min(2, n_tiles)):
            magnitudes(t)
        for t in range(n_tiles):
            g = chain(t, g)
            outputs(t)
            stage(t + XBUF)
            if t + 2 < n_tiles:
                magnitudes(t + 2)
        g_last[row0:row0 + n_rows] = g[:n_rows]
    assert not np.isnan(y.view(np.float32)).any()
    assert not np.isnan(g_last).any()
    return y, g_last


def _agc_input(rng, C, T, kind, regime):
    x = _bursty(rng, (C, T), kind)
    if regime == "tiny":        # a quiet channel's first samples
        x[:, :T // 2] *= 1e-20
    elif regime == "loud":      # bursts that drive the gain to its floor
        x[:, ::7] *= 1e6
    return x


# (C, T): full and ragged row blocks and tiles, one sample, fewer tiles than
# the ring, rows that leave memory warps without a row, the ring reused
FUSED_CASES = [(32, 64), (45, 100), (3, 31), (70, 1), (33, 200), (2, 129),
               (9, 97), (2, 400)]
# regime: (attack, decay, reference, max_gain)
REGIMES = {"bursty": (1e-1, 1e-2, 1.0, 65536.0),
           "tiny": (1e-1, 0.5, 0.25, 4.0),     # the gain clamped at max
           "loud": (1e-1, 1e-2, 1.0, 65536.0)}  # and at 1e-6


@pytest.mark.parametrize("regime", sorted(REGIMES))
@pytest.mark.parametrize("kind", ["real", "complex"])
@pytest.mark.parametrize("C,T", FUSED_CASES)
def test_agc2_fused_model_matches_plain(rng, C, T, kind, regime):
    """agc2_f32's warps, tiles, ring and hand-overs give the plain
    version's y and carried gain bit for bit over two chained blocks,
    also where the gain sits at its clamps."""
    a, d, ref, mx = REGIMES[regime]
    x = _agc_input(rng, C, 2 * T, kind, regime)
    g0 = np.full(C, 1.0, np.float32)
    clamped = set()
    for blk in range(2):
        xb = np.ascontiguousarray(x[:, blk * T:(blk + 1) * T])
        want, want_last = cuda_agc.agc2_plain(
            torch.from_numpy(xb), torch.from_numpy(g0), a, d, ref, mx)
        got, got_last = agc2_fused_model(xb, g0, a, d, ref, mx)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got_last, want_last.numpy())
        gains = cuda_agc.agc2_gain_plain(
            torch.abs(torch.from_numpy(xb)).float(), torch.from_numpy(g0),
            a, d, ref, mx)[0]
        clamped |= {v for v in (np.float32(cuda_agc.MIN_GAIN),
                                np.float32(mx)) if (gains == v).any()}
        g0 = got_last
    if regime == "tiny" and T >= 64:
        assert np.float32(mx) in clamped
    if regime == "loud" and T >= 64:
        assert np.float32(cuda_agc.MIN_GAIN) in clamped


def test_agc2_fused_model_follows_the_source():
    """The model's warps, ring and tiles are the kernel's, and the kernel
    computes |x| and y as the model does."""
    src = SRC.read_text()
    assert int(re.search(r"kHelpers = (\d+);", src).group(1)) == HELPERS
    assert "kHelperRows = (kRows + kHelpers - 1) / kHelpers;" in src
    assert int(re.search(r"kXBuf = (\d+);", src).group(1)) == XBUF
    assert int(re.search(r"kFTile = (\d+);", src).group(1)) == FTILE
    for line in ('asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(rs) : "f"(r));',
                 "q = r == INFINITY ? INFINITY : q;  // the slow path's "
                 "sqrt(inf)",
                 "return make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));",
                 "cp_async_wait<kXBuf - 2>();",
                 "stage(t + kXBuf);  // into the slot tile t leaves",
                 "s_mg[b][lane][j] = g;"):
        assert line in src, line
