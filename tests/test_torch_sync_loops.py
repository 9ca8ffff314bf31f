"""The PSK chains' loops of the port against the JAX package's on the CPU:
CostasLoop (orders 2 and 4), SymbolSync (complex sign decisions, real
levels, real sign decisions) and FllBandEdge, and numpy models of the
loop kernels `costas_loop_f32` (csrc/costas.cu), `symbol_sync_mm_f32`
(csrc/symbol_sync.cu) and `fll_band_edge_f32` (csrc/fll_band_edge.cu)
against their plain loops.

Each block is fed a short QPSK-like signal, locked or nearly so, whose
first samples are ~1e-20 (the denormal trap: XLA flushes denormals,
PyTorch does not), and streamed in two blocks; every output and state leaf
is compared after each block. Bounds, elementwise |port - jax| <= atol +
rtol |jax|:
  * CostasLoop 1e-5 / 1e-5: XLA's sin/cos on the CPU differ from
    PyTorch's in the last bit (measured 1.6e-6 on outputs of peak 1.2);
  * SymbolSync 1e-6 / 1e-6: XLA sums the interpolator's four products in
    another order (1 ulp, measured 1.8e-7); the position and clock agree;
  * FllBandEdge 2e-5 / 1e-5: |u|^2 and the sub-block means round apart,
    and the frequency's difference accumulates into the phase (measured
    4.1e-6 after two blocks of 5,000).
Downstream, these bounds leave the decoded bits equal (tests/
test_torch_psk.py). The Costas and sync kernels' models are held to the
plain loops bit for bit, as the kernels are on the card (tests/
test_torch_cuda.py); the FLL kernel's model to the FllBandEdge bound
above, as the kernel is on the card: it sums each sub-block's band-edge
energy in its own order, which torch.mean does not fix.
"""

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.sync.costas import CostasLoop as JaxCostas  # noqa: E402
from qradiolink_tpu.sync.fll import FllBandEdge as JaxFll  # noqa: E402
from qradiolink_tpu.sync.symbol_sync import SymbolSync as JaxSync  # noqa: E402
from qradiolink_tpu_torch.sync import (cuda_costas,  # noqa: E402
                                       cuda_fll, cuda_symbol_sync)
from qradiolink_tpu_torch.sync.costas import CostasLoop  # noqa: E402
from qradiolink_tpu_torch.sync.fll import FllBandEdge  # noqa: E402
from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.test_torch_cuda import SYNC_STRESS, stress_ramps  # noqa: E402
from tests.torch_parity import stream_both  # noqa: E402

CSRC = (pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch"
        / "csrc")
LEVELS4 = (-1.5, -0.5, 0.5, 1.5)


def qpsk_like(rng, C, n_sym, sps, offset=0.0, noise=0.05, tiny=100):
    """QPSK symbols held for sps samples, smoothed by a sps-tap moving
    average, rotated by `offset` rad/sample, with noise; the first `tiny`
    samples scaled to ~1e-20."""
    syms = (np.sign(rng.standard_normal((C, n_sym)))
            + 1j * np.sign(rng.standard_normal((C, n_sym)))) / np.sqrt(2)
    x = np.repeat(syms, sps, axis=1)
    k = np.ones(sps) / sps
    x = np.stack([np.convolve(r, k)[:x.shape[1]] for r in x])
    x = x * np.exp(1j * offset * np.arange(x.shape[1]))
    x = x + noise * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
    x = x.astype(np.complex64)
    x[:, :tiny] *= 1e-20
    return x


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("offset", [0.0, 0.01])
def test_costas_streamed(rng, order, offset):
    x = qpsk_like(rng, 3, 250, 4, offset=offset)
    blocks = np.split(x, 2, axis=-1)
    stream_both(JaxCostas(np.pi / 200, order, lead_shape=(3,)),
                CostasLoop(np.pi / 200, order, lead_shape=(3,),
                           device="cpu"),
                blocks, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["complex_sign", "real_levels",
                                     "real_sign"])
def test_symbol_sync_streamed(rng, variant):
    """The three decision variants, sps 4, two blocks of 400 samples."""
    x = qpsk_like(rng, 3, 200, 4)
    lv = None
    if variant == "real_levels":
        lv = LEVELS4
        x = np.repeat(rng.choice(LEVELS4, (3, 200)), 4, axis=1).astype(
            np.float32) + 0.02 * rng.standard_normal((3, 800)).astype(
            np.float32)
        x[:, :50] *= 1e-20
    elif variant == "real_sign":
        x = np.ascontiguousarray(x.real)
    stream_both(JaxSync(4, decisions=lv, lead_shape=(3,)),
                SymbolSync(4, decisions=lv, lead_shape=(3,), device="cpu"),
                np.split(x, 2, axis=-1), rtol=1e-6, atol=1e-6)


def test_symbol_sync_bpsk_gains(rng):
    """BpskDemod's sync: sps 10, gain_mu 0.05, gain_omega 2.5e-5, omega
    limit 0.001, the clock started off nominal by the signal's rate."""
    x = qpsk_like(rng, 2, 100, 10)[:, 3:3 + 900]
    kw = dict(gain_mu=0.05, gain_omega=2.5e-5, omega_limit=0.001,
              lead_shape=(2,))
    stream_both(JaxSync(10, **kw), SymbolSync(10, device="cpu", **kw),
                np.split(x, 3, axis=-1), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["complex", "pair"])
def test_fll_streamed(rng, kind):
    """QPSK250K's FLL (sps 4, 32 taps, loop bandwidth 2 pi/100) pulling in
    an offset of 0.05 rad/sample over two blocks of 5,000 (10 sub-blocks
    of 500 each)."""
    x = qpsk_like(rng, 3, 2500, 4, offset=0.05)
    blocks = np.split(x, 2, axis=-1)
    if kind == "pair":
        blocks = [(b.real.copy(), b.imag.copy()) for b in blocks]
    (js, ts), _ = stream_both(
        JaxFll(4, 0.35, 32, 2 * np.pi / 100, lead_shape=(3,)),
        FllBandEdge(4, 0.35, 32, 2 * np.pi / 100, lead_shape=(3,),
                    device="cpu"),
        blocks, rtol=1e-5, atol=2e-5)
    assert np.all(ts[1].numpy() > 0.002)  # pulling toward the offset


def test_fll_odd_block_length(rng):
    """A block length with no divisor near the sub-block (1,250: 250-sample
    sub-blocks), as the JAX block picks it."""
    x = qpsk_like(rng, 2, 625, 4, offset=0.02)
    stream_both(JaxFll(4, 0.35, 32, 2 * np.pi / 100, lead_shape=(2,)),
                FllBandEdge(4, 0.35, 32, 2 * np.pi / 100, lead_shape=(2,),
                            device="cpu"),
                np.split(x, 2, axis=-1), rtol=1e-5, atol=2e-5)


def test_loops_record_the_plain_path_on_cpu(rng):
    x = torch.from_numpy(qpsk_like(rng, 3, 10, 4))
    kernel_paths.reset()
    c = CostasLoop(0.01, 4, lead_shape=(3,), device="cpu")
    c(c.init_state(), x)
    s = SymbolSync(4, lead_shape=(3,), device="cpu")
    s(s.init_state(), x)
    rep = kernel_paths.report()
    assert rep[cuda_costas.OP] == {"cuda": 0, "plain": 1,
                                   "shapes": {"plain order4 3x40": 1}}
    assert rep[cuda_symbol_sync.OP] == {
        "cuda": 0, "plain": 1, "shapes": {"plain conj 3x40->10": 1}}


def test_wrappers_check_their_inputs():
    x = torch.zeros((3, 10), dtype=torch.complex64)
    with pytest.raises(ValueError):
        cuda_costas.costas_loop(x, torch.zeros(4), torch.zeros(3), 4, .1,
                                .1, 1.0)
    with pytest.raises(ValueError):
        cuda_costas.costas_loop(x, torch.zeros(3), torch.zeros(3), 3, .1,
                                .1, 1.0)
    z = torch.zeros(3, dtype=torch.complex64)
    with pytest.raises(ValueError):  # real sign decisions on complex input
        cuda_symbol_sync.symbol_sync(
            torch.zeros((3, 32), dtype=torch.complex64), x, torch.zeros(3),
            torch.zeros(3), z, z, 2, cuda_symbol_sync.MODE_SIGN, None, 4.0,
            .02, 1e-5, .02, 1.0)


# -- numpy models of the kernels ----------------------------------------------

ROWS, TILE = 32, 32
NEAR_BOUND = 6.0  # costas.cu kNearBound
F = np.float32


def _sgn(v):
    return np.where(v > 0, F(1), np.where(v < 0, F(-1), F(0))).astype(F)


def wrap_near(a, pi, two_pi):
    """costas.cu's select for fmodf(a, 2 pi) (+ 2 pi where negative), then
    - pi, over f32 arrays a = phase + pi with |a| < 4 pi."""
    lo = (a + two_pi).astype(F)
    lo2 = (lo + two_pi).astype(F)
    hi = (a - two_pi).astype(F)
    r = np.where(a >= two_pi, hi,
                 np.where(a >= 0, a, np.where(a >= -two_pi, lo, lo2)))
    return (r.astype(F) - pi).astype(F)


def costas_model(x, ph0, fr0, order, alpha, beta, max_freq):
    """costas_loop_f32 in numpy: blocks of ROWS rows, lane i of the chain's
    warp owning row row0 + i; tiles of TILE samples staged lane-wise by the
    other warp (lane i takes sample t0 + i of every row, 0 past the end),
    two tiles ahead; each chain lane walks its row across the tile into the
    output tile, which the other warp stores lane-wise. The wrap: fmod's path on
    a block's first tile and on a ragged tile, `wrap_near` on every other
    tile where max_freq + |alpha| <= NEAR_BOUND (in f32, as the kernel
    compares). f32 arithmetic, each operation rounded on its own; cos and
    sin from torch (the kernel's NCO, sincosf or nco_near, gives
    torch.cos/torch.sin's bits on the card for every f32). Asserts that
    every output is written once."""
    alpha, beta, max_freq = F(alpha), F(beta), F(max_freq)
    pi, two_pi = F(cuda_costas.PI), F(cuda_costas.TWO_PI)
    near = bool(F(max_freq + abs(alpha)) <= F(NEAR_BOUND))
    C, T = x.shape
    y = np.full((C, T), np.nan, np.complex64)
    ph_out = np.full(C, np.nan, F)
    fr_out = np.full(C, np.nan, F)
    for row0 in range(0, C, ROWS):
        n_rows = min(ROWS, C - row0)
        lanes = np.arange(ROWS)
        mine = lanes < n_rows
        ph = np.where(mine, ph0[np.minimum(row0 + lanes, C - 1)], F(0))
        fr = np.where(mine, fr0[np.minimum(row0 + lanes, C - 1)], F(0))

        def load(t0):
            v = np.zeros((ROWS, ROWS), np.complex64)  # [row r, lane]
            for r in range(n_rows):
                t = t0 + lanes
                ok = t < T
                v[r, ok] = x[row0 + r, t[ok]]
            return v

        v = load(0)
        for t0 in range(0, T, TILE):
            s_x = v.copy()
            v = load(t0 + TILE)
            n = min(TILE, T - t0)
            fast = near and t0 > 0 and n == TILE
            s_y = np.full((ROWS, TILE), np.nan, np.complex64)
            for j in range(n):
                xj = s_x[lanes, j]
                xr, xi = xj.real.astype(F), xj.imag.astype(F)
                c = torch.cos(torch.from_numpy(ph)).numpy()
                s = -torch.sin(torch.from_numpy(ph)).numpy()
                yr = (xr * c - xi * s).astype(F)
                yi = (xr * s + xi * c).astype(F)
                e = yi * _sgn(yr) if order == 2 else (
                    _sgn(yr) * yi - _sgn(yi) * yr)
                e = np.minimum(np.maximum(e.astype(F), F(-1)), F(1))
                fr = np.minimum(np.maximum((fr + beta * e).astype(F),
                                           -max_freq), max_freq)
                p = ((ph + fr).astype(F) + (alpha * e).astype(F)).astype(F)
                a = (p + pi).astype(F)
                if fast:
                    assert np.all(np.abs(a) < 2 * two_pi)
                    ph = wrap_near(a, pi, two_pi)
                else:
                    r = np.fmod(a, two_pi).astype(F)
                    r = np.where(r < 0, (r + two_pi).astype(F), r)
                    ph = (r - pi).astype(F)
                s_y[:, j] = yr + 1j * yi
            for r in range(n_rows):
                for lane in range(n):
                    assert np.isnan(y[row0 + r, t0 + lane])
                    y[row0 + r, t0 + lane] = s_y[r, lane]
        ph_out[row0:row0 + n_rows] = ph[:n_rows]
        fr_out[row0:row0 + n_rows] = fr[:n_rows]
    assert not np.isnan(y).any() and not np.isnan(ph_out).any()
    return y, ph_out, fr_out


# (C, T): full and ragged row blocks and tiles, a block shorter than a tile,
# one sample
COSTAS_MODEL_CASES = [(32, 64), (45, 70), (3, 31), (33, 1), (5, 160)]


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("C,T", COSTAS_MODEL_CASES)
def test_costas_model_matches_plain(rng, order, C, T):
    """The kernel's tiling, its step and its two wraps give the plain
    loop's outputs and state bit for bit, over two chained blocks; the
    carried phase starts off [-pi, pi] so that the first tile's fmod path
    wraps it."""
    x = qpsk_like(rng, C, -(-2 * T // 4), 4, offset=0.02, tiny=20)
    ph = (rng.uniform(-30.0, 30.0, C)).astype(F)
    fr = np.zeros(C, F)
    args = (order, 0.0786, 0.00309, 1.0)
    for blk in range(2):
        xb = np.ascontiguousarray(x[:, blk * T:(blk + 1) * T])
        yr, yi, ph_p, fr_p = cuda_costas.costas_loop_plain(
            torch.from_numpy(xb.real.copy()), torch.from_numpy(xb.imag.copy()),
            torch.from_numpy(ph), torch.from_numpy(fr), *args)
        y, ph, fr = costas_model(xb, ph, fr, *args)
        np.testing.assert_array_equal(y.real, yr.numpy())
        np.testing.assert_array_equal(y.imag, yi.numpy())
        np.testing.assert_array_equal(ph, ph_p.numpy())
        np.testing.assert_array_equal(fr, fr_p.numpy())


def _in_domain(a):
    """-4 pi <= a < 4 pi: where the select equals fmod's path (at a = +4 pi
    it would give +pi where fmod gives -pi; the kernel's bound keeps a
    below it)."""
    two_pi = F(cuda_costas.TWO_PI)
    return a[(a >= -2 * two_pi) & (a < 2 * two_pi)]


def _edges():
    """a = phase + pi at the select's edges (+-2 pi, +-4 pi, +-0, +-pi) and
    the next f32 either side of each, in the select's domain."""
    two_pi = F(cuda_costas.TWO_PI)
    out = []
    for v in (two_pi, 2 * two_pi, F(0), F(cuda_costas.PI)):
        for w in (v, -v):
            out += [w, np.nextafter(w, F(np.inf)), np.nextafter(w, F(-np.inf))]
    return _in_domain(np.array(out, F))


@pytest.mark.parametrize("kind", ["edges", "dense"])
def test_wrap_select_equals_fmod(rng, kind):
    """The kernel's wrap select equals wrap_pm_pi's fmod path (torch.fmod,
    then + 2 pi where negative, then - pi) bit for bit: on the edges and on
    a dense seeded sample of -4 pi < a < 4 pi (the f32s nearest 0 among
    them)."""
    two_pi = F(cuda_costas.TWO_PI)
    if kind == "edges":
        a = _edges()
        assert len(a) == 21 and np.signbit(a[a == 0]).any()
        assert -2 * two_pi in a and 2 * two_pi not in a
    else:
        a = rng.uniform(-2 * two_pi, 2 * two_pi, 2_000_000).astype(F)
        a = _in_domain(np.concatenate(
            [a, (rng.standard_normal(10_000) * 1e-30).astype(F)]))
    want = (cuda_costas.mod_2pi(torch.from_numpy(a))
            - cuda_costas.PI).numpy()
    got = wrap_near(a, F(cuda_costas.PI), two_pi)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_wrap_select_bound():
    """Where the kernel takes the select (max_freq + |alpha| <= NEAR_BOUND,
    the phase wrapped to [-pi, pi]), |phase + pi| stays below 4 pi: the
    largest reachable a, every operation rounded up, is below it."""
    pi, two_pi = F(cuda_costas.PI), F(cuda_costas.TWO_PI)
    # |phase| <= pi, then + freq, + alpha e, + pi, each rounding up by an
    # ulp at most
    assert 2 * float(pi) + NEAR_BOUND + 3 * 2.0 ** -20 < 2 * float(two_pi)
    # the QPSK and BPSK chains' loops take the select
    for loop in (CostasLoop(np.pi / 200, 4, device="cpu"),
                 CostasLoop(2 * np.pi / 200, 2, device="cpu")):
        assert F(loop.max_freq + abs(loop.alpha)) <= F(NEAR_BOUND)


def sync_model(tail, x, pos, om, yp, dp, n_out, mode, levels, sps, alpha,
               beta, omega_lim, ted_norm):
    """symbol_sync_mm_f32 in numpy, one row at a time, with its ring: the
    plan (S, R, reach) from cuda_symbol_sync.ring_plan; at each chunk's
    start the row's fill of granules [g_lo, g_hi) into slots g mod (R / G)
    (each slot remembers which sample it holds); each sample read asserted
    to be in its slot both before the chunk's copies land and after (the
    kernel's copies may land at any time during the chunk; the first
    chunk waits for its own); then the coefficients with the f32
    reciprocal of 6, the four products summed in order, the decision, the
    TED, the clip and the loop update, each f32 operation rounded on its
    own. Real input with levels takes the kernel's real-levels path (MODE
    3) where the tails' imaginary words of the row's block of 32 are all
    +0: yi is +0 without reading that plane, and the first nearest level
    by |yr - l| from a (distance, level) tree over 2, 4 or 8 levels padded
    with NaN; otherwise MODE 1's hypot over every level. Returns the
    kernel's outputs and, as a last item, the plan with how far past a
    chunk's starting position the floor of a position in that chunk or the
    next came (at most reach): (S, R, reach, used)."""
    xc = np.iscomplexobj(x)
    inv6 = F(cuda_symbol_sync.INV6)
    inv_norm = F(cuda_symbol_sync.recip(ted_norm))
    omin, omax = F(sps - omega_lim), F(sps + omega_lim)
    alpha, beta = F(alpha), F(beta)
    rows, L = tail.shape
    T = x.shape[1]
    S, R, reach = cuda_symbol_sync.ring_plan(sps, alpha, omega_lim, L + T,
                                             xc)
    G = cuda_symbol_sync.granule(xc)
    Rg = R // G
    max_pos = F(L + T - 3)
    y = np.full((rows, n_out), np.nan, np.complex64)
    out = [np.zeros(rows, F), np.zeros(rows, F),
           np.zeros(rows, np.complex64), np.zeros(rows, np.complex64)]
    used = 0.0
    real_lv = np.zeros(rows, bool)
    if mode == cuda_symbol_sync.MODE_LEVELS and not xc:
        im = np.ascontiguousarray(np.asarray(tail).imag, F).view(np.uint32)
        for r0 in range(0, rows, ROWS):
            real_lv[r0:r0 + ROWS] = not im[r0:r0 + ROWS].any()
        n_lv = len(levels)
        NL = 2 if n_lv <= 2 else (4 if n_lv <= 4 else 8)
        padded = [F(v) for v in levels] + [F(np.nan)] * (NL - n_lv)
    for r in range(rows):
        p_, o_ = F(pos[r]), F(om[r])
        ypr, ypi = F(yp[r].real), F(yp[r].imag)
        dpr, dpi = F(dp[r].real), F(dp[r].imag)

        def sample(j):
            if j < L:
                return F(tail[r, j].real), F(tail[r, j].imag)
            v = x[r, j - L]
            return (F(v.real), F(v.imag)) if xc else (F(v), F(0))

        ring = np.full(R, -1, np.int64)  # the sample each slot holds
        filled = 0
        starts, ends = [], []  # each chunk's starting position, last read
        for m0 in range(0, n_out, S):
            starts.append(p_)
            ends.append(-1)
            t = min(max(F(p_ + F(reach)), F(2)), max_pos)
            g_hi = max(filled, (int(t) + 3 + G - 1) // G)
            g_lo = max(filled, g_hi - Rg)
            landed = ring.copy()
            for g in range(g_lo, g_hi):
                ring[(g % Rg) * G:(g % Rg + 1) * G] = np.arange(G) + g * G
            filled = g_hi
            if m0 == 0:
                landed = ring
            for m in range(m0, min(m0 + S, n_out)):
                p = min(max(p_, F(2)), max_pos)
                b = F(np.floor(p))
                mu = F(p - b)
                mm1, mm2, mp1 = F(mu - F(1)), F(mu - F(2)), F(mu + F(1))
                c = [F(F(F(-mu * mm1) * mm2) * inv6),
                     F(F(F(mp1 * mm1) * mm2) * F(0.5)),
                     F(F(F(-mp1 * mu) * mm2) * F(0.5)),
                     F(F(F(mp1 * mu) * mm1) * inv6)]
                j0 = int(b) - 1
                for k in range(4):
                    slot = (j0 + k) & (R - 1)
                    assert landed[slot] == ring[slot] == j0 + k, (r, m, k)
                ends[-1] = max(ends[-1], j0 + 3)
                w = [sample(j0 + k) for k in range(4)]
                yr, yi = F(w[0][0] * c[0]), F(w[0][1] * c[0])
                for k in range(1, 4):
                    yr = F(yr + F(w[k][0] * c[k]))
                    yi = F(yi + F(w[k][1] * c[k]))
                if real_lv[r]:
                    # MODE 3: yi +0 unread; the tree of |yr - l|
                    yi = F(0)
                    d = [F(abs(F(yr - lv))) for lv in padded]
                    lvs = list(padded)
                    wd = 1
                    while wd < NL:
                        for k in range(0, NL - wd, 2 * wd):
                            if d[k + wd] < d[k]:
                                d[k], lvs[k] = d[k + wd], lvs[k + wd]
                        wd *= 2
                    dr, di = lvs[0], F(0)
                elif mode == cuda_symbol_sync.MODE_LEVELS:
                    d = [F(np.hypot(F(yr - F(lv)), yi)) for lv in levels]
                    dr, di = F(levels[int(np.argmin(d))]), F(0)
                else:
                    dr, di = F(np.sign(yr)), F(np.sign(yi))
                if mode == cuda_symbol_sync.MODE_CONJ:
                    e = F(F(F(dpr * yr) + F(dpi * yi)) - F(F(dr * ypr)
                                                            + F(di * ypi)))
                else:
                    e = F(F(F(dpr * yr) - F(dpi * yi)) - F(F(dr * ypr)
                                                            - F(di * ypi)))
                e = min(max(F(e * inv_norm), F(-1)), F(1))
                o_ = min(max(F(o_ + F(beta * e)), omin), omax)
                p_ = F(F(p_ + o_) + F(alpha * e))
                assert np.isnan(y[r, m])
                y[r, m] = yr + 1j * yi
                ypr, ypi, dpr, dpi = yr, yi, dr, di
        out[0][r], out[1][r] = p_, o_
        out[2][r], out[3][r] = ypr + 1j * ypi, dpr + 1j * dpi
        for k in range(len(starts) - 1):
            # b = floor(p) of the last symbol read: its last sample - 2
            used = max(used, ends[k + 1] - 2 - float(starts[k]))
    assert not np.isnan(y).any()
    return y, *out, (S, R, reach, used)


def _bits(a):
    """f32 and complex64 as their words: -0 and +0 apart."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype in (np.float32, np.complex64) else a


def _sync_blocks(ss, x, T, n_blocks=2, st=None, bits=False):
    """Chain SymbolSync ss over n_blocks blocks of T of x through the
    wrapper (the plain loop on the CPU) and through sync_model, from state
    st (init_state's by default); assert every output and state leaf
    equal (bits: word for word, the signs of zeros too). Returns the
    omegas after each block and the plan."""
    mode = cuda_symbol_sync.mode_of(np.iscomplexobj(x), ss.levels)
    st = ss.init_state() if st is None else st
    omegas = []
    for blk in range(n_blocks):
        xb = np.ascontiguousarray(x[:, blk * T:(blk + 1) * T])
        pos, om, yp, dp, tail = st
        args = (int(round(T / ss.sps)), mode, ss.levels, ss.sps, ss.alpha,
                ss.beta, ss.omega_limit, ss.ted_norm)
        got = cuda_symbol_sync.symbol_sync(
            tail, torch.from_numpy(xb), pos, om, yp, dp, *args)
        *want, plan = sync_model(
            tail.numpy(), xb, pos.numpy(), om.numpy(), yp.numpy(),
            dp.numpy(), *args[:2],
            None if ss.levels is None else ss.levels.numpy(), *args[3:])
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
            if bits:
                np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
        st, _ = ss(st, torch.from_numpy(xb))
        omegas.append(st[1].numpy().copy())
    return omegas, plan


@pytest.mark.parametrize("variant", ["complex_sign", "real_levels",
                                     "real_sign"])
def test_sync_model_matches_plain(rng, variant):
    """The kernel's chunks, ring fills and reads and its arithmetic give the
    plain loop's symbols and state bit for bit over two chained blocks."""
    C, T, sps = 3, 120, 4
    x = qpsk_like(rng, C, 2 * T // sps, sps, tiny=10)
    lv = None
    if variant == "real_levels":
        lv = LEVELS4
        x = np.repeat(rng.choice(LEVELS4, (C, 2 * T // sps)), sps,
                      axis=1).astype(np.float32)
    elif variant == "real_sign":
        x = np.ascontiguousarray(x.real)
    _sync_blocks(SymbolSync(sps, decisions=lv, lead_shape=(C,),
                            device="cpu"), x, T)


# the real-levels path's loops: (sps, gain_mu, gain_omega, omega_limit as a
# fraction of sps, levels) of M17's (chains/m17.py), DMR's (chains/dmr.py)
# and GMSK2K's (chains/fsk.py _binary_sync) SymbolSync
REAL_LEVELS_LOOPS = {"M17": (5, 0.085, 0.0038, 0.05, LEVELS4),
                     "DMR": (5, 0.2869, 0.005, 0.06, LEVELS4),
                     "GMSK2K": (10, 0.085, 0.0038, 0.05, (-1.0, 1.0))}


@pytest.mark.parametrize("name", sorted(REAL_LEVELS_LOOPS))
@pytest.mark.parametrize("tail_imag", [False, True])
def test_sync_model_real_levels(rng, name, tail_imag):
    """The kernel's real-levels path (sync_model's MODE 3) on 33 rows of
    real input (a block of 32 rows and one of 1): random levels held sps
    samples, smoothed, noisy, the first samples
    ~1e-20; the first symbol, at an integral position whose interpolation
    is the tail's sample there, exactly midway between the first two
    levels (the first wins). Bit for bit the plain loop's symbols and
    state, the signs of zeros compared as words, over two chained blocks;
    tail_imag: the second block of rows starts from a tail with imaginary
    words, which takes MODE 1 there and MODE 3 in the first."""
    sps, mu, g_om, lim, lv = REAL_LEVELS_LOOPS[name]
    C, T = 33, 24 * sps
    ss = SymbolSync(sps, gain_mu=mu, gain_omega=g_om, omega_limit=lim,
                    decisions=lv, lead_shape=(C,), device="cpu")
    n_sym = 2 * T // sps + 1
    x = np.repeat(rng.choice(np.asarray(lv, np.float32), (C, n_sym)), sps,
                  axis=1)[:, :2 * T]
    x = np.stack([np.convolve(r, np.ones(sps) / sps)[:2 * T] for r in x])
    x = (x + 0.05 * rng.standard_normal(x.shape)).astype(np.float32)
    x[:, :3 * sps] *= np.float32(1e-20)
    pos, om, yp, dp, tail = ss.init_state()
    b = int(pos[0])
    assert float(pos[0]) == b
    tail = tail.clone()
    tail[:, b] = (lv[0] + lv[1]) / 2
    if tail_imag:
        tail[32:] = torch.complex(tail[32:].real,
                                  torch.full_like(tail[32:].real, -0.0))
    _sync_blocks(ss, x, T, st=(pos, om, yp, dp, tail), bits=True)
    pos2, om2, yp2, dp2, tail2 = ss.init_state()
    xb = np.ascontiguousarray(x[:, :T])
    y = cuda_symbol_sync.symbol_sync(
        tail, torch.from_numpy(xb), pos2, om2, yp2, dp2, T // sps,
        cuda_symbol_sync.MODE_LEVELS, ss.levels, ss.sps, ss.alpha, ss.beta,
        ss.omega_limit, ss.ted_norm)[0]
    assert float(y[0, 0].real) == float(np.float32((lv[0] + lv[1]) / 2))


@pytest.mark.parametrize("name", sorted(SYNC_STRESS))
def test_sync_model_on_the_stress_input(name):
    """On the stress ramps (tests/test_torch_cuda.stress_ramps) omega sits
    at omax (rows up) and omin (rows down) and |e| at 1, so the positions
    advance as far as the ring plan allows for: the model, its ring
    asserted on every read, equals the plain loop over two chained blocks,
    and the reads of some chunk and the next reach within 2 samples of the
    plan's reach."""
    kw, lv = SYNC_STRESS[name]
    C, T = 4, 1200
    ss = SymbolSync(decisions=lv, lead_shape=(C,), device="cpu", **kw)
    x = stress_ramps(C, 2 * T, lv is None)
    omegas, (S, R, reach, used) = _sync_blocks(ss, x, T)
    omax, omin = F(ss.sps + ss.omega_limit), F(ss.sps - ss.omega_limit)
    for om in omegas:
        assert np.all(om[0::2] == omax) and np.all(om[1::2] == omin), om
    assert reach - 2 <= used <= reach, (used, reach)


# every SymbolSync the JAX package's chains build: (sps, gain_mu,
# gain_omega, omega_limit as SymbolSync takes it, a fraction of sps)
JAX_SYNCS = {
    # qradiolink_tpu/chains/psk.py:136 (QpskDemod, the default gains)
    "QPSK250K": (4, 0.02, 1e-5, 0.0016),
    "QPSK20K": (4, 0.02, 1e-5, 0.02),
    "QPSK2K": (40, 0.2, 1e-4, 0.2),
    # qradiolink_tpu/chains/psk.py:54 (BpskDemod)
    "BPSK2K": (10, 0.05, 2.5e-5, 0.001),
    "BPSK1K": (20, 0.05, 2.5e-5, 0.001),
    # qradiolink_tpu/chains/fsk.py:92 (Fsk4Demod variants)
    "4FSK2K": (10, 0.085, 0.0038, 0.05),
    "4FSK10KFM": (8, 0.085, 0.0038, 0.05),
    "4FSK100K": (5, 0.085, 0.0038, 0.05),
    # qradiolink_tpu/chains/fsk.py:309 (4FSK filter bank), :357 (2FSK),
    # :436 (2FSK filter bank)
    "4FSK2KFB": (10, 0.085, 0.0038, 0.05),
    "2FSK2K": (10, 0.085, 0.0038, 0.05),
    "2FSK1K": (20, 0.085, 0.0038, 0.05),
    "2FSK10K": (4, 0.085, 0.0038, 0.05),
    # qradiolink_tpu/chains/m17.py:64
    "M17": (5, 0.085, 0.0038, 0.05),
    # qradiolink_tpu/chains/dmr.py:72: the largest gain_mu
    "DMR": (5, 0.2869, 0.005, 0.06),
}


@pytest.mark.parametrize("name", sorted(JAX_SYNCS))
@pytest.mark.parametrize("complex_in", [True, False])
def test_ring_plan_covers_the_worst_advance(name, complex_in):
    """For each chain's loop, the plan's reach covers 2S - 1 symbols of the
    largest advance (omega at its limit, |e| = 1), and its ring holds that
    reach, the granule and the 4 taps: R >= reach + G + 6, R <= RING_MAX.
    A block of 200,000 samples (the paths' step), its tail included."""
    sps, mu, _, lim = JAX_SYNCS[name]
    ss = SymbolSync(sps, gain_mu=mu, omega_limit=lim, device="cpu")
    total = 200_000 + ss.tail_len
    S, R, reach = cuda_symbol_sync.ring_plan(ss.sps, ss.alpha,
                                             ss.omega_limit, total,
                                             complex_in)
    adv = float(F(ss.sps + ss.omega_limit)) + abs(float(F(ss.alpha)))
    assert S in cuda_symbol_sync.CHUNKS and R & (R - 1) == 0
    assert reach >= (2 * S - 1) * adv + 1.0
    assert reach + cuda_symbol_sync.granule(complex_in) + 6 <= R
    assert R <= cuda_symbol_sync.RING_MAX
    assert float(F(ss.sps - ss.omega_limit)) - abs(float(F(ss.alpha))) > 0
    if name in ("QPSK250K", "BPSK2K", "DMR", "M17"):
        assert S == 16  # the driven paths and the next ports: full chunks


@pytest.mark.parametrize("sps,mu,lim", [(600, 0.05, 0.001),
                                        (4, 5.0, 0.005), (4, 0.02, 1.1)])
def test_sync_wrapper_raises_where_the_ring_cannot_serve(sps, mu, lim):
    """Parameters whose advance a symbol outgrows the largest ring (sps
    600), or whose position can step back (gain_mu 5 at sps 4; omega down
    to 0): the plan and the wrapper raise, on the CPU as on the card."""
    with pytest.raises(ValueError):
        cuda_symbol_sync.ring_plan(sps, mu, lim * sps, 10_000, True)
    ss = SymbolSync(sps, gain_mu=mu, omega_limit=lim, lead_shape=(2,),
                    device="cpu")
    with pytest.raises(ValueError):
        ss(ss.init_state(), torch.zeros((2, 4 * sps), dtype=torch.complex64))


# fll_band_edge_f32's outputs a lane a pass and the warp's pass
FLL_R, FLL_PASS = 4, 128


def fll_padded(i):
    """Shared-memory word of logical word i of [tail | y]."""
    return i + i // FLL_R


def fll_ring_reads(K):
    """The buffer words each FMA of a pass reads for the lane whose first
    output is m0 = 0, by running the kernel's ring over the padded layout
    (fill of kR - 1 slots, K // kR groups of kR steps with q advanced by
    kR + 1 words, then K mod kR steps under `u < rem`). Returns
    [(j, v, logical word)] in issue order."""
    R = FLL_R
    unpad = {fll_padded(i): i for i in range(4 * R + K)}
    ring = {s: unpad[s] for s in range(R - 1)}
    reads, q, j = [], 0, 0
    for us in [range(R)] * (K // R) + [range(K % R)]:
        for u in us:
            c = u + R - 1
            ring[(u + R - 1) % R] = unpad[q + c + c // R]
            reads += [(j, v, ring[(u + v) % R]) for v in range(R)]
            j += 1
        q += R + 1
    return reads


def _fma32(a, b, c):
    """fmaf(a, b, c) of f32 arrays: the exact product plus c, rounded in
    f64 then to f32 (equal to one rounding but where the f64 sum is a tie
    for f32; the model is held to a bound, not to bits)."""
    return (a.astype(np.float64) * b + c).astype(F)


def fll_model(xr, xi, ph, fr, tail, taps, beta, max_freq, sb):
    """fll_band_edge_f32 in numpy, every row at once (a warp a row): for
    each sub-block, the derotation in f32 with each product and sum
    rounded (cos and sin from torch, which the kernel's cosf/sinf equal on
    the card), the four FIRs a filter summed with fmaf in tap order from 0
    over the words x2-style ring reads name, |U|^2 - |L|^2, lane l's sum of
    its outputs m = pass 128 + 4 l + u in pass then u order from 0, the
    xor butterfly over the 32 lanes (offsets 16 .. 1, asserting that every
    lane ends with the same bits), times the f32 of 1/sb, then the clip
    and the update; the tail is the last K-1 words of [tail | y].
    xr, xi: (C, T) f32; ph, fr: (C,) f32; tail: (C, K-1) complex64; taps
    (4, K). Returns (y complex64, phase, freq, tail)."""
    C, T = xr.shape
    K = taps.shape[1]
    k1 = K - 1
    reads = np.array(fll_ring_reads(K))
    assert all(w == j + v for j, v, w in reads)
    beta, max_freq = F(beta), F(max_freq)
    inv, sb_f, two_pi = F(cuda_fll.inv_sb(sb)), F(sb), F(cuda_costas.TWO_PI)
    n = np.arange(sb, dtype=F)
    n_pass = -(-sb // FLL_PASS)
    lanes = np.arange(32)
    bre, bim = tail.real.astype(F), tail.imag.astype(F)
    ys = np.zeros((C, T), np.complex64)
    for k in range(T // sb):
        ar, ai = xr[:, k * sb:(k + 1) * sb], xi[:, k * sb:(k + 1) * sb]
        p = (ph[:, None] + (fr[:, None] * n).astype(F)).astype(F)
        c = torch.cos(torch.from_numpy(p)).numpy()
        s = -torch.sin(torch.from_numpy(p)).numpy()
        yr = ((ar * c).astype(F) - (ai * s).astype(F)).astype(F)
        yi = ((ar * s).astype(F) + (ai * c).astype(F)).astype(F)
        ys[:, k * sb:(k + 1) * sb] = yr + 1j * yi
        # the buffer's logical words, the passes' spare words zero
        n_buf = n_pass * FLL_PASS + K - 1
        wr = np.zeros((C, n_buf), F)
        wi = np.zeros((C, n_buf), F)
        wr[:, :k1], wr[:, k1:k1 + sb] = bre, yr
        wi[:, :k1], wi[:, k1:k1 + sb] = bim, yi
        m = np.arange(n_pass * FLL_PASS)
        acc = np.zeros((8, C, m.size), F)
        for j in range(K):
            sr, si = wr[:, m + j], wi[:, m + j]
            t = taps[:, j]
            for a, (tv, sv) in enumerate([(t[0], sr), (t[0], si),
                                          (t[1], sr), (t[1], si),
                                          (t[2], sr), (t[2], si),
                                          (t[3], sr), (t[3], si)]):
                acc[a] = _fma32(tv, sv, acc[a])
        urr, uir, uri, uii, lrr, lir, lri, lii = acc
        ur, ui = (urr - uii).astype(F), (uri + uir).astype(F)
        lr, li = (lrr - lii).astype(F), (lri + lir).astype(F)
        e = (((ur * ur).astype(F) + (ui * ui).astype(F)).astype(F)
             - ((lr * lr).astype(F) + (li * li).astype(F)).astype(F)
             ).astype(F)
        # output m = pass 128 + 4 lane + u
        e = e.reshape(C, n_pass, 32, FLL_R)
        valid = (m < sb).reshape(n_pass, 32, FLL_R)
        lane_sum = np.zeros((C, 32), F)
        for ps in range(n_pass):
            for u in range(FLL_R):
                lane_sum = np.where(valid[ps, :, u],
                                    (lane_sum + e[:, ps, :, u]).astype(F),
                                    lane_sum)
        for off in (16, 8, 4, 2, 1):
            lane_sum = (lane_sum + lane_sum[:, lanes ^ off]).astype(F)
        assert (lane_sum == lane_sum[:, :1]).all()
        err = np.clip((lane_sum[:, 0] * inv).astype(F), F(-1), F(1))
        fr_new = np.clip((fr + (beta * err).astype(F)).astype(F), -max_freq,
                         max_freq).astype(F)
        r = np.fmod((ph + (fr * sb_f).astype(F)).astype(F), two_pi)
        ph = np.where(r < 0, (r + two_pi).astype(F), r).astype(F)
        fr = fr_new
        bre, bim = wr[:, sb:sb + k1].copy(), wi[:, sb:sb + k1].copy()
    return ys, ph, fr, (bre + 1j * bim).astype(np.complex64)


# (rows, samples a block): QPSK250K's sub-blocks of 500 (4 passes, the last
# of 116 outputs); 1,250 (sub-blocks of 250: a lane with 2 of its 4
# outputs); 1,001 (sub-blocks of 143, odd)
FLL_MODEL_CASES = [(3, 2000), (2, 1250), (2, 1001)]


@pytest.mark.parametrize("C,T", FLL_MODEL_CASES)
def test_fll_model_matches_plain(rng, C, T):
    """The kernel's schedule against the plain FllBandEdge loop over two
    chained blocks of a signal 0.05 rad/sample off, its first samples
    ~1e-20: y and every state leaf within the FLL's bound, 2e-5 + 1e-5
    |plain|."""
    x = qpsk_like(rng, C, 2 * T // 4 + 1, 4, offset=0.05)[:, :2 * T]
    fll = FllBandEdge(4, 0.35, 32, 2 * np.pi / 100, lead_shape=(C,),
                      device="cpu")
    sb = fll.sub_block_len(T)
    taps = fll.taps.numpy()
    st = fll.init_state()
    ph, fr, tail = (v.numpy() for v in st)
    for blk in range(2):
        xb = np.ascontiguousarray(x[:, blk * T:(blk + 1) * T])
        st, want = fll(st, torch.from_numpy(xb))
        got = fll_model(xb.real.astype(F), xb.imag.astype(F), ph, fr, tail,
                        taps, fll.beta, fll.max_freq, sb)
        for g, w in zip(got, (want,) + tuple(st)):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-5, atol=2e-5)
        ys, ph, fr, tail = got
    assert np.all(fr > 5e-4)  # pulling toward the offset


@pytest.mark.parametrize("K", [2, 5, 31, 32, 33, 65])
def test_fll_ring_reads_every_tap_in_order(K):
    """Every FMA reads word j + v at tap j, and each output adds its taps
    j = 0 .. K-1 in order (fir_s1_f32's order)."""
    reads = fll_ring_reads(K)
    assert len(reads) == K * FLL_R
    for v in range(FLL_R):
        assert [j for j, vv, _ in reads if vv == v] == list(range(K))


def test_fll_records_its_path_on_cpu(rng):
    x = torch.from_numpy(qpsk_like(rng, 3, 250, 4))
    fll = FllBandEdge(4, 0.35, 32, 2 * np.pi / 100, lead_shape=(3,),
                      device="cpu")
    kernel_paths.reset()
    fll(fll.init_state(), x)
    assert kernel_paths.report() == {cuda_fll.OP: {
        "cuda": 0, "plain": 1, "shapes": {"plain 3x1000 sb500": 1}}}


def test_fll_wrapper_checks_its_inputs():
    x = torch.zeros((3, 1000))
    z = torch.zeros(3)
    tail = torch.zeros((3, 31), dtype=torch.complex64)
    taps = torch.zeros((4, 32))
    for args in [(x, x, z, z, tail, taps, .1, 1., 300),   # T % sb
                 (x, x, z, z, tail[:, :30], taps, .1, 1., 500),
                 (x, x, torch.zeros(4), z, tail, taps, .1, 1., 500),
                 (x, x.double(), z, z, tail, taps, .1, 1., 500),
                 (x, x, z, z, tail.real, taps, .1, 1., 500)]:
        with pytest.raises(ValueError):
            cuda_fll.fll_band_edge(*args)


def test_models_follow_the_sources():
    """The models' block and tile sizes, wraps, ring plan and reads, and the
    sources' rounding rules."""
    src = (CSRC / "costas.cu").read_text()
    assert int(re.search(r"kRows = (\d+);", src).group(1)) == ROWS
    assert int(re.search(r"kTile = (\d+);", src).group(1)) == TILE
    assert float(re.search(r"kNearBound = ([\d.]+)f;", src).group(1)) \
        == NEAR_BOUND
    for line in [
            "sincosf(ph, &sn, &c);",
            "const float a = __fadd_rn(p, pi);",
            "const float lo = __fadd_rn(a, two_pi);",
            "const float lo2 = __fadd_rn(lo, two_pi);",
            "const float hi = __fsub_rn(a, two_pi);",
            "r = a >= two_pi ? hi",
            ": (a >= 0.0f ? a : (a >= -two_pi ? lo : lo2));",
            "r = fmodf(a, two_pi);",
            "if (r < 0.0f) r = __fadd_rn(r, two_pi);",
            "return __fsub_rn(r, pi);",
            "if (NEAR && t0 > 0 && n == kTile) {",
            "const bool near = max_freq + fabsf(alpha) <= kNearBound;",
            "nco_near(ph, c, s);  // |ph| <= pi",
            "if (fabsf(ph[i]) < 105615.0f)",
            # warp 1 stages x two tiles ahead and stores y behind
            "stage(s_x[b], x, row0, n_rows, T, t0 + 2 * kTile, lane);",
            "bar_sync(3 + b);  // warp 0 wrote s_y[b] and is done with s_x[b]",
            "bar_sync(1 + b);  // s_x[b] holds tile t; s_y[b]'s tile t - 2 is out",
            "bar_arrive(3 + b);"]:
        assert line in src, line
    assert "__sinf(" not in src and "__cosf(" not in src \
        and "__fmul_rn" in src
    sync = (CSRC / "symbol_sync.cu").read_text()
    # sign(s) u in both kernels: u above 0, -u below, 0 u otherwise (NaN)
    for text in (src, sync):
        for line in ['const float z = __fmul_rn(0.0f, u);',
                     '"setp.gt.f32 gt, %1, 0f00000000;',
                     '"setp.lt.f32 lt, %1, 0f00000000;',
                     '"selp.f32 %0, %3, %2, lt;',
                     '"selp.f32 %0, %4, %0, gt;',
                     ': "f"(s), "f"(z), "f"(-u), "f"(u));']:
            assert line in text, line
    assert "kInv6 = 1.0f / 6.0f" in sync and "__fdiv_rn" not in sync
    assert "hypotf" in sync
    # the real-levels path (MODE 3): the tails' imaginary words checked,
    # yi +0 unread, the tree of |yr - l| over NaN-padded levels
    for line in [
            "for (int i = threadIdx.x; i < n; i += 2 * kRows) bits |= im[2 * i];",
            "if (__syncthreads_or(bits != 0u)) {",
            "run<false, 1, NL>(QRL_RUN_ARGS);",
            "yi = MODE == 3 ? 0.0f : __fmul_rn(w[0].y, c[0]);",
            "if (MODE != 3) yi = __fadd_rn(yi, __fmul_rn(w[k].y, c[k]));",
            "dr = nearest<NL>(yr, lv);",
            "d[k] = fabsf(__fsub_rn(yr, lv[k]));",
            "for (int w = 1; w < NL; w *= 2) {",
            "for (int k = 0; k + w < NL; k += 2 * w) {",
            "const bool right = d[k + w] < d[k];",
            ": (MODE == 3 ? __int_as_float(0x7fc00000) : 0.0f);",
            "fill<XC, MODE != 3>(my_re, my_im, g_lo, g_hi, R, trow, xrow, L);",
            "MODE == 3 ? 0.0f : my_im[s]);",
            "else if (n_lv <= 2)",
            "err = launch<false, 3, 2>(QRL_SYNC_ARGS);",
            "err = launch<false, 3, 4>(QRL_SYNC_ARGS);",
            "err = launch<false, 1, kMaxLevels>(QRL_SYNC_ARGS);"]:
        assert line in sync, line
    assert f"constexpr int kMaxRing = {cuda_symbol_sync.RING_MAX};" in sync
    assert f"constexpr int kMaxChunk = {cuda_symbol_sync.CHUNKS[0]};" in sync
    assert (f"R < {cuda_symbol_sync.RING_MIN} || R > kMaxRing"
            in sync)
    assert cuda_symbol_sync.granule(True) == 2 \
        and cuda_symbol_sync.granule(False) == 4
    for line in [
            "static constexpr int G = XC ? 2 : 4;",
            "const float t = fminf(fmaxf(__fadd_rn(p, reach), 2.0f), "
            "max_pos);",
            "const int g_hi = mine ? max(filled, ((int)t + 3 + G - 1) / G) "
            ": 0;",
            "const int g_lo = max(filled, g_hi - Rg);",
            "const int slot = (g & (Rg - 1)) * G;",
            # the fill warp copies from each chunk's posted positions and
            # posts their landing; the chain waits for chunk j - 1's
            "const float p = s_pos[j & 1][lane];",
            "bar_arrive(3 + (j & 1));",
            "bar_arrive(1 + (j & 1));",
            "if (j == 0)", "bar_sync(3);", "else if (j > 1)",
            "bar_sync(3 + ((j - 1) & 1));",
            "const int s = (j0 + k) & (R - 1);"]:
        assert line in sync, line
    for name in ("costas", "symbol_sync"):
        assert kernels._EXTRA[name] == ["--fmad=false"]
    assert not any("fast_math" in f for f in kernels._FLAGS)
    fll = (CSRC / "fll_band_edge.cu").read_text()
    for line in [
            f"constexpr int kR = {FLL_R};",
            "constexpr int kPass = 32 * kR;",
            "constexpr int padded(int i) { return i + i / kR; }",
            # the derotation
            "const float p = __fadd_rn(ph, __fmul_rn(fr, (float)n));",
            "const float c = cosf(p);", "const float s = -sinf(p);",
            "const float yr = __fsub_rn(__fmul_rn(ar, c), __fmul_rn(ai, s));",
            "const float yi = __fadd_rn(__fmul_rn(ar, s), __fmul_rn(ai, c));",
            "s_r[padded(k1 + n)] = yr;",
            # the passes and the ring
            "for (int m0 = lane * kR; m0 < sb; m0 += kPass) {",
            "const int q0 = (m0 / kR) * (kR + 1);",
            "wr[(u + kLast) % kR] = qr[c + c / kR];",
            "urr[v] = fmaf(t.x, sr, urr[v]);",
            "uii[v] = fmaf(t.y, si, uii[v]);",
            "lri[v] = fmaf(t.w, sr, lri[v]);",
            "if (u < rem) step(u, h[u]);",
            # the energy, the sums and the update
            "const float ur = __fsub_rn(urr[v], uii[v]);",
            "const float ui = __fadd_rn(uri[v], uir[v]);",
            "e_sum = __fadd_rn(e_sum, e);",
            "for (int off = 16; off > 0; off >>= 1)",
            "e_sum = __fadd_rn(e_sum, __shfl_xor_sync(0xffffffffu, e_sum,",
            "const float err = fminf(fmaxf(__fmul_rn(e_sum, inv_sb), -1.0f),",
            "fmaxf(__fadd_rn(fr, __fmul_rn(beta, err)), -max_freq), max_freq);",
            "float r = fmodf(__fadd_rn(ph, __fmul_rn(fr, sb_f)), two_pi);",
            "if (r < 0.0f) r = __fadd_rn(r, two_pi);",
            "tr[h] = s_r[padded(sb + i)];"]:
        assert line in fll, line
    assert "__sinf(" not in fll and "__cosf(" not in fll
    assert "fll_band_edge" in kernels._EXTRA and \
        kernels._EXTRA["fll_band_edge"] == ["--fmad=false"]
