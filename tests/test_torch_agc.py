"""Agc2 of the port against the JAX package's on the CPU, and the numpy
model of its kernel `agc2_gain_f32` (csrc/agc2.cu) against the plain loop.

Tolerances: the plain loop repeats the reference's operations in its
order, each rounded on its own; the magnitude of complex input is
torch.abs (a hypot) where XLA scales by the larger plane, which can differ
in the last bit. Outputs and the carried gain are held to 1e-6 relative.
The kernel's model is held to the plain loop bit for bit, as the kernel is
on the card (tests/test_torch_cuda.py).
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
    rep = kernel_paths.report()[cuda_agc.OP]
    assert rep["cuda"] == 0 and rep["shapes"] == {"plain 3x40": 1}


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
