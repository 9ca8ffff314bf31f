"""FIR stages of the port against the JAX package: firdes taps, conv1d_valid,
FirFilter and RationalResampler streamed with state, and the plain version
of the `fir_stream_f32` kernel against the JAX Pallas kernels it replaces
(banded_fir_stream, banded_fir), run in interpret mode. Tolerance: 1e-5,
the bound the JAX package holds its own FIR kernels to
(tests/test_pallas_kernels.py)."""

import functools
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import qradiolink_tpu.ops.pallas_fir as pf  # noqa: E402
from qradiolink_tpu.ops import firdes as jfirdes  # noqa: E402
from qradiolink_tpu.ops import fir as jfir  # noqa: E402
from qradiolink_tpu.ops.resample import (  # noqa: E402
    RationalResampler as JaxResampler, design_resampler_taps)
from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF  # noqa: E402
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod  # noqa: E402
from qradiolink_tpu_torch.chains.ssb import SsbDemod  # noqa: E402
from qradiolink_tpu_torch.chains.wbfm import WbfmDemod  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.ops import firdes, fir  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_fir import (  # noqa: E402
    fir_route, fir_stream, fir_stream_plain, route, s1_takes)
from qradiolink_tpu_torch.ops.resample import RationalResampler  # noqa: E402
from qradiolink_tpu_torch.utils import sass  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.test_torch_cuda import (  # noqa: E402
    COLS_CASES, LONG_CASES, S1_CASES, cols_taps, long_taps, s1_taps)
from tests.torch_parity import stream_both  # noqa: E402

# the three designs of the 4FSK main path (chains/fsk.py, 2KFM)
DESIGNS = {
    "head": ("low_pass", (1.0, 1_000_000, 10_000, 10_000,
                          "blackman_harris")),
    "chan_lp": ("low_pass", (1.0, 20_000, 3000.0, 1500.0,
                             "blackman_harris")),
    "rrc": ("root_raised_cosine", (1.5, 20_000, 2_000, 0.2, 251)),
}


def _taps(name, mod=firdes):
    fn, args = DESIGNS[name]
    return getattr(mod, fn)(*args)


@pytest.fixture
def pallas_interp(monkeypatch):
    """Run the JAX package's Pallas FIR kernels in interpret mode on the CPU
    (the pattern of tests/test_pallas_kernels.py)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(pf, "available", lambda: True)
    monkeypatch.setattr(pf, "_MIN_ELEMS", 1)
    pf.plan.cache_clear()
    pf.stream_plan.cache_clear()
    yield
    pf.plan.cache_clear()
    pf.stream_plan.cache_clear()


@pytest.mark.parametrize("name", sorted(DESIGNS))
def test_firdes_taps_identical(name):
    a, b = _taps(name), _taps(name, jfirdes)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


@pytest.mark.parametrize("complex_x", [False, True])
@pytest.mark.parametrize("name,D", [("chan_lp", 1), ("head", 50)])
def test_conv1d_valid_matches_jax(rng, name, D, complex_x):
    taps = _taps(name)
    n = 2000 + len(taps) - 1
    x = rng.standard_normal((3, n)).astype(np.float32)
    if complex_x:
        x = (x + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    ref = np.asarray(jfir.conv1d_valid(jnp.asarray(x), jnp.asarray(taps), D))
    got = fir.conv1d_valid(torch.from_numpy(x), taps, D).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    out = fir.conv1d_valid(torch.from_numpy(x), taps, D, out_len=7)
    np.testing.assert_array_equal(out.numpy(), got[:, :7])


@pytest.mark.parametrize("kind", ["pair", "real", "complex", "real_short"])
def test_fir_filter_streamed(rng, kind):
    """real_short: blocks of 30 samples, shorter than the 54-sample tail, so
    the new tail takes part of the old one."""
    taps = _taps("chan_lp")
    T = 30 if kind == "real_short" else 2000
    blocks = []
    for _ in range(2):
        re = rng.standard_normal((3, T)).astype(np.float32)
        im = rng.standard_normal((3, T)).astype(np.float32)
        blocks.append({"pair": (re, im), "real": re, "real_short": re,
                       "complex": (re + 1j * im).astype(np.complex64)}[kind])
    stream_both(jfir.FirFilter(taps, impl="conv", lead_shape=(3,)),
                fir.FirFilter(taps, lead_shape=(3,), device="cpu"), blocks)


def test_rrc_filter_streamed_real(rng):
    """The RRC as the chain runs it: real input, 251 taps; the JAX package
    picks its FFT implementation here on the CPU (impl="auto")."""
    taps = _taps("rrc")
    blocks = [rng.standard_normal((3, 4000)).astype(np.float32)
              for _ in range(2)]
    stream_both(jfir.FirFilter(taps, lead_shape=(3,)),
                fir.FirFilter(taps, lead_shape=(3,), device="cpu"), blocks)


@pytest.mark.parametrize("kind", ["pair", "complex"])
@pytest.mark.parametrize("L,M", [(1, 50), (2, 25)])
def test_rational_resampler_streamed(rng, L, M, kind):
    taps = _taps("head") if L == 1 else design_resampler_taps(L, M)
    blocks = []
    for _ in range(2):
        re = rng.standard_normal((2, 5000)).astype(np.float32)
        im = rng.standard_normal((2, 5000)).astype(np.float32)
        blocks.append((re, im) if kind == "pair"
                      else (re + 1j * im).astype(np.complex64))
    stream_both(JaxResampler(L, M, taps=taps, lead_shape=(2,)),
                RationalResampler(L, M, taps, lead_shape=(2,),
                                  device="cpu"), blocks)


def test_resampler_rejects_ragged_block():
    rs = RationalResampler(1, 50, _taps("head"), device="cpu")
    x = torch.zeros(4990)
    with pytest.raises(ValueError):
        rs(rs.init_state(), IqPair(x, x))


def test_plain_fir_matches_pallas_stream(pallas_interp, rng):
    """fir_stream's plain version (K1 form, carried tail) against the Pallas
    banded_fir_stream over two chained blocks, at (8, 40000)."""
    taps = _taps("head")
    k1, D, C, T = len(taps) - 1, 50, 8, 40_000
    tf = fir.flipped_taps(taps, "cpu")
    tails = [np.zeros((C, k1), np.float32)] * 2
    for _ in range(2):
        xs = [rng.standard_normal((C, T)).astype(np.float32)
              for _ in range(2)]
        res = pf.banded_fir_stream(tuple(jnp.asarray(t) for t in tails),
                                   tuple(jnp.asarray(x) for x in xs),
                                   taps, D, T // D)
        assert res is not None, "Pallas stream kernel did not run"
        ys, n_main = res
        got = fir_stream_plain([torch.from_numpy(x) for x in xs], tf, D,
                               T // D, tails=[torch.from_numpy(t)
                                              for t in tails])
        for y, g in zip(ys, got):
            np.testing.assert_allclose(g.numpy()[:, :n_main], np.asarray(y),
                                       rtol=1e-5, atol=1e-5)
        tails = [x[:, -k1:] for x in xs]


@pytest.mark.parametrize("complex_x", [False, True])
def test_plain_fir_matches_pallas_banded(pallas_interp, rng, complex_x):
    """fir_stream's plain version (K2 form, no tail) against the Pallas
    banded_fir, at (8, 40000 + K - 1)."""
    taps = _taps("head")
    n = 40_000 + len(taps) - 1
    x = rng.standard_normal((8, n)).astype(np.float32)
    if complex_x:
        x = (x + 1j * rng.standard_normal((8, n))).astype(np.complex64)
    ref = pf.banded_fir(jnp.asarray(x), taps, 50, None)
    assert ref is not None, "Pallas banded kernel did not run"
    got = fir.conv1d_valid(torch.from_numpy(x), taps, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_records_plain_path_on_cpu():
    kernel_paths.reset()
    x = torch.zeros(2, 100)
    tf = torch.ones(5)
    fir_stream((x, x), tf, 5, 20, tails=(x[:, :4], x[:, :4]))
    rep = kernel_paths.report()["fir_stream_f32"]
    assert rep["cuda"] == 0 and rep["plain"] == 1
    assert rep["shapes"] == {"plain K5 D5 tail 2x2": 1}
    assert not kernel_paths.served_only()


@pytest.mark.parametrize("bad", ["n_out", "dtype", "tail_shape"])
def test_wrapper_rejects_bad_input(bad):
    x = torch.zeros(2, 100)
    tf = torch.ones(5)
    kw = {"n_out": 20, "tails": (x[:, :4],)}
    xs = (x,)
    if bad == "n_out":
        kw["n_out"] = 21
    elif bad == "dtype":
        xs = (x.double(),)
    else:
        kw["tails"] = (x[:, :3],)
    with pytest.raises(ValueError):
        fir_stream(xs, tf, 5, **kw)


# ---- fir_decim_f32 (csrc/fir_decim.cu): a numpy model of its loop -------

def decim_model(tails, xs, tf, D, shift, n_out):
    """numpy model of fir_decim_f32's polyphase loop, line for line: the
    taps padded to A*D in two phase columns a lane, chunks of MW outputs a
    warp, rows of D loaded per lane with the tail/x seam resolved per
    element and loads past the stream reading 0, the ring of A
    accumulators, and the 32 x 32 tile of lane partials summed lane by
    lane every 32 outputs. tails: one (C, K-1) array per plane, or None;
    xs: (C, T)."""
    K = tf.shape[0]
    A = -(-K // D)
    NG = (256 + A - 1) // A + 1
    MW = (NG - 1) * A + 1
    lane = np.arange(32)
    has0, has1 = lane < D, lane + 32 < D
    j = np.arange(A)[:, None] * D + lane
    t0 = np.where(has0 & (j < K), tf[np.minimum(j, K - 1)], 0)
    t1 = np.where(has1 & (j + 32 < K), tf[np.minimum(j + 32, K - 1)], 0)
    t0, t1 = t0.astype(np.float32), t1.astype(np.float32)
    ys = []
    for p, x in enumerate(xs):
        C, T = x.shape
        tail = np.zeros((C, 0), np.float32) if tails is None else tails[p]
        tail_len = tail.shape[1]
        n_in = tail_len + T

        def load(v, has):
            ok = has & (v < n_in)
            vt = np.clip(v, 0, max(tail_len - 1, 0))
            vx = np.clip(v - tail_len, 0, T - 1)
            val = np.where(v < tail_len, tail[:, vt] if tail_len else 0,
                           x[:, vx])
            return np.where(ok, val, 0).astype(np.float32)

        y = np.full((C, n_out), np.nan, np.float32)
        for m0 in range(0, n_out, MW):
            m_end = min(m0 + MW, n_out)
            acc = np.zeros((A, C, 32), np.float32)
            red = np.zeros((C, 32, 32), np.float32)  # [output, lane]
            for r in range(NG * A):
                if r % A == 0 and m0 + r - (A - 1) >= m_end:
                    break
                v = (m0 + r) * D + shift + lane
                x0, x1 = load(v, has0), load(v + 32, has1)
                u = r % A
                for a in range(A):
                    s = (u - a) % A
                    acc[s] = acc[s] + t0[a] * x0
                    acc[s] = acc[s] + t1[a] * x1
                s = (u + 1) % A
                jo = r - (A - 1)
                if jo >= 0 and m0 + jo < m_end:
                    red[:, jo & 31] = acc[s]
                    if jo & 31 == 31 or m0 + jo == m_end - 1:
                        total = np.zeros((C, 32), np.float32)
                        for k in range(32):
                            total = total + red[:, :, k]
                        n = (jo & 31) + 1
                        base = m0 + (jo & ~31)
                        y[:, base: base + n] = total[:, :n]
                acc[s] = 0
        ys.append(y)
    return ys


# name: (C, T, K, D, shift, planes, tail); the head's taps at K 419, seeded
# random taps elsewhere
DECIM_CASES = {
    "head": (4, 20_000, 419, 50, 0, 2, True),
    "k_multiple_of_d": (4, 10_000, 400, 50, 0, 2, True),
    "k_below_d": (4, 10_000, 40, 50, 0, 2, True),
    "shift": (4, 10_000, 419, 50, 12, 2, True),
    "ragged_chunk": (3, 13_150, 419, 50, 0, 2, True),  # n_out = MW + 1
    "one_row_one_plane": (1, 5000, 419, 50, 0, 1, True),
    "no_tail": (4, 10_000, 419, 50, 0, 1, False),
    "d64_a16": (2, 64 * 300, 1024, 64, 0, 2, True),
    "d32": (2, 32 * 300, 100, 32, 5, 2, True),
}


def decim_case(name, rng):
    """numpy inputs of one case: (tails or None, xs, tf, D, shift, n_out)."""
    C, T, K, D, shift, planes, tail = DECIM_CASES[name]
    if K == 419:
        tf = _taps("head")[::-1].astype(np.float32)
    else:
        tf = (rng.standard_normal(K) / np.sqrt(K)).astype(np.float32)
    xs = [rng.standard_normal((C, T)).astype(np.float32)
          for _ in range(planes)]
    tails = ([rng.standard_normal((C, K - 1)).astype(np.float32)
              for _ in range(planes)] if tail else None)
    n_out = (T // D) if tail else (T - shift - K) // D + 1
    return tails, xs, np.ascontiguousarray(tf), D, shift, n_out


@pytest.mark.parametrize("name", sorted(DECIM_CASES))
def test_decim_model_matches_plain(rng, name):
    """The kernel's index math (the numpy model) against fir_stream_plain,
    within the FIR's 1e-5."""
    tails, xs, tf, D, shift, n_out = decim_case(name, rng)
    K = tf.shape[0]
    assert route(K, D) == "fir_decim_f32"
    got = decim_model(tails, xs, tf, D, shift, n_out)
    ref = fir_stream_plain(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(tf), D, n_out,
        tails=None if tails is None else [torch.from_numpy(t)
                                          for t in tails], shift=shift)
    for g, r in zip(got, ref):
        assert not np.isnan(g).any(), "an output was never written"
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stage,want", [
    ("fsk head K419 D50", "fir_decim_f32"),
    ("fsk channel LP K55 D1", "fir_s1_f32"),
    ("fsk RRC K251 D1", "fir_s1_f32"),
    ("nbfm head K2239 D50", "resample_dec_f32"),
    ("nbfm channel LP K133 D1", "fir_s1_f32"),
    ("nbfm audio LP K55 D1", "fir_s1_f32"),
    ("nbfm audio resampler D5", "resample_poly_f32"),
    ("K2048 D1", "fir_s1_f32"),
    ("K2049 D1", "fir_stream_f32"),
    ("K419 D100", "fir_stream_f32"),
    ("K496 D31", "fir_stream_f32"),
    ("K512 D32", "fir_decim_f32"),
    ("K1024 D64", "fir_decim_f32"),
    ("K1025 D64", "fir_long_f32"),
    ("K800 D65", "fir_stream_f32"),
    ("K800 D50", "fir_decim_f32"),
    ("K801 D50", "fir_long_f32"),
    ("K2239 D50", "resample_dec_f32"),
    ("K3200 D50", "fir_long_f32"),
    ("K3201 D50", "fir_stream_f32"),
    ("K113 D5", "fir_cols_f32"),
    ("ssb head K5597 D125", "resample_dec_f32"),
    ("wbfm head K225 D5", "fir_cols_f32"),
    ("wbfm audio resampler K1121 D25", "fir_cols_f32"),
    ("K5597 D125", "resample_dec_f32"),
    ("K225 D5", "fir_cols_f32"),
    ("K1121 D25", "fir_cols_f32"),
    ("K1984 D31", "fir_cols_f32"),
    ("K1985 D31", "fir_stream_f32"),
    ("K32 D2", "fir_stream_f32"),
    ("K33 D2", "fir_cols_f32"),
    ("K8192 D128", "fir_long_f32"),
    ("K6273 D129", "fir_stream_f32"),
    ("K8192 D256", "fir_long_f32"),
])
def test_fir_route_recorded_on_cpu(stage, want):
    """On CPU tensors each stage records `plain` under the kernel its shape
    routes to: the 4FSK head (16 taps a phase at most) under fir_decim_f32;
    the NBFM head (K2239 D50) and the SSB head (K5597 D125) under
    resample_dec_f32 at L 1; at 17 to 64 taps a phase the other D 32-64
    shapes under fir_long_f32 (up to 8 warps of column groups x segments)
    and the WBFM
    head and audio resampler (D 5, 25; the resampler on real input) under
    fir_cols_f32 (D 2-31); the stride-1 filters of up to 2,048 taps under
    fir_s1_f32, the NBFM audio resampler (L 2, every phase in one call)
    under resample_poly_f32, every other FIR under fir_stream_f32."""
    fsk, nbfm = Fsk4DemodFF(device="cpu"), NbfmDemod(device="cpu")
    kernel_paths.reset()
    if stage.startswith("fsk head"):
        x = torch.zeros(5000)
        fsk.resamp(fsk.resamp.init_state(), IqPair(x, x))
    elif stage.startswith("fsk channel"):
        x = torch.zeros(200)
        fsk.chan_filter(fsk.chan_filter.init_state(), IqPair(x, x))
    elif stage.startswith("fsk RRC"):
        fsk.shaping(fsk.shaping.init_state(), torch.zeros(200))
    elif stage.startswith("nbfm head"):
        x = torch.zeros(5000)
        nbfm.resamp(nbfm.resamp.init_state(), IqPair(x, x))
    elif stage.startswith("nbfm channel"):
        x = torch.zeros(200)
        nbfm.chan_filter(nbfm.chan_filter.init_state(), IqPair(x, x))
    elif stage.startswith("nbfm audio LP"):
        nbfm.audio_filter(nbfm.audio_filter.init_state(), torch.zeros(200))
    elif stage.startswith("nbfm audio"):
        x = torch.zeros(500)
        nbfm.audio_resamp(nbfm.audio_resamp.init_state(), IqPair(x, x))
    elif stage.startswith("ssb head"):
        rs = SsbDemod(device="cpu").resamp
        x = torch.zeros(1250)
        rs(rs.init_state(), IqPair(x, x))
    elif stage.startswith("wbfm head"):
        rs = WbfmDemod(device="cpu").resamp
        x = torch.zeros(500)
        rs(rs.init_state(), IqPair(x, x))
    elif stage.startswith("wbfm audio"):
        rs = WbfmDemod(device="cpu").audio_resamp
        rs(rs.init_state(), torch.zeros(500))
    else:
        K, D = (int(s[1:]) for s in stage.split())
        x = torch.zeros(2, 4 * D)
        tf = torch.ones(K)
        t = torch.zeros(2, K - 1)
        fir_stream((x, x), tf, D, 4, tails=(t, t))
    rep = kernel_paths.report()
    assert set(rep) == {want}, rep
    assert rep[want]["cuda"] == 0 and rep[want]["plain"] >= 1
    shape = re.search(r"(K\d+ )?D\d+$", stage).group(0)
    assert all(re.search(rf"\b{shape}\b", k) for k in rep[want]["shapes"]), \
        rep


@pytest.mark.parametrize("rows,form,want", [
    (2048, "stream", "resample_dec_f32"),   # GMSK2K's head
    (256, "stream", "resample_dec_f32"),    # 2FSK2K's head in the sweep
    (32, "stream", "resample_dec_f32"),     # the mixed path's NBFM head
    (1, "stream", "resample_dec_f32"),      # one radio's
    (2048, "shift", "fir_long_f32"),        # not the resampler's form
    (2048, "no_tail", "fir_long_f32"),
    (2048, "short", "fir_long_f32")])
def test_fir_route_k2239_d50_by_rows(rows, form, want):
    """The K2239 D50 head: resample_dec_f32 at L 1 at every row count in
    the resampler's form (a tail, shift 0, every output of the block; it
    ran 1.37-2.75x fir_long_f32 in turns at 1 to 2048 rows), the FIR
    kernels' route (fir_long_f32) for other calls at that shape; a
    RationalResampler(1, 50) on the CPU records the routed kernel's plain
    version once a block at its key."""
    from qradiolink_tpu_torch.ops import cuda_fir

    K, D, T = 2239, 50, 4 * 50
    n_out = {"shift": 3, "short": 3}.get(form, 4)
    tails = None if form == "no_tail" else (torch.zeros(rows, K - 1),)
    assert cuda_fir.stream_route(K, D, T, n_out, tails,
                                 3 if form == "shift" else 0) == want
    assert cuda_fir.route(K, D) == "resample_dec_f32"
    assert cuda_fir.fir_route(K, D) == "fir_long_f32"
    if form != "stream":
        return
    rs = RationalResampler(1, 50, lead_shape=(rows,), device="cpu")
    assert (rs.kp, rs.M) == (K, D)
    x = torch.zeros(rows, T)
    kernel_paths.reset()
    rs(rs.init_state(), IqPair(x, x))
    assert kernel_paths.report() == {want: {
        "cuda": 0, "plain": 1, "shapes": {f"plain K{K} D{D} tail 2x{rows}":
                                          1}}}


@pytest.mark.parametrize("rows,form,want", [
    (2048, "stream", "resample_dec_f32"),   # the SSB path's head
    (256, "stream", "resample_dec_f32"),    # the sweep's USB and LSB
    (16, "stream", "resample_dec_f32"),
    (1, "stream", "resample_dec_f32"),      # one radio's
    (2048, "shift", "fir_long_f32"),        # not the resampler's form
    (2048, "no_tail", "fir_long_f32"),
    (2048, "short", "fir_long_f32")])
def test_fir_route_k5597_d125_by_rows(rows, form, want):
    """SSB's K5597 D125 head: resample_dec_f32 at L 1 at every row count in
    the resampler's form (a tail, shift 0, every output of the block), the
    FIR kernels' route (fir_long_f32) for other calls at that shape; a
    RationalResampler(1, 125) on the CPU records the routed kernel's plain
    version once a block at its key."""
    from qradiolink_tpu_torch.ops import cuda_fir

    K, D, T = 5597, 125, 4 * 125
    n_out = {"shift": 3, "short": 3}.get(form, 4)
    tails = None if form == "no_tail" else (torch.zeros(rows, K - 1),)
    assert cuda_fir.stream_route(K, D, T, n_out, tails,
                                 3 if form == "shift" else 0) == want
    assert cuda_fir.route(K, D) == "resample_dec_f32"
    assert cuda_fir.fir_route(K, D) == "fir_long_f32"
    if form != "stream":
        return
    rs = RationalResampler(1, 125, lead_shape=(rows,), device="cpu")
    assert (rs.kp, rs.M) == (K, D)
    state = rs.init_state()
    for _ in range(2):
        x = torch.zeros(rows, T)
        kernel_paths.reset()
        state, _ = rs(state, IqPair(x, x))
        assert kernel_paths.report() == {want: {
            "cuda": 0, "plain": 1,
            "shapes": {f"plain K{K} D{D} tail 2x{rows}": 1}}}


@pytest.mark.parametrize("K,D,want", [
    (1, 1, "fir_s1_f32"),
    (55, 1, "fir_s1_f32"),
    (251, 1, "fir_s1_f32"),
    (2048, 1, "fir_s1_f32"),
    (2049, 1, "fir_stream_f32"),
    (55, 2, "fir_cols_f32"),
])
def test_fir_route_s1_by_taps_and_stride(K, D, want):
    """fir_s1_f32 takes every stride-1 FIR of up to 2,048 taps, whatever
    its rows and length."""
    assert route(K, D) == want


@pytest.mark.parametrize("chain,stage,planes", [
    (Fsk4DemodFF, "chan_filter", 2), (NbfmDemod, "audio_filter", 1)],
    ids=["fsk_chan_lp", "nbfm_audio_lp"])
def test_fir_launch_key_tells_stages_apart(chain, stage, planes):
    """Two stages with one K and D, the 4FSK channel low-pass (2 planes)
    and the NBFM audio low-pass (real), record under different keys:
    the key holds planes x rows."""
    blk = getattr(chain(lead_shape=(32,), device="cpu"), stage)
    x = torch.zeros(32, 200)
    kernel_paths.reset()
    blk(blk.init_state(), IqPair(x, x) if planes == 2 else x)
    assert kernel_paths.report()["fir_s1_f32"]["shapes"] == {
        f"plain K55 D1 tail {planes}x32": 1}


# ---- fir_s1_f32 (csrc/fir_s1.cu): a numpy model of its loop -------------

S1_R, S1_THREADS = 8, 128
S1_TILE = S1_R * S1_THREADS


def s1_model(state, xs, tf, shift, n_out):
    """numpy model of fir_s1_f32's loop, line for line: tiles of 1,024
    outputs a block (all tiles at once here); the taps and the span staged
    as one run of K + span words, word i >= K from stream sample
    m0 + shift - K + i, into the padded shared layout (one pad word after
    every 8; the pad words and the taps' rounding hold NaN, so a wrong
    index shows) with the tail/x seam resolved per element, the tails read
    through their row stride in the (C, 2, K-1) state, and 0 past the
    stream; the ring of 8 window values and 8 accumulators a thread, the
    taps of a group read as two float4, the K mod 8 remainder taps, and the
    stores skipping outputs past n_out. state: (C, 2, K-1) or None (no
    tail); xs: one (C, T) array a plane."""
    K = tf.shape[0]
    R = S1_R
    tap_words = (K + 3) & ~3
    n_tiles = -(-n_out // S1_TILE)
    n_words = K + S1_TILE + K - 1
    words = np.arange(n_words)
    s_tap = np.full(tap_words, np.nan, np.float32)
    s_tap[words[:K]] = tf[words[:K]]
    i = words[K:] - K  # span words
    phys = i + i // R
    t = np.arange(S1_THREADS)
    g0 = t * R
    ys = []
    for p, x in enumerate(xs):
        C, T = x.shape
        tail_len = 0 if state is None else K - 1
        n_in = tail_len + T
        if state is not None:
            flat = np.ascontiguousarray(state).reshape(-1)
            tail_ld = 2 * (K - 1)
        m0 = np.arange(n_tiles) * S1_TILE
        v = (m0 + shift - K)[:, None] + words[K:]  # (n_tiles, span)
        rows = np.arange(C)[:, None, None]
        if tail_len:
            from_tail = flat[np.clip(rows * tail_ld + p * (K - 1) + v, 0,
                                     flat.size - 1)]
        else:
            from_tail = 0
        from_x = x[rows, np.clip(v - tail_len, 0, T - 1)]
        val = np.where(v < tail_len, from_tail,
                       np.where(v < n_in, from_x, 0)).astype(np.float32)
        s_x = np.full((C, n_tiles, phys[-1] + 1), np.nan, np.float32)
        s_x[:, :, phys] = val

        q = t * (R + 1)  # each thread's first window word
        acc = np.zeros((R, C, n_tiles, S1_THREADS), np.float32)
        w = np.zeros((R, C, n_tiles, S1_THREADS), np.float32)
        for s_ in range(R - 1):
            w[s_] = s_x[:, :, q + s_]

        def step(u, tap, q):
            c = u + R - 1
            w[(u + R - 1) % R] = s_x[:, :, q + c + c // R]
            for r in range(R):
                acc[r] = acc[r] + np.float32(tap) * w[(u + r) % R]

        n_grp = K // R
        for b in range(n_grp):
            tv = np.concatenate([s_tap[b * R + 4 * k: b * R + 4 * k + 4]
                                 for k in range(R // 4)])
            for u in range(R):
                step(u, tv[u], q)
            q = q + R + 1
        rem = K - n_grp * R
        for u in range(R - 1):
            if u < rem:
                step(u, s_tap[n_grp * R + u], q)

        y = np.full((C, n_out), np.nan, np.float32)
        for b, m in enumerate(m0):
            for ti in range(S1_THREADS):
                if m + g0[ti] >= n_out:
                    continue
                n_here = n_out - m - g0[ti]
                for r in range(min(R, n_here)):
                    y[:, m + g0[ti] + r] = acc[r, :, b, ti]
        ys.append(y)
    return ys


def s1_case(name, rng):
    """numpy inputs of one case: (state or None, xs, tf, shift, n_out)."""
    C, T, K, shift, planes, tail = S1_CASES[name]
    tf = s1_taps(name, K, rng)
    assert tf.shape == (K,)
    xs = [rng.standard_normal((C, T)).astype(np.float32)
          for _ in range(planes)]
    state = (rng.standard_normal((C, 2, K - 1)).astype(np.float32)
             if tail else None)
    n_out = T - shift if tail else T - shift - K + 1
    return state, xs, tf, shift, n_out


@pytest.mark.parametrize("name", sorted(S1_CASES))
def test_s1_model_matches_plain(rng, name):
    """The kernel's index math (the numpy model) against fir_stream_plain,
    within the FIR's 1e-5."""
    state, xs, tf, shift, n_out = s1_case(name, rng)
    assert s1_takes(tf.shape[0], 1)
    got = s1_model(state, xs, tf, shift, n_out)
    tails = None if state is None else [
        torch.from_numpy(state[:, p, :]) for p in range(len(xs))]
    ref = fir_stream_plain([torch.from_numpy(x) for x in xs],
                           torch.from_numpy(tf), 1, n_out, tails=tails,
                           shift=shift)
    for g, r in zip(got, ref):
        assert not np.isnan(g).any(), "an output was never written"
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-5)


# ---- fir_long_f32 (csrc/fir_long.cu): a numpy model of its loop ---------

def long_shape(K, D):
    """(S, AS, NG, MW, G) of fir_long_f32 at K taps and stride D: segments,
    phase rows a segment, groups of AS rows a warp walks, outputs a block,
    column groups of 64."""
    A = -(-K // D)
    S = -(-A // 16)
    AS = -(-A // S)
    NG = (256 + AS - 1) // AS + 1
    return S, AS, NG, (NG - 1) * AS + 1, -(-D // 64)


def long_model(tails, xs, tf, D, shift, n_out):
    """numpy model of fir_long_f32's loop, line for line, with every warp
    (column group, segment, chunk) of a row at once: the taps padded to
    A*D, S segments of AS phase rows, G column groups of 64 with two phase
    columns a lane (lane l of group g holds columns 64g + l and
    64g + l + 32 where they are < D; D >= 32, so group 0 holds every
    first); chunks of MW outputs a block; warp w = g*S + s walks rows
    m0 + s*AS + r, each lane loading X[row][64g + l] and
    X[row][64g + l + 32] with the tail/x seam resolved per element, loads
    past the stream and of columns >= D reading 0 (the kernel's
    one-pointer loads of groups inside x read the same elements); the ring
    of AS accumulators; the 32 x 32 tile of lane partials summed lane by
    lane every 32 outputs into the warp's partials; then warps added in
    order 0 .. G*S-1. A chunk past its last output records nothing (the
    kernel's break). tails: one (C, K-1) array per plane, or None; xs:
    (C, T)."""
    K = tf.shape[0]
    S, AS, NG, MW, G = long_shape(K, D)
    W = G * S
    assert D >= 32 and W <= 8
    lane = np.arange(32)
    warp = np.arange(W)[:, None, None]
    grp, seg = warp // S, warp % S
    col = grp * 64 + lane  # (W, 1, 32)
    has0, has1 = col < D, col + 32 < D
    j = (seg * AS + np.arange(AS)[:, None]) * D + col  # (W, AS, 32)
    t0 = np.where(has0 & (j < K), tf[np.minimum(j, K - 1)], 0)
    t1 = np.where(has1 & (j + 32 < K), tf[np.minimum(j + 32, K - 1)], 0)
    t0, t1 = t0.astype(np.float32), t1.astype(np.float32)
    n_chunks = -(-n_out // MW)
    m0 = np.arange(n_chunks) * MW
    m_end = np.minimum(m0 + MW, n_out)
    ys = []
    for p, x in enumerate(xs):
        C, T = x.shape
        tail = np.zeros((C, 0), np.float32) if tails is None else tails[p]
        tail_len = tail.shape[1]
        n_in = tail_len + T

        def load(v, has):  # v: (W, n_chunks, 32) -> (C, W, n_chunks, 32)
            ok = has & (v < n_in)
            vt = np.clip(v, 0, max(tail_len - 1, 0))
            vx = np.clip(v - tail_len, 0, T - 1)
            val = np.where(v < tail_len, tail[:, vt] if tail_len else 0,
                           x[:, vx])
            return np.where(ok, val, 0).astype(np.float32)

        v0 = (m0[:, None] + seg * AS) * D + shift + col  # (W, n_chunks, 32)
        acc = np.zeros((AS, C, W, n_chunks, 32), np.float32)
        red = np.zeros((C, W, n_chunks, 32, 32), np.float32)  # [out, lane]
        part = np.full((C, W, n_chunks, MW), np.nan, np.float32)
        for r in range(NG * AS):
            if r % AS == 0 and np.all(m0 + r - (AS - 1) >= m_end):
                break
            c0, c1 = load(v0 + r * D, has0), load(v0 + r * D + 32, has1)
            u = r % AS
            for a in range(AS):
                s = (u - a) % AS
                acc[s] = acc[s] + t0[:, None, a] * c0
                acc[s] = acc[s] + t1[:, None, a] * c1
            s = (u + 1) % AS
            jo = r - (AS - 1)
            live = (jo >= 0) & (m0 + jo < m_end)
            if jo >= 0 and live.any():
                red[:, :, live, jo & 31] = acc[s][:, :, live]
                flush = live & ((jo & 31 == 31) | (m0 + jo == m_end - 1))
                if flush.any():
                    tile = red[:, :, flush]
                    total = np.zeros(tile.shape[:-1], np.float32)
                    for k in range(32):
                        total = total + tile[..., k]
                    n = (jo & 31) + 1
                    base = jo & ~31
                    part[:, :, flush, base: base + n] = total[..., :n]
            acc[s] = 0
        y = part[:, 0]
        for w in range(1, W):
            y = y + part[:, w]
        ys.append(y.reshape(C, n_chunks * MW)[:, :n_out])
    return ys


@pytest.mark.parametrize("name", sorted(LONG_CASES))
def test_long_model_matches_plain(rng, name):
    """fir_long_f32's index math (the numpy model) against fir_stream_plain,
    within the FIR's 1e-5, at every shape the card test runs."""
    C, T, K, D, shift, planes, tail = LONG_CASES[name]
    assert fir_route(K, D) == "fir_long_f32"
    tf = np.ascontiguousarray(long_taps(name, K, rng))
    xs = [rng.standard_normal((C, T)).astype(np.float32)
          for _ in range(planes)]
    tails = ([rng.standard_normal((C, K - 1)).astype(np.float32)
              for _ in range(planes)] if tail else None)
    n_out = (T // D) if tail else (T - shift - K) // D + 1
    got = long_model(tails, xs, tf, D, shift, n_out)
    ref = fir_stream_plain(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(tf), D, n_out,
        tails=None if tails is None else [torch.from_numpy(t)
                                          for t in tails], shift=shift)
    for g, r in zip(got, ref):
        assert not np.isnan(g).any(), "an output was never written"
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-5)


def test_long_model_ragged_chunk_is_mw_plus_one():
    """The ragged_chunk case leaves one output to a second block at the NBFM
    head's AS = 15 (MW = 271), and the head runs 3 segments in one column
    group."""
    C, T, K, D, shift, planes, tail = LONG_CASES["ragged_chunk"]
    S, AS, NG, MW, G = long_shape(K, D)
    assert (S, AS, MW, G) == (3, 15, 271, 1) and T // D == MW + 1


def test_long_shape_ssb_head_is_two_groups_of_three_segments():
    """The SSB head (K 5597, D 125) runs 2 column groups x 3 segments of 15
    phase rows, 6 warps a block, with 125 of the 128 lane-columns busy; the
    ssb_head case leaves a ragged second chunk."""
    C, T, K, D, shift, planes, tail = LONG_CASES["ssb_head"]
    S, AS, NG, MW, G = long_shape(K, D)
    assert (S, AS, MW, G) == (3, 15, 271, 2)
    assert MW < T // D < 2 * MW



# ---- fir_cols_f32 (csrc/fir_cols.cu): a numpy model of its loop ---------

COLS_R, COLS_THREADS, COLS_SLAB, COLS_TAP_ROW = 8, 128, 13, 64
COLS_PARTS = 2
COLS_TILE = COLS_R * COLS_THREADS
# shared floats of a staged column: rows 0 .. kTile + kMaxA - 2, padded
COLS_WORDS = (COLS_TILE + 62) + (COLS_TILE + 62) // COLS_R + 1


def cols_slab(D):
    """Columns a slab of fir_cols_f32 at stride D: ceil(D / 13) slabs of
    nearly equal size."""
    n_slabs = -(-D // COLS_SLAB)
    return -(-D // n_slabs)


def cols_smem(D):
    """fir_cols_f32's shared memory at stride D, in bytes."""
    return (D * COLS_TAP_ROW + cols_slab(D) * COLS_WORDS) * 4


def cols_parts(D):
    """Column parts of fir_cols_f32's block at stride D: kParts where the
    block takes more than 48 KB of shared memory, else 1."""
    return COLS_PARTS if cols_smem(D) > 48 * 1024 else 1


def cols_model(tails, xs, tf, D, shift, n_out):
    """numpy model of fir_cols_f32's loop, line for line, with every tile
    (block) and thread of a row at once: the taps by column,
    s_tap[b][a] = tf[a*D + b] (0 past K) in rows of 64; tiles of 1,024
    outputs, thread t of each column part owning outputs m0 + 8t ..
    m0 + 8t + 7; the columns in slabs of at most 13, each slab staging the
    phase rows 0 .. ceil8(n_here) + A - 2 of the tile, word (r, c) from sample
    (m0 + r)*D + shift + b0 + c of [tail | x] (the seam per element, 0 past
    the stream) at word r + r // 8 of column c; then for each column of the
    slab, groups of 8 taps and the last A mod 8 (the ring of 8 samples,
    read from the padded column at q[s + s // 8] with q = 9t + 9g), each
    tap adding c_b[a] * X[g0 + o + a][b] into the sum o of the thread of
    part h, where part h of H (cols_parts) takes the slab's columns
    h*nb // H .. (h+1)*nb // H - 1, in order; then part 0 adds parts 1 ..
    H-1 in order. Threads with no output store nothing. tails: one
    (C, K-1) array per plane, or None; xs: (C, T)."""
    K = tf.shape[0]
    A = -(-K // D)
    assert 2 <= D <= 31 and 17 <= A <= 64
    R = COLS_R
    i = np.arange(D * COLS_TAP_ROW)
    j = (i % COLS_TAP_ROW) * D + i // COLS_TAP_ROW
    s_tap = np.where(j < K, tf[np.minimum(j, K - 1)], 0).astype(
        np.float32).reshape(D, COLS_TAP_ROW)
    nb_max = cols_slab(D)
    H = cols_parts(D)
    n_tiles = -(-n_out // COLS_TILE)
    ys = []
    for p, x in enumerate(xs):
        C, T = x.shape
        tail = np.zeros((C, 0), np.float32) if tails is None else tails[p]
        tail_len = tail.shape[1]
        n_in = tail_len + T
        y = np.full((C, n_tiles * COLS_TILE), np.nan, np.float32)
        for tile in range(n_tiles):
            m0 = tile * COLS_TILE
            n_here = min(COLS_TILE, n_out - m0)
            n_rows = -(-n_here // R) * R + A - 1
            accs = np.zeros((H, C, COLS_THREADS, R), np.float32)
            for b0 in range(0, D, nb_max):
                nb = min(nb_max, D - b0)
                v = (m0 + np.arange(n_rows)[:, None]) * D + shift + b0 \
                    + np.arange(nb)  # (n_rows, nb): word (r, c)
                vt = np.clip(v, 0, max(tail_len - 1, 0))
                vx = np.clip(v - tail_len, 0, T - 1)
                val = np.where(v < tail_len, tail[:, vt] if tail_len else 0,
                               x[:, vx])
                slab = np.where(v < n_in, val, 0).astype(np.float32)
                r = np.arange(n_rows)
                for cb in range(nb):
                    acc = accs[next(h for h in range(H)
                                    if cb < (h + 1) * nb // H)]
                    # the staged column, row r at word r + r // 8 (the rest
                    # is never read by a thread with an output)
                    col = np.zeros((C, COLS_WORDS), np.float32)
                    col[:, r + r // R] = slab[:, :, cb]
                    taps = s_tap[b0 + cb]

                    def at(q, s, col=col):  # word s + s // 8 from each q
                        return col[:, np.minimum(q + s + s // R,
                                                 COLS_WORDS - 1)]

                    def step(v, tap, q, w, acc=acc):
                        w[(v + R - 1) % R] = at(q, v + R - 1)
                        for oo in range(R):
                            acc[:, :, oo] = acc[:, :, oo] + \
                                tap * w[(v + oo) % R]

                    q = np.arange(COLS_THREADS) * (R + 1)
                    w = [at(q, s) for s in range(R - 1)] + [None]
                    n_grp = A // R
                    for g in range(n_grp):
                        tv = taps[g * R: g * R + R]
                        for vv in range(R):
                            step(vv, tv[vv], q, w)
                        q = q + R + 1
                    for vv in range(R - 1):
                        if vv < A - n_grp * R:
                            step(vv, taps[n_grp * R + vv], q, w)
            for h in range(1, H):
                accs[0] = accs[0] + accs[h]
            out = accs[0].reshape(C, COLS_TILE)
            keep = np.arange(COLS_TILE) < n_here
            y[:, m0: m0 + COLS_TILE][:, keep] = out[:, keep]
        ys.append(y[:, :n_out])
    return ys


@pytest.mark.parametrize("name", sorted(COLS_CASES))
def test_cols_model_matches_plain(rng, name):
    """fir_cols_f32's index math (the numpy model) against
    fir_stream_plain, within the FIR's 1e-5, at every shape the card test
    runs."""
    C, T, K, D, shift, planes, tail = COLS_CASES[name]
    assert route(K, D) == "fir_cols_f32"
    tf = np.ascontiguousarray(cols_taps(name, K, rng))
    xs = [rng.standard_normal((C, T)).astype(np.float32)
          for _ in range(planes)]
    tails = ([rng.standard_normal((C, K - 1)).astype(np.float32)
              for _ in range(planes)] if tail else None)
    n_out = (T // D) if tail else (T - shift - K) // D + 1
    got = cols_model(tails, xs, tf, D, shift, n_out)
    ref = fir_stream_plain(
        [torch.from_numpy(x) for x in xs], torch.from_numpy(tf), D, n_out,
        tails=None if tails is None else [torch.from_numpy(t)
                                          for t in tails], shift=shift)
    for g, r in zip(got, ref):
        assert not np.isnan(g).any(), "an output was never written"
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-5)


def test_cols_slabs_and_tiles_at_the_wbfm_shapes():
    """The WBFM head (D 5) stages its 5 columns in one slab and the audio
    resampler (D 25) in two, of 13 and 12; the shared memory (the kernel's
    smem_bytes) is 25 KB at D 5, under the 48 KB a launch gets without
    opting in, and at most 70 KB (D 26), three blocks an SM; the blocks
    above 48 KB (D 10-13 and 19-31) run in two column parts, each part
    with a column of every slab and room in the staging buffer for the
    sums part 1 hands to part 0; the cases with two tiles end in a ragged
    one."""
    assert cols_slab(5) == 5 and cols_slab(25) == 13 and cols_slab(31) == 11
    assert cols_smem(5) <= 48 * 1024 and cols_smem(8) <= 48 * 1024
    assert max(cols_smem(D) for D in range(2, 32)) == cols_smem(26) \
        <= 227 * 1024 // 3
    assert cols_parts(5) == 1 and cols_parts(25) == COLS_PARTS
    for D in (D for D in range(2, 32) if cols_parts(D) > 1):
        n_slabs = -(-D // cols_slab(D))
        last = D - (n_slabs - 1) * cols_slab(D)
        assert last >= COLS_PARTS
        assert (COLS_PARTS - 1) * COLS_R * COLS_THREADS \
            <= cols_slab(D) * COLS_WORDS
    for name in ("wbfm_head", "wbfm_audio"):
        C, T, K, D, shift, planes, tail = COLS_CASES[name]
        assert COLS_TILE < T // D < 2 * COLS_TILE


def test_cols_constants_match_the_source():
    """cols_model's block constants are the kernel's (csrc/fir_cols.cu)."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch"
           / "csrc" / "fir_cols.cu").read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (kThreads|kR|kSlab|kMaxA|kMinA|kMaxD|kMinD|kParts) "
        r"= (\d+);", src)}
    assert got == {"kThreads": COLS_THREADS, "kR": COLS_R,
                   "kParts": COLS_PARTS,
                   "kSlab": COLS_SLAB, "kMaxA": COLS_TAP_ROW, "kMinA": 17,
                   "kMaxD": 31, "kMinD": 2}
    assert "kTapRow = kMaxA" in src


# ---- fir_stream_f32 (csrc/fir.cu): the plain version at its path shapes
# against the JAX package, and a numpy model of the kernel's schedule ------

def _stream_shape_taps(name):
    """The flipped taps of the three shapes the route gives fir_stream_f32
    on a path: FreeDV's head (K1045 D125), 4FSK1KFM's head (K837 D100) and
    4FSK100K's head (K17 D2), from the chains' own designs."""
    from qradiolink_tpu_torch.chains.fsk import Fsk4Demod
    from qradiolink_tpu_torch.chains.freedv import FreeDvDemod

    rs = {"freedv_head": lambda: FreeDvDemod(device="cpu").resamp,
          "fsk1kfm_head": lambda: Fsk4Demod(variant="1KFM",
                                            device="cpu").resamp,
          "fsk100k_head": lambda: Fsk4Demod(variant="96K",
                                            device="cpu").resamp}[name]()
    return rs.phase_taps[0], rs.M


# name: (K, D, samples a block); the blocks are the shortest that
# stream_plan serves with two slabs of 128 outputs
STREAM_PATH_SHAPES = {"freedv_head": (1045, 125, 32_000),
                      "fsk1kfm_head": (837, 100, 25_600),
                      "fsk100k_head": (17, 2, 1_024)}


@pytest.mark.parametrize("name", sorted(STREAM_PATH_SHAPES))
def test_plain_fir_matches_pallas_stream_at_stream_shapes(pallas_interp,
                                                          rng, name):
    """fir_stream's plain version against the Pallas banded_fir_stream, in
    interpret mode, at the three shapes that route() gives fir_stream_f32
    on a path, with the chains' own taps: two chained blocks (the tails
    carried), 2 planes, within 1e-5. 8 rows, not 4: stream_plan takes
    channel tiles of 8 to 128 rows, and refuses 4 rows at every shape."""
    K, D, T = STREAM_PATH_SHAPES[name]
    tf, M = _stream_shape_taps(name)
    assert (tf.shape[0], M) == (K, D) and route(K, D) == "fir_stream_f32"
    taps = tf.numpy()[::-1].copy()
    C, n_out = 8, T // D
    tails = [rng.standard_normal((C, K - 1)).astype(np.float32)
             for _ in range(2)]
    for _ in range(2):
        xs = [rng.standard_normal((C, T)).astype(np.float32)
              for _ in range(2)]
        res = pf.banded_fir_stream(tuple(jnp.asarray(t) for t in tails),
                                   tuple(jnp.asarray(x) for x in xs),
                                   taps, D, n_out)
        assert res is not None, "Pallas stream kernel did not run"
        ys, n_main = res
        assert n_main == n_out
        got = fir_stream_plain([torch.from_numpy(x) for x in xs], tf, D,
                               n_out, tails=[torch.from_numpy(t)
                                             for t in tails])
        for y, g in zip(ys, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(y), rtol=1e-5,
                                       atol=1e-5)
        tails = [x[:, -(K - 1):] for x in xs]


FIR_SRC = (pathlib.Path(__file__).resolve().parents[1] / "qradiolink_tpu_torch"
           / "csrc" / "fir.cu")
STREAM_WARPS, STREAM_CH, STREAM_SLOTS = 4, 64, 2
STREAM_PITCH, STREAM_OUT, STREAM_MAX_S = 33, 32, 16
STREAM_STREAM_WORDS = 12   # sizeof(Stream) / 4
STREAM_SMALL_PD = (2, 4)   # periods the kernel runs as straight-line code


def stream_plan(K, D):
    """(S, P, PD, qmax) of csrc/fir.cu's plan_of: accumulators a lane,
    outputs a lane's outputs lie apart, a period's positions, and the
    position from which the oldest accumulator takes no tap."""
    A = -(-K // D)
    P = 1 if A <= STREAM_MAX_S else -(-A // STREAM_MAX_S)
    S = -(-A // P)
    return S, P, P * D, K - (S - 1) * P * D


def stream_tap_row(S):
    return S if S <= 2 else -(-S // 4) * 4


def stream_smem_bytes(K, D):
    """fir_stream_smem_bytes: the taps by position, and a warp's stream
    table, ring and output buffer."""
    S, P, PD, _ = stream_plan(K, D)
    taps = -(-PD * stream_tap_row(S) // 4) * 4
    warp = (32 * STREAM_STREAM_WORDS + STREAM_SLOTS * STREAM_CH
            * STREAM_PITCH + 32 * (STREAM_OUT + 1))
    return 4 * (taps + STREAM_WARPS * warp)


def stream_work(K, D, n_out, rows, lanes):
    """(L, NSR, n_streams, n_samp) of launch<S>() when one wave holds
    `lanes` lanes: outputs a stream, streams a (plane, row), streams, and
    positions a stream reads."""
    S, P, PD, _ = stream_plan(K, D)
    segs = max(1, lanes // (rows * P))
    L = -(-n_out // (P * segs))
    NSR = P * -(-n_out // (P * L))
    return L, NSR, rows * NSR, P * (L - 1) * D + K


def fma32(t, x, acc):
    """fmaf on f32 arrays in numpy: the product is exact in f64, the sum
    rounds in f64 and then to f32 (the card rounds once). The model and the
    reference below both use it, so their bits differ only where their
    order or indices do."""
    return (np.float64(t) * x.astype(np.float64)
            + acc.astype(np.float64)).astype(np.float32)


def stream_reference(state, xs, tf, D, shift, n_out):
    """Each output as one sequential f32 sum, j = 0 .. K-1 from 0."""
    K = tf.shape[0]
    ys = []
    for p, x in enumerate(xs):
        xc = x if state is None else np.concatenate([state[:, p], x], -1)
        idx = np.arange(n_out) * D + shift
        acc = np.zeros((x.shape[0], n_out), np.float32)
        for j in range(K):
            acc = fma32(tf[j], xc[:, idx + j], acc)
        ys.append(acc)
    return ys


def stream_model(state, xs, tf, D, shift, n_out, lanes):
    """numpy model of fir_stream_f32's schedule, line for line, every lane
    at once, for a wave of `lanes` lanes: the taps by period position
    (taps[q*SP + k] = tf[q + k*PD]; every other word NaN, so a tap read
    outside the schedule shows); each lane's stream (plane, row, first
    output s0, outputs s0 + P e, their count n_valid); the warp's ring of
    STREAM_SLOTS slots of STREAM_CH positions at pitch 33 (the pad word
    NaN), each chunk copied kSlots - 1 ahead: where the chunk lies in x for
    all 32 streams of the warp, from x alone (the copy without tests; its
    range is asserted), else element by element with the tail/x seam
    resolved, the tails read through their row stride in the (C, 2, K-1)
    state, and 0 past the input; the runs of a period with and without the
    oldest accumulator, its output staged at qmax, the shift at the
    period's end; at a period of 2 or 4 positions, whole periods a chunk
    (the last chunk's past the stream's end too) with the output staged at
    the period's end; each kOut outputs (or the last) stored, a stream's
    run at stride P. There is no copy alignment to model: the copies are
    4-byte. Every output must be written once. state: (C, 2, K-1) or None;
    xs: one (C, T) array a plane. Returns the outputs and (S, P, L, NSR,
    n_samp)."""
    K = tf.shape[0]
    S, P, PD, qmax = stream_plan(K, D)
    SP = stream_tap_row(S)
    CH, NSL, OUT = STREAM_CH, STREAM_SLOTS, STREAM_OUT
    e_ = np.arange(PD * SP)
    q_, k_ = e_ // SP, e_ % SP
    j_ = q_ + k_ * PD
    taps = np.full(PD * SP, np.nan, np.float32)
    ok = (k_ < S) & (j_ < K)
    taps[ok] = tf[j_[ok]]

    planes = len(xs)
    C, T = xs[0].shape
    tail_len = 0 if state is None else K - 1
    lim = tail_len + T
    L, NSR, n_streams, n_samp = stream_work(K, D, n_out, planes * C, lanes)
    n_warps = -(-n_streams // 32)   # warps past the work return
    sid = np.arange(n_warps * 32)
    idv = np.where(sid < n_streams, sid, 0)
    rp, sigma = idv // NSR, idv % NSR
    plane, row = rp // C, rp % C
    s0 = (sigma // P) * P * L + sigma % P
    v0 = s0 * D + shift
    n_valid = np.where((sid < n_streams) & (s0 < n_out),
                       np.minimum(L, -(-(n_out - s0) // P)), 0)
    warp, lane = sid // 32, sid % 32
    c_lo = np.where(v0 >= tail_len, 0, -(-(tail_len - v0) // CH))
    c_hi = np.fix((lim - v0) / CH).astype(np.int64) - 1
    c_lo_w = c_lo.reshape(n_warps, 32).max(1)
    c_hi_w = c_hi.reshape(n_warps, 32).min(1)
    x_all = np.stack(xs)
    flat = None if state is None else np.ascontiguousarray(state).ravel()
    tail_ld = 2 * (K - 1)

    ring = np.full((n_warps, NSL, CH, STREAM_PITCH), np.nan, np.float32)

    def copy(c):
        u = v0[:, None] + c * CH + np.arange(CH)  # (lanes, CH)
        fast = ((c >= c_lo_w) & (c <= c_hi_w))[warp]
        xi = u - tail_len
        assert ((xi[fast] >= 0) & (xi[fast] < T)).all()
        val = x_all[plane[:, None], row[:, None], np.clip(xi, 0, T - 1)]
        if tail_len:
            ti = (row[:, None] * tail_ld + plane[:, None] * (K - 1)
                  + np.clip(u, 0, K - 2))
            val = np.where(u < tail_len, flat[ti], val)
        ring[warp, c % NSL, :, lane] = np.where(u < lim, val, 0)

    ys = [np.full((C, n_out), np.nan, np.float32) for _ in xs]
    written = np.zeros((planes, C, n_out), np.int64)
    obuf = np.full((len(sid), OUT + 1), np.nan, np.float32)

    def flush(e_base, count):
        ee = e_base + np.arange(count)
        li, ci = np.nonzero(ee[None, :] < n_valid[:, None])
        m = s0[li] + ee[ci] * P
        for p in range(planes):
            sel = plane[li] == p
            ys[p][row[li][sel], m[sel]] = obuf[li[sel], ci[sel]]
        np.add.at(written, (plane[li], row[li], m), 1)

    acc = np.zeros((S, len(sid)), np.float32)
    q, e, tp, left = 0, 1 - S, 0, n_samp
    per_left = L + S - 1

    def emit():
        nonlocal e
        if e >= 0:
            r = e % OUT
            obuf[:, r] = acc[S - 1]
            if r == OUT - 1 or e == L - 1:
                flush(e - r, r + 1)
        e += 1

    n_chunks = -(-n_samp // CH)
    for c in range(min(NSL - 1, n_chunks)):
        copy(c)
    for c in range(n_chunks):
        if c + NSL - 1 < n_chunks:
            copy(c + NSL - 1)
        xs_ = ring[warp, c % NSL, :, lane]  # (lanes, CH)
        if PD in STREAM_SMALL_PD:  # whole periods, the taps in registers
            n_per = min(CH // PD, per_left)
            per_left -= n_per
            for i in range(n_per):
                for qq in range(PD):
                    x = xs_[:, i * PD + qq]
                    t = taps[qq * SP: qq * SP + SP]
                    for k in range(S - 1):
                        acc[k] = fma32(t[k], x, acc[k])
                    if qq < qmax:
                        acc[S - 1] = fma32(t[S - 1], x, acc[S - 1])
                emit()
                acc[1:] = acc[:-1].copy()
                acc[0] = 0
            continue
        o_end, o = min(CH, left), 0
        while o < o_end:
            oldest = q < qmax
            n = min(o_end - o, (qmax if oldest else PD) - q)
            for i in range(n):
                x = xs_[:, o + i]
                t = taps[tp + i * SP: tp + i * SP + SP]
                for k in range(S - 1):
                    acc[k] = fma32(t[k], x, acc[k])
                if oldest:
                    acc[S - 1] = fma32(t[S - 1], x, acc[S - 1])
            o, q, tp = o + n, q + n, tp + n * SP
            if q == qmax:
                emit()
            if q == PD:
                acc[1:] = acc[:-1].copy()
                acc[0] = 0
                q, tp = 0, 0
        left -= o_end
    assert (written == 1).all(), "an output was written twice or never"
    return ys, (S, P, L, NSR, n_samp)


# name: (C, T, K, D, shift, planes, tail, lanes of the wave); the first
# three are the path shapes cut to a few chunks a stream
STREAM_CASES = {
    "freedv_head": (2, 5_000, 1045, 125, 0, 2, True, 16),
    "fsk1kfm_head": (2, 4_000, 837, 100, 0, 2, True, 16),
    "fsk100k_head": (2, 2_000, 17, 2, 0, 2, True, 32),
    "ragged": (3, 2_222, 17, 2, 0, 2, True, 40),
    "shift": (2, 3_000, 400, 60, 7, 2, True, 16),
    "no_tail": (2, 3_000, 837, 100, 0, 1, False, 16),
    "one_plane": (3, 2_000, 17, 2, 0, 1, True, 32),
    "d4": (2, 3_001, 50, 4, 1, 2, True, 24),
    "d_above_chunk": (2, 6_000, 300, 200, 3, 2, True, 16),
    "k_below_d": (2, 5_000, 40, 125, 0, 2, True, 16),
    "one_tap": (2, 600, 1, 3, 1, 1, True, 32),
    "a_above_16": (2, 2_800, 2239, 1, 0, 1, False, 64),
}


def stream_case(name, rng):
    C, T, K, D, shift, planes, tail, lanes = STREAM_CASES[name]
    if name in STREAM_PATH_SHAPES:
        tf = _stream_shape_taps(name)[0].numpy()
    else:
        tf = (rng.standard_normal(K) / np.sqrt(K)).astype(np.float32)
    xs = [rng.standard_normal((C, T)).astype(np.float32)
          for _ in range(planes)]
    state = (rng.standard_normal((C, 2, K - 1)).astype(np.float32)
             if tail else None)
    n_out = (T - shift) // D if tail else (T - shift - K) // D + 1
    return state, xs, tf, D, shift, n_out, lanes


@pytest.mark.parametrize("name", sorted(STREAM_CASES))
def test_stream_model_matches_sequential_sum(rng, name):
    """fir_stream_f32's schedule (the numpy model) bit-equal to one
    sequential f32 sum an output, j = 0 .. K-1, at every case: what makes
    the kernel bit-equal to fir_stream_v0_f32 and fir_s1_f32."""
    state, xs, tf, D, shift, n_out, lanes = stream_case(name, rng)
    got, (S, P, L, NSR, n_samp) = stream_model(state, xs, tf, D, shift,
                                               n_out, lanes)
    ref = stream_reference(state, xs, tf, D, shift, n_out)
    for g, r in zip(got, ref):
        assert not np.isnan(g).any(), "an output was never written"
        assert np.array_equal(g, r)
    # and within the FIR's 1e-5 of the plain version
    tails = None if state is None else [torch.from_numpy(state[:, p])
                                        for p in range(len(xs))]
    plain = fir_stream_plain([torch.from_numpy(x) for x in xs],
                             torch.from_numpy(tf), D, n_out, tails=tails,
                             shift=shift)
    for g, r in zip(got, plain):
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-5)


def test_stream_cases_cover_the_plan():
    """The model's cases reach what they are named for: several streams a
    row with a ragged last one, periods longer than a chunk (D > 64), A = 1,
    and P > 1 (A > 16: residues of one segment on several lanes)."""
    plans = {}
    for name, (C, T, K, D, shift, planes, tail, lanes) in \
            STREAM_CASES.items():
        n_out = (T - shift) // D if tail else (T - shift - K) // D + 1
        S, P, PD, qmax = stream_plan(K, D)
        L, NSR, n_streams, n_samp = stream_work(K, D, n_out, planes * C,
                                                lanes)
        plans[name] = (S, P, PD, qmax, L, NSR, n_out)
    assert plans["freedv_head"][:4] == (9, 1, 125, 45)
    assert plans["fsk1kfm_head"][:4] == (9, 1, 100, 37)
    assert plans["fsk100k_head"][:4] == (9, 1, 2, 1)
    assert plans["d4"][2] == 4 and plans["d4"][3] < 4
    S, P, PD, qmax, L, NSR, n_out = plans["ragged"]
    assert NSR > 1 and n_out % L != 0
    assert plans["d_above_chunk"][2] > STREAM_CH
    assert plans["k_below_d"][0] == 1 and plans["one_tap"][:4] == (1, 1, 3, 1)
    S, P, PD, qmax, L, NSR, n_out = plans["a_above_16"]
    assert (S, P) == (16, 140) and NSR >= P


def test_stream_constants_match_the_source():
    """The model's constants are csrc/fir.cu's, and the shared memory of
    the path shapes fits a block with room for two blocks an SM."""
    src = FIR_SRC.read_text()
    got = {k: int(v) for k, v in re.findall(
        r"constexpr int (kWarps|kCh|kSlots|kPitch|kOut|kMaxS) = (\d+);", src)}
    assert got == {"kWarps": STREAM_WARPS, "kCh": STREAM_CH,
                   "kSlots": STREAM_SLOTS, "kPitch": STREAM_PITCH,
                   "kOut": STREAM_OUT, "kMaxS": STREAM_MAX_S}
    assert "    int pad;\n};" in src   # sizeof(Stream) == 48
    for pd in STREAM_SMALL_PD:
        assert f"a.PD == {pd}" in src
    for K, D in ((1045, 125), (837, 100), (17, 2)):
        assert 2 * stream_smem_bytes(K, D) <= 232_448


SASS = """
\t\tFunction : _Z8kernelILi15EEvPf
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/               @P0 LDG.E.CONSTANT R57, desc[UR6][R98.64] ;
""" + "".join(f"        /*{i:04x}*/                   FFMA R2, R3, R4, R2 ;\n"
              for i in range(16)) + """\
        /*0100*/              @!P1 BRA 0x200 ;
        /*0110*/                   STS [R99], R144 ;
        /*0120*/                   BSYNC B0 ;
""" + "".join(f"        /*{i:04x}*/                   FFMA R2, R3, R4, R2 ;\n"
              for i in range(17)) + """\
        /*0300*/                   EXIT ;
\t\tFunction : _Z8kernelILi9EEvPf
        /*0000*/                   EXIT ;
"""


def test_sass_opcode_mix_and_row_runs():
    """utils/sass.py on a made-up listing: opcodes with their predicates
    dropped, one list a kernel instance, runs of 16+ FFMAs split at
    branches, reconvergence points and exits."""
    fns = sass.functions(SASS)
    assert list(fns) == ["_Z8kernelILi15EEvPf", "_Z8kernelILi9EEvPf"]
    ops = fns["_Z8kernelILi15EEvPf"]
    assert ops[:2] == ["LDC", "LDG"] and ops.count("FFMA") == 33
    runs = sass.runs(ops)
    assert [sum(r.values()) for r in runs] == [19, 18]
    assert runs[0]["FFMA"] == 16 and runs[0]["BRA"] == 1
    assert runs[1]["FFMA"] == 17 and runs[1]["EXIT"] == 1
    assert sass.runs(fns["_Z8kernelILi9EEvPf"]) == []


# -- the FFT form (fft_fir_block, FftFirFilter, fir_filter, "auto") ---------
# Bounds: tests/test_fir.py's, 1e-4 (rtol and atol) against numpy for the
# short filters and 1e-3 for the long one; the port against the JAX
# functions on the same inputs within 1e-5 of the output's peak (measured
# 5e-7: both are f32 FFTs of the same length, rounded apart).
FFT_TOL = 1e-5


def _ref_fir(x, h, decim=1):
    """y[m] = sum_k h[k] x[m*decim - k], x[<0] = 0 (tests/test_fir.py)."""
    return np.convolve(x, h)[: len(x)][::decim]


def _taps_of(rng, K, complex_taps):
    h = rng.standard_normal(K)
    if complex_taps:
        h = h + 1j * rng.standard_normal(K)
    return h.astype(np.complex64 if complex_taps else np.float32)


@pytest.mark.parametrize("decim", [1, 2])
@pytest.mark.parametrize("complex_x,complex_taps",
                         [(False, False), (True, False), (False, True),
                          (True, True)])
def test_fft_fir_block_matches_jax(rng, complex_x, complex_taps, decim):
    """fft_fir_block against the JAX function on [history | block] of 2 x
    (K - 1 + 600): the same dtype (real for real input and taps) and
    values within FFT_TOL of the peak."""
    K, T = 101, 600
    h = _taps_of(rng, K, complex_taps)
    x = rng.standard_normal((2, K - 1 + T))
    if complex_x:
        x = x + 1j * rng.standard_normal(x.shape)
    x = x.astype(np.complex64 if complex_x else np.float32)
    want = np.asarray(jfir.fft_fir_block(jnp.asarray(x), jnp.asarray(h),
                                         decim))
    got = fir.fft_fir_block(torch.from_numpy(x), h, decim).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= FFT_TOL * np.abs(want).max()


@pytest.mark.parametrize("complex_taps", [False, True])
@pytest.mark.parametrize("kind", ["pair", "real", "complex"])
def test_fft_fir_filter_streamed(rng, kind, complex_taps):
    """FftFirFilter against the JAX FftFirFilter streamed over two blocks
    of 3 x 700: every output and state leaf within FFT_TOL of its peak.
    (On IqPair input the JAX FirFilter is always direct; the port's takes
    the FFT it is told to, within the same bound.)"""
    h = _taps_of(rng, 133, complex_taps)
    if kind == "real":
        x = rng.standard_normal((3, 1400)).astype(np.float32)
        blocks = np.split(x, 2, axis=-1)
    else:
        x = (rng.standard_normal((3, 1400))
             + 1j * rng.standard_normal((3, 1400))).astype(np.complex64)
        blocks = [b if kind == "complex" else (b.real.copy(), b.imag.copy())
                  for b in np.split(x, 2, axis=-1)]
    stream_both(jfir.FftFirFilter(h, lead_shape=(3,)),
                fir.FftFirFilter(h, lead_shape=(3,), device="cpu"), blocks,
                rtol=FFT_TOL, atol=0.0, peak=True)


@pytest.mark.parametrize("impl", ["conv", "fft"])
@pytest.mark.parametrize("nchunks", [1, 4, 8])
def test_fir_impl_block_size_invariance(rng, impl, nchunks):
    """tests/test_fir.py's block-size invariance on the port: complex 512
    samples, 33 real taps, in 1, 4 or 8 blocks, within 1e-4 of numpy."""
    x = (rng.standard_normal(512)
         + 1j * rng.standard_normal(512)).astype(np.complex64)
    h = rng.standard_normal(33).astype(np.float32)
    blk = fir.FirFilter(h, impl=impl, device="cpu")
    st, ys = blk.init_state(), []
    for part in np.split(x, nchunks):
        st, y = blk(st, torch.from_numpy(part))
        ys.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(ys), _ref_fir(x, h),
                               rtol=1e-4, atol=1e-4)


def test_fft_fir_long_taps(rng):
    """tests/test_fir.py's long-filter case on the port: 401 taps over
    4096 complex samples, within 1e-3 of numpy."""
    x = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    h = np.asarray(np.hamming(401) * np.sinc(np.linspace(-4, 4, 401)),
                   np.float32)
    y = fir.FftFirFilter(h, device="cpu").one_shot(
        torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, _ref_fir(x, h), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("decim", [1, 3])
def test_fir_filter_oneshot_matches_jax(rng, decim):
    """fir_filter (zero history) against the JAX function and numpy,
    within 1e-5 (tests/test_fir.py's bound)."""
    x = rng.standard_normal((2, 129)).astype(np.float32)
    h = rng.standard_normal(9).astype(np.float32)
    got = fir.fir_filter(torch.from_numpy(x), h, decim).numpy()
    want = np.asarray(jfir.fir_filter(jnp.asarray(x), jnp.asarray(h), decim))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0], _ref_fir(x[0], h, decim), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("K,complex_taps,decim,complex_in,want", [
    (963, True, 1, True, "fft"),     # AmMod's post filter
    (133, True, 1, True, "fft"),     # FreeDvMod's band-pass
    (167, True, 1, False, "conv"),   # SsbDemod's band-pass, on IqPair
    (fir.FFT_MIN_TAPS, True, 1, True, "fft"),
    (fir.FFT_MIN_TAPS - 1, True, 1, True, "conv"),
    (963, True, 2, True, "conv"),
    (963, False, 1, True, "conv"),   # real taps stay direct
    (837, False, 1, True, "conv"),   # the 4FSK filter bank's symbol LP
])
def test_auto_impl_rule(K, complex_taps, decim, complex_in, want):
    """"auto" resolves by taps, decimation and the input's kind alone, the
    same rule on every device: the FFT only for complex taps of more than
    96 at decimation 1 on a complex tensor."""
    assert fir.FFT_MIN_TAPS == 97
    h = np.ones(K, np.complex64 if complex_taps else np.float32)
    assert fir.auto_impl(h, decim, complex_in) == want
    blk = fir.FirFilter(h, decim, device="cpu")
    assert blk.impl == "auto" and blk.form(complex_in) == want
    assert fir.FirFilter(h, decim, impl="conv", device="cpu").form(
        complex_in) == "conv"


def test_auto_takes_the_direct_form_on_iq_pairs(rng):
    """A complex K167 filter: an IqPair block launches the direct kernels'
    plain version (fir_s1_f32 twice), a complex tensor the FFT form."""
    h = _taps_of(rng, 167, True)
    blk = fir.FirFilter(h, lead_shape=(2,), device="cpu")
    x = (rng.standard_normal((2, 800))
         + 1j * rng.standard_normal((2, 800))).astype(np.complex64)
    kernel_paths.reset()
    blk(blk.init_state(), IqPair(torch.from_numpy(x.real.copy()),
                                 torch.from_numpy(x.imag.copy())))
    assert set(kernel_paths.report()) == {"fir_s1_f32"}
    kernel_paths.reset()
    blk(blk.init_state(), torch.from_numpy(x))
    assert set(kernel_paths.report()) == {fir.FFT_OP}


def test_fft_form_records_its_route_on_cpu(rng):
    """The FFT form records one plain call a block under FFT_OP, with taps,
    stride, planes and rows; the direct kernels are not called."""
    h = _taps_of(rng, 963, True)
    blk = fir.FirFilter(h, lead_shape=(2,), device="cpu")
    x = torch.from_numpy((rng.standard_normal((2, 2000))
                          + 1j * rng.standard_normal((2, 2000))
                          ).astype(np.complex64))
    kernel_paths.reset()
    blk(blk.init_state(), x)
    rep = kernel_paths.report()
    assert set(rep) == {fir.FFT_OP}
    assert rep[fir.FFT_OP]["shapes"] == {"plain K963 D1 2x2": 1}


def test_fft_matches_direct_at_ammod_bound(rng):
    """The port's two forms of AmMod's post filter (963 complex taps) on
    the same real-as-complex input: within 1e-3 of the direct form's peak,
    the JAX package's FFT-against-direct bound (tests/test_fir.py)."""
    from qradiolink_tpu_torch.chains.am import AmMod

    taps = AmMod(device="cpu").post_filter.taps
    x = torch.from_numpy(rng.standard_normal((2, 3000)).astype(
        np.float32)).to(torch.complex64)
    ys = {}
    for impl in ("conv", "fft"):
        blk = fir.FirFilter(taps, impl=impl, lead_shape=(2,), device="cpu")
        st, y1 = blk(blk.init_state(), x[:, :1500])
        st, y2 = blk(st, x[:, 1500:])
        ys[impl] = torch.cat([y1, y2], -1).numpy()
    peak = np.abs(ys["conv"]).max()
    assert np.abs(ys["fft"] - ys["conv"]).max() <= 1e-3 * peak
