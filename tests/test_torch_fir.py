"""FIR stages of the port against the JAX package: firdes taps, conv1d_valid,
FirFilter and RationalResampler streamed with state, and the plain version
of the `fir_stream_f32` kernel against the JAX Pallas kernels it replaces
(banded_fir_stream, banded_fir), run in interpret mode. Tolerance: 1e-5,
the bound the JAX package holds its own FIR kernels to
(tests/test_pallas_kernels.py)."""

import functools

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
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.ops import firdes, fir  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_fir import (  # noqa: E402
    fir_stream, fir_stream_plain)
from qradiolink_tpu_torch.ops.resample import RationalResampler  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
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


@pytest.mark.parametrize("kind", ["pair", "real", "complex"])
def test_fir_filter_streamed(rng, kind):
    taps = _taps("chan_lp")
    blocks = []
    for _ in range(2):
        re = rng.standard_normal((3, 2000)).astype(np.float32)
        im = rng.standard_normal((3, 2000)).astype(np.float32)
        blocks.append({"pair": (re, im), "real": re,
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
    assert rep["shapes"] == {"plain K5 D5 tail": 1}
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
