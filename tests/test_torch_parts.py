"""The parts of ported modules that came last, each against the JAX
function on the same numpy input, on the CPU:

- core.scan_stream and concat_stream_out over a chain (a decimating FIR,
  a quadrature demodulator and an Fn): the stacked outputs and the final
  state within 1e-5 (the FIR bound), and scan_stream equal to run_stream;
- core.Fn and core.device_init_state;
- utils/profiling's step_timer, and annotate inside trace, whose Chrome
  trace holds the region (tests/test_app.py:304-312);
- sync/feedforward.vv_carrier_correct on tests/test_feedforward.py:53-76's
  inputs: outputs within 1e-5 of their peak, phases within 1e-5 rad, and
  the JAX tests' residual rotation bounds;
- RationalResampler with complex taps at (L, M) = (1, 5), (3, 2), (2, 1)
  on real, complex and IqPair input, streaming two blocks and comparing
  every state leaf, within 1e-5 (the FIR bound), two kernel calls a block;
- io/native.native_available.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu import core as jcore  # noqa: E402
from qradiolink_tpu_torch import core  # noqa: E402
from tests.test_feedforward import make_shaped_bpsk  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_same, assert_states_same, stream_both)

TOL = 1e-5


def chains():
    """The same chain in both packages: a 31-tap low-pass decimating by 2,
    a quadrature demodulator and an Fn scaling by 0.5."""
    from qradiolink_tpu.ops import firdes
    from qradiolink_tpu.ops.analog import QuadratureDemod as JQuad
    from qradiolink_tpu.ops.fir import FirFilter as JFir
    from qradiolink_tpu_torch.ops.analog import QuadratureDemod
    from qradiolink_tpu_torch.ops.fir import FirFilter

    taps = firdes.low_pass(1.0, 1e5, 1e4, 5e3)[:31]
    jc = jcore.Chain([JFir(taps, decim=2, lead_shape=(2,)),
                      JQuad(1.0, lead_shape=(2,)),
                      jcore.Fn(lambda y: y * 0.5, "half")])
    tc = core.Chain([FirFilter(taps, decim=2, lead_shape=(2,),
                               device="cpu"),
                     QuadratureDemod(1.0, lead_shape=(2,), device="cpu"),
                     core.Fn(lambda y: y * 0.5, "half")])
    return jc, tc


def test_scan_stream_and_concat_match_jax(rng):
    x = (rng.standard_normal((3, 2, 400))
         + 1j * rng.standard_normal((3, 2, 400))).astype(np.complex64)
    jc, tc = chains()
    js, jy = jcore.scan_stream(jc, jnp.asarray(x))
    ts, ty = core.scan_stream(tc, torch.from_numpy(x))
    assert tuple(ty.shape) == (3, 2, 200)
    assert_same(np.asarray(jy), ty, TOL, TOL, what="stacked outputs")
    assert_states_same(js, ts, TOL, TOL)
    assert_same(np.asarray(jcore.concat_stream_out(jy)),
                core.concat_stream_out(ty), TOL, TOL, what="concatenated")
    # the same as the host loop, block by block
    run = list(core.run_stream(tc, torch.from_numpy(x)))
    assert torch.equal(torch.stack(run), ty)


def test_scan_stream_stacks_dicts_and_iq_pairs(rng):
    """Every output leaf stacks to (N, ...), an IqPair input splits along
    N: the main path's chain over three blocks equals run_stream bit for
    bit."""
    from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF

    re = rng.standard_normal((3, 2, 4000)).astype(np.float32) * 0.1
    im = rng.standard_normal((3, 2, 4000)).astype(np.float32) * 0.1
    x = core.IqPair(torch.from_numpy(re), torch.from_numpy(im))
    chain = Fsk4DemodFF(lead_shape=(2,), device="cpu")
    state, ys = core.scan_stream(chain, x)
    st = chain.init_state()
    for i in range(3):
        st, out = chain(st, core.IqPair(x.re[i], x.im[i]))
        for key in ("bits", "symbols", "rssi"):
            assert torch.equal(ys[key][i], out[key]), key
        assert torch.equal(ys["constellation"].re[i], out["constellation"].re)
    assert all(torch.equal(a, b) for a, b in zip(core._flatten(state, []),
                                                 core._flatten(st, [])))


def test_fn_matches_jax(rng):
    x = rng.standard_normal((2, 64)).astype(np.float32)
    jf, tf = jcore.Fn(jnp.tanh), core.Fn(torch.tanh)
    assert tf.name == jf.name == "tanh"
    assert core.Fn(torch.tanh, "squash").name == "squash"
    js, jy = jf(jf.init_state(), jnp.asarray(x))
    ts, ty = tf(tf.init_state(), torch.from_numpy(x))
    assert ts == () and js == ()
    assert_same(np.asarray(jy), ty, TOL, TOL)
    assert_same(np.asarray(jf.one_shot(jnp.asarray(x))),
                tf.one_shot(torch.from_numpy(x)), TOL, TOL)


def test_device_init_state_is_the_blocks_state():
    from qradiolink_tpu.chains.nbfm import NbfmDemod as JaxNbfm
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod

    demod = NbfmDemod(lead_shape=(2,), device="cpu")
    st = core.device_init_state(demod)
    assert all(leaf.device.type == "cpu" for leaf in core._flatten(st, []))
    assert_states_same(jcore.device_init_state(JaxNbfm(lead_shape=(2,))),
                       st, 0, 0)


def test_profiling_helpers(tmp_path):
    """tests/test_app.py:304-312 on the port, the keys of the JAX dict,
    and the region's name in the Chrome trace."""
    from qradiolink_tpu.utils import profiling as jprof
    from qradiolink_tpu_torch.utils.profiling import (annotate, step_timer,
                                                      trace)

    f = jax.jit(lambda x: x * 2.0)
    want = jprof.step_timer(f, jnp.ones(1000), iters=2,
                            samples_per_step=1000)
    x = torch.ones(1000)
    stats = step_timer(lambda x: x * 2.0, x, iters=2, samples_per_step=1000)
    assert set(stats) == set(want) == {"step_ms", "samples_per_s"}
    assert stats["step_ms"] > 0 and stats["samples_per_s"] > 0
    assert set(step_timer(lambda x: x * 2.0, x, iters=1)) == {"step_ms"}
    with trace(str(tmp_path)):
        with annotate("test-region"):
            (x * 2.0).sum()
    events = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "test-region" in names


@pytest.mark.parametrize("seed,cfo", [(2, 0.0), (3, 1e-5)])
def test_vv_carrier_correct_matches_jax(seed, cfo):
    """tests/test_feedforward.py:53-76: shaped BPSK at sps 10 with a 1.1 rad
    offset, or a slow carrier offset."""
    from qradiolink_tpu.sync.feedforward import vv_carrier_correct as jvv
    from qradiolink_tpu_torch.sync.feedforward import vv_carrier_correct

    rng = np.random.default_rng(seed)
    _, x = make_shaped_bpsk(rng, 1600, 10)
    t = np.arange(len(x))
    if cfo:
        x = (x * np.exp(2j * np.pi * cfo * t)).astype(np.complex64)
    else:
        x = x * np.exp(1j * 1.1).astype(np.complex64)
    jy, jph = jvv(jnp.asarray(x), order=2, n_sub=16)
    y, ph = vv_carrier_correct(torch.from_numpy(x), order=2, n_sub=16)
    assert y.dtype == torch.complex64 and tuple(ph.shape) == (16,)
    assert_same(np.asarray(jph), ph, 0, TOL, what="phases")
    assert_same(np.asarray(jy), y, TOL, 0, peak=True, what="corrected")
    y = y.numpy()
    rot = np.abs(np.angle(y[np.abs(y) > 0.5]))
    rot = np.minimum(rot, np.pi - rot)  # BPSK 180-deg ambiguity
    assert np.median(rot) < (0.2 if cfo else 0.15)


def test_vv_carrier_correct_rows_match_jax(rng):
    """Rows of a batch, order 4: each row's phases and output as the JAX
    function gives them."""
    from qradiolink_tpu.sync.feedforward import vv_carrier_correct as jvv
    from qradiolink_tpu_torch.sync.feedforward import vv_carrier_correct

    x = np.stack([make_shaped_bpsk(rng, 800, 10)[1] * np.exp(1j * a)
                  for a in (0.3, -0.7, 2.0)]).astype(np.complex64)
    jy, jph = jvv(jnp.asarray(x), order=4, n_sub=8)
    y, ph = vv_carrier_correct(torch.from_numpy(x), order=4, n_sub=8)
    assert_same(np.asarray(jph), ph, 0, TOL, what="phases")
    assert_same(np.asarray(jy), y, TOL, 0, peak=True, what="corrected")


@pytest.mark.parametrize("kind", ["real", "complex", "pair"])
@pytest.mark.parametrize("L,M", [(1, 5), (3, 2), (2, 1)])
def test_complex_tap_resampler_matches_jax(rng, L, M, kind):
    from qradiolink_tpu.ops.resample import RationalResampler as JaxRs
    from qradiolink_tpu_torch.ops.resample import RationalResampler
    from qradiolink_tpu_torch.utils.profiling import kernel_paths

    taps = (rng.standard_normal(37) + 1j * rng.standard_normal(37)) * 0.2
    taps = taps.astype(np.complex64)
    T = 60 * M
    blocks = []
    for _ in range(2):
        re = rng.standard_normal((2, T)).astype(np.float32)
        im = rng.standard_normal((2, T)).astype(np.float32)
        blocks.append(re if kind == "real" else (re, im) if kind == "pair"
                      else (re + 1j * im).astype(np.complex64))
    rs = RationalResampler(L, M, taps=taps, lead_shape=(2,), device="cpu")
    kernel_paths.reset()
    stream_both(JaxRs(L, M, taps=taps, lead_shape=(2,)), rs, blocks, TOL,
                TOL)
    # one run of the routed kernel's plain version a tap plane a block
    calls = sum(r["plain"] for r in kernel_paths.report().values())
    assert calls == 2 * len(blocks)
    assert not kernel_paths.served_only()


def test_native_available(tmp_path, monkeypatch):
    """True where the engine builds and loads, as in the JAX package; False
    where g++ refuses the source, and the engine's calls still raise."""
    from qradiolink_tpu.io import native as jnative
    from qradiolink_tpu_torch.io import native

    assert native.native_available() is True
    assert jnative.native_available() is True
    bad = tmp_path / "qrl_native.cpp"
    bad.write_text("extern \"C\" void qrl_broken( { }\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    assert native.native_available() is False
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        native.cs16_to_f32(np.zeros(4, np.int16))
