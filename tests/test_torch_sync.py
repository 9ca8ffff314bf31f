"""Feedforward symbol sync and quadrature demod of the port against the JAX
package, streamed over two blocks with every state leaf compared.
Tolerance atol 1e-5: the stages are elementwise f32 math and small
reductions whose summation order differs between the frameworks."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu.ops.analog import QuadratureDemod as JaxQuad  # noqa: E402
from qradiolink_tpu.sync import feedforward as jff  # noqa: E402
from qradiolink_tpu_torch.ops.analog import QuadratureDemod  # noqa: E402
from qradiolink_tpu_torch.sync import feedforward as ff  # noqa: E402
from tests.torch_parity import stream_both, assert_same  # noqa: E402

SPS = 10


def _fsk_like(rng, lead, n_sym, sps=SPS):
    """A smoothed 4-level symbol stream plus noise, as the sync sees it
    after the RRC: a timing line to estimate, offset per channel."""
    levels = rng.choice([-1.5, -0.5, 0.5, 1.5], lead + (n_sym,))
    x = np.repeat(levels, sps, axis=-1)
    kern = np.hanning(sps + 1)
    kern /= kern.sum()
    x = np.apply_along_axis(lambda r: np.convolve(r, kern, "same"), -1, x)
    x = x + 0.05 * rng.standard_normal(x.shape)
    return x.astype(np.float32)


def _blocks(x, n):
    return np.split(x, n, axis=-1)


def test_feedforward_sync_streamed(rng):
    x = _fsk_like(rng, (4,), 160)
    stream_both(jff.FeedforwardSymbolSync(SPS, lead_shape=(4,)),
                ff.FeedforwardSymbolSync(SPS, lead_shape=(4,), device="cpu"),
                _blocks(x, 2))


def test_feedforward_sync_window_mode(rng):
    x = _fsk_like(rng, (4,), 160)
    stream_both(jff.FeedforwardSymbolSync(SPS, lead_shape=(4,), window=200),
                ff.FeedforwardSymbolSync(SPS, lead_shape=(4,), window=200,
                                         device="cpu"),
                _blocks(x, 2))


def test_acc_decay_is_a_class_attribute():
    assert ff.FeedforwardSymbolSync.ACC_DECAY == \
        jff.FeedforwardSymbolSync.ACC_DECAY


@pytest.mark.parametrize("fn", ["agc", "om", "farrow", "pick"])
def test_sync_helpers(rng, fn):
    x = _fsk_like(rng, (3,), 40)
    if fn == "agc":
        a = jff.block_agc(jnp.asarray(x), n_sub=4)
        b = ff.block_agc(torch.from_numpy(x), n_sub=4)
    elif fn == "om":
        a = jff.om_timing_estimate(jnp.asarray(x), SPS, n_sub=4)
        b = ff.om_timing_estimate(torch.from_numpy(x), SPS, n_sub=4)
    elif fn == "farrow":
        mu = rng.random(x.shape).astype(np.float32)
        a = jff.farrow_delay(jnp.asarray(x), jnp.asarray(mu))
        b = ff.farrow_delay(torch.from_numpy(x), torch.from_numpy(mu))
    else:
        tau = rng.integers(0, SPS, (3, 4)).astype(np.float32)
        y = x.reshape(3, 4, 100)
        a = jff.symbol_pick(jnp.asarray(y), jnp.asarray(tau), SPS)
        b = ff.symbol_pick(torch.from_numpy(y), torch.from_numpy(tau), SPS)
    assert_same(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["pair", "complex"])
def test_quadrature_demod_streamed(rng, kind):
    """Including exact-zero (squelched) samples and samples so small that
    their squares are denormal, which the reference counts as zero."""
    blocks = []
    for _ in range(2):
        re = rng.standard_normal((3, 500)).astype(np.float32)
        im = rng.standard_normal((3, 500)).astype(np.float32)
        re[:, 100:140] = 0.0
        im[:, 100:140] = 0.0
        re[:, 200:210] *= 1e-10
        im[:, 200:210] *= 1e-10
        blocks.append((re, im) if kind == "pair"
                      else (re + 1j * im).astype(np.complex64))
    stream_both(JaxQuad(SPS / np.pi, lead_shape=(3,)),
                QuadratureDemod(SPS / np.pi, lead_shape=(3,), device="cpu"),
                blocks)
