"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy and handed to both frameworks; outputs and state
trees come back as numpy and are compared leaf by leaf, integer leaves
exactly and float leaves within a stated tolerance.

Importing this module caps torch's intra-op threads at 2: the driver runs
the tests in several xdist workers at once, and a torch process that takes
every core starves the timing-sensitive tests beside it (a ZeroMQ receive
with a 3 s timeout, for one).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from qradiolink_tpu.core import IqPair as JaxPair
from qradiolink_tpu_torch.core import IqPair as TorchPair, state_to_numpy

torch.set_num_threads(2)


def to_jax(x):
    """numpy array -> jnp array; a (re, im) tuple -> JAX IqPair."""
    if isinstance(x, tuple):
        return JaxPair(jnp.asarray(x[0]), jnp.asarray(x[1]))
    return jnp.asarray(x)


def to_torch(x, device="cpu"):
    """numpy array -> tensor; a (re, im) tuple -> port IqPair."""
    if isinstance(x, tuple):
        return TorchPair(torch.from_numpy(np.array(x[0])).to(device),
                         torch.from_numpy(np.array(x[1])).to(device))
    return torch.from_numpy(np.array(x)).to(device)


def to_numpy(y):
    """Output of either framework -> numpy (an IqPair -> complex)."""
    if isinstance(y, (JaxPair, TorchPair)):
        return to_numpy(y.re) + 1j * to_numpy(y.im)
    if isinstance(y, torch.Tensor):
        return y.detach().cpu().numpy()
    return np.asarray(y)


def assert_same(jax_y, torch_y, rtol=1e-5, atol=1e-5, what="output",
                peak=False, wrap=False):
    """Same shape and dtype kind; integers and bools equal, floats close:
    elementwise |b - a| <= atol + rtol |a|, or with peak=True
    max |b - a| <= atol + rtol max |a| (relative to the output's peak, the
    form the JAX package's channelizer tests use); wrap (with peak) takes
    differences modulo 2 pi (a carried phase in [0, 2 pi) may sit at either
    end)."""
    a, b = to_numpy(jax_y), to_numpy(torch_y)
    assert a.shape == b.shape, f"{what}: shape {a.shape} != {b.shape}"
    assert a.dtype == b.dtype, f"{what}: dtype {a.dtype} != {b.dtype}"
    if np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_:
        np.testing.assert_array_equal(a, b, err_msg=what)
    elif peak:
        d = np.abs(b.astype(np.result_type(b.dtype, np.float64)) - a)
        if wrap:
            d = np.minimum(d, np.abs(d - 2 * np.pi))
        err = float(d.max()) if a.size else 0.0
        lim = atol + rtol * (float(np.abs(a).max()) if a.size else 0.0)
        assert err <= lim, f"{what}: max |diff| {err:.3e} > {lim:.3e}"
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=what)


def assert_states_same(jax_state, torch_state, rtol=1e-5, atol=1e-5,
                       peak=False, wrap=False):
    """Same tree structure; every leaf the same (see assert_same)."""
    jnp_tree = jax.tree_util.tree_map(np.asarray, jax_state)
    t_tree = state_to_numpy(torch_state)
    assert (jax.tree_util.tree_structure(jnp_tree)
            == jax.tree_util.tree_structure(t_tree))
    for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jnp_tree),
                                   jax.tree_util.tree_leaves(t_tree))):
        assert_same(a, b, rtol, atol, what=f"state leaf {i}", peak=peak,
                    wrap=wrap)


def assert_outputs_same(jy, ty, rtol=1e-5, atol=1e-5, key_tol=None,
                        what="output", peak=False):
    """Outputs of either framework: a dict (key_tol maps a key to its own
    (rtol, atol)), a list of outputs (MultichannelRx's groups), or one
    array or IqPair."""
    if isinstance(jy, dict):
        assert set(jy) == set(ty), what
        for k in jy:
            r, a = (key_tol or {}).get(k, (rtol, atol))
            assert_outputs_same(jy[k], ty[k], r, a, key_tol, f"{what} {k}",
                                peak)
    elif isinstance(jy, list):
        assert isinstance(ty, list) and len(jy) == len(ty), what
        for g, (a, b) in enumerate(zip(jy, ty)):
            assert_outputs_same(a, b, rtol, atol, key_tol, f"{what}[{g}]",
                                peak)
    else:
        assert_same(jy, ty, rtol, atol, what=what, peak=peak)


def stream_both(jax_block, torch_block, blocks, rtol=1e-5, atol=1e-5,
                state_rtol=None, state_atol=None, key_tol=None, peak=False,
                call=None, wrap_phase=False):
    """Stream the numpy `blocks` through both blocks from their initial
    states, comparing every output and every state leaf after each block.
    key_tol maps an output key of a dict-returning block to its own
    (rtol, atol); peak=True compares floats relative to their peak (see
    assert_same), wrap_phase (with peak) the state leaves modulo 2 pi (a
    FrequencyMod's carried phase). call(block, state, blk, conv) -> (state,
    out) runs one block, conv (to_jax or to_torch) converting its inputs
    (default: block(state, conv(blk)); a block may then be a tuple of
    inputs, a mask beside the signal). Returns the final (jax_state,
    torch_state) and the outputs of the last block, (jax_out,
    torch_out)."""
    call = call or (lambda b, s, x, conv: b(s, conv(x)))
    js, ts = jax_block.init_state(), torch_block.init_state()
    assert_states_same(js, ts)
    for i, blk in enumerate(blocks):
        js, jy = call(jax_block, js, blk, to_jax)
        ts, ty = call(torch_block, ts, blk, to_torch)
        assert_outputs_same(jy, ty, rtol, atol, key_tol, f"block {i}", peak)
        assert_states_same(js, ts,
                           rtol if state_rtol is None else state_rtol,
                           atol if state_atol is None else state_atol,
                           peak=peak, wrap=wrap_phase)
    return (js, ts), (jy, ty)


def direct_firs(chain):
    """The JAX chain with every FirFilter that its "auto" runs as an FFT on
    the CPU (more than 96 taps at decimation <= 2) swapped for the same
    filter in direct form, impl="conv", as the port computes it (the
    "direct" variant of the demodulators' parity tests); attributes and
    lists of filters (a filter bank) alike."""
    from qradiolink_tpu.ops.fir import FirFilter as JaxFir

    def direct(f):
        if isinstance(f, JaxFir) and f.impl == "fft":
            return JaxFir(np.asarray(f.taps), f.decim, impl="conv",
                          lead_shape=f.lead_shape)
        return f

    for k, v in list(vars(chain).items()):
        if isinstance(v, list):
            setattr(chain, k, [direct(f) for f in v])
        else:
            setattr(chain, k, direct(v))
    return chain

