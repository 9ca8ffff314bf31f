"""Port core (qradiolink_tpu_torch/core.py): state trees cross between the
frameworks, through npz snapshots in both directions and through
state_from_numpy / state_to_numpy."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qradiolink_tpu import core as jcore  # noqa: E402
from qradiolink_tpu.chains.fsk import Fsk4DemodFF as JaxFsk4  # noqa: E402
from qradiolink_tpu_torch import core  # noqa: E402
from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF  # noqa: E402
from qradiolink_tpu_torch.ops.fir import FirFilter  # noqa: E402
from tests.torch_parity import assert_states_same  # noqa: E402


def _random_state(like, rng):
    """A numpy state tree shaped like `like` with random leaf values."""
    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return rng.integers(0, 2, a.shape).astype(a.dtype)
        return rng.standard_normal(a.shape).astype(a.dtype)
    return jax.tree_util.tree_map(leaf, like)


@pytest.fixture
def chains():
    return JaxFsk4(lead_shape=(3,)), Fsk4DemodFF(lead_shape=(3,),
                                                  device="cpu")


def test_init_states_match(chains):
    jchain, tchain = chains
    assert_states_same(jchain.init_state(), tchain.init_state(), 0, 0)


def test_jax_snapshot_loads_into_port(chains, tmp_path, rng):
    jchain, tchain = chains
    st = _random_state(jchain.init_state(), rng)
    jcore.save_state(tmp_path / "j.npz", jax.tree_util.tree_map(
        jnp.asarray, st))
    loaded = core.load_state(tmp_path / "j.npz", tchain.init_state())
    assert_states_same(st, loaded, 0, 0)


def test_port_snapshot_loads_into_jax(chains, tmp_path, rng):
    jchain, tchain = chains
    st = _random_state(jchain.init_state(), rng)
    core.save_state(tmp_path / "t.npz", core.state_from_numpy(st, "cpu"))
    loaded = jcore.load_state(tmp_path / "t.npz", jchain.init_state())
    assert_states_same(loaded, core.state_from_numpy(st, "cpu"), 0, 0)


def test_load_state_rejects_wrong_structure(chains, tmp_path):
    _, tchain = chains
    core.save_state(tmp_path / "f.npz", FirFilter(
        np.ones(5, np.float32), device="cpu").init_state())
    with pytest.raises(ValueError):
        core.load_state(tmp_path / "f.npz", tchain.init_state())


def test_state_numpy_round_trip(chains, rng):
    jchain, _ = chains
    st = _random_state(jchain.init_state(), rng)
    t = core.state_from_numpy(st, "cpu")
    back = core.state_to_numpy(t)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(st))
    for a, b in zip(jax.tree_util.tree_leaves(st),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_chain_and_run_stream_block_size_invariant(rng):
    """A Chain streamed in blocks through run_stream equals one block."""
    taps = rng.standard_normal(9).astype(np.float32)
    x = rng.standard_normal((2, 600)).astype(np.float32)
    chain = core.Chain([FirFilter(taps, lead_shape=(2,), device="cpu"),
                        FirFilter(taps[::-1], decim=2, lead_shape=(2,),
                                  device="cpu")])
    whole = chain.one_shot(torch.from_numpy(x))
    parts = list(core.run_stream(chain, [torch.from_numpy(c) for c in
                                         np.split(x, 3, axis=-1)]))
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), whole.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_iq_take_and_abs(rng):
    re = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    im = torch.from_numpy(rng.standard_normal((5, 8)).astype(np.float32))
    pair = core.IqPair(re, im)
    sl = core.iq_take(pair, [1, 2, 3], axis=0)
    assert sl.re.data_ptr() == re[1].data_ptr()  # a range is a view
    np.testing.assert_array_equal(core.iq_take(pair, [4, 0], axis=0).im,
                                  im[[4, 0]])
    np.testing.assert_allclose(core.iq_abs(pair),
                               torch.abs(pair.to_complex()), rtol=1e-6)


# the chains of slice 6: (JAX module, class, kwargs); each built with
# lead_shape (2,) but the MMDVM multi-carrier pair, whose channel axis is
# its own
NEW_CHAINS = [
    ("fsk", "Fsk4Demod", {}), ("fsk", "Fsk4Demod", {"variant": "96K"}),
    ("fsk", "Fsk4FbDemod", {}), ("fsk", "Fsk4Mod", {"variant": "10KFM"}),
    ("fsk", "Fsk2Demod", {}), ("fsk", "Fsk2FbDemod", {}),
    ("fsk", "GmskDemod", {}), ("fsk", "Fsk2Mod", {}), ("fsk", "GmskMod", {}),
    ("dsss", "DsssBpskDemod", {}), ("dsss", "DsssBpskMod", {}),
    ("dsss", "CwMod", {}), ("freedv", "FreeDvDemod", {}),
    ("freedv", "FreeDvMod", {"usb": False}), ("mmdvm", "MmdvmDemod", {}),
    ("mmdvm", "MmdvmMod", {}), ("mmdvm", "MmdvmMultiRx", {}),
    ("mmdvm", "MmdvmMultiTx", {"num_channels": 5})]


@pytest.mark.parametrize("mod,cls,kw", NEW_CHAINS, ids=[
    "-".join([c] + [str(v) for v in k.values()]) for _, c, k in NEW_CHAINS])
def test_new_chain_snapshot_crosses(tmp_path, rng, mod, cls, kw):
    """A random JAX state of the chain saved by the JAX package loads into
    the port's chain leaf for leaf (dtypes, shapes and values), and the
    port's initial state equals the JAX chain's."""
    import importlib

    jmod = importlib.import_module(f"qradiolink_tpu.chains.{mod}")
    tmod = importlib.import_module(f"qradiolink_tpu_torch.chains.{mod}")
    lead = {} if cls.startswith("MmdvmMulti") else {"lead_shape": (2,)}
    jchain = getattr(jmod, cls)(**lead, **kw)
    tchain = getattr(tmod, cls)(**lead, **kw, device="cpu")
    assert_states_same(jchain.init_state(), tchain.init_state(), 0, 0)
    st = _random_state(jchain.init_state(), rng)
    jcore.save_state(tmp_path / "j.npz", jax.tree_util.tree_map(
        jnp.asarray, st))
    assert_states_same(st, core.load_state(tmp_path / "j.npz",
                                           tchain.init_state()), 0, 0)


def test_put_and_get_iq_match_jax(rng):
    """put_iq, put_iq_pair and get_iq on the CPU: the same values and dtypes
    as the JAX package's, complex64 back from an IqPair or a complex
    tensor, real input as is."""
    x = (rng.standard_normal((2, 50))
         + 1j * rng.standard_normal((2, 50))).astype(np.complex128)
    y = core.put_iq(x, device="cpu")
    assert y.dtype == torch.complex64 and y.device.type == "cpu"
    np.testing.assert_array_equal(y.numpy(), np.asarray(jcore.put_iq(x)))
    p = core.put_iq_pair(x, device="cpu")
    jp = jcore.put_iq_pair(x)
    np.testing.assert_array_equal(p.re.numpy(), np.asarray(jp.re))
    np.testing.assert_array_equal(p.im.numpy(), np.asarray(jp.im))
    assert core.put_iq_pair(p) is p
    p2 = core.put_iq_pair((x.real, x.imag), device="cpu")
    np.testing.assert_array_equal(p2.im.numpy(), p.im.numpy())
    for v in (p, y):
        got = core.get_iq(v)
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, jcore.get_iq(jp))
    r = rng.standard_normal(7).astype(np.float32)
    np.testing.assert_array_equal(core.put_iq(r, device="cpu").numpy(), r)
    assert core.get_iq(r) is r
