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
