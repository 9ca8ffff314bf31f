"""The port's multi-process path (qradiolink_tpu_torch/parallel/multihost.py)
against the JAX package's: tests/test_multihost.py's case (Fsk4DemodFF on
C 8 channels x T 40,000 samples, 2 steps with state carried) on two gloo
processes (tests/torch_multihost_worker.py), each ingesting only its own 4
rows (local_channel_slice, distribute_channels) over a (host, ch) pod mesh
with the global zero state sharded (shard_state).

The reference is the JAX chain over all 8 rows in this process. The JAX
chain runs its K251 RRC as an FFT on the CPU and the port in direct form,
so it is compared as tests/test_torch_chain.py compares the two on noise:
each rank's symbols within 1e-5 + 1e-5 |s| of its rows of the JAX run
(measured 6.7e-6), its bits equal, and every leaf of its final local state
within 1e-5 of that leaf's peak (measured 7e-6 at most, the RRC's tail;
the Viterbi tail's soft values, up to 255, 4.3e-6 of it).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.torch_multihost_worker import start_ranks  # noqa: E402
from tests.torch_parity import assert_same  # noqa: E402

C, T, STEPS = 8, 40_000, 2
TOL = 1e-5


def test_two_process_multihost_step_matches_jax(tmp_path):
    from qradiolink_tpu.chains.fsk import Fsk4DemodFF

    rng = np.random.default_rng(7)
    blocks = np.stack([(rng.standard_normal((C, T))
                        + 1j * rng.standard_normal((C, T))).astype(
                            np.complex64) * 0.1 for _ in range(STEPS)])
    wait = start_ranks("multihost", {"blocks": blocks}, tmp_path)
    chain = Fsk4DemodFF(lead_shape=(C,))
    state, want = chain.init_state(), []
    for blk in blocks:
        state, out = chain(state, jnp.asarray(blk))
        want.append({k: np.asarray(out[k]) for k in ("symbols", "bits")})
    leaves = [np.asarray(leaf) for leaf in jax.tree_util.tree_leaves(state)]

    ranks = wait()
    assert [list(r["rows"]) for r in ranks] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for rank, r in enumerate(ranks):
        rows = r["rows"]
        for i in range(STEPS):
            what = f"rank {rank} step {i}"
            assert_same(want[i]["symbols"][rows], r[f"symbols{i}"], TOL, TOL,
                        what=f"{what} symbols")
            assert_same(want[i]["bits"][rows], r[f"bits{i}"],
                        what=f"{what} bits")
        assert len([k for k in r if k.startswith("state")]) == len(leaves)
        for j, leaf in enumerate(leaves):
            assert_same(leaf[rows], r[f"state{j}"], TOL, 0.0, peak=True,
                        what=f"rank {rank} state leaf {j}")
