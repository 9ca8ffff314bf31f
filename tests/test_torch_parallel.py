"""The port's scale-out (qradiolink_tpu_torch/parallel/sharding.py) against
the JAX package's on the CPU: two real gloo processes
(tests/torch_multihost_worker.py) against the JAX functions on a 2-device
mesh of the 8 virtual CPU devices tests/conftest.py makes.

- time_sharded_fir at K 31, and K 25 with decimation 5
  (tests/test_sharding.py:21-38): within 1e-5 of the JAX output's peak;
- time_sharded_chain of Fsk4DemodFF(sync_window=320), 2 x 192,000
  samples with a halo of 64,000: bit-equal to the JAX sharded run and to
  the serial run beyond the first shard, at most 16 differences in it
  (tests/test_time_sharded.py:52-60);
  (the signal made by the port's Fsk4Mod, and tests/test_sharding.py's by
  the port's NbfmMod: the JAX modulators' first calls cost seconds);
- shard_over_channels with NbfmDemod on 8 channels over 2 ranks, against
  the JAX sharded run past the squelch's opening (audio[:, 200:], the JAX
  test's bound), and the refusal of a chain built for all 8 rows;
- MultichannelRx with a mesh on the JAX test's 8-channel [1, 5] case, two
  blocks, with a one-row group [3] that the second rank skips: each rank's
  rows within 1e-5 of the JAX output's peak;
- the gradient of an NBFM loss (tests/test_sharding.py:120-131) through the
  port's plain path, against jax.grad within 1e-4 relative.

The ranks save what they computed; the references are computed here once,
while the ranks run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from qradiolink_tpu.parallel import sharding as jsh  # noqa: E402
from tests.torch_multihost_worker import start_ranks  # noqa: E402
from tests.torch_parity import assert_same, direct_firs  # noqa: E402

FIR_TOL = 1e-5
HEAD_MISMATCHES = 16   # tests/test_time_sharded.py:59
# one Viterbi tile at 1 Msps, and a multiple of it (the window and tile
# boundaries of the serial and sharded runs coincide)
CHAIN_HALO, CHAIN_LOCAL = 64_000, 192_000


def jax_mesh(axis):
    assert len(jax.devices()) >= 2, "expected the virtual CPU devices"
    return jsh.make_mesh(2, axis=axis)


@pytest.mark.parametrize("k,n_local,decim", [(31, 512, 1), (25, 500, 5)])
def test_time_sharded_fir_matches_jax(rng, tmp_path, k, n_local, decim):
    taps = rng.standard_normal(k).astype(np.float32)
    x = rng.standard_normal(2 * n_local).astype(np.float32)
    wait = start_ranks("fir", {"taps": taps, "x": x,
                               "decim": np.asarray(decim)}, tmp_path)
    want = np.asarray(jsh.time_sharded_fir(
        taps, jax_mesh("t"), axis="t", decim=decim)(jnp.asarray(x)))
    ranks = wait()
    got = np.concatenate([r["y"] for r in ranks])
    assert_same(want, got, FIR_TOL, 0.0, peak=True)
    # and the serial FIR from zero state
    assert_same(np.convolve(x, taps)[:len(x)][::decim], got, FIR_TOL, 0.0,
                peak=True)


@pytest.fixture(scope="module")
def chain_run(tmp_path_factory):
    """tests/test_time_sharded.py's signal (400 seeded bytes through the
    port's Fsk4Mod, which the FSK tests hold to the JAX one) on 2 x 192,000
    samples, and the two ranks' bits."""
    from qradiolink_tpu_torch.chains.fsk import Fsk4Mod

    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 400).astype(np.uint8)
    mod = Fsk4Mod(device="cpu")
    signal = mod(mod.init_state(), torch.from_numpy(data))[1]["iq"].numpy()
    iq = np.zeros(2 * CHAIN_LOCAL, np.complex64)
    iq[:min(len(signal), iq.size)] = signal[:iq.size]
    wait = start_ranks("chain", {"iq": iq, "halo": np.asarray(CHAIN_HALO)},
                       tmp_path_factory.mktemp("chain"))
    return iq, wait


def chain_bits_agree(ranks, want, what):
    """The time-sharded contract: the ranks' bits equal to `want` beyond the
    first shard (rank 0's), at most HEAD_MISMATCHES differences in it."""
    got = np.concatenate([r["bits"] for r in ranks])
    per_shard = len(ranks[0]["bits"])
    assert 0 < per_shard < len(got), what
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got[per_shard:], want[per_shard:],
                                  err_msg=what)
    head = int(np.sum(got[:per_shard] != want[:per_shard]))
    assert head <= HEAD_MISMATCHES, f"{what}: {head} head mismatches"


def test_time_sharded_chain_matches_jax_sharded(chain_run):
    from qradiolink_tpu.chains.fsk import Fsk4DemodFF

    iq, wait = chain_run
    mesh = jax_mesh("t")
    fn = jsh.time_sharded_chain(Fsk4DemodFF(sync_window=320), mesh,
                                halo=CHAIN_HALO, axis="t")
    want = np.asarray(fn(jax.device_put(
        jnp.asarray(iq), NamedSharding(mesh, P("t"))))["bits"])
    chain_bits_agree(wait(), want, "JAX sharded")


def test_time_sharded_chain_matches_jax_serial(chain_run):
    from qradiolink_tpu.chains.fsk import Fsk4DemodFF

    iq, wait = chain_run
    chain = Fsk4DemodFF(sync_window=320)
    want = np.asarray(chain(chain.init_state(), jnp.asarray(iq))[1]["bits"])
    chain_bits_agree(wait(), want, "JAX serial")


@pytest.fixture(scope="module")
def channels_run(tmp_path_factory):
    """8 NBFM channels (tests/test_sharding.py:41-65): the JAX sharded run's
    audio and the two ranks' saved arrays."""
    from qradiolink_tpu.chains.nbfm import NbfmDemod
    from qradiolink_tpu_torch.chains.nbfm import NbfmMod

    C, n_audio = 8, 1000
    audio = np.stack([
        0.5 * np.sin(2 * np.pi * (300.0 + 100.0 * c)
                     * np.arange(n_audio) / 8000.0)
        for c in range(C)]).astype(np.float32)
    mod = NbfmMod(lead_shape=(C,), device="cpu")
    iq = mod(mod.init_state(), torch.from_numpy(audio))[1]["iq"].numpy()
    wait = start_ranks("channels", {"iq": iq},
                       tmp_path_factory.mktemp("channels"))
    demod = NbfmDemod(lead_shape=(C,))
    step, place = jsh.shard_over_channels(demod, jax_mesh("ch"), axis="ch")
    _, out = step(place(demod.init_state()), place(jnp.asarray(iq)))
    return np.asarray(out["audio"]), wait()


def test_channel_sharded_nbfm_matches_jax(channels_run):
    want, ranks = channels_run
    got = np.concatenate([r["audio"] for r in ranks])
    assert got.shape == want.shape
    # past the squelch's opening, the JAX test's bound
    np.testing.assert_allclose(got[:, 200:], want[:, 200:], rtol=1e-3,
                               atol=1e-4)


def test_chain_built_for_every_row_is_refused(channels_run):
    _, ranks = channels_run
    for r in ranks:
        msg = str(r["refused"])
        assert "built for 8 rows" in msg and "lead_shape=(4,)" in msg, msg


def jax_chan_nbfm(fs_ch):
    """tests/test_sharding.py:83-107's channel-rate NBFM factory."""
    from qradiolink_tpu.core import Block, Sequencer, init_states
    from qradiolink_tpu.ops import firdes
    from qradiolink_tpu.ops.analog import QuadratureDemod
    from qradiolink_tpu.ops.fir import FirFilter

    class ChanNbfm(Block):
        def __init__(self, ls):
            self.filt = FirFilter(firdes.low_pass(1.0, fs_ch, 5000.0,
                                                  2000.0), lead_shape=ls)
            self.quad = QuadratureDemod(1.0, lead_shape=ls)
            self.blocks = [self.filt, self.quad]

        def init_state(self):
            return init_states(self.blocks)

        def __call__(self, state, x):
            seq = Sequencer(state)
            y = seq(self.filt, x)
            y = seq(self.quad, y)
            return seq.states(), {"audio": y}

    return lambda lead_shape=(): ChanNbfm(lead_shape)


def test_multichannel_rx_over_mesh_matches_jax(tmp_path):
    M, fs_ch, Tm = 8, 25_000.0, 5000
    fs = fs_ch * M
    t = np.arange(Tm * M) / fs
    x = (np.exp(2j * np.pi * (1 * fs / M) * t)
         + np.exp(2j * np.pi * (5 * fs / M + 1000.0) * t)).astype(np.complex64)
    blocks = np.split(x, 2)
    groups = [[1, 5], [3, -1]]
    wait = start_ranks("mcrx", {"M": np.asarray(M),
                                "groups": np.asarray(groups),
                                "blocks": np.stack(blocks)}, tmp_path)
    rx = jsh.MultichannelRx(
        M, [(jax_chan_nbfm(fs_ch), [int(c) for c in g if c >= 0])
            for g in groups], mesh=jax_mesh("ch"))
    step, state = rx.jit_step(), rx.init_state()
    want = []
    for blk in blocks:
        state, outs = step(state, jnp.asarray(blk))
        want.append([np.asarray(o["audio"]) for o in outs])

    ranks = wait()
    # [1, 5]: a row a rank; [3]: the first rank's, the second skips it
    assert [list(r["rows0"]) for r in ranks] == [[1], [5]]
    assert [list(r["rows1"]) for r in ranks] == [[3], []]
    assert "audio1_0" not in ranks[1]
    for i in range(len(blocks)):
        for r, g, rows in ((0, 0, [0]), (1, 0, [1]), (0, 1, [0])):
            assert_same(want[i][g][rows], ranks[r][f"audio{g}_{i}"],
                        FIR_TOL, 0.0, peak=True,
                        what=f"block {i} group {g} rank {r}")
    # channel 5 has a +1 kHz offset: a constant demodulated output
    assert np.abs(ranks[1]["audio0_0"][0, 1000:]).mean() > 0.1


def test_chain_gradient_matches_jax():
    """d/df of sum |audio|^2 for NbfmDemod on exp(i f phi): a 1 kHz tone at
    f = 1. The JAX test's loss differentiates by the amplitude of a
    constant input, which an FM demodulator does not see: its exact
    gradient is 0 and either framework's value is rounding noise, so the
    parity is taken by the tone's frequency. The JAX chain's CPU FFT FIRs
    are swapped for their direct form, as the port computes them."""
    from qradiolink_tpu.chains.nbfm import NbfmDemod as JaxNbfm
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod

    phi = (2 * np.pi * 1000.0 * np.arange(25_000) / 1e6).astype(np.float32)
    jd = direct_firs(JaxNbfm())
    js = jd.init_state()

    def loss(f):
        _, out = jd(js, jnp.exp(1j * f * jnp.asarray(phi)))
        return jnp.sum(jnp.abs(out["audio"]) ** 2)

    want = float(jax.jit(jax.grad(loss))(1.0))
    td = NbfmDemod(device="cpu")
    f = torch.tensor(1.0, requires_grad=True)
    _, out = td(td.init_state(), torch.exp(1j * f * torch.from_numpy(phi)))
    got, = torch.autograd.grad(torch.sum(torch.abs(out["audio"]) ** 2), f)
    assert np.isfinite(want) and abs(want) > 1.0
    assert abs(float(got) - want) <= 1e-4 * abs(want), (float(got), want)


def test_chain_gradient_exists_on_a_constant_input():
    """tests/test_sharding.py:120-131 as it is: the graph runs through the
    whole chain and the gradient is finite."""
    from qradiolink_tpu_torch.chains.nbfm import NbfmDemod

    demod = NbfmDemod(device="cpu")
    scale = torch.tensor(1.0, requires_grad=True)
    _, out = demod(demod.init_state(),
                   scale * torch.ones(25_000, dtype=torch.complex64))
    loss = torch.sum(torch.abs(out["audio"]) ** 2)
    assert loss.requires_grad
    g, = torch.autograd.grad(loss, scale)
    assert np.isfinite(float(g))
