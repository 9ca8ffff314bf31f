"""The slice as a whole: the port's MultichannelRx (PFB channelizer, 4FSK and
NBFM groups) against the JAX one on the CPU, with the full state tree
compared after every block.

Tolerances: the channelizer output feeds both groups within 1e-5 of its
peak (tests/test_torch_channelizer.py); each part of the state tree has
its own bound, stated at STATE_TOL; the NBFM outputs are held as in
tests/test_torch_nbfm.py (the symbols' bound is explained at OUT_TOL).
Bits must be equal.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.chains.fsk import Fsk4DemodFF as JaxFsk4  # noqa: E402
from qradiolink_tpu.chains.nbfm import NbfmDemod as JaxNbfm  # noqa: E402
from qradiolink_tpu.parallel.sharding import (  # noqa: E402
    MultichannelRx as JaxMultichannelRx)
from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF  # noqa: E402
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_pfb  # noqa: E402
from qradiolink_tpu_torch.ops.channelizer import (  # noqa: E402
    PfbSynthesizer)
from qradiolink_tpu_torch.parallel.sharding import (  # noqa: E402
    MultichannelRx)
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402
from tests.torch_parity import (  # noqa: E402
    assert_outputs_same, assert_states_same, to_jax, to_torch)

FIX = pathlib.Path(__file__).parent / "fixtures" / "iq_4fsk2k_-6db.npz"
M = 8
FSK, NBFM = list(range(4)), list(range(4, 8))
# (rtol, atol, peak) of each part of the state tree, compared as
# tests/torch_parity.assert_same does:
# - the channelizer's raw history is a copy of the input: exact;
# - the leaves span 1e-8 (NBFM squelch power on the 0.05 RMS noise its
#   channels carry) to 255 (the FSK Viterbi tail's soft values), so each
#   is held relative to its own peak. The FSK group, whose channels carry
#   the capture, within 1e-5. The NBFM group within 1e-5 up to the
#   discriminator (resampler and channel LP tails, squelch power and
#   envelope, the demod's last sample); within 1e-4 after it (audio
#   resampler and LP tails, de-emphasis), where the discriminator turns
#   the channelizer's ~3e-7 spread into up to 7e-5 of the peak on noise,
#   as it does for the FSK symbols (OUT_TOL).
STATE_TOL = {"channelizer": (0, 0, False), "fsk": (1e-5, 0, True),
             "nbfm before the discriminator": (1e-5, 0, True),
             "nbfm after the discriminator": (1e-4, 0, True)}
# blocks of NbfmDemod's state tuple up to the discriminator
NBFM_PRE = 4
# symbols: the channelizer's output differs from the JAX one by up to
# ~3e-7 of its peak (sum order), and the FM discriminator turns that into
# a phase error that grows where the -6 dB capture's amplitude dips, so
# the symbols are held to 1e-4 (1e-5 behind a plain resampler head); the
# constellation is cos/sin(pi/2 * symbols), so the same; rssi is
# 10 log10 of a mean power, where 1e-4 dB is 2.3e-5 of the power (the
# mean's sum order)
OUT_TOL = {"symbols": (0, 1e-4), "constellation": (0, 1e-4),
           "rssi": (0, 1e-4), "audio": (1e-5, 1e-5)}


def _assert_state_tree_same(js, ts):
    (jch, (jfsk, jnb)), (tch, (tfsk, tnb)) = js, ts
    assert len(jnb) == len(tnb) == 7
    for name, a, b in (("channelizer", jch, tch), ("fsk", jfsk, tfsk),
                       ("nbfm before the discriminator", jnb[:NBFM_PRE],
                        tnb[:NBFM_PRE]),
                       ("nbfm after the discriminator", jnb[NBFM_PRE:],
                        tnb[NBFM_PRE:])):
        rtol, atol, peak = STATE_TOL[name]
        assert_states_same(a, b, rtol, atol, peak=peak)


def _wideband(Tm):
    """The frozen 4FSK capture placed by the port's PfbSynthesizer on the
    four FSK channels (a different stretch of it on each), seeded noise at
    0.05 RMS a plane (bench.py's level) on the NBFM channels: (re, im)
    planes of M*Tm wideband samples."""
    data = np.load(FIX)
    cap = (data["iq_re"].astype(np.float32)
           + 1j * data["iq_im"].astype(np.float32))
    s = np.zeros((M, Tm), np.complex64)
    for k in FSK:
        s[k] = cap[k * 200_000:k * 200_000 + Tm]
    noise = np.random.default_rng(1).standard_normal((2, len(NBFM), Tm))
    s[NBFM] = 0.05 * (noise[0] + 1j * noise[1])
    syn = PfbSynthesizer(M, device="cpu")
    _, y = syn(syn.init_state(), IqPair(torch.from_numpy(s.real.copy()),
                                        torch.from_numpy(s.imag.copy())))
    return y.re.numpy(), y.im.numpy()


def test_mixed_rx_streamed():
    """MultichannelRx(8), 4 FSK + 4 NBFM channels (bench.py's mixed config,
    cut to 8 channels), two blocks of 4,000 samples a channel. Bits
    equal, every output and state leaf within the tolerances above."""
    T = M * 4000
    re, im = _wideband(2 * 4000)
    blocks = [(re[:T], im[:T]), (re[T:], im[T:])]
    jrx = JaxMultichannelRx(M, [(JaxFsk4, FSK), (JaxNbfm, NBFM)])
    trx = MultichannelRx(M, [(Fsk4DemodFF, FSK), (NbfmDemod, NBFM)],
                         device="cpu")
    kernel_paths.reset()
    js, ts = jrx.init_state(), trx.init_state()
    _assert_state_tree_same(js, ts)
    for i, blk in enumerate(blocks):
        js, jouts = jrx(js, to_jax(blk))
        ts, touts = trx(ts, to_torch(blk))
        assert_outputs_same(jouts, touts, key_tol=OUT_TOL, what=f"block {i}")
        _assert_state_tree_same(js, ts)
    assert np.asarray(jouts[0]["bits"]).shape == (4, 8)
    assert np.asarray(jouts[1]["audio"]).shape == (4, 32)
    report = kernel_paths.report()
    # the channelizer's kernel is the one cuda_pfb.route(M, kp) picks
    for op in (cuda_pfb.route(M, trx.channelizer.kp), "resample_dec_f32",
               "resample_poly_f32", "viterbi_bfly_k7"):
        assert report[op]["plain"] >= 2, op
