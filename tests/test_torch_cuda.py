"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
neither jax nor the JAX package, so it also runs where those are not
installed; run it on a machine with a card with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(--noconftest: tests/conftest.py imports jax). Tolerances: the FIRs (the
strided FIR and the per-row depthwise FIR) within 1e-5 (relative to the
output's peak, and elementwise 1e-5 + 1e-5 |plain|), the bound the JAX
package holds its FIR kernels to; the fused channelizer within 1e-5 of its
output's peak, the JAX package's bound for it, with its carried state
bit-equal; the Viterbi, the AGC stage and its gain recurrence bit-exact
(the AGC's |x| equal to torch.abs's bits); the
rational resampler's two kernels bit-equal to each other; the analog
chains on the card within 1e-5 of each output's and state leaf's peak of
the same chain on the CPU (their FIRs' bound), rssi within 1e-4 dB; the
PSK chains' loop kernels (the Costas loop, the M&M symbol sync, the
streaming Viterbi) bit-equal to their plain loops over two chained blocks,
every output and state leaf; the FLL kernel within the FLL's bound of its
plain loop (it sums each sub-block's band-edge energy in its own order),
elementwise 2e-5 + 1e-5 |plain|, the phase as a distance on the circle;
the M17 and DMR chains on the card against their CPU path: bits equal,
symbols, soft and every state leaf within 2e-5 of their peak. Slice 6: the
FFT form (torch.fft, cuFFT) against its CPU form within 1e-5 of the peak
and against the direct kernels within 1e-3 (tests/test_fir.py's bound);
the MMDVMmulti channelizer (pfb_fft_f32 at M 10, kp 56) and synthesizer
(depthwise_run_f32 at kp 53) against their plain versions and the kernels
that served them before (pfb_channelize_f32 within the same bound,
depthwise_fir_f32 bit for bit); every FIR and
resampler block of the new modes on the card against the same block on the
CPU (the kernel against its plain version at the block's shape: outputs
within the FIR's bound, the new state equal); each new mode's chains on
the card against the CPU on 2 rows (the demodulators' bits equal, symbols
within 1e-3 of their peak and state leaves within 2e-5; the float outputs
of FreeDV and MMDVM within 1e-5; the modulators' IQ within 2e-4 of its
peak, FrequencyMod's phase a cumulative sum in another order on each).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# a few intra-op threads only: the suite runs in several workers at once
torch.set_num_threads(2)

from qradiolink_tpu_torch.chains.am import AmDemod  # noqa: E402
from qradiolink_tpu_torch.chains.dmr import (  # noqa: E402
    DmrDemod, DmrDemodFF, DmrMod)
from qradiolink_tpu_torch.chains.m17 import (  # noqa: E402
    M17Demod, M17DemodFF, M17Mod)
from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF  # noqa: E402
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod  # noqa: E402
from qradiolink_tpu_torch.chains.ssb import SsbDemod  # noqa: E402
from qradiolink_tpu_torch.chains.wbfm import WbfmDemod  # noqa: E402
from qradiolink_tpu_torch.core import IqPair, _flatten  # noqa: E402
from qradiolink_tpu_torch.chains.psk import (  # noqa: E402
    BpskDemod, QpskDemod, QpskMod)
from qradiolink_tpu_torch.fec.conv import (  # noqa: E402
    CCSDS_K7, ConvCode, conv_encode)
from qradiolink_tpu_torch.fec import viterbi_stream_cuda  # noqa: E402
from qradiolink_tpu_torch.fec.viterbi_cuda import (  # noqa: E402
    decode_stream, decode_stream_plain, decode_stream_tiled, decode_windows,
    decode_windows_plain)
from qradiolink_tpu_torch.ops import cuda_agc  # noqa: E402
from qradiolink_tpu_torch.ops.channelizer import (  # noqa: E402
    PfbChannelizer, PfbSynthesizer)
from qradiolink_tpu_torch.ops import cuda_depthwise  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_depthwise import (  # noqa: E402
    depthwise_fir, depthwise_fir_plain)
from qradiolink_tpu_torch.ops import cuda_fir  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_fir import (  # noqa: E402
    fir_stream, fir_stream_plain, route)
from qradiolink_tpu_torch.ops import cuda_pfb  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_pfb import channelize_plain  # noqa: E402
from qradiolink_tpu_torch.ops import cuda_resample  # noqa: E402
from qradiolink_tpu_torch.ops.cuda_resample import (  # noqa: E402
    phase_offsets, resample_poly, resample_poly_plain)
from qradiolink_tpu_torch.ops.fir import FirFilter  # noqa: E402
from qradiolink_tpu_torch.ops.resample import RationalResampler  # noqa: E402
from qradiolink_tpu_torch.sync import cuda_costas  # noqa: E402
from qradiolink_tpu_torch.sync import cuda_fll  # noqa: E402
from qradiolink_tpu_torch.utils import kernels  # noqa: E402
from qradiolink_tpu_torch.sync import cuda_symbol_sync  # noqa: E402
from qradiolink_tpu_torch.utils.profiling import kernel_paths  # noqa: E402

pytestmark = pytest.mark.cuda
FIX = pathlib.Path(__file__).parent / "fixtures" / "iq_4fsk2k_-6db.npz"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("stage", ["head", "chan_lp", "rrc", "phase2"])
def test_fir_kernel_matches_plain(cuda, gen, stage):
    chain = Fsk4DemodFF(lead_shape=(8,), device=cuda)
    C = 8
    if stage == "head":
        tf, D, T, shift, tail = chain.resamp.phase_taps[0], 50, 20_000, 0, 1
    elif stage == "chan_lp":
        tf, D, T, shift, tail = chain.chan_filter.taps_flipped, 1, 4000, 0, 1
    elif stage == "rrc":
        tf, D, T, shift, tail = chain.shaping.taps_flipped, 1, 4250, 0, 0
    else:  # a later phase of an L=2 resampler: shift > 0
        tf, D, T, shift, tail = chain.resamp.phase_taps[0][:210], 25, 5000, \
            12, 1
    K = tf.shape[0]
    planes = 1 if stage == "rrc" else 2
    xs = [torch.randn((C, T), generator=gen, device=cuda)
          for _ in range(planes)]
    st = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
    tails = (st[:, 0, :], st[:, 1, :])[:planes] if tail else None
    n_out = (T // D) if tail else (T - K) // D + 1
    kernel_paths.reset()
    got = fir_stream(xs, tf, D, n_out, tails=tails, shift=shift)
    assert kernel_paths.launches(route(K, D)) == 1
    ref = fir_stream_plain(xs, tf, D, n_out, tails=tails, shift=shift)
    _assert_fir_close(got, ref)


# fir_decim_f32's shapes, as in tests/test_torch_fir.py's CPU model test:
# name: (C, T, K, D, shift, planes, tail)
DECIM_CASES = {
    "head": (4, 20_000, 419, 50, 0, 2, True),
    "k_multiple_of_d": (4, 10_000, 400, 50, 0, 2, True),
    "k_below_d": (4, 10_000, 40, 50, 0, 2, True),
    "shift": (4, 10_000, 419, 50, 12, 2, True),
    "ragged_chunk": (3, 13_150, 419, 50, 0, 2, True),
    "one_row_one_plane": (1, 5000, 419, 50, 0, 1, True),
    "no_tail": (4, 10_000, 419, 50, 0, 1, False),
    "d64_a16": (2, 64 * 300, 1024, 64, 0, 2, True),
    "d32": (2, 32 * 300, 100, 32, 5, 2, True),
}


@pytest.mark.parametrize("name", sorted(DECIM_CASES))
def test_fir_decim_kernel_matches_plain(cuda, gen, name):
    C, T, K, D, shift, planes, tail = DECIM_CASES[name]
    if K == 419:
        tf = Fsk4DemodFF(device=cuda).resamp.phase_taps[0]
    else:
        tf = torch.randn((K,), generator=gen, device=cuda) / K ** 0.5
    xs = [torch.randn((C, T), generator=gen, device=cuda)
          for _ in range(planes)]
    st = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
    tails = (st[:, 0, :], st[:, 1, :])[:planes] if tail else None
    n_out = (T // D) if tail else (T - shift - K) // D + 1
    kernel_paths.reset()
    got = fir_stream(xs, tf, D, n_out, tails=tails, shift=shift)
    assert kernel_paths.launches("fir_decim_f32") == 1
    assert kernel_paths.launches("fir_stream_f32") == 0
    _assert_fir_close(got, fir_stream_plain(xs, tf, D, n_out, tails=tails,
                                            shift=shift))


def test_fir_decim_head_two_chained_blocks(cuda, gen):
    """The 4FSK resampler head as the chain runs it: two blocks, the tails
    strided views of the (C, 2, K-1) state, the second block reading the
    tail the first one left."""
    rs = Fsk4DemodFF(lead_shape=(64,), device=cuda).resamp
    C, T, k1 = 64, 200_000, rs.kp - 1
    state = torch.randn((C, 2, k1), generator=gen, device=cuda)
    for _ in range(2):
        x = IqPair(torch.randn((C, T), generator=gen, device=cuda),
                   torch.randn((C, T), generator=gen, device=cuda))
        kernel_paths.reset()
        new_state, y = rs(state, x)
        assert kernel_paths.report()["fir_decim_f32"]["shapes"] == {
            f"cuda K{rs.kp} D{rs.M} tail 2x{C}": 1}
        ref = fir_stream_plain((x.re, x.im), rs.phase_taps[0], rs.M,
                               T // rs.M, tails=(state[:, 0], state[:, 1]))
        _assert_fir_close((y.re, y.im), ref)
        state = new_state


# fir_long_f32's shapes, which tests/test_torch_fir.py's CPU model test
# shares: name: (C, T, K, D, shift, planes, tail). The NBFM head's taps at
# K 2239 (A 45: 3 segments of 15 phase rows) and the SSB head's at K 5597
# (D 125, A 45: 2 column groups x 3 segments), seeded random taps
# elsewhere.
LONG_CASES = {
    "nbfm_head": (2, 20_000, 2239, 50, 0, 2, True),
    "ragged_chunk": (1, 13_600, 2239, 50, 0, 2, True),  # n_out = MW + 1
    "shift": (2, 10_000, 2239, 50, 12, 2, True),
    "no_tail": (2, 20_000, 2239, 50, 0, 1, False),
    "one_row_one_plane": (1, 10_000, 2239, 50, 0, 1, True),
    "k_multiple_of_d": (2, 10_000, 2000, 50, 0, 2, True),  # A 40, 14 x 3
    "a17": (2, 10_000, 801, 50, 0, 2, True),  # 2 segments of 9 rows
    "d32": (2, 32 * 300, 645, 32, 5, 2, True),  # A 21
    "d64_a64": (1, 64 * 300, 4096, 64, 0, 2, True),  # 4 segments of 16
    "ssb_head": (2, 125 * 300, 5597, 125, 0, 2, True),  # 271 + 29 outputs
    "ssb_head_no_tail": (3, 125 * 330, 5597, 125, 7, 1, False),
    "d65_two_groups": (2, 65 * 300, 1250, 65, 3, 2, True),  # group 1: 1 col
    "d128_a64": (1, 128 * 300, 8192, 128, 0, 2, True),  # 2 groups x 4 segs
    "d256_a32": (1, 256 * 290, 8192, 256, 0, 1, True),  # 4 groups x 2 segs
}


def long_taps(name, K, rng):
    """A case's flipped taps, (K,) f32 numpy: the NBFM resampler head's
    (RationalResampler(1, 50)) at K 2239, the SSB head's
    (RationalResampler(1, 125)) at K 5597, seeded random taps elsewhere."""
    if K == 2239:
        return NbfmDemod(device="cpu").resamp.phase_taps[0].numpy()
    if K == 5597:
        return SsbDemod(device="cpu").resamp.phase_taps[0].numpy()
    return (rng.standard_normal(K) / np.sqrt(K)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(LONG_CASES))
def test_fir_long_kernel_matches_plain(cuda, gen, name):
    """fir_long_f32 (cuda_fir.fir_long: the FIR kernels' route at every
    case, though route() gives the K2239 D50 head's streaming calls to
    resample_dec_f32) within 1e-5 of the plain version; fir_stream_f32 does
    not launch. The tails are strided views of a (C, 2, K-1) state."""
    C, T, K, D, shift, planes, tail = LONG_CASES[name]
    tf = torch.from_numpy(long_taps(name, K, np.random.default_rng(0))).to(
        cuda)
    xs = [torch.randn((C, T), generator=gen, device=cuda)
          for _ in range(planes)]
    st = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
    tails = (st[:, 0, :], st[:, 1, :])[:planes] if tail else None
    n_out = (T // D) if tail else (T - shift - K) // D + 1
    assert cuda_fir.fir_route(K, D) == "fir_long_f32"
    kernel_paths.reset()
    got = cuda_fir.fir_long(xs, tf, D, n_out, tails=tails, shift=shift)
    assert kernel_paths.launches("fir_long_f32") == 1
    assert kernel_paths.launches("fir_stream_f32") == 0
    _assert_fir_close(got, fir_stream_plain(xs, tf, D, n_out, tails=tails,
                                            shift=shift))


def test_fir_long_nbfm_head_two_chained_blocks(cuda, gen):
    """The NBFM resampler head as the chain runs it: two blocks, the tails
    strided views of the (C, 2, 2238) state, the second block reading the
    tail the first one left; one launch of the routed kernel a block
    (resample_dec_f32 at L 1, which took the shape from fir_long_f32)."""
    rs = NbfmDemod(lead_shape=(32,), device=cuda).resamp
    C, T, k1 = 32, 100_000, rs.kp - 1
    assert k1 == 2238
    state = torch.randn((C, 2, k1), generator=gen, device=cuda)
    for _ in range(2):
        x = IqPair(torch.randn((C, T), generator=gen, device=cuda),
                   torch.randn((C, T), generator=gen, device=cuda))
        kernel_paths.reset()
        new_state, y = rs(state, x)
        assert kernel_paths.report()[route(rs.kp, rs.M)]["shapes"] == {
            f"cuda K{rs.kp} D{rs.M} tail 2x{C}": 1}
        assert kernel_paths.launches("fir_stream_f32") == 0
        ref = fir_stream_plain((x.re, x.im), rs.phase_taps[0], rs.M,
                               T // rs.M, tails=(state[:, 0], state[:, 1]))
        _assert_fir_close((y.re, y.im), ref)
        state = new_state


def test_fir_long_ssb_head_two_chained_blocks(cuda, gen):
    """The SSB resampler head (K 5597, D 125: two column groups) as the
    chain runs it: two blocks of IqPair input, the tails strided views of
    the (C, 2, 5596) state; one launch of the routed kernel a block
    (resample_dec_f32 at L 1, which took the shape from fir_long_f32)."""
    rs = SsbDemod(lead_shape=(16,), device=cuda).resamp
    C, T, k1 = 16, 200_000, rs.kp - 1
    assert (k1, rs.M) == (5596, 125)
    state = torch.randn((C, 2, k1), generator=gen, device=cuda)
    for _ in range(2):
        x = IqPair(torch.randn((C, T), generator=gen, device=cuda),
                   torch.randn((C, T), generator=gen, device=cuda))
        kernel_paths.reset()
        new_state, y = rs(state, x)
        assert kernel_paths.report()[route(rs.kp, rs.M)]["shapes"] == {
            f"cuda K{rs.kp} D{rs.M} tail 2x{C}": 1}
        assert kernel_paths.launches("fir_stream_f32") == 0
        assert kernel_paths.launches("fir_long_f32") == 0
        ref = fir_stream_plain((x.re, x.im), rs.phase_taps[0], rs.M,
                               T // rs.M, tails=(state[:, 0], state[:, 1]))
        _assert_fir_close((y.re, y.im), ref)
        assert torch.equal(new_state[:, 0], x.re[:, -k1:])
        state = new_state


# fir_cols_f32's shapes, which tests/test_torch_fir.py's CPU model test
# shares: name: (C, T, K, D, shift, planes, tail). The WBFM head's taps at
# K 225 (D 5, A 45: one slab of 5 columns) and the WBFM audio resampler's
# at K 1121 (D 25, A 45: slabs of 13 and 12), seeded random taps
# elsewhere. Every case but one_row_one_plane has two tiles, the last
# ragged.
COLS_CASES = {
    "wbfm_head": (2, 5 * 1100, 225, 5, 0, 2, True),
    "shift": (2, 5 * 1100, 225, 5, 3, 2, True),
    "wbfm_audio": (2, 25 * 1100, 1121, 25, 0, 1, True),
    "wbfm_audio_no_tail": (2, 25 * 1100 + 1120, 1121, 25, 0, 1, False),
    "one_row_one_plane": (1, 5 * 600, 225, 5, 0, 1, True),
    "k113_d5": (2, 5 * 1030, 113, 5, 0, 2, True),  # A 23: 2 groups + 7
    "a_multiple_of_r": (2, 5 * 1030, 240, 5, 0, 2, True),  # A 48
    "d2_a17": (2, 2 * 1500, 34, 2, 0, 2, True),
    "d9_one_slab": (2, 9 * 1030, 355, 9, 0, 2, True),  # A 40
    "d31_a64": (1, 31 * 1100, 1984, 31, 0, 2, True),  # 11, 10, 10
}


def cols_taps(name, K, rng):
    """A case's flipped taps, (K,) f32 numpy: the WBFM head's
    (RationalResampler(1, 5)) at K 225 and its audio resampler's
    (RationalResampler(1, 25)) at K 1121, seeded random taps elsewhere."""
    if K == 225:
        return WbfmDemod(device="cpu").resamp.phase_taps[0].numpy()
    if K == 1121:
        return WbfmDemod(device="cpu").audio_resamp.phase_taps[0].numpy()
    return (rng.standard_normal(K) / np.sqrt(K)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(COLS_CASES))
def test_fir_cols_kernel_matches_plain(cuda, gen, name):
    """fir_cols_f32, which route() picks at every case, within 1e-5 of the
    plain version; fir_stream_f32 does not launch. The tails are strided
    views of a (C, 2, K-1) state."""
    C, T, K, D, shift, planes, tail = COLS_CASES[name]
    tf = torch.from_numpy(cols_taps(name, K, np.random.default_rng(0))).to(
        cuda)
    xs = [torch.randn((C, T), generator=gen, device=cuda)
          for _ in range(planes)]
    st = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
    tails = (st[:, 0, :], st[:, 1, :])[:planes] if tail else None
    n_out = (T // D) if tail else (T - shift - K) // D + 1
    kernel_paths.reset()
    got = fir_stream(xs, tf, D, n_out, tails=tails, shift=shift)
    assert kernel_paths.launches("fir_cols_f32") == 1
    assert kernel_paths.launches("fir_stream_f32") == 0
    _assert_fir_close(got, fir_stream_plain(xs, tf, D, n_out, tails=tails,
                                            shift=shift))


def test_fir_cols_wbfm_audio_resampler_real_two_chained_blocks(cuda, gen):
    """The WBFM audio resampler (K 1121, D 25) as the chain runs it: real
    input, the tail read in place from the (C, 2, 1120) state (no
    concatenation), two chained blocks; the new state's re plane is the
    last 1,120 inputs and its im plane zero."""
    rs = WbfmDemod(lead_shape=(16,), device=cuda).audio_resamp
    C, T, k1 = 16, 40_000, rs.kp - 1
    assert (k1, rs.M) == (1120, 25)
    state = torch.zeros((C, 2, k1), device=cuda)
    state[:, 0] = torch.randn((C, k1), generator=gen, device=cuda)
    for _ in range(2):
        x = torch.randn((C, T), generator=gen, device=cuda)
        kernel_paths.reset()
        new_state, y = rs(state, x)
        assert kernel_paths.report()["fir_cols_f32"]["shapes"] == {
            f"cuda K{rs.kp} D{rs.M} tail 1x{C}": 1}
        assert kernel_paths.launches("fir_stream_f32") == 0
        ref = fir_stream_plain((x,), rs.phase_taps[0], rs.M, T // rs.M,
                               tails=(state[:, 0],))
        _assert_fir_close((y,), ref)
        assert torch.equal(new_state[:, 0], x[:, -k1:])
        assert not bool(new_state[:, 1].any())
        state = new_state


# fir_s1_f32's shapes, which tests/test_torch_fir.py's CPU model test
# shares (this file imports no JAX, so the cases live here):
# name: (C, T, K, shift, planes, tail)
S1_CASES = {
    "chan_lp": (4, 4000, 55, 0, 2, True),
    "rrc": (3, 4250, 251, 0, 1, False),
    "rrc_tail": (3, 4000, 251, 0, 1, True),
    "nbfm_chan_lp": (2, 2000, 133, 0, 2, True),
    "audio_lp": (2, 800, 55, 0, 1, True),
    "k_multiple_of_r": (2, 3000, 64, 0, 2, True),
    "k_not_multiple_of_r": (2, 3000, 100, 0, 2, True),
    "k_below_r": (2, 3000, 5, 0, 2, True),
    "shift": (2, 3000, 55, 7, 2, True),
    "shift_no_tail": (2, 3000, 55, 7, 1, False),
    "one_row_one_plane": (1, 1500, 55, 0, 1, True),
    "ragged_tile": (2, 1025, 55, 0, 2, True),  # n_out = one tile + 1
    "k_at_limit": (2, 1500, 2048, 0, 1, True),
    # the M17 and DMR paths' filters at 24 ksps, 4,800 samples a step
    "m17_chan_lp": (3, 4800, 11, 0, 2, True),
    "m17_rrc": (3, 4800, 251, 0, 1, True),
    "dmr_rrc": (3, 4800, 125, 0, 1, True),
}


def s1_taps(name, K, rng):
    """A case's flipped taps, (K,) f32 numpy: the chains' filters at the
    four path shapes, seeded random taps elsewhere."""
    if name.startswith("chan_lp") or name == "shift":
        tf = Fsk4DemodFF(device="cpu").chan_filter.taps_flipped
    elif name.startswith("rrc"):
        tf = Fsk4DemodFF(device="cpu").shaping.taps_flipped
    elif name == "nbfm_chan_lp":
        tf = NbfmDemod(device="cpu").chan_filter.taps_flipped
    elif name == "audio_lp":
        tf = NbfmDemod(device="cpu").audio_filter.taps_flipped
    elif name.startswith(("m17_", "dmr_")):
        rx = (M17Demod if name.startswith("m17") else DmrDemod)(device="cpu")
        tf = (rx.chan_filter if name.endswith("chan_lp")
              else rx.shaping).taps_flipped
    else:
        return (rng.standard_normal(K) / np.sqrt(K)).astype(np.float32)
    return tf.numpy()


@pytest.mark.parametrize("name", sorted(S1_CASES))
def test_fir_s1_kernel_matches_plain(cuda, gen, name):
    """fir_s1_f32, which route() picks at every case, within 1e-5 of the
    plain version, and bit-equal to fir_stream_f32, whose sum order it
    keeps."""
    C, T, K, shift, planes, tail = S1_CASES[name]
    tf = torch.from_numpy(s1_taps(name, K, np.random.default_rng(0))).to(
        cuda)
    assert tf.shape == (K,)
    xs = [torch.randn((C, T), generator=gen, device=cuda)
          for _ in range(planes)]
    st = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
    tails = (st[:, 0, :], st[:, 1, :])[:planes] if tail else None
    n_out = T - shift if tail else T - shift - K + 1
    kernel_paths.reset()
    got = fir_stream(xs, tf, 1, n_out, tails=tails, shift=shift)
    assert kernel_paths.launches("fir_s1_f32") == 1
    assert kernel_paths.launches("fir_stream_f32") == 0
    _assert_fir_close(got, fir_stream_plain(xs, tf, 1, n_out, tails=tails,
                                            shift=shift))
    old = cuda_fir._launch_stream(xs, tf, 1, n_out, tails, shift)
    for g, o in zip(got, old):
        assert torch.equal(g, o)


def test_fir_s1_rrc_two_chained_blocks(cuda, gen):
    """The RRC FirFilter as the 4FSK chain runs it: real input, the tail
    read in place from the (C, 2, 250) state, two chained blocks."""
    rrc = Fsk4DemodFF(lead_shape=(64,), device=cuda).shaping
    C, T, k1 = 64, 4000, rrc.ntaps - 1
    state = torch.randn((C, 2, k1), generator=gen, device=cuda)
    for _ in range(2):
        x = torch.randn((C, T), generator=gen, device=cuda)
        kernel_paths.reset()
        new_state, y = rrc(state, x)
        assert kernel_paths.report()["fir_s1_f32"]["shapes"] == {
            f"cuda K{rrc.ntaps} D1 tail 1x{C}": 1}
        ref = fir_stream_plain((x,), rrc.taps_flipped, 1, T,
                               tails=(state[:, 0],))
        _assert_fir_close((y,), ref)
        assert torch.equal(new_state[:, 0], x[:, -k1:])
        assert not bool(new_state[:, 1].any())
        state = new_state


def _assert_fir_close(got, ref):
    for g, r in zip(got, ref):
        diff = (g - r).abs()
        assert float(diff.max() / r.abs().max()) <= 1e-5
        assert bool((diff <= 1e-5 + 1e-5 * r.abs()).all())


# fir_stream_f32 (csrc/fir.cu) against its first design fir_stream_v0_f32
# (csrc/fir_stream_v0.cu), whose sum order it keeps: a grid of taps and
# strides; at each, three layouts (tail, planes, shift, rows, outputs a
# row), the outputs ragged against every tile and chunk
STREAM_K = (1, 17, 837, 1045, 2239)
STREAM_D = (1, 2, 31, 100, 125, 200)
STREAM_LAYOUTS = ((True, 2, 0, 3, 517), (True, 1, 3, 2, 300),
                  (False, 2, 2, 3, 261))


@pytest.mark.parametrize("D", STREAM_D)
@pytest.mark.parametrize("K", STREAM_K)
def test_fir_stream_kernel_matches_v0_and_plain(cuda, gen, K, D):
    """fir_stream_f32 bit-equal to fir_stream_v0_f32 and within the FIR's
    1e-5 of the plain version, with the tails read in place as strided
    views of the (C, 2, K-1) state (as _cuda_args takes them) or no tail,
    1 and 2 planes, shift 0 and above."""
    for tail, planes, shift, C, n_out in STREAM_LAYOUTS:
        T = (n_out - 1) * D + shift + K - (K - 1 if tail else 0) + 5
        tf = torch.randn((K,), generator=gen, device=cuda) / K ** 0.5
        xs = [torch.randn((C, T), generator=gen, device=cuda)
              for _ in range(planes)]
        st = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
        tails = (st[:, 0, :], st[:, 1, :])[:planes] if tail else None
        kernel_paths.reset()
        got = cuda_fir._launch_stream(xs, tf, D, n_out, tails, shift)
        old = cuda_fir.fir_stream_v0(xs, tf, D, n_out, tails, shift)
        assert kernel_paths.launches(cuda_fir.OP) == 1
        assert kernel_paths.launches(cuda_fir.V0_OP) == 1
        for g, o in zip(got, old):
            assert torch.equal(g, o)
        _assert_fir_close(got, fir_stream_plain(xs, tf, D, n_out,
                                                tails=tails, shift=shift))


def test_fir_stream_path_shapes_match_v0(cuda, gen):
    """The three shapes the route gives fir_stream_f32 on a path (FreeDV's
    head K1045 D125, 4FSK1KFM's K837 D100, 4FSK100K's K17 D2), with the
    chains' taps, 8 rows x 2 planes, tails in place: bit-equal to
    fir_stream_v0_f32 over two chained blocks."""
    from qradiolink_tpu_torch.chains.freedv import FreeDvDemod
    from qradiolink_tpu_torch.chains.fsk import Fsk4Demod

    for rs, T in ((FreeDvDemod(device=cuda).resamp, 40_000),
                  (Fsk4Demod(variant="1KFM", device=cuda).resamp, 40_000),
                  (Fsk4Demod(variant="96K", device=cuda).resamp, 20_000)):
        tf, D = rs.phase_taps[0], rs.M
        K = tf.shape[0]
        assert route(K, D) == cuda_fir.OP
        st = torch.randn((8, 2, K - 1), generator=gen, device=cuda)
        for _ in range(2):
            xs = [torch.randn((8, T), generator=gen, device=cuda)
                  for _ in range(2)]
            tails = (st[:, 0, :], st[:, 1, :])
            got = fir_stream(xs, tf, D, T // D, tails=tails)
            old = cuda_fir.fir_stream_v0(xs, tf, D, T // D, tails)
            for g, o in zip(got, old):
                assert torch.equal(g, o)
            _assert_fir_close(got, fir_stream_plain(xs, tf, D, T // D,
                                                    tails=tails))
            st = torch.stack([x[:, -(K - 1):] for x in xs], 1).contiguous()


def test_fir_stream_gate_raises_and_never_launches(cuda, gen):
    """Where a block's shared memory cannot hold the design (the taps by
    period position grow with D), the wrapper raises before any launch;
    one stride below, it launches and matches the plain version."""
    lib = cuda_fir._lib("fir", cuda_fir.OP, "fir_error_string")
    K = 3
    lo, hi = 1, 1 << 20  # the first D whose block does not fit
    while lo < hi:
        mid = (lo + hi) // 2
        if lib.fir_stream_smem_bytes(K, mid) > kernels.SMEM_MAX:
            hi = mid
        else:
            lo = mid + 1
    tf = torch.randn((K,), generator=gen, device=cuda)
    for D in (lo, lo - 4):
        xs = [torch.randn((2, 3 * D + K), generator=gen, device=cuda)]
        kernel_paths.reset()
        if D == lo:
            with pytest.raises(ValueError, match="shared memory"):
                cuda_fir._launch_stream(xs, tf, D, 3)
            with pytest.raises(ValueError, match="shared memory"):
                fir_stream(xs, tf, D, 3)
            assert kernel_paths.launches(cuda_fir.OP) == 0
        else:
            got = cuda_fir._launch_stream(xs, tf, D, 3)
            assert kernel_paths.launches(cuda_fir.OP) == 1
            _assert_fir_close(got, fir_stream_plain(xs, tf, D, 3))


def test_fir_stream_rows_past_the_grid(cuda, gen):
    """fir_stream_f32 takes more rows than a grid's y dimension (65,535),
    where fir_stream_v0_f32 raises."""
    C, T, K, D = 70_000, 40, 17, 2
    tf = torch.randn((K,), generator=gen, device=cuda)
    xs = [torch.randn((C, T), generator=gen, device=cuda)]
    got = cuda_fir._launch_stream(xs, tf, D, (T - K) // D + 1)
    _assert_fir_close(got, fir_stream_plain(xs, tf, D, (T - K) // D + 1))
    with pytest.raises(ValueError, match="rows exceed"):
        cuda_fir.fir_stream_v0(xs, tf, D, (T - K) // D + 1)


@pytest.mark.parametrize("C,kp,lead,planes,n_out", [
    (64, 24, (), 2, 5000),     # channelizer branches (kp rounded to 8)
    (64, 23, (), 2, 5000),     # synthesizer branches (kp 23)
    (7, 13, (3,), 1, 777),     # leading axes, one plane, ragged last tile
    (5, 1, (), 2, 100),        # a single tap
])
def test_depthwise_kernel_matches_plain(cuda, gen, C, kp, lead, planes,
                                        n_out):
    taps = torch.randn((C, kp), generator=gen, device=cuda)
    xs = [torch.randn(lead + (C, n_out + kp - 1 + 3), generator=gen,
                      device=cuda) for _ in range(planes)]
    kernel_paths.reset()
    got = depthwise_fir(xs, taps, n_out)
    assert kernel_paths.launches(cuda_depthwise.route(kp)) == 1
    _assert_fir_close(got, depthwise_fir_plain(xs, taps, n_out))


def _depthwise_old(xs, taps, n_out, tails):
    """depthwise_fir_f32 on the explicit [tail | x] concatenation."""
    if tails is not None:
        xs = [torch.cat([t, x], -1) for t, x in zip(tails, xs)]
    return cuda_depthwise._launch_fir(xs, taps, n_out, "")


# depthwise_run_f32's shapes: name: (C, kp, lead, planes, n_out, form,
# extra input samples)
RUN_CASES = {
    "synth": (64, 23, (), 2, 100_000, "tail", 0),
    "channelizer": (64, 24, (), 2, 100_000, "valid", 0),
    "synth_ragged": (64, 23, (), 2, 5000 + 3, "tail", 0),
    "valid_misaligned": (64, 24, (), 2, 5000, "valid", 3),
    "lead_one_plane": (7, 23, (3,), 1, 777, "tail", 0),
    "short_rows": (5, 24, (2,), 2, 9, "valid", 1),
    # MMDVMmulti's synthesizer (kp 53): one site, the headless block, a
    # farm of 64 sites; the VALID form on misaligned rows
    "mmdvm_synth": (10, 53, (), 2, 25_000, "tail", 0),
    "mmdvm_headless": (10, 53, (), 2, 3_000, "tail", 0),
    "mmdvm_farm": (10, 53, (64,), 2, 25_000, "tail", 0),
    "kp53_valid_misaligned": (10, 53, (), 2, 5000 + 1, "valid", 3),
}


@pytest.mark.parametrize("name", sorted(RUN_CASES))
def test_depthwise_run_matches_plain(cuda, gen, name):
    """depthwise_run_f32, which route(kp) picks, within 1e-5 of the plain
    version and equal bit for bit to depthwise_fir_f32 on the
    concatenation: the tail form with strided tails of a (..., 2, C, kp-1)
    state, the VALID form on rows whose body is not 16-byte aligned, rows
    shorter than a tile, leading axes."""
    C, kp, lead, planes, n_out, form, extra = RUN_CASES[name]
    assert cuda_depthwise.route(kp) == cuda_depthwise.RUN_OP
    taps = torch.randn((C, kp), generator=gen, device=cuda) / kp ** 0.5
    tails = None
    if form == "tail":
        st = torch.randn(lead + (2, C, kp - 1), generator=gen, device=cuda)
        tails = (st[..., 0, :, :], st[..., 1, :, :])[:planes]
        n_in = n_out + extra
    else:
        n_in = n_out + kp - 1 + extra
    xs = [torch.randn(lead + (C, n_in), generator=gen, device=cuda)
          for _ in range(planes)]
    kernel_paths.reset()
    got = depthwise_fir(xs, taps, n_out, tails=tails)
    assert kernel_paths.launches(cuda_depthwise.RUN_OP) == 1
    assert kernel_paths.launches(cuda_depthwise.OP) == 0
    _assert_fir_close(got, depthwise_fir_plain(xs, taps, n_out, tails))
    for g, o in zip(got, _depthwise_old(xs, taps, n_out, tails)):
        assert torch.equal(g, o)


@pytest.mark.parametrize("n_out,runs", [(3_000, 6), (25_000, None),
                                        (100_000, None)])
def test_depthwise_run_spreads_short_rows(cuda, n_out, runs):
    """depthwise_run_f32's run count at 10 rows x 2 planes, kp 53: the
    blocks the card holds over the 20 row-planes, at most one a 512
    outputs, so that the headless block (3,000 outputs) runs as 6 runs a
    row-plane, 120 blocks, and a long row as many as the card holds."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    got = cuda_depthwise.run_count(10, 53, n_out, 2, cuda)
    cap = -(-n_out // 512)
    if runs is not None:
        assert got == runs
    assert 1 <= got <= cap and 20 * got >= min(sms, 20 * cap)


def test_synthesizer_branches_equal_the_old_route(cuda, gen):
    """PfbSynthesizer._branches at M 64 (kp 23) over two chained blocks:
    outputs and state equal bit for bit to the concatenation route on
    depthwise_fir_f32, which served it before."""
    syn = PfbSynthesizer(64, device=cuda)
    state = torch.randn((2, 64, 22), generator=gen, device=cuda)
    for _ in range(2):
        w = [torch.randn((64, 20_000), generator=gen, device=cuda)
             for _ in range(2)]
        kernel_paths.reset()
        new_state, vr, vi = syn._branches(state, *w)
        assert kernel_paths.report()[cuda_depthwise.RUN_OP]["shapes"] == {
            "cuda C64 kp23 tail": 1}
        tails = (state[0], state[1])
        for g, o in zip((vr, vi), _depthwise_old(w, syn._bt_flipped, 20_000,
                                                tails)):
            assert torch.equal(g, o)
        assert torch.equal(new_state, torch.stack([p[:, -22:] for p in w]))
        state = new_state


def _resample_old(xs, taps, L, M, tails):
    """The two-launch route the audio resampler had: fir_stream_f32 once a
    phase, the tails read in place and q_r as the shift, the phases
    interleaved in PyTorch."""
    n_pp = xs[0].shape[-1] // M
    phases = [cuda_fir._launch_stream(xs, taps[r], M, n_pp, tails, q)
              for r, q in enumerate(phase_offsets(L, M))]
    return tuple(torch.stack([p[i] for p in phases], -1).reshape(
        xs[0].shape[:-1] + (n_pp * L,)) for i in range(len(xs)))


# resample_poly_f32's shapes: name: (L, M, C, T, planes); "rat_": the
# shapes of resample_rat_f32 (its chains' taps) at the rows and blocks the
# paths run them: MMDVM's TX at 256 rows and one (a headless block),
# DSSS's TX at 256 rows, MMDVMmulti's TX and RX at 7 rows (one site, a
# headless block)
POLY_CASES = {
    "nbfm_audio": (2, 5, 32, 2000, 1),
    "nbfm_audio_pair": (2, 5, 32, 2000, 2),
    "m17_3_125": (3, 125, 2, 125 * 45, 2),
    "tx_25_4": (25, 4, 3, 4 * 50, 1),
    "tx_20_1": (20, 1, 2, 70, 2),
    "tx_125_1": (125, 1, 2, 40, 2),  # SsbMod's and AmMod's interpolator
    "short_block": (2, 5, 3, 50, 1),  # T < K-1: the new tail takes part
    "rat_125_12": (125, 12, 256, 24_000, 2),
    "rat_125_12_block": (125, 12, 1, 2880, 2),
    "rat_50_13": (50, 13, 256, 5200, 2),
    "rat_50_13_real": (50, 13, 3, 13 * 41, 1),
    "rat_25_24": (25, 24, 7, 24_000, 2),
    "rat_25_24_block": (25, 24, 7, 2880, 2),
    "rat_24_25": (24, 25, 7, 25_000, 2),
    "rat_24_25_block": (24, 25, 7, 3000, 2),
    "rat_24_25_short": (24, 25, 3, 25, 1),  # T < K-1 (25 < 52)
}


@pytest.mark.parametrize("name", sorted(POLY_CASES))
def test_resample_poly_matches_plain(cuda, gen, name):
    """The rational resampler with the default taps over two chained
    blocks: one launch a block of the kernel cuda_resample.route picks
    (resample_up_f32 at the TX shapes, resample_rat_f32 at the "rat_"
    shapes, resample_poly_f32 at the others), outputs within 1e-5 of the
    plain version and equal bit for bit to the two-launch route (and, at
    the "rat_" shapes, to resample_poly_f32's), the new state (zeros in the
    im plane of real input) equal to the plain version's."""
    L, M, C, T, planes = POLY_CASES[name]
    rat = name.startswith("rat_")
    if rat:
        from scripts.resample_rat_variants import rat_resampler
        rs = rat_resampler(L, M, cuda)
    else:
        rs = RationalResampler(L, M, lead_shape=(C,), device=cuda)
    state = torch.randn((C, 2, rs.kp - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = [torch.randn((C, T), generator=gen, device=cuda)
              for _ in range(planes)]
        tails = (state[:, 0], state[:, 1])[:planes]
        kernel_paths.reset()
        new_state, got = resample_poly(xs, rs.poly_taps, L, M, tails)
        op = cuda_resample.route(L, M, rs.kp)
        assert op == (cuda_resample.UP_OP if name.startswith("tx_")
                      else cuda_resample.RAT_OP if rat
                      else cuda_resample.OP)
        assert kernel_paths.report() == {op: {
            "cuda": 1, "plain": 0,
            "shapes": {f"cuda L{L} K{rs.kp} D{M} tail {planes}x{C}": 1}}}
        want_state, want = resample_poly_plain(xs, rs.poly_taps, L, M, tails)
        _assert_fir_close(got, want)
        assert torch.equal(new_state, want_state)
        for g, o in zip(got, _resample_old(xs, rs.poly_taps, L, M, tails)):
            assert torch.equal(g, o)
        if rat:
            old_state, old = cuda_resample.launch(cuda_resample.OP, xs,
                                                  rs.poly_taps, L, M, tails)
            assert torch.equal(new_state, old_state)
            for g, o in zip(got, old):
                assert torch.equal(g, o)
        state = new_state


@pytest.mark.parametrize("rows", [1, 3, 29, 64])
@pytest.mark.parametrize("L,M", [(125, 12), (50, 13), (25, 24), (24, 25)])
def test_resample_rat_tile_widths_bit_equal(cuda, gen, L, M, rows):
    """resample_rat_f32 at the output times a group that its tile rule
    gives 1, 3, 29 and 64 rows of 1,237 output times and 2 planes (on 132
    SMs from 1 to 248: one chunk, several and a ragged last one, groups
    past the row's end): outputs and state bit-equal to
    resample_poly_f32's."""
    from scripts.resample_rat_variants import rat_resampler

    rs = rat_resampler(L, M, cuda)
    n_pp = 1237
    state = torch.randn((rows, 2, rs.kp - 1), generator=gen, device=cuda)
    xs = [torch.randn((rows, n_pp * M), generator=gen, device=cuda)
          for _ in range(2)]
    tails = (state[:, 0], state[:, 1])
    got = cuda_resample.launch(cuda_resample.RAT_OP, xs, rs.poly_taps, L,
                               M, tails)
    old = cuda_resample.launch(cuda_resample.OP, xs, rs.poly_taps, L, M,
                               tails)
    for a, b in zip((got[0], *got[1]), (old[0], *old[1])):
        assert torch.equal(a, b)


def test_resample_rat_raises_without_an_instance(cuda):
    """No fallback: a launch of resample_rat_f32 at an (M, K) it has no
    instance for raises; the route never sends one there."""
    x = torch.zeros((2, 120), device=cuda)
    taps = torch.zeros((125, 45), device=cuda)
    t = torch.zeros((2, 44), device=cuda)
    assert cuda_resample.route(125, 12, 45) == cuda_resample.OP
    with pytest.raises(ValueError):
        cuda_resample.launch(cuda_resample.RAT_OP, (x,), taps, 125, 12, (t,))


# resample_up_f32 at the TX interpolators, 2048 rows (name: (L, M, T,
# planes)), and at the edges of its tiles, jobs and rings
UP_CASES = {
    "ssb_tx_up": (125, 1, 1600, 2, 2048),
    "am_tx_up": (125, 1, 1600, 1, 2048),   # AmMod: one real plane
    "nbfm_tx_up1": (25, 4, 1600, 1, 2048),
    "nbfm_tx_up2": (20, 1, 10_000, 2, 2048),
    "ragged_tiles": (125, 1, 850, 2, 3),   # 432 + 418 output times
    "m4_ragged": (25, 4, 8004, 2, 3),      # 1,008 + 993, ring of 29
    "m2_l5": (5, 2, 2 * 611, 2, 5),        # ring of 31, L not dividing 32
    "m3_l4": (4, 3, 3 * 9, 1, 7),          # one job of 9 of 8 + 1 times
    "m5_l8": (8, 5, 5 * 97, 2, 4),         # ring of 36
    "state_only": (125, 1, 0, 2, 3),       # T = 0: the state alone
}


@pytest.mark.parametrize("name", sorted(UP_CASES))
def test_resample_up_matches_plain(cuda, gen, name):
    """resample_up_f32 with the default taps over two chained blocks, the
    tails read in place: outputs and new state equal bit for bit to
    resample_poly_f32's on the same inputs, within 1e-5 of the plain
    version (the state equal to it)."""
    L, M, T, planes, C = UP_CASES[name]
    rs = RationalResampler(L, M, lead_shape=(C,), device=cuda)
    assert cuda_resample.route(L, M, rs.kp) == cuda_resample.UP_OP
    state = torch.randn((C, 2, rs.kp - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = [torch.randn((C, T), generator=gen, device=cuda)
              for _ in range(planes)]
        tails = (state[:, 0], state[:, 1])[:planes]
        kernel_paths.reset()
        new_state, got = resample_poly(xs, rs.poly_taps, L, M, tails)
        assert kernel_paths.launches(cuda_resample.UP_OP) == 1
        assert kernel_paths.launches(cuda_resample.OP) == 0
        old_state, old = cuda_resample.launch(cuda_resample.OP, xs,
                                              rs.poly_taps, L, M, tails)
        want_state, want = resample_poly_plain(xs, rs.poly_taps, L, M, tails)
        assert torch.equal(new_state, old_state)
        assert torch.equal(new_state, want_state)
        for g, o in zip(got, old):
            assert torch.equal(g, o)
        if T:
            _assert_fir_close(got, want)
        state = new_state


def test_resample_up_raises_without_a_ring_instance(cuda):
    """No fallback: a launch of resample_up_f32 at a decimation it has no
    instance for raises; the route never sends one there."""
    x, taps = torch.zeros((2, 60), device=cuda), torch.zeros((4, 5),
                                                             device=cuda)
    t = torch.zeros((2, 4), device=cuda)
    assert cuda_resample.route(4, 6, 5) == cuda_resample.OP
    with pytest.raises(ValueError):
        cuda_resample.launch(cuda_resample.UP_OP, (x,), taps, 4, 6, (t,))


def test_nbfm_audio_resampler_is_one_launch(cuda, gen):
    """The NBFM chain's audio resampler (2/5) on real input at the mixed
    path's shape: one resample_poly_f32 launch and no fir_stream_f32."""
    rs = NbfmDemod(lead_shape=(32,), device=cuda).audio_resamp
    state = rs.init_state()
    for _ in range(2):
        x = torch.randn((32, 2000), generator=gen, device=cuda)
        kernel_paths.reset()
        new_state, y = rs(state, x)
        assert kernel_paths.report() == {"resample_poly_f32": {
            "cuda": 1, "plain": 0, "shapes": {
                "cuda L2 K113 D5 tail 1x32": 1}}}
        want_state, (want,) = resample_poly_plain(
            (x,), rs.poly_taps, 2, 5, (state[:, 0],))
        _assert_fir_close((y,), (want,))
        assert torch.equal(new_state, want_state)
        state = new_state


def _pfb_two_blocks(cuda, gen, M, B, Tm, taps=None):
    """Two chained blocks through the channelizer's fused route: each
    block's output within 1e-5 of the plain version's peak from the same
    state, the second block reading the history the first one left (the
    seam), and the carried state bit-equal to the last kp*M input samples.
    Each block launches the kernel route(M, kp) picks, once, and not the
    other; returns that kernel's name."""
    ch = PfbChannelizer(M, taps=taps, lead_shape=(B,), device=cuda)
    op = cuda_pfb.route(M, ch.kp)
    other = ({cuda_pfb.OP, cuda_pfb.FFT_OP} - {op}).pop()
    state = torch.randn((B, 2, ch.kp * M), generator=gen, device=cuda)
    for _ in range(2):
        x = IqPair(torch.randn((B, Tm * M), generator=gen, device=cuda),
                   torch.randn((B, Tm * M), generator=gen, device=cuda))
        kernel_paths.reset()
        new_state, y = ch(state, x)
        assert kernel_paths.launches(op) == 1
        assert kernel_paths.launches(other) == 0
        ref = channelize_plain((x.re, x.im), state, ch._ct)
        peak = max(float(r.abs().max()) for r in ref)
        for g, r in zip((y.re, y.im), ref):
            assert float((g - r).abs().max()) <= 1e-5 * peak
        want = torch.cat([state, torch.stack([x.re, x.im], 1)], -1)
        assert torch.equal(new_state, want[..., -ch.kp * M:])
        state = new_state
    return op


@pytest.mark.parametrize("M,B,Tm", [(64, 1, 3000), (8, 3, 1000 + 7),
                                    (10, 2, 515), (13, 1, 300),
                                    (12, 3, 401)])
def test_pfb_kernel_matches_plain(cuda, gen, M, B, Tm):
    """M = 64 and 8 route to pfb_fft_f32; M = 10, 13 and 12 to
    pfb_channelize_f32: at 10 and 13 its scalar staging (M not a multiple
    of 4), at 13 its one-stage dense DFT (M1 = 1), at 12 its float4
    staging over three streams."""
    op = _pfb_two_blocks(cuda, gen, M, B, Tm)
    assert op == (cuda_pfb.FFT_OP if M in (8, 64) else cuda_pfb.OP)


@pytest.mark.parametrize("M", [8, 16, 32, 64])
@pytest.mark.parametrize("B,Tm", [(1, 32 * 3000 + 5), (3, 32 * 1200 + 27)])
def test_pfb_fft_kernel_matches_plain(cuda, gen, M, B, Tm):
    """pfb_fft_f32 at every M it takes, one and three streams (stream b's
    planes start at b Tm M), ragged last tiles, over two chained blocks.
    The tiles outnumber the blocks the card holds several times over, so
    runs are several tiles long and the staging ring wraps."""
    assert _pfb_two_blocks(cuda, gen, M, B, Tm) == cuda_pfb.FFT_OP


def _mmdvm_taps():
    from qradiolink_tpu_torch.chains import mmdvm
    return mmdvm._lp(1.0, mmdvm.DEVICE_RATE, mmdvm.FILTER_WIDTH)


@pytest.mark.parametrize("B,Tm", [(1, 25_000), (1, 3_000), (3, 64 * 1200 + 27),
                                  (64, 25_000), (2, 5)])
def test_pfb_fft_at_mmdvm_multi_shape(cuda, gen, B, Tm):
    """pfb_fft_f32 at M 10, kp 56 (MMDVMmulti's channelizer taps): one
    site, the headless block, three streams with runs of several tiles and
    a ragged last tile, a farm of 64 sites, and a block shorter than one
    tile, over two chained blocks."""
    assert _pfb_two_blocks(cuda, gen, 10, B, Tm, _mmdvm_taps()) == \
        cuda_pfb.FFT_OP


def test_pfb_kernels_agree_at_the_mixed_shape(cuda, gen):
    """Both kernels at M = 64, kp = 24 on one input: each within 1e-5 of the
    plain version's peak (pfb_channelize_f32 no longer serves this shape on
    a path)."""
    ch = PfbChannelizer(64, device=cuda)
    xs = tuple(torch.randn((64 * 5000,), generator=gen, device=cuda)
               for _ in range(2))
    state = torch.randn((2, 24 * 64), generator=gen, device=cuda)
    ref = channelize_plain(xs, state, ch._ct)
    peak = max(float(r.abs().max()) for r in ref)
    kernel_paths.reset()
    for got in (cuda_pfb._launch(xs, state, ch._ct, ch._dft),
                cuda_pfb._launch_fft(xs, state, ch._ct)):
        for g, r in zip(got, ref):
            assert float((g - r).abs().max()) <= 1e-5 * peak
    assert kernel_paths.launches(cuda_pfb.OP) == 1
    assert kernel_paths.launches(cuda_pfb.FFT_OP) == 1


def test_channelizer_routes_agree_on_card_and_cpu(cuda, gen):
    """IqPair input (K5, on the kernel route(M, kp) picks) and complex input
    (K4, then an FFT) on the card and IqPair input on the CPU (the plain
    route) give one channelizer output."""
    M, Tm = 64, 2000
    x = IqPair(torch.randn((M * Tm,), generator=gen, device=cuda),
               torch.randn((M * Tm,), generator=gen, device=cuda))
    outs = {}
    for name, dev in (("k5", cuda), ("k4", cuda),
                      ("cpu", torch.device("cpu"))):
        ch = PfbChannelizer(M, device=dev)
        op = (cuda_depthwise.route(ch.kp) if name == "k4"
              else cuda_pfb.route(M, ch.kp))
        xd = (torch.complex(x.re, x.im).to(dev) if name == "k4"
              else IqPair(x.re.to(dev), x.im.to(dev)))
        kernel_paths.reset()
        _, y = ch(ch.init_state(), xd)
        assert kernel_paths.report()[op]["cuda" if dev.type == "cuda"
                                         else "plain"] == 1
        outs[name] = (y if name == "k4" else torch.complex(y.re, y.im)).cpu()
    peak = float(outs["cpu"].abs().max())
    for name in ("k5", "k4"):
        assert float((outs[name] - outs["cpu"]).abs().max()) <= 1e-5 * peak


def test_synthesizer_on_card_matches_cpu(cuda, gen):
    M, Tm = 64, 1000
    s = IqPair(torch.randn((M, Tm), generator=gen, device=cuda),
               torch.randn((M, Tm), generator=gen, device=cuda))
    ys = {}
    for dev in (cuda, torch.device("cpu")):
        syn = PfbSynthesizer(M, device=dev)
        st = syn.init_state()
        kernel_paths.reset()
        for _ in range(2):
            st, y = syn(st, IqPair(s.re.to(dev), s.im.to(dev)))
        if dev.type == "cuda":
            assert kernel_paths.launches(cuda_depthwise.route(syn.kp)) == 2
        ys[dev.type] = torch.complex(y.re, y.im).cpu()
    peak = float(ys["cpu"].abs().max())
    assert float((ys["cuda"] - ys["cpu"]).abs().max()) <= 1e-5 * peak


@pytest.mark.parametrize("kind", ["integer", "chain"])
def test_viterbi_kernel_bit_exact(cuda, gen, kind):
    if kind == "integer":
        win = torch.randint(0, 256, (1024, 192, 2), generator=gen,
                            device=cuda).float()
    else:
        ph = float(np.pi / 2) * 1.5 * torch.randn((1024, 192), generator=gen,
                                                  device=cuda)
        win = torch.clamp(torch.stack([torch.sin(ph), torch.cos(ph)], -1)
                          * 128.0 + 128.0, 0.0, 255.0)
    kernel_paths.reset()
    got = decode_windows(CCSDS_K7, win, 32)
    assert kernel_paths.launches("viterbi_tiled_k7") == 1
    assert torch.equal(got, decode_windows_plain(CCSDS_K7, win, 32))


def _viterbi_soft(gen, cuda, shape, kind):
    if kind == "integer":
        return torch.randint(0, 256, shape, generator=gen,
                             device=cuda).float()
    ph = float(np.pi / 2) * 1.5 * torch.randn(shape[:-1], generator=gen,
                                              device=cuda)
    return torch.clamp(torch.stack([torch.sin(ph), torch.cos(ph)], -1)
                       * 128.0 + 128.0, 0.0, 255.0)


@pytest.mark.parametrize("lead,T", [(2048, 400), (32, 200), (3, 224),
                                    (3, 10)])
@pytest.mark.parametrize("kind", ["integer", "chain"])
def test_viterbi_bfly_matches_plain(cuda, gen, kind, lead, T):
    """viterbi_bfly_k7 over two chained blocks (the 4FSK and mixed path
    shapes, T + W = 256 with no pad, T < W): one launch a call and none of
    viterbi_tiled_k7; bits and the new tail equal to the plain version's
    and to the old window route's."""
    state = torch.full((lead, 32, 2), 128.0, device=cuda)
    for _ in range(2):
        soft = _viterbi_soft(gen, cuda, (lead, T, 2), kind)
        kernel_paths.reset()
        tail, bits = decode_stream(CCSDS_K7, state, soft)
        assert kernel_paths.launches("viterbi_bfly_k7") == 1
        assert kernel_paths.launches("viterbi_tiled_k7") == 0
        p_tail, p_bits = decode_stream_plain(CCSDS_K7, state, soft, 128, 32)
        o_tail, o_bits = decode_stream_tiled(CCSDS_K7, state, soft, 128, 32)
        for ref_tail, ref_bits in ((p_tail, p_bits), (o_tail, o_bits)):
            assert torch.equal(bits, ref_bits)
            assert torch.equal(tail, ref_tail)
        state = tail


def test_fixture_bits_equal_on_card_and_cpu(cuda):
    data = np.load(FIX)
    re = torch.from_numpy(data["iq_re"].astype(np.float32))
    im = torch.from_numpy(data["iq_im"].astype(np.float32))
    half = re.shape[0] // 2
    bits = {}
    for dev in (cuda, torch.device("cpu")):
        chain = Fsk4DemodFF(device=dev)
        st = chain.init_state()
        out_bits = []
        for sl in (slice(0, half), slice(half, 2 * half)):
            st, out = chain(st, IqPair(re[sl].to(dev), im[sl].to(dev)))
            out_bits.append(out["bits"].cpu())
        bits[dev.type] = torch.cat(out_bits)
    assert torch.equal(bits["cuda"], bits["cpu"])


# agc2_gain_f32's shapes: name: (C, T): the SSB chain at 2048 channels x
# 200,000 samples (1,600 at 8 ksps), the AM chain's 20 ksps (4,000), row
# counts and tiles that do not fill a block, one sample
AGC_CASES = {"ssb": (2048, 1600), "am": (64, 4000), "ragged": (45, 100),
             "one_sample": (3, 1)}
# (attack, decay, reference) of the SSB and the AM chain's AGC
AGC_PARAMS = [(1e-1, 1e-1, 0.25), (1e-1, 1e-2, 1.0)]


@pytest.mark.parametrize("params", AGC_PARAMS)
@pytest.mark.parametrize("name", sorted(AGC_CASES))
def test_agc2_kernel_equals_plain(cuda, gen, name, params):
    """Two chained blocks of bursty magnitudes: one launch a block, gains
    and the carried gain equal bit for bit to the plain loop's."""
    C, T = AGC_CASES[name]
    amp = torch.where((torch.arange(T, device=cuda) // 150) % 2 == 0, 2.0,
                      0.02)
    g = torch.ones(C, device=cuda)
    for _ in range(2):
        m = (torch.randn((C, T), generator=gen, device=cuda) * amp).abs()
        kernel_paths.reset()
        gains, g_last = cuda_agc.agc2_gain(m, g, *params, 65536.0)
        assert kernel_paths.report()["agc2_gain_f32"]["shapes"] == {
            f"cuda {C}x{T}": 1}
        want, want_last = cuda_agc.agc2_gain_plain(m, g, *params, 65536.0)
        assert torch.equal(gains, want) and torch.equal(g_last, want_last)
        g = g_last


# agc2_f32's shapes: name: (C, T, complex input, the chain's (attack,
# decay, reference)): QPSK250K after the RRC, the SSB chain after its
# squelch, the AM chain after ComplexToMag, all at 2048 channels x 200,000
# samples; rows and tiles that do not fill a block, one sample
AGC_FUSED_CASES = {"qpsk250k": (2048, 100_000, True, (1e-1, 1e-1, 1.0)),
                   "ssb": (2048, 1600, True, AGC_PARAMS[0]),
                   "am": (2048, 4000, False, AGC_PARAMS[1]),
                   "ragged": (45, 100, True, AGC_PARAMS[0]),
                   "ragged_real": (33, 97, False, AGC_PARAMS[1]),
                   "one_sample": (3, 1, True, AGC_PARAMS[1])}


@pytest.mark.parametrize("name", sorted(AGC_FUSED_CASES))
def test_agc2_fused_kernel_equals_plain(cuda, gen, name):
    """Two chained blocks of bursty input (the first samples ~1e-20): one
    launch of agc2_f32 a block, y and the carried gain equal bit for bit
    to the plain version's (torch.abs, the loop, the products)."""
    C, T, cplx, params = AGC_FUSED_CASES[name]
    amp = torch.where((torch.arange(T, device=cuda) // 150) % 2 == 0, 2.0,
                      0.02)
    g = torch.ones(C, device=cuda)
    for blk in range(2):
        dt = torch.complex64 if cplx else torch.float32
        x = torch.randn((C, T), generator=gen, device=cuda, dtype=dt) * amp
        if blk == 0:
            x[:, :200] *= 1e-20
        kernel_paths.reset()
        y, g_last = cuda_agc.agc2(x, g, *params, 65536.0)
        kind = "complex" if cplx else "real"
        assert kernel_paths.report() == {cuda_agc.OP_FUSED: {
            "cuda": 1, "plain": 0, "shapes": {f"cuda {kind} {C}x{T}": 1}}}
        want, want_last = cuda_agc.agc2_plain(x, g, *params, 65536.0)
        assert y.dtype == want.dtype
        assert torch.equal(y, want) and torch.equal(g_last, want_last)
        g = g_last


def _abs_edges(dev):
    """complex64 edge patterns: signed zeros, denormals, one plane far
    above the other both ways, magnitudes near FLT_MAX that stay finite,
    and their mixtures."""
    f = torch.finfo(torch.float32)
    vals = torch.tensor([0.0, -0.0, f.tiny, -f.tiny, f.tiny / 2, 1e-45,
                         -1e-45, 1e-40, 1e-38, 1e-30, 1e-20, 1.0, -1.0,
                         3.0, 1e10, 1e20, 1e30, 1e38, 2e38, -2e38,
                         f.max / 2, f.max / 1.5, 2.3e38, -2.4e38],
                        dtype=torch.float32, device=dev)
    re, im = torch.meshgrid(vals, vals, indexing="ij")
    return torch.complex(re.reshape(-1), im.reshape(-1))


def test_agc2_abs_equals_torch_abs(cuda):
    """agc2_f32's |x| (hypotf) gives torch.abs's bits on 2^28 complex64
    values of random bit patterns (every exponent; NaN against NaN counts
    as equal), 2^24 of randn pairs and the edge patterns."""
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    bad, n = 0, 0
    for _ in range(8):
        bits = torch.randint(-2**31, 2**31, (1 << 26,), generator=g,
                             dtype=torch.int64, device=cuda).to(torch.int32)
        x = bits.view(torch.float32).view(torch.complex64)
        got, want = cuda_agc.abs_complex(x), torch.abs(x)
        same = (got.view(torch.int32) == want.view(torch.int32)) | (
            torch.isnan(got) & torch.isnan(want))
        bad += int((~same).sum())
        n += x.numel()
        del bits, x, got, want, same
    for x in (torch.randn(1 << 24, generator=g, device=cuda,
                          dtype=torch.complex64), _abs_edges(cuda)):
        got, want = cuda_agc.abs_complex(x), torch.abs(x)
        assert torch.isfinite(want).all()
        bad += int((got.view(torch.int32) != want.view(torch.int32)).sum())
        n += x.numel()
    assert n >= 1 << 28 and bad == 0


@pytest.mark.parametrize("kind", ["pair", "complex", "real"])
def test_complex_tap_fir_on_card_matches_cpu(cuda, gen, kind):
    """The SSB channel filter's 167 complex taps in direct form
    (impl="conv": "auto" gives a complex tensor the FFT form,
    test_fft_fir_on_card_matches_cpu): two launches of fir_s1_f32 a block
    (one a tap plane) at one key, over two chained blocks, output and
    state within the FIR bound of the CPU path's."""
    from qradiolink_tpu_torch.ops import firdes
    taps = firdes.complex_band_pass(1.0, 8000, 200.0, 2700.0, 200.0,
                                    firdes.WIN_BLACKMAN_HARRIS)
    C, T = 16, 1600
    fs = {d: FirFilter(taps, impl="conv", lead_shape=(C,), device=d)
          for d in (cuda, torch.device("cpu"))}
    states = {d: f.init_state() for d, f in fs.items()}
    for _ in range(2):
        re, im = (torch.randn((C, T), generator=gen, device=cuda)
                  for _ in range(2))
        x = {"pair": IqPair(re, im), "complex": torch.complex(re, im),
             "real": re}[kind]
        outs = {}
        for d, f in fs.items():
            xd = IqPair(x.re.to(d), x.im.to(d)) if kind == "pair" \
                else x.to(d)
            kernel_paths.reset()
            states[d], y = f(states[d], xd)
            outs[d.type] = y
            planes = 1 if kind == "real" else 2
            path = "cuda" if d.type == "cuda" else "plain"
            assert kernel_paths.report()["fir_s1_f32"]["shapes"] == {
                f"{path} K167 D1 tail {planes}x{C}": 2}
        got, want = outs["cuda"], outs["cpu"]
        if kind == "pair":
            got, want = got.to_complex(), want.to_complex()
        assert got.dtype == want.dtype == torch.complex64
        _assert_fir_close((got.real.cpu(), got.imag.cpu()),
                          (want.real, want.imag))
        assert torch.equal(states[cuda].cpu(), states[torch.device("cpu")])


def _assert_peak_close(got, want, rtol=1e-5, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    peak = float(np.abs(want).max()) if want.size else 0.0
    assert float(np.abs(got - want).max()) <= rtol * peak, what


@pytest.mark.parametrize("chain", ["ssb_usb", "ssb_lsb", "am", "wbfm"])
def test_analog_chain_on_card_matches_cpu(cuda, gen, chain):
    """3 channels, two blocks of 25,000 IqPair samples at 0.1 RMS a plane:
    audio and every state leaf within 1e-5 of the peak of the CPU path's,
    rssi within 1e-4 dB."""
    make = {"ssb_usb": lambda d: SsbDemod(usb=True, lead_shape=(3,),
                                          device=d),
            "ssb_lsb": lambda d: SsbDemod(usb=False, lead_shape=(3,),
                                          device=d),
            "am": lambda d: AmDemod(lead_shape=(3,), device=d),
            "wbfm": lambda d: WbfmDemod(lead_shape=(3,), device=d)}[chain]
    cpu = torch.device("cpu")
    chains = {d.type: make(d) for d in (cuda, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    for _ in range(2):
        re, im = (torch.randn((3, 25_000), generator=gen, device=cuda) * 0.1
                  for _ in range(2))
        outs = {}
        for d in (cuda, cpu):
            states[d.type], outs[d.type] = chains[d.type](
                states[d.type], IqPair(re.to(d), im.to(d)))
        _assert_peak_close(outs["cuda"]["audio"].cpu(), outs["cpu"]["audio"],
                           what="audio")
        assert float((outs["cuda"]["rssi"].cpu()
                      - outs["cpu"]["rssi"]).abs().max()) <= 1e-4
        for i, (a, b) in enumerate(zip(_flatten(states["cuda"], []),
                                       _flatten(states["cpu"], []))):
            _assert_peak_close(a.cpu(), b, what=f"state leaf {i}")


# -- the PSK chains' loop kernels ---------------------------------------------

def qpsk_signal(dev, C, T, seed=0, offset_hz=1000.0, noise=0.05):
    """C rows of T complex64 samples of QPSK250K from the port's QpskMod
    (1 Msps), with a carrier offset and seeded noise, the first 200
    samples scaled to ~1e-20 (the denormal trap)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    n_bytes = -(-T // 64)  # 64 samples a byte at QPSK250K
    mod = QpskMod(125_000, lead_shape=(C,), device=dev)
    data = torch.randint(0, 256, (C, n_bytes), generator=g, device=dev,
                         dtype=torch.int64).to(torch.uint8)
    iq = mod(mod.init_state(), data)[1]["iq"][:, :T]
    t = torch.arange(T, device=dev, dtype=torch.float64)
    rot = torch.exp(1j * (2 * np.pi * offset_hz / 1e6 * t)).to(
        torch.complex64)
    iq = iq * rot + noise * torch.randn((C, T), generator=g, device=dev,
                                        dtype=torch.complex64)
    iq[:, :200] *= 1e-20
    return iq.contiguous()


# (rows, samples a block): the QPSK250K widths in miniature, a ragged row
# block, a block shorter than one staging tile, one sample
COSTAS_CASES = {"wide": (2048, 2000), "ragged": (45, 300),
                "short": (33, 17), "one_sample": (3, 1)}


@pytest.mark.parametrize("order", [2, 4])
@pytest.mark.parametrize("name", sorted(COSTAS_CASES))
def test_costas_kernel_equals_plain(cuda, name, order):
    """Two chained blocks: y and the carried phase and frequency equal bit
    for bit to the plain loop's, one launch a block."""
    C, T = COSTAS_CASES[name]
    x = qpsk_signal(cuda, C, 2 * T + 200)[:, 200 - (2 * T) % 7:]
    alpha, beta = 0.0786, 0.00309
    ph = torch.zeros(C, device=cuda)
    fr = torch.zeros(C, device=cuda)
    for blk in range(2):
        xb = x[:, blk * T:(blk + 1) * T].contiguous()
        kernel_paths.reset()
        y, ph2, fr2 = cuda_costas.costas_loop(xb, ph, fr, order, alpha, beta,
                                              1.0)
        assert kernel_paths.launches(cuda_costas.OP) == 1
        yr, yi, ph_p, fr_p = cuda_costas.costas_loop_plain(
            xb.real, xb.imag, ph, fr, order, alpha, beta, 1.0)
        assert torch.equal(y.real, yr) and torch.equal(y.imag, yi)
        assert torch.equal(ph2, ph_p) and torch.equal(fr2, fr_p)
        ph, fr = ph2, fr2


# name: (rows, samples a block, sps, mode); odd_T and sign_real_pad take the
# wrapper's padded copy (rows a whole number of 16-byte granules apart)
SYNC_CASES = {"qpsk_wide": (2048, 800, 4, "conj"),
              "qpsk_ragged": (45, 400, 4, "conj"),
              "bpsk_sps10": (33, 500, 10, "conj"),
              "short": (5, 8, 4, "conj"),
              "odd_T": (9, 401, 4, "conj"),
              "sign_real": (40, 400, 4, "sign"),
              "sign_real_pad": (40, 402, 4, "sign"),
              "levels_real": (40, 400, 4, "levels"),
              "levels_complex": (7, 200, 4, "levels")}


def _sync_args(mode, sps, x):
    from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync

    lv = (-1.5, -0.5, 0.5, 1.5) if mode == "levels" else None
    return SymbolSync(sps, decisions=lv, lead_shape=(x.shape[0],),
                      device=x.device)


@pytest.mark.parametrize("name", sorted(SYNC_CASES))
def test_symbol_sync_kernel_equals_plain(cuda, name):
    """Two chained blocks through SymbolSync's loop: the symbols and every
    state leaf of the kernel equal to the plain loop's on the same
    inputs, one launch a block."""
    C, T, sps, mode = SYNC_CASES[name]
    x = qpsk_signal(cuda, C, 2 * T + 200, offset_hz=0.0)[:, 200:]
    if mode != "conj":
        x = x.real.contiguous() * (2.0 if mode == "levels" else 1.0)
        if name == "levels_complex":
            x = x.to(torch.complex64)
    ss = _sync_args(mode, sps, x)
    m = cuda_symbol_sync.mode_of(torch.is_complex(x), ss.levels)
    st = ss.init_state()
    for blk in range(2):
        xb = x[:, blk * T:(blk + 1) * T].contiguous()
        pos, omega, yp, dp, tail = st
        args = (tail, xb, pos, omega, yp, dp, int(round(T / sps)), m,
                ss.levels, ss.sps, ss.alpha, ss.beta, ss.omega_limit,
                ss.ted_norm)
        kernel_paths.reset()
        got = cuda_symbol_sync.symbol_sync(*args)
        assert kernel_paths.launches(cuda_symbol_sync.OP) == 1
        xc = torch.cat([tail, xb.to(torch.complex64)], dim=-1)
        want = cuda_symbol_sync.symbol_sync_plain(
            xc.real.contiguous(), xc.imag.contiguous(), *args[2:])
        assert torch.equal(got[0].real, want[0])
        assert torch.equal(got[0].imag, want[1])
        for a, b in zip(got[1:], want[2:]):
            assert torch.equal(a, b)
        st, _ = ss(st, xb)


def stress_ramps(C, n, complex_in, slope=1.0):
    """The symbol sync's stress input (numpy): rows that ramp up (even
    rows, slope (t + 1)) and down (odd rows, slope (n - t)), on both planes
    of complex input. To the M&M TED every symbol is late (up) or early
    (down) by more than any clock the loop may take, so |e| sits at its
    clip, +1 or -1, and omega runs to omax or omin and stays there: each
    symbol advances the position by omax + gain_mu or omin - gain_mu, the
    extremes the kernel's ring plan (cuda_symbol_sync.ring_plan) serves."""
    t = np.arange(n, dtype=np.float64)
    v = np.stack([slope * (t + 1) if r % 2 == 0 else slope * (n - t)
                  for r in range(C)])
    return (v * (1 + 1j)).astype(np.complex64) if complex_in \
        else v.astype(np.float32)


# name: SymbolSync kwargs and real levels (None: complex sign decisions):
# QPSK250K's loop and DMR's (the largest gain_mu of the JAX chains), each
# with a gain_omega that takes omega to its limit within the first block
SYNC_STRESS = {"qpsk250k": (dict(sps=4, gain_mu=0.02, gain_omega=1e-4,
                                 omega_limit=0.0016), None),
               "dmr": (dict(sps=5, gain_mu=0.2869, gain_omega=0.005,
                            omega_limit=0.06), (-1.5, -0.5, 0.5, 1.5))}


@pytest.mark.parametrize("name", sorted(SYNC_STRESS))
def test_symbol_sync_stress_equals_plain(cuda, name):
    """The stress ramps at 2048 rows over two chained blocks of 4,000:
    omega at omax on the rows that ramp up and omin on those that ramp
    down after each block, |e| at its clip, so each chunk's reads reach as
    far as the ring allows; the symbols and every state leaf equal the
    plain loop's, one launch a block."""
    from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync

    kw, lv = SYNC_STRESS[name]
    C, T = 2048, 4000
    ss = SymbolSync(decisions=lv, lead_shape=(C,), device=cuda, **kw)
    x = torch.from_numpy(stress_ramps(C, 2 * T, lv is None)).to(cuda)
    m = cuda_symbol_sync.mode_of(torch.is_complex(x), ss.levels)
    st = ss.init_state()
    omax = np.float32(ss.sps + ss.omega_limit)
    omin = np.float32(ss.sps - ss.omega_limit)
    for blk in range(2):
        xb = x[:, blk * T:(blk + 1) * T].contiguous()
        pos, omega, yp, dp, tail = st
        args = (tail, xb, pos, omega, yp, dp, int(round(T / ss.sps)), m,
                ss.levels, ss.sps, ss.alpha, ss.beta, ss.omega_limit,
                ss.ted_norm)
        kernel_paths.reset()
        got = cuda_symbol_sync.symbol_sync(*args)
        assert kernel_paths.launches(cuda_symbol_sync.OP) == 1
        xc = torch.cat([tail, xb.to(torch.complex64)], dim=-1)
        want = cuda_symbol_sync.symbol_sync_plain(
            xc.real.contiguous(), xc.imag.contiguous(), *args[2:])
        assert torch.equal(got[0].real, want[0])
        assert torch.equal(got[0].imag, want[1])
        for a, b in zip(got[1:], want[2:]):
            assert torch.equal(a, b)
        om = got[2].cpu().numpy()
        assert np.all(om[0::2] == omax) and np.all(om[1::2] == omin)
        st, _ = ss(st, xb)


def test_symbol_sync_raises_where_the_ring_cannot_serve(cuda):
    """sps 600: a symbol's advance outgrows the largest ring; the wrapper
    raises before any launch."""
    from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync

    ss = SymbolSync(600, lead_shape=(4,), device=cuda)
    kernel_paths.reset()
    with pytest.raises(ValueError):
        ss(ss.init_state(), torch.zeros((4, 2400), dtype=torch.complex64,
                                        device=cuda))
    assert kernel_paths.launches(cuda_symbol_sync.OP) == 0


def test_sync_levels_fabs_equals_torch_abs(cuda):
    """The real-levels path's distance, fabsf(d) on the card (through
    cuda_symbol_sync.level_distance), gives the bits of
    torch.abs(torch.complex(d, +0)) and of torch.abs(torch.complex(d, -0))
    for all 2^32 f32 patterns (NaN against NaN counts as equal), in chunks
    of 2^28: hypot(d, +-0) = |d|, so the kernel's |yr - l| is the plain
    loop's distance where yi is +0."""
    n = 1 << 28
    bad = 0
    for k in range(16):
        bits = torch.arange(-(1 << 31) + k * n, -(1 << 31) + (k + 1) * n,
                            dtype=torch.int32, device=cuda)
        d = bits.view(torch.float32)
        got = cuda_symbol_sync.level_distance(d)
        for z in (0.0, -0.0):
            want = torch.abs(torch.complex(d, torch.full_like(d, z)))
            same = (got.view(torch.int32) == want.view(torch.int32)) | (
                torch.isnan(got) & torch.isnan(want))
            bad += int((~same).sum())
            del want
        del bits, d, got
    assert bad == 0


def _same_bits(a, b):
    """Equal bit for bit, the signs of zeros too (torch.equal takes -0 for
    +0)."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


# the levels-mode loops of the paths, real input: name: (registry mode, rows,
# samples a block); M17, DMR and GMSK2K at their steps, the sweep's modes at
# 256 rows; "dmr_tail_imag" starts from a tail whose imaginary plane is
# not +0, where the kernel interpolates it and takes a hypotf a level
SYNC_LEVELS_CASES = {"m17": ("M17", 2048, 4_800), "dmr": ("DMR", 2048, 4_800),
                     "gmsk2k": ("GMSK2K", 2048, 4_000),
                     "4fsk2k": ("4FSK2K", 256, 10_000),
                     "4fsk10kfm": ("4FSK10KFM", 256, 16_000),
                     "4fsk100k": ("4FSK100K", 256, 100_000),
                     "2fsk2k": ("2FSK2K", 256, 20_000),
                     "2fsk1k": ("2FSK1K", 256, 40_000),
                     "gmsk10k": ("GMSK10K", 256, 16_000),
                     "dmr_tail_imag": ("DMR", 45, 4_800)}


@pytest.mark.parametrize("name", sorted(SYNC_LEVELS_CASES))
def test_sync_levels_kernel_equals_plain(cuda, gen, name):
    """The chain's M&M loop in levels mode on real input (the kernel's
    real-levels path) over two chained blocks: random levels held a symbol,
    smoothed and noisy, the first 50 samples ~1e-20, and the first symbol
    (an integral position: yr is the tail's sample there) exactly midway
    between the first two levels, where the first one wins; symbols and
    every state leaf equal to one call of the plain loop bit for bit (the
    signs of zeros too), one launch a block; and equal to the hypotf levels
    code (symbol_sync_levels_v0)."""
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.sync.symbol_sync import SymbolSync

    mode, C, T = SYNC_LEVELS_CASES[name]
    ss = registry.rx_chain(mode, lead_shape=(C,), device=cuda).symbol_sync
    assert isinstance(ss, SymbolSync) and ss.levels is not None
    sps, lv = int(ss.sps), ss.levels
    idx = torch.randint(0, lv.numel(), (C, -(-2 * T // sps) + 1),
                        generator=gen, device=cuda)
    x = torch.nn.functional.avg_pool1d(
        torch.repeat_interleave(lv[idx], sps, dim=-1)[:, None], sps,
        1)[:, 0, :2 * T]
    x = x + 0.05 * torch.randn(x.shape, generator=gen, device=cuda)
    x[:, :50] *= 1e-20
    st = list(ss.init_state())
    b = int(st[0][0])
    assert float(st[0][0]) == b
    tail = st[4].clone()
    if name == "dmr_tail_imag":
        tail = torch.complex(torch.randn(tail.shape, generator=gen,
                                         device=cuda),
                             torch.randn(tail.shape, generator=gen,
                                         device=cuda))
    else:
        tail[:, b] = (lv[0] + lv[1]) / 2
    st[4] = tail
    n_out = int(round(T / ss.sps))
    for blk in range(2):
        xb = x[:, blk * T:(blk + 1) * T].contiguous()
        pos, omega, yp, dp, tail = st
        kw = (lv, ss.sps, ss.alpha, ss.beta, ss.omega_limit, ss.ted_norm)
        kernel_paths.reset()
        got = cuda_symbol_sync.symbol_sync(tail, xb, pos, omega, yp, dp,
                                           n_out, cuda_symbol_sync.MODE_LEVELS,
                                           *kw)
        assert kernel_paths.launches(cuda_symbol_sync.OP) == 1
        xc = torch.cat([tail, xb.to(torch.complex64)], dim=-1)
        want = cuda_symbol_sync.symbol_sync_plain(
            xc.real.contiguous(), xc.imag.contiguous(), pos, omega, yp, dp,
            n_out, cuda_symbol_sync.MODE_LEVELS, *kw)
        assert _same_bits(got[0].real.contiguous(), want[0])
        assert _same_bits(got[0].imag.contiguous(), want[1])
        for a, w in zip(got[1:], want[2:]):
            assert _same_bits(a, w)
        v0 = cuda_symbol_sync.symbol_sync_levels_v0(tail, xb, pos, omega,
                                                    yp, dp, n_out, *kw)
        for a, w in zip(got, v0):
            assert _same_bits(a, w)
        if blk == 0 and name != "dmr_tail_imag":
            # the tie happened: the first symbol is the midpoint
            assert float(got[0][0, 0].real) == float((lv[0] + lv[1]) / 2)
        st = list(ss(st, xb)[0])


def test_costas_nco_equals_torch_for_every_f32(cuda):
    """The Costas kernel's NCO (its sincosf, through costas_nco_f32) gives
    torch.cos's and -torch.sin's bits for all 2^32 f32 patterns (NaN
    against NaN counts as equal), in chunks of 2^28."""
    n = 1 << 28
    bad = 0
    for k in range(16):
        bits = torch.arange(-(1 << 31) + k * n, -(1 << 31) + (k + 1) * n,
                            dtype=torch.int32, device=cuda)
        ph = bits.view(torch.float32)
        c, s = cuda_costas.nco(ph)
        for got, want in ((c, torch.cos(ph)), (s, -torch.sin(ph))):
            same = (got.view(torch.int32) == want.view(torch.int32)) | (
                torch.isnan(got) & torch.isnan(want))
            bad += int((~same).sum())
        del bits, ph, c, s
    assert bad == 0


# name: (rows, pairs a block, lag); lag 0 is viterbi_decode's form;
# QPSK250K's shape and BPSK2K's (the delay-diversity pair, 2 x 2048 rows of
# 200 pairs at 2,000 symbols/s)
VITERBI_STREAM_CASES = {"wide": (2048, 500, 64), "ragged": (45, 100, 64),
                        "block_below_lag": (3, 30, 64),
                        "decode": (33, 77, 0), "one_pair": (1, 1, 64),
                        "qpsk250k": (2048, 25_000, 64),
                        "bpsk2k": (4096, 200, 64), "no_pair": (5, 0, 64)}


def viterbi_soft(dev, B, T, seed=0):
    """Noisy non-integer soft pairs of a CCSDS-coded random stream, in
    [0, 255]."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bits = torch.randint(0, 2, (B, T), generator=g, device=dev,
                         dtype=torch.int64).to(torch.uint8)
    coded = conv_encode(CCSDS_K7, bits).float()
    soft = 128.0 + 90.0 * (2.0 * coded - 1.0) + 60.0 * torch.randn(
        coded.shape, generator=g, device=dev)
    return torch.clamp(soft, 0.0, 255.0).reshape(B, T, 2).contiguous()


@pytest.mark.parametrize("name", sorted(VITERBI_STREAM_CASES))
def test_viterbi_stream_kernel_equals_plain(cuda, name):
    """Two chained blocks: bits and the carried path metrics equal bit for
    bit to the plain loop's, one launch a block."""
    B, T, lag = VITERBI_STREAM_CASES[name]
    soft = viterbi_soft(cuda, B, 2 * T)
    pm = torch.zeros((B, 64), device=cuda)
    tail = torch.full((B, lag, 2), 128.0, device=cuda)
    for blk in range(2):
        sb = soft[:, blk * T:(blk + 1) * T].contiguous()
        kernel_paths.reset()
        pm1, bits = viterbi_stream_cuda.viterbi_stream(CCSDS_K7, pm, tail, sb)
        assert kernel_paths.launches(viterbi_stream_cuda.OP) == 1
        want_pm, want_bits = viterbi_stream_cuda.viterbi_stream_plain(
            CCSDS_K7, pm, tail, sb)
        assert torch.equal(bits, want_bits) and torch.equal(pm1, want_pm)
        pm = pm1
        tail = torch.cat([tail, sb], dim=1)[:, T:].contiguous()


@pytest.mark.parametrize("name", ["ragged", "decode", "one_pair", "wide",
                                  "block_below_lag", "no_pair"])
def test_viterbi_stream_redux_kernel_equals_plain(cuda, name):
    """viterbi_stream_redux_k7, the one-warp design with the class minima,
    kept for timing in turns: two chained blocks, bits and metrics equal
    bit for bit to the plain loop's."""
    B, T, lag = VITERBI_STREAM_CASES[name]
    soft = viterbi_soft(cuda, B, 2 * T)
    pm = torch.zeros((B, 64), device=cuda)
    tail = torch.full((B, lag, 2), 128.0, device=cuda)
    for blk in range(2):
        sb = soft[:, blk * T:(blk + 1) * T].contiguous()
        kernel_paths.reset()
        pm1, bits = viterbi_stream_cuda.viterbi_stream_redux(CCSDS_K7, pm,
                                                             tail, sb)
        assert kernel_paths.launches(viterbi_stream_cuda.OP_REDUX) == 1
        want_pm, want_bits = viterbi_stream_cuda.viterbi_stream_plain(
            CCSDS_K7, pm, tail, sb)
        assert torch.equal(bits, want_bits) and torch.equal(pm1, want_pm)
        pm = pm1
        tail = torch.cat([tail, sb], dim=1)[:, T:].contiguous()


@pytest.mark.parametrize("name", ["ragged", "decode", "one_pair", "wide"])
@pytest.mark.parametrize("polys", [(109, 79), (121, 91)])
def test_viterbi_stream_warp_kernel_equals_plain(cuda, name, polys):
    """viterbi_stream_warp_k7, the route of the other K=7 codes (and the
    CCSDS code's design before viterbi_stream_k7): two chained blocks,
    bits and metrics equal bit for bit to the plain loop's."""
    code = CCSDS_K7 if polys == (109, 79) else ConvCode(7, polys)
    B, T, lag = VITERBI_STREAM_CASES[name]
    soft = viterbi_soft(cuda, B, 2 * T)
    pm = torch.zeros((B, 64), device=cuda)
    tail = torch.full((B, lag, 2), 128.0, device=cuda)
    for blk in range(2):
        sb = soft[:, blk * T:(blk + 1) * T].contiguous()
        kernel_paths.reset()
        if polys == (109, 79):
            pm1, bits = viterbi_stream_cuda.viterbi_stream_warp(code, pm,
                                                                tail, sb)
        else:
            pm1, bits = viterbi_stream_cuda.viterbi_stream(code, pm, tail,
                                                           sb)
        assert kernel_paths.launches(viterbi_stream_cuda.OP_WARP) == 1
        want_pm, want_bits = viterbi_stream_cuda.viterbi_stream_plain(
            code, pm, tail, sb)
        assert torch.equal(bits, want_bits) and torch.equal(pm1, want_pm)
        pm = pm1
        tail = torch.cat([tail, sb], dim=1)[:, T:].contiguous()


# -- the redesigned QPSK-path rows: QpskMod's x2 and the FLL -------------------

# resample_x2_f32 at L 2 M 1 (name: (rows, block length, planes)):
# QpskMod's x2 at 2048 rows, a ragged tile, round and job, a block shorter
# than the tail, one real plane, the state alone
X2_CASES = {"qpsk_tx_up": (2048, 25_000, 2), "ragged": (3, 30_007, 2),
            "short": (3, 20, 2), "real": (5, 4_100, 1),
            "state_only": (3, 0, 2)}


@pytest.mark.parametrize("name", sorted(X2_CASES))
def test_resample_x2_matches_resample_poly(cuda, gen, name):
    """resample_x2_f32 with QpskMod's x2 taps (46 a phase) over two chained
    blocks, the tails read in place: one launch a block on the route,
    outputs and new state equal bit for bit to resample_poly_f32's on the
    same inputs, within 1e-5 of the plain version (the state equal)."""
    C, T, planes = X2_CASES[name]
    rs = QpskMod(125_000, lead_shape=(C,), device=cuda).up
    assert (rs.L, rs.M, rs.kp) == (2, 1, 46)
    assert cuda_resample.route(2, 1, rs.kp) == cuda_resample.X2_OP
    state = torch.randn((C, 2, rs.kp - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = [torch.randn((C, T), generator=gen, device=cuda)
              for _ in range(planes)]
        tails = (state[:, 0], state[:, 1])[:planes]
        kernel_paths.reset()
        new_state, got = resample_poly(xs, rs.poly_taps, 2, 1, tails)
        assert kernel_paths.report() == {cuda_resample.X2_OP: {
            "cuda": 1, "plain": 0,
            "shapes": {f"cuda L2 K46 D1 tail {planes}x{C}": 1}}}
        old_state, old = cuda_resample.launch(cuda_resample.OP, xs,
                                              rs.poly_taps, 2, 1, tails)
        want_state, want = resample_poly_plain(xs, rs.poly_taps, 2, 1, tails)
        assert torch.equal(new_state, old_state)
        assert torch.equal(new_state, want_state)
        for g, o in zip(got, old):
            assert torch.equal(g, o)
        if T:
            _assert_fir_close(got, want)
        state = new_state


def test_resample_x2_raises_off_its_shape(cuda):
    """No fallback: a launch of resample_x2_f32 at another L or M
    raises."""
    x, t = torch.zeros((2, 60), device=cuda), torch.zeros((2, 4),
                                                          device=cuda)
    for L, M in ((2, 5), (3, 1)):
        with pytest.raises(ValueError):
            cuda_resample.launch(cuda_resample.X2_OP, (x,),
                                 torch.zeros((L, 5), device=cuda), L, M,
                                 (t,))


def _fll_close(got, want):
    """y, phase, freq and tail within 2e-5 + 1e-5 |plain|, the phase as a
    distance on the circle."""
    for leaf, a, b in zip(("y", "phase", "freq", "tail"), got, want):
        if a.is_complex():
            a, b = torch.view_as_real(a), torch.view_as_real(b)
        d = (a.double() - b.double()).abs()
        if leaf == "phase":
            d = torch.minimum(d, 2 * np.pi - d)
        assert bool(torch.isfinite(a).all()), leaf
        assert bool((d <= 2e-5 + 1e-5 * b.double().abs()).all()), (
            leaf, float(d.max()))


# the FLL kernel (name: (chain, rows, block length, input kind)): QPSK250K's
# FLL and BPSK2K's at 2048 x 4,000 (sub-blocks of 500), a ragged row block
# with odd sub-blocks (1,001: 143), complex and real input
FLL_CASES = {"qpsk": ("qpsk", 2048, 4000, "pair"),
             "bpsk": ("bpsk", 2048, 4000, "pair"),
             "ragged": ("qpsk", 45, 1001, "pair"),
             "complex": ("qpsk", 33, 2000, "complex"),
             "real": ("bpsk", 7, 1000, "real")}


@pytest.mark.parametrize("name", sorted(FLL_CASES))
def test_fll_kernel_matches_plain(cuda, name):
    """Two chained blocks of a QPSK250K signal 1 kHz off (its first
    samples ~1e-20): FllBandEdge on the card is one fll_band_edge_f32
    launch a block and no other kernel; y and the state within the FLL's
    bound of the plain loop run from the kernel's state, and of the plain
    loop chained from its own state."""
    chain, C, T, kind = FLL_CASES[name]
    fll = (QpskDemod(125_000, 500_000, lead_shape=(C,), device=cuda) if
           chain == "qpsk" else BpskDemod(lead_shape=(C,), device=cuda)).fll
    x = qpsk_signal(cuda, C, 2 * T)
    sb = fll.sub_block_len(T)
    st = st_p = fll.init_state()
    for blk in range(2):
        xb = x[:, blk * T:(blk + 1) * T].contiguous()
        xr, xi = xb.real.contiguous(), xb.imag.contiguous()
        arg = {"pair": IqPair(xr, xi), "complex": xb, "real": xr}[kind]
        kernel_paths.reset()
        st_k, y = fll(st, arg)
        assert kernel_paths.report() == {cuda_fll.OP: {
            "cuda": 1, "plain": 0, "shapes": {f"cuda {C}x{T} sb{sb}": 1}}}
        for s0 in (st, st_p):
            want = cuda_fll.fll_plain(
                xr, torch.zeros_like(xr) if kind == "real" else xi, *s0,
                fll.taps, fll.beta, fll.max_freq, sb)
            _fll_close((y, *st_k), want)
        st, st_p = st_k, want[1:]


def test_fll_raises_without_its_kernel(cuda, monkeypatch, tmp_path):
    """No fallback on the card: a sub-block the kernel cannot stage raises,
    and so does a kernel that fails to build; the plain loop never runs."""
    fll = QpskDemod(125_000, 500_000, lead_shape=(2,), device=cuda).fll
    x = torch.zeros((2, 200_000), device=cuda)
    st = fll.init_state()
    kernel_paths.reset()
    with pytest.raises(ValueError):  # one sub-block of 200,000 samples
        cuda_fll.fll_band_edge(x, x, *st, fll.taps, fll.beta, fll.max_freq,
                               200_000)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(tmp_path / "nvcc"))
    with pytest.raises(OSError):
        fll(st, IqPair(x[:, :1000], x[:, :1000]))
    assert kernel_paths.report().get(cuda_fll.OP, {}).get("plain", 0) == 0


def test_cuda_mean_is_the_sum_times_the_f32_reciprocal(cuda, gen):
    """What fll_band_edge_f32 copies from the plain loop's torch.mean: on
    the card the mean over the last axis is the sum times the f32 of
    1/n (cuda_fll.inv_sb), not the sum divided by n."""
    x = torch.randn((2048, 500), generator=gen, device=cuda)
    assert torch.equal(x.mean(dim=-1),
                       x.sum(dim=-1) * cuda_fll.inv_sb(500))


# -- the M17 and DMR chains -----------------------------------------------

@pytest.mark.parametrize("kind", ["m17", "dmr"])
def test_fsk4_head_matches_plain(cuda, gen, kind):
    """The 3/125 head with the chain's taps (M17 K349 a phase, DMR K2091),
    64 rows, two chained blocks of 25,000, on its route: one
    resample_dec_f32 launch a block (DMR's ran fir_long_f32 once a phase,
    M17's resample_poly_f32, before it); outputs within 1e-5 of the plain
    version, the state equal; resample_poly_f32 and the per-phase route
    too."""
    rs = (M17Demod if kind == "m17" else DmrDemod)(
        lead_shape=(64,), device=cuda).resamp
    op = cuda_resample.route(3, 125, rs.kp, 64)
    assert op == cuda_resample.DEC_OP
    key = f"cuda L3 K{rs.kp} D125 tail 2x64"
    state = torch.randn((64, 2, rs.kp - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = [torch.randn((64, 25_000), generator=gen, device=cuda)
              for _ in range(2)]
        tails = (state[:, 0], state[:, 1])
        kernel_paths.reset()
        new_state, got = resample_poly(xs, rs.poly_taps, 3, 125, tails)
        assert kernel_paths.report() == {op: {
            "cuda": 1, "plain": 0, "shapes": {key: 1}}}
        want_state, want = resample_poly_plain(xs, rs.poly_taps, 3, 125,
                                               tails)
        _assert_fir_close(got, want)
        assert torch.equal(new_state, want_state)
        for other in (cuda_resample.resample_phases(
                xs, rs.poly_taps, 3, 125, tails), cuda_resample.launch(
                cuda_resample.OP, xs, rs.poly_taps, 3, 125, tails)):
            _assert_fir_close(other[1], want)
            assert torch.equal(other[0], want_state)
        state = new_state


# resample_dec_f32's instances: (L, M, K) -> the registry mode whose RX
# head it is (the L 1 heads, GMSK2K's and USB's, are launched directly: no
# resampler route gives them)
DEC_HEADS = {(3, 125, 2091): "DMR", (3, 125, 349): "M17",
             (12, 125, 523): "MMDVM", (2, 25, 105): "4FSK10KFM",
             (2, 25, 561): "2FSK10K", (1, 50, 2239): "GMSK2K",
             (1, 125, 5597): "USB"}


def _dec_head(shape, cuda):
    from qradiolink_tpu_torch.models import registry

    rs = registry.rx_chain(DEC_HEADS[shape], device=cuda).resamp
    assert (rs.L, rs.M, rs.kp) == shape
    return rs


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("rows,n_pp", [(3, 101), (1, 7)])
@pytest.mark.parametrize("shape", sorted(DEC_HEADS))
def test_resample_dec_matches_plain(cuda, gen, shape, rows, n_pp, planes):
    """resample_dec_f32 with the chain's taps over two chained blocks of
    n_pp output times (7: a block shorter than the state at K2091 and
    K2239): outputs within 1e-5 of the plain version, the new state (zeros
    in the im plane of one plane) equal to it; through resample_poly one
    resample_dec_f32 launch a block at the L > 1 shapes (the taps-in-order
    instance launched directly: at these rows the route gives
    resample_poly_f32)."""
    L, M, K = shape
    rs = _dec_head(shape, cuda)
    state = torch.randn((rows, 2, K - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = [torch.randn((rows, n_pp * M), generator=gen, device=cuda)
              for _ in range(planes)]
        tails = (state[:, 0], state[:, 1])[:planes]
        kernel_paths.reset()
        if L > 1 and shape not in cuda_resample.DEC_IN_ORDER:
            assert cuda_resample.route(L, M, K, rows) == \
                cuda_resample.DEC_OP
            new_state, got = resample_poly(xs, rs.poly_taps, L, M, tails)
            assert kernel_paths.report() == {cuda_resample.DEC_OP: {
                "cuda": 1, "plain": 0, "shapes": {
                    f"cuda L{L} K{K} D{M} tail {planes}x{rows}": 1}}}
        else:
            new_state, got = cuda_resample.launch(
                cuda_resample.DEC_OP, xs, rs.poly_taps, L, M, tails)
        want_state, want = resample_poly_plain(xs, rs.poly_taps, L, M, tails)
        _assert_fir_close(got, want)
        assert torch.equal(new_state, want_state)
        state = new_state


@pytest.mark.parametrize("shape", [(3, 125, 2091), (2, 25, 105)])
def test_resample_dec_reads_tails_in_place(cuda, gen, shape):
    """The tails read in place from the (C, 2, K-1) state's strided views
    and from contiguous copies, and x at a 16-byte boundary and one word
    off it (the 4-byte copies), give the same bits; the state is copied
    bit for bit, and a block of no samples leaves the state as it was."""
    L, M, K = shape
    rs = _dec_head(shape, cuda)
    C, T = 5, 67 * M
    state = torch.randn((C, 2, K - 1), generator=gen, device=cuda)
    xs = [torch.randn((C, T), generator=gen, device=cuda) for _ in range(2)]
    views = (state[:, 0], state[:, 1])
    got = cuda_resample.launch(cuda_resample.DEC_OP, xs, rs.poly_taps, L, M,
                               views)
    copies = tuple(t.contiguous() for t in views)
    off = []
    for x in xs:
        buf = torch.empty((C * T + 1,), device=cuda)
        off.append(buf[1:].view(C, T))
        off[-1].copy_(x)
    for args in ((xs, copies), (off, views)):
        other = cuda_resample.launch(cuda_resample.DEC_OP, args[0],
                                     rs.poly_taps, L, M, args[1])
        assert torch.equal(other[0], got[0])
        for a, b in zip(other[1], got[1]):
            assert torch.equal(a, b)
    want_state, _ = resample_poly_plain(xs, rs.poly_taps, L, M, views)
    assert torch.equal(got[0], want_state)
    empty = [torch.zeros((C, 0), device=cuda) for _ in range(2)]
    st0, ys0 = cuda_resample.launch(cuda_resample.DEC_OP, empty,
                                    rs.poly_taps, L, M, views)
    assert torch.equal(st0, state) and ys0[0].shape == (C, 0)


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("rows,n_pp,offset", [
    (2, 400, 0),      # the GMSK10K card test's blocks
    (37, 333, 1),     # ragged rows, x one word off: the 4-byte copies
    (256, 2000, 0),   # the sweep's rows
    (1, 5000, 0),     # one radio's block
    (3, 2, 0)])       # a block shorter than the state
def test_resample_dec_in_tap_order_equals_resample_poly(cuda, gen, rows,
                                                         n_pp, offset,
                                                         planes):
    """The taps-in-order instance (the 2/25 K561 head of 2FSK10K and
    GMSK10K) over two chained blocks: its outputs and new state equal
    resample_poly_f32's bit for bit (both add each output's taps in order
    from 0.0f, as the CPU path's F.conv1d gives them there)."""
    L, M, K = 2, 25, 561
    rs = _dec_head((L, M, K), cuda)
    state = torch.randn((rows, 2, K - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = []
        for _ in range(planes):
            buf = torch.randn((rows * n_pp * M + offset,), generator=gen,
                              device=cuda)
            xs.append(buf[offset:].view(rows, n_pp * M))
        tails = (state[:, 0], state[:, 1])[:planes]
        got = cuda_resample.launch(cuda_resample.DEC_OP, xs, rs.poly_taps,
                                   L, M, tails)
        want = cuda_resample.launch(cuda_resample.OP, xs, rs.poly_taps, L,
                                    M, tails)
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            assert torch.equal(a, b)
        state = got[0]


def test_resample_dec_raises_without_an_instance(cuda):
    """No fallback: a launch of resample_dec_f32 at an (L, M, K) it has no
    instance for raises; the route never sends one there."""
    x = torch.zeros((2, 250), device=cuda)
    taps = torch.zeros((3, 113), device=cuda)
    t = torch.zeros((2, 112), device=cuda)
    assert cuda_resample.route(3, 125, 113) == cuda_resample.OP
    with pytest.raises(ValueError):
        cuda_resample.launch(cuda_resample.DEC_OP, (x,), taps, 3, 125, (t,))


def test_resample_dec_l1_raises_at_other_shapes(cuda):
    """No fallback at L 1 either: resample_dec_f32 at a K or D it has no
    instance for raises, through cuda_resample.launch and through the
    strided FIR's launcher; a launch without the new state is
    resample_dec_f32's alone."""
    x = torch.zeros((2, 1000), device=cuda)
    t = torch.zeros((2, 1999), device=cuda)
    with pytest.raises(ValueError):
        cuda_resample.launch(cuda_resample.DEC_OP, (x,),
                             torch.zeros((1, 2000), device=cuda), 1, 50,
                             (t,))
    with pytest.raises(ValueError):
        cuda_fir._launch_dec((x,), torch.zeros(2000, device=cuda), 50, (t,))
    with pytest.raises(ValueError):
        cuda_resample.launch(cuda_resample.OP, (x,),
                             torch.zeros((2, 113), device=cuda), 2, 5,
                             (torch.zeros((2, 112), device=cuda),),
                             state=False)


@pytest.mark.parametrize("rows,T", [(2048, 20_000), (256, 100_000),
                                    (37, 100_050)])
def test_k2239_head_routed_equals_fir_long(cuda, gen, rows, T):
    """The K2239 D50 head as GMSK2K's chain runs it (its RationalResampler
    (1, 50) from the registry, IqPair blocks, the tails strided views of
    its state) over two chained blocks, at the path's rows, the sweep's
    and a ragged count: one launch of the routed resample_dec_f32 a block,
    its outputs bit-equal to fir_long_f32's on the same inputs and tails,
    the new state [tail | x]'s last K-1 samples."""
    from qradiolink_tpu_torch.models import registry

    rs = registry.rx_chain("GMSK2K", lead_shape=(rows,), device=cuda).resamp
    K, D = rs.kp, rs.M
    assert (rs.L, K, D) == (1, 2239, 50)
    assert cuda_fir.route(K, D) == cuda_fir.DEC_OP
    state = torch.randn((rows, 2, K - 1), generator=gen, device=cuda)
    for _ in range(2):
        x = IqPair(torch.randn((rows, T), generator=gen, device=cuda),
                   torch.randn((rows, T), generator=gen, device=cuda))
        kernel_paths.reset()
        new_state, y = rs(state, x)
        assert kernel_paths.report() == {cuda_fir.DEC_OP: {
            "cuda": 1, "plain": 0,
            "shapes": {f"cuda K{K} D{D} tail 2x{rows}": 1}}}
        want = cuda_fir.fir_long((x.re, x.im), rs.phase_taps[0], D, T // D,
                                 tails=(state[:, 0], state[:, 1]))
        assert torch.equal(y.re, want[0]) and torch.equal(y.im, want[1])
        assert torch.equal(new_state, torch.stack(
            [x.re[:, -(K - 1):], x.im[:, -(K - 1):]], dim=-2))
        state = new_state


@pytest.mark.parametrize("rows,T", [(2048, 20_000), (256, 200_000),
                                    (16, 200_000), (1, 200_125)])
def test_k5597_head_routed_equals_fir_long(cuda, gen, rows, T):
    """SSB's K5597 D125 head as USB's chain runs it (its RationalResampler
    (1, 125) from the registry, IqPair blocks, the tails strided views of
    its state) over two chained blocks, at the SSB path's rows, the
    sweep's, 16 and one radio's (a ragged last chunk): one launch of the
    routed resample_dec_f32 a block, its outputs bit-equal to
    fir_long_f32's on the same inputs and tails, the new state [tail |
    x]'s last K-1 samples."""
    from qradiolink_tpu_torch.models import registry

    rs = registry.rx_chain("USB", lead_shape=(rows,), device=cuda).resamp
    K, D = rs.kp, rs.M
    assert (rs.L, K, D) == (1, 5597, 125)
    assert cuda_fir.route(K, D) == cuda_fir.DEC_OP
    state = torch.randn((rows, 2, K - 1), generator=gen, device=cuda)
    for _ in range(2):
        x = IqPair(torch.randn((rows, T), generator=gen, device=cuda),
                   torch.randn((rows, T), generator=gen, device=cuda))
        kernel_paths.reset()
        new_state, y = rs(state, x)
        assert kernel_paths.report() == {cuda_fir.DEC_OP: {
            "cuda": 1, "plain": 0,
            "shapes": {f"cuda K{K} D{D} tail 2x{rows}": 1}}}
        want = cuda_fir.fir_long((x.re, x.im), rs.phase_taps[0], D, T // D,
                                 tails=(state[:, 0], state[:, 1]))
        assert torch.equal(y.re, want[0]) and torch.equal(y.im, want[1])
        assert torch.equal(new_state, torch.stack(
            [x.re[:, -(K - 1):], x.im[:, -(K - 1):]], dim=-2))
        state = new_state


@pytest.mark.parametrize("L,K,T", [(4, 12, 12_500), (2, 46, 50_000),
                                   (6, 45, 800)])
def test_resample_few_rows_on_resample_poly(cuda, gen, L, K, T):
    """At one row the interpolators L <= 6, M 1 launch resample_poly_f32
    (the route's few-row rule), bit-equal to the kernel many rows take."""
    rs = RationalResampler(L, 1, taps=torch.randn((L * K,), generator=gen,
                                                  device=cuda).cpu().numpy(),
                           lead_shape=(1,), device=cuda)
    assert rs.kp == K
    many = cuda_resample.route(L, 1, K)
    assert many in (cuda_resample.UP_OP, cuda_resample.X2_OP)
    xs = [torch.randn((1, T), generator=gen, device=cuda) for _ in range(2)]
    st = torch.randn((1, 2, K - 1), generator=gen, device=cuda)
    tails = (st[:, 0], st[:, 1])
    kernel_paths.reset()
    got = resample_poly(xs, rs.poly_taps, L, 1, tails)
    assert kernel_paths.launches(cuda_resample.OP) == 1
    other = cuda_resample.launch(many, xs, rs.poly_taps, L, 1, tails)
    for a, b in zip((got[0], *got[1]), (other[0], *other[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["m17", "dmr"])
def test_fsk4_symbol_sync_equals_plain(cuda, gen, kind):
    """The chain's M&M loop in levels mode on real input at sps 5 (M17's
    gains and DMR's, the largest of the JAX chains), 2048 rows, two
    chained blocks of 4,800 (a path step at 24 ksps): symbols and every
    state leaf equal to the plain loop's, one launch a block."""
    ss = (M17Demod if kind == "m17" else DmrDemod)(
        lead_shape=(2048,), device=cuda).symbol_sync
    lv = ss.levels[torch.randint(0, 4, (2048, 1921), generator=gen,
                                 device=cuda)]
    x = torch.nn.functional.avg_pool1d(
        torch.repeat_interleave(lv, 5, dim=-1)[:, None], 5, 1)[:, 0, :9600]
    x = x + 0.05 * torch.randn(x.shape, generator=gen, device=cuda)
    m = cuda_symbol_sync.mode_of(False, ss.levels)
    assert m == cuda_symbol_sync.MODE_LEVELS
    st = ss.init_state()
    for blk in range(2):
        xb = x[:, blk * 4800:(blk + 1) * 4800].contiguous()
        pos, omega, yp, dp, tail = st
        args = (tail, xb, pos, omega, yp, dp, 960, m, ss.levels, ss.sps,
                ss.alpha, ss.beta, ss.omega_limit, ss.ted_norm)
        kernel_paths.reset()
        got = cuda_symbol_sync.symbol_sync(*args)
        assert kernel_paths.launches(cuda_symbol_sync.OP) == 1
        xc = torch.cat([tail, xb.to(torch.complex64)], dim=-1)
        want = cuda_symbol_sync.symbol_sync_plain(
            xc.real.contiguous(), xc.imag.contiguous(), *args[2:])
        assert torch.equal(got[0].real, want[0])
        assert torch.equal(got[0].imag, want[1])
        for a, b in zip(got[1:], want[2:]):
            assert torch.equal(a, b)
        st, _ = ss(st, xb)


# the M17 and DMR TX interpolators: name: (chain, attribute, planes, T)
FSK4_TX_CASES = {"m17_shaper": (M17Mod, "shaper", 1, 960),
                 "m17_up": (M17Mod, "up", 2, 4800),
                 "dmr_shaper": (DmrMod, "shaper", 1, 960),
                 "dmr_up": (DmrMod, "up", 2, 4800)}


@pytest.mark.parametrize("name", sorted(FSK4_TX_CASES))
def test_fsk4_tx_interpolator_matches_plain(cuda, gen, name):
    """The chain's 5/1 shaper or 125/3 interpolator at 2048 rows, a path
    step, two chained blocks: one resample_up_f32 launch a block, outputs
    and state equal bit for bit to resample_poly_f32's, within 1e-5 of the
    plain version (the state equal to it)."""
    Mod, attr, planes, T = FSK4_TX_CASES[name]
    rs = getattr(Mod(lead_shape=(2048,), device=cuda), attr)
    L, M = rs.L, rs.M
    assert cuda_resample.route(L, M, rs.kp) == cuda_resample.UP_OP
    state = torch.randn((2048, 2, rs.kp - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = [torch.randn((2048, T), generator=gen, device=cuda)
              for _ in range(planes)]
        tails = (state[:, 0], state[:, 1])[:planes]
        kernel_paths.reset()
        new_state, got = resample_poly(xs, rs.poly_taps, L, M, tails)
        assert kernel_paths.launches(cuda_resample.UP_OP) == 1
        old_state, old = cuda_resample.launch(cuda_resample.OP, xs,
                                              rs.poly_taps, L, M, tails)
        want_state, want = resample_poly_plain(xs, rs.poly_taps, L, M,
                                               tails)
        assert torch.equal(new_state, old_state)
        assert torch.equal(new_state, want_state)
        for g, o in zip(got, old):
            assert torch.equal(g, o)
        _assert_fir_close(got, want)
        state = new_state


def test_dmr_mask_zeroes_idle_slot_on_card(cuda, gen):
    """DmrMod on the card with a mask zeroing one 720-sample slot in three
    at 24 ksps (IqPair and complex output): the zeroed slot's middle
    10,000 samples at 1 Msps carry under 1e-3 of an open slot's power, and
    the two outputs agree."""
    bits = torch.randint(0, 2, (4, 9600), generator=gen, device=cuda,
                         dtype=torch.int64).to(torch.uint8)
    t = torch.arange(24_000, device=cuda)
    mask = ((t // 720) % 3 != 1).float()
    outs = {}
    for pair in (False, True):
        mod = DmrMod(lead_shape=(4,), pair=pair, device=cuda)
        outs[pair] = mod(mod.init_state(), bits, mask=mask)[1]["iq"]
    iq = outs[False]
    assert torch.equal(outs[True].re, iq.real)
    assert torch.equal(outs[True].im, iq.imag)

    def power(slot):
        mid = (slot * 720 + 360) * 125 // 3
        return float((iq[:, mid - 5000:mid + 5000].abs() ** 2).mean())

    for slot in (1, 4, 7):
        assert power(slot) < 1e-3 * power(slot + 1), slot


FSK4_CHAINS = {"m17": (M17Mod, M17Demod), "m17_ff": (M17Mod, M17DemodFF),
               "dmr": (DmrMod, DmrDemod), "dmr_ff": (DmrMod, DmrDemodFF)}


@pytest.mark.parametrize("name", sorted(FSK4_CHAINS))
def test_fsk4_chain_on_card_matches_cpu(cuda, gen, name):
    """The modulator's IQ (2 rows, seeded bits) with noise at 0.05 a
    plane, two blocks of 25,000 samples, through the demodulator on the
    card and on the CPU: bits equal; symbols, soft and every state leaf
    within 2e-5 of their peak (the FIRs' sums round apart on the two);
    the modulator's IQ on the card and the CPU within 1e-5."""
    Mod, Demod = FSK4_CHAINS[name]
    cpu = torch.device("cpu")
    bits = torch.randint(0, 2, (2, 480), generator=gen, device=cuda,
                         dtype=torch.int64).to(torch.uint8)
    iqs = {}
    for d in (cuda, cpu):
        mod = Mod(lead_shape=(2,), device=d)
        iqs[d.type] = mod(mod.init_state(), bits.to(d))[1]["iq"]
    _assert_peak_close(torch.view_as_real(iqs["cuda"]).cpu(),
                       torch.view_as_real(iqs["cpu"]), what="iq")
    iq = iqs["cuda"] + 0.05 * torch.randn(iqs["cuda"].shape, generator=gen,
                                          device=cuda, dtype=torch.complex64)
    chains = {d.type: Demod(lead_shape=(2,), device=d) for d in (cuda, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    for blk in range(2):
        xb = iq[:, blk * 25_000:(blk + 1) * 25_000]
        outs = {}
        for d in (cuda, cpu):
            x = IqPair(xb.real.to(d).contiguous(), xb.imag.to(d).contiguous())
            states[d.type], outs[d.type] = chains[d.type](states[d.type], x)
        assert torch.equal(outs["cuda"]["bits"].cpu(), outs["cpu"]["bits"])
        for k in ("symbols", "soft"):
            if k in outs["cpu"]:
                _assert_peak_close(outs["cuda"][k].cpu(), outs["cpu"][k],
                                   rtol=2e-5, what=k)
        for i, (a, b) in enumerate(zip(_flatten(states["cuda"], []),
                                       _flatten(states["cpu"], []))):
            _assert_peak_close(a.cpu(), b, rtol=2e-5, what=f"state leaf {i}")



# -- slice 6: the FFT form, MMDVMmulti's K4/K5 shapes, the new modes --------
@pytest.mark.parametrize("K,complex_taps,complex_in,decim", [
    (963, True, True, 1), (167, True, False, 1), (133, True, True, 1),
    (101, False, False, 2)])
def test_fft_fir_on_card_matches_cpu(cuda, gen, K, complex_taps, complex_in,
                                     decim):
    """FirFilter(impl="fft") on the card against the same filter on the
    CPU, 8 rows x two blocks of 4,000: outputs within 1e-5 of the peak, the
    states equal; and within 1e-3 of the direct kernels' output on the
    card (tests/test_fir.py's FFT-against-direct bound)."""
    rng = np.random.default_rng(K)
    taps = rng.standard_normal(K) + (1j * rng.standard_normal(K)
                                     if complex_taps else 0)
    taps = taps.astype(np.complex64 if complex_taps else np.float32)
    cpu = torch.device("cpu")
    blks = {d.type: FirFilter(taps, decim, impl="fft", lead_shape=(8,),
                              device=d) for d in (cuda, cpu)}
    direct = FirFilter(taps, decim, impl="conv", lead_shape=(8,),
                       device=cuda)
    states = {k: b.init_state() for k, b in blks.items()}
    ds = direct.init_state()
    for _ in range(2):
        x = torch.randn((8, 4000), generator=gen, device=cuda)
        if complex_in:
            x = torch.complex(x, torch.randn((8, 4000), generator=gen,
                                             device=cuda))
        kernel_paths.reset()
        states["cuda"], y = blks["cuda"](states["cuda"], x)
        assert kernel_paths.launches("torch_fft_fir") == 1
        states["cpu"], yc = blks["cpu"](states["cpu"], x.cpu())
        ds, yd = direct(ds, x)
        assert torch.equal(states["cuda"].cpu(), states["cpu"])
        assert torch.equal(states["cuda"], ds)
        to_np = (lambda v: torch.view_as_real(v).cpu().numpy()
                 if v.is_complex() else v.cpu().numpy())
        _assert_peak_close(to_np(y), to_np(yc), what="card vs CPU")
        _assert_peak_close(to_np(y), to_np(yd), rtol=1e-3,
                           what="fft vs direct")


def test_mmdvm_multi_kernels_match_plain(cuda, gen):
    """MmdvmMultiRx's channelizer (M 10, kp 56) on pfb_fft_f32 over two
    chained blocks of 250,000 IqPair samples within 1e-5 of the plain
    version's peak, and pfb_channelize_f32, which served it before, within
    the same bound; its raw history carried bit-equal. MmdvmMultiTx's
    synthesizer branch FIRs (10 rows, kp 53, tails in place) on
    depthwise_run_f32 within the FIR's bound of the plain version and equal
    bit for bit to depthwise_fir_f32 on the concatenation."""
    from qradiolink_tpu_torch.chains.mmdvm import MmdvmMultiRx, MmdvmMultiTx

    ch = MmdvmMultiRx(device=cuda).channelizer
    M, kp = ch.M, ch.kp
    assert (M, kp, cuda_pfb.route(M, kp)) == (10, 56, cuda_pfb.FFT_OP)
    state = ch.init_state()
    for _ in range(2):
        x = IqPair(torch.randn((250_000,), generator=gen, device=cuda) * 0.1,
                   torch.randn((250_000,), generator=gen, device=cuda) * 0.1)
        kernel_paths.reset()
        new_state, y = ch(state, x)
        assert kernel_paths.launches(cuda_pfb.FFT_OP) == 1
        assert kernel_paths.launches(cuda_pfb.OP) == 0
        want = channelize_plain((x.re, x.im), state, ch._ct)
        old = cuda_pfb._launch((x.re, x.im), state, ch._ct, ch._dft)
        peak = max(float(w.abs().max()) for w in want)
        for g, o, w in zip((y.re, y.im), old, want):
            assert float((g - w).abs().max()) <= 1e-5 * peak
            assert float((o - w).abs().max()) <= 1e-5 * peak
        assert torch.equal(new_state, torch.cat(
            [state, torch.stack([x.re, x.im])], -1)[..., -kp * M:])
        state = new_state
    syn = MmdvmMultiTx(device=cuda).synthesizer
    tf = syn._bt_flipped
    C, kps = tf.shape
    assert (C, kps, cuda_depthwise.route(kps)) == (10, 53,
                                                   cuda_depthwise.RUN_OP)
    st = torch.randn((2, C, kps - 1), generator=gen, device=cuda)
    for _ in range(2):
        xs = [torch.randn((C, 25_000), generator=gen, device=cuda)
              for _ in range(2)]
        kernel_paths.reset()
        new_st, vr, vi = syn._branches(st, *xs)
        assert kernel_paths.launches(cuda_depthwise.RUN_OP) == 1
        assert kernel_paths.launches(cuda_depthwise.OP) == 0
        tails = (st[0], st[1])
        _assert_fir_close((vr, vi), depthwise_fir_plain(xs, tf, 25_000,
                                                        tails))
        for g, o in zip((vr, vi), _depthwise_old(xs, tf, 25_000, tails)):
            assert torch.equal(g, o)
        st = new_st


# the new modes: registry name -> (RX block length at 1 Msps or 250 ksps,
# TX input: ("bytes", n) | ("audio", n) | ("key", n))
NEW_MODES = {
    "4FSK2K": (25_000, ("bytes", 13)), "4FSK2KFB": (25_000, ("bytes", 13)),
    "4FSK1KFM": (25_000, ("bytes", 13)), "4FSK10KFM": (25_000, ("bytes", 63)),
    "4FSK100K": (10_000, ("bytes", 260)), "2FSK2K": (25_000, ("bytes", 7)),
    "2FSK1K": (50_000, ("bytes", 7)), "2FSK10K": (10_000, ("bytes", 30)),
    "2FSK2KFB": (25_000, ("bytes", 7)), "2FSK1KFB": (50_000, ("bytes", 7)),
    "GMSK2K": (25_000, ("bytes", 7)), "GMSK1K": (50_000, ("bytes", 7)),
    "GMSK10K": (10_000, ("bytes", 30)),
    "BPSKDSSS8": (250_000, ("bytes", 1)),
    "FreeDV1600USB": (25_000, ("audio", 400)),
    "FreeDV700DLSB": (25_000, ("audio", 400)),
    "MMDVM": (25_000, ("audio", 4800)),
    "MMDVMmulti": (25_000, ("audio", 4800)),
    "CW": (None, ("key", 800)),
}


def _chain_blocks(chain):
    """The FIR and resampler blocks of a chain, nested chains and filter
    banks included."""
    from qradiolink_tpu_torch.ops.fir import FirFilter as Fir

    out = []
    for v in vars(chain).values():
        for b in (v if isinstance(v, list) else [v]):
            if isinstance(b, (Fir, RationalResampler)):
                out.append(b)
            elif hasattr(b, "blocks") and b is not chain:
                out += _chain_blocks(b)
    return out


def _lead(mode, rows):
    return {} if mode == "MMDVMmulti" else {"lead_shape": (rows,)}


@pytest.mark.parametrize("mode", sorted(NEW_MODES))
def test_new_mode_blocks_on_card_match_cpu(cuda, gen, mode):
    """Every FIR and resampler block of the mode's RX and TX chains on the
    card against the same block on the CPU, on seeded IqPair input of 8 (or
    the chain's channel count of) rows x two blocks (a multiple of its
    decimation): outputs within the FIR's bound of the plain version, the
    new state equal (the FFT form within 1e-5 of the peak)."""
    from qradiolink_tpu_torch.models import registry
    from qradiolink_tpu_torch.ops.fir import FirFilter as Fir

    cpu = torch.device("cpu")
    spec = registry.get_mode(mode)
    pairs = []
    for fac in (spec.rx_factory, spec.tx_factory):
        if fac is None:
            continue
        made = [_chain_blocks(fac(**_lead(mode, 8), device=d))
                for d in (cuda, cpu)]
        pairs += list(zip(*made))
    assert pairs
    for bc, bh in pairs:
        rows = bc.lead_shape or (1,)
        M = bc.M if isinstance(bc, RationalResampler) else bc.decim
        T = 4000 - 4000 % M
        sc, sh = bc.init_state(), bh.init_state()
        for _ in range(2):
            x = IqPair(*(torch.randn(tuple(rows) + (T,), generator=gen,
                                     device=cuda) for _ in range(2)))
            sc, yc = bc(sc, x)
            sh, yh = bh(sh, IqPair(x.re.cpu(), x.im.cpu()))
            what = f"{type(bc).__name__} K{getattr(bc, 'ntaps', None)}"
            if isinstance(bc, Fir) and bc.impl == "fft":
                _assert_peak_close(yc.re.cpu(), yh.re, what=what)
                _assert_peak_close(yc.im.cpu(), yh.im, what=what)
            else:
                _assert_fir_close((yc.re.cpu(), yc.im.cpu()), (yh.re, yh.im))
            assert torch.equal(sc.cpu(), sh), what


def _tx_input(kind, n, rows, gen, cuda):
    if kind == "bytes":
        return torch.randint(0, 256, (rows, n), generator=gen, device=cuda,
                             dtype=torch.int64).to(torch.uint8)
    if kind == "key":
        return (torch.arange(n, device=cuda) % 400 < 150).float().expand(
            rows, n).contiguous()
    t = torch.arange(n, device=cuda) / 8000.0
    return (0.3 * torch.sin(2 * np.pi * 700.0 * t)
            + 0.05 * torch.randn((rows, n), generator=gen, device=cuda))


def _cmp(a, b, rtol, what):
    if isinstance(a, IqPair):
        a, b = torch.stack([a.re, a.im]), torch.stack([b.re, b.im])
    a = a.cpu()
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    if not a.is_floating_point():
        assert torch.equal(a, b), what
        return
    _assert_peak_close(a.numpy(), b.numpy(), rtol=rtol, what=what)


@pytest.mark.parametrize("mode", sorted(NEW_MODES))
def test_new_mode_on_card_matches_cpu(cuda, gen, mode):
    """The mode's TX chain on 2 rows (7 carriers for MMDVMmulti) of seeded
    input on the card and on the CPU: IQ within 2e-4 of its peak. Its RX
    chain on that IQ with noise at 0.05 a plane, two blocks, card and CPU:
    bits equal; symbols within 1e-3 of their peak, every state leaf within
    2e-5 of its peak (the carried FM and carrier phases as distances on the
    circle); FreeDV's passband and MMDVM's audio within 1e-5."""
    from qradiolink_tpu_torch.models import registry

    T, (kind, n) = NEW_MODES[mode]
    rows = 7 if mode == "MMDVMmulti" else 2
    cpu = torch.device("cpu")
    lead = _lead(mode, rows)
    x = _tx_input(kind, n, rows, gen, cuda)
    iqs = {}
    for d in (cuda, cpu):
        tx = registry.tx_chain(mode, device=d, **lead)
        iqs[d.type] = tx(tx.init_state(), x.to(d))[1]["iq"]
    _cmp(iqs["cuda"], iqs["cpu"], 2e-4, f"{mode} iq")
    if T is None:
        return
    iq = iqs["cuda"]
    iq = iq.to_complex() if isinstance(iq, IqPair) else iq
    if mode == "MMDVMmulti":
        iq = iq.reshape(1, -1)
    iq = iq[..., :2 * T]
    iq = iq + 0.05 * torch.randn(iq.shape, generator=gen, device=cuda,
                                 dtype=torch.complex64)
    if mode == "MMDVMmulti":
        iq = iq[0]
    chains = {d.type: registry.rx_chain(mode, device=d, **(
        {} if mode == "MMDVMmulti" else {"lead_shape": (rows,)}))
        for d in (cuda, cpu)}
    states = {k: c.init_state() for k, c in chains.items()}
    float_tol = 1e-5 if mode.startswith(("FreeDV", "MMDVM")) else 1e-3
    for blk in range(2):
        xb = iq[..., blk * T:(blk + 1) * T]
        outs = {}
        for d in (cuda, cpu):
            xp = IqPair(xb.real.to(d).contiguous(), xb.imag.to(d).contiguous())
            states[d.type], outs[d.type] = chains[d.type](states[d.type], xp)
        for k, v in outs["cpu"].items():
            _cmp(outs["cuda"][k], v, 1e-4 if k == "rssi" or k == "rssi_slots"
                 else float_tol, f"{mode} block {blk} {k}")
        for i, (a, b) in enumerate(zip(_flatten(states["cuda"], []),
                                       _flatten(states["cpu"], []))):
            a = a.cpu()
            if a.is_complex():
                a, b = torch.view_as_real(a), torch.view_as_real(b)
            if not a.is_floating_point():
                assert torch.equal(a, b), f"{mode} state leaf {i}"
                continue
            d = (a.double() - b.double()).abs()
            d = torch.minimum(d, (d - 2 * np.pi).abs())
            peak = max(float(b.abs().max()) if b.numel() else 0.0, 1e-30)
            assert float(d.max()) <= 2e-5 * max(peak, 1.0), \
                f"{mode} block {blk} state leaf {i}"
