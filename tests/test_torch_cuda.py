"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. This file imports
neither jax nor the JAX package, so it also runs where those are not
installed; run it on a machine with a card with

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -q

(--noconftest: tests/conftest.py imports jax). Tolerances: the FIR within
1e-5 (relative to the output's peak, and elementwise 1e-5 + 1e-5 |plain|),
the bound the JAX package holds its FIR kernels to; the Viterbi bit-exact.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu_torch.chains.fsk import Fsk4DemodFF  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.fec.conv import CCSDS_K7  # noqa: E402
from qradiolink_tpu_torch.fec.viterbi_cuda import (  # noqa: E402
    decode_windows, decode_windows_plain)
from qradiolink_tpu_torch.ops.cuda_fir import (  # noqa: E402
    fir_stream, fir_stream_plain)
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
    assert kernel_paths.launches("fir_stream_f32") == 1
    ref = fir_stream_plain(xs, tf, D, n_out, tails=tails, shift=shift)
    for g, r in zip(got, ref):
        diff = (g - r).abs()
        assert float(diff.max() / r.abs().max()) <= 1e-5
        assert bool((diff <= 1e-5 + 1e-5 * r.abs()).all())


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
