"""The DSSS BPSK chains and CwMod of the port (chains/dsss.py) against their
JAX twins on the CPU, and the port's own DSSS loopback and CW keying, at
the JAX tests' thresholds (tests/test_chains_dsss_cw.py).

DsssBpskDemod is fed the port's DsssBpskMod IQ (2 rows, one seeded byte,
noise at 0.05 a plane) as complex blocks of 250,000 samples (4 coded bits:
a multiple of 62,500 holding whole soft pairs), two blocks. Its K599
matched filter runs as an FFT in the JAX chain on the CPU and in direct
form in the port's, so it is compared twice ("direct": the JAX matched
filter in direct form and a ~1e-20 start; "fft": the JAX chain as it is),
as tests/test_torch_m17.py does: the four bit streams equal, the symbols,
rssi and every state leaf within 5e-6 (1 + peak) (measured 1.2e-6).
The modulators: IQ and every state leaf within 2e-6 (measured 5.7e-7).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.chains import dsss as jdsss  # noqa: E402
from qradiolink_tpu_torch.chains import dsss  # noqa: E402
from qradiolink_tpu_torch.chains.digital_common import (  # noqa: E402
    bytes_to_bits)
from tests.test_torch_sync_loops import NEAR_BOUND  # noqa: E402
from tests.torch_parity import (direct_firs, stream_both,  # noqa: E402
                                to_numpy)

RX_TOL = 5e-6
TX_TOL = 2e-6
BLOCK = 250_000


@pytest.mark.parametrize("variant", ["direct", "fft"])
def test_demod_matches_jax(variant):
    rng = np.random.default_rng(3)
    mod = dsss.DsssBpskMod(lead_shape=(2,), device="cpu")
    data = rng.integers(0, 256, (2, 1)).astype(np.uint8)
    iq = to_numpy(mod(mod.init_state(), torch.from_numpy(data))[1]["iq"])
    noise = rng.standard_normal((2, 2, 2 * BLOCK))
    iq = iq[:, :2 * BLOCK] + 0.05 * (noise[0] + 1j * noise[1])
    iq = iq.astype(np.complex64)
    jax_demod = jdsss.DsssBpskDemod(lead_shape=(2,))
    if variant == "direct":
        iq[:, :200] *= 1e-20
        jax_demod = direct_firs(jax_demod)
    stream_both(jax_demod, dsss.DsssBpskDemod(lead_shape=(2,),
                                              device="cpu"),
                np.split(iq, 2, axis=-1), RX_TOL, RX_TOL, peak=True)


def test_mod_matches_jax(rng):
    data = rng.integers(0, 256, (2, 2)).astype(np.uint8)
    stream_both(jdsss.DsssBpskMod(lead_shape=(2,)),
                dsss.DsssBpskMod(lead_shape=(2,), device="cpu"),
                np.split(data, 2, axis=-1), TX_TOL, TX_TOL, peak=True)


def test_cw_mod_matches_jax():
    """A keying pattern at 8 kHz, 2 rows x two blocks of 8,000: IQ and the
    state leaves (key filter, SsbMod, the tone's phase) within TX_TOL."""
    key = (np.arange(16_000) % 4_000 < 1_500).astype(np.float32)
    key = np.stack([key, np.roll(key, 700)])
    stream_both(jdsss.CwMod(lead_shape=(2,)),
                dsss.CwMod(lead_shape=(2,), device="cpu"),
                np.split(key, 2, axis=-1), TX_TOL, TX_TOL, peak=True,
                wrap_phase=True)


def test_costas_at_dsss_rate_takes_the_exact_wrap():
    """DsssBpskDemod's CostasLoop(pi/200, 2) at 5.2 ksps keeps max_freq +
    |alpha| within the kernel's exact-select bound (test_wrap_select_bound
    in tests/test_torch_sync_loops.py)."""
    c = dsss.DsssBpskDemod(device="cpu").costas_freq
    assert c.max_freq + abs(c.alpha) <= NEAR_BOUND


def best_ber(decoded, sent, max_offset=200):
    """tests/test_chains_dsss_cw.best_ber: min BER over alignments on
    [n/4, n/2)."""
    n = len(sent)
    lo, hi = n // 4, n // 2
    best = 1.0
    for off in range(max_offset):
        seg = decoded[off + lo: off + hi]
        if len(seg) < hi - lo:
            break
        best = min(best, float(np.mean(seg != sent[lo:hi])))
    return best


def test_dsss_clean_loopback():
    """tests/test_chains_dsss_cw.py's clean loopback on the port: 24 bytes
    (384 coded bits, 24 s at 1 Msps), the best of the four streams below
    1% BER."""
    data = np.random.default_rng(4).integers(0, 256, 24).astype(np.uint8)
    mod, dem = dsss.DsssBpskMod(device="cpu"), dsss.DsssBpskDemod(
        device="cpu")
    iq = mod(mod.init_state(), torch.from_numpy(data))[1]["iq"]
    m = iq.shape[-1] - iq.shape[-1] % 125_000
    out = dem(dem.init_state(), iq[:m])[1]
    sent = bytes_to_bits(torch.from_numpy(data)).numpy()
    ber = min(best_ber(out[k].numpy(), sent)
              for k in ("bits", "bits_alt", "bits_inv", "bits_alt_inv"))
    assert ber < 0.01, f"DSSS clean BER {ber}"


def test_cw_keying():
    """tests/test_chains_dsss_cw.py's keying envelope on the port: the
    power during a key-down 100 times the power after key-up."""
    n = 8000
    key = np.zeros(n, np.float32)
    key[1000:3000] = 1.0
    key[5000:5500] = 1.0
    cw = dsss.CwMod(device="cpu")
    iq = cw(cw.init_state(), torch.from_numpy(key))[1]["iq"].numpy()
    up = len(iq) / n
    on = np.mean(np.abs(iq[int(1500 * up):int(2500 * up)]) ** 2)
    off = np.mean(np.abs(iq[int(3700 * up):int(4700 * up)]) ** 2)
    assert on > 100 * max(off, 1e-12)
