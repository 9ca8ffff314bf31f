"""Make the frozen QPSK250K capture tests/fixtures/iq_qpsk250k_10db.npz.

    JAX_PLATFORMS=cpu python scripts/make_qpsk_capture.py

Made the way tests/fixtures/iq_4fsk2k_-6db.npz was: the JAX package's own
transmitter, here `QpskMod(125_000)` (the QPSK250K waveform: differential
QPSK at 125,000 symbols/s, RRC at 4 samples a symbol, then x2 to 1 Msps),
on 1,250 payload bytes from a fixed seed; a 1 kHz carrier offset; complex
white noise at 10 dB below the signal's mean power (SNR 10 dB over the
full 1 MHz band); IQ quantized to float16. The 80,000 samples stream as two
blocks of 40,000, a multiple of the receiver's decimation of 2. The file
holds the IQ planes (`iq_re`, `iq_im`, float16) and the payload (`payload`,
uint8); it is about 0.3 MB.
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qradiolink_tpu.chains.psk import QpskMod  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "iq_qpsk250k_10db.npz"
N_BYTES = 1_250          # 10,000 bits: 80,000 IQ samples at 1 Msps
SNR_DB = 10.0            # signal to noise over the full 1 MHz band, dB
OFFSET_HZ = 1_000.0
SEED = 20_261_018


def main():
    rng = np.random.default_rng(SEED)
    payload = rng.integers(0, 256, N_BYTES).astype(np.uint8)
    mod = QpskMod(125_000)
    _, out = mod(mod.init_state(), jnp.asarray(payload))
    iq = np.asarray(out["iq"]).astype(np.complex64)
    n = np.arange(iq.shape[0])
    iq = iq * np.exp(2j * np.pi * OFFSET_HZ / 1e6 * n)
    p_sig = float(np.mean(np.abs(iq) ** 2))
    sigma = np.sqrt(p_sig * 10 ** (-SNR_DB / 10) / 2)
    iq = iq + sigma * (rng.standard_normal(iq.shape)
                       + 1j * rng.standard_normal(iq.shape))
    np.savez_compressed(OUT, iq_re=iq.real.astype(np.float16),
                        iq_im=iq.imag.astype(np.float16), payload=payload)
    print(f"{OUT.relative_to(ROOT)}: {iq.shape[0]} IQ samples, signal "
          f"power {p_sig:.3e}, noise sigma {sigma:.3e} a plane, "
          f"{OUT.stat().st_size} bytes")


if __name__ == "__main__":
    main()
