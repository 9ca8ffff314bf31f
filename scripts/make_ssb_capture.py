"""Make the frozen SSB capture tests/fixtures/iq_ssb_usb_-10db.npz.

    JAX_PLATFORMS=cpu python scripts/make_ssb_capture.py

The capture is made the way tests/fixtures/iq_4fsk2k_-6db.npz was: the JAX
package's own transmitter, AWGN from a fixed seed, IQ quantized to
float16. Here the transmitter is `SsbMod(usb=True)` (filter width 2,700 Hz)
on 0.2 s of voice-like audio at 8 ksps: two tones, 700 and 1,900 Hz, under
a 4 Hz syllabic envelope. Its 1 Msps IQ (200,000 samples, two blocks of
100,000, a multiple of the receiver's decimation of 125) gets complex white
noise at 10 dB above the signal's mean power over the full 1 MHz band
(SNR -10 dB), which leaves the signal about 15 dB above the noise in its
2.7 kHz audio band. The file holds the IQ planes (`iq_re`, `iq_im`,
float16) and the source audio (`audio`, float32); it is about 0.75 MB.
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qradiolink_tpu.chains.ssb import SsbMod  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "iq_ssb_usb_-10db.npz"
AUDIO_RATE = 8_000
N_AUDIO = 1_600          # 0.2 s; 200,000 IQ samples at 1 Msps
SNR_DB = -10.0           # signal to noise over the full 1 MHz band, dB
SEED = 20_261_017


def voice_like(n, rate=AUDIO_RATE):
    """Two tones (700 and 1,900 Hz) under a 4 Hz syllabic envelope."""
    t = np.arange(n) / rate
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t)
    return (0.4 * env * (np.sin(2 * np.pi * 700.0 * t)
                         + 0.6 * np.sin(2 * np.pi * 1900.0 * t))).astype(
        np.float32)


def main():
    audio = voice_like(N_AUDIO)
    mod = SsbMod(usb=True)
    _, out = mod(mod.init_state(), jnp.asarray(audio))
    iq = np.asarray(out["iq"]).astype(np.complex64)
    rng = np.random.default_rng(SEED)
    p_sig = float(np.mean(np.abs(iq) ** 2))
    sigma = np.sqrt(p_sig * 10 ** (-SNR_DB / 10) / 2)
    iq = iq + sigma * (rng.standard_normal(iq.shape)
                       + 1j * rng.standard_normal(iq.shape))
    np.savez_compressed(OUT, iq_re=iq.real.astype(np.float16),
                        iq_im=iq.imag.astype(np.float16), audio=audio)
    print(f"{OUT.relative_to(ROOT)}: {iq.shape[0]} IQ samples, signal "
          f"power {p_sig:.3e}, noise sigma {sigma:.3e} a plane, "
          f"{OUT.stat().st_size} bytes")


if __name__ == "__main__":
    main()
