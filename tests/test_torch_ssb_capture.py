"""The frozen SSB capture through the port's SsbDemod against the JAX
package's, on the CPU.

tests/fixtures/iq_ssb_usb_-10db.npz (made by scripts/make_ssb_capture.py:
the JAX SsbMod(usb=True) on two tones under a syllabic envelope, AWGN at
-10 dB over the full band from a fixed seed, IQ quantized to float16) pins
the exact sample stream, as iq_4fsk2k_-6db.npz does for the 4FSK chain.
It streams in two blocks of 100,000 IqPair samples (800 audio samples
each) through both chains; every output and state leaf is compared after
each block: the audio within 1e-5 of its peak (the FIRs' bound), rssi
within 1e-4 dB, the state leaves within 1e-5 of their peaks.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.chains import ssb as jssb  # noqa: E402
from qradiolink_tpu_torch.chains import ssb  # noqa: E402
from tests.torch_parity import stream_both  # noqa: E402

FIX = pathlib.Path(__file__).parent / "fixtures" / "iq_ssb_usb_-10db.npz"
SSB_TOL = {"audio": (1e-5, 0.0), "rssi": (0.0, 1e-4)}
BLOCK = 100_000


def capture_blocks():
    """The capture as two (re, im) blocks of one channel, f32."""
    data = np.load(FIX)
    re = data["iq_re"].astype(np.float32)[None, :]
    im = data["iq_im"].astype(np.float32)[None, :]
    return [(re[:, i: i + BLOCK].copy(), im[:, i: i + BLOCK].copy())
            for i in range(0, re.shape[1], BLOCK)]


def test_capture_shape():
    """Two blocks of 100,000 samples, a multiple of the head's 125, and
    the 1,600 source audio samples; under 1 MB on disk."""
    data = np.load(FIX)
    assert data["iq_re"].dtype == np.float16 == data["iq_im"].dtype
    assert data["iq_re"].shape == (2 * BLOCK,) == data["iq_im"].shape
    assert data["audio"].shape == (2 * BLOCK // 125,)
    assert BLOCK % 125 == 0 and FIX.stat().st_size < 1_000_000


def test_ssb_capture_decodes_to_the_jax_chain():
    """SsbDemod(usb=True) on the capture: the port's CPU path against the
    JAX chain, every output and state leaf after each block; the second
    block's audio carries the two tones (most of its power within 60 Hz
    of 700 and 1,900 Hz)."""
    jd = jssb.SsbDemod(usb=True, lead_shape=(1,))
    td = ssb.SsbDemod(usb=True, lead_shape=(1,), device="cpu")
    _, (jy, ty) = stream_both(jd, td, capture_blocks(), key_tol=SSB_TOL,
                              peak=True)
    audio = ty["audio"].numpy()[0]
    assert audio.shape == (BLOCK // 125,)
    spec = np.abs(np.fft.rfft((audio - audio.mean())
                              * np.hanning(len(audio)))) ** 2
    f = np.fft.rfftfreq(len(audio), 1 / 8000)
    tones = (np.abs(f - 700) < 60) | (np.abs(f - 1900) < 60)
    assert spec[tones].sum() > 0.5 * spec[f > 100].sum()
