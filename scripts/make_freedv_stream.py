"""Make the stored FreeDV 1600 modem stream tests/fixtures/freedv1600_modem.npz.

    JAX_PLATFORMS=cpu python scripts/make_freedv_stream.py

Needs libcodec2 with its FreeDV API. The JAX package's FreeDvTx, part by
part, on 3 s of tests/test_freedv.py's test utterance (pitch harmonics at
110 Hz with a syllable-rate envelope, 8 kHz): its 200-3500 Hz band-pass,
x32765 clipped and truncated to int16 (`pcm`, what FreeDvTx hands to
freedv_tx), then freedv_tx in mode 1600 (`modem`, int16 at 8 kHz). The
file also holds the utterance (`speech`, int16). chip_smoke.py runs
FreeDV's DSP ends on `modem` where the machine's libcodec2 has no FreeDV
API, and tests/test_torch_freedv_vocoder.py checks that the file is still
what this script writes. About 0.1 MB.
"""

import os
import pathlib
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from qradiolink_tpu.chains.freedv import FreeDvTx  # noqa: E402

OUT = ROOT / "tests" / "fixtures" / "freedv1600_modem.npz"
SECONDS = 3


def utterance(n, rate=8000):
    """tests/test_freedv.py:14-22, int16."""
    t = np.arange(n) / rate
    x = sum(np.sin(2 * np.pi * 110.0 * k * t) / k for k in range(1, 8))
    x *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (x / np.abs(x).max() * 12000).astype(np.int16)


def stream():
    """-> (speech, pcm, modem), each int16."""
    speech = utterance(8000 * SECONDS)
    tx = FreeDvTx("1600", usb=True)
    _, filt = tx.audio_filter(tx._af_state, jnp.asarray(
        speech.astype(np.float32) / 32768.0))
    pcm = np.clip(np.asarray(filt) * 32765.0, -32765,
                  32765).astype(np.int16)
    return speech, pcm, tx.freedv.tx(pcm)


def main():
    speech, pcm, modem = stream()
    np.savez_compressed(OUT, speech=speech, pcm=pcm, modem=modem)
    print(f"{OUT}: {speech.size} speech samples, {modem.size} modem "
          f"samples, {OUT.stat().st_size} bytes")


if __name__ == "__main__":
    main()
