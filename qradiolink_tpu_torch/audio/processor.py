"""TX/RX audio processing: compressor, codec band-pass, VAD level (port
of qradiolink_tpu/audio/processor.py, the same numpy code: it stays on
the host, as in the reference, and gives the JAX module's bits).

The compressor is a per-sample loop over numpy scalars, whose dtypes are
the reference's (numpy 2 keeps `x[pos] * self.linearpregain` an
np.float32; a loop over Python floats would round otherwise), and the
Codec2 band-pass runs in float64 through np.convolve.

Equivalent of reference src/audio/audioprocessor.cpp:1-299 +
src/ext/compressor.c (sndfilter "simplecomp"):

- Compressor: a faithful port of sndfilter's compressor algorithm
  (soft-knee compression curve with binary-searched knee constant,
  sin/asin gain interpolation, adaptive cubic release curve, chunked
  envelope updates every 32 samples) with the reference's six per-mode
  presets (read/write x analog/opus/codec2, audioprocessor.cpp:29-110).
  The envelope is a per-sample feedback loop at 8 kHz host rate — the
  same control/data split as the rest of the framework: sample-rate RF
  DSP on device, 8 kHz voice conditioning on host.
- filter_audio: the Codec2 700/1400 band-pass (256-tap 200-3000 Hz
  windowed-sinc, audioprocessor.cpp:113-126) applied pre-encode and
  post-decode.
- calc_audio_power / vad: the VOX level detector
  (audioprocessor.cpp:162-188).
"""

from __future__ import annotations

import numpy as np

from qradiolink_tpu_torch.ops import firdes

SPU = 32                # samples per envelope chunk (SF_COMPRESSOR_SPU)
SPACING_DB = 5.0        # SF_COMPRESSOR_SPACINGDB


def _db2lin(db):
    return 10.0 ** (0.05 * db)


def _lin2db(lin):
    return 20.0 * np.log10(np.maximum(lin, 1e-30))


class Compressor:
    """sndfilter simplecomp (reference src/ext/compressor.c:82-333)."""

    def __init__(self, rate: int = 8000, pregain: float = 0.0,
                 threshold: float = -24.0, knee: float = 30.0,
                 ratio: float = 12.0, attack: float = 0.003,
                 release: float = 0.25):
        # sf_simplecomp fixed advanced params (compressor.c:62-79)
        predelay = 0.006
        releasezone = (0.09, 0.16, 0.42, 0.98)
        postgain = 0.0
        wet = 1.0

        self.delaybufsize = max(1, int(rate * predelay))
        self.linearpregain = _db2lin(pregain)
        self.linearthreshold = _db2lin(threshold)
        self.slope = 1.0 / ratio
        attacksamples = rate * attack
        self.attacksamplesinv = 1.0 / attacksamples
        releasesamples = rate * release
        self.satreleasesamplesinv = 1.0 / (rate * 0.0025)
        self.wet, self.dry = wet, 1.0 - wet
        self.threshold, self.knee = threshold, knee

        # knee constant binary search (compressor.c:108-124)
        k = 5.0
        kneedboffset = 0.0
        linearthresholdknee = 0.0
        if knee > 0.0:
            xknee = _db2lin(threshold + knee)
            mink, maxk = 0.1, 10000.0
            for _ in range(15):
                if self._kneeslope(xknee, k) < self.slope:
                    maxk = k
                else:
                    mink = k
                k = np.sqrt(mink * maxk)
            kneedboffset = _lin2db(self._kneecurve(xknee, k))
            linearthresholdknee = _db2lin(threshold + knee)
        self.k = k
        self.kneedboffset = kneedboffset
        self.linearthresholdknee = linearthresholdknee
        fulllevel = self._compcurve(1.0)
        self.mastergain = _db2lin(postgain) * (1.0 / fulllevel) ** 0.6

        y1, y2, y3, y4 = (releasesamples * z for z in releasezone)
        self.a = (-y1 + 3 * y2 - 3 * y3 + y4) / 6.0
        self.b = y1 - 2.5 * y2 + 2.0 * y3 - 0.5 * y4
        self.c = (-11 * y1 + 18 * y2 - 9 * y3 + 2 * y4) / 6.0
        self.d = y1

        # streaming state
        self.detectoravg = 0.0
        self.compgain = 1.0
        self.maxcompdiffdb = -1.0
        self.metergain = 1.0
        self.meterrelease = 1.0 - np.exp(-1.0 / (rate * 0.325))
        self._delay = np.zeros(self.delaybufsize, np.float32)
        self._wr = 0
        self._rd = 1 if self.delaybufsize > 1 else 0

    def _kneecurve(self, x, k=None):
        k = self.k if k is None else k
        lt = self.linearthreshold
        return lt + (1.0 - np.exp(-k * (x - lt))) / k

    def _kneeslope(self, x, k):
        lt = self.linearthreshold
        return k * x / ((k * lt + 1.0) * np.exp(k * (x - lt)) - 1)

    def _compcurve(self, x):
        if x < self.linearthreshold:
            return x
        if self.knee <= 0.0:
            return _db2lin(self.threshold + self.slope
                           * (_lin2db(x) - self.threshold))
        if x < self.linearthresholdknee:
            return self._kneecurve(x)
        return _db2lin(self.kneedboffset + self.slope
                       * (_lin2db(x) - self.threshold - self.knee))

    def process(self, x: np.ndarray) -> np.ndarray:
        """float audio in [-1, 1] -> compressed audio (streaming;
        trailing partial 32-sample chunk is carried implicitly by the
        caller's framing, mirroring the reference's whole-chunk loop)."""
        x = np.asarray(x, np.float32).ravel()
        out = np.empty_like(x)
        n = (len(x) // SPU) * SPU
        ang90 = np.pi / 2
        detectoravg, compgain = self.detectoravg, self.compgain
        maxcompdiffdb = self.maxcompdiffdb
        pos = 0
        for _ in range(n // SPU):
            if not np.isfinite(detectoravg):
                detectoravg = 1.0
            scaleddesiredgain = np.arcsin(min(detectoravg, 1.0)) * (2 / np.pi)
            compdiffdb = _lin2db(compgain / max(scaleddesiredgain, 1e-30))
            if compdiffdb < 0.0:      # releasing
                maxcompdiffdb = -1.0
                xr = (np.clip(compdiffdb, -12.0, 0.0) + 12.0) * 0.25
                releasesamples = ((self.a * xr + self.b) * xr + self.c) \
                    * xr + self.d
                enveloperate = _db2lin(SPACING_DB / max(releasesamples, 1.0))
            else:                     # attacking
                if maxcompdiffdb == -1.0 or maxcompdiffdb < compdiffdb:
                    maxcompdiffdb = compdiffdb
                attenuate = max(maxcompdiffdb, 0.5)
                enveloperate = 1.0 - (0.25 / attenuate) \
                    ** self.attacksamplesinv
            for _i in range(SPU):
                s = x[pos] * self.linearpregain
                self._delay[self._wr] = s
                inputmax = abs(s)
                if inputmax < 0.0001:
                    attenuation = 1.0
                else:
                    attenuation = self._compcurve(inputmax) / inputmax
                if attenuation > detectoravg:   # releasing
                    attenuationdb = max(-_lin2db(attenuation), 2.0)
                    rate = _db2lin(attenuationdb
                                   * self.satreleasesamplesinv) - 1.0
                else:
                    rate = 1.0
                detectoravg = min(
                    detectoravg + (attenuation - detectoravg) * rate, 1.0)
                if enveloperate < 1.0:
                    compgain += (scaleddesiredgain - compgain) * enveloperate
                else:
                    compgain = min(compgain * enveloperate, 1.0)
                premixgain = np.sin(ang90 * compgain)
                gain = self.dry + self.wet * self.mastergain * premixgain
                out[pos] = self._delay[self._rd] * gain
                pos += 1
                self._rd = (self._rd + 1) % self.delaybufsize
                self._wr = (self._wr + 1) % self.delaybufsize
        out[n:] = x[n:]
        self.detectoravg, self.compgain = detectoravg, compgain
        self.maxcompdiffdb = maxcompdiffdb
        return out


# the reference's six per-mode presets (audioprocessor.cpp:29-110):
# (pregain, threshold, knee, ratio, attack, release)
PRESETS = {
    ("read", "codec2"): (0, -35, 40, 30, 0.001, 0.15),
    ("write", "codec2"): (3, -30, 20, 20, 0.001, 0.125),
    ("read", "opus"): (0, -35, 20, 20, 0.009, 0.125),
    ("write", "opus"): (0, -35, 20, 20, 0.001, 0.125),
    ("read", "analog"): (0, -35, 20, 20, 0.009, 0.125),
    ("write", "analog"): (-6, -30, 20, 20, 0.001, 0.125),
}


class Denoiser:
    """Spectral-subtraction denoiser + slow AGC on 320-sample frames.

    The Speex-preprocess equivalent for the TX capture path: the
    reference initializes speex_preprocess with DENOISE on and
    NOISE_SUPPRESS=-45 dB (src/audio/audioprocessor.cpp:27-52 — the
    block is compiled out in the shipped build, which is why
    Settings.audio_denoise defaults to False here too; enabling it
    activates this stage in write_preprocess).

    Method: 50%-overlap sqrt-Hann WOLA at the frame size; noise PSD per
    bin tracked with minima-controlled recursive averaging (MCRA-style:
    follow downward immediately, creep upward slowly so speech never
    trains the noise model); per-bin Wiener-like gain floored at the
    suppress level. AGC (optional) applies a slow gain toward a target
    RMS with attack/decay step counts matching the reference's
    agc_attack / agc_decay settings semantics.
    """

    def __init__(self, rate: int = 8000, frame: int = 320,
                 suppress_db: float = -45.0, denoise: bool = True,
                 agc: bool = False,
                 agc_target: float = 0.1, agc_attack: int = 1,
                 agc_decay: int = 100):
        self.rate = rate
        self.denoise_enabled = bool(denoise)
        self.frame = int(frame)
        self.hop = self.frame // 2
        self.win = np.sqrt(np.hanning(self.frame + 1)[:-1].astype(np.float64)
                           + 1e-12)
        self.floor = 10.0 ** (suppress_db / 20.0)
        self.noise = None              # per-bin noise PSD estimate
        self.psd_s = None              # smoothed per-bin PSD
        self.up = 1.03                 # upward creep per frame (~0.13 dB)
        self.alpha = 0.85              # downward smoothing
        self.beta = 2.5                # over-subtraction factor
        self._in_tail = np.zeros(self.hop)
        self._ola_tail = np.zeros(self.hop)
        self.agc_enabled = bool(agc)
        self.agc_target = float(agc_target)
        self.agc_attack = max(int(agc_attack), 1)
        self.agc_decay = max(int(agc_decay), 1)
        self.agc_gain = 1.0

    def _denoise_frame(self, fr: np.ndarray) -> np.ndarray:
        spec = np.fft.rfft(fr * self.win)
        psd = np.abs(spec) ** 2
        if self.psd_s is None:
            self.psd_s = psd.copy()
            self.noise = psd.copy() + 1e-12
        else:
            self.psd_s = 0.6 * self.psd_s + 0.4 * psd
            lower = self.psd_s < self.noise
            self.noise = np.where(
                lower,
                self.alpha * self.noise + (1 - self.alpha) * self.psd_s,
                self.noise * self.up)
        # over-subtracted Wiener gain on the smoothed PSD, floored at
        # the suppress level (the -45 dB NOISE_SUPPRESS role)
        gain = np.maximum(
            1.0 - self.beta * self.noise / np.maximum(self.psd_s, 1e-12),
            0.0)
        gain = np.maximum(np.sqrt(gain), self.floor)
        return np.fft.irfft(spec * gain, n=self.frame) * self.win

    def process(self, audio: np.ndarray) -> np.ndarray:
        """Stream 8 kHz float audio through denoise (+AGC). Output is
        delayed by one hop (WOLA latency), length-preserving for
        hop-multiple blocks."""
        x = np.concatenate([self._in_tail, np.asarray(audio, np.float64)])
        n_frames = (len(x) - self.hop) // self.hop
        out = np.zeros(max(n_frames, 0) * self.hop)
        for i in range(n_frames):
            fr = x[i * self.hop: i * self.hop + self.frame]
            if self.denoise_enabled:
                y = self._denoise_frame(fr)
            else:
                y = fr * (self.win * self.win)  # AGC-only pass-through
            y[: self.hop] += self._ola_tail
            out[i * self.hop: (i + 1) * self.hop] = y[: self.hop]
            self._ola_tail = y[self.hop:].copy()
        self._in_tail = x[len(x) - self.hop:]
        if self.agc_enabled and len(out):
            rms = float(np.sqrt(np.mean(out * out)) + 1e-12)
            want = self.agc_target / rms
            step = (self.agc_attack if want < self.agc_gain
                    else self.agc_decay)
            self.agc_gain += (want - self.agc_gain) / step
            self.agc_gain = float(np.clip(self.agc_gain, 0.01, 100.0))
            out = out * self.agc_gain
        return out.astype(np.float32)


class AudioProcessor:
    """Per-mode audio conditioning (reference AudioProcessor)."""

    AUDIO_MODE_ANALOG = "analog"
    AUDIO_MODE_OPUS = "opus"
    AUDIO_MODE_CODEC2 = "codec2"

    def __init__(self, rate: int = 8000, denoise: bool = False,
                 agc: bool = False, agc_attack: int = 1,
                 agc_decay: int = 100):
        self.rate = rate
        self.denoiser = (Denoiser(rate, denoise=denoise, agc=agc,
                                  agc_attack=agc_attack,
                                  agc_decay=agc_decay)
                         if (denoise or agc) else None)
        self._comp = {key: Compressor(rate, *args)
                      for key, args in PRESETS.items()}
        # Codec2 700/1400 band-pass: 256-tap 200-3000 Hz
        # (audioprocessor.cpp Filter(BPF,256,8,0.2,3.0) at 8 kHz)
        taps = firdes.band_pass(1.0, float(rate), 200.0, 3000.0, 200.0,
                                firdes.WIN_BLACKMAN_HARRIS)
        self._bp_taps = np.asarray(taps, np.float64)
        self._bp_tail = np.zeros(len(self._bp_taps) - 1)
        self._mag_sum = 0.0
        self._count = 0
        self.audio_level = 0.0

    # -- compression ---------------------------------------------------------
    def write_preprocess(self, audio: np.ndarray, audio_mode: str,
                         preprocess: bool = True,
                         compress: bool = True) -> np.ndarray:
        """TX-side conditioning (audioprocessor.cpp:142-149): denoise,
        compress, and band-pass for Codec2 modes."""
        if not preprocess:
            return np.asarray(audio, np.float32)
        y = np.asarray(audio, np.float32)
        if self.denoiser is not None:
            # denoise/AGC run first, exactly where the reference calls
            # speex_preprocess_run on each capture frame
            y = self.denoiser.process(y)
        if compress:
            y = self._comp[("write", audio_mode)].process(y)
        if audio_mode == self.AUDIO_MODE_CODEC2:
            y = self.filter_audio(y)
        return y

    def read_preprocess(self, audio: np.ndarray, audio_mode: str,
                        preprocess: bool = True,
                        vox_level: float = 0.0) -> tuple[np.ndarray, bool]:
        """RX->speaker conditioning + VOX decision
        (audioprocessor.cpp:152-160)."""
        y = np.asarray(audio, np.float32)
        if preprocess:
            y = self._comp[("read", audio_mode)].process(y)
        power = self.calc_audio_power(y)
        # reference compares the int16-scale RMS against vox_level*100
        # (audioprocessor.cpp:159: power >= vox_level * 100)
        return y, power * 32768.0 >= vox_level * 100.0

    def filter_audio(self, audio: np.ndarray) -> np.ndarray:
        """Streaming Codec2 band-pass."""
        x = np.concatenate([self._bp_tail, np.asarray(audio, np.float64)])
        y = np.convolve(x, self._bp_taps, "valid")
        self._bp_tail = x[len(x) - (len(self._bp_taps) - 1):]
        return y.astype(np.float32)

    def calc_audio_power(self, audio: np.ndarray) -> float:
        """RMS + the 960-sample averaged dB level meter
        (audioprocessor.cpp:162-188, volume factored out)."""
        a = np.abs(np.asarray(audio, np.float64))
        power = float(np.sum(a * a))
        self._mag_sum += power
        self._count += len(a)
        rms = np.sqrt(power / max(len(a), 1))
        if self._count >= 960:
            avg = np.sqrt(self._mag_sum / self._count)
            self.audio_level = float(np.clip(
                20.0 * np.log10(max(avg, 1e-10) / 0.775), -100.0, 20.0))
            self._mag_sum = 0.0
            self._count = 0
        return float(rms)
