"""The port's host audio modules against the JAX package's, on the CPU:

- audio/flac.py: the CRC check words, and every file byte for byte equal
  to the JAX writer's (silence, partial last blocks, float input, other
  rates); each package reads the other's files back to the samples.
- audio/recorder.py: WAV and FLAC recordings byte for byte equal.
- audio/processor.py: Compressor (the six presets), Denoiser (denoise,
  AGC, both) and AudioProcessor (every mode, with and without the
  denoiser) over chained blocks, outputs and every state leaf equal bit
  for bit (host numpy in both packages: no tolerance), and the JAX tests'
  gates (tests/test_audio_processor.py) on the port's outputs.
- RadioController.tx_audio_block with audio_compressor (and
  audio_denoise): FM (AUDIO_MODE_ANALOG), 4FSK2K (Codec2) and 4FSK10KFM
  (Opus) over two chained blocks, every processor state leaf equal to the
  JAX controller's and the IQ within the modulator's parity bound
  (NbfmMod 5e-5, Fsk4Mod 1e-4, of the peak).
- audio/mixer.py: AudioMixer's frames and queues equal; UdpAudioClient's
  two resamplers (on the port's RationalResampler, device="cpu") over
  three reads of different lengths, none a multiple of 6: the float output
  within RS_TOL of the JAX client's peak, the carried state equal, the
  int16 output within one LSB (its truncation toward zero can flip a
  sample whose float lies at a boundary); the 400 Hz UDP round trip
  (tests/test_mixer.py:35-56) between two of the port's clients.
"""

import time
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

import jax.numpy as jnp  # noqa: E402
from qradiolink_tpu import config as jconfig  # noqa: E402
from qradiolink_tpu.app import controller as jctl  # noqa: E402
from qradiolink_tpu.audio import flac as jflac  # noqa: E402
from qradiolink_tpu.audio import mixer as jmixer  # noqa: E402
from qradiolink_tpu.audio import processor as jproc  # noqa: E402
from qradiolink_tpu.audio import recorder as jrecorder  # noqa: E402
from qradiolink_tpu_torch import config  # noqa: E402
from qradiolink_tpu_torch.app import controller as ctl  # noqa: E402
from qradiolink_tpu_torch.audio import codecs  # noqa: E402
from qradiolink_tpu_torch.audio import flac, mixer, processor  # noqa: E402
from qradiolink_tpu_torch.audio import recorder  # noqa: E402

CPU = "cpu"
RS_TOL = 1e-5     # the resamplers' float output, relative to the peak
COMP_STATE = ("detectoravg", "compgain", "maxcompdiffdb", "metergain",
              "_delay", "_wr", "_rd")
COMP_CONST = ("delaybufsize", "linearpregain", "linearthreshold", "slope",
              "attacksamplesinv", "satreleasesamplesinv", "k",
              "kneedboffset", "linearthresholdknee", "mastergain", "a", "b",
              "c", "d", "meterrelease")
DENOISE_STATE = ("noise", "psd_s", "_in_tail", "_ola_tail", "agc_gain")


def _tone(n=8000, f=1000.0, amp=1.0, rate=8000):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / rate)
            ).astype(np.float32)


def _speech(rng, n):
    """Seeded test audio: two tones with a syllable-rate envelope plus
    noise, loud enough that the compressor works."""
    t = np.arange(n) / 8000.0
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 3.0 * t)
    x = env * (0.6 * np.sin(2 * np.pi * 440 * t)
               + 0.3 * np.sin(2 * np.pi * 1270 * t))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _same_value(a, b, what):
    """Bit-equal values of the same type: numpy arrays (dtype, shape,
    elements), numpy scalars and Python numbers (type and value)."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), what
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(b, a, err_msg=what)
    else:
        assert type(a) is type(b), (what, type(a), type(b))
        assert a == b or (a != a and b != b), (what, a, b)


def _same_attrs(j, p, names):
    for n in names:
        _same_value(getattr(j, n), getattr(p, n), n)


# ------------------------------------------------------------------ FLAC
def test_crc_vectors_match_jax(rng):
    """tests/test_flac.py:18-21, and the JAX functions' values."""
    assert flac._crc8(b"123456789") == 0xF4
    assert flac._crc16(b"123456789") == 0xFEE8
    data = bytes(rng.integers(0, 256, 3000, dtype=np.uint8))
    assert flac._crc8(data) == jflac._crc8(data)
    assert flac._crc16(data) == jflac._crc16(data)


FLAC_CASES = {
    "empty": (0, 0.0, 8000, np.int16),
    "short": (100, 8000.0, 8000, np.int16),
    "one block": (4096, 500.0, 8000, np.int16),
    "partial last block": (5000, 1000.0, 8000, np.int16),
    "round trip": (10_000, 8000.0, 8000, np.int16),
    "silence": (8192, 0.0, 8000, np.int16),
    "48 kHz": (9000, 3000.0, 48_000, np.int16),
    "odd rate": (3000, 3000.0, 11_025, np.int16),
    "float input": (6000, 0.4, 8000, np.float32),
    "clipped float": (4500, 2.0, 8000, np.float64),
}


@pytest.mark.parametrize("case", list(FLAC_CASES))
def test_flac_file_equals_jax(case, tmp_path, rng):
    n, scale, rate, dtype = FLAC_CASES[case]
    x = (rng.standard_normal(n) * scale).astype(dtype)
    if dtype == np.int16 and scale == 0.0 and n:
        x[:] = -3 if case == "silence" else 0
    jp, tp = tmp_path / "j.flac", tmp_path / "p.flac"
    jflac.write_flac(jp, x, rate)
    flac.write_flac(tp, x, rate)
    assert tp.read_bytes() == jp.read_bytes()
    want = x if dtype == np.int16 else np.clip(
        np.asarray(x, np.float64) * 32767.0, -32768, 32767).astype(np.int16)
    for reader in (flac.read_flac, jflac.read_flac):
        y, r = reader(tp)
        assert r == rate
        np.testing.assert_array_equal(y, want)
    if case == "silence":
        assert tp.stat().st_size < 200      # CONSTANT subframes


def test_flac_frame_sync_and_crc(tmp_path, rng):
    """tests/test_flac.py:53-64 on the port's file."""
    x = (rng.standard_normal(4096) * 500).astype(np.int16)
    p = tmp_path / "c.flac"
    flac.write_flac(p, x, 8000)
    data = p.read_bytes()
    assert data[:4] == b"fLaC"
    fpos = 4 + 4 + 34
    assert data[fpos] == 0xFF and (data[fpos + 1] & 0xFC) == 0xF8
    assert flac._crc16(data[fpos:]) == 0


def test_flac_reader_refuses_other_streams(tmp_path):
    p = tmp_path / "x.flac"
    p.write_bytes(b"RIFF0000")
    with pytest.raises(ValueError, match="not a FLAC stream"):
        flac.read_flac(p)


# -------------------------------------------------------------- recorder
@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_recorder_file_equals_jax(fmt, tmp_path, rng):
    """tests/test_flac.py:67-85: the same calls on both recorders write the
    same bytes; float blocks clip to +-32767, int16 blocks pass."""
    a = (rng.standard_normal(3000) * 0.4).astype(np.float32)
    b = (rng.standard_normal(700) * 9000).astype(np.int16)
    paths = []
    for mod, sub in ((jrecorder, "jax"), (recorder, "port")):
        rec = mod.AudioRecorder(tmp_path / sub, rate=8000, fmt=fmt)
        assert not rec.recording
        path = rec.start("take1")
        assert rec.recording and path.suffix == f".{fmt}"
        for blk in (a, b, a[:123]):
            rec.write(blk)
        assert rec.stop() == path and not rec.recording
        assert rec.stop() is None
        paths.append(path)
    assert paths[1].read_bytes() == paths[0].read_bytes()
    want = np.concatenate([np.clip(a * 32767.0, -32767, 32767).astype(
        np.int16), b, np.clip(a[:123] * 32767.0, -32767, 32767).astype(
        np.int16)])
    if fmt == "flac":
        y, rate = flac.read_flac(paths[1])
    else:
        with wave.open(str(paths[1])) as w:
            rate = w.getframerate()
            y = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    assert rate == 8000
    np.testing.assert_array_equal(y, want)


def test_recorder_refuses_other_formats(tmp_path):
    with pytest.raises(ValueError, match="unsupported recording format"):
        recorder.AudioRecorder(tmp_path, fmt="mp3")


# ------------------------------------------------------------- processor
@pytest.mark.parametrize("preset", list(processor.PRESETS))
def test_compressor_matches_jax(preset, rng):
    """Each of the six presets over two chained blocks (neither a whole
    number of 32-sample chunks): outputs and every state leaf bit-equal."""
    assert processor.PRESETS == jproc.PRESETS
    args = processor.PRESETS[preset]
    j, p = jproc.Compressor(8000, *args), processor.Compressor(8000, *args)
    _same_attrs(j, p, COMP_CONST + COMP_STATE)
    for n in (1000, 777):
        x = _speech(rng, n)
        _same_value(j.process(x), p.process(x), f"{preset} output")
        _same_attrs(j, p, COMP_STATE)


def test_compressor_gates_on_the_port():
    """tests/test_audio_processor.py:15-45 on the port's Compressor."""
    kw = dict(pregain=0, threshold=-30, knee=20, ratio=20, attack=0.001,
              release=0.125)
    out_loud = processor.Compressor(8000, **kw).process(
        _tone(amp=0.9))[4000:]
    out_quiet = processor.Compressor(8000, **kw).process(
        _tone(amp=0.02))[4000:]
    in_range = 20 * np.log10(0.9 / 0.02)
    out_range = 20 * np.log10(np.abs(out_loud).max()
                              / max(np.abs(out_quiet).max(), 1e-9))
    assert out_range < in_range - 10
    assert np.abs(out_loud).max() < 1.2
    y = processor.Compressor(8000, 0, -35, 20, 20, 0.001, 0.125).process(
        _tone(16000, amp=0.8))
    e1, e2 = np.abs(y[8000:12000]).max(), np.abs(y[12000:]).max()
    assert abs(e1 - e2) / e1 < 0.1


DENOISER_CASES = {"denoise": dict(denoise=True),
                  "agc": dict(denoise=False, agc=True, agc_target=0.1,
                              agc_attack=1, agc_decay=20),
                  "denoise and agc": dict(denoise=True, agc=True,
                                          agc_attack=3, agc_decay=50)}


@pytest.mark.parametrize("case", list(DENOISER_CASES))
def test_denoiser_matches_jax(case, rng):
    """Chained blocks of 320, 333 (not a whole hop) and 1000 samples of a
    gated tone in noise: outputs, the WOLA tails, the noise and PSD
    estimates and the AGC gain bit-equal."""
    kw = DENOISER_CASES[case]
    j, p = jproc.Denoiser(8000, **kw), processor.Denoiser(8000, **kw)
    _same_attrs(j, p, ("win", "floor", "hop") + DENOISE_STATE)
    t = np.arange(1653) / 8000
    x = (0.5 * np.sin(2 * np.pi * 800 * t) * (np.sin(2 * np.pi * 3 * t) > 0)
         + 0.05 * rng.standard_normal(t.size))
    pos = 0
    for n in (320, 333, 1000):
        blk = x[pos:pos + n]
        pos += n
        _same_value(j.process(blk), p.process(blk), f"{case} output")
        _same_attrs(j, p, DENOISE_STATE)


def test_denoiser_gates_on_the_port():
    """tests/test_audio_processor.py:83-133 on the port's Denoiser: the
    noise floor drops by 10 dB or more while the tone stays within 3 dB;
    the AGC pulls a quiet input toward its target."""
    rng = np.random.default_rng(7)
    fs = 8000
    t = np.arange(fs * 4) / fs
    gate = (np.sin(2 * np.pi * 0.7 * t) > 0).astype(float)
    x = 0.5 * np.sin(2 * np.pi * 800 * t) * gate \
        + 0.05 * rng.standard_normal(len(t))
    dn = processor.Denoiser(fs)
    out = np.concatenate([dn.process(x[i:i + 320])
                          for i in range(0, len(x), 320)])
    half = len(out) // 2
    spec_in = np.abs(np.fft.rfft(x[half:half + 8192])) ** 2
    spec_out = np.abs(np.fft.rfft(out[half:half + 8192])) ** 2
    freqs = np.fft.rfftfreq(8192, 1 / fs)
    band = (freqs > 1500) & (freqs < 3500)
    assert 10 * np.log10(spec_in[band].sum() / spec_out[band].sum()) >= 10
    tone = (freqs > 700) & (freqs < 900)
    assert 10 * np.log10(spec_out[tone].sum() / spec_in[tone].sum()) > -3
    dn = processor.Denoiser(fs, denoise=False, agc=True, agc_target=0.1,
                            agc_attack=1, agc_decay=20)
    q = 0.01 * np.sin(2 * np.pi * 700 * np.arange(fs * 3) / fs)
    outs = [dn.process(q[i:i + 320]) for i in range(0, len(q), 320)]
    assert 0.05 < float(np.sqrt(np.mean(np.concatenate(outs[-10:]) ** 2))) \
        < 0.2


def _processor_state(ap):
    """Every state leaf of an AudioProcessor: each compressor's, the
    band-pass tail, the level meter's, the denoiser's."""
    out = {f"bp {n}": getattr(ap, n) for n in
           ("_bp_tail", "_mag_sum", "_count", "audio_level")}
    for key, c in ap._comp.items():
        out.update({f"{key} {n}": getattr(c, n) for n in COMP_STATE})
    if ap.denoiser is not None:
        out.update({f"dn {n}": getattr(ap.denoiser, n)
                    for n in DENOISE_STATE})
    return out


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("mode", ["analog", "opus", "codec2"])
def test_audio_processor_matches_jax(mode, denoise, rng):
    """write_preprocess (with and without compression), read_preprocess
    (compressed and bare, VOX) and the level meter over chained blocks:
    every output and state leaf bit-equal."""
    kw = dict(denoise=denoise, agc_attack=2, agc_decay=40)
    j, p = jproc.AudioProcessor(**kw), processor.AudioProcessor(**kw)
    _same_value(j._bp_taps, p._bp_taps, "band-pass taps")
    assert p._bp_taps.size == 167
    for i, n in enumerate((640, 500, 960)):
        x = _speech(rng, n) * (0.3 if i == 1 else 1.0)
        comp = i != 2
        _same_value(j.write_preprocess(x, mode, compress=comp),
                    p.write_preprocess(x, mode, compress=comp), "write")
        for pre in (True, False):
            (jy, ja), (py, pa) = (
                ap.read_preprocess(x, mode, preprocess=pre, vox_level=30.0)
                for ap in (j, p))
            _same_value(jy, py, "read")
            assert ja == pa
        _same_value(j.write_preprocess(x, mode, preprocess=False),
                    p.write_preprocess(x, mode, preprocess=False), "bare")
        js, ps = _processor_state(j), _processor_state(p)
        assert js.keys() == ps.keys()
        for k in js:
            _same_value(js[k], ps[k], k)


def test_codec2_bandpass_and_vad_on_the_port():
    """tests/test_audio_processor.py:48-80 on the port's AudioProcessor."""
    ap = processor.AudioProcessor
    noise = np.random.default_rng(0).standard_normal(16000).astype(
        np.float32) * 0.2
    y_c2 = ap().write_preprocess(noise, ap.AUDIO_MODE_CODEC2)
    y_op = ap().write_preprocess(noise, ap.AUDIO_MODE_OPUS)

    def band_db(y, lo, hi):
        sp = np.abs(np.fft.rfft(y * np.hanning(len(y)))) ** 2
        f = np.fft.rfftfreq(len(y), 1 / 8000)
        return 10 * np.log10(sp[(f >= lo) & (f < hi)].mean() + 1e-12)

    assert band_db(y_c2, 500, 2500) - band_db(y_c2, 3600, 3990) > 30
    assert band_db(y_op, 500, 2500) - band_db(y_op, 3600, 3990) < 10
    p = ap()
    assert p.read_preprocess(_tone(960, amp=0.5), ap.AUDIO_MODE_ANALOG,
                             preprocess=False, vox_level=0.1)[1]
    assert not p.read_preprocess(np.zeros(960, np.float32),
                                 ap.AUDIO_MODE_ANALOG, preprocess=False,
                                 vox_level=0.1)[1]
    assert -100.0 <= p.audio_level <= 20.0


# the controller's TX branch: mode -> (denoise, the audio mode the branch
# picks, the modulator's IQ bound relative to the peak)
TX_CASES = {"FM": (True, "analog", 5e-5), "4FSK2K": (False, "codec2", 1e-4),
            "4FSK10KFM": (True, "opus", 1e-4)}


@pytest.mark.parametrize("mode", list(TX_CASES))
def test_controller_tx_audio_processor_matches_jax(mode, rng):
    """tx_audio_block with audio_compressor (and audio_denoise where the
    case says) on both controllers, two chained blocks of 1,600 samples:
    the processor built with the settings' agc_attack and agc_decay, the
    audio mode the branch picks, every processor state leaf equal, the IQ
    within the modulator's bound."""
    denoise, amode, tol = TX_CASES[mode]
    if amode != "analog" and not codecs.codec2_available():
        pytest.skip("codec2 missing")
    if amode == "opus" and not codecs.opus_available():
        pytest.skip("opus missing")
    kw = dict(tx_mode=mode, audio_compressor=True, audio_denoise=denoise,
              agc_attack=3, agc_decay=70)
    cs = []
    for mod, cfg, extra in ((jctl, jconfig, {}),
                            (ctl, config, {"device": CPU})):
        s = cfg.Settings()
        for k, v in kw.items():
            setattr(s, k, v)
        c = mod.RadioController(s, **extra)
        c.start_transmission()
        cs.append(c)
    j, p = cs
    for _ in range(2):
        x = _speech(rng, 1600)
        want, got = j.tx_audio_block(x), p.tx_audio_block(x)
        assert got.dtype == want.dtype == np.complex64
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= \
            tol * float(np.abs(want).max())
        js, ps = _processor_state(j._audio_proc), \
            _processor_state(p._audio_proc)
        assert js.keys() == ps.keys()
        for k in js:
            _same_value(js[k], ps[k], k)
    dn = p._audio_proc.denoiser
    assert (dn is not None) == denoise
    if denoise:
        assert (dn.agc_attack, dn.agc_decay) == (3, 70)
    touched = {k for k, c in p._audio_proc._comp.items()
               if c.compgain != 1.0}
    assert touched == {("write", amode)}


# ----------------------------------------------------------------- mixer
def test_mixer_matches_jax(rng):
    """tests/test_mixer.py:8-32's frames and a longer seeded script on both
    mixers: each frame (or None) and the queues left equal."""
    script = [("add", 1, np.full(400, 1000, np.int16)),
              ("add", 2, np.full(320, -500, np.int16)),
              ("mix", 1.0, 320), ("mix", 1.0, 40), ("mix", 1.0, 320),
              ("add", 9901, np.full(320, 1000, np.int16)),
              ("mix", 0.0, 320)]
    for _ in range(12):
        sid = int(rng.choice([3, 4, 9900, 9905]))
        script.append(("add", sid, (rng.standard_normal(
            int(rng.integers(1, 700))) * 12000).astype(np.int16)))
        if rng.random() < 0.6:
            script.append(("mix", float(rng.uniform(0, 1.5)),
                           int(rng.choice([40, 160, 320]))))
    script += [("mix", 0.7, 1)] * 6
    j, p = jmixer.AudioMixer(), mixer.AudioMixer()
    for step in script:
        if step[0] == "add":
            j.add_samples(step[2], sid=step[1])
            p.add_samples(step[2], sid=step[1])
        else:
            assert p.buffers_available(step[2]) == \
                j.buffers_available(step[2])
            jm = j.mix_samples(rx_volume=step[1], maximum_frame_size=step[2])
            pm = p.mix_samples(rx_volume=step[1], maximum_frame_size=step[2])
            assert (jm is None) == (pm is None)
            if jm is not None:
                _same_value(jm, pm, "mix")
        assert j._buffers.keys() == p._buffers.keys()
        for sid in j._buffers:
            _same_value(j._buffers[sid], p._buffers[sid], f"sid {sid}")
    p.empty()
    assert p.mix_samples() is None


@pytest.fixture
def clients():
    """A JAX client and a port client (device="cpu"), 48 kHz on the wire,
    sockets on ephemeral ports; closed after the test."""
    j = jmixer.UdpAudioClient(listen_port=0, send_port=0, wire_rate=48_000)
    p = mixer.UdpAudioClient(listen_port=0, send_port=0, wire_rate=48_000,
                             device=CPU)
    yield j, p
    j.close()
    p.close()


def _floats(rs, pcm, M, jax_side):
    """The float output that _resample would truncate, from a copy of the
    resampler's state (the state is left as it was)."""
    x = pcm.astype(np.float32) / 32768.0
    x = np.concatenate([x, np.zeros((-len(x)) % M, np.float32)])
    if jax_side:
        return np.asarray(rs[0](rs[1], jnp.asarray(x))[1]).real
    return rs[0](rs[1].clone(), torch.from_numpy(x))[1].numpy()


@pytest.mark.parametrize("side", ["down", "up"])
def test_udp_client_resamplers_match_jax(side, clients, rng):
    """Three reads of different lengths, none a multiple of 6 (the wire
    delivers what it has; the client pads each with zeros to a multiple of
    M): 48 kHz -> 8 kHz is L1 M6 with 269 taps, 8 kHz -> 48 kHz L6 M1 with
    45 taps a phase. The float output within RS_TOL of the peak of the
    JAX client's, the state equal after each read, the int16 output within
    one LSB, the count of flipped samples printed."""
    j, p = clients
    rs_j, rs_p = (c._rs_down if side == "down" else c._rs_up
                  for c in (j, p))
    M = 6 if side == "down" else 1
    assert (rs_p[0].L, rs_p[0].M, rs_p[0].kp) == \
        ((1, 6, 269) if side == "down" else (6, 1, 45))
    lengths = (1201, 2405, 599) if side == "down" else (331, 800, 157)
    flipped = 0
    for n in lengths:
        t = np.arange(n) / (48_000.0 if side == "down" else 8000.0)
        pcm = (9000 * np.sin(2 * np.pi * 400 * t)
               + 2000 * rng.standard_normal(n)).astype(np.int16)
        fj, fp = _floats(rs_j, pcm, M, True), _floats(rs_p, pcm, M, False)
        assert fp.dtype == fj.dtype == np.float32 and fp.shape == fj.shape
        assert float(np.abs(fp - fj).max()) <= \
            RS_TOL * float(np.abs(fj).max())
        yj = j._resample(rs_j, pcm, M)
        yp = p._resample(rs_p, pcm, M)
        assert yp.dtype == yj.dtype == np.int16 and yp.shape == yj.shape
        d = np.abs(yp.astype(np.int32) - yj)
        assert d.max() <= 1
        flipped += int((d > 0).sum())
        np.testing.assert_array_equal(rs_p[1].numpy(), np.asarray(rs_j[1]))
    print(f"{side}: {flipped} int16 samples one LSB apart")


def test_udp_audio_round_trip_48k():
    """tests/test_mixer.py:35-56 on two of the port's clients: a 400 Hz
    tone through 8k -> 48k -> UDP -> 8k, its peak within 20 Hz."""
    rx = mixer.UdpAudioClient(listen_port=0, send_port=0, wire_rate=48_000,
                              device=CPU)
    tx = mixer.UdpAudioClient(listen_port=0, send_port=rx.port,
                              wire_rate=48_000, device=CPU)
    try:
        t = np.arange(8000) / 8000.0
        tx.write_audio((8000 * np.sin(2 * np.pi * 400 * t)).astype(np.int16))
        got = np.zeros(0, np.int16)
        end = time.monotonic() + 10.0
        while got.size < 6000 and time.monotonic() < end:
            time.sleep(0.01)
            got = np.concatenate([got, rx.read_audio()])
        assert got.size >= 6000, f"only {got.size} samples received"
        x = got[1000:6000].astype(np.float64)
        sp = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
        f = np.fft.rfftfreq(len(x), 1 / 8000)
        assert abs(f[np.argmax(sp[1:]) + 1] - 400.0) < 20.0
    finally:
        rx.close()
        tx.close()
