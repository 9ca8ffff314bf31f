"""The port's mode registry (qradiolink_tpu_torch/models/registry.py)
against the JAX package's: the same 41 mode names, ModeSpec fields and
MODEM_TYPE_MAP, the same errors, and every RX and TX factory built on the
CPU and run over one block."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.models import registry as jreg  # noqa: E402
from qradiolink_tpu_torch.core import IqPair  # noqa: E402
from qradiolink_tpu_torch.models import registry  # noqa: E402

FIELDS = ("name", "kind", "framing", "scan_step_hz", "audio_rate",
          "bit_rate")
# RX block lengths at 1 Msps (250 ksps for MMDVM): whole symbols and
# decimations; DSSS a whole soft pair (2 x 62,500); the rest 10,000
RX_T = {"BPSKDSSS8": 125_000, "MMDVMmulti": 2500, "MMDVM": 2500}
# TX input: audio for the analog, FreeDV and MMDVM modes, bits for M17 and
# DMR, bytes for the other digital modes
AUDIO_TX = {"FM", "NBFM", "AM", "USB", "LSB", "CW", "MMDVM", "MMDVMmulti"}
BITS_TX = {"M17", "DMR"}


def test_mode_names_and_fields_match_jax():
    assert len(registry.MODES) == len(jreg.MODES) == 41
    assert list(registry.MODES) == list(jreg.MODES)
    assert [f.name for f in dataclasses.fields(registry.ModeSpec)] == \
        [f.name for f in dataclasses.fields(jreg.ModeSpec)]
    for name, spec in jreg.MODES.items():
        mine = registry.get_mode(name)
        for f in FIELDS:
            assert getattr(mine, f) == getattr(spec, f), (name, f)
        assert (mine.rx_factory is None) == (spec.rx_factory is None), name
        assert (mine.tx_factory is None) == (spec.tx_factory is None), name


def test_modem_type_map_matches_jax():
    assert registry.MODEM_TYPE_MAP == jreg.MODEM_TYPE_MAP
    assert set(registry.MODEM_TYPE_MAP.values()) <= set(registry.MODES)


@pytest.mark.parametrize("call,arg,exc", [
    ("tx_chain", "WBFM", ValueError), ("rx_chain", "CW", ValueError),
    ("get_mode", "NOPE", KeyError), ("rx_chain", "NOPE", KeyError)])
def test_errors_match_jax(call, arg, exc):
    with pytest.raises(exc) as want:
        getattr(jreg, call)(arg)
    kw = {} if call == "get_mode" else {"device": "cpu"}
    with pytest.raises(exc) as got:
        getattr(registry, call)(arg, **kw)
    assert str(got.value) == str(want.value)


def _lead(name):
    return {} if name == "MMDVMmulti" else {"lead_shape": (2,)}


@pytest.mark.parametrize("name", list(jreg.MODES))
def test_factories_build_and_run_on_cpu(name):
    """Each mode's RX chain over one block of noise IQ, its TX chain over
    one block of its input, on device="cpu": finite outputs, and the chains'
    blocks on the CPU."""
    rng = np.random.default_rng(1)
    spec = registry.get_mode(name)
    lead = _lead(name)
    rows = () if name == "MMDVMmulti" else (2,)
    if spec.rx_factory is not None:
        rx = registry.rx_chain(name, device="cpu", **lead)
        T = RX_T.get(name, 10_000)
        iq = (rng.standard_normal(rows + (T,))
              + 1j * rng.standard_normal(rows + (T,))) * 0.1
        iq = torch.from_numpy(iq.astype(np.complex64))
        _, out = rx(rx.init_state(), iq)
        for k, v in out.items():
            for p in (v if isinstance(v, IqPair) else (v,)):
                if p.is_floating_point() or p.is_complex():
                    assert bool(torch.isfinite(torch.view_as_real(p) if
                                               p.is_complex() else p).all()
                                ), (name, k)
                assert p.device.type == "cpu"
    if spec.tx_factory is not None:
        tx = registry.tx_chain(name, device="cpu", **lead)
        if name == "MMDVMmulti":
            x = rng.standard_normal((7, 2400)) * 0.3
        elif name in AUDIO_TX or name.startswith("FreeDV"):
            x = rng.standard_normal(rows + (2400,)) * 0.3
        elif name in BITS_TX:
            x = rng.integers(0, 2, rows + (960,))
        else:
            x = rng.integers(0, 256, rows + (2,))
        x = torch.from_numpy(x.astype(np.float32 if x.dtype.kind == "f"
                                      else np.uint8))
        _, out = tx(tx.init_state(), x)
        iq = out["iq"]
        iq = iq.to_complex() if isinstance(iq, IqPair) else iq
        assert iq.is_complex() and iq.shape[:-1] == rows
        assert bool(torch.isfinite(torch.view_as_real(iq)).all()), name


def test_factories_default_to_cuda():
    """With no device a factory builds on CUDA, and raises without a card
    (core.resolve_device)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.rx_chain("GMSK2K")
