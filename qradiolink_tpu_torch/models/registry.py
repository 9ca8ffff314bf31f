"""Operating-mode registry (port of qradiolink_tpu/models/registry.py).

Mirrors the reference's mode <-> modem-type mapping (reference
src/radiocontroller.cpp:2111-2360 RX / :2361-2525 TX and the
gr_modem_types enum in src/modem_types.h): one ModeSpec per user-facing
mode with its RX/TX chain factories over this package's chains, framing
config key, and scan step. The factories (Chain) pass their keyword
arguments through to the chain, `device` among them: None (the default)
builds on CUDA, device="cpu" on the CPU; chain_keywords names those a
mode's chain takes.

    from qradiolink_tpu_torch.models import registry
    rx = registry.rx_chain("GMSK2K", lead_shape=(2048,))
    tx = registry.tx_chain("GMSK2K", lead_shape=(2048,))
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Optional

from qradiolink_tpu_torch.chains.am import AmDemod, AmMod
from qradiolink_tpu_torch.chains.dmr import DmrDemod, DmrMod
from qradiolink_tpu_torch.chains.dsss import CwMod, DsssBpskDemod, DsssBpskMod
from qradiolink_tpu_torch.chains.freedv import FreeDvDemod, FreeDvMod
from qradiolink_tpu_torch.chains.fsk import (
    Fsk2Demod, Fsk2FbDemod, Fsk2Mod, Fsk4Demod, Fsk4FbDemod, Fsk4Mod,
    GmskDemod, GmskMod)
from qradiolink_tpu_torch.chains.m17 import M17Demod, M17Mod
from qradiolink_tpu_torch.chains.mmdvm import (MmdvmDemod, MmdvmMod,
                                              MmdvmMultiRx, MmdvmMultiTx)
from qradiolink_tpu_torch.chains.nbfm import NbfmDemod, NbfmMod
from qradiolink_tpu_torch.chains.psk import (BpskDemod, BpskMod, QpskDemod,
                                            QpskMod)
from qradiolink_tpu_torch.chains.ssb import SsbDemod, SsbMod
from qradiolink_tpu_torch.chains.wbfm import WbfmDemod


@dataclass(frozen=True)
class ModeSpec:
    name: str
    kind: str                     # 'analog' | 'digital_voice' | 'digital_data'
    rx_factory: Optional["Chain"]
    tx_factory: Optional["Chain"]
    framing: Optional[str] = None   # key into MODE_FRAME_CONFIG
    scan_step_hz: int = 12500       # per-mode scan step (reference tables)
    audio_rate: int = 8000
    bit_rate: int = 0


class Chain:
    """A mode's chain factory: `cls(**fixed, **defaults)`, where a caller's
    keywords replace `defaults` and may not name a `fixed` one (the mode's
    own rate or variant). `keywords` are the names a caller may pass."""

    def __init__(self, cls, fixed=None, **defaults):
        self.cls, self.fixed, self.defaults = cls, dict(fixed or {}), defaults

    def __call__(self, **kwargs):
        return self.cls(**self.fixed, **{**self.defaults, **kwargs})

    @property
    def keywords(self) -> frozenset:
        return frozenset(inspect.signature(self.cls).parameters) \
            - frozenset(self.fixed)


def _spec(name, kind, rx, tx, framing=None, step=12500, bit_rate=0):
    return ModeSpec(name, kind, rx, tx, framing, step, bit_rate=bit_rate)


MODES = {
    "FM": _spec("FM", "analog", Chain(NbfmDemod, filter_width=5000.0),
                Chain(NbfmMod, filter_width=5000.0), step=12500),
    "NBFM": _spec("NBFM", "analog",
                  Chain(NbfmDemod, filter_width=2500.0),
                  Chain(NbfmMod, filter_width=2500.0), step=6250),
    "WBFM": _spec("WBFM", "analog", Chain(WbfmDemod), None,
                  step=200000),
    "AM": _spec("AM", "analog", Chain(AmDemod),
                Chain(AmMod), step=10000),
    "USB": _spec("USB", "analog", Chain(SsbDemod, dict(usb=True)),
                 Chain(SsbMod, dict(usb=True)), step=2500),
    "LSB": _spec("LSB", "analog", Chain(SsbDemod, dict(usb=False)),
                 Chain(SsbMod, dict(usb=False)), step=2500),
    "BPSK2K": _spec("BPSK2K", "digital_voice",
                    Chain(BpskDemod, dict(symbol_rate=2000)),
                    Chain(BpskMod, dict(symbol_rate=2000)),
                    framing="BPSK2K", bit_rate=2000),
    "BPSK1K": _spec("BPSK1K", "digital_voice",
                    Chain(BpskDemod, dict(symbol_rate=1000)),
                    Chain(BpskMod, dict(symbol_rate=1000)),
                    framing="BPSK1K", step=6250, bit_rate=1000),
    "QPSK2K": _spec("QPSK2K", "digital_voice",
                    Chain(QpskDemod, dict(symbol_rate=1000,
                                          target_rate=40_000)),
                    Chain(QpskMod, dict(symbol_rate=1000)),
                    framing="QPSK2K", step=6250, bit_rate=2000),
    "QPSK20K": _spec("QPSK20K", "digital_voice",
                     Chain(QpskDemod, dict(symbol_rate=10_000,
                                           target_rate=40_000)),
                     Chain(QpskMod, dict(symbol_rate=10_000)),
                     framing="QPSK20K", step=25000, bit_rate=20000),
    "QPSK250K": _spec("QPSK250K", "digital_data",
                      Chain(QpskDemod, dict(symbol_rate=125_000,
                                            target_rate=500_000)),
                      Chain(QpskMod, dict(symbol_rate=125_000)),
                      framing="QPSK250K", step=500000, bit_rate=250000),
    # video over DQPSK: the QPSK250K waveform with the 3122-byte video
    # frame budget (reference gr_modem.cpp:159-162, modem_types.h
    # ModemTypeQPSKVideo)
    "QPSKVideo": _spec("QPSKVideo", "video",
                       Chain(QpskDemod, dict(symbol_rate=125_000,
                                             target_rate=500_000)),
                       Chain(QpskMod, dict(symbol_rate=125_000)),
                       framing="QPSKVideo", bit_rate=250000),
    "2FSK2K": _spec("2FSK2K", "digital_voice",
                    Chain(Fsk2Demod, dict(symbol_rate=2000)),
                    Chain(Fsk2Mod, dict(symbol_rate=2000)),
                    framing="2FSK2K", bit_rate=2000),
    "2FSK1K": _spec("2FSK1K", "digital_voice",
                    Chain(Fsk2Demod, dict(symbol_rate=1000)),
                    Chain(Fsk2Mod, dict(symbol_rate=1000)),
                    framing="2FSK1K", bit_rate=1000),
    "GMSK2K": _spec("GMSK2K", "digital_voice",
                    Chain(GmskDemod, dict(symbol_rate=2000)),
                    Chain(GmskMod, dict(symbol_rate=2000)),
                    framing="GMSK2K", bit_rate=2000),
    "GMSK1K": _spec("GMSK1K", "digital_voice",
                    Chain(GmskDemod, dict(symbol_rate=1000)),
                    Chain(GmskMod, dict(symbol_rate=1000)),
                    framing="GMSK1K", bit_rate=1000),
    # reference mode table: 4FSK2K is the non-FM filter-bank variant,
    # 4FSK2KFM the FM-discriminator one (gr_demod_base.cpp:211-214)
    "4FSK2K": _spec("4FSK2K", "digital_voice",
                    Chain(Fsk4Demod), Chain(Fsk4Mod),
                    framing="4FSK2K", bit_rate=2000),
    "4FSK2KFB": _spec("4FSK2KFB", "digital_voice",
                      Chain(Fsk4FbDemod, dict(variant="2K")),
                      Chain(Fsk4Mod, dict(variant="2K")),
                      framing="4FSK2K", bit_rate=2000),
    "4FSK1KFM": _spec("4FSK1KFM", "digital_voice",
                      Chain(Fsk4Demod, dict(variant="1KFM")),
                      Chain(Fsk4Mod, dict(variant="1KFM")),
                      framing="4FSK1KFM", bit_rate=1000),
    "4FSK10KFM": _spec("4FSK10KFM", "digital_data",
                       Chain(Fsk4Demod, dict(variant="10KFM")),
                       Chain(Fsk4Mod, dict(variant="10KFM")),
                       framing="4FSK10KFM", step=50000, bit_rate=10000),
    "4FSK100K": _spec("4FSK100K", "digital_data",
                      Chain(Fsk4Demod, dict(variant="96K")),
                      Chain(Fsk4Mod, dict(variant="96K")),
                      framing="4FSK100K", step=500000, bit_rate=100000),
    "2FSK10K": _spec("2FSK10K", "digital_data",
                     Chain(Fsk2Demod, dict(symbol_rate=20_000,
                                           filter_width=25000.0,
                                           target_rate=80_000)),
                     Chain(Fsk2Mod, dict(symbol_rate=20_000,
                                         filter_width=25000.0)),
                     framing="2FSK10KFM", step=50000, bit_rate=20000),
    "2FSK2KFB": _spec("2FSK2KFB", "digital_voice",
                      Chain(Fsk2FbDemod, dict(symbol_rate=2000,
                                              filter_width=4000.0)),
                      Chain(Fsk2Mod, dict(symbol_rate=2000,
                                          filter_width=4000.0)),
                      framing="2FSK2K", bit_rate=2000),
    "2FSK1KFB": _spec("2FSK1KFB", "digital_voice",
                      Chain(Fsk2FbDemod, dict(symbol_rate=1000,
                                              filter_width=2500.0)),
                      Chain(Fsk2Mod, dict(symbol_rate=1000,
                                          filter_width=2500.0)),
                      framing="2FSK1K", bit_rate=1000),
    # GMSK10K: 20 ksym/s at 80 ksps (4 sps) with the 47-byte IP-modem
    # framing (reference gr_demod_gmsk.cpp:53-60, gr_modem.cpp:187-190,
    # radiocontroller.cpp:2269-2273 scan step 50 kHz)
    "GMSK10K": _spec("GMSK10K", "digital_data",
                     Chain(GmskDemod, dict(symbol_rate=20_000,
                                           filter_width=20000.0,
                                           target_rate=80_000)),
                     Chain(GmskMod, dict(symbol_rate=20_000,
                                         filter_width=20000.0)),
                     framing="2FSK10KFM", step=50000, bit_rate=20000),
    # reference ModemTypeBPSK8: 7-byte frames with the 8*8 bit buffer
    # (gr_modem.cpp:219-222) — the BPSK2K frame shape, not BPSK1K's
    "BPSKDSSS8": _spec("BPSKDSSS8", "digital_voice",
                       Chain(DsssBpskDemod),
                       Chain(DsssBpskMod),
                       framing="BPSK2K", bit_rate=8),
    "CW": _spec("CW", "analog", None, Chain(CwMod), step=100),
    "M17": _spec("M17", "digital_voice",
                 Chain(M17Demod), Chain(M17Mod),
                 framing="M17", bit_rate=9600),
    "DMR": _spec("DMR", "digital_voice",
                 Chain(DmrDemod), Chain(DmrMod),
                 bit_rate=9600),
}

# FreeDV: the reference's variants (src/modem_types.h FreeDV1600USB ..
# FreeDV2400ALSB); the chains carry the 8 kHz passband, the vocoder runs
# on the host and is not ported


def _freedv_entries():
    rates = {"1600": 1600, "700C": 700, "700D": 700, "800XA": 800,
             "2400A": 2400}
    out = {}
    for fdv_mode in ("1600", "700C", "700D", "800XA", "2400A"):
        for sb, usb in (("USB", True), ("LSB", False)):
            name = f"FreeDV{fdv_mode}{sb}"
            # 2400A is a wideband FSK waveform: pass the full FreeDV
            # signal band (reference ModemTypeFREEDV2400AUSB/LSB,
            # modem_types.h:38,43)
            fw = 4000.0 if fdv_mode == "2400A" else 2500.0
            out[name] = _spec(
                name, "digital_voice",
                Chain(FreeDvDemod, dict(usb=usb), filter_width=fw),
                Chain(FreeDvMod, dict(usb=usb), filter_width=fw),
                step=2500, bit_rate=rates[fdv_mode])
    return out


MODES.update(_freedv_entries())


# MMDVM / MMDVMmulti (reference ModemTypeMMDVM / ModemTypeMMDVMmulti,
# radiocontroller.cpp:1996-2003: 250 ksps device rate, baseband carried
# to an external MMDVMHost over ZeroMQ)
def _mmdvm_entries():
    return {
        # TX chains default to IqPair planes (core.get_iq fetches either
        # form to the host)
        "MMDVM": _spec("MMDVM", "mmdvm",
                       Chain(MmdvmDemod),
                       Chain(MmdvmMod, pair=True),
                       step=12500, bit_rate=9600),
        "MMDVMmulti": _spec("MMDVMmulti", "mmdvm",
                            Chain(MmdvmMultiRx, num_channels=7),
                            Chain(MmdvmMultiTx, num_channels=7, pair=True),
                            step=12500, bit_rate=9600),
    }


MODES.update(_mmdvm_entries())


# Reference gr_modem_types enum -> registry mode name (the JAX registry's,
# held to it by tests/test_torch_registry.py).
# Naming differs where the reference's is misleading: the reference's
# bare 4FSK2K/2FSK2K/2FSK1K are the FILTER-BANK variants and *FM the
# discriminator ones; this registry names the discriminator chains bare
# and suffixes the filter-bank ones FB.
MODEM_TYPE_MAP = {
    "ModemTypeBPSK2K": "BPSK2K",
    "ModemTypeBPSK1K": "BPSK1K",
    "ModemTypeBPSK8": "BPSKDSSS8",
    "ModemTypeQPSK2K": "QPSK2K",
    "ModemTypeQPSK20K": "QPSK20K",
    "ModemTypeQPSK250K": "QPSK250K",
    "ModemTypeQPSKVideo": "QPSKVideo",
    "ModemType4FSK2K": "4FSK2KFB",
    "ModemType4FSK2KFM": "4FSK2K",
    "ModemType4FSK1KFM": "4FSK1KFM",
    "ModemType4FSK10KFM": "4FSK10KFM",
    "ModemType4FSK100K": "4FSK100K",
    "ModemType2FSK2KFM": "2FSK2K",
    "ModemType2FSK1KFM": "2FSK1K",
    "ModemType2FSK2K": "2FSK2KFB",
    "ModemType2FSK1K": "2FSK1KFB",
    "ModemType2FSK10KFM": "2FSK10K",
    # dead enum entry: never constructed or selected anywhere in the
    # reference (only appearance is modem_types.h:30); the IP-modem
    # waveform it names is the same 2FSK10KFM chain
    "ModemType2FSK10KFMINET": "2FSK10K",
    "ModemTypeGMSK2K": "GMSK2K",
    "ModemTypeGMSK1K": "GMSK1K",
    "ModemTypeGMSK10K": "GMSK10K",
    "ModemTypeNBFM2500": "NBFM",
    "ModemTypeNBFM5000": "FM",
    "ModemTypeWBFM": "WBFM",
    "ModemTypeUSB2500": "USB",
    "ModemTypeLSB2500": "LSB",
    "ModemTypeCW600USB": "CW",
    "ModemTypeAM5000": "AM",
    "ModemTypeFREEDV1600USB": "FreeDV1600USB",
    "ModemTypeFREEDV700CUSB": "FreeDV700CUSB",
    "ModemTypeFREEDV700DUSB": "FreeDV700DUSB",
    "ModemTypeFREEDV800XAUSB": "FreeDV800XAUSB",
    "ModemTypeFREEDV2400AUSB": "FreeDV2400AUSB",
    "ModemTypeFREEDV1600LSB": "FreeDV1600LSB",
    "ModemTypeFREEDV700CLSB": "FreeDV700CLSB",
    "ModemTypeFREEDV700DLSB": "FreeDV700DLSB",
    "ModemTypeFREEDV800XALSB": "FreeDV800XALSB",
    "ModemTypeFREEDV2400ALSB": "FreeDV2400ALSB",
    "ModemTypeMMDVM": "MMDVM",
    "ModemTypeMMDVMmulti": "MMDVMmulti",
    "ModemTypeM17": "M17",
    "ModemTypeDMR": "DMR",
}


def get_mode(name: str) -> ModeSpec:
    try:
        return MODES[name]
    except KeyError:
        raise KeyError(f"unknown mode {name!r}; available: {sorted(MODES)}")


def rx_chain(name: str, **kwargs):
    spec = get_mode(name)
    if spec.rx_factory is None:
        raise ValueError(f"mode {name} has no RX chain")
    return spec.rx_factory(**kwargs)


def chain_keywords(name: str, rx: bool = True) -> frozenset:
    """The keywords that the mode's RX (rx=True) or TX chain takes from a
    caller (Chain.keywords); empty where the mode has no such chain."""
    spec = get_mode(name)
    factory = spec.rx_factory if rx else spec.tx_factory
    return frozenset() if factory is None else factory.keywords


def tx_chain(name: str, **kwargs):
    spec = get_mode(name)
    if spec.tx_factory is None:
        raise ValueError(f"mode {name} is RX-only")
    return spec.tx_factory(**kwargs)
