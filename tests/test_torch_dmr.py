"""The DMR chains of the port against the JAX package's on the CPU, and the
port's own DMR loopback.

The demodulators (DmrDemod, DmrDemodFF) are compared as the M17 ones are
(tests/test_torch_m17.py: the port's DmrMod IQ with noise at 0.05 a
plane, 2 rows, two blocks of 25,000 samples; "direct" with the JAX RRC
(K125, an FFT on the CPU) in direct form and a ~1e-20 start, every bit
equal; "fft" with the JAX chain as it is, without the ~1e-20 start, bits
equal wherever the JAX decision is not within the symbol bound of its
threshold, 0 or the magnitude 0.9). Symbols, `soft` and constellation
within 2e-5 of the symbols' peak (measured 7.4e-6 against the FFT RRC:
DMR's loop gain, 0.2869, 3.4x M17's, carries the RRC's difference further
into the timing), rssi within 1e-5 dB, every state leaf within 2e-5 of
its peak.

DmrMod with and without a TDMA mask (one 720-sample slot in three zeroed
at 24 ksps), with complex and IqPair output: IQ and every state leaf
within 2e-4, FrequencyMod's cumulative phase (measured 5.2e-5), as
M17Mod's. The mask zeroes the slot's IQ on the port too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qradiolink_tpu.chains import dmr as jdmr  # noqa: E402
from qradiolink_tpu_torch.chains import dmr  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr as pdmr  # noqa: E402
from tests.test_torch_m17 import (BLOCK, TX_TOL, compare_demod,  # noqa: E402
                                  direct_rrc, rx_blocks)
from tests.torch_parity import stream_both, to_jax, to_torch  # noqa: E402

CHAINS = {"dmr": (jdmr.DmrDemod, dmr.DmrDemod),
          "dmr_ff": (jdmr.DmrDemodFF, dmr.DmrDemodFF)}
SLOT = 720           # samples at 24 ksps: one 30 ms TDMA slot
SYM_TOL = 2e-5       # relative to the symbols' peak


@pytest.fixture(scope="module")
def dmr_blocks():
    mod = dmr.DmrMod(lead_shape=(2,), device="cpu")
    return {"direct": rx_blocks(mod, 2, BLOCK, 6, 200),
            "fft": rx_blocks(mod, 2, BLOCK, 6, 0)}


@pytest.mark.parametrize("rrc", ["fft", "direct"])
@pytest.mark.parametrize("name", sorted(CHAINS))
def test_demod_matches_jax(dmr_blocks, name, rrc):
    make_jax, make_torch = CHAINS[name]
    jd = make_jax(lead_shape=(2,))
    if rrc == "direct":
        jd = direct_rrc(jd)
    near = compare_demod(jd, make_torch(lead_shape=(2,), device="cpu"),
                         dmr_blocks[rrc], 0.9, exact_bits=rrc == "direct",
                         tol=SYM_TOL)
    # within the bound of a threshold: the loop's first symbols, read from
    # its zero initial tail, and the ~1e-20 start's (2 bits a symbol)
    assert near <= 32, near


def slot_mask(n24, C=2):
    """One 720-sample slot in three zeroed, the rows offset by a slot."""
    t = np.arange(n24)
    return np.stack([(((t // SLOT) + c) % 3 != 1) for c in range(C)]
                    ).astype(np.float32)


class Masked:
    """A DmrMod given block i's mask (numpy, converted by `conv`) with
    block i's bits, for stream_both."""

    def __init__(self, mod, masks, conv):
        self.mod, self.masks, self.conv, self.i = mod, masks, conv, 0

    def init_state(self):
        self.i = 0
        return self.mod.init_state()

    def __call__(self, state, bits):
        mask = self.conv(self.masks[self.i])
        self.i += 1
        return self.mod(state, bits, mask=mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("pair", [False, True])
def test_mod_matches_jax(rng, pair, masked):
    """Two blocks of 9,600 bits a row (24,000 samples at 24 ksps, a
    multiple of the 125/3 interpolator's 3): IQ and every state leaf
    within 2e-4."""
    bits = rng.integers(0, 2, (2, 2 * 9_600)).astype(np.uint8)
    jm = jdmr.DmrMod(lead_shape=(2,), pair=pair)
    tm = dmr.DmrMod(lead_shape=(2,), pair=pair, device="cpu")
    if masked:
        masks = np.split(slot_mask(2 * 24_000), 2, axis=-1)
        jm, tm = Masked(jm, masks, to_jax), Masked(tm, masks, to_torch)
    stream_both(jm, tm, np.split(bits, 2, axis=-1), rtol=0.0, atol=TX_TOL)


def test_mask_zeroes_the_idle_slot(rng):
    """The mask's zeroed slot gives near-zero RF at 1 Msps on the port
    (tests/test_chains_dmr.py's check): the power in the slot's middle
    10,000 samples below 1e-3 of the power outside."""
    bits = rng.integers(0, 2, (2, 9_600)).astype(np.uint8)
    mask = slot_mask(24_000)
    mod = dmr.DmrMod(lead_shape=(2,), device="cpu")
    iq = mod(mod.init_state(), torch.from_numpy(bits),
             mask=torch.from_numpy(mask))[1]["iq"].numpy()
    for c in range(2):
        z0 = int(np.nonzero(mask[c] == 0)[0][0])
        mid = (z0 + SLOT // 2) * 125 // 3
        idle = np.mean(np.abs(iq[c, mid - 5000:mid + 5000]) ** 2)
        busy = np.mean(np.abs(iq[c, :(z0 - 100) * 125 // 3]) ** 2)
        assert idle < 1e-3 * busy, (c, idle, busy)


def make_transmission(device="cpu"):
    """tests/test_chains_dmr.py's transmission: a voice LC header, a voice
    superframe A-F with the embedded LC and the terminator, color code 1,
    on the port's protocol layer."""
    rng = np.random.default_rng(11)
    lc = pdmr.LinkControl(flco=pdmr.FLCO_GROUP, dst_id=91, src_id=2405321)
    voice = rng.integers(0, 2, (6, 216)).astype(np.uint8)
    header = pdmr.make_lc_burst(lc, color_code=1,
                                data_type=pdmr.DT_VOICE_LC_HEADER,
                                device=device)
    superframe = pdmr.make_voice_superframe(voice, lc, color_code=1,
                                            device=device)
    term = pdmr.make_lc_burst(lc, color_code=1,
                              data_type=pdmr.DT_TERMINATOR_WITH_LC,
                              device=device)
    return lc, voice, [header, *superframe, term]


def tx_stream(bursts, lead_frames=8, tail_frames=2):
    """The bursts between idle dibits (alternating levels, letting the RX
    loops lock), padded so the 24 ksps count is a multiple of 3."""
    pad = np.tile([0, 1, 1, 1], 66 * lead_frames)
    tail = np.tile([0, 1, 1, 1], 66 * tail_frames)
    bits = np.concatenate([pad] + [np.asarray(b).ravel() for b in bursts]
                          + [tail]).astype(np.uint8)
    need = (-len(bits) * 5 // 2) % 6
    return np.concatenate([bits, np.zeros(need * 2, np.uint8)])


def decode_stream(rx_bits, device="cpu"):
    """Sync hunt, then voice frames B..F by dead reckoning after a voice
    sync (tests/test_chains_dmr.py's _decode_stream)."""
    hits = dict(pdmr.find_bursts(rx_bits))
    starts = set(hits)
    for s, name in list(hits.items()):
        if name.endswith("audio"):
            for k in range(1, 6):
                p = s + k * pdmr.FRAME_BITS
                if p + pdmr.FRAME_BITS <= len(rx_bits):
                    starts.add(p)
    return [pdmr.decode_burst(rx_bits[s:s + pdmr.FRAME_BITS], device)
            for s in sorted(starts)]


def test_dmr_loopback_clean():
    """DmrMod -> DmrDemod -> find_bursts -> decode_burst on the port alone,
    as tests/test_chains_dmr.py's clean loopback: the header's LC, frame
    A's voice bits exact and the embedded LC from frames B..E."""
    lc, voice, bursts = make_transmission()
    mod, dem = dmr.DmrMod(device="cpu"), dmr.DmrDemod(device="cpu")
    iq = mod(mod.init_state(), torch.from_numpy(tx_stream(bursts)))[1]["iq"]
    iq = iq[: iq.shape[-1] - iq.shape[-1] % 625]
    rx_bits = dem(dem.init_state(), iq)[1]["bits"].numpy()
    decoded = decode_stream(rx_bits)
    kinds = [d.kind for d in decoded]
    assert kinds.count("data") >= 2 and kinds.count("voice_sync") >= 1 \
        and kinds.count("voice") >= 4, kinds
    headers = [d for d in decoded if d.kind == "data"
               and d.data_type == pdmr.DT_VOICE_LC_HEADER]
    assert headers and headers[0].ok
    assert (headers[0].lc.src_id, headers[0].lc.dst_id) == (lc.src_id,
                                                            lc.dst_id)
    va = [d for d in decoded if d.kind == "voice_sync"][0]
    np.testing.assert_array_equal(va.voice_bits, voice[0])
    asm, out = pdmr.EmbeddedLCAssembler(device="cpu"), None
    for d in decoded:
        if d.kind == "voice":
            out = out or asm.add(d.embedded_fragment, d.emb_lcss)
    assert out is not None and out.src_id == lc.src_id
