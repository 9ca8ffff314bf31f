"""The port's DMR call layer (protocols/dmr_control.py, dmr_stream.py,
dmr_data.py, dmr_signalling.py, dmr_utils.py) against the JAX package's,
on the CPU: the same bit streams, built once with the JAX builders and
held equal to the port's builders' output, go through both stacks
(DmrRxStream + DmrControl) in the same blocks, and the two give the same
events (header and terminator call info, voice payload bytes, talker
alias, CSBKs, data messages) and the same DmrTiming state, exactly.
DmrTxStream's bits and masks, and the data and signalling layers' round
trips, equal the JAX ones. Last, one case on the port alone: DmrMod ->
ChannelModel at 10 dB -> DmrDemod -> the stack, held to the JAX test's
gate (tests/test_dmr_call.py:198-213), since the two packages' channel
noise differs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.torch_parity  # noqa: E402,F401  (two intra-op threads)

from qradiolink_tpu.fec import ambe as jambe  # noqa: E402
from qradiolink_tpu.fec import bptc as jbptc  # noqa: E402
from qradiolink_tpu.protocols import dmr as jdmr  # noqa: E402
from qradiolink_tpu.protocols import dmr_control as jctl  # noqa: E402
from qradiolink_tpu.protocols import dmr_data as jdata  # noqa: E402
from qradiolink_tpu.protocols import dmr_signalling as jsig  # noqa: E402
from qradiolink_tpu.protocols import dmr_stream as jstream  # noqa: E402
from qradiolink_tpu.protocols import dmr_utils as jutils  # noqa: E402
from qradiolink_tpu_torch.fec import ambe, bptc  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr_control as ctl  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr_data as data  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr_signalling as sig  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr_stream as stream  # noqa: E402
from qradiolink_tpu_torch.protocols import dmr_utils as utils  # noqa: E402

CPU = "cpu"
SRC, DST = 2345678, 91
# bits a push: two slots, as tests/test_dmr_call.py feeds the stream
BLOCK = 2 * stream.SLOT_BITS


def _plain(v):
    """An event's value in a form both packages share."""
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _rx_stack(mod, dev_kw, **cfg):
    """DmrControl (RX config of tests/test_dmr_call.py) + DmrRxStream of
    one package, recording every callback in order."""
    c = mod.DmrControl(mod.DmrConfig(color_code=1, timeslot=2, source_id=0,
                                     destination_id=0, **cfg), **dev_kw)
    events = []
    for name in ("on_digital_audio", "on_header", "on_terminator",
                 "on_talker_alias", "on_gps", "on_csbk", "on_data_message"):
        setattr(c, name, lambda v, n=name: events.append((n, _plain(v))))
    return c, events


def _timing_state(t):
    return (t._time_base, t._sample_counter, list(t._slot_times),
            list(t._last_update), t._next_tx_time, t._tx, t._first)


def _run_both(bits, **cfg):
    """The same bits through both stacks in BLOCK-bit pushes."""
    jc, jev = _rx_stack(jctl, {}, **cfg)
    tc, tev = _rx_stack(ctl, {"device": CPU}, **cfg)
    js, ts = jstream.DmrRxStream(jc), stream.DmrRxStream(tc)
    for i in range(0, len(bits), BLOCK):
        assert js.push_bits(bits[i:i + BLOCK]) == \
            ts.push_bits(bits[i:i + BLOCK])
    assert tev == jev
    assert _timing_state(tc.timing) == _timing_state(jc.timing)
    assert (tc.rx_state, tc.tx_state) == (jc.rx_state, jc.tx_state)
    return tev


def _tx_voice_call(mod, dev_kw, amb, n_superframes, vocoder=True):
    """tests/test_dmr_call.py:_tx_voice_call on one package: header x2,
    the superframes (talker alias rotated through the embedded LC) and the
    terminator from a TX DmrControl; -> (bursts, payloads)."""
    cfg = mod.DmrConfig(color_code=1, timeslot=2, source_id=SRC,
                        destination_id=DST, talker_alias="TPU TEST",
                        vocoder=vocoder)
    tx = mod.DmrControl(cfg, **dev_kw)
    bursts = list(tx._voice_header_bursts())
    rng = np.random.default_rng(3)
    payloads = []
    for _ in range(n_superframes * 6):
        p = rng.integers(0, 2, (3, 49)).astype(np.uint8)
        payloads.append(p)
        voice = amb.voice_encode(p, **dev_kw)
        b27 = np.packbits(voice)
        for k in range(3):
            tx.add_tx_audio(b27[9 * k:9 * k + 9].tobytes())
        bursts.extend(tx.get_tx_bursts())
    tx.stop_voice_tx()
    bursts.extend(tx.get_tx_bursts())
    return bursts, payloads


def _flip(bits, rate, seed):
    """Seeded bit errors at `rate`."""
    rng = np.random.default_rng(seed)
    return bits ^ (rng.random(bits.size) < rate).astype(np.uint8)


def _late_entry_bits(mod, dev_kw, amb, seed=7):
    """tests/test_dmr_call.py:162-174 on one package: a BS downlink with
    slot 1 idle and slot 2 two superframes of voice (no header) and a
    terminator with LC."""
    rng = np.random.default_rng(seed)
    lc = mod.LinkControl(flco=mod.FLCO_GROUP, src_id=SRC, dst_id=DST)
    payloads = rng.integers(0, 2, (12, 3, 49)).astype(np.uint8)
    voice = amb.voice_encode(payloads, **dev_kw)
    sf1 = mod.make_voice_superframe(voice[:6], lc, 1, **dev_kw)
    sf2 = mod.make_voice_superframe(voice[6:], lc, 1, **dev_kw)
    term = mod.make_lc_burst(lc, 1, mod.DT_TERMINATOR_WITH_LC, **dev_kw)
    slot2 = list(sf1) + list(sf2) + [term]
    idle = mod.make_data_burst(np.zeros(196, np.uint8), 1, mod.DT_IDLE,
                               **dev_kw)
    builder = jstream if mod is jdmr else stream
    return builder.build_bs_stream([idle] * (len(slot2) + 2), slot2,
                                   lead_idle=2, **dev_kw), payloads


def test_builders_match_jax():
    """The call's bursts and streams built by the port equal the JAX
    builders' output bit for bit."""
    want, want_p = _late_entry_bits(jdmr, {}, jambe)
    got, got_p = _late_entry_bits(dmr, {"device": CPU}, ambe)
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got, want)
    jb, _ = _tx_voice_call(jctl, {}, jambe, 5)
    tb, _ = _tx_voice_call(ctl, {"device": CPU}, ambe, 5)
    assert len(tb) == len(jb)
    for a, b in zip(jb, tb):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("ber", [0.0, 0.02])
def test_late_entry_call_matches_jax(ber):
    """Late entry through the embedded LC, voice dead reckoning and AMBE
    regeneration, clean and at 2% bit errors (the FEC and the silence
    substitution at work), the JAX builders' bits."""
    bits, payloads = _late_entry_bits(jdmr, {}, jambe)
    ev = _run_both(_flip(bits, ber, 11), vocoder=True)
    assert sum(n == "on_digital_audio" for n, _ in ev) >= 6
    terms = [v for n, v in ev if n == "on_terminator"]
    if ber == 0.0:
        assert len(terms) == 1 and terms[0]["src_id"] == SRC
        voices = [v for n, v in ev if n == "on_digital_audio"]
        got = [ambe.voice_decode(np.unpackbits(np.frombuffer(
            v, np.uint8)), CPU)[0] for v in voices]
        assert len(got) == len(payloads)
        for g, p in zip(got, payloads):
            np.testing.assert_array_equal(g, p)


def test_header_alias_call_matches_jax():
    """Header x2, five superframes (the talker alias through the embedded
    LC rotation) and the terminator, from the JAX TX DmrControl, in a BS
    stream with a few bit errors; vocoder off (payloads as sent)."""
    bursts, _ = _tx_voice_call(jctl, {}, jambe, 5)
    idle = jdmr.make_data_burst(np.zeros(196, np.uint8), 1, jdmr.DT_IDLE)
    bits = jstream.build_bs_stream([idle] * (len(bursts) + 2), bursts,
                                   lead_idle=3)
    ev = _run_both(_flip(bits, 0.003, 5), vocoder=False)
    names = [n for n, _ in ev]
    assert names.count("on_header") >= 1 and "on_talker_alias" in names
    assert [v for n, v in ev if n == "on_talker_alias"][0].startswith(
        "TPU TEST")


def test_data_and_csbk_call_matches_jax():
    """A confirmed data call (header + rate-1/2 blocks) and trunking CSBKs
    in one stream: the same data message and CSBKs out of both stacks."""
    payload = b"packet data over DMR tier II"
    blocks = jdata.build_confirmed_blocks(payload)
    assert blocks == data.build_confirmed_blocks(payload)
    h = jdata.DataHeader(gi=True, dpf=jdata.DPF_CONFIRMED_DATA, dst_id=9,
                         src_id=SRC, blocks=len(blocks))
    np.testing.assert_array_equal(
        data.DataHeader(**dataclasses.asdict(h)).to_bytes(), h.to_bytes())
    info = np.asarray(jbptc.encode(np.unpackbits(h.to_bytes())), np.uint8)
    np.testing.assert_array_equal(
        bptc.encode(torch.from_numpy(np.unpackbits(h.to_bytes()))).numpy(),
        info)
    slot2 = [jdmr.make_csbk_burst(jsig.group_voice_grant(0x123, 2, 1000,
                                                         2000), 1),
             jdmr.make_data_burst(info, 1, jdmr.DT_DATA_HEADER)]
    slot2 += [jdmr.make_rate12_burst(np.frombuffer(b, np.uint8), 1)
              for b in blocks]
    slot2.append(jdmr.make_csbk_burst(jsig.clear_channel(9, True), 1))
    idle = jdmr.make_data_burst(np.zeros(196, np.uint8), 1, jdmr.DT_IDLE)
    bits = jstream.build_bs_stream([idle] * (len(slot2) + 2), slot2,
                                   lead_idle=1)
    ev = _run_both(bits)
    msgs = [v for n, v in ev if n == "on_data_message"]
    assert len(msgs) == 1 and msgs[0]["crc_valid"]
    assert msgs[0]["payload"].rstrip(b"\x00") == payload
    csbks = [v for n, v in ev if n == "on_csbk"]
    assert [sig.classify(dmr.Csbk(**c)) for c in csbks] == ["grant", "clear"]


def test_tx_stream_matches_jax():
    """DmrTxStream's bits and masks across block boundaries
    (tests/test_dmr_call.py:234), simplex and duplex, equal the JAX
    scheduler's, as do the launch samples on an RX-derived grid."""
    burst = (np.arange(264) % 2).astype(np.uint8)
    for duplex in (False, True):
        out = []
        for mod, smod, kw in ((jctl, jstream, {}),
                              (ctl, stream, {"device": CPU})):
            c = mod.DmrControl(mod.DmrConfig(timeslot=1), **kw)
            c.timing.increment_sample_counter(1234)
            c.timing.set_slot_times(1)
            txs = smod.DmrTxStream(c, duplex=duplex)
            txs.send_bursts([burst] * 3)
            c.timing.set_tx_time(True)
            txs.send_bursts([burst, 1 - burst], slot_no=1)
            launches = [q[0] for q in txs._queue]
            blocks = [txs.next_block(n) for n in (1005, 2500, 720, 4000)]
            out.append((launches, blocks))
        (jl, jb), (tl, tb) = out
        assert tl == jl
        for (jbits, jmask), (tbits, tmask) in zip(jb, tb):
            np.testing.assert_array_equal(tbits, jbits)
            np.testing.assert_array_equal(tmask, jmask)


def test_signalling_roundtrips_match_jax():
    """Every CSBK builder (tests/test_dmr_signalling.py), through the BPTC
    burst layer and back: the same bursts and the same decoded fields and
    meanings."""
    calls = [("private_voice_grant", (0x123, 2, 1000, 2000)),
             ("group_voice_grant", (0x0AB, 1, 3, 4)),
             ("private_data_grant", (7, 2, 5, 6)),
             ("group_data_grant", (8, 1, 7, 8)),
             ("presence_check_ahoy", (777,)),
             ("auth_check_ahoy", (777, 0xABCDEF, 3)),
             ("private_voice_call_request", (11, 22)),
             ("reply_message_accepted", (5, 6)),
             ("reply_registration_accepted", (9,)),
             ("reply_wait_for_signalling", (9,)),
             ("reply_call_queued", (9,)),
             ("reply_call_denied", (9,)),
             ("reply_not_registered", (9,)),
             ("clear_channel", (91, True)),
             ("registration_request", (0x1234,))]
    for name, args in calls:
        jc, tc = getattr(jsig, name)(*args), getattr(sig, name)(*args)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
        jb = jdmr.make_csbk_burst(jc, color_code=1)
        tb = dmr.make_csbk_burst(tc, color_code=1, device=CPU)
        np.testing.assert_array_equal(tb, jb)
        got = dmr.Csbk.from_bytes(dmr.decode_burst(tb, CPU).payload[:12])
        want = jdmr.Csbk.from_bytes(jdmr.decode_burst(jb).payload[:12])
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert sig.classify(got) == jsig.classify(want)
        if sig.classify(got) == "grant":
            assert sig.grant_channel_slot(got) == \
                jsig.grant_channel_slot(want)


def test_data_layer_matches_jax():
    """Data headers of every format, CRC9 / CRC32, the confirmed blocks and
    the reassembly (tests/test_dmr_data.py) equal the JAX module's."""
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 31):
        b = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert data.crc9(b) == jdata.crc9(b)
        assert data.crc32_dmr(b) == jdata.crc32_dmr(b)
    for dpf in (data.DPF_UDT, data.DPF_RESPONSE, data.DPF_UNCONFIRMED_DATA,
                data.DPF_CONFIRMED_DATA, data.DPF_DEFINED_SHORT,
                data.DPF_PROPRIETARY):
        kw = dict(gi=True, dpf=dpf, dst_id=91, src_id=777, blocks=3, sap=9,
                  pad_nibble=5, ns=2, s=True, f=True, udt_format=4,
                  opcode=7)
        jb = jdata.DataHeader(**kw).to_bytes()
        tb = data.DataHeader(**kw).to_bytes()
        np.testing.assert_array_equal(tb, jb)
        for raw in (tb, tb ^ np.eye(12, dtype=np.uint8)[3] * 0x10):
            j, t = jdata.DataHeader.from_bytes(raw), \
                data.DataHeader.from_bytes(raw)
            assert (t is None) == (j is None)
            if t is not None:
                assert dataclasses.asdict(t) == dataclasses.asdict(j)
    payload = b"The quick brown fox jumps over the lazy DMR"
    blocks = data.build_confirmed_blocks(payload)
    assert blocks == jdata.build_confirmed_blocks(payload)
    bad = list(blocks)
    bad[1] = bytes([bad[1][0] ^ 1]) + bad[1][1:]
    for blist in (blocks, bad):
        out = []
        for m in (jdata, data):
            h = m.DataHeader(dpf=m.DPF_CONFIRMED_DATA, dst_id=91,
                             src_id=777, blocks=len(blist))
            mh = m.DmrMessageHandler()
            mh.process_header(bytes(h.to_bytes()))
            msg = [mh.process_block(m.DT_RATE_12_DATA, b, 777)
                   for b in blist][-1]
            out.append(dataclasses.asdict(msg))
        assert out[1] == out[0]
    assert out[0]["crc_valid"] is False


def test_utils_match_jax(tmp_path):
    """Group-number arithmetic, text parsing, the RC4 challenge and the ID
    lookup (tests/test_dmr_signalling.py) equal the JAX module's."""
    for g in (0, 1, 91, 2350, 99_998, 123_456, 9_999_999):
        assert utils.base11(g) == jutils.base11(g)
        assert utils.base11_group_to_base10(g) == \
            jutils.base11_group_to_base10(g)
        assert utils.base10_group_to_base11(g) == \
            jutils.base10_group_to_base11(g)
    assert utils.p3_group_to_cai(32_921_901) == \
        jutils.p3_group_to_cai(32_921_901)
    text = "DMR text".encode("utf-16-be")
    assert utils.parse_utf16(text) == jutils.parse_utf16(text)
    iso = bytes([0x89, 0x36, 0x98, 0xA0, 0x00])
    assert utils.parse_iso7(iso) == jutils.parse_iso7(iso)
    key = bytes(range(16))
    assert utils.auth_challenge_response(key, 0x123456) == \
        jutils.auth_challenge_response(key, 0x123456)
    assert utils.auth_check(key, *jutils.auth_challenge_response(key, 77))
    ids = tmp_path / "DMRIds.dat"
    ids.write_text("2345678,N0CALL,Op\n91\tTG,x,y\nbad line\n")
    t, j = utils.DmrIdLookup(ids), jutils.DmrIdLookup(ids)
    assert len(t) == len(j) == 2
    for i in (2345678, 91, 5):
        assert t.lookup(i) == j.lookup(i)
    raw = np.arange(9, dtype=np.uint8) * 29
    assert ctl.extract_gps(raw) == jctl.extract_gps(raw)


def test_late_entry_iq_loopback_10db():
    """The port alone, end to end: DmrMod -> ChannelModel (10 dB) ->
    DmrDemod -> DmrRxStream -> DmrControl on the CPU, held to the JAX
    test's gate: one terminator with the call's src/dst (recovered from
    the embedded LC, late entry), at least 8 of the 12 voice bursts
    FEC-recovered to the sent payloads, slot timing captured."""
    from qradiolink_tpu_torch.chains.channel import ChannelModel
    from qradiolink_tpu_torch.chains.dmr import DmrDemod, DmrMod

    bits, payloads = _late_entry_bits(dmr, {"device": CPU}, ambe)
    mod = DmrMod(device=CPU)
    _, txo = mod(mod.init_state(), torch.from_numpy(bits))
    iq = ChannelModel(1_000_000, snr_db=10.0, seed=5)(txo["iq"])
    m = iq.shape[-1] - iq.shape[-1] % 625
    dem = DmrDemod(device=CPU)
    _, rxo = dem(dem.init_state(), iq[..., :m])
    rx_bits = rxo["bits"].numpy()

    c, ev = _rx_stack(ctl, {"device": CPU}, vocoder=True)
    rx = stream.DmrRxStream(c)
    for i in range(0, len(rx_bits), BLOCK):
        rx.push_bits(rx_bits[i:i + BLOCK])
    terms = [v for n, v in ev if n == "on_terminator"]
    assert len(terms) == 1
    assert (terms[0]["src_id"], terms[0]["dst_id"]) == (SRC, DST)
    sent = {tuple(np.packbits(p.reshape(-1))) for p in payloads}
    ok = 0
    for n, v in ev:
        if n == "on_digital_audio":
            dec, _ = ambe.voice_decode(
                np.unpackbits(np.frombuffer(v, np.uint8)), CPU)
            ok += tuple(np.packbits(dec.reshape(-1))) in sent
    assert ok >= 8, f"only {ok} voice bursts FEC-recovered at 10 dB"
    assert c.timing._slot_times[1] > 0 and c.timing.timing_recent(2)


def test_control_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ctl.DmrControl(ctl.DmrConfig())
