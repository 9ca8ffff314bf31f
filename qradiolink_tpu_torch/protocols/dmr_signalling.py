"""DMR Tier III trunking signalling: CSBK builders + standard PDUs (a copy
of qradiolink_tpu/protocols/dmr_signalling.py on the port's
protocols.dmr).

Re-derivation of reference src/DMR/signalling.cpp:1-935 +
src/DMR/standard_PDU.h: the control-channel CSBK vocabulary a trunked
site exchanges with subscribers — registration/ALOHA broadcasts,
presence/auth AHOYs, voice and packet-data channel grants, ACK/NACK
reply flavors, and channel clear-downs. Every builder returns a
protocols.dmr.Csbk ready for make_csbk_burst; field packing matches
the reference bit-for-bit (the values are ETSI TS 102 361-4 PDU
constants).
"""

from __future__ import annotations

from qradiolink_tpu_torch.protocols.dmr import (
    Csbk, CSBKO_ACKD, CSBKO_AHOY, CSBKO_C_BCAST, CSBKO_NACKRSP,
    CSBKO_PV_GRANT, CSBKO_TV_GRANT, CSBKO_PD_GRANT, CSBKO_TD_GRANT,
    CSBKO_P_CLEAR, CSBKO_UUVREQ,
)


class StandardAddresses:
    """ETSI gateway identities (standard_PDU.h:21-40)."""
    ALLMSI = 0xFFFED4
    REGI = 0xFFFEC6
    TSI = 0xFFFECA
    ALLMSIDL = 0xFFFFFD
    ALLMSID = 0xFFFFFF
    SDMI = 0xFFFEC5
    TATTSI = 0xFFFED7
    DGNAI = 0xFFFED6
    DIVERTI = 0xFFFEC9
    MSI = 0xFFFEC7
    GPI = 0xFFFECE
    AUTHI = 0xFFFECD
    SUPLI = 0xFFFEC4
    DISPATI = 0xFFFECB
    LINEI = 0xFFFEC2
    IPI = 0xFFFEC3
    HDATA_GW = 0xFFFD02


class ServiceKind:
    """Service kinds in AHOY/grant CBF low nibble (standard_PDU.h:42-59)."""
    IndivVoiceCall = 0
    GroupVoiceCall = 1
    IndivPacketDataCall = 2
    GroupPacketDataCall = 3
    IndivUDTDataCall = 4
    GroupUDTDataCall = 5
    UDTDataPolling = 6
    StatusTransport = 7
    CallDiversion = 8
    CallAnswer = 9
    FullDuplexVoiceCall = 10
    FullDuplexDataCall = 11
    SupplementaryServ = 13
    RegiAuthMSCheck = 14
    CancelCall = 15


def registration_request(system_identity_code: int) -> Csbk:
    """C_BCAST announcing mass registration (signalling.cpp:321-342)."""
    announcement_type = 0x04 << 3            # MassReg
    par = 3                                  # PAR AB
    system_id = ((system_identity_code & 0x3FFF) << 2) | par
    data3 = (1 << 4) << 16                   # reg flag
    data3 |= 8 << 16                         # random backoff
    data3 |= system_id
    return Csbk(csbko=CSBKO_C_BCAST, fid=0x00, data1=announcement_type,
                cbf=8 << 2, dst_id=data3, src_id=0)


def _grant(csbko: int, channel: int, slot: int, src_id: int,
           dst_id: int, late_entry: bool = False,
           emergency: bool = False) -> Csbk:
    """Common grant packing (signalling.cpp:571-662): physical channel
    split across data1 (high bits) and CBF (low nibble + slot/flags)."""
    c1 = (channel >> 4) & 0xFF
    data2 = ((channel & 0x0F) << 4)
    data2 |= ((slot - 1) << 3) & 0x08
    data2 |= (1 << 2) if late_entry else 0
    data2 |= (1 << 1) if emergency else 0
    return Csbk(csbko=csbko, fid=0x00, data1=c1, cbf=data2,
                dst_id=dst_id, src_id=src_id)


def private_voice_grant(channel: int, slot: int, src_id: int,
                        dst_id: int, **kw) -> Csbk:
    return _grant(CSBKO_PV_GRANT, channel, slot, src_id, dst_id, **kw)


def group_voice_grant(channel: int, slot: int, src_id: int,
                      dst_id: int, **kw) -> Csbk:
    return _grant(CSBKO_TV_GRANT, channel, slot, src_id, dst_id, **kw)


def private_data_grant(channel: int, slot: int, src_id: int,
                       dst_id: int, **kw) -> Csbk:
    return _grant(CSBKO_PD_GRANT, channel, slot, src_id, dst_id, **kw)


def group_data_grant(channel: int, slot: int, src_id: int,
                     dst_id: int, **kw) -> Csbk:
    return _grant(CSBKO_TD_GRANT, channel, slot, src_id, dst_id, **kw)


def grant_channel_slot(csbk: Csbk) -> tuple[int, int]:
    """Inverse of _grant: (physical channel, slot 1|2)."""
    channel = (csbk.data1 << 4) | ((csbk.cbf >> 4) & 0x0F)
    slot = ((csbk.cbf >> 3) & 1) + 1
    return channel, slot


def presence_check_ahoy(target_id: int, group: bool = False) -> Csbk:
    """AHOY presence check (signalling.cpp:453-464)."""
    data2 = ServiceKind.RegiAuthMSCheck | ((1 << 6) if group else 0)
    return Csbk(csbko=CSBKO_AHOY, fid=0x00, data1=0x00, cbf=data2,
                dst_id=target_id & 0xFFFFFF,
                src_id=StandardAddresses.TSI)


def auth_check_ahoy(target_id: int, challenge: int,
                    options: int = 0) -> Csbk:
    """AHOY authentication challenge (signalling.cpp:465-476)."""
    return Csbk(csbko=CSBKO_AHOY, fid=0x00, data1=(options << 1) & 0xFF,
                cbf=ServiceKind.RegiAuthMSCheck,
                dst_id=target_id & 0xFFFFFF,
                src_id=challenge & 0xFFFFFF)


def private_voice_call_request(src_id: int, dst_id: int,
                               local: bool = True) -> Csbk:
    """UU_V_Req (signalling.cpp:543-555)."""
    return Csbk(csbko=CSBKO_UUVREQ, fid=0x00,
                data1=0x40 if local else 0x00,
                cbf=ServiceKind.IndivVoiceCall,
                dst_id=dst_id, src_id=src_id)


def _ackd(dst_id: int, src_id: int, reason: int,
          response_info: int = 0) -> Csbk:
    data1 = ((response_info << 1) | (reason >> 7)) & 0xFF
    return Csbk(csbko=CSBKO_ACKD, fid=0x00, data1=data1,
                cbf=(reason << 1) & 0xFF, dst_id=dst_id, src_id=src_id)


def reply_message_accepted(dst_id: int, src_id: int,
                           from_ts: bool = True) -> Csbk:
    """ACKD message_accepted (signalling.cpp:477-492)."""
    return _ackd(dst_id, src_id, 0x60 if from_ts else 0x44)


def reply_registration_accepted(dst_id: int) -> Csbk:
    """ACKD registration accepted (signalling.cpp:493-503)."""
    return Csbk(csbko=CSBKO_ACKD, fid=0x00, data1=0xFE, cbf=0xC4,
                dst_id=dst_id, src_id=StandardAddresses.REGI)


def reply_wait_for_signalling(dst_id: int) -> Csbk:
    """ACKD wait (signalling.cpp:836-845, reason 0x10)."""
    return _ackd(dst_id, StandardAddresses.TSI, 0x10)


def reply_call_queued(dst_id: int) -> Csbk:
    """ACKD queued (signalling.cpp:846-860, reason 0xA0)."""
    return _ackd(dst_id, StandardAddresses.TSI, 0xA0)


def reply_call_denied(dst_id: int) -> Csbk:
    """NACK call denied (signalling.cpp:861-875, reason 0x29)."""
    c = _ackd(dst_id, StandardAddresses.TSI, 0x29)
    c.csbko = CSBKO_NACKRSP
    return c


def reply_not_registered(dst_id: int) -> Csbk:
    """NACK not registered (signalling.cpp:876-890, reason 0x2C)."""
    c = _ackd(dst_id, StandardAddresses.TSI, 0x2C)
    c.csbko = CSBKO_NACKRSP
    return c


def clear_channel(dst_id: int, group_call: bool) -> Csbk:
    """P_CLEAR channel clear-down (signalling.cpp:663-676)."""
    data2 = (1 << 6) if group_call else 0
    return Csbk(csbko=CSBKO_P_CLEAR, fid=0x00, data1=0x00, cbf=data2,
                dst_id=dst_id, src_id=StandardAddresses.TSI)


def classify(csbk: Csbk) -> str:
    """Map a received CSBK to its trunking meaning (the subscriber-side
    dispatch the reference's DMRControl trunked mode performs)."""
    if csbk.csbko == CSBKO_C_BCAST:
        return "announcement"
    if csbk.csbko == CSBKO_AHOY:
        return "ahoy"
    if csbk.csbko in (CSBKO_PV_GRANT, CSBKO_TV_GRANT,
                      CSBKO_PD_GRANT, CSBKO_TD_GRANT):
        return "grant"
    if csbk.csbko == CSBKO_ACKD:
        return "ack"
    if csbk.csbko == CSBKO_NACKRSP:
        return "nack"
    if csbk.csbko == CSBKO_P_CLEAR:
        return "clear"
    if csbk.csbko == CSBKO_UUVREQ:
        return "call_request"
    return "other"
