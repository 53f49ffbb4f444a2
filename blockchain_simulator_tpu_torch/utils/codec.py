"""Wire codec (a copy of ``blockchain_simulator_tpu/utils/codec.py``, which is
pure Python) — the reference's ASCII message format (SURVEY.md C7).

The reference encodes every protocol message as 3-4 ASCII bytes, one char per
field, via ``intToChar``/``charToInt`` (``'0' + value``): pbft-node.cc:57-63,
raft-node.cc:54-60, paxos-node.cc:49-55.  Consequence (quirk #11): every field
— view numbers, seq numbers, tickets, node ids — is capped at 0-9; anything
larger silently corrupts into ``':'``, ``';'``, ... (the reference never
checks).  Block-carrying messages append a ``'1'``-filled tx payload whose
first bytes the header overwrites (``generateTX``, pbft-node.cc:79-95,
raft-node.cc:323-336).

The tensorized backends deliberately design this away (channels carry int
fields directly — there is nothing to parse), so the codec exists as the
boundary component: encoding a simulated message stream to the reference's
exact wire format (e.g. for trace export) and decoding such bytes back.
``strict=True`` raises on out-of-range fields; ``strict=False`` reproduces
the reference's silent corruption byte-for-byte.

Message schemas below are the complete wire protocol from SURVEY.md §2
("Protocol message formats"), with the declared-but-unused types included.
"""

from __future__ import annotations

# --- the three per-protocol Message enums ----------------------------------
# pbft-node.h:80-91
PBFT_TYPES = {
    "REQUEST": 0, "PRE_PREPARE": 1, "PREPARE": 2, "COMMIT": 3,
    "PRE_PREPARE_RES": 4, "PREPARE_RES": 5, "COMMIT_RES": 6, "REPLY": 7,
    "VIEW_CHANGE": 8,
}
# raft-node.h:81-89
RAFT_TYPES = {
    "CLIENT_REQ": 0, "CLIENT_RES": 1, "VOTE_REQ": 2, "VOTE_RES": 3,
    "HEARTBEAT": 4, "HEARTBEAT_RES": 5,
}
# paxos-node.h:72-81
PAXOS_TYPES = {
    "REQUEST_TICKET": 0, "REQUEST_PROPOSE": 1, "REQUEST_COMMIT": 2,
    "RESPONSE_TICKET": 3, "RESPONSE_PROPOSE": 4, "RESPONSE_COMMIT": 5,
    "CLIENT_PROPOSE": 6,
}

# field layout per (protocol, type): header byte 0 is always the type char.
# (SURVEY.md §2 message-format table; field names follow the reference code.)
SCHEMAS = {
    "pbft": {
        "PRE_PREPARE": ("v", "n", "val"),      # pbft-node.cc:89-93
        "PREPARE": ("v", "n", "val"),          # pbft-node.cc:196-209
        "PREPARE_RES": ("v", "n", "state"),    # pbft-node.cc:215-220
        "COMMIT": ("v", "n"),                  # pbft-node.cc:231-238
        "COMMIT_RES": ("v", "n"),              # built, never sent (:249-253)
        "VIEW_CHANGE": ("v", "leader"),        # pbft-node.cc:294-303
    },
    "raft": {
        "VOTE_REQ": ("id",),                   # raft-node.cc:392-401
        "VOTE_RES": ("state",),                # raft-node.cc:154-167
        "HEARTBEAT": ("hb_type", "val"),       # raft-node.cc:405-429
        "HEARTBEAT_RES": ("hb_type", "state"),  # raft-node.cc:170-193
    },
    "paxos": {
        "REQUEST_TICKET": ("ticket",),           # paxos-node.cc:511-518
        # state-conditional: the SUCCESS promise carries the stored command,
        # the FAILED reply is ['type','fail'] only — its byte 3 is
        # uninitialized stack garbage upstream (paxos-node.cc:177-197), so
        # decode() returns 'command' only when state == SUCCESS (0)
        "RESPONSE_TICKET": ("state", "command"),
        "REQUEST_PROPOSE": ("ticket", "command"),  # paxos-node.cc:258-274
        "RESPONSE_PROPOSE": ("state",),          # paxos-node.cc:199-221
        "REQUEST_COMMIT": ("ticket", "command"),  # paxos-node.cc:295-305
        "RESPONSE_COMMIT": ("state",),           # paxos-node.cc:222-247
        "CLIENT_PROPOSE": (),                    # paxos-node.cc:357-361
    },
}

_TYPE_ENUMS = {"pbft": PBFT_TYPES, "raft": RAFT_TYPES, "paxos": PAXOS_TYPES}


def int_to_char(v: int, strict: bool = True) -> int:
    """``intToChar``: ``'0' + v`` (pbft-node.cc:57-59).  One byte out.

    quirk #11: the reference accepts any int and silently produces a
    non-digit byte for v outside 0-9 (``10 -> ':'``); ``strict=True`` raises
    instead, ``strict=False`` reproduces the corruption."""
    if strict and not 0 <= v <= 9:
        raise ValueError(
            f"field value {v} does not fit the reference's single-char "
            "encoding (0-9, SURVEY.md quirk #11); pass strict=False to "
            "reproduce the silent corruption"
        )
    return ord("0") + v


def char_to_int(b: int) -> int:
    """``charToInt``: ``c - '0'`` (pbft-node.cc:61-63).  No validation —
    exactly like the reference (a corrupted byte round-trips to its
    out-of-range int)."""
    return b - ord("0")


def encode(protocol: str, msg_type: str, *fields: int, strict: bool = True,
           payload_txs: int = 0, tx_size: int = 0) -> bytes:
    """Encode one message to the reference's wire bytes.

    ``payload_txs``/``tx_size`` append a ``generateTX`` block: ``num * size``
    bytes of ``'1'`` fill whose first ``len(header)`` bytes the header
    overwrites (pbft-node.cc:79-95: the header is written INTO the block
    buffer, so the wire length is the block size, not header + block)."""
    schema = _schema(protocol, msg_type)
    # state-conditional layout: the paxos RESPONSE_TICKET FAILED reply is
    # ['type','fail'] only (paxos-node.cc:190-193) — encode it without a
    # command byte, mirroring decode()
    if (
        (protocol, msg_type) == ("paxos", "RESPONSE_TICKET")
        and fields
        and fields[0] != 0  # SUCCESS == 0 (paxos-node.h:85)
    ):
        schema = schema[:1]
    if len(fields) != len(schema):
        raise ValueError(
            f"{protocol}/{msg_type} takes fields {schema}, got {len(fields)}"
        )
    header = bytes(
        [int_to_char(_TYPE_ENUMS[protocol][msg_type], strict)]
        + [int_to_char(v, strict) for v in fields]
    )
    if payload_txs:
        block = bytearray(b"1" * max(payload_txs * tx_size, len(header)))
        block[: len(header)] = header
        return bytes(block)
    return header


def decode(protocol: str, data: bytes) -> tuple[str, dict[str, int]]:
    """Decode wire bytes to ``(msg_type, {field: value})``.

    Like ``getPacketContent`` + the ``HandleRead`` switch, only the header
    chars are read; any block payload beyond the schema is ignored."""
    if not data:
        raise ValueError("empty packet")
    enum = _TYPE_ENUMS[_check_protocol(protocol)]
    t = char_to_int(data[0])
    by_val = {v: k for k, v in enum.items()}
    if t not in by_val or by_val[t] not in SCHEMAS[protocol]:
        raise ValueError(f"unknown/unused {protocol} message type byte {data[0]!r}")
    name = by_val[t]
    schema = SCHEMAS[protocol][name]
    # state-conditional layout: a paxos RESPONSE_TICKET FAILED reply carries
    # no command (upstream leaves byte 3 uninitialized, paxos-node.cc:190-193)
    # — surface only the fields the sender actually wrote
    if (
        protocol == "paxos"
        and name == "RESPONSE_TICKET"
        and len(data) >= 2
        and char_to_int(data[1]) != 0  # SUCCESS == 0 (paxos-node.h:85)
    ):
        schema = schema[:1]
    if len(data) < 1 + len(schema):
        raise ValueError(
            f"{protocol}/{name} needs {1 + len(schema)} bytes, got {len(data)}"
        )
    return name, {f: char_to_int(data[1 + i]) for i, f in enumerate(schema)}


def _check_protocol(protocol: str) -> str:
    if protocol not in SCHEMAS:
        raise ValueError(f"unknown protocol {protocol!r}")
    return protocol


def _schema(protocol: str, msg_type: str) -> tuple[str, ...]:
    _check_protocol(protocol)
    if msg_type not in SCHEMAS[protocol]:
        raise ValueError(
            f"{protocol} has no wire schema for {msg_type!r} "
            f"(declared-but-unused types are not encodable)"
        )
    return SCHEMAS[protocol][msg_type]
