"""The port's wire codec, mirroring tests/test_codec.py (SURVEY.md C7 / §4
"codec round-trip") case for case, and byte for byte against the JAX
package's codec.

The reference's format: 3-4 ASCII bytes, one ``'0'+value`` char per field
(intToChar/charToInt, pbft-node.cc:57-63), fields capped 0-9 (quirk #11),
block payloads '1'-filled with the header overwriting the first bytes
(generateTX, pbft-node.cc:79-95).
"""

import pytest

from blockchain_simulator_tpu.utils import codec as jcodec
from blockchain_simulator_tpu_torch.utils import codec


def test_int_char_inverse():
    for v in range(10):
        assert codec.char_to_int(codec.int_to_char(v)) == v
    assert codec.int_to_char(5) == ord("5")


def test_roundtrip_every_message_type():
    for proto, schemas in codec.SCHEMAS.items():
        for name, fields in schemas.items():
            vals = tuple((i + 3) % 10 for i in range(len(fields)))
            if (proto, name) == ("paxos", "RESPONSE_TICKET"):
                vals = (0,) + vals[1:]  # SUCCESS: the only state whose reply
                # carries the command byte (state-conditional schema)
            wire = codec.encode(proto, name, *vals)
            assert len(wire) == 1 + len(fields)  # 3-4 ASCII bytes (1-3 here)
            back_name, back = codec.decode(proto, wire)
            assert back_name == name
            assert tuple(back[f] for f in fields) == vals


def test_quirk11_cap():
    # strict: the 0-9 cap is enforced
    with pytest.raises(ValueError, match="single-char"):
        codec.encode("paxos", "REQUEST_TICKET", 10)
    # non-strict: the reference's silent corruption, byte-for-byte
    # ('0'+10 == ':'), and charToInt faithfully un-corrupts it
    wire = codec.encode("paxos", "REQUEST_TICKET", 10, strict=False)
    assert wire[1:] == b":"
    _, back = codec.decode("paxos", wire)
    assert back["ticket"] == 10


def test_block_payload():
    # PBFT PRE_PREPARE rides a 50 tx x 1 KB block: wire length is the block
    # size (the header overwrites bytes 0..3 of the '1' fill)
    wire = codec.encode("pbft", "PRE_PREPARE", 1, 0, 0, payload_txs=50,
                        tx_size=1000)
    assert len(wire) == 50_000
    assert wire[:4] == b"1100"  # type=1, v=1, n=0, val=0
    assert set(wire[4:]) == {ord("1")}
    name, fields = codec.decode("pbft", wire)
    assert name == "PRE_PREPARE" and fields == {"v": 1, "n": 0, "val": 0}


def test_unused_types_rejected():
    # REQUEST/PRE_PREPARE_RES/REPLY are declared but unused (pbft-node.h:82-89)
    with pytest.raises(ValueError, match="no wire schema"):
        codec.encode("pbft", "REQUEST")
    with pytest.raises(ValueError, match="unknown/unused"):
        codec.decode("pbft", bytes([codec.int_to_char(7)]))  # REPLY
    with pytest.raises(ValueError, match="unknown protocol"):
        codec.encode("pbkdf", "X")


def test_truncated_packet_rejected():
    wire = codec.encode("pbft", "PREPARE", 1, 2, 3)
    with pytest.raises(ValueError, match="needs"):
        codec.decode("pbft", wire[:2])


def test_paxos_response_ticket_failed_drops_command():
    # The FAILED promise is ['type','fail'] only — upstream leaves byte 3
    # uninitialized (paxos-node.cc:190-193), so decoding must not surface a
    # garbage 'command' field as meaningful.  SUCCESS (0) carries it.
    ok = codec.encode("paxos", "RESPONSE_TICKET", 0, 7)
    name, fields = codec.decode("paxos", ok)
    assert name == "RESPONSE_TICKET" and fields == {"state": 0, "command": 7}
    # the FAILED reply encodes AND decodes as the 2-byte form
    failed = codec.encode("paxos", "RESPONSE_TICKET", 1)
    assert failed == bytes([codec.int_to_char(3), codec.int_to_char(1)])
    name, fields = codec.decode("paxos", failed)
    assert name == "RESPONSE_TICKET" and fields == {"state": 1}
    # and a FAILED reply that happens to carry a garbage third byte ignores it
    name, fields = codec.decode("paxos", failed + b"\x07")
    assert fields == {"state": 1}


def test_same_tables_and_bytes_as_the_jax_codec():
    assert codec.SCHEMAS == jcodec.SCHEMAS
    for proto, schemas in codec.SCHEMAS.items():
        for name, fields in schemas.items():
            vals = tuple((i + 7) % 12 for i in range(len(fields)))
            if (proto, name) == ("paxos", "RESPONSE_TICKET"):
                vals = (0,) + vals[1:]
            wire = codec.encode(proto, name, *vals, strict=False)
            assert wire == jcodec.encode(proto, name, *vals, strict=False)
            assert codec.decode(proto, wire) == jcodec.decode(proto, wire)
