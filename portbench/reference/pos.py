"""The state hashes of a Proof-of-State submission, worked out from the
fixture's bytes: the 16 candidate states and the bridge tip that its
proof carries, each decoded and hashed here.

The wire format is Mina's bin_prot: a field element is 32 bytes
little-endian, an int or a length a variable-length integer, a list its
length and then its items, an option or a variant a tag byte and then its
payload, a versioned value its version and then the value. A state's hash
is

    body_hash  = Poseidon_fp(prefix("MinaProtoStateBody"), body fields...)
    state_hash = Poseidon_fp(prefix("MinaProtoState"), previous_state_hash, body_hash)

where the body's fields are its values in wire order, a 32-byte string
split into two 16-byte little-endian halves, a 33-byte public key into its
32-byte x (two halves) and its parity byte, a bool 0 or 1, every value
reduced mod the Pallas base field.
"""

from __future__ import annotations

from . import pasta

PREFIX_BODY, PREFIX_STATE = "MinaProtoStateBody", "MinaProtoState"

# schemas: "field", "int", "bool", ("bytes", n), "blob" (length-prefixed),
# ("list", s), ("tuple", s...), ("option", s), ("version", v, s),
# ("variant", [s...] a constructor)
POINT = ("variant", [], ["field", "field"])
COMM = ("list", POINT)
KIMCHI_PROOF = ("tuple",
                ("list", "field"),  # public
                ("list", ("tuple", ("list", "field"), POINT)),  # previous challenges
                ("tuple", ("list", COMM), COMM, ("list", COMM), COMM, COMM, ("list", POINT)),  # commitments
                ("list", ("tuple", "field", "field")),  # evaluations
                "field",  # ft_eval1
                ("tuple", ("list", ("tuple", POINT, POINT)), POINT, "field", "field", POINT, ("list", "field"),
                 ("tuple", "int", "field", "field", "field", "field")))  # opening
TIP_PROOF = ("version", 3, ("tuple", ("tuple", ("list", "field"), POINT), KIMCHI_PROOF, ("option", KIMCHI_PROOF)))
STATE_PROOF = ("tuple", TIP_PROOF, ("list", "blob"), "blob")

EPOCH = ("tuple", ("tuple", "field", "int"), "field", "field", "field", "int")
PUBKEY = ("bytes", 33)
BODY = ("tuple",
        "field",  # genesis state hash
        ("tuple", ("tuple", "field", ("bytes", 32), ("bytes", 32), "field"), "field", "field", "int",
         ("bytes", 32)),  # blockchain state
        ("tuple", "int", "int", "int", ("list", "int"), ("bytes", 32), "int", ("tuple", "int", "int"), "int",
         EPOCH, EPOCH, "bool", PUBKEY, PUBKEY, PUBKEY, "bool"),  # consensus state
        ("tuple", "int", "int", "int", "int", "int"))  # constants
STATE = ("version", 2, ("tuple", "field", BODY))


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.off = data, 0

    def take(self, n: int) -> bytes:
        if self.off + n > len(self.data):
            raise ValueError("truncated")
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def varint(self, signed: bool) -> int:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        width = {0xFF: 1, 0xFE: 2, 0xFD: 4, 0xFC: 8}.get(b)
        if width is None or (width == 1 and not signed):
            raise ValueError(f"bad integer code {b:#x}")
        return int.from_bytes(self.take(width), "little", signed=signed)

    def read(self, s):
        """The value of schema s: ints, bytes, or lists of values."""
        if s == "field":
            return int.from_bytes(self.take(32), "little")
        if s == "int":
            return self.varint(True)
        if s == "bool":
            return self.take(1)[0] != 0
        if s == "blob":
            return self.take(self.varint(False))
        kind = s[0]
        if kind == "bytes":
            return self.take(s[1])
        if kind == "list":
            return [self.read(s[1]) for _ in range(self.varint(False))]
        if kind == "tuple":
            return [self.read(x) for x in s[1:]]
        if kind == "option":
            return self.read(s[1]) if self.take(1)[0] else None
        if kind == "version":
            if self.varint(True) != s[1]:
                raise ValueError("unexpected version")
            return self.read(s[2])
        if kind == "variant":
            return [self.read(x) for x in s[1 + self.take(1)[0]]]
        raise ValueError(f"unknown schema {s!r}")


def decode(s, data: bytes):
    r = _Reader(data)
    v = r.read(s)
    if r.off != len(data):
        raise ValueError(f"{len(data) - r.off} trailing bytes")
    return v


def _flat(v) -> list[int]:
    if isinstance(v, bool):
        return [int(v)]
    if isinstance(v, int):
        return [v % pasta.P_PALLAS]
    if isinstance(v, bytes):
        halves = [int.from_bytes(v[:16], "little"), int.from_bytes(v[16:32], "little")]
        return halves + ([v[32]] if len(v) == 33 else [])
    return [x for item in v for x in _flat(item)]


def _prefix(name: str) -> int:
    return int.from_bytes(name.encode()[:20].ljust(20, b"\0"), "little")


def state_hash(blob: bytes) -> int:
    previous, body = decode(STATE, blob)
    body_hash = pasta.sponge_hash("fp", [_prefix(PREFIX_BODY)] + _flat(body))
    return pasta.sponge_hash("fp", [_prefix(PREFIX_STATE), previous, body_hash])


def submission_hashes(proof: bytes) -> list[int]:
    """The 16 candidate state hashes, then the bridge tip's: the order in
    which the service hashes a submission's states."""
    _tip, states, tip_state = decode(STATE_PROOF, proof)
    return [state_hash(s) for s in states] + [state_hash(tip_state)]
