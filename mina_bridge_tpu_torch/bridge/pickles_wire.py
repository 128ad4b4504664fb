"""Wire codec for the candidate tip's Pickles proof.

The reference binprot-decodes the tip proof fetched from a Mina node as
`MinaBaseProofStableV2` (reference core/src/mina.rs:235-248) — a
statement (the step verifier's deferred values / accumulator), the wrap
proof's commitments (kimchi PolyComm chunk vectors), the evaluations,
and the bulletproof opening (lr rounds, delta, z1, z2, sg, carried
`prev_challenges`). This module is the framework's counterpart
(PARITY D12): the same component inventory over OUR pickles proof model
(pickles/verifier.py TipProof — wrap HostProof + step accumulator),
expressed in the bin_prot descriptor DSL (bridge/binprot.py) so a proof
envelope fetched from a node round-trips byte-identically and lands
directly on device (`device_tips`).

Layout notes mirroring the reference types:
  * points are `Or_infinity`-style variants (Infinity | Finite (x, y));
  * a commitment is a chunk VECTOR (kimchi `PolyComm.elems`) — length 1
    below the SRS bound, nc chunks at the real Wrap 2^17 domain;
  * the statement carries the step accumulator (folding challenges +
    sg), i.e. the deferred-values payload the wrap circuit binds
    (reference README.md:534-604).

The port's own copy of mina_bridge_tpu/bridge/pickles_wire.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

from ..kimchi.prover_host import HostProof, as_chunks
from . import binprot as bp

# --- descriptors ----------------------------------------------------------

POINT = bp.Variant(
    ("Infinity", []),
    ("Finite", [bp.Tuple(bp.Field(), bp.Field())]),
)

COMM = bp.List(POINT)  # kimchi PolyComm: one point per SRS-sized chunk

ACCUMULATOR = bp.Record(  # a RecursionChallenge: (chals, comm)
    ("chals", bp.List(bp.Field())),
    ("sg", POINT),
)

OPENING = bp.Record(
    ("lr", bp.List(bp.Tuple(POINT, POINT))),
    ("delta", POINT),
    ("z1", bp.Field()),
    ("z2", bp.Field()),
    ("sg", POINT),
    ("chals", bp.List(bp.Field())),
    (
        "u_hints",
        bp.Record(
            ("sel", bp.Int()),
            ("y", bp.Field()),
            ("w0", bp.Field()),
            ("w1", bp.Field()),
            ("alpha", bp.Field()),
        ),
    ),
)

# A kimchi proof (wrap OR step side: both are HostProof instances; the
# reference's MinaBaseProofStableV2 nests the same PicklesProofProofsVerified2
# proof record)
KIMCHI_PROOF = bp.Record(
    ("public", bp.List(bp.Field())),
    ("prev_challenges", bp.List(ACCUMULATOR)),
    (
        "commitments",
        bp.Record(
            ("w_comm", bp.List(COMM)),
            ("z_comm", COMM),
            ("s_comm", bp.List(COMM)),
            ("rt_comm", COMM),
            ("zl_comm", COMM),
            ("t_comm", bp.List(POINT)),
        ),
    ),
    ("evals", bp.List(bp.Tuple(bp.Field(), bp.Field()))),
    ("ft_eval1", bp.Field()),
    ("opening", OPENING),
)

# MinaBaseProofStableV2 counterpart: versioned {statement, wrap proof,
# wrapped step proof}. Version 3 adds the step proof so the verifier
# service can run the on-device step verification (PARITY D7) on
# adversarial submissions; Option keeps legacy v2-shaped envelopes
# (step_proof=None) decodable under the same descriptor.
TIP_PROOF = bp.Versioned(
    bp.Record(
        (
            "statement",
            bp.Record(
                ("step_acc_prechals", bp.List(bp.Field())),
                ("step_acc_sg", POINT),
            ),
        ),
        ("proof", KIMCHI_PROOF),
        ("step_proof", bp.Option(KIMCHI_PROOF)),
    ),
    version=3,
)


# --- TipProof <-> wire value ---------------------------------------------

def _pt_wire(p):
    return ("Infinity", []) if p is None else ("Finite", [(p[0], p[1])])


def _pt_unwire(v):
    name, vals = v
    return None if name == "Infinity" else tuple(vals[0])


def _comm_wire(pc):
    return [_pt_wire(p) for p in as_chunks(pc)]


def _comm_unwire(v):
    pts = [_pt_unwire(p) for p in v]
    return pts[0] if len(pts) == 1 else pts


def _proof_wire(pr: HostProof) -> dict:
    op = pr.opening
    return {
        "public": list(pr.public),
        "prev_challenges": [
            {"chals": list(ch), "sg": _pt_wire(sg)}
            for ch, sg in pr.prev_challenges
        ],
        "commitments": {
            "w_comm": [_comm_wire(c) for c in pr.w_comm],
            "z_comm": _comm_wire(pr.z_comm),
            "s_comm": [_comm_wire(c) for c in pr.s_comm],
            "rt_comm": _comm_wire(pr.rt_comm),
            "zl_comm": _comm_wire(pr.zl_comm),
            "t_comm": [_pt_wire(p) for p in pr.t_comm],
        },
        "evals": [(e0, e1) for e0, e1 in pr.evals],
        "ft_eval1": pr.ft_eval1,
        "opening": {
            "lr": [(_pt_wire(L), _pt_wire(R)) for L, R in op.lr],
            "delta": _pt_wire(op.delta),
            "z1": op.z1,
            "z2": op.z2,
            "sg": _pt_wire(op.sg),
            "chals": list(op.chals),
            "u_hints": {
                "sel": op.u_hints.sel,
                "y": op.u_hints.y,
                "w0": op.u_hints.wits[0],
                "w1": op.u_hints.wits[1],
                "alpha": op.u_hints.alpha,
            },
        },
    }


def _proof_unwire(p: dict) -> HostProof:
    from ..commitment import ipa
    from ..curves import groupmap as gm

    op = p["opening"]
    uh = op["u_hints"]
    opening = ipa.HostOpeningProof(
        lr=[(_pt_unwire(L), _pt_unwire(R)) for L, R in op["lr"]],
        delta=_pt_unwire(op["delta"]),
        z1=op["z1"],
        z2=op["z2"],
        sg=_pt_unwire(op["sg"]),
        chals=list(op["chals"]),
        u_hints=gm.UHints(
            sel=uh["sel"],
            y=uh["y"],
            wits=(uh["w0"], uh["w1"]),
            alpha=uh["alpha"],
        ),
    )
    c = p["commitments"]
    return HostProof(
        w_comm=[_comm_unwire(v) for v in c["w_comm"]],
        z_comm=_comm_unwire(c["z_comm"]),
        s_comm=[_comm_unwire(v) for v in c["s_comm"]],
        rt_comm=_comm_unwire(c["rt_comm"]),
        zl_comm=_comm_unwire(c["zl_comm"]),
        t_comm=[_pt_unwire(v) for v in c["t_comm"]],
        evals=[[e0, e1] for e0, e1 in p["evals"]],
        ft_eval1=p["ft_eval1"],
        opening=opening,
        public=list(p["public"]),
        prev_challenges=[
            (list(a["chals"]), _pt_unwire(a["sg"]))
            for a in p["prev_challenges"]
        ],
    )


def tip_doc(tip) -> dict:
    """pickles.TipProof -> wire value (plain dict for TIP_PROOF)."""
    return {
        "statement": {
            "step_acc_prechals": list(tip.step_acc_prechals),
            "step_acc_sg": _pt_wire(tip.step_acc_sg),
        },
        "proof": _proof_wire(tip.wrap),
        "step_proof": None if tip.step is None else _proof_wire(tip.step),
    }


def tip_from_doc(doc: dict):
    """Wire value -> pickles.TipProof."""
    from ..pickles.verifier import TipProof

    st = doc["statement"]
    step = doc.get("step_proof")
    return TipProof(
        wrap=_proof_unwire(doc["proof"]),
        step_acc_prechals=list(st["step_acc_prechals"]),
        step_acc_sg=_pt_unwire(st["step_acc_sg"]),
        step=None if step is None else _proof_unwire(step),
    )


def encode_tip_proof(tip) -> bytes:
    return TIP_PROOF.encode(tip_doc(tip))


def decode_tip_proof(data: bytes):
    return tip_from_doc(TIP_PROOF.decode(data))


def device_tips(docs: list[dict], device: str | None = None):
    """Wire values -> stacked DeviceTips on `device` (the card unless
    "cpu"): the from_wire device path."""
    from .. import device as _device
    from ..pickles.verifier import DeviceTips

    return DeviceTips.from_host([tip_from_doc(d) for d in docs], _device(device))
