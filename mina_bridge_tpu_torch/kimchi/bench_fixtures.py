"""The real-scale Kimchi proof fixtures: proving, writing and loading them.

Counterpart of mina_bridge_tpu/kimchi/bench_fixtures.py: the chain
circuit (`build_chain_circuit`, a 2^log_n-row squaring chain whose result
is the public input) and its witness, `make_fixture` (setup and `batch`
proofs with `random.Random(20260820)`, on the card unless "cpu"), the
hex-int JSON documents (`_index_doc`, `_proof_doc`, `save_fixture`) and
the loader (`_index_from_doc`, `_proof_from_doc`, `load_fixture`,
`fixture_path`, `get_fixture`). fixtures/kimchi_2e<log_n>_b<B>.json.gz
hold an index's commitments and B proofs; the port's proofs equal them
document for document. `more_proofs` and `merge_fixture` are the
counterparts of scripts/gen_more_proofs.py and scripts/merge_fixture.py:
more proofs of the same circuit, and a larger fixture from two files
(scripts/torch_make_fixtures.py runs them).
"""

from __future__ import annotations

import gzip
import json
import os
import pathlib
import random

from ..commitment import ipa
from ..curves import groupmap as gm
from ..curves.host import PALLAS, CurveSpec
from ..curves.srs import load_srs
from . import prover_host
from .circuit import COLUMNS, CircuitBuilder
from .domain import Domain
from .prover_host import HostProof, VerifierIndexHost

FIXTURES = pathlib.Path(__file__).resolve().parents[2] / "fixtures"
CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "fixtures"  # get_fixture's own fixtures


def fixture_path(log_n: int, batch: int) -> pathlib.Path:
    return FIXTURES / f"kimchi_2e{log_n}_b{batch}.json.gz"


def build_chain_circuit(field, log_n: int, n_gates: int):
    """x_(i+1) = x_i^2 chain with the final value as the public input."""
    b = CircuitBuilder(field, log_n)
    pub = b.public_input()
    cells = [b.mul_gate() for _ in range(n_gates)]
    for i in range(n_gates):
        a_c, b_c, c_c = cells[i]
        b.connect([a_c, b_c])  # square: both inputs are the same wire
        if i + 1 < n_gates:
            b.connect([c_c, cells[i + 1][0]])
    b.connect([cells[-1][2], pub])
    return b.build()


def chain_witness(field, circuit, n_gates: int, x0: int):
    """Witness for build_chain_circuit: the squaring chain from x0."""
    p = field.p
    w = [[0] * circuit.n for _ in range(COLUMNS)]
    vals = [x0 % p]
    for _ in range(n_gates):
        vals.append(vals[-1] * vals[-1] % p)
    out = vals[-1]
    w[0][0] = out  # public row
    for i in range(n_gates):
        row = 1 + i
        w[0][row] = vals[i]
        w[1][row] = vals[i]
        w[2][row] = vals[i + 1]
    return w, [out]


def make_fixture(log_n: int, batch: int, n_gates: int | None = None, device=None, timings: list | None = None):
    """Set up the chain circuit at 2^log_n and prove `batch` witnesses
    (x0 = 3 + i) with random.Random(20260820), on `device` (the card
    unless "cpu"). timings, when given, receives {"setup": s} and one
    dict of stage seconds a proof."""
    import time

    curve = PALLAS
    fs = curve.scalar
    n = 1 << log_n
    if n_gates is None:
        n_gates = max(1, min(n - 16, n // 2))
    circuit = build_chain_circuit(fs, log_n, n_gates)
    srs = load_srs("pallas", circuit.n)
    t0 = time.perf_counter()
    index = prover_host.setup(circuit, curve, srs["g"], _srs_h(srs), device=device)
    if timings is not None:
        timings.append({"setup": time.perf_counter() - t0})
    rng = random.Random(20260820)
    proofs = []
    for i in range(batch):
        w, pub = chain_witness(fs, circuit, n_gates, 3 + i)
        st = {} if timings is not None else None
        proofs.append(prover_host.prove(index, circuit, w, pub, srs["g"], _srs_h(srs), rng, device=device, timings=st))
        if timings is not None:
            timings.append(st)
    return index, proofs


def _srs_h(srs: dict) -> tuple[int, int]:
    from ..fields.params import limbs_to_int

    return (limbs_to_int(srs["h"][0]), limbs_to_int(srs["h"][1]))


def _pt(p):
    # a chunked commitment nests: [[hex, hex], ...]
    if isinstance(p, list):
        return [_pt(q) for q in p]
    return None if p is None else [hex(p[0]), hex(p[1])]


def _index_doc(index: VerifierIndexHost) -> dict:
    doc = {
        "log_n": index.domain.log_size,
        "npub": index.npub,
        "shifts": [hex(s) for s in index.shifts],
        "sigma_comm": [_pt(p) for p in index.sigma_comm],
        "coeff_comm": [_pt(p) for p in index.coeff_comm],
        "sel_comm": {k: _pt(p) for k, p in index.sel_comm.items()},
        "table_comm": [_pt(p) for p in index.table_comm],
        "qlk_comm": _pt(index.qlk_comm),
    }
    if index.srs_len:  # chunked index
        doc["srs_len"] = index.srs_len
    return doc


def _proof_doc(pr: HostProof) -> dict:
    op = pr.opening
    doc = {}
    if pr.prev_challenges:  # carried accumulators (wrap proofs)
        doc["prev"] = [[[hex(c) for c in chals], _pt(sg)] for chals, sg in pr.prev_challenges]
    return doc | {
        "w_comm": [_pt(p) for p in pr.w_comm],
        "z_comm": _pt(pr.z_comm),
        "s_comm": [_pt(p) for p in pr.s_comm],
        "rt_comm": _pt(pr.rt_comm),
        "zl_comm": _pt(pr.zl_comm),
        "t_comm": [_pt(p) for p in pr.t_comm],
        "evals": [[hex(e0), hex(e1)] for e0, e1 in pr.evals],
        "ft_eval1": hex(pr.ft_eval1),
        "public": [hex(x) for x in pr.public],
        "lr": [[_pt(L), _pt(R)] for L, R in op.lr],
        "delta": _pt(op.delta),
        "z1": hex(op.z1),
        "z2": hex(op.z2),
        "sg": _pt(op.sg),
        "chals": [hex(x) for x in op.chals],
        "u_hints": {
            "sel": op.u_hints.sel,
            "y": hex(op.u_hints.y),
            "wits": [hex(w) for w in op.u_hints.wits],
            "alpha": hex(op.u_hints.alpha),
        },
    }


def write_doc(path: pathlib.Path, doc: dict) -> None:
    """A gzipped JSON document written under a temporary name, then
    renamed, so a reader never sees half a file."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    with gzip.open(tmp, "wt") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


def read_doc(path: pathlib.Path) -> dict:
    with gzip.open(path, "rt") as f:
        return json.load(f)


def save_fixture(path: pathlib.Path, index, proofs) -> None:
    write_doc(path, {"index": _index_doc(index), "proofs": [_proof_doc(p) for p in proofs]})


def _unpt(v):
    if v is None:
        return None
    if isinstance(v[0], str):  # a bare point [hex_x, hex_y]
        return (int(v[0], 16), int(v[1], 16))
    return [_unpt(q) for q in v]  # a chunk list


def _index_from_doc(d: dict, curve: CurveSpec) -> VerifierIndexHost:
    return VerifierIndexHost(
        curve=curve,
        domain=Domain(curve.scalar, d["log_n"]),
        npub=d["npub"],
        sigma_comm=[_unpt(p) for p in d["sigma_comm"]],
        coeff_comm=[_unpt(p) for p in d["coeff_comm"]],
        sel_comm={k: _unpt(p) for k, p in d["sel_comm"].items()},
        table_comm=[_unpt(p) for p in d["table_comm"]],
        qlk_comm=_unpt(d["qlk_comm"]),
        shifts=tuple(int(s, 16) for s in d["shifts"]),
        srs_len=d.get("srs_len"),
    )


def _proof_from_doc(pd: dict) -> HostProof:
    uh = pd["u_hints"]
    opening = ipa.HostOpeningProof(
        lr=[(_unpt(L), _unpt(R)) for L, R in pd["lr"]],
        delta=_unpt(pd["delta"]),
        z1=int(pd["z1"], 16),
        z2=int(pd["z2"], 16),
        sg=_unpt(pd["sg"]),
        chals=[int(x, 16) for x in pd["chals"]],
        u_hints=gm.UHints(
            sel=uh["sel"],
            y=int(uh["y"], 16),
            wits=tuple(int(w, 16) for w in uh["wits"]),
            alpha=int(uh["alpha"], 16),
        ),
    )
    return HostProof(
        w_comm=[_unpt(p) for p in pd["w_comm"]],
        z_comm=_unpt(pd["z_comm"]),
        s_comm=[_unpt(p) for p in pd["s_comm"]],
        rt_comm=_unpt(pd["rt_comm"]),
        zl_comm=_unpt(pd["zl_comm"]),
        t_comm=[_unpt(p) for p in pd["t_comm"]],
        evals=[(int(e0, 16), int(e1, 16)) for e0, e1 in pd["evals"]],
        ft_eval1=int(pd["ft_eval1"], 16),
        opening=opening,
        public=[int(x, 16) for x in pd["public"]],
        prev_challenges=[([int(c, 16) for c in chals], _unpt(sg)) for chals, sg in pd.get("prev", [])],
    )


def load_fixture(path: pathlib.Path, curve: CurveSpec = PALLAS):
    """-> (VerifierIndexHost, [HostProof])."""
    doc = read_doc(path)
    return _index_from_doc(doc["index"], curve), [_proof_from_doc(pd) for pd in doc["proofs"]]


def get_fixture(log_n: int = 16, batch: int = 2, device=None):
    """The committed fixture, else the one in CACHE_DIR, else one made by
    make_fixture on `device` (the card unless "cpu") and kept in CACHE_DIR.
    -> (VerifierIndexHost, [HostProof])."""
    cached = CACHE_DIR / fixture_path(log_n, batch).name
    for path in (fixture_path(log_n, batch), cached):
        if path.exists():
            return load_fixture(path)
    index, proofs = make_fixture(log_n, batch, device=device)
    save_fixture(cached, index, proofs)
    return index, proofs


def more_proofs(log_n: int, x0_start: int, count: int, out: pathlib.Path, device=None) -> list[dict]:
    """`count` more proofs of the chain circuit at 2^log_n, witnesses x0 =
    x0_start .. x0_start + count - 1, proof x0 with its own
    random.Random(20260820 * 1000 + x0), as scripts/gen_more_proofs.py
    makes them. The index must equal the committed 8-proof fixture's where
    there is one. Writes {"index", "proofs"} (the new proofs only) to
    `out` after every proof; returns the proof documents."""
    import logging
    import time

    fs = PALLAS.scalar
    n_gates = max(1, min((1 << log_n) - 16, (1 << log_n) // 2))
    circuit = build_chain_circuit(fs, log_n, n_gates)
    srs = load_srs("pallas", circuit.n)
    g, h = srs["g"], _srs_h(srs)
    index = prover_host.setup(circuit, PALLAS, g, h, device=device)
    index_doc = _index_doc(index)
    ref = fixture_path(log_n, 8)
    if ref.exists() and read_doc(ref)["index"] != index_doc:
        raise RuntimeError(f"the 2^{log_n} index differs from {ref.name}'s")
    docs = []
    for x0 in range(x0_start, x0_start + count):
        t0 = time.perf_counter()
        w, pub = chain_witness(fs, circuit, n_gates, x0)
        docs.append(_proof_doc(prover_host.prove(index, circuit, w, pub, g, h, random.Random(20260820 * 1000 + x0),
                                                 device=device)))
        write_doc(out, {"index": index_doc, "proofs": docs})
        logging.getLogger(__name__).info("proof x0=%d in %.1f s", x0, time.perf_counter() - t0)
    return docs


def merge_fixture(base: pathlib.Path, extra: pathlib.Path, out: pathlib.Path, batch: int, device=None) -> None:
    """The first `batch` proofs of `base` then `extra` (same index, distinct
    public inputs), each checked by the port's batched verify on `device`
    (the card unless "cpu") before `out` is written, as
    scripts/merge_fixture.py checks each with its host verify."""
    import numpy as np
    import torch

    from .. import device as _device
    from ..fields.params import NLIMBS, int_to_limbs
    from . import verifier as kv

    bdoc, edoc = read_doc(base), read_doc(extra)
    if bdoc["index"] != edoc["index"]:
        raise ValueError("the two files hold different indexes")
    docs = (bdoc["proofs"] + edoc["proofs"])[:batch]
    if len(docs) < batch or len({tuple(d["public"]) for d in docs}) != batch:
        raise ValueError(f"need {batch} distinct proofs, have {len({tuple(d['public']) for d in docs})}")
    index, proofs = _index_from_doc(bdoc["index"], PALLAS), [_proof_from_doc(d) for d in docs]
    dev = _device(device)
    dindex = kv.DeviceVerifierIndex.from_host(index, load_srs("pallas", index.chunk_size), dev)
    weights = torch.as_tensor(np.array([[int_to_limbs(int.from_bytes(os.urandom(16), "little"), NLIMBS)
                                         for _ in range(2)] for _ in proofs]), device=dev)
    hint = kv.host_public_commitments(dindex, [p.public for p in proofs])
    if kv.verify(dindex, kv.DeviceProofs.from_host(proofs, dev), weights, pub_comm_hint=hint) is not True:
        raise ValueError("the merged proofs do not verify")
    write_doc(out, {"index": bdoc["index"], "proofs": docs})
