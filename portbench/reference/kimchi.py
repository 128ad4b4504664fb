"""The Kimchi verifier's Fiat-Shamir challenges, replayed on Python ints.

`challenges(index_doc, proof_doc, curve, srs)` follows the verifier's
transcript from the committed fixture's own JSON (hex integers): the index
digest, the public commitment (from the SRS: with one public input its
Lagrange commitment is [1/n] times the sum of the SRS points of a chunk),
the commitments in the protocol's order, then the scalar-field sponge over
the public evaluations, ft(zeta w) and the opened evaluations. It returns
joint, beta, gamma, alpha, zeta, v, u and the base-field digest, as the
verifier derives them.

`SrsSums` decompresses the raw SRS file (srs/<curve>.srs) and keeps the
prefix sums it needs in the benchmark's cache, so only the first run in a
checkout pays for the square roots.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pathlib

from . import pasta

GATE_ORDER = ("generic", "poseidon", "complete_add", "varbasemul", "endomul", "endomulscalar", "xor",
              "rangecheck", "lookup_rt")
NAMES = ("joint", "beta", "gamma", "alpha", "zeta", "v", "u", "fq_digest")


def _pt(v):
    """A fixture point [hex x, hex y] (None the identity) or a chunk list."""
    if v is None:
        return None
    if isinstance(v[0], str):
        return (int(v[0], 16), int(v[1], 16))
    return [_pt(q) for q in v]


def _chunks(v) -> list:
    p = _pt(v)
    return p if isinstance(p, list) else [p]


def _absorb_pt(s: pasta.Sponge, pt) -> None:
    s.absorb(0 if pt is None else pt[0])
    s.absorb(0 if pt is None else pt[1])


def index_digest(index_doc: dict, curve: pasta.Curve) -> int:
    s = pasta.Sponge("fp" if curve is pasta.PALLAS else "fq")
    groups = (list(index_doc["sigma_comm"]) + list(index_doc["coeff_comm"])
              + [index_doc["sel_comm"][g] for g in GATE_ORDER] + list(index_doc["table_comm"])
              + [index_doc["qlk_comm"]])
    for pc in groups:
        for pt in _chunks(pc):
            _absorb_pt(s, pt)
    s.absorb(1 << index_doc["log_n"])
    s.absorb(index_doc["npub"])
    return s.squeeze()


def _parse_srs(data: bytes) -> tuple[list[bytes], bytes]:
    """The msgpack file: fixarray(2) of (array32 of bin8(33) g, bin8(33) h)."""
    if data[0] != 0x92 or data[1] != 0xDD:
        raise ValueError("not an SRS file")
    n = int.from_bytes(data[2:6], "big")
    off, g = 6, []
    for _ in range(n):
        if data[off] != 0xC4 or data[off + 1] != 33:
            raise ValueError("bad SRS point")
        g.append(data[off + 2:off + 35])
        off += 35
    return g, data[off + 2:off + 35]


def _sum_part(args) -> tuple[int, int] | None:
    name, raw = args
    c = pasta.CURVES[name]
    return pasta.point_sum(c, (pasta.decompress(c, b) for b in raw))


class SrsSums:
    """The sum of the first N points of a curve's SRS, and its h, cached
    as JSON under `cache_dir` (keyed by curve and N)."""

    def __init__(self, cache_dir: pathlib.Path, srs_dir: pathlib.Path = pasta.ROOT / "srs", workers: int = 8):
        self.cache_dir, self.srs_dir, self.workers = pathlib.Path(cache_dir), pathlib.Path(srs_dir), workers

    def get(self, curve: pasta.Curve, N: int) -> tuple[tuple[int, int], tuple[int, int]]:
        path = self.cache_dir / f"ref_srs_{curve.name}_{N}.json"
        if path.exists():
            d = json.loads(path.read_text())
            return tuple(int(v, 16) for v in d["sum"]), tuple(int(v, 16) for v in d["h"])
        g, h = _parse_srs((self.srs_dir / f"{curve.name}.srs").read_bytes())
        raw = g[:N]
        if len(raw) < N:
            raise ValueError(f"{curve.name}.srs has {len(g)} points, fewer than {N}")
        step = -(-len(raw) // (4 * self.workers))
        parts = [(curve.name, raw[i:i + step]) for i in range(0, len(raw), step)]
        if self.workers > 1 and len(raw) >= 4096:
            with multiprocessing.get_context("spawn").Pool(self.workers) as pool:
                sums = pool.map(_sum_part, parts)
        else:
            sums = [_sum_part(p) for p in parts]
        total = pasta.point_sum(curve, sums)
        hp = pasta.decompress(curve, h)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}")
        tmp.write_text(json.dumps({"sum": [hex(v) for v in total], "h": [hex(v) for v in hp]}))
        os.replace(tmp, path)
        return total, hp


def challenges(index_doc: dict, proof_doc: dict, curve: pasta.Curve, srs: SrsSums) -> dict[str, int]:
    """{name: value} of the verifier's challenges for one proof."""
    p, r = curve.p, curve.r
    log_n, npub = index_doc["log_n"], index_doc["npub"]
    n = 1 << log_n
    N = min(n, index_doc.get("srs_len") or n)
    nc = n // N
    public = [int(x, 16) for x in proof_doc["public"]]
    if len(public) != npub or npub > 1:
        raise NotImplementedError("the reference's public commitment covers one public input")
    total, h = srs.get(curve, N)
    lag0 = pasta.mul(curve, pasta.inv(n, r), total)  # every chunk of L_0: [1/n] sum of the chunk's SRS points
    pub_chunks = [pasta.mul(curve, public[0], lag0) if npub else None for _ in range(nc)]
    pub_chunks[0] = pasta.add(curve, pub_chunks[0], h)

    fq = pasta.Sponge("fp" if curve is pasta.PALLAS else "fq")
    fq.absorb(index_digest(index_doc, curve))
    prev = proof_doc.get("prev", [])
    for _chals, sg in prev:
        _absorb_pt(fq, _pt(sg))
    for pt in pub_chunks:
        _absorb_pt(fq, pt)
    for pc in proof_doc["w_comm"]:
        for pt in _chunks(pc):
            _absorb_pt(fq, pt)
    for pt in _chunks(proof_doc["rt_comm"]):
        _absorb_pt(fq, pt)
    out = {"joint": pasta.endo_chal(curve, fq)}
    for pc in proof_doc["s_comm"]:
        for pt in _chunks(pc):
            _absorb_pt(fq, pt)
    out["beta"] = pasta.low128(fq.squeeze())
    out["gamma"] = pasta.low128(fq.squeeze())
    for pt in _chunks(proof_doc["z_comm"]) + _chunks(proof_doc["zl_comm"]):
        _absorb_pt(fq, pt)
    out["alpha"] = pasta.endo_chal(curve, fq)
    for pc in proof_doc["t_comm"]:
        _absorb_pt(fq, _pt(pc))
    zeta = out["zeta"] = pasta.endo_chal(curve, fq)
    out["fq_digest"] = fq.squeeze()

    fr = pasta.Sponge("fq" if curve is pasta.PALLAS else "fp")
    fr.absorb(out["fq_digest"] % r)
    for chals, _sg in prev:
        for ch in chals:
            fr.absorb(int(ch, 16))
    zeta_w = zeta * pasta.omega(r, log_n) % r
    for j in range(nc):
        for y in (zeta, zeta_w):
            fr.absorb(sum(x * pasta.lagrange_chunk_eval(r, log_n, i, j, N, y) for i, x in enumerate(public)) % r)
    fr.absorb(int(proof_doc["ft_eval1"], 16))
    for e0, e1 in proof_doc["evals"]:
        fr.absorb(int(e0, 16))
        fr.absorb(int(e1, 16))
    out["v"] = pasta.endo_chal(curve, fr)
    out["u"] = pasta.endo_chal(curve, fr)
    return out
