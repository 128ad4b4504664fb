"""Write the toy Proof-of-State fixture: B state proofs whose candidate
tips are Pickles tips at the verifier service's default toy domains (wrap
2^10 on Pallas, step 2^4 on Vesta), proven for each chain's own tip hash.

    JAX_PLATFORMS=cpu python scripts/make_pos_fixture.py [--seed N] [--batch B] [--out PATH]

For i in 0..B-1 it builds a 16-state candidate chain and a bridge tip with
the JAX package's `bridge/fixtures.make_state_proof(random.Random(seed +
i))`, proves a tip binding the chain's last state hash with its host
prover (`pickles.prove_tip`, same rng), and puts the tip on the wire as
the proof's `candidate_tip_proof` (`pickles_wire.tip_doc`). The document
holds each proof's seed and its pub inputs and proof as binprot hex, and
both verifier indexes in the layout of the Pickles fixtures
(`kimchi/bench_fixtures._index_doc`). The port reads it with
`mina_bridge_tpu_torch/bridge/fixtures.load_pos_fixture`.

This is a tool of the JAX package's: the port does not import it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import pathlib
import random
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mina_bridge_tpu.bridge import fixtures, pickles_wire  # noqa: E402
from mina_bridge_tpu.curves import host as jhc  # noqa: E402
from mina_bridge_tpu.curves import srs as jsrs  # noqa: E402
from mina_bridge_tpu.kimchi import bench_fixtures as bf  # noqa: E402
from mina_bridge_tpu.pickles import verifier as pv  # noqa: E402


def srs_points_host(name: str, n: int):
    """The first n SRS points and h, decompressed from srs/<name>.srs,
    without the JAX package's on-disk cache of the whole table (which
    `curves.srs.srs_points_host` writes in place)."""
    raw_g, raw_h = jsrs._parse_msgpack_srs((jsrs._SRS_DIR / f"{name}.srs").read_bytes())
    c = {"pallas": jhc.PALLAS, "vesta": jhc.VESTA}[name]
    return [jhc.decompress(c, b) for b in raw_g[:n]], jhc.decompress(c, raw_h)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0x5057)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    out = args.out or ROOT / "fixtures" / f"pos_2e{pv.BLOCK_LOG_N}_s2e{pv.STEP_LOG_N}_b{args.batch}.json.gz"
    pv.srs_points_host = srs_points_host

    t0 = time.time()
    entries = []
    for i in range(args.batch):
        t1 = time.time()
        rng = random.Random(args.seed + i)
        pub, proof, _, _ = fixtures.make_state_proof(rng)
        tip = pv.prove_tip(pub.candidate_chain_state_hashes[-1], rng)
        proof = dataclasses.replace(proof, candidate_tip_proof=pickles_wire.tip_doc(tip))
        entries.append({"seed": args.seed + i, "pub": pub.encode().hex(), "proof": proof.encode().hex()})
        print(f"state proof {i}: tip proven in {time.time() - t1:.1f} s", flush=True)
    _, wrap_index, _, _, _ = pv.block_setup()
    _, step_index, _, _, _ = pv.step_setup()
    doc = {
        "block_log_n": pv.BLOCK_LOG_N,
        "step_log_n": pv.STEP_LOG_N,
        "seed": args.seed,
        "proofs": entries,
        "wrap_index": bf._index_doc(wrap_index),
        "step_index": bf._index_doc(step_index),
    }
    tmp = out.with_name(f".{out.name}.{os.getpid()}")
    with gzip.open(tmp, "wt") as f:
        json.dump(doc, f)
    os.replace(tmp, out)
    print(f"wrote {out.relative_to(ROOT)} ({out.stat().st_size} bytes) in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
