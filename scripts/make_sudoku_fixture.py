"""Write the Sudoku fixture: the zkApp circuit's verifier index and one
proof, made by the JAX package's host prover.

    JAX_PLATFORMS=cpu python scripts/make_sudoku_fixture.py [--seed N] [--holes H] [--out PATH]

As tests/test_example_sudoku.py does: random.Random(seed) generates the
puzzle and its solution (example/sudoku_lib.generate), then
example/sudoku_zkapp.SudokuCircuit(puzzle).prove(solution, g, h, rng)
sets up the 2^11-row circuit over the Pallas SRS and proves the solution
with the same rng. The document holds the seed, the holes, the puzzle,
the solution, the index (`kimchi/bench_fixtures._index_doc`) and the
proof (`_proof_doc`); the port's own Sudoku proof on the card is held
against it document for document.

This is a tool of the JAX package's: the port does not import it.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import pathlib
import random
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "example"))

import sudoku_lib  # noqa: E402
from sudoku_zkapp import LOG_N, SudokuCircuit  # noqa: E402

from mina_bridge_tpu.curves import host as jhc  # noqa: E402
from mina_bridge_tpu.curves import srs as jsrs  # noqa: E402
from mina_bridge_tpu.kimchi import bench_fixtures as bf  # noqa: E402


def srs_points_host(name: str, n: int):
    """The first n SRS points and h, decompressed from srs/<name>.srs,
    without the JAX package's on-disk cache of the whole table."""
    raw_g, raw_h = jsrs._parse_msgpack_srs((jsrs._SRS_DIR / f"{name}.srs").read_bytes())
    c = {"pallas": jhc.PALLAS, "vesta": jhc.VESTA}[name]
    return [jhc.decompress(c, b) for b in raw_g[:n]], jhc.decompress(c, raw_h)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0x5D0)
    ap.add_argument("--holes", type=int, default=30)
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "fixtures" / f"sudoku_2e{LOG_N}.json.gz")
    args = ap.parse_args()

    t0 = time.time()
    rng = random.Random(args.seed)
    puzzle, solution = sudoku_lib.generate(rng, holes=args.holes)
    circ = SudokuCircuit(puzzle)
    g, h = srs_points_host("pallas", circ.circuit.n)
    index, proof = circ.prove(solution, g, h, rng)
    doc = {"seed": args.seed, "holes": args.holes, "log_n": LOG_N, "puzzle": puzzle, "solution": solution,
           "index": bf._index_doc(index), "proof": bf._proof_doc(proof)}
    tmp = args.out.with_name(f".{args.out.name}.{os.getpid()}")
    with gzip.open(tmp, "wt") as f:
        json.dump(doc, f)
    os.replace(tmp, args.out)
    print(f"wrote {args.out.relative_to(ROOT)} ({args.out.stat().st_size} bytes) in {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
