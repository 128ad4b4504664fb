#!/usr/bin/env python3
"""Bank the port's fixtures with its prover, on the card by default.

    python3 scripts/torch_make_fixtures.py kimchi [--log-n 16] [--batch 2] [--out PATH]
    python3 scripts/torch_make_fixtures.py kimchi --more X0 COUNT --out PATH [--log-n 16]
    python3 scripts/torch_make_fixtures.py kimchi --merge BASE EXTRA --batch B --out PATH
    python3 scripts/torch_make_fixtures.py tips [--block-log-n 17] [--step-log-n 18] [--batch 8]
                                                [--start S --count C] [--out PATH]
    python3 scripts/torch_make_fixtures.py tips --merge PART... --out PATH
    python3 scripts/torch_make_fixtures.py pos [--block-log-n 10] [--step-log-n 4] [--batch 8] [--seed N]
                                               [--start S --count C] [--out PATH]
    python3 scripts/torch_make_fixtures.py pos --merge PART... --out PATH

Each takes `--device` (default: the card; `--device cpu` only on request).
- kimchi: `kimchi/bench_fixtures.make_fixture` (the squaring-chain
  circuit at 2^log_n, `batch` proofs) to fixtures/kimchi_2e<n>_b<B>.json.gz;
  `--more` proves COUNT more witnesses from x0 = X0 (`more_proofs`, as
  scripts/gen_more_proofs.py), `--merge` joins two files (`merge_fixture`,
  every proof verified first, as scripts/merge_fixture.py).
- tips: Pickles tips at wrap 2^b / step 2^s with the committed files'
  state hashes and seeds (`pickles/fixtures.make_tips_range`, as
  scripts/gen_pickles_fixture.py and gen_pickles_tips_range.py) to
  fixtures/pickles_2e<b>_s2e<s>_b<B>.json.gz, or a range of them to
  `--out`; `--merge` joins ranges (`merge_tips`, as
  scripts/merge_pickles_fixtures.py).
- pos: Proof-of-State proofs whose tips bind each chain's own tip hash
  (`bridge/fixtures.make_pos_fixture`, as scripts/make_pos_fixture.py,
  seed 0x5057) to fixtures/pos_2e<b>_s2e<s>_b<B>.json.gz, or a range of
  them; `--merge` joins ranges (`merge_pos_fixtures`).

Every writer checkpoints after each proof or tip. Prints one JSON line:
what was written, its size, the seconds in all and for each proof or tip,
and the device.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kind", choices=("kimchi", "tips", "pos"))
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' only on request")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--log-n", type=int, default=16, help="kimchi: log2 of the domain")
    ap.add_argument("--more", type=int, nargs=2, metavar=("X0", "COUNT"), help="kimchi: more proofs from x0")
    ap.add_argument("--block-log-n", type=int, default=None, help="tips, pos: log2 of the wrap domain")
    ap.add_argument("--step-log-n", type=int, default=None, help="tips, pos: log2 of the step domain")
    ap.add_argument("--seed", type=int, default=None, help="pos: the first chain's seed (default 0x5057)")
    ap.add_argument("--start", type=int, default=0, help="tips, pos: the first index proven")
    ap.add_argument("--count", type=int, default=None, help="tips, pos: how many (default: up to --batch)")
    ap.add_argument("--merge", type=pathlib.Path, nargs="+", default=None, help="files to join into --out")
    args = ap.parse_args()
    logging.basicConfig(level=logging.INFO, format="%(message)s")

    import torch

    from mina_bridge_tpu_torch import device as resolve_device
    from mina_bridge_tpu_torch.bridge import fixtures as bfx
    from mina_bridge_tpu_torch.kimchi import bench_fixtures as bf
    from mina_bridge_tpu_torch.pickles import fixtures as pfx
    from mina_bridge_tpu_torch.pickles import verifier as pv

    dev = resolve_device(args.device)
    device = str(dev)
    if args.merge and args.out is None:
        ap.error("--merge needs --out")
    t0 = time.time()
    per: list = []
    if args.kind == "kimchi":
        batch = args.batch or 2
        if args.merge:
            if len(args.merge) != 2:
                ap.error("kimchi --merge takes BASE EXTRA")
            bf.merge_fixture(*args.merge, args.out, batch, device)
        elif args.more:
            if args.out is None:
                ap.error("--more needs --out")
            bf.more_proofs(args.log_n, *args.more, args.out, device)
        else:
            args.out = args.out or bf.fixture_path(args.log_n, batch)
            timings: list = []
            index, proofs = bf.make_fixture(args.log_n, batch, device=device, timings=timings)
            bf.save_fixture(args.out, index, proofs)
            per = [sum(v for k, v in t.items() if isinstance(v, float)) for t in timings[1:]]
    else:
        wl = args.block_log_n or (pv.REAL_BLOCK_LOG_N if args.kind == "tips" else pv.BLOCK_LOG_N)
        sl = args.step_log_n or (pv.REAL_STEP_LOG_N if args.kind == "tips" else pv.STEP_LOG_N)
        batch = args.batch or (2 if args.kind == "tips" else 8)
        count = batch - args.start if args.count is None else args.count
        timings = []
        if args.kind == "tips":
            if args.merge:
                pfx.merge_tips(args.out, args.merge, device)
            else:
                args.out = args.out or pfx.fixture_path(wl, sl, batch)
                pfx.make_tips_range(wl, sl, args.start, count, args.out, device, timings)
        elif args.merge:
            bfx.merge_pos_fixtures(args.out, args.merge)
        else:
            args.out = args.out or bfx.pos_fixture_path(wl, sl, batch)
            seed = bfx.POS_SEED if args.seed is None else args.seed
            bfx.make_pos_fixture(seed, batch, wl, sl, device, start=args.start, count=count, out=args.out,
                                 timings=timings)
        per = [t["step_s"] + t["step_check_s"] + t["wrap_s"] for t in timings]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(json.dumps({"kind": args.kind, "out": str(args.out), "bytes": args.out.stat().st_size,
                      "seconds": time.time() - t0, "per_item_s": per, "device": device,
                      "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
