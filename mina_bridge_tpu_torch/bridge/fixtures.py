"""Synthetic Mina chains, accounts and ledgers, and the toy
Proof-of-State fixture's loader.

The port's own copy of mina_bridge_tpu/bridge/fixtures.py (`make_state`,
`make_chain`, `dummy_tip_doc`, `make_state_proof`, `make_account`,
`SparseLedger`): the same seeded rng calls give the same chains and
accounts, hashed on the host. `make_account_batch` makes a
Proof-of-Account batch's accounts and paths.

The Proof-of-State fixtures, fixtures/pos_2e<wrap>_s2e<step>_b<B>.json.gz,
hold B state proofs whose candidate tips are Pickles tips proven for each
chain's own tip hash, and both verifier indexes. `make_pos_fixture` writes
one as scripts/make_pos_fixture.py wrote the toy file (wrap 2^10, step
2^4), at any domains and in ranges that `merge_pos_fixtures` joins;
`load_pos_fixture` reads one.
"""

from __future__ import annotations

import dataclasses
import logging
import pathlib
import random
import time

from ..fields.params import FP
from ..kimchi import bench_fixtures as bf
from . import mina_types as mt
from . import proof_model as pm
from .consensus import SUB_WINDOWS_PER_WINDOW
from .merkle import LEDGER_DEPTH
from .state_hash import host_hash_with_prefix


def _pk(rng) -> bytes:
    return rng.randbytes(32) + bytes([rng.randrange(2)])


def make_state(
    rng,
    previous_state_hash: int,
    blockchain_length: int,
    global_slot: int,
    epoch_count: int = 1,
    snarked_ledger_hash: int | None = None,
    lock_checkpoint: int = 777,
    min_window_density: int = 77,
) -> dict:
    f = lambda: rng.randrange(FP.p)
    epoch = lambda lock: {
        "ledger": {"hash": f(), "total_currency": 10**9},
        "seed": f(),
        "start_checkpoint": f() if lock != 777 else 1234,
        "lock_checkpoint": lock,
        "epoch_length": 100,
    }
    return {
        "previous_state_hash": previous_state_hash,
        "body": {
            "genesis_state_hash": 42,
            "blockchain_state": {
                "staged_ledger_hash": {
                    "non_snark_ledger_hash": f(),
                    "non_snark_aux_hash": rng.randbytes(32),
                    "non_snark_pending_coinbase_aux": rng.randbytes(32),
                    "pending_coinbase_hash": f(),
                },
                "genesis_ledger_hash": 43,
                "snarked_ledger_hash": snarked_ledger_hash
                if snarked_ledger_hash is not None
                else f(),
                "timestamp": 1700000000 + global_slot * 180,
                "body_reference": rng.randbytes(32),
            },
            "consensus_state": {
                "blockchain_length": blockchain_length,
                "epoch_count": epoch_count,
                "min_window_density": min_window_density,
                "sub_window_densities": [7] * SUB_WINDOWS_PER_WINDOW,
                "last_vrf_output": rng.randbytes(32),
                "total_currency": 10**12,
                "curr_global_slot_since_hard_fork": {
                    "slot_number": global_slot,
                    "slots_per_epoch": 7140,
                },
                "global_slot_since_genesis": global_slot,
                "staking_epoch_data": epoch(lock_checkpoint),
                "next_epoch_data": epoch(lock_checkpoint + 1),
                "has_ancestor_in_same_checkpoint_window": True,
                "block_stake_winner": _pk(rng),
                "block_creator": _pk(rng),
                "coinbase_receiver": _pk(rng),
                "supercharge_coinbase": False,
            },
            "constants": {
                "k": 290,
                "slots_per_epoch": 7140,
                "slots_per_sub_window": 7,
                "delta": 0,
                "genesis_state_timestamp": 1600000000,
            },
        },
    }


def make_chain(
    rng, n: int = pm.BRIDGE_TRANSITION_FRONTIER_LEN, start_length: int = 100
):
    """A hash-linked candidate chain plus an older bridge-tip state.

    The bridge tip shares the candidate's epoch/lock checkpoint (so the
    fork is short-range) and is shorter, so the candidate wins chain
    selection.
    """
    tip_state = make_state(rng, 555, start_length - 2, 900)
    states = []
    prev_hash = 999  # root's parent (outside the bridged window)
    for i in range(n):
        st = make_state(rng, prev_hash, start_length + i, 1000 + 2 * i)
        states.append(st)
        prev_hash = pm.host_full_state_hash(st)
    return states, tip_state


def dummy_tip_doc() -> dict:
    """A structurally-valid TIP_PROOF wire value with zeroed content —
    for envelope tests that never device-verify the tip (those prove a
    real tip via pickles.prove_tip and pass it alongside)."""
    pt = ("Infinity", [])
    return {
        "statement": {"step_acc_prechals": [], "step_acc_sg": pt},
        "proof": {
            "public": [],
            "prev_challenges": [],
            "commitments": {
                "w_comm": [],
                "z_comm": [pt],
                "s_comm": [],
                "rt_comm": [pt],
                "zl_comm": [pt],
                "t_comm": [],
            },
            "evals": [],
            "ft_eval1": 0,
            "opening": {
                "lr": [],
                "delta": pt,
                "z1": 0,
                "z2": 0,
                "sg": pt,
                "chals": [],
                "u_hints": {"sel": 0, "y": 0, "w0": 0, "w1": 0, "alpha": 0},
            },
        },
        "step_proof": None,
    }


def make_state_proof(rng, tip_doc: dict | None = None):
    states, tip_state = make_chain(rng)
    # make_chain hashed each state into the next one's previous_state_hash
    cand_hashes = [s["previous_state_hash"] for s in states[1:]] + [pm.host_full_state_hash(states[-1])]
    ledgers = [
        s["body"]["blockchain_state"]["snarked_ledger_hash"] for s in states
    ]
    pub = pm.MinaStatePubInputs(
        bridge_tip_state_hash=pm.host_full_state_hash(tip_state),
        candidate_chain_state_hashes=cand_hashes,
        candidate_chain_ledger_hashes=ledgers,
    )
    proof = pm.MinaStateProof(
        candidate_tip_proof=tip_doc if tip_doc is not None else dummy_tip_doc(),
        candidate_chain_states=[mt.PROTOCOL_STATE.encode(s) for s in states],
        bridge_tip_state=mt.PROTOCOL_STATE.encode(tip_state),
    )
    return pub, proof, states, tip_state


# --- accounts & ledger ----------------------------------------------------

def make_account(rng, with_zkapp: bool = True) -> dict:
    f = lambda: rng.randrange(FP.p)
    zkapp = None
    if with_zkapp:
        vk = {
            "max_proofs_verified": ("N2", []),
            "actual_wrap_domain_size": ("N1", []),
            "sigma_comm": [{"x": f(), "y": f()} for _ in range(7)],
            "coefficients_comm": [{"x": f(), "y": f()} for _ in range(15)],
            "generic_comm": {"x": f(), "y": f()},
            "psm_comm": {"x": f(), "y": f()},
            "complete_add_comm": {"x": f(), "y": f()},
            "mul_comm": {"x": f(), "y": f()},
            "emul_comm": {"x": f(), "y": f()},
            "endomul_scalar_comm": {"x": f(), "y": f()},
        }
        zkapp = {
            "app_state": [f() for _ in range(8)],
            "verification_key": vk,
            "zkapp_version": 2,
            "action_state": [f() for _ in range(5)],
            "last_action_slot": 1200,
            "proved_state": True,
            "zkapp_uri": "ipfs://fixture",
        }
    auth = lambda name: (name, [])
    return {
        "public_key": _pk(rng),
        "token_id": 1,
        "token_symbol": "MINA",
        "balance": rng.randrange(10**9),
        "nonce": rng.randrange(1000),
        "receipt_chain_hash": f(),
        "delegate": _pk(rng) if rng.random() < 0.5 else None,
        "voting_for": f(),
        "timing": ("Untimed", [])
        if rng.random() < 0.5
        else (
            "Timed",
            [
                {
                    "initial_minimum_balance": 10,
                    "cliff_time": 20,
                    "cliff_amount": 5,
                    "vesting_period": 2,
                    "vesting_increment": 1,
                }
            ],
        ),
        "permissions": {
            name: (auth("Signature") if name != "set_verification_key" else (auth("Proof"), 3))
            for name, _ in mt.PERMISSIONS.fields
        },
        "zkapp": zkapp,
    }


class SparseLedger:
    """Depth-35 Merkle ledger with lazily computed empty-subtree hashes."""

    def __init__(self, depth: int = LEDGER_DEPTH):
        self.depth = depth
        self.leaves: dict[int, int] = {}
        self.empties = [0]
        from .state_hash import PREFIX_MERKLE_TREE

        for d in range(depth):
            e = self.empties[d]
            self.empties.append(
                host_hash_with_prefix(f"{PREFIX_MERKLE_TREE}[{d}]", [e, e])
            )

    def set_leaf(self, index: int, leaf_hash: int) -> None:
        self.leaves[index] = leaf_hash

    def _node(self, depth_above: int, index: int) -> int:
        """Hash of subtree at height `depth_above` (0 = leaf) and index."""
        if depth_above == 0:
            return self.leaves.get(index, self.empties[0])
        lo = index << 1
        span = [
            k
            for k in self.leaves
            if lo << (depth_above - 1) <= k < (index + 1) << depth_above
        ]
        if not span:
            return self.empties[depth_above]
        left = self._node(depth_above - 1, lo)
        right = self._node(depth_above - 1, lo + 1)
        return host_hash_with_prefix(
            f"{self._prefix(depth_above - 1)}", [left, right]
        )

    @staticmethod
    def _prefix(d: int) -> str:
        from .state_hash import PREFIX_MERKLE_TREE

        return f"{PREFIX_MERKLE_TREE}[{d}]"

    def root(self) -> int:
        return self._node(self.depth, 0)

    def path(self, index: int) -> list[tuple[str, list[int]]]:
        """Merkle path in proof_model format [('Left'|'Right', [hash])]."""
        out = []
        idx = index
        for d in range(self.depth):
            sib_idx = idx ^ 1
            sib = self._node(d, sib_idx)
            side = "Left" if sib_idx < idx else "Right"
            out.append((side, [sib]))
            idx >>= 1
        return out


def make_account_batch(seed: int, n: int, depth: int = LEDGER_DEPTH) -> tuple[list[dict], list[list]]:
    """n accounts from random.Random(seed), every second one a zkApp, and
    for each a Merkle path of `depth` seeded random siblings on random
    sides, in proof_model format [('Left'|'Right', [hash])]. The ledger
    hashes they fold to are the caller's to compute."""
    rng = random.Random(seed)
    accounts = [make_account(rng, with_zkapp=i % 2 == 0) for i in range(n)]
    paths = [[(rng.choice(("Left", "Right")), [rng.randrange(FP.p)]) for _ in range(depth)] for _ in range(n)]
    return accounts, paths


# --- the Proof-of-State fixtures -----------------------------------------

POS_SEED = 0x5057  # scripts/make_pos_fixture.py's seed


def pos_fixture_path(block_log_n: int, step_log_n: int, batch: int) -> pathlib.Path:
    return bf.FIXTURES / f"pos_2e{block_log_n}_s2e{step_log_n}_b{batch}.json.gz"


POS_FIXTURE = pos_fixture_path(10, 4, 8)  # the toy tips' (pickles.BLOCK_LOG_N, STEP_LOG_N)


def make_pos_fixture(
    seed: int = POS_SEED,
    batch: int = 8,
    block_log_n: int = 10,
    step_log_n: int = 4,
    device: str | None = None,
    tip_prover=None,
    start: int = 0,
    count: int | None = None,
    out: pathlib.Path | None = None,
    timings: list | None = None,
) -> dict:
    """State proofs start .. start + count - 1 (count: the rest of
    `batch`) of a Proof-of-State fixture, as a document in the layout of
    the committed toy file. Proof i: random.Random(seed + i) makes the
    chain (make_state_proof), then the tip binding the chain's tip hash is
    proven with the same rng, by pickles.prove_tip at the given domains on
    `device` (the card unless "cpu"), or by tip_prover(state_hash, rng)
    when given, and put on the wire as the proof's candidate tip.

    The file holds the docs of the verifier indexes that
    pickles.block_setup / step_setup build on `device`. out: where the document is written after every proof (a temporary
    name, then a rename). timings, when given, receives prove_tip's
    timings a tip."""
    from ..pickles import verifier as pv
    from . import pickles_wire

    count = batch - start if count is None else count
    wrap_index, step_index = pv.block_setup(block_log_n, step_log_n, device)[1], pv.step_setup(step_log_n, device)[1]
    doc = {"block_log_n": block_log_n, "step_log_n": step_log_n, "seed": seed, "proofs": [],
           "wrap_index": bf._index_doc(wrap_index), "step_index": bf._index_doc(step_index)}
    for i in range(start, start + count):
        t0 = time.perf_counter()
        rng = random.Random(seed + i)
        pub, proof, _, _ = make_state_proof(rng)
        if tip_prover is None:
            st = {} if timings is not None else None
            tip = pv.prove_tip(pub.candidate_chain_state_hashes[-1], rng, log_n=block_log_n, step_log_n=step_log_n,
                               device=device, timings=st)
            if timings is not None:
                timings.append(st)
        else:
            tip = tip_prover(pub.candidate_chain_state_hashes[-1], rng)
        proof = dataclasses.replace(proof, candidate_tip_proof=pickles_wire.tip_doc(tip))
        doc["proofs"].append({"seed": seed + i, "pub": pub.encode().hex(), "proof": proof.encode().hex()})
        if out is not None:
            bf.write_doc(out, doc)
        logging.getLogger(__name__).info("state proof %d: tip proven in %.1f s", i, time.perf_counter() - t0)
    return doc


def merge_pos_fixtures(out: pathlib.Path, parts: list[pathlib.Path]) -> int:
    """The proofs of `parts`, in order, as one fixture at `out`; the parts
    must agree on the domains, the seed and both index docs. Returns the
    number of proofs."""
    docs = [bf.read_doc(p) for p in parts]
    keys = ("block_log_n", "step_log_n", "seed", "wrap_index", "step_index")
    for path, d in zip(parts, docs):
        if any(d[k] != docs[0][k] for k in keys):
            raise ValueError(f"{path} differs from {parts[0]} in {[k for k in keys if d[k] != docs[0][k]]}")
    merged = dict(docs[0], proofs=[e for d in docs for e in d["proofs"]])
    bf.write_doc(out, merged)
    return len(merged["proofs"])


def load_pos_fixture(path: pathlib.Path = POS_FIXTURE) -> dict:
    """-> {"block_log_n", "step_log_n", "seeds", "pubs", "proofs",
    "wrap_index", "step_index"}: the pub inputs and proofs decoded from
    their binprot hex (each proof's tip is `proof.tip_proof()`), and both
    host verifier indexes (`pickles.fixtures.device_index` puts one on a
    device)."""
    from ..curves.host import PALLAS, VESTA

    doc = bf.read_doc(path)
    return {
        "block_log_n": doc["block_log_n"],
        "step_log_n": doc["step_log_n"],
        "seeds": [e["seed"] for e in doc["proofs"]],
        "pubs": [pm.MinaStatePubInputs.decode(bytes.fromhex(e["pub"])) for e in doc["proofs"]],
        "proofs": [pm.MinaStateProof.decode(bytes.fromhex(e["proof"])) for e in doc["proofs"]],
        "wrap_index": bf._index_from_doc(doc["wrap_index"], PALLAS),
        "step_index": bf._index_from_doc(doc["step_index"], VESTA),
    }
