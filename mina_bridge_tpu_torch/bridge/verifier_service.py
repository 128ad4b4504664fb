"""The Proof-of-State / Proof-of-Account verifier service.

Counterpart of mina_bridge_tpu/bridge/verifier_service.py.

Proof of State (`verify_states_batch`), for B proofs of 16 candidate
states and the bridge tip each:
 1. decode every state (host), hash every body and then every (previous
    hash, body hash) pair, each as one `hash_fixed` batch over all 17 B
    states (one K2 launch each on the card);
 2. host checks per proof: the pub inputs' state and ledger hashes, the
    bridge tip's hash, the chain's linkage, consensus (candidate vs bridge
    tip), and that the tip proof binds the candidate tip's hash;
 3. one batched Pickles tips verify over the proofs that passed (2),
    bisected only on failure (`_tip_verdicts`).

Proof of Account (`verify_accounts_batch`): the Solidity encoding of the
decoded account against the pub inputs, then the leaf hash and the Merkle
fold along its path (bridge/merkle.py) against the ledger hash, one device
batch per (field count, depth) group.

Unlike the JAX package, the service hashes a batch's zkApp verification
keys (`proof_model.vk_hash`, which both the leaf and the Solidity encoding
need) on the device too, one `hash_fixed` batch per key length, and hands
the digests to `account_fields` and `encode_account_sol`: the port has no
native host Poseidon. Verdicts and reasons are the JAX package's.

Every entry point takes `device` (None: the card; "cpu" for the tests).
`METRICS` times each stage (`accounts.*`, `states.*`).
"""

from __future__ import annotations

import dataclasses
import secrets
from collections import Counter

import numpy as np
import torch

from .. import device as _device
from ..curves.host import PALLAS, VESTA
from ..fields import ffl
from ..fields.params import FP, NLIMBS, int_to_limbs, limbs_to_int
from ..pickles import verifier as pickles
from ..utils.profiling import METRICS
from . import mina_types as mt
from . import proof_model as pm
from .consensus import candidate_wins
from .merkle import device_merkle_roots
from .sol_codec import encode_account_sol
from .state_hash import PREFIX_ACCOUNT, PREFIX_PROTO_STATE_BODY, device_hash_with_prefix, device_state_hashes


def system_rand_weights(batch: int, device: str | None = None) -> torch.Tensor:
    """(B, 5, 20) verifier randomness from OS entropy, on `device` (the
    card unless "cpu").

    The batch's random linear combinations are sound only with weights the
    prover cannot predict, drawn after the proofs are fixed, so a server
    calls this itself when a batch arrives; tests pass weights explicitly.
    Components 0-1 weight the wrap opening (Pallas scalars), 2 the legacy
    accumulator decider (Vesta scalars), 3-4 the step opening (Vesta
    scalars)."""
    rng = secrets.SystemRandom()
    mods = (PALLAS.scalar.p, PALLAS.scalar.p, VESTA.scalar.p, VESTA.scalar.p, VESTA.scalar.p)
    w = np.array([[int_to_limbs(rng.randrange(m), NLIMBS) for m in mods] for _ in range(batch)])
    return torch.as_tensor(w, device=_device(device))


def _pad_batch(tips: pickles.DeviceTips, rw: torch.Tensor, min_batch: int = 2):
    """Pad a tip batch and its weights by duplication to the next power of
    two, at least `min_batch`. A duplicate of a valid tip verifies and a
    duplicate of an invalid one fails beside it, so the verdict holds."""
    B = rw.shape[0]
    target = max(min_batch, 1 << (B - 1).bit_length())
    if B == target:
        return tips, rw
    reps = -(-target // B)

    def tile(x):
        return x.repeat((reps,) + (1,) * (x.dim() - 1))[:target]

    return tips.map(tile), tile(rw)


def _tip_verdicts(
    idxs: list[int],
    tips: pickles.DeviceTips,
    rand_weights: torch.Tensor,
    dindex=None,
    step_dindex=None,
    block_log_n: int = pickles.BLOCK_LOG_N,
    step_log_n: int | None = None,
) -> dict[int, bool]:
    """{index: verdict} for the tips at `idxs`: one batched verify of all
    of them, then, only on failure, the same on each half (padded by
    `_pad_batch`) down to single tips. The indexes and domains go to
    `pickles.batch_verify_tips`, which builds a missing index."""
    verdicts: dict[int, bool] = {}

    def rec(sub: list[int]):
        if not sub:
            return
        sel = torch.as_tensor(sub, device=rand_weights.device)
        tp, rw = _pad_batch(tips.map(lambda x: x[sel]), rand_weights[sel])
        if pickles.batch_verify_tips(tp, rw, dindex, step_dindex, log_n=block_log_n, step_log_n=step_log_n):
            verdicts.update((i, True) for i in sub)
        elif len(sub) == 1:
            verdicts[sub[0]] = False
        else:
            mid = len(sub) // 2
            rec(sub[:mid])
            rec(sub[mid:])

    rec(list(idxs))
    return verdicts


@dataclasses.dataclass
class StateVerificationResult:
    ok: bool
    reason: str = ""


def _limbs(rows: list[list[int]], dev: torch.device) -> torch.Tensor:
    """Rows of n ints below 2^260 -> (rows, n, 20) limbs on `dev` (the
    limbs of `int_to_limbs`, converted in one batch)."""
    n = len(rows[0])
    flat = ffl.ints_to_limbs([v for row in rows for v in row])
    return torch.as_tensor(flat.reshape(len(rows), n, NLIMBS), device=dev)


def _ints(x: torch.Tensor) -> list[int]:
    """(..., 20) limbs -> one int per row."""
    return [limbs_to_int(row) for row in x.cpu().numpy().reshape(-1, x.shape[-1])]


def _vk_digests(accounts: list[dict], dev: torch.device) -> list[int | None]:
    """`proof_model.vk_hash` of each zkApp account's verification key
    (None for an account without one): one device hash per key length."""
    groups: dict[int, list[tuple[int, list[int]]]] = {}
    for i, a in enumerate(accounts):
        zk = a["zkapp"]
        if zk is not None and zk["verification_key"] is not None:
            fields = [x % FP.p for x in pm.vk_fields(zk["verification_key"])]
            groups.setdefault(len(fields), []).append((i, fields))
    out: list[int | None] = [None] * len(accounts)
    for group in groups.values():
        digests = _ints(device_hash_with_prefix(pm.PREFIX_SIDE_LOADED_VK, _limbs([f for _, f in group], dev)))
        for (i, _), d in zip(group, digests):
            out[i] = d
    return out


def verify_proof_of_account(
    pub: pm.MinaAccountPubInputs, proof: pm.MinaAccountProof, device: str | None = None
) -> StateVerificationResult:
    """Single-proof Proof-of-Account: a batch of one on the batched path."""
    [result] = verify_accounts_batch([pub], [proof], device)
    return result


def verify_accounts_batch(
    pubs: list[pm.MinaAccountPubInputs], proofs: list[pm.MinaAccountProof], device: str | None = None
) -> list[StateVerificationResult]:
    """Batched account verification: the leaf hashes and Merkle folds of
    each (field count, depth) group run as one device batch (the bridge's
    account-throughput hot path)."""
    dev = _device(device)
    with METRICS.timer("accounts.decode"):
        accounts = [mt.ACCOUNT.decode(p.account) for p in proofs]
    with METRICS.timer("accounts.vk_hash"):
        vks = _vk_digests(accounts, dev)
    results = [StateVerificationResult(True) for _ in proofs]
    with METRICS.timer("accounts.encode"):
        for i, (a, vk, pub) in enumerate(zip(accounts, vks, pubs)):
            if encode_account_sol(a, vk) != pub.encoded_account:
                results[i] = StateVerificationResult(False, "encoded account mismatch")
        fields = [pm.account_fields(a, vk) for a, vk in zip(accounts, vks)]
    with METRICS.timer("accounts.merkle"):
        roots = _ledger_roots(fields, [p.merkle_path for p in proofs], dev)
    for i, r in enumerate(roots):
        if results[i].ok and r != pubs[i].ledger_hash:
            results[i] = StateVerificationResult(False, "merkle root != ledger hash")
    return results


def _ledger_roots(fields: list[list[int]], paths: list[list], dev: torch.device) -> list[int]:
    """The root each account's leaf (its fields' hash) folds to along its
    Merkle path, one device batch per (field count, depth) group.

    An account's leaf hash must not depend on what it is batched with: the
    sponge absorbs exactly len(fields) elements, so zero-padding a shorter
    account to the batch's longest would change its hash."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (f, path) in enumerate(zip(fields, paths)):
        groups.setdefault((len(f), len(path)), []).append(i)
    roots = [0] * len(fields)
    for idxs in groups.values():
        leaves = device_hash_with_prefix(PREFIX_ACCOUNT, _limbs([fields[i] for i in idxs], dev))
        sibs = _limbs([[nd[1][0] for nd in paths[i]] for i in idxs], dev)
        is_left = torch.as_tensor([[nd[0] == "Left" for nd in paths[i]] for i in idxs], dtype=torch.bool, device=dev)
        for i, r in zip(idxs, _ints(device_merkle_roots(leaves, sibs, is_left))):
            roots[i] = r
    return roots


def full_state_hashes(states: list[dict], dev: torch.device) -> list[int]:
    """`proof_model.host_full_state_hash` of each decoded protocol state,
    on `dev`: the bodies of each field count as one `hash_fixed` batch (one
    K2 launch on the card; a chain's states share one count), then every
    (previous state hash, body hash) pair as one."""
    fields = [pm.state_body_fields(s) for s in states]
    groups: dict[int, list[int]] = {}
    for i, f in enumerate(fields):
        groups.setdefault(len(f), []).append(i)
    body_hashes = torch.empty((len(states), NLIMBS), dtype=torch.int64, device=dev)
    for idxs in groups.values():
        body_hashes[idxs] = device_hash_with_prefix(PREFIX_PROTO_STATE_BODY, _limbs([fields[i] for i in idxs], dev))
    return _ints(device_state_hashes(_limbs([[s["previous_state_hash"] for s in states]], dev)[0], body_hashes))


def verify_proof_of_state(
    pub: pm.MinaStatePubInputs,
    proof: pm.MinaStateProof,
    tip_proof_device: pickles.DeviceTips,
    rand_weights: torch.Tensor,
    dindex=None,
    step_dindex=None,
    device: str | None = None,
    block_log_n: int = pickles.BLOCK_LOG_N,
    step_log_n: int | None = None,
) -> StateVerificationResult:
    """Single-proof Proof-of-State: a batch of one on the batched path
    (verify_states_batch), so its checks exist exactly once."""
    [result] = verify_states_batch([pub], [proof], tip_proof_device, rand_weights, dindex, step_dindex, device,
                                   block_log_n=block_log_n, step_log_n=step_log_n)
    return result


def verify_states_batch(
    pubs: list[pm.MinaStatePubInputs],
    proofs: list[pm.MinaStateProof],
    tip_proofs_device: pickles.DeviceTips,
    rand_weights: torch.Tensor,
    dindex=None,
    step_dindex=None,
    device: str | None = None,
    block_log_n: int = pickles.BLOCK_LOG_N,
    step_log_n: int | None = None,
) -> list[StateVerificationResult]:
    """Verify many Proof-of-States at once: every state's body hash, then
    every state hash, as one device batch each, and the B tips in one
    batched tips verify (see the module docstring). dindex, step_dindex:
    the tips' wrap (Pallas) and step (Vesta) verifier indexes; a missing
    one is built at block_log_n / step_log_n (pickles.batch_verify_tips)."""
    with METRICS.timer("verify_states_batch"):
        results = _verify_states_batch(pubs, proofs, tip_proofs_device, rand_weights, dindex, step_dindex, device,
                                       block_log_n, step_log_n)
    METRICS.count("state_proofs_submitted", len(pubs))
    METRICS.count("state_proofs_verified", sum(r.ok for r in results))
    return results


def _verify_states_batch(pubs, proofs, tip_proofs_device, rand_weights, dindex, step_dindex, device, block_log_n, step_log_n):
    dev = _device(device)
    B = len(pubs)
    n = pm.BRIDGE_TRANSITION_FRONTIER_LEN
    results = [StateVerificationResult(True) for _ in range(B)]
    decoded = []
    with METRICS.timer("states.decode"):
        for b, proof in enumerate(proofs):
            if len(proof.candidate_chain_states) != n:
                results[b] = StateVerificationResult(False, "wrong chain length")
                decoded.append(None)
                continue
            try:
                decoded.append(
                    (
                        [mt.decode_protocol_state_any(s) for s in proof.candidate_chain_states],
                        mt.decode_protocol_state_any(proof.bridge_tip_state),
                    )
                )
            except Exception as e:  # a malformed blob fails alone, not the batch
                results[b] = StateVerificationResult(False, f"undecodable state: {e}")
                decoded.append(None)

    # A proof whose decoded states disagree on the body's field count cannot
    # be stacked into the batch: fail it alone (against the most common
    # count, so one malformed proof never fails the others).
    per_proof_flens = {
        b: [len(pm.state_body_fields(s)) for s in dec[0] + [dec[1]]] for b, dec in enumerate(decoded) if dec is not None
    }
    counts = Counter(fl for fls in per_proof_flens.values() for fl in fls)
    if counts:
        flen = counts.most_common(1)[0][0]
        for b, fls in per_proof_flens.items():
            if any(fl != flen for fl in fls):
                results[b] = StateVerificationResult(False, "inconsistent body field count")
                decoded[b] = None
    all_states = [s for dec in decoded if dec is not None for s in dec[0] + [dec[1]]]
    if all_states:
        with METRICS.timer("states.hash"):
            hashes = full_state_hashes(all_states, dev)

    # per-proof host checks (pub inputs, linkage, consensus)
    with METRICS.timer("states.checks"):
        claimed = _ints(tip_proofs_device.wrap.public[:, 0])
        cursor = 0
        for b, dec in enumerate(decoded):
            if dec is None:
                continue
            states, tip = dec
            cand = hashes[cursor : cursor + n]
            tip_hash = hashes[cursor + n]
            cursor += n + 1
            pub = pubs[b]
            if cand != pub.candidate_chain_state_hashes:
                results[b] = StateVerificationResult(False, "state hash mismatch")
            elif [s["body"]["blockchain_state"]["snarked_ledger_hash"] for s in states] != pub.candidate_chain_ledger_hashes:
                results[b] = StateVerificationResult(False, "ledger hash mismatch")
            elif tip_hash != pub.bridge_tip_state_hash:
                results[b] = StateVerificationResult(False, "bridge tip hash mismatch")
            elif any(states[i + 1]["previous_state_hash"] != cand[i] for i in range(n - 1)):
                results[b] = StateVerificationResult(False, "chain broken")
            elif not candidate_wins(
                pm.consensus_from_state(tip, tip_hash),
                pm.consensus_from_state(states[-1], cand[-1]),
            ):
                results[b] = StateVerificationResult(False, "consensus: not better")
            elif claimed[b] != cand[-1]:
                results[b] = StateVerificationResult(False, "tip proof binds wrong hash")

    # One batched tips verify over the proofs that passed the host checks
    # (bisected only on failure), so a malformed submission can neither
    # mask nor fail another proof's tip verdict.
    ok_idxs = [b for b, r in enumerate(results) if r.ok]
    with METRICS.timer("states.tips"):
        verdicts = _tip_verdicts(ok_idxs, tip_proofs_device, rand_weights, dindex, step_dindex, block_log_n, step_log_n)
    for b in ok_idxs:
        if not verdicts[b]:
            results[b] = StateVerificationResult(False, "tip proof invalid")
    return results
