"""Ouroboros Samasika chain-selection rules (consensus checks).

Re-implements the candidate-vs-tip consensus checks the reference
delegates to the aligned fork's `operator/mina/lib/src/consensus_state.rs`
(reference README.md:290-294) following the protocol rules documented in
README.md:606-778:

* decentralized checkpointing -> short-range fork detection
  (start/lock checkpoints, README.md:633-651)
* sliding-window density -> long-range fork rule (11 sub-window
  densities, ring-shift, projected window, relative minimum window
  density, README.md:653-735)
* selectSecureChain / selectLongerChain with VRF/state-hash tiebreaks
  (README.md:750-766)

All of this is scalar integer logic (SURVEY §2b: "plain logic, still
bit-faithful to spec"); it runs on host next to binprot decoding.

The port's own copy of mina_bridge_tpu/bridge/consensus.py: the port imports
nothing of the JAX package, not even its pure-Python modules.
"""

from __future__ import annotations

import dataclasses

# Protocol constants (Mina mainnet/devnet; README.md:677 — 11 sub-windows)
SLOTS_PER_SUB_WINDOW = 7
SUB_WINDOWS_PER_WINDOW = 11
SLOTS_PER_WINDOW = SLOTS_PER_SUB_WINDOW * SUB_WINDOWS_PER_WINDOW
GRACE_PERIOD_END = 1440  # slots before the long-range density rule activates


@dataclasses.dataclass
class EpochData:
    ledger_hash: int
    seed: int
    start_checkpoint: int
    lock_checkpoint: int
    epoch_length: int


@dataclasses.dataclass
class ConsensusState:
    """The consensus slice of a Mina protocol state (host-decoded)."""

    blockchain_length: int
    epoch_count: int
    min_window_density: int
    sub_window_densities: list[int]  # 11 entries
    last_vrf_output: bytes
    global_slot: int  # curr_global_slot_since_hard_fork
    global_slot_since_genesis: int
    staking_epoch_data: EpochData
    next_epoch_data: EpochData
    state_hash: int = 0  # filled by the caller for tiebreaks


def is_short_range(c1: ConsensusState, c2: ConsensusState) -> bool:
    """Short-range fork <=> fork point after the previous epoch's
    lock_checkpoint (README.md:640-651)."""

    def check(newer: ConsensusState, older: ConsensusState) -> bool:
        # newer is one epoch ahead: its previous-epoch (staking) view must
        # match older's in-progress (next) epoch lock checkpoint.
        return newer.staking_epoch_data.lock_checkpoint == (
            older.next_epoch_data.lock_checkpoint
        )

    if c1.epoch_count == c2.epoch_count:
        return (
            c1.staking_epoch_data.lock_checkpoint
            == c2.staking_epoch_data.lock_checkpoint
        )
    if c1.epoch_count == c2.epoch_count + 1:
        return check(c1, c2)
    if c2.epoch_count == c1.epoch_count + 1:
        return check(c2, c1)
    return False


def _sub_window(global_slot: int) -> int:
    return global_slot // SLOTS_PER_SUB_WINDOW


def project_window(state: ConsensusState, next_global_slot: int) -> list[int]:
    """Projected window of `state` to `next_global_slot` (README.md:698-735).

    All intervening slots are empty, so we ring-shift in zero densities:
    shift_count = min(max(k - 1, 0), SUB_WINDOWS_PER_WINDOW) where k is
    how many sub-windows ahead the target is.
    """
    cur = _sub_window(state.global_slot)
    nxt = _sub_window(next_global_slot)
    k = nxt - cur
    shift_count = min(max(k - 1, 0), SUB_WINDOWS_PER_WINDOW)
    out = list(state.sub_window_densities)
    rel = cur % SUB_WINDOWS_PER_WINDOW
    i = rel
    while shift_count > 0:
        i = (i + 1) % SUB_WINDOWS_PER_WINDOW
        out[i] = 0
        shift_count -= 1
    return out


def relative_min_window_density(
    tip: ConsensusState, candidate: ConsensusState
) -> int:
    """README.md:737-748: project the tip's window to the candidate's
    slot before comparing minimum densities."""
    max_slot = max(tip.global_slot, candidate.global_slot)
    if max_slot < GRACE_PERIOD_END:
        return tip.min_window_density
    projected = project_window(tip, max_slot)
    projected_density = sum(projected)
    return min(tip.min_window_density, projected_density)


def _vrf_cmp(a: bytes, b: bytes) -> int:
    """Compare VRF outputs as big-endian integers (hash comparison)."""
    ia, ib = int.from_bytes(a, "big"), int.from_bytes(b, "big")
    return (ia > ib) - (ia < ib)


def select_longer_chain(
    tip: ConsensusState, candidate: ConsensusState
) -> ConsensusState:
    """README.md:766: length, then VRF tiebreak, then state hash."""
    if candidate.blockchain_length > tip.blockchain_length:
        return candidate
    if candidate.blockchain_length == tip.blockchain_length:
        c = _vrf_cmp(candidate.last_vrf_output, tip.last_vrf_output)
        if c > 0:
            return candidate
        if c == 0 and candidate.state_hash > tip.state_hash:
            return candidate
    return tip


def select_secure_chain(
    tip: ConsensusState, candidate: ConsensusState
) -> ConsensusState:
    """README.md:758-764: short-range forks by length; long-range forks by
    relative minimum window density (then length on ties)."""
    if is_short_range(candidate, tip):
        return select_longer_chain(tip, candidate)
    tip_density = relative_min_window_density(tip, candidate)
    cand_density = relative_min_window_density(candidate, tip)
    if cand_density > tip_density:
        return candidate
    if cand_density == tip_density:
        return select_longer_chain(tip, candidate)
    return tip


def candidate_wins(tip: ConsensusState, candidate: ConsensusState) -> bool:
    """True iff the candidate chain should replace the bridged tip."""
    return select_secure_chain(tip, candidate) is candidate
