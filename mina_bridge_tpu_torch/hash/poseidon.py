"""Poseidon permutation and sponge (kimchi shape) on torch tensors, plus the
host (Python int) sponge.

Counterpart of mina_bridge_tpu/hash/poseidon.py: `permute`, `Sponge`,
`hash_fixed`, `run_transcript` and the host `HostSponge` /
`host_permute_py`. Width 3, rate 2, 55 full rounds; each round applies the
x^7 sbox to every word, then the MDS matrix, then the round constants.

Device state has shape (..., 3, 22) (ffl REP limbs). `run_transcript`
simulates a static absorb/squeeze schedule into T permutation blocks and
runs them all through one call of the K2 wrapper
(hash/transcript_kernel.py): the CUDA kernel on the card, the plain torch
loop on the CPU. `hash_fixed` is one such call with a schedule of its own.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..fields import ffl
from ..fields.params import LIMB_BITS, LIMB_MASK, NLIMBS, int_to_limbs
from .poseidon_params import RATE, WIDTH, PoseidonSpec, poseidon_spec

__all__ = [
    "poseidon_spec",
    "permute",
    "hash_fixed",
    "Sponge",
    "run_transcript",
    "HostSponge",
    "host_permute_py",
]


def _antidiag_map(R: int, C: int) -> np.ndarray:
    """(R * C, R + C - 1) 0/1: entry (r C + c, r + c) is 1."""
    m = np.zeros((R * C, R + C - 1))
    r, c = np.divmod(np.arange(R * C), C)
    m[np.arange(R * C), r + c] = 1
    return m


class _Tables(NamedTuple):
    rc: torch.Tensor  # (55, 3, 22) round constants, canonical limbs
    split_fold: torch.Tensor  # (43 x 3 pieces, 20): the reduction's first re-spread with the fold
    split: torch.Tensor  # (20 x 3 pieces, 22): its second re-spread
    mds: torch.Tensor  # (3 x 22, 3 x 43): the MDS products summed per output word
    shifts: torch.Tensor  # (3,) the shifts of the 13-bit pieces


@functools.cache
def _tables(ps: PoseidonSpec, device: torch.device) -> _Tables:
    """The round constants and a round's linear steps as float64 matrices
    (see `_reduce`)."""
    L, W = ffl.REP_LIMBS, WIDTH
    rc = np.stack([np.stack([int_to_limbs(c, L) for c in row]) for row in ps.round_constants])
    mds = np.stack([np.stack([int_to_limbs(c, L) for c in row]) for row in ps.mds]).astype(np.float64)
    fold = np.concatenate([np.eye(NLIMBS), ffl._fold_rows(ps.field, 2 * L + 1 - NLIMBS)])
    conv = _antidiag_map(L, L).reshape(L, L, -1)
    m_mds = np.zeros((W, L, W, 2 * L - 1))
    for i in range(W):
        for j in range(W):
            m_mds[j, :, i] = (mds[i, j][:, None, None] * conv).sum(0)
    f64 = lambda m: torch.as_tensor(m, dtype=torch.float64, device=device)
    return _Tables(
        rc=torch.as_tensor(rc, device=device),
        split_fold=f64(_antidiag_map(2 * L - 1, 3) @ fold),
        split=f64(_antidiag_map(NLIMBS, 3)),
        mds=f64(m_mds.reshape(W * L, -1)),
        shifts=torch.arange(0, 3 * LIMB_BITS, LIMB_BITS, device=device),
    )


def _pieces(t: _Tables, x: torch.Tensor) -> torch.Tensor:
    """(..., n) limbs < 2^39 -> (..., 3 n) float64 13-bit pieces, limb-major."""
    return ((x.unsqueeze(-1) >> t.shifts) & LIMB_MASK).flatten(-2).to(torch.float64)


def _reduce(t: _Tables, x: torch.Tensor) -> torch.Tensor:
    """ffl._reduce, the same limbs: (..., 43) limbs < 2^39 -> REP, with the
    linear steps (re-spread and fold) as float64 matrix products. Every
    product and partial sum in them is an integer below 2^40, so float64
    holds each exactly."""
    y = (_pieces(t, x) @ t.split_fold).to(ffl.DTYPE)
    return (_pieces(t, y) @ t.split).to(ffl.DTYPE)


def _mul(t: _Tables, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """ffl.mul on REP limbs, the same limbs."""
    return _reduce(t, ffl.conv(a, b))


def permute(ps: PoseidonSpec, state: torch.Tensor) -> torch.Tensor:
    """The full permutation on (..., 3, 22) state.

    Each round is the x^7 sbox (x^2, then x^4 and x^3 in one batched
    product, then x^7), the MDS products summed as raw limb convolutions
    (one float64 matrix product, sums < 2^36) plus the round constant,
    reduced once (the same value mod p as the reference's mul + add
    tree). The reductions are `_reduce`'s: the same limbs as ffl's ops in
    fewer torch ops."""
    t = _tables(ps, state.device)
    L = ffl.REP_LIMBS
    st = state
    for r in range(t.rc.shape[0]):
        x2 = _mul(t, st, st)
        x4_x3 = _mul(t, torch.stack([x2, x2]), torch.stack([x2, st]))
        x7 = _mul(t, x4_x3[0], x4_x3[1])
        raw = (x7.flatten(-2).to(torch.float64) @ t.mds).to(ffl.DTYPE).unflatten(-1, (WIDTH, 2 * L - 1))
        raw[..., :L] += t.rc[r]
        st = _reduce(t, raw)
    return st


def initial_state(ps: PoseidonSpec, batch_shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    return ffl.zeros(ps.field, tuple(batch_shape) + (WIDTH,), device)


def _to_rep(x: torch.Tensor) -> torch.Tensor:
    """Accept canonical 20-limb or REP 22-limb input."""
    return ffl.from_canon(x)


def hash_fixed(ps: PoseidonSpec, inputs: torch.Tensor) -> torch.Tensor:
    """Hash a fixed-length sequence of field elements (kimchi `hash`):
    absorb the n inputs, squeeze once.

    inputs: (..., n, 20 or 22) -> canonical (..., 20). The schedule is
    fixed: T = ceil(max(n, 1) / 2) blocks, each adding two inputs (the
    last one zero when n is odd, both when n = 0) to the rate and
    permuting; the digest is word 0 after the last block. So the inputs,
    padded with zeros to 2 T, are one K2 call over every lane from the
    zero state."""
    from .transcript_kernel import transcript_blocks

    x = _to_rep(inputs)
    *bshape, n, L = x.shape
    T = max(-(-n // RATE), 1)
    x = torch.nn.functional.pad(x, (0, 0, 0, RATE * T - n))
    adds = x.reshape(*bshape, T, RATE, L).movedim(-3, 0).movedim(-2, 1)  # (T, 2, ..., L)
    state = initial_state(ps, tuple(bshape), x.device)
    out = transcript_blocks(ps, state, adds)
    return ffl.canon(ps.field, out[-1][..., 0, :])


class Sponge:
    """Batched kimchi sponge over device tensors (host-driven sequencing)."""

    def __init__(self, ps: PoseidonSpec, batch_shape: tuple[int, ...] = (), device="cpu"):
        self.ps = ps
        self.state = initial_state(ps, batch_shape, device)
        self.mode = "absorbing"
        self.offset = 0

    def absorb(self, x: torch.Tensor) -> None:
        """Absorb one field element (canonical 20-limb or REP 22-limb)."""
        x = _to_rep(x)
        if self.mode != "absorbing":
            self.mode, self.offset = "absorbing", 0
        if self.offset == RATE:
            self.state = permute(self.ps, self.state)
            self.offset = 0
        i = self.offset
        st = self.state.clone()
        st[..., i, :] = ffl.add(self.ps.field, self.state[..., i, :], x)
        self.state = st
        self.offset += 1

    def squeeze(self) -> torch.Tensor:
        """Squeeze one canonical 20-limb field element."""
        if self.mode == "absorbing" or self.offset == RATE:
            self.state = permute(self.ps, self.state)
            self.mode, self.offset = "squeezing", 0
        out = self.state[..., self.offset, :]
        self.offset += 1
        return ffl.canon(self.ps.field, out)


def run_transcript(
    ps: PoseidonSpec,
    ops: list,
    sponge: Sponge | None = None,
    batch_shape: tuple[int, ...] = (),
    device=None,
):
    """Execute a static absorb/squeeze schedule as one K2 call.

    ops: list of ("absorb", tensor) / ("squeeze",). The pattern is
    simulated into permutation blocks (each: up to RATE pre-permute
    additions + one permutation); squeezes read the canonicalized state
    after their block, and trailing absorbs after the last block are added
    without a permutation. Semantics equal driving `Sponge` op by op.

    Returns (squeezed: list of canonical (..., 20) tensors, sponge
    positioned for continuation).
    """
    from .transcript_kernel import transcript_blocks

    if sponge is None:
        if device is None:
            device = next(op[1].device for op in ops if op[0] == "absorb")
        sponge = Sponge(ps, batch_shape, device)
    state = sponge.state
    mode, offset = sponge.mode, sponge.offset

    blocks: list[list] = []
    cur: list = []
    squeeze_map: list[tuple[int, int]] = []
    for op in ops:
        if op[0] == "absorb":
            if mode != "absorbing":
                mode, offset = "absorbing", 0
            if offset == RATE:
                blocks.append(cur)
                cur = []
                offset = 0
            cur.append((offset, _to_rep(op[1])))
            offset += 1
        elif op[0] == "squeeze":
            if mode == "absorbing" or offset == RATE:
                blocks.append(cur)
                cur = []
                mode, offset = "squeezing", 0
            squeeze_map.append((len(blocks) - 1, offset))
            offset += 1
        else:
            raise ValueError(op[0])

    T = len(blocks)
    squeezed: list = []
    if T:
        bshape = state.shape[:-2]
        L = state.shape[-1]
        adds = torch.zeros((T, RATE) + tuple(bshape) + (L,), dtype=ffl.DTYPE, device=state.device)
        for t, blk in enumerate(blocks):
            for pos, arr in blk:
                adds[t, pos] += arr.expand(tuple(bshape) + (L,))
        all_states = transcript_blocks(ps, state, adds)
        state = all_states[-1]
        for bi, row in squeeze_map:
            squeezed.append(ffl.canon(ps.field, all_states[bi][..., row, :]))

    # trailing (un-permuted) absorbs go straight into the running state
    if cur:
        state = state.clone()
        for pos, arr in cur:
            state[..., pos, :] = ffl.add(ps.field, state[..., pos, :], arr)

    out_sponge = Sponge(ps, (), state.device)
    out_sponge.state = state
    out_sponge.mode = mode
    out_sponge.offset = offset
    return squeezed, out_sponge


# ---------------------------------------------------------------------------
# Host reference (python ints)
# ---------------------------------------------------------------------------

def host_permute_py(ps: PoseidonSpec, state: list[int]) -> list[int]:
    """The permutation on Python ints."""
    p = ps.field.p
    st = list(state)
    for r in range(len(ps.round_constants)):
        st = [pow(x, 7, p) for x in st]
        st = [sum(ps.mds[i][j] * st[j] for j in range(WIDTH)) % p for i in range(WIDTH)]
        st = [(st[i] + ps.round_constants[r][i]) % p for i in range(WIDTH)]
    return st


class HostSponge:
    def __init__(self, ps: PoseidonSpec):
        self.ps = ps
        self.state = [0] * WIDTH
        self.mode = "absorbing"
        self.offset = 0

    def absorb(self, x: int) -> None:
        if self.mode != "absorbing":
            self.mode, self.offset = "absorbing", 0
        if self.offset == RATE:
            self.state = host_permute_py(self.ps, self.state)
            self.offset = 0
        self.state[self.offset] = (self.state[self.offset] + x) % self.ps.field.p
        self.offset += 1

    def squeeze(self) -> int:
        if self.mode == "absorbing" or self.offset == RATE:
            self.state = host_permute_py(self.ps, self.state)
            self.mode, self.offset = "squeezing", 0
        out = self.state[self.offset]
        self.offset += 1
        return out
