"""K2: a whole Poseidon transcript schedule as one CUDA kernel.

Counterpart of mina_bridge_tpu/hash/transcript_kernel.py::transcript_blocks
(Pallas grid (T,) carrying the sponge state in VMEM scratch). The CUDA
kernel is csrc/transcript.cu: Hopper has no sequential grid, so a group
of four lanes owns one transcript (one lane per state word, sharing the
sbox outputs by warp shuffles) and loops over the T blocks, eight
transcripts to a one-warp block (see the note there on what bounds it).

`transcript_blocks` takes the ffl layout. On a CPU tensor it runs
`transcript_blocks_plain` (add, then poseidon.permute, per block); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from ..fields import ffl
from ..fields.chain_kernel import field_id
from .poseidon_params import RATE, WIDTH, PoseidonSpec

__all__ = ["transcript_blocks", "transcript_blocks_plain"]


def _mont_words(v: int, p: int) -> list[int]:
    """v * 2^256 mod p as four 64-bit words, stored as signed int64."""
    m = (v << 256) % p
    words = [(m >> (64 * i)) & ((1 << 64) - 1) for i in range(4)]
    return [w - (1 << 64) if w >= (1 << 63) else w for w in words]


@functools.cache
def _mont_tables(ps: PoseidonSpec, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(55, 3, 4) round constants and (3, 3, 4) MDS in Montgomery words."""
    p = ps.field.p
    rc = np.array([[_mont_words(c, p) for c in row] for row in ps.round_constants], dtype=np.int64)
    mds = np.array([[_mont_words(c, p) for c in row] for row in ps.mds], dtype=np.int64)
    return torch.as_tensor(rc, device=device), torch.as_tensor(mds, device=device)


def transcript_blocks_plain(ps: PoseidonSpec, state: torch.Tensor, adds: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch ops."""
    from .poseidon import permute

    outs = []
    st = state
    for t in range(adds.shape[0]):
        absorbed = ffl.add(ps.field, st[..., :RATE, :], adds[t].movedim(0, -2))
        st = permute(ps, torch.cat([absorbed, st[..., RATE:, :]], dim=-2))
        outs.append(st)
    return torch.stack(outs)


def transcript_blocks(ps: PoseidonSpec, state: torch.Tensor, adds: torch.Tensor) -> torch.Tensor:
    """Run T pre-scheduled permutation blocks.

    state: (..., 3, 22) initial sponge state; adds: (T, 2, ..., 22)
    pre-permute additions per block. Returns (T, ..., 3, 22): the state
    after each block (canonical limbs from the kernel)."""
    bshape = state.shape[:-2]
    L = state.shape[-1]
    assert L == ffl.REP_LIMBS and state.shape[-2] == WIDTH
    if state.device.type == "cpu":
        return transcript_blocks_plain(ps, state, adds)
    T = adds.shape[0]
    B = int(np.prod(bshape, dtype=np.int64)) if bshape else 1
    st = state.to(ffl.DTYPE).reshape(B, WIDTH, L).contiguous()
    ad = adds.to(ffl.DTYPE).reshape(T, RATE, B, L).contiguous()
    rc, mds = _mont_tables(ps, st.device)
    kernels.require_cuda("transcript_blocks", st, ad)
    out = torch.empty((T, B, WIDTH, L), dtype=ffl.DTYPE, device=st.device)
    code = kernels.lib("transcript").mbt_transcript(
        field_id(ps.field), st.data_ptr(), ad.data_ptr(), out.data_ptr(), rc.data_ptr(),
        mds.data_ptr(), rc.shape[0], T, B, kernels.stream(),
    )
    kernels.check(code, "transcript_blocks")
    return out.reshape((T,) + tuple(bshape) + (WIDTH, L))
