"""The work counts: from the shapes of a call only, frozen formulas."""

from __future__ import annotations

import torch

from mina_bridge_tpu_torch.curves.host import PALLAS
from mina_bridge_tpu_torch.hash import poseidon
from mina_bridge_tpu_torch.hash import transcript_kernel as tk
from mina_bridge_tpu_torch.hash.poseidon_params import poseidon_spec
from portbench.roofline import OPS_PER_PRODUCT, least_seconds
from portbench.roofline import msm as rmsm
from portbench.roofline import transcript as rtr


def test_msm_work_is_the_bucket_method_of_its_point_count():
    N = 65536 + 112 * 128
    ops, nbytes = rmsm.counts(N)
    adds = 20 * (N + 2 * 4097) + 19
    assert ops == (adds * 12 + 19 * 13 * 6) * OPS_PER_PRODUCT
    assert nbytes == N * 96 + 20 * 96
    t, bound = least_seconds(ops, nbytes)
    assert bound == "operations" and 3.0e-4 < t < 3.5e-4


def test_msm_work_reads_shapes_not_values():
    # what a kernel writes, or how it lays out its points, never enters
    N = 4097
    a = rmsm.work(PALLAS, torch.zeros((N, 20), dtype=torch.int64), torch.zeros((3, 22, N), dtype=torch.int64))
    b = rmsm.work(PALLAS, torch.ones((N, 20), dtype=torch.int64), torch.ones((3, 22, N + 5), dtype=torch.int64), G=64)
    assert a == b == rmsm.counts(N)


def test_transcript_blocks_match_the_program_schedule():
    ps = poseidon_spec("fp")
    x = torch.zeros((4, 20), dtype=torch.int64)
    for ops in (
        [("absorb", x)] * 5 + [("squeeze",)] * 3,
        [("absorb", x), ("squeeze",), ("absorb", x), ("absorb", x), ("absorb", x), ("squeeze",), ("squeeze",)],
        [("squeeze",), ("squeeze",), ("squeeze",)],
    ):
        n_blocks, n_abs, n_sq = rtr.blocks(ops)
        seen = []
        real = tk.transcript_blocks

        def spy(ps_, state, adds):
            seen.append(adds.shape[0])
            return real(ps_, state, adds)

        tk.transcript_blocks = spy
        try:
            poseidon.run_transcript(ps, ops, batch_shape=(4,), device="cpu")
        finally:
            tk.transcript_blocks = real
        assert seen == [n_blocks]
        assert (n_abs, n_sq) == (sum(o[0] == "absorb" for o in ops), sum(o[0] == "squeeze" for o in ops))
        ops_count, nbytes = rtr.work(ps, ops, batch_shape=(4,))
        assert ops_count == 4 * n_blocks * 55 * 21 * OPS_PER_PRODUCT
        assert nbytes == 4 * 32 * (n_abs + n_sq + 6)
