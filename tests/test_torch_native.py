"""The port's native keccak (mina_bridge_tpu_torch/native, its own copy of
keccak.cpp built with g++ into build/native/) against the pure-Python
oracle and the JAX package's native build, with the cases of the JAX
package's tests/test_native.py; its Merkle levels against the batch tree
of bridge/aligned.py; and finalize_batch, whose root and inclusion
proofs the dispatch leaves unchanged. Exact: equal bytes."""

import random
import shutil

import pytest

from mina_bridge_tpu import native as jnative
from mina_bridge_tpu.bridge import aligned as jal
from mina_bridge_tpu_torch import native
from mina_bridge_tpu_torch.bridge import aligned as tal
from mina_bridge_tpu_torch.bridge import keccak as tkeccak
from mina_bridge_tpu_torch.bridge.keccak import keccak256, keccak256_py


def _cases():
    rng = random.Random(1)
    cases = [b"", b"a", b"abc" * 100]
    cases += [rng.randbytes(rng.randrange(0, 500)) for _ in range(50)]
    cases += [bytes(n) for n in (135, 136, 137, 271, 272, 273)]  # 136-byte rate edges
    return cases


def test_native_builds_where_a_compiler_exists():
    """g++ is on the path here, so the dispatch must not fall back; the
    library sits in build/native/ under its source hash."""
    assert shutil.which("g++")
    assert native.available()
    assert native._target().exists() and native._target().parent.name == "native"
    assert native._target().name.startswith("libmbt_native-")


def test_keccak_matches_python_and_jax_native():
    assert keccak256_py(b"").hex() == "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
    cases = _cases()
    want = [keccak256_py(x) for x in cases]
    assert [native.keccak256(x) for x in cases] == want
    assert [keccak256(x) for x in cases] == want  # the dispatch
    assert [jnative.keccak256(x) for x in cases] == want
    assert native.keccak256_batch(cases) == want == jnative.keccak256_batch(cases)


def test_merkle_levels_match_aligned_tree():
    rng = random.Random(2)
    for n in (1, 2, 8):
        leaves = [rng.randbytes(32) for _ in range(n)]
        levels = native.merkle_levels(leaves)
        assert levels == jnative.merkle_levels(leaves)
        level, want = leaves, []
        while len(level) > 1:
            level = [keccak256_py(level[i] + level[i + 1]) for i in range(0, len(level), 2)]
            want.append(level)
        assert levels == want
        root, proofs = tal.build_batch_merkle(leaves)
        assert root == (levels[-1][0] if levels else leaves[0])
        for i in range(n):
            assert tal.verify_batch_inclusion(leaves[i], proofs[i], i, root)
    with pytest.raises(ValueError):
        native.merkle_levels([b"\0" * 32] * 3)


def test_finalize_batch_unchanged_by_dispatch(monkeypatch):
    """A pending batch of 5 seeded submissions: the same root, inclusion
    proofs and commitments through the native dispatch, through the
    pure-Python keccak, and from the JAX package's helpers."""
    rng = random.Random(3)
    tags = [tal.PROVING_SYSTEM_MINA, tal.PROVING_SYSTEM_MINA_ACCOUNT]
    pending = [(rng.randbytes(rng.randrange(100, 3000)), rng.randbytes(96), tags[i % 2]) for i in range(5)]

    def finalize():
        svc = tal.CudaVerifierService(None, None, device="cpu")
        svc.pending = list(pending)
        return [(d.proof_commitment, d.pub_input_commitment, d.proving_system_aux_commitment, d.batch_merkle_root,
                 d.batch_inclusion_proof, d.index_in_batch) for d in svc.finalize_batch()]

    got = finalize()
    monkeypatch.setattr(tkeccak, "keccak256", keccak256_py)
    monkeypatch.setattr(tal, "keccak256", keccak256_py)
    assert finalize() == got
    root, proofs = jal.build_batch_merkle([jal.leaf_commitment(p, pub, tag) for p, pub, tag in pending])
    want = [(jal.keccak256(p), jal.keccak256(pub), jal.proving_system_commitment(tag), root, proofs[i], i)
            for i, (p, pub, tag) in enumerate(pending)]
    assert got == want
