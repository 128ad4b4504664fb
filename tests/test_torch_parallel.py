"""The port's multi-rank layer (mina_bridge_tpu_torch.parallel and
ops/msm.py::msm_sharded) on the CPU over gloo, against the JAX package.

One spawn of 4 ranks serves every test of the module (the `world`
fixture): each rank builds the meshes, shards a proof batch, broadcasts,
and runs the sharded MSM over 32 seeded points at pt = 4 and on the
(2, 2) mesh, and writes what it saw into the fixture's directory. The
mesh shapes are held against the JAX package's `make_mesh` over the
first 4 of the conftest's virtual CPU devices (no JAX executable is
built), the MSM against its host oracle `curves/host.py::msm`. Exact.

The rank program below imports torch and the port only: the spawned
ranks import this module, and JAX is imported inside the tests."""

import random

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mina_bridge_tpu_torch.curves import curve as cv
from mina_bridge_tpu_torch.curves import host as thc
from mina_bridge_tpu_torch.fields import ffl
from mina_bridge_tpu_torch.kimchi import verifier as tv
from mina_bridge_tpu_torch.ops import msm as tmsm
from mina_bridge_tpu_torch.parallel import distributed, dryrun
from mina_bridge_tpu_torch.parallel import mesh as pmesh
from mina_bridge_tpu_torch.pickles import verifier as tpv

WORLD = 4
B = 4
NPTS = 32
MESHES = {"default": {}, "1x4": {"n_dp": 1, "n_pt": 4}, "2x2": {"n_dp": 2, "n_pt": 2}, "dp2": {"n_dp": 2}}


def _proofs_like() -> tv.DeviceProofs:
    """A DeviceProofs whose every field is arange-filled (B, 3): row b holds
    b * 3 + field offset, so a slice shows which rows it kept."""
    return tv.DeviceProofs(**{f: torch.arange(B * 3).reshape(B, 3) + 100 * i
                              for i, f in enumerate(tv.DeviceProofs.__dataclass_fields__)})


def _msm_inputs():
    rng = random.Random(41)
    c = thc.PALLAS
    pts = [thc.mul(c, rng.randrange(1, c.scalar.p), c.generator) for _ in range(NPTS)]
    ks = [rng.randrange(c.scalar.p) for _ in range(NPTS)]
    return pts, ks


def _rank_checks(rank, workdir, dev):
    out = {"joined_again": distributed.initialize("gloo")}
    out["mesh"] = {}
    for name, kw in MESHES.items():
        m = pmesh.make_mesh(**kw)
        out["mesh"][name] = {"shape": list(m.shape), "names": list(m.mesh_dim_names), "grid": m.mesh.tolist()}
    out["production"] = {str(dp): list(distributed.production_mesh(dp).shape) for dp in (None, 2)}

    m22 = pmesh.make_mesh(2, 2)
    proofs = _proofs_like()
    rw = torch.arange(B * 2).reshape(B, 2)
    tips = tpv.DeviceTips(wrap=_proofs_like(), acc_prechals=torch.arange(B) * 7, acc_sg=torch.arange(B) * 9)
    sp, srw, stips, none = pmesh.shard_proof_batch((proofs, rw, tips, None), m22)
    out["shard"] = {"z1": sp.z1.tolist(), "public": sp.public.tolist(), "rw": srw.tolist(),
                    "tips_wrap_z1": stips.wrap.z1.tolist(), "acc_prechals": stips.acc_prechals.tolist(),
                    "step": stips.step is None and none is None}
    try:
        pmesh.shard_proof_batch(torch.zeros(3, 2), m22)
        out["odd_batch_raises"] = False
    except ValueError:
        out["odd_batch_raises"] = True
    out["replicated"] = pmesh.replicated((torch.full((2,), rank + 10),), m22)[0].tolist()

    pts, ks = _msm_inputs()
    scalars = torch.as_tensor(ffl.ints_to_limbs(ks))
    points = cv.from_affine_ints(thc.PALLAS, pts)
    out["msm"] = {name: cv.to_affine_ints(thc.PALLAS, tmsm.msm_sharded(thc.PALLAS, scalars, points, m))[0]
                  for name, m in (("pt4", pmesh.make_mesh(n_pt=4)), ("2x2", m22))}
    out["world"] = dist.get_world_size()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return dryrun.spawn(_rank_checks, WORLD, tmp_path_factory.mktemp("parallel"), backend="gloo", device="cpu")


@pytest.mark.parametrize("name", list(MESHES))
def test_make_mesh_matches_jax(world, name):
    """make_mesh's shape, axis names and rank grid equal JAX make_mesh's
    over the first 4 virtual devices, on every rank."""
    import jax

    from mina_bridge_tpu.parallel import mesh as jmesh

    jm = jmesh.make_mesh(**MESHES[name], devices=jax.devices()[:WORLD])
    want = {"shape": list(jm.devices.shape), "names": list(jm.axis_names),
            "grid": np.vectorize(lambda d: d.id)(jm.devices).tolist()}
    for r in world:
        assert r["world"] == WORLD and r["joined_again"] is True
        assert r["mesh"][name] == want


def test_production_mesh_dp_rule(world):
    """dp defaults to the node count (one node here, as JAX's process count
    is one in the test process); an explicit dp splits the world."""
    import jax

    from mina_bridge_tpu.parallel import distributed as jdist

    assert jdist.production_mesh().devices.shape[0] == 1
    assert jdist.production_mesh(2).devices.shape[0] == 2
    for r in world:
        assert r["production"] == {"None": [1, WORLD], "2": [2, WORLD // 2]}


def test_shard_proof_batch(world):
    """Rank r of the (2, 2) mesh holds rows [2 d, 2 d + 2) of every tensor
    field, d = r // 2 its dp coordinate; a batch that does not split raises."""
    for rank, r in enumerate(world):
        d = rank // 2
        rows = torch.arange(B * 3).reshape(B, 3)[2 * d : 2 * d + 2]
        fields = list(tv.DeviceProofs.__dataclass_fields__)
        assert r["shard"]["z1"] == (rows + 100 * fields.index("z1")).tolist()
        assert r["shard"]["public"] == rows.tolist()
        assert r["shard"]["rw"] == torch.arange(B * 2).reshape(B, 2)[2 * d : 2 * d + 2].tolist()
        assert r["shard"]["tips_wrap_z1"] == r["shard"]["z1"]
        assert r["shard"]["acc_prechals"] == [7 * (2 * d), 7 * (2 * d + 1)]
        assert r["shard"]["step"] is True
        assert r["odd_batch_raises"] is True


def test_replicated(world):
    assert [r["replicated"] for r in world] == [[10, 10]] * WORLD


@pytest.mark.parametrize("mesh", ["pt4", "2x2"])
def test_msm_sharded_matches_host(world, mesh):
    """msm_sharded over 32 seeded points (8 a rank at pt = 4, 16 on the
    (2, 2) mesh) equals the JAX host MSM on every rank."""
    from mina_bridge_tpu.curves import host as jhc

    pts, ks = _msm_inputs()
    want = list(jhc.msm(jhc.PALLAS, ks, pts))
    assert [r["msm"][mesh] for r in world] == [want] * WORLD


def test_initialize_without_rendezvous_is_a_noop(monkeypatch):
    """No MASTER_ADDR: initialize joins nothing (world size 1 in-process)."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert distributed.initialize() is False
    assert not dist.is_initialized()
