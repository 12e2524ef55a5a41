"""Multi-chip sharding on the virtual 8-device CPU mesh (the standard way to
test collectives without several accelerators; see tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from snark_bn254_verifier_tpu.models.jax_backend import (
    pack_fr_canonical,
    pack_g1,
    unpack_g1_jacobian,
)
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.parallel import sharded as S

pytestmark = pytest.mark.slow

requires_multidevice = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices"
)


@requires_multidevice
def test_mesh_construction():
    n = len(jax.devices())
    mesh = S.make_mesh(n, model_parallelism=2 if n % 2 == 0 else 1)
    assert set(mesh.axis_names) == {"data", "model"}


@requires_multidevice
def test_sharded_msm_matches_oracle():
    n_dev = len(jax.devices())
    model = 2 if n_dev % 2 == 0 else 1
    mesh = S.make_mesh(n_dev, model_parallelism=model)
    npts = 4 * model
    pts = [bn.g1_mul(bn.G1_GEN, i + 2) for i in range(npts)]
    scs = [3 * i + 1 for i in range(npts)]
    px, py, pinf = pack_g1(pts)
    points = (px.T[:, :, None], py.T[:, :, None], pinf[:, None])
    scalars = pack_fr_canonical(scs).T[:, :, None]
    with mesh:
        acc = S.sharded_msm(mesh, points, scalars)
    got = unpack_g1_jacobian(acc)[0]
    assert got == bn.g1_msm(pts, scs)


@requires_multidevice
def test_data_sharded_batch_tensors():
    mesh = S.make_mesh(len(jax.devices()), model_parallelism=1)
    x = jnp.zeros((16, 2 * len(jax.devices())), jnp.uint32)
    sx = S.shard_batch(x, mesh)
    assert sx.sharding.spec == jax.sharding.PartitionSpec(None, "data")


def test_graft_entry_importable():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location("graft_entry", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.entry)
    assert callable(mod.dryrun_multichip)


@requires_multidevice
def test_groth16_batch_verifier_on_data_mesh():
    """Groth16BatchVerifier(vk, mesh=...) spreads one batch over a 4-way
    data mesh and accepts exactly the valid lanes."""
    import chip_smoke
    from snark_bn254_verifier_tpu.parallel.batch import Groth16BatchVerifier

    mesh = S.make_mesh(4, model_parallelism=1)
    vk, proofs, inputs, kinds = chip_smoke.lane_plan("groth16", 8)
    got = Groth16BatchVerifier(vk, mesh=mesh).verify_batch(proofs, inputs)
    assert got.tolist() == [k == "valid" for k in kinds]
