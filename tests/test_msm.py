"""Pippenger MSM vs the oracle (small N so CPU compile stays bounded)."""

import random

import jax
import numpy as np
import pytest

from snark_bn254_verifier_tpu.models.jax_backend import unpack_g1_jacobian
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import field as F
from snark_bn254_verifier_tpu.ops import msm as M

pytestmark = pytest.mark.slow

rng = random.Random(9)


def _pack(pts, scs):
    x = np.stack([F.FQ.pack_scalar(p[0] if p else 0) for p in pts])
    y = np.stack([F.FQ.pack_scalar(p[1] if p else 0) for p in pts])
    inf = np.asarray([p is None for p in pts])
    sc = np.stack([F.FR.pack_scalar(s, mont=False) for s in scs])
    return (x, y, inf), sc


def test_pippenger_matches_oracle_with_edge_cases():
    n = 32
    pts = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(n)]
    scs = [rng.randrange(bn.R) for _ in range(n)]
    scs[3] = 0        # zero scalar
    pts[7] = None     # infinity input
    scs[9] = scs[10]  # duplicate scalar (same bucket, distinct points)
    pts[11] = pts[12]  # duplicate point (bucket doubling path)
    points, sc = _pack(pts, scs)
    out = M.msm_pippenger_jit(points, sc, c=8)
    got = unpack_g1_jacobian(jax.tree_util.tree_map(lambda a: a[:, None], out))[0]
    exp = bn.g1_msm([p for p in pts if p], [s for p, s in zip(pts, scs) if p])
    assert got == exp


def _trapdoor_points(n, seed=5):
    """n points P_i = (k0+i)*G via incremental oracle adds (O(n) cheap adds,
    not n scalar-muls) + the closed-form expected MSM result."""
    r = random.Random(seed)
    k0 = r.randrange(1, bn.R)
    pts, acc = [], bn.g1_mul(bn.G1_GEN, k0)
    for _ in range(n):
        pts.append(acc)
        acc = bn.g1_add(acc, bn.G1_GEN)
    scs = [r.randrange(bn.R) for _ in range(n)]
    expected_scalar = sum(s * (k0 + i) for i, s in enumerate(scs)) % bn.R
    return pts, scs, bn.g1_mul(bn.G1_GEN, expected_scalar)


def test_msm_best_dispatches_to_pippenger_at_threshold():
    """Threshold-crossing batched dispatch (B=2) bit-equals the oracle."""
    n = M.PIPPENGER_THRESHOLD
    pts, scs, exp = _trapdoor_points(n)
    points, sc = _pack(pts, scs)
    pts_b = tuple(
        np.repeat(a[..., None], 2, axis=-1) if a.ndim == 2 else np.repeat(a[:, None], 2, axis=1)
        for a in points
    )
    sc_b = np.repeat(sc[..., None], 2, axis=-1)
    out = jax.jit(M.msm_best)(pts_b, sc_b)
    got = unpack_g1_jacobian(out)
    assert got == [exp, exp]


def test_sharded_msm_pippenger_large():
    """2^12-point MSM sharded over the 8-device mesh: each chip runs a
    512-point Pippenger shard (the BASELINE 2^16 config's code path) and
    the reduced result bit-equals the trapdoor expectation. (2^12 keeps the
    CPU-mesh runtime bounded; the full 2^16 runs on the GPU via bench.py.)"""
    from snark_bn254_verifier_tpu.parallel.sharded import make_mesh, sharded_msm

    n = 1 << 12
    pts, scs, exp = _trapdoor_points(n, seed=6)
    points, sc = _pack(pts, scs)
    pts_b = (points[0][..., None], points[1][..., None], points[2][:, None])
    sc_b = sc[..., None]
    mesh = make_mesh(8, model_parallelism=8)
    out = sharded_msm(mesh, pts_b, sc_b)
    got = unpack_g1_jacobian(out)[0]
    assert got == exp


def test_jax_backend_msm_large_uses_pippenger():
    from snark_bn254_verifier_tpu.models.jax_backend import JaxBackend

    n = 80
    pts, scs, exp = _trapdoor_points(n, seed=7)
    assert JaxBackend.msm(pts, scs) == exp


def test_pippenger_all_zero_scalars_is_infinity():
    n = 8
    pts = [bn.g1_mul(bn.G1_GEN, i + 1) for i in range(n)]
    scs = [0] * n
    points, sc = _pack(pts, scs)
    out = M.msm_pippenger_jit(points, sc, c=8)
    got = unpack_g1_jacobian(jax.tree_util.tree_map(lambda a: a[:, None], out))[0]
    assert got is None
