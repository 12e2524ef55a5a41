"""JAX compute backend for the protocol verifiers.

Marshals host-side points (oracle representation: int tuples / None) into
Montgomery limb tensors, runs the device kernels (ops/curve.py MSM,
ops/pairing.py batched pairing) and unpacks results. Jitted kernels are
cached per static shape (number of MSM points / pairing pairs), so repeated
verifications hit the compile cache.

This is the single-proof device path behind
``Groth16Verifier.verify(..., backend="jax")``; the high-throughput batched
pipeline that keeps whole proof batches on device lives in parallel/batch.py.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle import bn254 as bn
from ..ops import curve as C
from ..ops import field as F
from ..ops import pairing as PR
from ..ops.limbs import limbs_batch_to_ints

_RINV = pow(F.FQ.r_mod, -1, bn.P)


# ---------------------------------------------------------------------------
# Packing helpers (host ints <-> device limb tensors)
# ---------------------------------------------------------------------------


def pack_fq(values: Sequence[int]):
    """Host-side: returns a NUMPY array — device transfer happens only at
    jitted-call boundaries, never op by op."""
    return F.FQ.pack(values)


def pack_fr_canonical(values: Sequence[int]):
    return F.FR.pack(values, mont=False)


def unpack_fq(arr) -> List[int]:
    return [v * _RINV % bn.P for v in limbs_batch_to_ints(np.asarray(arr))]


def pack_g1(points) -> Tuple:
    """List of oracle G1 points (None = infinity) -> affine tuple (numpy)."""
    xs = [p[0] if p is not None else 0 for p in points]
    ys = [p[1] if p is not None else 0 for p in points]
    inf = np.asarray([p is None for p in points])
    return (pack_fq(xs), pack_fq(ys), inf)


def pack_g2(points) -> Tuple:
    """G2 coordinates as Fq2 arrays (16, 2, B) (numpy)."""
    x0 = pack_fq([p[0][0] if p is not None else 0 for p in points])
    x1 = pack_fq([p[0][1] if p is not None else 0 for p in points])
    y0 = pack_fq([p[1][0] if p is not None else 0 for p in points])
    y1 = pack_fq([p[1][1] if p is not None else 0 for p in points])
    inf = np.asarray([p is None for p in points])
    return (np.stack([x0, x1], 1), np.stack([y0, y1], 1), inf)


def unpack_g1_jacobian(p) -> List:
    """Device Jacobian batch -> list of oracle affine points.

    Coordinates are stacked ON DEVICE and fetched in one transfer rather
    than one fetch per component."""
    import jax.numpy as jnp

    xs, ys, infs = _to_affine_g1(p)
    both = np.asarray(jnp.stack([jnp.asarray(xs), jnp.asarray(ys)], 0))
    xi = unpack_fq(both[0])
    yi = unpack_fq(both[1])
    ii = np.asarray(infs)
    return [None if ii[j] else (xi[j], yi[j]) for j in range(len(xi))]


def unpack_fq12(x) -> List:
    """(16, 12, B) device Fq12 -> list of oracle tower tuples.
    One device->host transfer for all 12 components (see
    unpack_g1_jacobian on fetch batching)."""
    x = np.asarray(x)
    comps = [unpack_fq(x[:, c]) for c in range(12)]
    nb = len(comps[0])
    return [
        tuple(
            tuple((comps[6 * h + 2 * j][k], comps[6 * h + 2 * j + 1][k]) for j in range(3))
            for h in range(2)
        )
        for k in range(nb)
    ]


# ---------------------------------------------------------------------------
# Jitted kernels, cached per static shape
# ---------------------------------------------------------------------------


@jax.jit
def _to_affine_g1(p):
    return C.to_affine(C.G1_OPS, p)


@functools.lru_cache(maxsize=None)
def _msm_kernel(n: int):
    """Size-dispatched MSM (ops/msm.py::msm_best): Straus below the
    Pippenger threshold, bucketed Pippenger above it."""
    del n  # shape captured by jit specialization

    def run(points, scalars):
        from ..ops import msm as M

        return M.msm_best(points, scalars)

    return jax.jit(run)


# Pairing products are padded with infinity pairs (which contribute 1) to
# a multiple of this many pairs, so single pairings and the 2- and 3-pair
# checks of both protocols share one compiled Miller product.
PAIR_BUCKET = 4


# ---------------------------------------------------------------------------
# Backend
# ---------------------------------------------------------------------------


class JaxBackend:
    """Device-compute backend with the OracleBackend interface."""

    name = "jax"
    _instance = None

    @classmethod
    def instance(cls):
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -- MSM ----------------------------------------------------------------

    @staticmethod
    def msm(points, scalars):
        n = len(points)
        assert n == len(scalars)
        if n == 0:
            return None
        # pack_* put limbs first: (16, N). Kernels want point-major with a
        # trailing batch axis of one: (N, 16, 1).
        px, py, pinf = pack_g1(points)
        pts = (px.T[:, :, None], py.T[:, :, None], pinf[:, None])
        sc = pack_fr_canonical([s % bn.R for s in scalars]).T.copy()[:, :, None]
        out = _msm_kernel(n)(pts, sc)
        return unpack_g1_jacobian(out)[0]

    @staticmethod
    def g1_mul(point, scalar):
        return JaxBackend.msm([point], [scalar])

    # -- pairings -----------------------------------------------------------

    @staticmethod
    def pairing(p, q):
        return JaxBackend.pairing_batch([(p, q)])

    @staticmethod
    def pairing_batch(pairs):
        pairs = list(pairs) + [(None, None)] * (-len(pairs) % PAIR_BUCKET)
        ps = pack_g1([p for p, _ in pairs])
        qs = pack_g2([q for _, q in pairs])
        # limbs-first -> pair-major with a trailing batch axis of one:
        # G1 (16,n)->(n,16,1); G2 (16,2,n)->(n,16,2,1)
        ps = (ps[0].T[:, :, None], ps[1].T[:, :, None], ps[2][:, None])
        qs = (
            np.moveaxis(qs[0], -1, 0)[..., None],
            np.moveaxis(qs[1], -1, 0)[..., None],
            qs[2][:, None],
        )
        return unpack_fq12(PR.pairing_batch_hostcall(ps, qs))[0]

    @staticmethod
    def pairing_batch_is_one(pairs):
        return JaxBackend.pairing_batch(pairs) == bn.FQ12_ONE
