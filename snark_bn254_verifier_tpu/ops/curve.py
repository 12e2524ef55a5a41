"""G1/G2 elliptic-curve ops, generic over the coordinate field.

Points live in Jacobian coordinates (X, Y, Z) — x = X/Z^2, y = Y/Z^3,
infinity encoded as Z == 0 — so the hot loops (scalar mul, MSM, pairing
steps) need no field inversions; a single batched inversion converts back to
affine at the boundary. All ops are branch-free (edge cases handled with
selects) and broadcast over trailing batch axes, making them jit/vmap/
shard_map-safe with static shapes.

Replaces `substrate-bn`'s AffineG1/AffineG2/G1/G2 (reference usage:
verifier/src/groth16/verify.rs:2, verifier/src/converter.rs:3; MSM at
verifier/src/plonk/verify.rs:284).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle import bn254 as bn
from . import field as F
from . import tower as T
from .limbs import LIMB_BITS, NUM_LIMBS


@dataclass(frozen=True)
class CurveOps:
    """Field-op bundle + curve constant b, shared by G1 (Fq) and G2 (Fq2)."""

    name: str
    add: Callable
    sub: Callable
    neg: Callable
    mul: Callable
    sq: Callable
    inv: Callable
    is_zero: Callable
    eq: Callable
    select: Callable
    zero: Callable      # like -> 0
    one: Callable       # like -> mont(1)
    b_const: Callable   # like -> curve b coefficient (mont)

    def dbl_coord(self, a):
        return self.add(a, a)


def _fq_b(like):
    return F._const(F.FQ.pack_scalar(bn.B_G1), like)


def _fq2_b(like):
    return T.fq2_pack_const(bn.B_G2, like)


G1_OPS = CurveOps(
    name="g1",
    add=F.fq_add,
    sub=F.fq_sub,
    neg=F.fq_neg,
    mul=F.fq_mul,
    sq=F.fq_sq,
    inv=F.fq_inv,
    is_zero=F.is_zero,
    eq=F.eq,
    select=F.select,
    zero=lambda like: jnp.zeros_like(like),
    one=lambda like: F.one_mont(F.FQ, like),
    b_const=_fq_b,
)

G2_OPS = CurveOps(
    name="g2",
    add=T.fq2_add,
    sub=T.fq2_sub,
    neg=T.fq2_neg,
    mul=T.fq2_mul,
    sq=T.fq2_sq,
    inv=T.fq2_inv,
    is_zero=T.fq2_is_zero,
    eq=T.fq2_eq,
    select=F.select,
    zero=lambda like: T.fq2_zero(like.shape[2:]),
    one=lambda like: T.fq2_one(like.shape[2:]),
    b_const=_fq2_b,
)


# A Jacobian point is the tuple (X, Y, Z); an affine point is (x, y, inf_mask)
# where inf_mask is a batch-shaped bool.


def to_jacobian(ops: CurveOps, affine):
    x, y, inf = affine
    one = ops.one(x)
    zero = ops.zero(x)
    z = ops.select(inf, zero, one)
    return (x, y, z)


def jacobian_is_inf(ops: CurveOps, p):
    return ops.is_zero(p[2])


def jacobian_double(ops: CurveOps, p):
    """dbl-2009-l: A=X^2, B=Y^2, C=B^2, D=2((X+B)^2-A-C), E=3A, F=E^2,
    X3=F-2D, Y3=E(D-X3)-8C, Z3=2YZ. Valid for a=0 curves; maps infinity to
    infinity (Z3 = 0) automatically, and order-2 points don't exist here."""
    x, y, z = p
    a = ops.sq(x)
    b = ops.sq(y)
    c = ops.sq(b)
    d = ops.sub(ops.sub(ops.sq(ops.add(x, b)), a), c)
    d = ops.dbl_coord(d)
    e = ops.add(ops.dbl_coord(a), a)
    f = ops.sq(e)
    x3 = ops.sub(f, ops.dbl_coord(d))
    c8 = ops.dbl_coord(ops.dbl_coord(ops.dbl_coord(c)))
    y3 = ops.sub(ops.mul(e, ops.sub(d, x3)), c8)
    z3 = ops.dbl_coord(ops.mul(y, z))
    return (x3, y3, z3)


def jacobian_add_mixed(ops: CurveOps, p, q_affine):
    """p (Jacobian) + q (affine with explicit infinity mask), branch-free.

    madd-2007-bl with full edge handling: q at infinity -> p; p at
    infinity -> q; p == q -> double; p == -q -> infinity.
    """
    x1, y1, z1 = p
    xq, yq, q_inf = q_affine
    z1z1 = ops.sq(z1)
    u2 = ops.mul(xq, z1z1)
    s2 = ops.mul(ops.mul(yq, z1), z1z1)
    h = ops.sub(u2, x1)
    r = ops.sub(s2, y1)
    h_zero = ops.is_zero(h)
    r_zero = ops.is_zero(r)

    hh = ops.sq(h)
    i = ops.dbl_coord(ops.dbl_coord(hh))
    j = ops.mul(h, i)
    rr = ops.dbl_coord(r)
    v = ops.mul(x1, i)
    x3 = ops.sub(ops.sub(ops.sq(rr), j), ops.dbl_coord(v))
    y3 = ops.sub(ops.mul(rr, ops.sub(v, x3)), ops.dbl_coord(ops.mul(y1, j)))
    z3 = ops.mul(ops.dbl_coord(z1), h)

    added = (x3, y3, z3)
    doubled = jacobian_double(ops, p)
    # p == q (h==0, r==0) -> doubled; p == -q (h==0, r!=0) -> infinity
    res = jax.tree_util.tree_map(
        lambda a_, b_: _sel(ops, h_zero & r_zero, b_, a_), added, doubled
    )
    inf_case = jnp.logical_and(h_zero, jnp.logical_not(r_zero))
    zero_z = jnp.zeros_like(z1)
    res = (res[0], res[1], ops.select(inf_case, zero_z, res[2]))
    # p at infinity -> q
    p_inf = ops.is_zero(z1)
    q_jac = to_jacobian(ops, q_affine)
    res = jax.tree_util.tree_map(lambda a_, b_: _sel(ops, p_inf, b_, a_), res, q_jac)
    # q at infinity -> p
    res = jax.tree_util.tree_map(lambda a_, b_: _sel(ops, q_inf, b_, a_), res, p)
    return res


def _sel(ops: CurveOps, cond, a, b):
    return F.select(cond, a, b)


def jacobian_add(ops: CurveOps, p, q):
    """General Jacobian + Jacobian addition (add-2007-bl), branch-free."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = ops.sq(z1)
    z2z2 = ops.sq(z2)
    u1 = ops.mul(x1, z2z2)
    u2 = ops.mul(x2, z1z1)
    s1 = ops.mul(ops.mul(y1, z2), z2z2)
    s2 = ops.mul(ops.mul(y2, z1), z1z1)
    h = ops.sub(u2, u1)
    r = ops.sub(s2, s1)
    h_zero = ops.is_zero(h)
    r_zero = ops.is_zero(r)

    i = ops.sq(ops.dbl_coord(h))
    j = ops.mul(h, i)
    rr = ops.dbl_coord(r)
    v = ops.mul(u1, i)
    x3 = ops.sub(ops.sub(ops.sq(rr), j), ops.dbl_coord(v))
    y3 = ops.sub(ops.mul(rr, ops.sub(v, x3)), ops.dbl_coord(ops.mul(s1, j)))
    z3 = ops.mul(ops.dbl_coord(ops.mul(z1, z2)), h)

    added = (x3, y3, z3)
    doubled = jacobian_double(ops, p)
    res = jax.tree_util.tree_map(
        lambda a_, b_: _sel(ops, h_zero & r_zero, b_, a_), added, doubled
    )
    inf_case = jnp.logical_and(h_zero, jnp.logical_not(r_zero))
    res = (res[0], res[1], ops.select(inf_case, jnp.zeros_like(z1), res[2]))
    p_inf = ops.is_zero(z1)
    q_inf = ops.is_zero(z2)
    res = jax.tree_util.tree_map(lambda a_, b_: _sel(ops, p_inf, b_, a_), res, q)
    res = jax.tree_util.tree_map(lambda a_, b_: _sel(ops, q_inf, b_, a_), res, p)
    return res


def jacobian_neg(ops: CurveOps, p):
    return (p[0], ops.neg(p[1]), p[2])


def scalar_bits(scalar_limbs, total_bits: int = 256):
    """(16, *batch) canonical Fr limbs -> (total_bits, *batch) bit array,
    MSB first. Vectorized (4 ops) rather than a 256-op unroll. Arbitrary
    ``total_bits`` are supported (truncated scalars for windowed/GLV
    variants): bits are extracted limb-wise and the low ``total_bits`` kept."""
    nlimbs = -(-total_bits // LIMB_BITS)
    shifts = jnp.arange(LIMB_BITS, dtype=jnp.uint32).reshape(
        (1, LIMB_BITS) + (1,) * (scalar_limbs.ndim - 1)
    )
    # (nlimbs, LIMB_BITS, *batch): bit b of limb l = bit l*LIMB_BITS+b
    bits = (scalar_limbs[:nlimbs, None] >> shifts) & jnp.uint32(1)
    bits = bits.reshape((nlimbs * LIMB_BITS,) + scalar_limbs.shape[1:])
    return bits[:total_bits][::-1]  # MSB first


def scalar_mul(ops: CurveOps, affine_point, scalar_limbs, num_bits: int = 256):
    """Double-and-add over the full (static) bit length; scalars are
    canonical (non-Montgomery) Fr limbs. Returns Jacobian."""
    bits = scalar_bits(scalar_limbs, num_bits)
    x, _, _ = affine_point
    like = x[0] if isinstance(x, tuple) else x
    zero_pt = _inf_point(ops, affine_point)

    def body(acc, bit):
        acc = jacobian_double(ops, acc)
        acc2 = jacobian_add_mixed(ops, acc, affine_point)
        take = bit.astype(jnp.bool_)
        acc = jax.tree_util.tree_map(lambda a_, b_: _sel(ops, take, b_, a_), acc, acc2)
        return acc, None

    out, _ = jax.lax.scan(body, zero_pt, bits)
    return out


def _inf_point(ops: CurveOps, affine_point):
    x, y, _ = affine_point
    # + x*0 / y*0: numerically identity, but makes the identity point
    # inherit the inputs' varying mesh axes so it is a valid scan carry
    # init inside shard_map
    vz = (x + y) * jnp.uint32(0)
    zz = ops.zero(x) + vz
    one = ops.one(x) + vz
    return (one, one, zz)


def msm(ops: CurveOps, points, scalars, num_bits: int = 256):
    """Multi-scalar multiplication with a shared-doubling Straus pass.

    points: affine tuple-of-stacked coords with leading point axis N —
      (x:(N,16,*b), y:(N,16,*b), inf:(N,*b)); scalars: (N,16,*b) canonical.
    Cost: num_bits doublings + num_bits*N conditional mixed adds.
    """
    bits = jax.vmap(lambda s: scalar_bits(s, num_bits))(scalars)  # (N, bits, *b)
    bits = jnp.moveaxis(bits, 1, 0)  # (bits, N, *b)
    first = jax.tree_util.tree_map(lambda a: a[0], points)
    acc0 = _inf_point(ops, first)

    def body(acc, step_bits):
        acc = jacobian_double(ops, acc)

        # inner scan over the point axis: ONE conditional mixed-add in the
        # traced graph regardless of N (the unrolled version made XLA:CPU
        # compile time linear in N)
        def add_one(acc, pj_bit):
            pj, take = pj_bit
            cand = jacobian_add_mixed(ops, acc, pj)
            return (
                jax.tree_util.tree_map(
                    lambda a_, b_: _sel(ops, take.astype(jnp.bool_), b_, a_),
                    acc,
                    cand,
                ),
                None,
            )

        acc, _ = jax.lax.scan(add_one, acc, (points, step_bits))
        return acc, None

    out, _ = jax.lax.scan(body, acc0, bits)
    return out


def msm_windowed(ops: CurveOps, points, scalars, w: int = 4, num_bits: int = 256):
    """Windowed shared-doubling MSM (the Straus pass above with w-bit
    digits): per-point 2^w-entry tables, then num_bits shared doublings +
    (num_bits/w) * N table-gather additions — ~2.3x fewer Montgomery
    multiplies than the bit-serial pass at w=4 (which pays a conditional
    add per point per BIT).

    points: (x:(N,16,*b), y:(N,16,*b), inf:(N,*b)) affine; scalars
    (N,16,*b) canonical Fr. Returns Jacobian with (16,*b) coords. ``w``
    must divide LIMB_BITS so digits never span limbs.
    """
    assert LIMB_BITS % w == 0 and num_bits % w == 0
    x, y, inf = points
    n = x.shape[0]
    # point axis folded into the field batch: coords (16, N, *b)
    aff = (jnp.moveaxis(x, 0, 1), jnp.moveaxis(y, 0, 1), inf)
    base = to_jacobian(ops, aff)
    zero = _inf_point(ops, aff)
    # table entries d*P built by a SCAN of uniform T[d] = T[d-1] + P steps
    # (one mixed add in the graph; the dbl/add ladder would be ~30% fewer
    # multiplies but 14 inlined Jacobian ops — measured 13x slower XLA:CPU
    # compile)
    nsteps = (1 << w) - 2

    def tstep(acc, _):
        nxt = jacobian_add_mixed(ops, acc, aff)
        return nxt, nxt

    _, rest = jax.lax.scan(tstep, base, None, length=nsteps)
    tbl = tuple(
        jnp.concatenate([jnp.stack([zero[i], base[i]], 0), rest[i]], 0)
        for i in range(3)
    )

    nwin = num_bits // w
    mask = np.uint32((1 << w) - 1)
    digs = []
    for k in range(nwin):  # high window first
        bitpos = (nwin - 1 - k) * w
        limb, sh = divmod(bitpos, LIMB_BITS)
        digs.append((scalars[:, limb] >> np.uint32(sh)) & mask)
    digs = jnp.stack(digs, 0).astype(jnp.int32)  # (nwin, N, *b)

    aff0 = jax.tree_util.tree_map(lambda a: a[:, 0], aff[:2]) + (inf[0],)
    acc0 = _inf_point(ops, aff0)

    def body(acc, dig):  # dig: (N, *b)
        for _ in range(w):
            acc = jacobian_double(ops, acc)
        idx = dig[None, None]  # (1, 1, N, *b)
        ent = tuple(
            jnp.take_along_axis(t, idx.astype(jnp.int32), axis=0)[0]
            for t in tbl
        )  # coords (16, N, *b)
        ent_n = jax.tree_util.tree_map(lambda a: jnp.moveaxis(a, 1, 0), ent)

        def add_one(a, e):
            return jacobian_add(ops, a, e), None

        acc, _ = jax.lax.scan(add_one, acc, ent_n)
        return acc, None

    out, _ = jax.lax.scan(body, acc0, digs)
    return out


def to_affine(ops: CurveOps, p):
    """Jacobian -> (x, y, inf_mask); infinity maps to (0, 0, True)."""
    x, y, z = p
    inf = ops.is_zero(z)
    zsafe = ops.select(inf, ops.one(x), z)
    zinv = ops.inv(zsafe)
    zinv2 = ops.sq(zinv)
    ax = ops.mul(x, zinv2)
    ay = ops.mul(y, ops.mul(zinv, zinv2))
    zero = ops.zero(x)
    return (ops.select(inf, zero, ax), ops.select(inf, zero, ay), inf)


def is_on_curve_affine(ops: CurveOps, affine):
    x, y, inf = affine
    lhs = ops.sq(y)
    rhs = ops.add(ops.mul(ops.sq(x), x), ops.b_const(x))
    return jnp.logical_or(inf, ops.eq(lhs, rhs))
