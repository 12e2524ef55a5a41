"""Batched Montgomery field arithmetic (jnp reference path).

Implements Fq/Fr arithmetic on uint32 limb arrays of shape ``(16, *batch)``
(see ops/limbs.py for the layout rationale). All functions broadcast over
trailing batch axes, contain no data-dependent Python control flow, and are
jit/vmap/shard_map-safe. The CIOS Montgomery product keeps every intermediate
strictly below 2^32 so plain uint32 lane arithmetic is exact:

    t[j] + a_i*b_j + c  <=  (2^16-1) + (2^16-1)^2 + (2^16-1)  =  2^32 - 1.

This replaces the reference's `substrate-bn` field layer (`bn::Fq`,
`bn::Fr`; reference call sites at verifier/src/groth16/verify.rs:2,
verifier/src/plonk/verify.rs:2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle import bn254 as bn
from .limbs import LIMB_BITS, LIMB_MASK, NUM_LIMBS, int_to_limbs

L = NUM_LIMBS
_MASK = np.uint32(LIMB_MASK)
_SHIFT = LIMB_BITS


class FieldSpec:
    """Static per-field constants (derived numerically, nothing hand-typed)."""

    def __init__(self, modulus: int, name: str):
        self.modulus = modulus
        self.name = name
        self.mod_limbs = [np.uint32((modulus >> (LIMB_BITS * i)) & LIMB_MASK) for i in range(L)]
        r = 1 << (LIMB_BITS * L)
        self.r_mod = r % modulus
        self.r2 = (r * r) % modulus
        # n0inv = -modulus^-1 mod 2^16 (per-limb CIOS constant)
        self.n0inv = np.uint32((-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))
        self.one_mont_np = int_to_limbs(self.r_mod)         # mont(1)
        self.r2_np = int_to_limbs(self.r2)
        self.zero_np = int_to_limbs(0)

    # -- host packing -------------------------------------------------------
    def to_mont_int(self, v: int) -> int:
        return ((v % self.modulus) << (LIMB_BITS * L)) % self.modulus

    def pack(self, values, mont: bool = True):
        """Host: list of ints -> (16, B) uint32 array (Montgomery form)."""
        vals = [self.to_mont_int(v) if mont else v % self.modulus for v in values]
        return np.stack([int_to_limbs(v) for v in vals], axis=1)

    def pack_scalar(self, v: int, mont: bool = True):
        return int_to_limbs(self.to_mont_int(v) if mont else v % self.modulus)


FQ = FieldSpec(bn.P, "fq")
FR = FieldSpec(bn.R, "fr")


# ---------------------------------------------------------------------------
# Core limb ops
# ---------------------------------------------------------------------------


def _cond_sub_mod(spec: FieldSpec, x, extra):
    """Given limbs ``x`` (16, *batch) plus an overflow word ``extra``,
    return x - modulus if x >= modulus, else x.

    ``extra`` may be any uint32 whose truthiness means "the full value is
    >= 2^256" (mont_mul passes t[L] + top_extra, provably 0 or 1 for BN254
    moduli); the result is guaranteed < 2*modulus, so one conditional
    subtraction fully reduces."""
    nv = _mod_vec(spec, x.ndim - 1)

    def bsub(bw, inp):
        tj, nj = inp
        s = tj - nj - bw
        return s >> np.uint32(31), s & _MASK

    borrow, d = jax.lax.scan(
        bsub,
        x[0] * np.uint32(0),
        (x, jnp.broadcast_to(nv, x.shape)),
    )
    do_sub = jnp.logical_or(extra.astype(jnp.bool_), borrow == 0)
    return jnp.where(do_sub[None], d, x)


def add(spec: FieldSpec, a, b):
    """(a + b) mod modulus."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    batch = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = jnp.broadcast_to(a, (L,) + batch)
    b = jnp.broadcast_to(b, (L,) + batch)

    def cadd(c, inp):
        s = inp[0] + inp[1] + c
        return s >> np.uint32(_SHIFT), s & _MASK

    vz = (a[0] + b[0]) * np.uint32(0)
    carry, t = jax.lax.scan(cadd, vz, (a, b))
    return _cond_sub_mod(spec, t, carry)


def sub(spec: FieldSpec, a, b):
    """(a - b) mod modulus."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    batch = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = jnp.broadcast_to(a, (L,) + batch)
    b = jnp.broadcast_to(b, (L,) + batch)
    nv = jnp.broadcast_to(_mod_vec(spec, len(batch)), (L,) + batch)

    def bsub(bw, inp):
        s = inp[0] - inp[1] - bw
        return s >> np.uint32(31), s & _MASK

    vz = (a[0] + b[0]) * np.uint32(0)
    borrow, d = jax.lax.scan(bsub, vz, (a, b))
    need = borrow.astype(jnp.bool_)

    def cadd(c, inp):
        s = inp[0] + jnp.where(need, inp[1], np.uint32(0)) + c
        return s >> np.uint32(_SHIFT), s & _MASK

    _, out = jax.lax.scan(cadd, vz, (d, nv))
    return out


def neg(spec: FieldSpec, a):
    zero = jnp.zeros_like(a)
    return jnp.where(is_zero(a)[None], zero, sub(spec, zero, a))


def _mod_vec(spec: FieldSpec, batch_ndim: int):
    """Modulus limbs as a (16, 1, ..) broadcastable device constant."""
    n = jnp.asarray(np.asarray(spec.mod_limbs, dtype=np.uint32))
    return n.reshape((L,) + (1,) * batch_ndim)


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a * b * R^-1 mod modulus (R = 2^256).

    CIOS as a ``lax.scan`` over the 16 limbs of ``a`` with deferred column
    carries: the running state is L+1 uint32 columns, each the sum of < 64
    16-bit terms (so always < 2^22, far from overflow); one step absorbs
    a_i * b, extracts the Montgomery digit m from the exact low 16 bits of
    column 0, absorbs m * n and shifts the window down one limb. Carries
    are only materialized for the consumed column, plus one final
    normalization scan.

    The scan keeps the traced graph ~20 ops per step regardless of limb
    count — no scatter/gather anywhere — which is what makes the XLA CPU
    path compile in milliseconds instead of minutes (XLA:CPU's LLVM
    codegen is superlinear in fused scatter chains).
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    batch_shape = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = jnp.broadcast_to(a, (L,) + batch_shape)
    b = jnp.broadcast_to(b, (L,) + batch_shape)
    n_vec = _mod_vec(spec, len(batch_shape))
    n0inv = spec.n0inv
    zrow = jnp.zeros((1,) + batch_shape, jnp.uint32)

    def body(t, ai):
        p = ai[None] * b  # (L, *batch), each product < 2^32 exactly
        t = (
            t
            + jnp.concatenate([p & _MASK, zrow], 0)
            + jnp.concatenate([zrow, p >> np.uint32(_SHIFT)], 0)
        )
        m = (t[0] * n0inv) & _MASK
        q = m[None] * n_vec
        t = (
            t
            + jnp.concatenate([q & _MASK, zrow], 0)
            + jnp.concatenate([zrow, q >> np.uint32(_SHIFT)], 0)
        )
        carry = t[0] >> np.uint32(_SHIFT)  # column 0 is ≡ 0 mod 2^16 now
        t = jnp.concatenate([(t[1] + carry)[None], t[2:], zrow], 0)
        return t, None

    # zeros derived from BOTH inputs so the carry inherits their varying
    # mesh axes (shard_map vma rules reject an unvarying init carry)
    vz = (a[0] + b[0]) * np.uint32(0)
    t0 = jnp.zeros((L + 1,) + batch_shape, jnp.uint32) + vz
    t, _ = jax.lax.scan(body, t0, a)

    # normalize columns (each < 2^22) to 16-bit limbs + overflow word
    def ripple(c, col):
        s = col + c
        return s >> np.uint32(_SHIFT), s & _MASK
    top_extra, limbs = jax.lax.scan(ripple, vz, t[:L])
    extra = t[L] + top_extra
    return _cond_sub_mod(spec, limbs, extra)


def mont_sq(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def double(spec: FieldSpec, a):
    return add(spec, a, a)


# ---------------------------------------------------------------------------
# Predicates / select
# ---------------------------------------------------------------------------


def is_zero(a):
    return jnp.all(a == 0, axis=0)


def eq(a, b):
    return jnp.all(a == b, axis=0)


def select(cond, a, b):
    """cond has batch shape; missing leading axes (limb/component) are
    broadcast automatically."""
    extra = a.ndim - cond.ndim
    return jnp.where(cond[(None,) * extra], a, b)


def geq_half(spec: FieldSpec, a):
    """a > (modulus-1)/2, i.e. 'lexicographically largest' (gnark order).
    Expects canonical (non-Montgomery) limbs."""
    half = (spec.modulus - 1) // 2
    hl = [np.uint32((half >> (LIMB_BITS * i)) & LIMB_MASK) for i in range(L)]
    al = [a[i] for i in range(L)]
    gt = None
    for j in range(L):  # from least to most significant
        limb_gt = al[j] > hl[j]
        limb_eq = al[j] == hl[j]
        gt = limb_gt if gt is None else jnp.where(limb_eq, gt, limb_gt)
    return gt


# ---------------------------------------------------------------------------
# Conversions / exponentiation / inversion
# ---------------------------------------------------------------------------


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, _const(spec.r2_np, a))


def from_mont(spec: FieldSpec, a):
    one = jnp.zeros_like(a).at[0].set(1)
    return mont_mul(spec, a, one)


def _const(np_limbs, like):
    """Broadcast a (16,) numpy constant against the batch shape of ``like``."""
    c = jnp.asarray(np_limbs, dtype=jnp.uint32)
    return c.reshape((L,) + (1,) * (like.ndim - 1))


def one_mont(spec: FieldSpec, like):
    return jnp.broadcast_to(_const(spec.one_mont_np, like), like.shape)


def pow_const(spec: FieldSpec, a, exponent: int):
    """a^exponent (Montgomery in, Montgomery out) for a fixed Python-int
    exponent; a scan over the static bit schedule — the traced graph
    stays two multiplies regardless of exponent size."""
    if exponent == 0:
        return one_mont(spec, a)
    init = one_mont(spec, a)
    bits = jnp.asarray([int(b) for b in bin(exponent)[2:]], dtype=jnp.uint32)

    def body(acc, bit):
        acc = mont_sq(spec, acc)
        acc_mul = mont_mul(spec, acc, a)
        return select(bit.astype(jnp.bool_), acc_mul, acc), None

    out, _ = jax.lax.scan(body, init, bits)
    return out


def inv(spec: FieldSpec, a):
    """Fermat inversion a^(modulus-2); maps zero to zero."""
    return pow_const(spec, a, spec.modulus - 2)


def sqrt_q3mod4(spec: FieldSpec, a):
    """Square root via a^((p+1)/4) (valid for p % 4 == 3, i.e. Fq).
    Returns (root, ok) where ok indicates a was a quadratic residue."""
    assert spec.modulus % 4 == 3
    r = pow_const(spec, a, (spec.modulus + 1) // 4)
    ok = eq(mont_sq(spec, r), a)
    return r, jnp.logical_or(ok, is_zero(a))


def batch_inv(spec: FieldSpec, a, axis: int = -1):
    """Montgomery-trick batched inversion along a batch axis: one Fermat
    inversion amortized over the whole axis. Zero entries map to zero.

    a: (16, ..., N, ...) with the scan axis given relative to batch dims.
    """
    # move target axis to position 1 (right after limbs)
    batch_axis = axis if axis >= 0 else a.ndim + axis
    perm = [0, batch_axis] + [i for i in range(1, a.ndim) if i != batch_axis]
    x = jnp.transpose(a, perm)
    n = x.shape[1]
    onem = one_mont(spec, x[:, 0])
    zmask = is_zero(x)  # (n, ...)
    safe = jnp.where(zmask[None], _bcast_one(spec, x), x)

    def fwd(carry, xi):
        nxt = mont_mul(spec, carry, xi)
        return nxt, carry  # prefix product BEFORE xi

    total, prefixes = jax.lax.scan(fwd, onem, jnp.moveaxis(safe, 1, 0))
    total_inv = inv(spec, total)

    def bwd(carry, inp):
        xi, prefix = inp
        out_i = mont_mul(spec, carry, prefix)  # inverse of xi
        nxt = mont_mul(spec, carry, xi)
        return nxt, out_i

    _, invs = jax.lax.scan(bwd, total_inv, (jnp.moveaxis(safe, 1, 0), prefixes), reverse=True)
    invs = jnp.moveaxis(invs, 0, 1)
    invs = jnp.where(zmask[None], jnp.zeros_like(invs), invs)
    inv_perm = [perm.index(i) for i in range(a.ndim)]
    return jnp.transpose(invs, inv_perm)


def _bcast_one(spec: FieldSpec, like):
    return jnp.broadcast_to(_const(spec.one_mont_np, like), like.shape)


# Convenience wrappers for the two fields. Deliberately ``def``s rather
# than functools.partial: a partial would capture the underlying function
# OBJECT at import, so runtime instrumentation of mont_mul/inv (the
# roofline counter, utils/roofline.py) and any future dispatch changes
# would be silently bypassed by every caller holding the partial (e.g.
# curve.py's CurveOps). A def resolves the target from module globals on
# every call.
def fq_add(a, b):
    return add(FQ, a, b)


def fq_sub(a, b):
    return sub(FQ, a, b)


def fq_neg(a):
    return neg(FQ, a)


def fq_mul(a, b):
    return mont_mul(FQ, a, b)


def fq_sq(a):
    return mont_sq(FQ, a)


def fq_inv(a):
    return inv(FQ, a)


def fr_add(a, b):
    return add(FR, a, b)


def fr_sub(a, b):
    return sub(FR, a, b)


def fr_mul(a, b):
    return mont_mul(FR, a, b)


def fr_inv(a):
    return inv(FR, a)
