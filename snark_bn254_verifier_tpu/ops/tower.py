"""BN254 extension tower: Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3-XI),
Fq12 = Fq6[w]/(w^2-v), XI = 9+u.

Representation: a degree-C tower element is ONE uint32 array of
shape ``(16, C, *batch)`` — limbs, then a component axis, then batch:

    Fq2 : (16, 2, *b)   [re, im]
    Fq6 : (16, 6, *b)   [v0.re, v0.im, v1.re, v1.im, v2.re, v2.im]
    Fq12: (16, 12, *b)  [c0 (Fq6) | c1 (Fq6)]

Because ops/field.py broadcasts over all trailing axes, the component axis
rides along as batch — so a tower add/sub/neg is a single field op, and the
multiplication schedules below flatten each level's *independent* Montgomery
products into one wide ``mont_mul`` call (54 lanes for a full Fq12 multiply).
This keeps the traced graph ~25x smaller than composing scalar field calls
and hands XLA large, well-shaped elementwise ops (the batch axis is the
contiguous trailing axis).

Formulas mirror the oracle (oracle/bn254.py); every constant (XI powers,
Frobenius gammas) is derived numerically from the oracle. Replaces
`substrate-bn`'s Fq2/Fq6/Fq12 tower (SURVEY.md §2.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle import bn254 as bn
from . import field as F

FQ = F.FQ


# ---------------------------------------------------------------------------
# Generic helpers
# ---------------------------------------------------------------------------


def pack_const(coeffs, like):
    """List of C Fq ints -> (16, C, 1...) broadcastable device constant."""
    arr = np.stack([FQ.pack_scalar(c) for c in coeffs], axis=1)
    extra = (1,) * (like.ndim - 2)
    return jnp.asarray(arr).reshape((16, len(coeffs)) + extra)


def fq2_pack_const(val, like):
    return pack_const([val[0], val[1]], like)


def _mul_many(a_parts, b_parts):
    """One wide Montgomery multiply over a list of (16, *b) operand pairs."""
    A = jnp.stack(a_parts, axis=1)
    B = jnp.stack(b_parts, axis=1)
    t = F.fq_mul(A, B)
    return [t[:, i] for i in range(len(a_parts))]


def fq2_mul_many(pairs):
    """Karatsuba Fq2 products, all flattened into a single width-3k
    Montgomery call. pairs: list of ((16,2,*b), (16,2,*b))."""
    k = len(pairs)
    a = jnp.stack([p[0] for p in pairs], axis=1)  # (16, k, 2, *b)
    b = jnp.stack([p[1] for p in pairs], axis=1)
    sa = F.fq_add(a[:, :, 0], a[:, :, 1])  # (16, k, *b)
    sb = F.fq_add(b[:, :, 0], b[:, :, 1])
    A = jnp.concatenate([a[:, :, 0], a[:, :, 1], sa], axis=1)  # (16, 3k, *b)
    B = jnp.concatenate([b[:, :, 0], b[:, :, 1], sb], axis=1)
    t = F.fq_mul(A, B)
    t0, t1, t2 = t[:, :k], t[:, k : 2 * k], t[:, 2 * k :]
    c0 = F.fq_sub(t0, t1)
    c1 = F.fq_sub(t2, F.fq_add(t0, t1))
    out = jnp.stack([c0, c1], axis=2)  # (16, k, 2, *b)
    return [out[:, i] for i in range(k)]


# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------


def fq2_parts(a):
    return a[:, 0], a[:, 1]


def fq2_from_parts(re, im):
    return jnp.stack([re, im], axis=1)


def fq2_add(a, b):
    return F.fq_add(a, b)


def fq2_sub(a, b):
    return F.fq_sub(a, b)


def fq2_neg(a):
    return F.fq_neg(a)


def fq2_double(a):
    return F.fq_add(a, a)


def fq2_conj(a):
    return jnp.stack([a[:, 0], F.fq_neg(a[:, 1])], axis=1)


def fq2_mul(a, b):
    return fq2_mul_many([(a, b)])[0]


def fq2_sq(a):
    return fq2_mul(a, a)


def fq2_mul_fq(a, s):
    """Multiply both components by an Fq element s of shape (16, *b)."""
    return F.fq_mul(a, s[:, None])


def fq2_mul_xi(a):
    """Multiply by XI = 9 + u: (9a0 - a1) + (a0 + 9a1)u."""
    a9 = _mul9(a)
    return jnp.stack(
        [F.fq_sub(a9[:, 0], a[:, 1]), F.fq_add(a[:, 0], a9[:, 1])], axis=1
    )


def _mul9(x):
    x2 = F.fq_add(x, x)
    x4 = F.fq_add(x2, x2)
    x8 = F.fq_add(x4, x4)
    return F.fq_add(x8, x)


def fq2_inv(a):
    n = F.fq_add(F.fq_sq(a[:, 0]), F.fq_sq(a[:, 1]))
    ninv = F.fq_inv(n)
    return jnp.stack(
        [F.fq_mul(a[:, 0], ninv), F.fq_neg(F.fq_mul(a[:, 1], ninv))], axis=1
    )


def fq2_is_zero(a):
    return jnp.all(a == 0, axis=(0, 1))


def fq2_eq(a, b):
    return jnp.all(a == b, axis=(0, 1))


def fq2_select(cond, a, b):
    return jnp.where(cond[None, None], a, b)


def fq2_zero(batch_shape):
    """batch_shape: tuple of trailing batch dims (NOT an array)."""
    return jnp.zeros((16, 2) + tuple(batch_shape), jnp.uint32)


def fq2_one(batch_shape):
    batch_shape = tuple(batch_shape)
    z = jnp.zeros((16,) + batch_shape, jnp.uint32)
    onem = jnp.broadcast_to(F._const(FQ.one_mont_np, z), z.shape)
    return jnp.stack([onem, z], axis=1)


def fq2_pow_const(a, exponent: int):
    bits = jnp.asarray([int(c) for c in bin(exponent)[2:]], dtype=jnp.uint32)

    def body(acc, bit):
        acc = fq2_sq(acc)
        acc_mul = fq2_mul(acc, a)
        return jnp.where(bit.astype(jnp.bool_), acc_mul, acc), None

    out, _ = jax.lax.scan(body, fq2_one(a.shape[2:]), bits)
    return out


def fq2_sqrt(a):
    """Square root in Fq2 (complex method for p % 4 == 3); returns (y, ok)."""
    a1 = fq2_pow_const(a, (bn.P - 3) // 4)
    alpha = fq2_mul(fq2_sq(a1), a)
    x0 = fq2_mul(a1, a)
    minus_one = fq2_pack_const((bn.P - 1, 0), a)
    is_m1 = fq2_eq(alpha, jnp.broadcast_to(minus_one, a.shape))
    y_m1 = jnp.stack([F.fq_neg(x0[:, 1]), x0[:, 0]], axis=1)  # u * x0
    b = fq2_pow_const(F.fq_add(fq2_one(a.shape[2:]), alpha), (bn.P - 1) // 2)
    y_gen = fq2_mul(b, x0)
    y = fq2_select(is_m1, y_m1, y_gen)
    ok = jnp.logical_or(fq2_eq(fq2_sq(y), a), fq2_is_zero(a))
    return y, ok


def fq2_lexicographically_largest(a_canonical):
    """gnark Fq2 ordering on canonical (non-Montgomery) limbs: decide by the
    imaginary part first, then the real part."""
    im_nonzero = jnp.logical_not(F.is_zero(a_canonical[:, 1]))
    im_big = F.geq_half(FQ, a_canonical[:, 1])
    re_big = F.geq_half(FQ, a_canonical[:, 0])
    return jnp.where(im_nonzero, im_big, re_big)


# ---------------------------------------------------------------------------
# Fq6 — (16, 6, *b); component c = 2*v_power + imag
# ---------------------------------------------------------------------------


def fq6_c(a, i):
    """i-th Fq2 coefficient of an Fq6 element."""
    return a[:, 2 * i : 2 * i + 2]


def fq6_from_fq2(c0, c1, c2):
    return jnp.concatenate([c0, c1, c2], axis=1)


def fq6_add(a, b):
    return F.fq_add(a, b)


def fq6_sub(a, b):
    return F.fq_sub(a, b)


def fq6_neg(a):
    return F.fq_neg(a)


def _fq6_mul_pairs(pairs):
    """Toom-style Fq6 products, flattened: each pair costs 6 Fq2 products,
    all issued in one fq2_mul_many call of width 6k."""
    k = len(pairs)
    mul_pairs = []
    for x, y in pairs:
        x0, x1, x2 = fq6_c(x, 0), fq6_c(x, 1), fq6_c(x, 2)
        y0, y1, y2 = fq6_c(y, 0), fq6_c(y, 1), fq6_c(y, 2)
        mul_pairs += [
            (x0, y0),
            (x1, y1),
            (x2, y2),
            (fq2_add(x1, x2), fq2_add(y1, y2)),
            (fq2_add(x0, x1), fq2_add(y0, y1)),
            (fq2_add(x0, x2), fq2_add(y0, y2)),
        ]
    prods = fq2_mul_many(mul_pairs)
    outs = []
    for i in range(k):
        t0, t1, t2, m12, m01, m02 = prods[6 * i : 6 * i + 6]
        c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(m12, fq2_add(t1, t2))))
        c1 = fq2_add(fq2_sub(m01, fq2_add(t0, t1)), fq2_mul_xi(t2))
        c2 = fq2_add(fq2_sub(m02, fq2_add(t0, t2)), t1)
        outs.append(fq6_from_fq2(c0, c1, c2))
    return outs


def fq6_mul(a, b):
    return _fq6_mul_pairs([(a, b)])[0]


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    return fq6_from_fq2(fq2_mul_xi(fq6_c(a, 2)), fq6_c(a, 0), fq6_c(a, 1))


def fq6_inv(a):
    a0, a1, a2 = fq6_c(a, 0), fq6_c(a, 1), fq6_c(a, 2)
    sqs = fq2_mul_many([(a0, a0), (a1, a1), (a2, a2), (a1, a2), (a0, a1), (a0, a2)])
    s0, s1, s2, m12, m01, m02 = sqs
    c0 = fq2_sub(s0, fq2_mul_xi(m12))
    c1 = fq2_sub(fq2_mul_xi(s2), m01)
    c2 = fq2_sub(s1, m02)
    prods = fq2_mul_many([(a2, c1), (a1, c2), (a0, c0)])
    t = fq2_add(fq2_mul_xi(fq2_add(prods[0], prods[1])), prods[2])
    tinv = fq2_inv(t)
    outs = fq2_mul_many([(c0, tinv), (c1, tinv), (c2, tinv)])
    return fq6_from_fq2(*outs)


def fq6_zero(batch_shape):
    return jnp.zeros((16, 6) + tuple(batch_shape), jnp.uint32)


def fq6_one(batch_shape):
    one2 = fq2_one(batch_shape)
    z2 = fq2_zero(batch_shape)
    return jnp.concatenate([one2, z2, z2], axis=1)


# ---------------------------------------------------------------------------
# Fq12 — (16, 12, *b) = [c0 | c1] over Fq6
# ---------------------------------------------------------------------------


def fq12_half(a, i):
    return a[:, 6 * i : 6 * i + 6]


def fq12_from_fq6(c0, c1):
    return jnp.concatenate([c0, c1], axis=1)


def fq12_mul(a, b):
    a0, a1 = fq12_half(a, 0), fq12_half(a, 1)
    b0, b1 = fq12_half(b, 0), fq12_half(b, 1)
    t0, t1, t2 = _fq6_mul_pairs(
        [(a0, b0), (a1, b1), (fq6_add(a0, a1), fq6_add(b0, b1))]
    )
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(t2, fq6_add(t0, t1))
    return fq12_from_fq6(c0, c1)


def fq12_sq(a):
    # complex squaring: t = a0*a1; s = (a0+a1)(a0+v*a1)
    a0, a1 = fq12_half(a, 0), fq12_half(a, 1)
    t, s = _fq6_mul_pairs(
        [(a0, a1), (fq6_add(a0, a1), fq6_add(a0, fq6_mul_by_v(a1)))]
    )
    c0 = fq6_sub(fq6_sub(s, t), fq6_mul_by_v(t))
    c1 = fq6_add(t, t)
    return fq12_from_fq6(c0, c1)


def fq12_conj(a):
    return fq12_from_fq6(fq12_half(a, 0), fq6_neg(fq12_half(a, 1)))


def fq12_inv(a):
    a0, a1 = fq12_half(a, 0), fq12_half(a, 1)
    s0, s1 = _fq6_mul_pairs([(a0, a0), (a1, a1)])
    t = fq6_sub(s0, fq6_mul_by_v(s1))
    tinv = fq6_inv(t)
    o0, o1 = _fq6_mul_pairs([(a0, tinv), (a1, tinv)])
    return fq12_from_fq6(o0, fq6_neg(o1))


def fq12_zero(batch_shape):
    return jnp.zeros((16, 12) + tuple(batch_shape), jnp.uint32)


def fq12_one(batch_shape):
    one2 = fq2_one(batch_shape)
    z2 = fq2_zero(batch_shape)
    return jnp.concatenate([one2] + [z2] * 5, axis=1)


def fq12_select(cond, a, b):
    return jnp.where(cond[None, None], a, b)


def fq12_eq(a, b):
    return jnp.all(a == b, axis=(0, 1))


def fq12_is_one(a):
    return fq12_eq(a, fq12_one(a.shape[2:]))


# --- Frobenius -------------------------------------------------------------

# w-basis index of each (half, v-power) Fq2 coefficient: component 2*(3h+j)?
# element = sum_i a_i w^i with a_i Fq2; tower coeff (h, j) sits at w^(2j+h).
_WB_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2), (1, 2)]  # w^0..w^5 -> (h, j)


def _frob_gamma_consts(power: int):
    return [bn.fq2_pow(bn.XI, i * (bn.P**power - 1) // 6) for i in range(6)]


def fq12_frobenius(a, power: int = 1):
    assert power in (1, 2, 3)
    gammas = _frob_gamma_consts(power)
    # gather w-basis coeffs, conj if odd power, multiply by gamma_i
    coeffs = []
    for i, (h, j) in enumerate(_WB_ORDER):
        c = a[:, 6 * h + 2 * j : 6 * h + 2 * j + 2]
        if power % 2 == 1:
            c = fq2_conj(c)
        coeffs.append(c)
    consts = [fq2_pack_const(g, a) for g in gammas]
    prods = fq2_mul_many(
        [(c, jnp.broadcast_to(k, c.shape)) for c, k in zip(coeffs, consts)]
    )
    # reassemble by component order (a concat, no scatters):
    # component slot 6h+2j holds w-basis coeff i where (h, j) = _WB_ORDER[i]
    slot_to_wb = {6 * h + 2 * j: i for i, (h, j) in enumerate(_WB_ORDER)}
    return jnp.concatenate(
        [prods[slot_to_wb[slot]] for slot in range(0, 12, 2)], axis=1
    )


# --- cyclotomic squaring ---------------------------------------------------


def fq12_cyclotomic_sq(a):
    """Granger-Scott squaring in the cyclotomic subgroup: 9 Fq2 products in
    one wide call (vs 18 for a generic multiply)."""
    z0 = fq6_c(fq12_half(a, 0), 0)
    z4 = fq6_c(fq12_half(a, 0), 1)
    z3 = fq6_c(fq12_half(a, 0), 2)
    z2 = fq6_c(fq12_half(a, 1), 0)
    z1 = fq6_c(fq12_half(a, 1), 1)
    z5 = fq6_c(fq12_half(a, 1), 2)

    pairs = []
    for x, y in ((z0, z1), (z2, z3), (z4, z5)):
        pairs += [(x, x), (y, y), (fq2_add(x, y), fq2_add(x, y))]
    prods = fq2_mul_many(pairs)

    def fp4(idx):
        t0, t1, t2 = prods[3 * idx : 3 * idx + 3]
        c0 = fq2_add(fq2_mul_xi(t1), t0)
        c1 = fq2_sub(fq2_sub(t2, t0), t1)
        return c0, c1

    a0, a1 = fp4(0)
    b0, b1 = fp4(1)
    c0, c1 = fp4(2)

    def m3(x):
        return fq2_add(fq2_add(x, x), x)

    def m2(x):
        return fq2_add(x, x)

    z0n = fq2_sub(m3(a0), m2(z0))
    z1n = fq2_add(m3(a1), m2(z1))
    z4n = fq2_sub(m3(b0), m2(z4))
    z5n = fq2_add(m3(b1), m2(z5))
    z2n = fq2_add(m3(fq2_mul_xi(c1)), m2(z2))
    z3n = fq2_sub(m3(c0), m2(z3))
    return fq12_from_fq6(
        fq6_from_fq2(z0n, z4n, z3n), fq6_from_fq2(z2n, z1n, z5n)
    )
