"""Optimal-ate pairing: batched Miller loops + final exponentiation.

Design:
  * The Miller loop is a ``lax.scan`` over the static 64-bit schedule of
    6x+2; the traced graph holds one doubling step, one conditional addition
    step and two sparse line multiplies.
  * Every group of independent Fq2 products inside a step is flattened into
    a single wide Montgomery multiply (see ops/tower.py) — a full Miller
    iteration issues ~6 wide multiplies instead of ~200 scalar ones, which
    keeps both the XLA graph and the op dispatch count small.
  * The loop point T stays in Jacobian coordinates; line evaluations are
    scaled by Fq2 factors (annihilated by the final exponentiation), so
    there are ZERO field inversions in the hot path.
  * ``pairing_batch`` vmaps the Miller loop over the pair axis and shares
    one final exponentiation — the semantics of bn::pairing_batch
    (reference call sites verifier/src/groth16/verify.rs:73,
    verifier/src/plonk/kzg.rs:180).
  * The final-exponentiation hard part evaluates the base-p digits of
    (p^4 - p^2 + 1)/r (derived numerically in the oracle) with a 4-base
    Straus multi-exponentiation: one cyclotomic squaring + one table gather
    per bit inside a scan.

Infinity inputs follow e(O, Q) = e(P, O) = 1 via an output mask.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..oracle import bn254 as bn
from . import field as F
from . import tower as T


# ---------------------------------------------------------------------------
# Miller-loop steps. T = (X, Y, Z) Jacobian over Fq2 (arrays (16,2,*b));
# lines are (c0, c1, c3) with l(P) = c0*yP + (c1*xP) w + c3 w^3 up to scale.
# ---------------------------------------------------------------------------


def _dbl_step(t):
    x, y, z = t
    # stage 1
    a, b, zz, yz = T.fq2_mul_many([(x, x), (y, y), (z, z), (y, z)])
    e = T.fq2_add(T.fq2_double(a), a)  # 3X^2
    xb = T.fq2_add(x, b)
    # stage 2
    c, f_, xb2, zzz, ex = T.fq2_mul_many([(b, b), (e, e), (xb, xb), (zz, z), (e, x)])
    d = T.fq2_double(T.fq2_sub(T.fq2_sub(xb2, a), c))
    x3 = T.fq2_sub(f_, T.fq2_double(d))
    z3 = T.fq2_double(yz)
    c8 = T.fq2_double(T.fq2_double(T.fq2_double(c)))
    # stage 3
    y3m, c0, c1m, c3m = T.fq2_mul_many(
        [
            (e, T.fq2_sub(d, x3)),
            (z3, zzz),
            (e, zzz),
            (z, T.fq2_sub(ex, T.fq2_double(b))),
        ]
    )
    y3 = T.fq2_sub(y3m, c8)
    return (x3, y3, z3), (c0, T.fq2_neg(c1m), c3m)


def _add_step(t, q):
    x1, y1, z1 = t
    xq, yq = q
    # stage 1
    z1z1 = T.fq2_mul_many([(z1, z1)])[0]
    # stage 2
    u2, s2p = T.fq2_mul_many([(xq, z1z1), (yq, z1z1)])
    # stage 3: s2 = yq * z1 * z1z1
    s2, = T.fq2_mul_many([(s2p, z1)])
    h = T.fq2_sub(u2, x1)
    r = T.fq2_sub(s2, y1)
    rr = T.fq2_double(r)
    # stage 4
    hh, rr2 = T.fq2_mul_many([(h, h), (rr, rr)])
    i = T.fq2_double(T.fq2_double(hh))
    # stage 5
    j, v, z3, rxq, yqz3p = T.fq2_mul_many(
        [(h, i), (x1, i), (T.fq2_double(z1), h), (rr, xq), (yq, T.fq2_double(z1))]
    )
    x3 = T.fq2_sub(T.fq2_sub(rr2, j), T.fq2_double(v))
    # stage 6
    y3a, y3b, yqz3 = T.fq2_mul_many(
        [(rr, T.fq2_sub(v, x3)), (y1, j), (yqz3p, h)]
    )
    y3 = T.fq2_sub(y3a, T.fq2_double(y3b))
    c0 = z3
    c1 = T.fq2_neg(rr)
    c3 = T.fq2_sub(rxq, yqz3)
    return (x3, y3, z3), (c0, c1, c3)


def _mul_by_line(f, line, xp, yp, skip=None):
    """f * l where l = (l00, 0, 0) + (l10, l11, 0) w in Fq6 coefficients:
    l00 = c0*yP, l10 = c1*xP, l11 = c3. 17 Fq2 products in two wide calls.

    ``skip`` (optional bool mask over the batch) turns the multiply into an
    identity for masked lanes — used by the shared-chain mixed product for
    infinity pairs (e(O, Q) = e(P, O) = 1), where the per-pair final mask of
    ``miller_loop`` is unavailable."""
    c0, c1, c3 = line
    l00, l10 = (
        T.fq2_mul_fq(c0, yp),
        T.fq2_mul_fq(c1, xp),
    )
    l11 = c3
    return _mul_by_l(f, l00, l10, l11, skip)


def _mul_by_l(f, l00, l10, l11, skip=None):
    """Core sparse multiply f * ((l00,0,0) + (l10,l11,0) w)."""
    if skip is not None:
        one = T.fq2_one(l00.shape[2:])
        zero = jnp.zeros_like(l00)
        l00 = T.fq2_select(skip, one, l00)
        l10 = T.fq2_select(skip, zero, l10)
        l11 = T.fq2_select(skip, zero, l11)
    f0, f1 = T.fq12_half(f, 0), T.fq12_half(f, 1)
    a0, a1, a2 = T.fq6_c(f1, 0), T.fq6_c(f1, 1), T.fq6_c(f1, 2)
    b0 = T.fq2_add(T.fq6_c(f0, 0), a0)
    b1 = T.fq2_add(T.fq6_c(f0, 1), a1)
    b2 = T.fq2_add(T.fq6_c(f0, 2), a2)
    s0 = T.fq2_add(l00, l10)
    prods = T.fq2_mul_many(
        [
            # t0 = f0 * (l00,0,0): 3 products
            (T.fq6_c(f0, 0), l00),
            (T.fq6_c(f0, 1), l00),
            (T.fq6_c(f0, 2), l00),
            # t1 = f1 * (l10,l11,0): 6 products
            (a0, l10),
            (a2, l11),
            (a1, l10),
            (a0, l11),
            (a2, l10),
            (a1, l11),
            # s = (f0+f1) * (l00+l10, l11, 0): 6 products
            (b0, s0),
            (b2, l11),
            (b1, s0),
            (b0, l11),
            (b2, s0),
            (b1, l11),
        ]
    )
    t0 = T.fq6_from_fq2(prods[0], prods[1], prods[2])
    t1 = T.fq6_from_fq2(
        T.fq2_add(prods[3], T.fq2_mul_xi(prods[4])),
        T.fq2_add(prods[5], prods[6]),
        T.fq2_add(prods[7], prods[8]),
    )
    s = T.fq6_from_fq2(
        T.fq2_add(prods[9], T.fq2_mul_xi(prods[10])),
        T.fq2_add(prods[11], prods[12]),
        T.fq2_add(prods[13], prods[14]),
    )
    c0_out = T.fq6_add(t0, T.fq6_mul_by_v(t1))
    c1_out = T.fq6_sub(T.fq6_sub(s, t0), t1)
    return T.fq12_from_fq6(c0_out, c1_out)


# Static Miller bit schedule: bits of 6x+2 after the leading one
_MILLER_BITS = [int(c) for c in bin(bn.ATE_LOOP_COUNT)[2:]][1:]


def _g2_frobenius_affine(q, power: int):
    """Untwist-Frobenius pi^power on an affine twist point."""
    xq, yq = q
    gx = bn.fq2_pow(bn.XI, (bn.P**power - 1) // 3)
    gy = bn.fq2_pow(bn.XI, (bn.P**power - 1) // 2)
    if power % 2 == 1:
        xq = T.fq2_conj(xq)
        yq = T.fq2_conj(yq)
    cx = jnp.broadcast_to(T.fq2_pack_const(gx, xq), xq.shape)
    cy = jnp.broadcast_to(T.fq2_pack_const(gy, yq), yq.shape)
    ox, oy = T.fq2_mul_many([(xq, cx), (yq, cy)])
    return (ox, oy)


def miller_loop(p_affine, q_affine):
    """f_{6x+2,Q}(P) with the two Frobenius correction lines.

    p_affine: (x:(16,*b), y:(16,*b), inf:(*b,)); q_affine over Fq2 arrays.
    Infinity lanes yield one.
    """
    xp, yp, p_inf = p_affine
    xq, yq, q_inf = q_affine
    q = (xq, yq)
    t0 = (xq, yq, T.fq2_one(xq.shape[2:]))
    f0 = T.fq12_one(xp.shape[1:])

    def step(f, t, take):
        f = T.fq12_sq(f)
        t, line = _dbl_step(t)
        f = _mul_by_line(f, line, xp, yp)
        t2, line2 = _add_step(t, q)
        f2 = _mul_by_line(f, line2, xp, yp)
        f = F.select(take, f2, f)
        t = jax.tree_util.tree_map(lambda a_, b_: F.select(take, b_, a_), t, t2)
        return f, t

    bits = jnp.asarray(_MILLER_BITS, dtype=jnp.uint32)

    def body(carry, bit):
        return step(*carry, bit.astype(jnp.bool_)), None

    (f, t), _ = jax.lax.scan(body, (f0, t0), bits)

    q1 = _g2_frobenius_affine(q, 1)
    q2 = _g2_frobenius_affine(q, 2)
    q2 = (q2[0], T.fq2_neg(q2[1]))
    t, line = _add_step(t, q1)
    f = _mul_by_line(f, line, xp, yp)
    t, line = _add_step(t, q2)
    f = _mul_by_line(f, line, xp, yp)

    inf = jnp.logical_or(p_inf, q_inf)
    return F.select(inf, T.fq12_one(xp.shape[1:]), f)


# ---------------------------------------------------------------------------
# Final exponentiation: easy part, then the hard part (p^4 - p^2 + 1)/r
# as a 254-step digit-Straus scan over its base-p digits.
#
# Hard-part decomposition, derived numerically from the BN parameter
# x = X_PARAM (verified in-tree: the signed base-p digits of
# (p^4 - p^2 + 1)/r are exactly these polynomials in x):
#
#   (p^4-p^2+1)/r = p^3 + (6x^2+1) p^2
#                   - (36x^3+18x^2+12x-1) p - (36x^3+30x^2+18x+2)
#
# The scan below uses the digits directly (bn.HARD_DIGITS). An x-chain
# (A = m^x, B = m^{x^2}, C = m^{x^3} by three cyclotomic exponentiations,
# then a small Straus combine over {C, B, A, m}) needs fewer multiplies;
# the reference's substrate-bn uses one (bn::final_exponentiation).

_HARD_DIGITS = bn.HARD_DIGITS
_NBITS = max(d.bit_length() for d in _HARD_DIGITS)
_STEP_IDX = np.asarray(
    [
        sum(((d >> bit) & 1) << i for i, d in enumerate(_HARD_DIGITS))
        for bit in range(_NBITS - 1, -1, -1)
    ],
    dtype=np.int32,
)


def final_exponentiation(f):
    """f^((p^12-1)/r): easy part, then a 254-step digit-Straus scan over
    the base-p digits of the hard part with a 16-entry subset-product
    table (one cyclotomic squaring + one gathered multiply per bit)."""
    f1 = T.fq12_conj(f)
    f2 = T.fq12_inv(f)
    f = T.fq12_mul(f1, f2)                       # ^(p^6 - 1)
    f = T.fq12_mul(T.fq12_frobenius(f, 2), f)    # ^(p^2 + 1)

    bases = [f] + [T.fq12_frobenius(f, i) for i in range(1, len(_HARD_DIGITS))]
    one = T.fq12_one(f.shape[2:])
    # subset-product table built with a scan (one fq12_mul in the graph):
    # entry[mask] = prod of bases[i] over set bits of mask
    ntbl = 1 << len(bases)
    table = jnp.stack([one] + bases + [one] * (ntbl - 1 - len(bases)), axis=0)
    perm = [0] + [1 << i for i in range(len(bases))]  # masks already filled
    fill = [m for m in range(1, ntbl) if m & (m - 1)]
    pos_of_mask = {m: i for i, m in enumerate(perm)}
    fills = []
    for m in fill:
        low = m & -m
        pos_of_mask[m] = len(pos_of_mask)
        fills.append((pos_of_mask[m], pos_of_mask[m ^ low], pos_of_mask[low]))
    fills_arr = jnp.asarray(fills, dtype=jnp.int32)

    def fill_body(tbl, idxs):
        dst, a_i, b_i = idxs[0], idxs[1], idxs[2]
        entry = T.fq12_mul(tbl[a_i], tbl[b_i])
        return tbl.at[dst].set(entry), None

    table, _ = jax.lax.scan(fill_body, table, fills_arr)
    mask_to_pos = np.zeros(ntbl, dtype=np.int32)
    for m, i in pos_of_mask.items():
        mask_to_pos[m] = i
    idx = jnp.asarray(mask_to_pos[_STEP_IDX])

    def body(acc, i):
        acc = T.fq12_cyclotomic_sq(acc)
        acc = T.fq12_mul(acc, table[i])
        return acc, None

    out, _ = jax.lax.scan(body, one, idx)
    return out


def _miller_product(pairs_p, pairs_q):
    """Miller loops over the pair axis, reduced to one Fq12.

    Rather than vmapping, the pair axis is folded into the broadcast batch
    of the limb tensors ((n,16,*b) -> (16,n,*b)) — every field op broadcasts
    over trailing axes anyway, and this keeps the field kernel out of vmap.
    """
    px = jnp.moveaxis(pairs_p[0], 0, 1)   # (16, n, *b)
    py = jnp.moveaxis(pairs_p[1], 0, 1)
    pinf = pairs_p[2]                      # (n, *b)
    qx = jnp.moveaxis(pairs_q[0], 0, 2)   # (16, 2, n, *b)
    qy = jnp.moveaxis(pairs_q[1], 0, 2)
    qinf = pairs_q[2]
    f = miller_loop((px, py, pinf), (qx, qy, qinf))  # (16, 12, n, *b)

    def prod_body(acc, fi):
        return T.fq12_mul(acc, fi), None

    first = f[:, :, 0]
    rest = jnp.moveaxis(f[:, :, 1:], 2, 0)  # (n-1, 16, 12, *b)
    acc, _ = jax.lax.scan(prod_body, first, rest)
    return acc


# ---------------------------------------------------------------------------
# Mixed Miller product: one shared squaring chain over at most one variable
# pair plus any number of fixed-Q pairs with precomputed line tables
# (ops/lines.py). Covers both protocols' pairing checks:
#   Groth16: 1 variable pair e(A,B) + fixed e(L,-gamma), e(C,-delta)
#   PlonK/KZG: 0 variable pairs + fixed e(F,[1]_2), e(-W,[x]_2)
# The chain shares ONE f^2 per iteration across every pair (vs one chain per
# pair in ``_miller_product``), and fixed pairs skip all G2 step arithmetic.
# ---------------------------------------------------------------------------


def _fixed_line_apply(f, c1row, c3row, xp, yp, p_inf):
    """Multiply f by the affine-normalized precomputed line (c0 == 1):
    l00 = (yP, 0), l10 = c1*xP, l11 = c3, with the (16, 2) table rows
    broadcast against the batch. Infinity lanes are identity."""
    nb = xp.ndim - 1
    c1b = c1row.reshape(c1row.shape[:2] + (1,) * nb)
    c3b = c3row.reshape(c3row.shape[:2] + (1,) * nb)
    l00 = T.fq2_from_parts(yp, jnp.zeros_like(yp))
    l10 = T.fq2_mul_fq(c1b, xp)
    l11 = jnp.broadcast_to(c3b, c3b.shape[:2] + xp.shape[1:])
    return _mul_by_l(f, l00, l10, l11, skip=p_inf)


def miller_product_mixed(var_p, var_q, fixed_ps, tables):
    """Product of Miller loops sharing one f-squaring chain.

    var_p/var_q: one variable pair ((x, y, inf) affine tuples, Fq2 arrays
    for Q) or None for a fixed-only product (PlonK/KZG). fixed_ps: tuple of
    affine G1 tuples; tables: matching tuple of ops/lines.py::G2LineTable
    field tuples (arrays (STEPS,16,2) / (2,16,2), batch independent).

    Semantics match multiplying the individual ``miller_loop`` values
    (infinity pairs contribute 1); the value may differ by an Fq2-subfield
    factor, which ``final_exponentiation`` annihilates.
    """
    nf = len(fixed_ps)
    assert nf == len(tables)
    assert nf > 0 or var_p is not None
    some_x = fixed_ps[0][0] if nf else var_p[0]
    batch = some_x.shape[1:]
    f0 = T.fq12_one(batch)

    has_var = var_p is not None
    if has_var:
        xp, yp, p_inf = var_p
        xq, yq, q_inf = var_q
        skip_v = jnp.logical_or(p_inf, q_inf)
        q = (xq, yq)
        t0 = (xq, yq, T.fq2_one(xq.shape[2:]))
    fixed_inf = [p[2] for p in fixed_ps]

    def step(f, t, take, rows):
        # rows: per-table (dbl_c1, dbl_c3, add_c1, add_c3) row arrays
        f = T.fq12_sq(f)
        if has_var:
            t, line = _dbl_step(t)
            f = _mul_by_line(f, line, xp, yp, skip=skip_v)
        for j in range(nf):
            dc1, dc3, _, _ = rows[j]
            f = _fixed_line_apply(
                f, dc1, dc3, fixed_ps[j][0], fixed_ps[j][1], fixed_inf[j]
            )
        f2 = f
        if has_var:
            t2, line2 = _add_step(t, q)
            f2 = _mul_by_line(f2, line2, xp, yp, skip=skip_v)
        else:
            t2 = t
        for j in range(nf):
            _, _, ac1, ac3 = rows[j]
            f2 = _fixed_line_apply(
                f2, ac1, ac3, fixed_ps[j][0], fixed_ps[j][1], fixed_inf[j]
            )
        f = F.select(take, f2, f)
        if has_var:
            t = jax.tree_util.tree_map(
                lambda a_, b_: F.select(take, b_, a_), t, t2
            )
        return f, t

    t_init = t0 if has_var else ()
    bits = jnp.asarray(_MILLER_BITS, dtype=jnp.uint32)
    xs = (
        bits,
        tuple(
            (
                jnp.asarray(tb.dbl_c1),
                jnp.asarray(tb.dbl_c3),
                jnp.asarray(tb.add_c1),
                jnp.asarray(tb.add_c3),
            )
            for tb in tables
        ),
    )

    def body(carry, x):
        bit, rows = x
        f, t = step(carry[0], carry[1], bit.astype(jnp.bool_), rows)
        return (f, t), None

    (f, t), _ = jax.lax.scan(body, (f0, t_init), xs)

    # Frobenius correction adds (static tail)
    if has_var:
        q1 = _g2_frobenius_affine(q, 1)
        q2 = _g2_frobenius_affine(q, 2)
        q2 = (q2[0], T.fq2_neg(q2[1]))
        t, line = _add_step(t, q1)
        f = _mul_by_line(f, line, xp, yp, skip=skip_v)
        t, line = _add_step(t, q2)
        f = _mul_by_line(f, line, xp, yp, skip=skip_v)
    for k in range(2):
        for j in range(nf):
            tc1 = jnp.asarray(tables[j].tail_c1)[k]
            tc3 = jnp.asarray(tables[j].tail_c3)[k]
            f = _fixed_line_apply(
                f, tc1, tc3, fixed_ps[j][0], fixed_ps[j][1], fixed_inf[j]
            )
    return f


def pairing(p_affine, q_affine):
    return final_exponentiation(miller_loop(p_affine, q_affine))


def pairing_batch(pairs_p, pairs_q):
    """Product of n pairings with one shared final exponentiation.

    pairs_p: (x:(n,16,*b), y:(n,16,*b), inf:(n,*b)); pairs_q analogous with
    Fq2 arrays (n,16,2,*b). The Miller loop is vmapped over the pair axis,
    so one compiled loop serves every pair.
    """
    return final_exponentiation(_miller_product(pairs_p, pairs_q))


def pairing_batch_is_one(pairs_p, pairs_q):
    return T.fq12_is_one(pairing_batch(pairs_p, pairs_q))


# ---------------------------------------------------------------------------
# Host-callable jitted compositions. Keeping the Miller loop, the pair
# product and the final exponentiation as SEPARATE jit units means the
# persistent compilation cache is shared across every entry point (tests,
# single verify, batch verifiers, bench) instead of each fused program
# paying its own multi-minute XLA compile.
# ---------------------------------------------------------------------------

miller_product_jit = jax.jit(_miller_product)
final_exponentiation_jit = jax.jit(final_exponentiation)
_miller_mixed_var_jit = jax.jit(
    lambda vp, vq, fps, tbs: miller_product_mixed(vp, vq, fps, tbs)
)
_miller_mixed_novar_jit = jax.jit(
    lambda fps, tbs: miller_product_mixed(None, None, fps, tbs)
)


def miller_mixed_hostcall(var_p, var_q, fixed_ps, tables):
    """Jitted mixed Miller product; tables may be numpy."""
    tables = tuple(
        type(tb)(*(jnp.asarray(a) for a in tb)) for tb in tables
    )
    fixed_ps = tuple(tuple(jnp.asarray(x) for x in p) for p in fixed_ps)
    if var_p is None:
        return _miller_mixed_novar_jit(fixed_ps, tables)
    return _miller_mixed_var_jit(var_p, var_q, fixed_ps, tables)


def pairing_mixed_hostcall(var_p, var_q, fixed_ps, tables):
    """final_exp(mixed Miller product) as two jitted stages."""
    return final_exponentiation_jit(
        miller_mixed_hostcall(var_p, var_q, fixed_ps, tables)
    )


def pairing_batch_hostcall(pairs_p, pairs_q):
    return final_exponentiation_jit(miller_product_jit(pairs_p, pairs_q))
