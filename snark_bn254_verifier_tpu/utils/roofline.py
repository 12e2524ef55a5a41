"""Work accounting: Montgomery-multiply counts per verification.

Converts measured throughput into 256-bit Montgomery multiplies/sec, the
unit of work a device peak can later be divided into.

Method: the unit of work in this framework is the 16x16-bit-limb CIOS
Montgomery multiply (ops/field.py::mont_mul — 2*16*16 = 512 u32
multiply-accumulates in its two inner products). Leaf costs (one Miller
step, one Jacobian double, one fq12 multiply, ...) are COUNTED by running
the real op graph eagerly on CPU with a counting wrapper installed around
``field.mont_mul`` — each call contributes the element count of its
broadcast batch, so wide flattened tower multiplies (ops/tower.py) are
charged their true element totals. Loop multiplicities (64 Miller
iterations, 256 Straus bits, 254-bit Fermat inversions) come from the same
schedule constants the kernels themselves trace over, so the totals track
the code, not a hand-derived formula. Fermat ``pow_const`` towers are
charged analytically (2 mults/exponent-bit) because their lax.scan bodies
only execute once under eager tracing.

Costs exclude uint32 adds/subs/selects (~10x fewer ops than the MAC
chains), so a rate derived from these counts UNDERestimates the work done.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import numpy as np

MACS_PER_MONT_MUL = 2 * 16 * 16  # CIOS: a_i*b_j and m_i*n_j inner products


@contextmanager
def _counting():
    """Patch field.mont_mul with an element counter; pow_const charged
    analytically (its scan body runs once per trace, not per bit)."""
    from ..ops import field as F

    total = [0]
    orig_mul, orig_pow = F.mont_mul, F.pow_const

    def counted_mul(spec, a, b):
        import jax.numpy as jnp

        sa = jnp.shape(jnp.asarray(a))[1:]
        sb = jnp.shape(jnp.asarray(b))[1:]
        total[0] += int(np.prod(jnp.broadcast_shapes(sa, sb), dtype=np.int64))
        return orig_mul(spec, a, b)

    def counted_pow(spec, a, exponent: int):
        import jax.numpy as jnp

        total[0] += (
            2 * exponent.bit_length()
            * int(np.prod(jnp.shape(jnp.asarray(a))[1:], dtype=np.int64))
        )
        return a  # shape/dtype carrier only; value unused for counting

    F.mont_mul, F.pow_const = counted_mul, counted_pow
    try:
        yield total
    finally:
        F.mont_mul, F.pow_const = orig_mul, orig_pow


def _count(fn) -> int:
    """Count mont-mults by TRACING fn (jax.make_jaxpr — no XLA compile or
    execution; the counter fires on the python-level mont_mul calls, which
    is exactly once per multiply for the scan-free leaf ops counted here)."""
    import jax
    import jax.numpy as jnp

    def wrapper():
        fn()
        return jnp.zeros(())

    with _counting() as total:
        jax.make_jaxpr(wrapper)()
    return total[0]


def _sample_points():
    """Tiny concrete B=1 operands for the leaf ops."""
    from ..models.jax_backend import pack_g1, pack_g2
    from ..oracle import bn254 as bn
    from ..ops import field as F

    p = pack_g1([bn.g1_mul(bn.G1_GEN, 7)])
    q = pack_g2([bn.g2_mul(bn.G2_GEN, 9)])
    one = F.one_mont(F.FQ, p[0])
    return p, q, one


@functools.lru_cache(maxsize=None)
def _leaf_costs() -> dict:
    """Measured per-lane mont-mult counts of every hot leaf op (B=1)."""
    from ..ops import curve as C
    from ..ops import pairing as PR
    from ..ops import tower as T

    (px, py, pinf), (qx, qy, qinf), one = _sample_points()
    jac = (px, py, one)
    t_pt = (qx, qy, T.fq2_one(qx.shape[2:]))
    f12 = T.fq12_one(px.shape[1:])

    def miller_step():
        f = T.fq12_sq(f12)
        t, line = PR._dbl_step(t_pt)
        f = PR._mul_by_line(f, line, px, py)
        t2, line2 = PR._add_step(t, (qx, qy))
        PR._mul_by_line(f, line2, px, py)

    def miller_tail():
        q1 = PR._g2_frobenius_affine((qx, qy), 1)
        q2 = PR._g2_frobenius_affine((qx, qy), 2)
        q2 = (q2[0], T.fq2_neg(q2[1]))
        t, line = PR._add_step(t_pt, q1)
        f = PR._mul_by_line(f12, line, px, py)
        t, line = PR._add_step(t, q2)
        PR._mul_by_line(f, line, px, py)

    def fe_easy():
        f1 = T.fq12_conj(f12)
        f2 = T.fq12_inv(f12)
        f = T.fq12_mul(f1, f2)
        T.fq12_mul(T.fq12_frobenius(f, 2), f)
        for i in range(1, len(PR._HARD_DIGITS)):
            T.fq12_frobenius(f, i)  # the digit-Straus bases

    def var_dbl_line():
        t, line = PR._dbl_step(t_pt)
        PR._mul_by_line(f12, line, px, py)

    def var_add_line():
        t2, line2 = PR._add_step(t_pt, (qx, qy))
        PR._mul_by_line(f12, line2, px, py)

    def fixed_line():
        c1row = np.zeros((16, 2), np.uint32)
        PR._fixed_line_apply(f12, c1row, c1row, px, py, pinf)

    return {
        "miller_step": _count(miller_step),
        "miller_tail": _count(miller_tail),
        "var_dbl_line": _count(var_dbl_line),
        "var_add_line": _count(var_add_line),
        "fixed_line": _count(fixed_line),
        "fe_easy": _count(fe_easy),
        "fq12_mul": _count(lambda: T.fq12_mul(f12, f12)),
        "fq12_sq": _count(lambda: T.fq12_sq(f12)),
        "fq12_cyc_sq": _count(lambda: T.fq12_cyclotomic_sq(f12)),
        "frobenius": _count(lambda: T.fq12_frobenius(f12, 1)),
        "jac_double": _count(lambda: C.jacobian_double(C.G1_OPS, jac)),
        "jac_add_mixed": _count(
            lambda: C.jacobian_add_mixed(C.G1_OPS, jac, (px, py, pinf))
        ),
        "jac_add_full": _count(lambda: C.jacobian_add(C.G1_OPS, jac, jac)),
        "to_affine": _count(lambda: C.to_affine(C.G1_OPS, jac)),
    }


@functools.lru_cache(maxsize=None)
def miller_loop_mults() -> int:
    """One Miller loop: the 64-step 6x+2 schedule + Frobenius tail.
    Every step executes BOTH the doubling and the (selected) addition
    branch — branch-free SIMD, so the cost is schedule-independent."""
    from ..ops import pairing as PR

    c = _leaf_costs()
    n_steps = len(PR._MILLER_BITS)
    return n_steps * c["miller_step"] + c["miller_tail"]


@functools.lru_cache(maxsize=None)
def final_exp_mults() -> int:
    """Digit-Straus final exponentiation (ops/pairing.py::
    final_exponentiation): easy part, the subset-product table (one fq12
    multiply per entry that is not a single base), then one cyclotomic
    squaring + one fq12 multiply per digit bit. Composed from measured leaf
    costs and the schedule constants the scans trace over."""
    from ..ops import pairing as PR

    c = _leaf_costs()
    n_bases = len(PR._HARD_DIGITS)
    table = ((1 << n_bases) - 1 - n_bases) * c["fq12_mul"]
    digits = len(PR._STEP_IDX) * (c["fq12_cyc_sq"] + c["fq12_mul"])
    return c["fe_easy"] + table + digits


def pairing_product_mults(n_pairs: int) -> int:
    """n-pair Miller product with one shared final exponentiation."""
    c = _leaf_costs()
    return (
        n_pairs * miller_loop_mults()
        + (n_pairs - 1) * c["fq12_mul"]
        + final_exp_mults()
    )


def mixed_product_mults(nf: int, has_var: bool) -> int:
    """Shared-chain mixed Miller product + final exp — the pairing the
    production batch pipelines run (ops/pairing.py::miller_product_mixed):
    one f^2 per iteration for the WHOLE product, per-iteration sparse line
    applies for the nf fixed-table pairs (dbl + selected add, both branches
    execute — branch-free SIMD), full G2 step arithmetic only for the
    optional variable pair, plus the 2-line Frobenius tails."""
    from ..ops import pairing as PR

    c = _leaf_costs()
    n_steps = len(PR._MILLER_BITS)
    per_step = c["fq12_sq"] + 2 * nf * c["fixed_line"]
    if has_var:
        per_step += c["var_dbl_line"] + c["var_add_line"]
    tails = 2 * nf * c["fixed_line"] + (c["miller_tail"] if has_var else 0)
    return n_steps * per_step + tails + final_exp_mults()


def straus_msm_mults(n_points: int) -> int:
    """Bit-serial shared-doubling Straus (ops/curve.py::msm): 256 bits x
    (1 double + n conditional mixed adds, both branches). Kept for
    comparison; the pipelines now run the windowed variant below."""
    c = _leaf_costs()
    return 256 * (c["jac_double"] + n_points * c["jac_add_mixed"])


def windowed_msm_mults(n_points: int, w: int = 4) -> int:
    """Windowed Straus (ops/curve.py::msm_windowed): per-point table of
    2^w - 2 sequential mixed adds, 256 shared doublings, one FULL Jacobian
    add per point per window."""
    c = _leaf_costs()
    nent = 1 << w
    table = n_points * (nent - 2) * c["jac_add_mixed"]
    nwin = 256 // w
    return table + 256 * c["jac_double"] + nwin * n_points * c["jac_add_full"]


def groth16_mults_per_proof(n_inputs: int = 2) -> int:
    """Device mults for one proof lane of the batched Groth16 pipeline
    (parallel/batch.py::_groth16_pipeline: the n_inputs-point windowed MSM,
    one mixed add of k0, to affine, then the 3-pair mixed product)."""
    c = _leaf_costs()
    return (
        windowed_msm_mults(n_inputs)
        + c["jac_add_mixed"]
        + c["to_affine"]
        + mixed_product_mults(nf=2, has_var=True)
    )


def plonk_mults_per_proof(n_qcp: int = 0) -> int:
    """Device mults for one PlonK lane: phase A linearization MSM
    (10 + n_qcp points), phase B combo MSM (10 + n_qcp + 4) + 2-point
    quotient MSM, then the 2-pair KZG product (parallel/batch.py)."""
    c = _leaf_costs()
    n_lin = 10 + n_qcp
    n_combo = n_lin + 4
    return (
        windowed_msm_mults(n_lin)
        + windowed_msm_mults(n_combo)
        + windowed_msm_mults(2)
        + 3 * c["to_affine"]
        + mixed_product_mults(nf=2, has_var=False)
    )


def roofline_fields(proofs_per_sec_per_chip: float, mults_per_proof: int) -> dict:
    """Bench-line fields: counted work per proof and the measured mult
    rate. No device peak is applied here."""
    mults_per_sec = proofs_per_sec_per_chip * mults_per_proof
    return {
        "mults_per_proof": int(mults_per_proof),
        "mont_mults_per_sec": round(mults_per_sec, 1),
    }
