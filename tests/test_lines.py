"""Precomputed G2 line tables (ops/lines.py) + shared-chain mixed Miller
product (ops/pairing.py::miller_product_mixed), XLA tier vs the exact
oracle.

These are the building blocks of BOTH production batch pipelines
(parallel/batch.py): Groth16 verifies via one variable pair plus two
VK-fixed pairs, PlonK/KZG via two fixed pairs only. Reference behavior
being matched: bn::pairing_batch over those pairs
(verifier/src/groth16/verify.rs:73-77, verifier/src/plonk/kzg.rs:180-186).
"""

import random

import numpy as np
import pytest

from snark_bn254_verifier_tpu.models.jax_backend import (
    pack_g1,
    pack_g2,
    unpack_fq12,
)
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import lines as LN
from snark_bn254_verifier_tpu.ops import pairing as PR

pytestmark = pytest.mark.slow  # pays the mixed-scan + final-exp compile

rng = random.Random(41)

B = 8  # lanes; matches the batch verifiers' minimum bucket so the jitted
       # executables are shared with the verify-path tests via the cache


def _fixture(with_inf: bool):
    q_fixed = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(2)]
    tables = tuple(LN.g2_line_table(q) for q in q_fixed)
    fixed_lanes = [
        [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(B)]
        for _ in range(2)
    ]
    if with_inf:
        fixed_lanes[0][1] = None
    fixed_ps = tuple(pack_g1(lane) for lane in fixed_lanes)
    return q_fixed, tables, fixed_lanes, fixed_ps


def _oracle_lane(lane, q_fixed, fixed_lanes, var_pq=None):
    pairs = [
        (fixed_lanes[j][lane], q_fixed[j])
        for j in range(2)
        if fixed_lanes[j][lane] is not None
    ]
    if var_pq is not None:
        pairs.append((var_pq[0][lane], var_pq[1][lane]))
    return bn.pairing_batch(pairs)


@pytest.mark.parametrize("with_inf", [False, True])
def test_mixed_product_fixed_only_matches_oracle(with_inf):
    """PlonK/KZG shape: nf=2, no variable pair."""
    q_fixed, tables, fixed_lanes, fixed_ps = _fixture(with_inf)
    f = PR.miller_mixed_hostcall(None, None, fixed_ps, tables)
    gt = unpack_fq12(np.asarray(PR.final_exponentiation_jit(f)))
    for lane in range(B):
        assert gt[lane] == _oracle_lane(lane, q_fixed, fixed_lanes)


def test_mixed_product_with_variable_pair_matches_oracle():
    """Groth16 shape: nf=2 plus one variable (A, B) pair."""
    q_fixed, tables, fixed_lanes, fixed_ps = _fixture(False)
    vp_lanes = [bn.g1_mul(bn.G1_GEN, rng.randrange(1, bn.R)) for _ in range(B)]
    vq_lanes = [bn.g2_mul(bn.G2_GEN, rng.randrange(1, bn.R)) for _ in range(B)]
    var_p, var_q = pack_g1(vp_lanes), pack_g2(vq_lanes)
    f = PR.miller_mixed_hostcall(var_p, var_q, fixed_ps, tables)
    gt = unpack_fq12(np.asarray(PR.final_exponentiation_jit(f)))
    for lane in range(B):
        assert gt[lane] == _oracle_lane(
            lane, q_fixed, fixed_lanes, (vp_lanes, vq_lanes)
        )


def test_line_table_shapes_and_schedule():
    """Table invariants: row counts match the Miller schedule; add rows are
    zero exactly where the schedule bit is 0 (cheap, no device compile)."""
    q = bn.g2_mul(bn.G2_GEN, 12345)
    tb = LN.g2_line_table(q)
    assert tb.dbl_c1.shape == (LN.STEPS, 16, 2)
    assert tb.tail_c1.shape == (2, 16, 2)
    for i, bit in enumerate(LN.MILLER_BITS):
        is_zero = not tb.add_c1[i].any() and not tb.add_c3[i].any()
        assert is_zero == (bit == 0)
