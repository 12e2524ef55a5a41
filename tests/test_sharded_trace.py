"""Trace-time checks of the sharded-MSM program (parallel/sharded.py).

The 4-card MSM runs this shard_map program with ``check_vma`` on; a scan
carry or a kernel output that does not carry the inputs' varying mesh
axes fails at trace time. Tracing needs no execution, so these run in
seconds on the CPU mesh; tests/test_multichip.py executes the program.
"""

import numpy as np
import pytest

import jax

from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.ops import field as F
from snark_bn254_verifier_tpu.ops import msm as M
from snark_bn254_verifier_tpu.parallel.sharded import make_mesh, sharded_msm_program

pytestmark = pytest.mark.smoke


def _msm_inputs(n: int, b: int = 1):
    pts = [bn.g1_mul(bn.G1_GEN, i + 1) for i in range(n)]
    x = np.stack([F.FQ.pack_scalar(p[0]) for p in pts])
    y = np.stack([F.FQ.pack_scalar(p[1]) for p in pts])
    x = np.broadcast_to(x[..., None], (n, 16, b))
    y = np.broadcast_to(y[..., None], (n, 16, b))
    inf = np.zeros((n, b), bool)
    sc = np.stack([F.FR.pack_scalar(3 * i + 7, mont=False) for i in range(n)])
    sc = np.broadcast_to(sc[..., None], (n, 16, b))
    return (x, y, inf), sc


@pytest.mark.parametrize(
    "n_points", [8, 2 * M.PIPPENGER_THRESHOLD], ids=["straus", "pippenger"]
)
def test_sharded_msm_program_traces(n_points):
    """Both local kernels (Straus below the Pippenger threshold, Pippenger
    above) trace under shard_map with check_vma on a 4-way model mesh."""
    mesh = make_mesh(4, model_parallelism=4)
    points, sc = _msm_inputs(n_points)
    traced = jax.jit(sharded_msm_program(mesh, c=8)).trace(points, sc)
    assert [tuple(o.shape) for o in traced.out_info] == [(16, 1)] * 3
