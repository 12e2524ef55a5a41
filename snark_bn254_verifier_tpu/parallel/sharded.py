"""Multi-chip sharding: device meshes, data-parallel batches, sharded MSM.

The distributed layer the reference lacks (SURVEY.md §2 parallelism
inventory: none — single-threaded Rust):

  * ``make_mesh`` — a ("data", "model") jax.sharding.Mesh.
  * ``shard_batch`` — places the batch (trailing) axis of every limb tensor
    on the "data" axis; batched verification then scales across chips with
    zero collectives (embarrassingly parallel proofs).
  * ``sharded_msm`` — MSM with the *points* axis sharded over "model":
    each chip computes a local partial MSM (Straus or Pippenger by size,
    ops/msm.py::msm_best); the per-chip partials (3 Jacobian coordinates,
    ~1.5 KB) are gathered between devices by XLA's sharding propagation and
    tree-added (group addition is not a psum-able ring op, so gather+add
    is the collective of choice).
  * ``init_distributed`` — multi-host initialization; the same
    meshes then span all hosts' chips (tested 2-process on CPU,
    tests/test_multihost.py).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import curve as C


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Multi-host initialization: one JAX process per host, meshes
    spanning every host's devices.

    Pass all three arguments (coordinator ``host:port``, process count and
    this process's id); with none, ``jax.distributed.initialize`` relies on
    a cluster environment it can detect. Idempotent. The 2-process CPU test
    is tests/test_multihost.py. The reference has no distributed layer at
    all (SURVEY.md §2 parallelism inventory).
    """
    import jax

    # Idempotence via the public surface where available (jax >= 0.7 exposes
    # is_initialized); fall back to catching the documented "already
    # initialized" RuntimeError rather than reading jax._src internals.
    is_init = getattr(jax.distributed, "is_initialized", None)
    if is_init is not None and is_init():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallelism: int = 1,
    axis_names: Tuple[str, str] = ("data", "model"),
) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    assert n % model_parallelism == 0
    grid = np.asarray(devs).reshape(n // model_parallelism, model_parallelism)
    return Mesh(grid, axis_names)


def shard_batch(tree, mesh: Mesh, axis: str = "data"):
    """Place the trailing (batch) axis of every leaf on the data mesh axis."""

    def put(leaf):
        leaf = jnp.asarray(leaf)
        spec = P(*([None] * (leaf.ndim - 1) + [axis]))
        return jax.device_put(leaf, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    def put(leaf):
        return jax.device_put(jnp.asarray(leaf), NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(put, tree)


def sharded_msm_program(mesh: Mesh, axis: str = "model", c: int = 8):
    """Build the (unjitted) sharded-MSM program for ``mesh``.

    Split from :func:`sharded_msm` so that tests can trace the program
    (``jax.jit(prog).trace(...)``) without executing it.
    """
    from jax import shard_map

    from ..ops import msm as M

    pspec = (P(axis), P(axis), P(axis))
    sspec = P(axis)

    # check_vma stays ON: the field/curve code derives its scan-carry
    # inits from the inputs (`vz = (a+b)*0` in ops/field.py mont_mul/add/sub
    # and ops/curve.py _inf_point) so carries inherit the inputs' varying
    # mesh axes. The shard_map emits per-device partials (out_specs=P(axis) — honestly typed as varying);
    # the Jacobian reduction happens OUTSIDE the manual region, where XLA's
    # sharding propagation inserts the gather between devices.
    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec, sspec),
        out_specs=(P(axis), P(axis), P(axis)),
    )
    def run(local_points, local_scalars):
        part = M.msm_best(local_points, local_scalars, c=c)  # local Jacobian
        return jax.tree_util.tree_map(lambda a: a[None], part)  # (1, 16, B)

    def full(pts, scs):
        parts = run(pts, scs)  # leaves (ndev, 16, B), sharded over `axis`
        ndev = parts[0].shape[0]
        # pairwise (tree) reduction of the per-chip partials: O(log ndev)
        # depth in the compiled graph
        acc = [
            jax.tree_util.tree_map(lambda a, i=i: a[i], parts)
            for i in range(ndev)
        ]
        while len(acc) > 1:
            nxt = [
                C.jacobian_add(C.G1_OPS, acc[i], acc[i + 1])
                if i + 1 < len(acc)
                else acc[i]
                for i in range(0, len(acc), 2)
            ]
            acc = nxt
        return acc[0]

    return full


def sharded_msm(mesh: Mesh, points, scalars, axis: str = "model", c: int = 8):
    """MSM with the point axis sharded across ``axis``.

    points: affine stacked tuple (x:(N,16,B), y:(N,16,B), inf:(N,B));
    scalars: (N,16,B) canonical Fr. N must be divisible by the axis size.
    Returns a replicated Jacobian point (tuple of (16,B) arrays).

    The per-chip kernel is size-dispatched (ops/msm.py::msm_best): Straus
    for small local shards, Pippenger (window ``c``) above
    PIPPENGER_THRESHOLD — the BASELINE 2^16-point config runs Pippenger on
    every chip's 2^16/n_chips-point shard.
    """
    return _sharded_msm_jit(mesh, axis, c)(points, scalars)


@functools.lru_cache(maxsize=None)
def _sharded_msm_jit(mesh: Mesh, axis: str, c: int):
    # jit the whole sharded program (eager shard_map would dispatch the
    # traced body op-by-op), once per (mesh, axis, c) so that repeated
    # calls reuse the compiled executable instead of retracing
    return jax.jit(sharded_msm_program(mesh, axis=axis, c=c))
