"""Large multi-scalar multiplication: static-shape Pippenger.

The reference delegates MSM to ``AffineG1::msm`` (call sites
verifier/src/plonk/verify.rs:284, verifier/src/plonk/kzg.rs:82,161,175 —
all small, 2..~20 points, served by ops/curve.py::msm). This module covers
the *large* regime (the BASELINE.json config: 2^16-point G1 MSM) with a
static-shape Pippenger formulated for SIMD:

  1. scalars -> W windows of C-bit digits (static shapes);
  2. per window, points are sorted by digit (argsort + gather) and bucket
     sums computed with a SEGMENTED associative scan whose combine op is the
     branch-free Jacobian add — log2(N) vectorized point-additions over all
     windows at once, no data-dependent control flow;
  3. bucket-weighted sums via the running-sum trick, scanned once over the
     2^C bucket axis with all windows in parallel lanes;
  4. Horner combine over windows (C doublings + 1 add per window).

Multi-chip: shard the point axis and all_gather+add the per-shard results
(parallel/sharded.py::sharded_msm accepts this as the local kernel).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import curve as C
from . import field as F
from .limbs import LIMB_BITS

G1 = C.G1_OPS


def _digits(scalars, c: int, w: int):
    """(N,16) canonical Fr limbs -> (W, N) int32 digit matrix."""
    # A digit is assembled from at most TWO adjacent 16-bit limbs; c <= 16
    # guarantees that (worst case off=15: 1 bit from limb k + 15 of the 16
    # available from limb k+1). Wider windows would need a third limb and
    # silently truncate — fail loudly instead (c reachable via bench --msm-c
    # and the c= kwargs on msm_best/sharded_msm).
    if not (1 <= c <= 16):
        raise ValueError(f"Pippenger window width c={c} unsupported (need 1..16)")
    outs = []
    for win in range(w):
        lo_bit = c * win
        limb = lo_bit // LIMB_BITS
        off = lo_bit % LIMB_BITS
        d = scalars[:, limb] >> np.uint32(off)
        bits_have = LIMB_BITS - off
        if bits_have < c and limb + 1 < scalars.shape[1]:
            d = d | (scalars[:, limb + 1] << np.uint32(bits_have))
        outs.append((d & np.uint32((1 << c) - 1)).astype(jnp.int32))
    return jnp.stack(outs, axis=0)


def msm_pippenger(points, scalars, c: int = 8):
    """points: (x:(N,16), y:(N,16), inf:(N,)) affine Montgomery limbs;
    scalars: (N,16) canonical Fr limbs. Returns a Jacobian point (batchless:
    coordinate arrays of shape (16,)).
    """
    x, y, inf = points
    n = x.shape[0]
    w = (256 + c - 1) // c
    nbuckets = 1 << c
    digs = _digits(scalars, c, w)  # (W, N)
    # treat digit 0 and infinity inputs as the dump bucket 0
    digs = jnp.where(inf[None, :], 0, digs)

    order = jnp.argsort(digs, axis=1)  # (W, N)
    dsort = jnp.take_along_axis(digs, order, axis=1)
    # gather points per window: (W, N, 16)
    px = x[order]
    py = y[order]

    # Jacobian arrays with limb axis LAST here (gather-friendly), moved to
    # limb-first for the field ops: ops expect (16, *batch) = (16, W, N)
    def lf(a):  # (W, N, 16) -> (16, W, N)
        return jnp.moveaxis(a, -1, 0)

    one = F.one_mont(F.FQ, lf(px))
    zero = jnp.zeros_like(one)
    is_zero_digit = dsort == 0
    pt = (
        lf(px),
        lf(py),
        jnp.where(is_zero_digit[None], zero, one),  # z=0 for dump lanes
    )

    # segment starts: first element of each run of equal digits
    prev = jnp.concatenate([jnp.full((w, 1), -1, dsort.dtype), dsort[:, :-1]], axis=1)
    seg_start = dsort != prev  # (W, N)

    def combine(l, r):
        lp, lflag = l
        rp, rflag = r
        summed = C.jacobian_add(G1, lp, rp)
        pt_out = jax.tree_util.tree_map(
            lambda s, rr: F.select(rflag, rr, s), summed, rp
        )
        return pt_out, jnp.logical_or(lflag, rflag)

    # scan over the N axis; flags carried as (1, W, N) so every leaf has the
    # same rank and the same scan axis index
    prefix, _ = jax.lax.associative_scan(combine, (pt, seg_start[None]), axis=2)

    # bucket extraction: last element of each segment holds the bucket sum
    nxt = jnp.concatenate([dsort[:, 1:], jnp.full((w, 1), -1, dsort.dtype)], axis=1)
    is_last = dsort != nxt
    slot = jnp.where(is_last, dsort, nbuckets)  # dump slot for non-lasts

    def scatter(coord):  # (16, W, N) -> (16, W, nbuckets+1)
        cc = jnp.moveaxis(coord, 0, -1)  # (W, N, 16)
        out = jnp.zeros((w, nbuckets + 1, 16), cc.dtype)
        out = out.at[jnp.arange(w)[:, None], slot].set(cc)
        return jnp.moveaxis(out, -1, 0)

    bx, by, bz = (scatter(prefix[i]) for i in range(3))
    # drop dump slot; bucket 0 unused (digit 0 contributes nothing)
    buckets = (bx[:, :, :nbuckets], by[:, :, :nbuckets], bz[:, :, :nbuckets])

    # weighted reduction: sum_j j * bucket_j via running sums, scanned from
    # the top bucket down, all windows in parallel (leaves (16, W))
    running = jax.tree_util.tree_map(lambda a: a[:, :, nbuckets - 1], buckets)
    total = running

    def body(carry, j):
        running, total = carry
        bj = tuple(
            jax.lax.dynamic_index_in_dim(b, j, axis=2, keepdims=False)
            for b in buckets
        )
        running = C.jacobian_add(G1, running, bj)
        total = C.jacobian_add(G1, total, running)
        return (running, total), None

    idxs = jnp.arange(nbuckets - 2, 0, -1)
    (_, total), _ = jax.lax.scan(body, (running, total), idxs)
    # total leaves: (16, W) — per-window weighted sums

    # Horner over windows, high to low: acc = 2^c * acc + window_w
    def horner(acc, wi):
        for _ in range(c):
            acc = C.jacobian_double(G1, acc)
        wpt = tuple(
            jax.lax.dynamic_index_in_dim(t, wi, axis=1, keepdims=False)
            for t in total
        )
        return C.jacobian_add(G1, acc, wpt), None

    top = tuple(t[:, w - 1] for t in total)
    acc, _ = jax.lax.scan(horner, top, jnp.arange(w - 2, -1, -1))
    return acc


msm_pippenger_jit = jax.jit(msm_pippenger, static_argnames=("c",))

# Dispatch threshold: below this point count the shared-doubling Straus pass
# (O(256) doublings amortized over all points, no sort/scatter) wins; above
# it Pippenger's O(N log N / c) bucket formulation takes over. The protocol
# MSMs are all <= ~20 points (plonk/verify.rs:284, kzg.rs:82,161,175); this
# threshold only engages for the large standalone MSM surface.
PIPPENGER_THRESHOLD = 64


def msm_pippenger_batched(points, scalars, c: int = 8):
    """Batched Pippenger: points (x:(N,16,B), y:(N,16,B), inf:(N,B));
    scalars (N,16,B) canonical Fr. Returns a Jacobian point with (16,B)
    coordinate leaves (same contract as ops/curve.py::msm)."""
    fn = functools.partial(msm_pippenger, c=c)
    return jax.vmap(fn, in_axes=((2, 2, 1), 2), out_axes=1)(points, scalars)


def msm_best(points, scalars, c: int = 8):
    """Size-dispatched batched MSM (windowed Straus below
    PIPPENGER_THRESHOLD, Pippenger above). Same signature/contract as
    ops/curve.py::msm."""
    if points[0].shape[0] >= PIPPENGER_THRESHOLD:
        return msm_pippenger_batched(points, scalars, c=c)
    return C.msm_windowed(C.G1_OPS, points, scalars)
