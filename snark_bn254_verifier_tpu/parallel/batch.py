"""Batched proof verification: the high-throughput device pipeline.

Whole batches of proofs are verified in one (or, for PlonK, two) jitted
device programs, with the batch riding the trailing axis of every limb
tensor. Host work is restricted to byte parsing and
Fiat-Shamir/Fr scalar algebra — O(KB) per proof.

Per-lane error isolation (SURVEY.md §5 "failure detection"): a proof that
fails parsing, transcript checks, or the linearization-constant early check
contributes a masked lane — the batch result marks it False rather than
raising, unlike the reference's panics (verifier/src/lib.rs:45-46).

Groth16 pipeline (one device program):
    msm(k[1:], inputs) (+k[0]) -> 3-pair pairing_batch vs cached e(alpha,beta)

PlonK pipeline (two device programs with a host transcript step between —
the KZG fold challenge binds the device-computed linearization digest,
plonk/verify.rs:284 -> kzg.rs:46):
    phase A: 17ish-point MSM -> linearization digest (to host bytes)
    phase B: single fused 11-point MSM + 2-point quotient MSM
             -> 2-pair pairing_batch is_one
"""

from __future__ import annotations

import functools
import secrets
import time
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import kzg as kzg_mod
from ..models import plonk as plonk_mod
from ..models.jax_backend import (
    pack_fq,
    pack_fr_canonical,
    pack_g1,
    pack_g2,
    unpack_fq12,
    unpack_g1_jacobian,
)
from ..oracle import bn254 as bn
from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import pairing as PR
from ..ops import tower as T
from ..utils import errors
from ..utils import serialization as ser
from ..utils.profiling import RunStats
from ..utils.hash_to_field import WrappedHashToField
from ..utils.transcript import ALPHA, BETA, GAMMA, ZETA, Transcript

R = bn.R


def _bucket_size(b: int) -> int:
    """Snap a batch size to the next power of two (min 8).

    Every distinct trailing batch dim compiles its own executables, and the
    pairing pipeline costs minutes of XLA compile per shape; bucketing
    collapses all small-batch callers (tests, singles, odd batches) onto a
    handful of shared shapes. Padded lanes are zeros: zero points are
    infinity lanes (pairing contributes 1, MSM contributes identity) and
    the `valid` mask for them is False; callers slice results back to b."""
    r = 8
    while r < b:
        r *= 2
    return r


def _pad_trailing(tree, b_to: int):
    """Zero-pad the trailing axis of every array leaf to b_to."""

    def pad(a):
        if a.shape[-1] == b_to:
            return a
        widths = [(0, 0)] * (a.ndim - 1) + [(0, b_to - a.shape[-1])]
        xp = np if isinstance(a, (np.ndarray, np.generic)) else jnp
        return xp.pad(a, widths)

    return jax.tree_util.tree_map(pad, tree)


def _bcast_pt_g1(pt, b: int):
    """Single oracle G1 point -> affine tuple broadcast to batch b (numpy —
    transfers happen at jit boundaries only)."""
    x, y, inf = pack_g1([pt])
    return (
        np.broadcast_to(x, (16, b)),
        np.broadcast_to(y, (16, b)),
        np.broadcast_to(inf, (b,)),
    )


def _bcast_pt_g2(pt, b: int):
    x, y, inf = pack_g2([pt])
    return (
        np.broadcast_to(x, (16, 2, b)),
        np.broadcast_to(y, (16, 2, b)),
        np.broadcast_to(inf, (b,)),
    )


def _stack_affine_g1(points: Sequence[Tuple]):
    """List of per-lane affine tuples -> point-major stacked tuple.
    Uses jnp under tracing (inside jit) and numpy on host values."""
    import jax.core

    host = all(
        isinstance(x, (np.ndarray, np.generic)) for p in points for x in p
    )
    xp = np if host else jnp
    return tuple(xp.stack([p[i] for p in points], axis=0) for i in range(3))


# ---------------------------------------------------------------------------
# Groth16
# ---------------------------------------------------------------------------


def _groth16_kernel(
    n_inputs: int,
    k_points,      # ((n+1), 16, B) stacked affine tuple (broadcast VK)
    scalars,       # (n, 16, B) canonical Fr
    ar, bs, krs,   # proof point tuples
    line_tables,   # (gamma, -delta) ops/lines.py tables (VK-fixed G2)
    alpha_beta,    # (16, 12, B) target Gt
    valid,         # (B,) bool
):
    """Full batched Groth16 device step (jittable as one program).

    The pairing check runs as ONE shared-chain mixed Miller product: the
    variable pair e(A, B) plus the two VK-fixed-Q pairs e(L, gamma) and
    e(C, -delta) via precomputed line tables (ops/lines.py) — no G2 step
    arithmetic for the fixed pairs, one f^2 chain for all three."""
    prepared = _g16_prepare(n_inputs, k_points, scalars)
    f = PR.miller_product_mixed(ar, bs, (prepared, krs), tuple(line_tables))
    gt = PR.final_exponentiation(f)
    ok = T.fq12_eq(gt, alpha_beta)
    return jnp.logical_and(ok, valid)


def _g16_prepare(n_inputs: int, k_points, scalars):
    k0 = jax.tree_util.tree_map(lambda a: a[0], k_points)
    if n_inputs > 0:
        krest = jax.tree_util.tree_map(lambda a: a[1:], k_points)
        acc = C.msm_windowed(C.G1_OPS, krest, scalars)
        acc = C.jacobian_add_mixed(C.G1_OPS, acc, k0)
    else:
        acc = C.to_jacobian(C.G1_OPS, k0)
    return C.to_affine(C.G1_OPS, acc)


_g16_prepare_jit = jax.jit(_g16_prepare, static_argnames=("n_inputs",))


@jax.jit
def _gt_eq_masked(gt, target, valid):
    return jnp.logical_and(T.fq12_eq(gt, target), valid)


@jax.jit
def _g2_on_curve_jit(affine_g2):
    return C.is_on_curve_affine(C.G2_OPS, affine_g2)


@functools.partial(jax.jit, static_argnames=("c",))
def _pippenger_affine_b(points, scalars, c=8):
    out = M.msm_pippenger_batched(points, scalars, c=c)
    return C.to_affine(C.G1_OPS, out)


def _msm_affine(points, scalars):
    """Batched MSM -> affine. Size-dispatched: Pippenger buckets above
    ops/msm.py::PIPPENGER_THRESHOLD, else the jitted windowed scan. Batch
    bucketed (see _bucket_size)."""
    b = points[0].shape[-1]
    bt = _bucket_size(b)
    if bt != b:
        points = _pad_trailing(points, bt)
        scalars = _pad_trailing(jnp.asarray(scalars), bt)
    if points[0].shape[0] >= M.PIPPENGER_THRESHOLD:
        out = _pippenger_affine_b(points, jnp.asarray(scalars))
    else:
        out = _msm_kernel_b(points[0].shape[0], points, scalars)
    if bt != b:
        out = jax.tree_util.tree_map(lambda a: a[..., :b], out)
    return out


def _groth16_pipeline(n_inputs, k_points, scalars, ar, bs, krs, line_tables,
                      alpha_beta, valid):
    """Same computation as _groth16_kernel but composed from separately
    jitted stages so the persistent compile cache is shared across batch
    sizes and entry points."""
    prepared = _g16_prepare_jit(n_inputs, k_points, scalars)
    # prepared stays DEVICE-resident into the pairing stage (a host sync
    # here costs a device->host->device round trip per batch and strips
    # mesh placement)
    gt = PR.pairing_mixed_hostcall(ar, bs, (prepared, krs), tuple(line_tables))
    return _gt_eq_masked(gt, alpha_beta, valid)


class Groth16BatchVerifier:
    """VK-specialized batched Groth16 verifier with cached e(alpha, beta).

    Realizes the reference's dead PreparedVerifyingKey (groth16/verify.rs:45)
    and replaces its per-call pairing(alpha, beta) recomputation
    (groth16/verify.rs:70) with a one-time device pairing.

    With a ``mesh`` (parallel/sharded.py::make_mesh), every per-lane array
    is placed with its batch axis on the mesh's "data" axis, so one batch
    spreads over the devices with no collectives; the batch size must be a
    multiple of that axis.
    """

    def __init__(self, vk_bytes: bytes, mesh=None):
        self.vk = ser.load_groth16_verifying_key_from_bytes(vk_bytes)
        self.mesh = mesh
        self.n_inputs = len(self.vk.k) - 1
        self._alpha_beta_single = None  # (16,12,1) device Gt, computed lazily
        self._tables = None  # (gamma, -delta) Miller line tables, lazy
        self.last_stats: Optional[RunStats] = None  # set by verify_batch

    def _line_tables(self):
        """Precomputed Miller line tables for the VK-fixed G2 points gamma
        and -delta (ops/lines.py) — computed once per VK on the host."""
        if self._tables is None:
            from ..ops import lines as LN

            self._tables = (
                LN.g2_line_table(self.vk.gamma_g2),
                LN.g2_line_table(bn.g2_neg(self.vk.delta_g2)),
            )
        return self._tables

    def _alpha_beta(self):
        """e(alpha, beta) — computed ONCE per VK on host (the oracle pairing
        is exact and takes ~80ms; device values are bit-identical, so the
        packed constant is directly comparable with device Gt outputs)."""
        if self._alpha_beta_single is None:
            ab = bn.pairing(self.vk.alpha_g1, self.vk.beta_g2)
            comps = []
            for h in range(2):
                for j in range(3):
                    comps.append(F.FQ.pack_scalar(ab[h][j][0]))
                    comps.append(F.FQ.pack_scalar(ab[h][j][1]))
            self._alpha_beta_single = np.stack(comps, axis=1)[:, :, None]
        return self._alpha_beta_single

    def verify_batch(
        self,
        proofs: Sequence[bytes],
        public_inputs: Sequence[Sequence[int]],
    ) -> np.ndarray:
        t_start = time.perf_counter()
        ok = np.asarray(self.verify_batch_async(proofs, public_inputs))
        self.last_stats = RunStats(
            protocol="groth16",
            batch_size=len(proofs),
            n_chips=max(1, len(jax.devices())),
            elapsed_s=time.perf_counter() - t_start,
            n_valid=int(ok.sum()),
            pairings_per_proof=3,  # 3-pair batch vs cached e(alpha,beta)
        )
        return ok

    def verify_batch_async(
        self,
        proofs: Sequence[bytes],
        public_inputs: Sequence[Sequence[int]],
    ):
        """Dispatch one batch WITHOUT syncing: returns the device bool
        array. JAX dispatch is asynchronous, so the caller can prepare and
        dispatch the next batch while this one executes — pipelined
        throughput hides the device time and the device->host fetch behind
        host parsing of the next batch. ``verify_batch`` is this plus a
        sync."""
        b = len(proofs)
        assert len(public_inputs) == b
        parsed = self._parse_proofs(proofs)
        native = parsed is not None
        if native:
            ar, bs, krs, valid = parsed
        else:
            ar, bs, krs, valid = self._parse_proofs_python(proofs)
        scalars = []
        for i, ins in enumerate(public_inputs):
            if len(ins) != self.n_inputs:
                valid[i] = False
                scalars.append([0] * self.n_inputs)
            else:
                scalars.append([s % R for s in ins])
        # k points: (n+1, 16, B) broadcast
        k_stack = _stack_affine_g1([_bcast_pt_g1(pt, b) for pt in self.vk.k])
        if self.n_inputs > 0:
            sc = np.stack(
                [pack_fr_canonical([row[j] for row in scalars]) for j in range(self.n_inputs)],
                axis=0,
            )
        else:
            sc = np.zeros((0, 16, b), np.uint32)
        ab = np.broadcast_to(self._alpha_beta(), (16, 12, b))
        lanes = (k_stack, sc, ar, bs, krs, ab, valid)
        if self.mesh is not None:
            from .sharded import shard_batch

            lanes = shard_batch(lanes, self.mesh)
        k_stack, sc, ar, bs, krs, ab, valid_dev = lanes
        if native:
            # the native parse leaves the G2 on-curve check to the device;
            # its mask is ANDed here instead of synced to host in the parse
            # stage — one fewer device->host round trip per batch
            valid_dev = jnp.logical_and(valid_dev, _g2_on_curve_jit(bs))
        return _groth16_pipeline(
            self.n_inputs, k_stack, sc, ar, bs, krs, self._line_tables(),
            ab, valid_dev,
        )

    def _parse_proofs(self, proofs: Sequence[bytes]):
        """Native batch parse (C++ data-plane); None if unavailable or the
        proofs have heterogeneous lengths. The G2 on-curve check is left to
        the device (see verify_batch_async)."""
        from ..utils import native

        if not native.native_available() or not proofs:
            return None
        stride = len(proofs[0])
        if stride < 256 or any(len(p) != stride for p in proofs):
            return None
        b = len(proofs)
        outs = native.parse_groth16_batch(b"".join(proofs), stride, b)
        valid = np.array(outs["valid"], dtype=bool)
        zeros = np.zeros(b, dtype=bool)
        ar = (outs["ar_x"], outs["ar_y"], zeros)
        krs = (outs["krs_x"], outs["krs_y"], zeros)
        bs_x = np.stack([outs["bs_x0"], outs["bs_x1"]], 1)
        bs_y = np.stack([outs["bs_y0"], outs["bs_y1"]], 1)
        bs = (bs_x, bs_y, zeros)
        return ar, bs, krs, valid

    def _parse_proofs_python(self, proofs: Sequence[bytes]):
        b = len(proofs)
        valid = np.ones(b, dtype=bool)
        ars, bss, krss = [], [], []
        for i, pb in enumerate(proofs):
            try:
                proof = ser.load_groth16_proof_from_bytes(pb)
                ars.append(proof.ar)
                bss.append(proof.bs)
                krss.append(proof.krs)
            except (errors.VerifierError, IndexError, ValueError):
                valid[i] = False
                ars.append(bn.G1_GEN)
                bss.append(bn.G2_GEN)
                krss.append(bn.G1_GEN)
        return pack_g1(ars), pack_g2(bss), pack_g1(krss), valid


# ---------------------------------------------------------------------------
# PlonK
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_points",))
def _msm_kernel_b(n_points: int, points, scalars):
    """Batched MSM -> affine result. points: (n,16,B)-stacked tuple."""
    del n_points
    out = C.msm_windowed(C.G1_OPS, points, scalars)
    return C.to_affine(C.G1_OPS, out)


@jax.jit
def _negate_affine_y(aff):
    return (aff[0], F.fq_neg(aff[1]), aff[2])


@jax.jit
def _is_one_masked(gt, valid):
    return jnp.logical_and(T.fq12_is_one(gt), valid)


def _plonk_final_kernel(combo_points, combo_scalars, quot_points, quot_scalars,
                        line_tables, valid):
    """Fused KZG batch check: e(combo, G2) * e(-(quot), [tau]G2) == 1,
    composed from cached jit stages. BOTH G2 points are VK-fixed
    (kzg.rs:180-186), so the pairing runs as a fixed-only shared-chain
    Miller product over precomputed line tables — zero G2 arithmetic."""
    combo = _msm_affine(combo_points, combo_scalars)
    quot = _msm_affine(quot_points, quot_scalars)
    neg_quot = _negate_affine_y(quot)
    # combo/neg_quot stay device-resident into the pairing stage (no host
    # sync between MSM and pairing)
    gt = PR.pairing_mixed_hostcall(
        None, None, (combo, neg_quot), tuple(line_tables)
    )
    return _is_one_masked(gt, valid)


def _batch_inv_mod_r(values: Sequence[int]) -> List[Optional[int]]:
    """Montgomery-trick batch inversion mod R with ONE modexp total.

    Zero entries yield None (the caller marks that lane invalid) without
    poisoning the rest of the batch. This is the host-side analogue of the
    reference's batch_invert (plonk/verify.rs:364-396), amortized across
    every lane of the batch rather than per proof.
    """
    n = len(values)
    safe = [v % R if v % R != 0 else 1 for v in values]
    prefix = [1] * (n + 1)
    for i, v in enumerate(safe):
        prefix[i + 1] = prefix[i] * v % R
    inv_all = pow(prefix[n], R - 2, R)
    out: List[Optional[int]] = [None] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_all % R if values[i] % R != 0 else None
        inv_all = inv_all * safe[i] % R
    return out


class PlonkBatchVerifier:
    """VK-specialized batched PlonK verifier (full gnark semantics incl.
    BSB22; per-lane failure isolation)."""

    def __init__(self, vk_bytes: bytes):
        self.vk = ser.load_plonk_verifying_key_from_bytes(vk_bytes)
        vk = self.vk
        # VK-constant powers of the domain generator, hoisted out of the
        # per-lane loop: w^i for the public-input Lagrange evaluations
        # (plonk/verify.rs:116-137) and w^(nb_public+cci) for BSB22
        # (plonk/verify.rs:147-152).
        self._w_pows = [1]
        for _ in range(max(vk.nb_public_variables, 1) - 1):
            self._w_pows.append(self._w_pows[-1] * vk.generator % R)
        self._cci_wpow = [
            pow(vk.generator, vk.nb_public_variables + cci, R)
            for cci in vk.commitment_constraint_indexes
        ]
        self._tables = None  # KZG ([1]_2, [x]_2) Miller line tables, lazy
        self.last_stats: Optional[RunStats] = None  # set by verify_batch
        self._last_host_s = 0.0

    def _kzg_tables(self):
        """Precomputed Miller line tables for the KZG SRS G2 points
        ([1]_2, [x]_2) — both VK-fixed (kzg.rs:180-186), once per VK."""
        if self._tables is None:
            from ..ops import lines as LN

            self._tables = (
                LN.g2_line_table(self.vk.kzg.g2[0]),
                LN.g2_line_table(self.vk.kzg.g2[1]),
            )
        return self._tables

    def verify_batch(
        self,
        proofs: Sequence[bytes],
        public_inputs: Sequence[Sequence[int]],
        rng=None,
    ) -> np.ndarray:
        t_start = time.perf_counter()
        ok = np.asarray(self.verify_batch_async(proofs, public_inputs, rng))
        self.last_stats = self._stats(
            len(proofs), int(ok.sum()), time.perf_counter() - t_start,
            self._last_host_s,
        )
        return ok

    def verify_batch_async(
        self,
        proofs: Sequence[bytes],
        public_inputs: Sequence[Sequence[int]],
        rng=None,
    ):
        """Dispatch one batch; returns the device bool array without the
        final sync (see Groth16BatchVerifier.verify_batch_async — same
        pipelining contract; PlonK still pays its internal phase-A host
        sync for the KZG fold challenge)."""
        vk = self.vk
        b = len(proofs)
        t_start = time.perf_counter()
        host_s = 0.0
        valid = np.ones(b, dtype=bool)
        parsed: List[Optional[ser.PlonkProof]] = []
        for i, pb in enumerate(proofs):
            try:
                proof = ser.load_plonk_proof_from_bytes(pb)
                if len(proof.bsb22_commitments) != len(vk.qcp):
                    raise errors.Bsb22CommitmentMismatchError()
                if len(public_inputs[i]) != vk.nb_public_variables:
                    raise errors.InvalidWitnessError()
                if len(proof.batched_proof.claimed_values) < 6 + len(vk.qcp):
                    raise errors.InvalidWitnessError()
                parsed.append(proof)
            except Exception:
                valid[i] = False
                parsed.append(None)

        # host: challenges + scalar algebra (reference logic,
        # plonk/verify.rs:62-279), vectorized across lanes: pass 1 derives
        # the Fiat-Shamir challenges and collects every denominator, ONE
        # Montgomery-trick batch inversion serves the whole batch, pass 2
        # finishes the Fr algebra with multiplications only.
        chs: List[Optional[dict]] = []
        denoms: List[int] = []
        for i, proof in enumerate(parsed):
            if proof is None:
                chs.append(None)
                continue
            try:
                ch = self._lane_challenges(proof, public_inputs[i])
            except errors.VerifierError:
                valid[i] = False
                chs.append(None)
                continue
            chs.append(ch)
            denoms.extend(ch["denoms"])
        invs = _batch_inv_mod_r(denoms)
        lanes = []
        pos = 0
        for i, ch in enumerate(chs):
            if ch is None:
                lanes.append(None)
                continue
            k = len(ch["denoms"])
            lane_invs = invs[pos : pos + k]
            pos += k
            if any(v is None for v in lane_invs):
                valid[i] = False  # zeta hit a domain point (InverseNotFound)
                lanes.append(None)
                continue
            try:
                lanes.append(
                    self._lane_finish(parsed[i], public_inputs[i], ch, lane_invs)
                )
            except errors.VerifierError:
                valid[i] = False
                lanes.append(None)

        host_s += time.perf_counter() - t_start
        template = next((l for l in lanes if l is not None), None)
        if template is None:
            self._last_host_s = host_s
            return np.zeros(b, dtype=bool)

        # phase A: linearization digest MSM on device
        n_lin = len(template["lin_points"])
        lin_pts = _stack_affine_g1(
            [
                pack_g1([(l["lin_points"][j] if l else bn.G1_GEN) for l in lanes])
                for j in range(n_lin)
            ]
        )
        lin_sc = np.stack(
            [
                pack_fr_canonical([(l["lin_scalars"][j] if l else 0) for l in lanes])
                for j in range(n_lin)
            ],
            axis=0,
        )
        lin_aff = _msm_affine(lin_pts, lin_sc)
        lin_points_host = _unpack_affine(lin_aff)

        # host: fold gamma (binds the digest bytes), randomizers
        t_host2 = time.perf_counter()
        rand_fr = rng if rng is not None else (lambda: secrets.randbelow(R - 1) + 1)
        combo_cols, quot_cols = [], []
        n_combo, n_quot = None, None
        for i, l in enumerate(lanes):
            if l is None:
                combo_cols.append(None)
                quot_cols.append(None)
                continue
            proof = parsed[i]
            lin_digest = lin_points_host[i]
            digests = [lin_digest, proof.lro[0], proof.lro[1], proof.lro[2],
                       vk.s[0], vk.s[1]] + list(vk.qcp)
            cv = proof.batched_proof.claimed_values
            gamma_fold = kzg_mod.derive_gamma(
                l["zeta"], digests, cv, ser.fr_to_bytes_be(proof.z_shifted_opening.claimed_value)
            )
            gpow = [1]
            for _ in range(len(digests) - 1):
                gpow.append(gpow[-1] * gamma_fold % R)
            folded_eval = sum(v * c for v, c in zip(cv, gpow)) % R
            r_rand = rand_fr()
            zeta = l["zeta"]
            shifted = zeta * vk.generator % R
            zu = proof.z_shifted_opening.claimed_value
            fe_total = (folded_eval + r_rand * zu) % R
            # combo = sum gpow_i * digests_i + r*z - fe_total*g1
            #         + zeta*H_b + r*shifted*H_s
            combo_points = digests + [proof.z, vk.kzg.g1,
                                      proof.batched_proof.h, proof.z_shifted_opening.h]
            combo_scalars = gpow + [r_rand, (-fe_total) % R, zeta,
                                    r_rand * shifted % R]
            quot_points = [proof.batched_proof.h, proof.z_shifted_opening.h]
            quot_scalars = [1, r_rand]
            combo_cols.append((combo_points, combo_scalars))
            quot_cols.append((quot_points, quot_scalars))
            n_combo = len(combo_points)
            n_quot = 2

        def col(j, cols, dummy_pt):
            return pack_g1([(c[0][j] if c else dummy_pt) for c in cols])

        def scal(j, cols):
            return pack_fr_canonical([(c[1][j] if c else 0) for c in cols])

        combo_pts = _stack_affine_g1([col(j, combo_cols, bn.G1_GEN) for j in range(n_combo)])
        combo_sc = np.stack([scal(j, combo_cols) for j in range(n_combo)], axis=0)
        quot_pts = _stack_affine_g1([col(j, quot_cols, bn.G1_GEN) for j in range(n_quot)])
        quot_sc = np.stack([scal(j, quot_cols) for j in range(n_quot)], axis=0)
        host_s += time.perf_counter() - t_host2
        self._last_host_s = host_s
        return _plonk_final_kernel(
            combo_pts, combo_sc, quot_pts, quot_sc, self._kzg_tables(), valid
        )

    def _stats(self, b: int, n_valid: int, elapsed: float, host_s: float) -> RunStats:
        return RunStats(
            protocol="plonk",
            batch_size=b,
            n_chips=max(1, len(jax.devices())),
            elapsed_s=elapsed,
            n_valid=n_valid,
            pairings_per_proof=2,  # KZG 2-pair batch check (kzg.rs:180-186)
            extra={"host_s": host_s},
        )

    # -- host scalar work (reference plonk/verify.rs:62-279 semantics) ------

    def _lane_challenges(self, proof: ser.PlonkProof, inputs: Sequence[int]):
        """Pass 1: Fiat-Shamir challenges + every denominator this lane
        needs inverted (batch-inverted across lanes by the caller)."""
        vk = self.vk
        fs = Transcript([GAMMA, BETA, ALPHA, ZETA])
        plonk_mod.bind_public_data(fs, GAMMA, vk, inputs)
        gamma = plonk_mod.derive_randomness(fs, GAMMA, list(proof.lro))
        beta = plonk_mod.derive_randomness(fs, BETA)
        alpha = plonk_mod.derive_randomness(
            fs, ALPHA, list(proof.bsb22_commitments) + [proof.z]
        )
        zeta = plonk_mod.derive_randomness(fs, ZETA, list(proof.h))

        # zeta^n: vk.size is the domain size (a power of two), so this is
        # ~log2(n) squarings — cheap next to a 254-bit inversion exponent.
        zeta_n = pow(zeta, vk.size, R)
        denoms = [(zeta - 1) % R]
        denoms.extend((zeta - w) % R for w in self._w_pows[: len(inputs)])
        denoms.extend((zeta - w) % R for w in self._cci_wpow)
        return {
            "gamma": gamma,
            "beta": beta,
            "alpha": alpha,
            "zeta": zeta,
            "zeta_n": zeta_n,
            "denoms": denoms,
        }

    def _lane_finish(
        self,
        proof: ser.PlonkProof,
        inputs: Sequence[int],
        ch: dict,
        invs: Sequence[int],
    ):
        """Pass 2: the remaining Fr algebra, multiplications only."""
        vk = self.vk
        gamma, beta, alpha, zeta = ch["gamma"], ch["beta"], ch["alpha"], ch["zeta"]
        zeta_n = ch["zeta_n"]
        zh_zeta = (zeta_n - 1) % R
        lagrange_one = invs[0] * zh_zeta % R * vk.size_inv % R

        pi = 0
        for j, w in enumerate(inputs):
            li = zh_zeta * invs[1 + j] % R * vk.size_inv % R * self._w_pows[j] % R
            pi = (pi + li * (w % R)) % R
        htf = WrappedHashToField(plonk_mod.BSB22_DST)
        base = 1 + len(inputs)
        for i, w_pow_i in enumerate(self._cci_wpow):
            htf.write(ser.g1_to_bytes(proof.bsb22_commitments[i]))
            hashed = int.from_bytes(htf.sum(), "big") % R
            htf.reset()
            lagrange = zh_zeta * w_pow_i % R * invs[base + i] % R * vk.size_inv % R
            pi = (pi + lagrange * hashed) % R

        cv = proof.batched_proof.claimed_values
        l, r_, o, s1, s2 = cv[1], cv[2], cv[3], cv[4], cv[5]
        zu = proof.z_shifted_opening.claimed_value
        alpha_sq_l1 = lagrange_one * alpha % R * alpha % R
        const_lin = (beta * s1 + gamma + l) % R
        const_lin = const_lin * ((beta * s2 + gamma + r_) % R) % R
        const_lin = const_lin * ((o + gamma) % R) % R * alpha % R * zu % R
        const_lin = (const_lin - alpha_sq_l1 + pi) % R
        const_lin = (-const_lin) % R
        if const_lin != cv[0] % R:
            raise errors.OpeningPolyMismatchError()

        _s1 = (beta * s1 + l + gamma) % R * ((beta * s2 + r_ + gamma) % R) % R
        _s1 = _s1 * beta % R * alpha % R * zu % R
        u = vk.coset_shift
        _s2 = (beta * zeta + gamma + l) % R
        _s2 = _s2 * ((beta * u % R * zeta + gamma + r_) % R) % R
        _s2 = _s2 * ((beta * u % R * u % R * zeta + gamma + o) % R) % R
        _s2 = (-(_s2 * alpha)) % R
        coeff_z = (alpha_sq_l1 + _s2) % R
        rl = l * r_ % R
        zeta_n2 = zeta_n * zeta % R * zeta % R
        zn2_zh = (-(zeta_n2 * zh_zeta)) % R
        zn2sq_zh = (-(zeta_n2 * zeta_n2 % R * zh_zeta)) % R
        zh_neg = (-zh_zeta) % R

        lin_points = list(proof.bsb22_commitments) + [
            vk.ql, vk.qr, vk.qm, vk.qo, vk.qk, vk.s[2],
            proof.z, proof.h[0], proof.h[1], proof.h[2],
        ]
        qc = [v % R for v in cv[6:]]
        lin_scalars = qc + [l, r_, rl, o, 1, _s1, coeff_z, zh_neg, zn2_zh, zn2sq_zh]
        return {
            "zeta": zeta,
            "lin_points": lin_points,
            "lin_scalars": lin_scalars,
        }


def _unpack_affine(aff):
    """Device affine tuple -> list of oracle points."""
    from ..models.jax_backend import unpack_fq

    xs = unpack_fq(aff[0])
    ys = unpack_fq(aff[1])
    infs = np.asarray(aff[2])
    return [None if infs[j] else (xs[j], ys[j]) for j in range(len(xs))]
