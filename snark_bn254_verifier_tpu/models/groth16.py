"""Groth16 verification (gnark-compatible semantics).

Protocol logic mirrors verifier/src/groth16/verify.rs: the proof is valid iff

    e(ar, bs) * e(sum_i in_i * k_{i+1} + k_0, gamma) * e(krs, -delta)
        == e(alpha, beta)

with the VK's beta points already negated at load time
(groth16/converter.rs:74,79). Unlike the reference — which recomputes
e(alpha, beta) on every call (groth16/verify.rs:70) — ``PreparedVerifyingKey``
caches it, realizing the reference's dead ``PreparedVerifyingKey`` struct
(groth16/verify.rs:45-50) properly.

Pedersen commitments / commitment_pok are parsed but NOT verified, matching
reference behavior for compatibility (see SURVEY.md §7 fidelity notes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..oracle import bn254 as bn
from ..utils import errors, serialization as ser
from .backend import get_backend


def prepare_inputs(vk: ser.Groth16VerifyingKey, public_inputs: Sequence[int], backend=None):
    """k[0] + sum_i public_inputs[i] * k[i+1] (groth16/verify.rs:53-63)."""
    if len(public_inputs) + 1 != len(vk.k):
        raise errors.PrepareInputsFailedError(
            f"got {len(public_inputs)} inputs for {len(vk.k)} k-points"
        )
    backend = get_backend(backend)
    if len(public_inputs) == 0:
        return vk.k[0]
    acc = backend.msm(vk.k[1:], [s % bn.R for s in public_inputs])
    return bn.g1_add(vk.k[0], acc)


@dataclass
class PreparedVerifyingKey:
    """VK with the constant pairing e(alpha, beta) precomputed once."""

    vk: ser.Groth16VerifyingKey
    alpha_beta: tuple  # Gt (Fq12 element)

    @classmethod
    def from_vk(cls, vk: ser.Groth16VerifyingKey, backend=None):
        backend = get_backend(backend)
        return cls(vk=vk, alpha_beta=backend.pairing(vk.alpha_g1, vk.beta_g2))

    @classmethod
    def from_bytes(cls, vk_bytes: bytes, backend=None):
        return cls.from_vk(ser.load_groth16_verifying_key_from_bytes(vk_bytes), backend)


def verify_groth16(
    vk: ser.Groth16VerifyingKey,
    proof: ser.Groth16Proof,
    public_inputs: Sequence[int],
    backend=None,
    prepared: Optional[PreparedVerifyingKey] = None,
) -> bool:
    """groth16/verify.rs:65-78 semantics. The reference loads beta already
    negated, so its pairing_batch computes
    e(ar,bs) * e(PI,gamma) * e(krs,-delta) and compares against
    e(alpha, -beta)... with both sides carrying the same negation the check
    is equivalent to the classic equation; we evaluate it identically."""
    backend = get_backend(backend)
    prepared_inputs = prepare_inputs(vk, public_inputs, backend)
    alpha_beta = (
        prepared.alpha_beta if prepared is not None else backend.pairing(vk.alpha_g1, vk.beta_g2)
    )
    lhs = backend.pairing_batch(
        [
            (proof.ar, proof.bs),
            (prepared_inputs, vk.gamma_g2),
            (proof.krs, bn.g2_neg(vk.delta_g2)),
        ]
    )
    return lhs == alpha_beta


class Groth16Verifier:
    """Public API facade matching the reference (verifier/src/lib.rs:44-49).

    Repeat calls with the same VK bytes reuse the parsed VK and the
    PreparedVerifyingKey (cached e(alpha, beta)) — the single-proof latency
    path then pays one proof parse + one 3-pair pairing per call instead of
    re-preparing the VK each time (VERDICT r3 item #10)."""

    _cache: dict = {}

    @staticmethod
    def verify(
        proof: bytes,
        vk: bytes,
        public_inputs: Sequence[int],
        backend=None,
    ) -> bool:
        import hashlib

        backend_obj = get_backend(backend)
        key = (
            hashlib.sha256(vk).digest(),
            getattr(backend_obj, "name", None) or id(backend_obj),
        )
        ent = Groth16Verifier._cache.get(key)
        if ent is None:
            vk_obj = ser.load_groth16_verifying_key_from_bytes(vk)
            prepared = PreparedVerifyingKey.from_vk(vk_obj, backend_obj)
            ent = (vk_obj, prepared)
            Groth16Verifier._cache[key] = ent
        vk_obj, prepared = ent
        proof_obj = ser.load_groth16_proof_from_bytes(proof)
        return verify_groth16(
            vk_obj, proof_obj, public_inputs, backend=backend_obj,
            prepared=prepared,
        )
