"""Accelerator BN254 SNARK verifier framework.

A from-scratch JAX/XLA/Pallas re-implementation of the capabilities of
succinctlabs/snark-bn254-verifier (Groth16 + PlonK verification over BN254,
bit-compatible with gnark/SP1 serialized proofs and verifying keys), built
around batches: multi-limb Montgomery field arithmetic vectorized over lanes,
the full Fp2/Fp6/Fp12 tower, optimal-ate pairings and Pippenger MSM as device
kernels, with batched verification sharded across device meshes.

Public API (mirrors verifier/src/lib.rs:44,69):

    from snark_bn254_verifier_tpu import Groth16Verifier, PlonkVerifier
    ok = Groth16Verifier.verify(proof_bytes, vk_bytes, public_inputs)
    ok = PlonkVerifier.verify(proof_bytes, vk_bytes, public_inputs)
"""

from .models.groth16 import Groth16Verifier, PreparedVerifyingKey, verify_groth16
from .models.plonk import PlonkVerifier, verify_plonk
from .models.backend import get_backend, set_default_backend
from .utils import errors

__all__ = [
    "Groth16Verifier",
    "PlonkVerifier",
    "PreparedVerifyingKey",
    "verify_groth16",
    "verify_plonk",
    "get_backend",
    "set_default_backend",
    "errors",
]

__version__ = "0.1.0"
