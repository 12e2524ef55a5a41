"""Example / demo driver (parity with the reference host driver CLI,
examples/script/src/main.rs:18-36: ``--elf`` x ``--mode`` selection).

The reference's flow generates proofs with the SP1 SDK and re-verifies them
inside the zkVM — neither the SP1 prover nor its circuit VK fixtures exist
offline, so this driver offers the two flows that ARE runnable:

  * ``--golden``: parse the 8 golden SP1 wrapper binaries from the
    reference checkout, extract raw proofs + public inputs, and validate
    structure, canonical encodings and on-curve membership
    (the full True/False run needs the out-of-repo SP1 VK fixtures —
    pass --vk PATH if you have them).
  * ``--synthetic``: generate trapdoor test vectors in exact gnark byte
    format and run full verification (oracle or jax backend).

Usage:
    python -m snark_bn254_verifier_tpu.examples --synthetic --mode plonk
    python -m snark_bn254_verifier_tpu.examples --golden --elf fibonacci \
        --mode groth16 [--vk ~/.sp1/circuits/v2.0.0/groth16_vk.bin]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

GOLDEN_DIR = "/root/reference/examples/binaries"
ELFS = ["fibonacci", "is-prime", "sha2", "tendermint"]


def run_golden(elf: str, mode: str, vk_path: str | None, backend: str) -> int:
    from .oracle import bn254 as bn
    from .utils import serialization as ser
    from .utils.sp1_wrapper import load_sp1_wrapper

    path = os.path.join(GOLDEN_DIR, f"{elf}_{mode}_proof.bin")
    if not os.path.exists(path):
        print(f"golden vector not found: {path}")
        return 1
    w = load_sp1_wrapper(path)
    print(f"{elf}/{mode}: raw_proof {len(w.raw_proof)}B, "
          f"public inputs {[str(v)[:18] + '...' for v in w.public_inputs]}")
    if mode == "groth16":
        proof = ser.load_groth16_proof_from_bytes(w.raw_proof)
        pts = {"ar": proof.ar, "krs": proof.krs}
        ok = all(bn.g1_is_on_curve(p) for p in pts.values())
        ok &= bn.g2_is_on_curve(proof.bs)
    else:
        proof = ser.load_plonk_proof_from_bytes(w.raw_proof)
        pts = list(proof.lro) + [proof.z, *proof.h, proof.batched_proof.h,
                                 proof.z_shifted_opening.h] + proof.bsb22_commitments
        ok = all(bn.g1_is_on_curve(p) for p in pts)
    print(f"  structure + canonical encodings + on-curve: {'OK' if ok else 'FAIL'}")
    if vk_path is None and mode == "plonk":
        # the SP1 v2.0.0 PlonK VK is committed (recovered from the reference
        # guest ELF by fixtures/extract_vk.py), so golden PlonK runs full
        # end-to-end by default; the Groth16 VK never shipped (see
        # ARCHITECTURE.md "Correctness strategy").
        default_vk = os.path.join(
            os.path.dirname(__file__), "fixtures", "plonk_vk.bin"
        )
        if os.path.exists(default_vk):
            vk_path = default_vk
    if vk_path:
        from . import Groth16Verifier, PlonkVerifier

        vk = open(os.path.expanduser(vk_path), "rb").read()
        verifier = Groth16Verifier if mode == "groth16" else PlonkVerifier
        t0 = time.time()
        result = verifier.verify(w.raw_proof, vk, w.public_inputs, backend=backend)
        print(f"  full verification: {result} ({time.time() - t0:.3f}s, backend={backend})")
        return 0 if result else 1
    print("  (full verification needs the SP1 circuit VK: pass --vk PATH)")
    return 0 if ok else 1


def run_synthetic(mode: str, backend: str) -> int:
    from . import Groth16Verifier, PlonkVerifier
    from .fixtures.gen import gen_groth16_vector, gen_plonk_vector

    if mode == "groth16":
        vec = gen_groth16_vector(0)
        verifier = Groth16Verifier
    else:
        vec = gen_plonk_vector(0)
        verifier = PlonkVerifier
    t0 = time.time()
    ok = verifier.verify(vec.proof, vec.vk, vec.public_inputs, backend=backend)
    print(f"synthetic {mode} verify: {ok} ({time.time() - t0:.3f}s, backend={backend})")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="snark_bn254_verifier_tpu.examples")
    ap.add_argument("--elf", choices=ELFS, default="fibonacci")
    ap.add_argument("--mode", choices=["groth16", "plonk"], default="groth16")
    ap.add_argument("--golden", action="store_true")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--all-golden", action="store_true")
    ap.add_argument("--vk", default=None, help="SP1 circuit VK path")
    ap.add_argument("--backend", choices=["oracle", "jax"], default="oracle")
    args = ap.parse_args(argv)

    if args.all_golden:
        rc = 0
        for elf in ELFS:
            for mode in ("groth16", "plonk"):
                rc |= run_golden(elf, mode, args.vk, args.backend)
        return rc
    if args.golden:
        return run_golden(args.elf, args.mode, args.vk, args.backend)
    return run_synthetic(args.mode, args.backend)


if __name__ == "__main__":
    sys.exit(main())
