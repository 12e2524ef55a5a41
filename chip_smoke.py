"""End-to-end smoke run of the verifier on a GPU.

Drives the main path through the entry points a user calls, at the
README's production batch of 1,024 lanes:

  * ``Groth16BatchVerifier.verify_batch`` with 2 public inputs (324-byte
    proofs) and with the SP1-shaped vector (3 inputs and one commitment,
    388-byte proofs);
  * ``PlonkBatchVerifier.verify_batch`` with one BSB22 commitment (904-byte
    proofs);
  * the facades ``Groth16Verifier.verify`` / ``PlonkVerifier.verify`` with
    ``backend="jax"``, on a valid and an invalid proof each.

Every batch mixes distinct valid proofs (one VK, several proofs) with
invalid lanes of one byte length: wrong public inputs, an A or a
commitment made off-curve by a flipped byte, a B that is not on the
twist, a corrupted claimed value and a swapped KZG opening. Every lane's
verdict must equal the oracle's (oracle/bn254.py), computed once for each
distinct (proof, inputs) pair.

With ``--four-cards`` it runs only the multi-card paths: a data-parallel
Groth16 batch of 4 x 1,024 lanes on a 4-way "data" mesh, compared lane for
lane with the one-card verdicts and the oracle, and ``sharded_msm`` of
2^16 points on a 4-way "model" mesh, compared with the closed form of a
trapdoor MSM.

Times printed here are informational (the phases run concurrently, in
threads of this one process). The script refuses to run without a
GPU, exits non-zero if any phase fails, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

only when every phase passed.

Usage: python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from snark_bn254_verifier_tpu.fixtures.gen import (
    gen_groth16_vector,
    gen_groth16_vector_sp1_shaped,
    gen_plonk_vector,
)
from snark_bn254_verifier_tpu.oracle import bn254 as bn
from snark_bn254_verifier_tpu.utils import errors
from snark_bn254_verifier_tpu.utils import serialization as ser

BATCH = 1024
N_VALID_PROOFS = 4   # distinct valid proofs per batch, all under one VK
MSM_LOG2_POINTS = 16


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Device checks and the result line
# ---------------------------------------------------------------------------


def require_gpu(devices, count: int = 1):
    """Refuse to run on anything but ``count`` or more GPUs."""
    platform = devices[0].platform if devices else None
    if platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke needs {count} GPUs; JAX found {len(devices)}")
    return devices


def card_lines() -> list:
    """Name and power limit of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def contract_line(devices) -> str:
    """The last stdout line of a passing run."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


# ---------------------------------------------------------------------------
# Lane plans: which proof and inputs each lane of a batch carries
# ---------------------------------------------------------------------------


def _flip(proof: bytes, offset: int) -> bytes:
    """Flip the lowest bit of one byte (the big-endian coordinates keep
    their length and stay below the modulus)."""
    b = bytearray(proof)
    b[offset] ^= 1
    return bytes(b)


def _wrong_inputs(kind: str, inputs):
    if kind == "wrong_input_plus1":
        return [(inputs[0] + 1) % bn.R] + list(inputs[1:])
    if kind == "wrong_input_swapped":
        return list(inputs[::-1])
    return [0] * len(inputs)  # wrong_input_zero


_WRONG_INPUTS = ("wrong_input_plus1", "wrong_input_swapped", "wrong_input_zero")
# Groth16 proof bytes: A (64) || B (128, x1 x0 y1 y0) || C (64) || ...
_G16_MUTATIONS = _WRONG_INPUTS + ("a_off_curve", "b_off_curve")
# PlonK proof bytes: L R O (3 x 64) || Z || H0 H1 H2 || batched opening H
# (448:512) || claimed-value count (4) || claimed values (516:) || ...
_PLONK_MUTATIONS = _WRONG_INPUTS + (
    "commitment_off_curve", "claimed_value_flip", "opening_swapped",
)


def _mutate(kind: str, proof: bytes, inputs):
    if kind in _WRONG_INPUTS:
        return proof, _wrong_inputs(kind, inputs)
    if kind in ("a_off_curve", "commitment_off_curve"):
        return _flip(proof, 31), list(inputs)       # low byte of the first x
    if kind == "b_off_curve":
        return _flip(proof, 64 + 127), list(inputs)  # low byte of B's y0
    if kind == "claimed_value_flip":
        return _flip(proof, 516 + 31), list(inputs)
    if kind == "opening_swapped":
        other = ser.g1_to_uncompressed_bytes(bn.g1_mul(bn.G1_GEN, 2))
        return proof[:448] + other + proof[512:], list(inputs)
    raise ValueError(kind)


def lane_kinds(batch: int, mutations) -> list:
    """Lane i's kind: every third lane carries one of ``mutations`` in
    turn, the others are valid."""
    kinds, m = [], 0
    for i in range(batch):
        if i % 3 == 1:
            kinds.append(mutations[m % len(mutations)])
            m += 1
        else:
            kinds.append("valid")
    return kinds


def lane_plan(protocol: str, batch: int, seed: int = 0):
    """(vk, proofs, inputs, kinds) for one batch of ``protocol``
    ("groth16", "groth16_sp1" or "plonk"). Valid lanes cycle through
    N_VALID_PROOFS proofs of one VK; invalid lanes mutate the first."""
    gen, mutations = {
        "groth16": (lambda ps: gen_groth16_vector(seed, num_inputs=2, proof_seed=ps),
                    _G16_MUTATIONS),
        "groth16_sp1": (lambda ps: gen_groth16_vector_sp1_shaped(seed, proof_seed=ps),
                        _G16_MUTATIONS),
        "plonk": (lambda ps: gen_plonk_vector(seed, proof_seed=ps),
                  _PLONK_MUTATIONS),
    }[protocol]
    vecs = [gen(ps) for ps in range(N_VALID_PROOFS)]
    assert len({v.vk for v in vecs}) == 1, "proofs must share one VK"
    kinds = lane_kinds(batch, mutations)
    proofs, inputs = [], []
    for i, kind in enumerate(kinds):
        if kind == "valid":
            v = vecs[i % N_VALID_PROOFS]
            proofs.append(v.proof)
            inputs.append(list(v.public_inputs))
        else:
            p, ins = _mutate(kind, vecs[0].proof, vecs[0].public_inputs)
            proofs.append(p)
            inputs.append(ins)
    assert len({len(p) for p in proofs}) == 1, "lanes must keep one byte length"
    return vecs[0].vk, proofs, inputs, kinds


def oracle_verdicts(protocol: str, vk: bytes, proofs, inputs) -> list:
    """The oracle backend's verdict for every lane, computed once for each
    distinct (proof, inputs) pair. A raised verifier error is a reject."""
    from snark_bn254_verifier_tpu import Groth16Verifier, PlonkVerifier

    facade = PlonkVerifier if protocol == "plonk" else Groth16Verifier
    memo = {}
    out = []
    for proof, ins in zip(proofs, inputs):
        key = (proof, tuple(ins))
        if key not in memo:
            try:
                memo[key] = bool(facade.verify(proof, vk, list(ins), backend="oracle"))
            except errors.VerifierError:
                memo[key] = False
        out.append(memo[key])
    return out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def _verifier_cls(protocol: str):
    from snark_bn254_verifier_tpu.parallel.batch import (
        Groth16BatchVerifier,
        PlonkBatchVerifier,
    )

    return PlonkBatchVerifier if protocol == "plonk" else Groth16BatchVerifier


def _compare(label: str, got, want, kinds) -> bool:
    got = [bool(x) for x in got]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    counts = {}
    for k, w in zip(kinds, want):
        counts.setdefault(k, [0, 0])[0 if w else 1] += 1
    log(f"[{label}] lanes={len(got)} accepted={sum(got)} "
        f"oracle_accepted={sum(want)} mismatches={len(bad)}")
    log(f"[{label}] per kind (oracle accept, reject): "
        + json.dumps({k: tuple(v) for k, v in sorted(counts.items())}))
    if bad:
        log(f"[{label}] first mismatching lanes: "
            + ", ".join(f"{i}:{kinds[i]} device={got[i]} oracle={want[i]}"
                        for i in bad[:8]))
    return len(got) == len(want) and not bad


def batch_phase(protocol: str, batch: int, warm: bool = True) -> bool:
    """One protocol's batch at ``batch`` lanes vs the oracle, lane for lane.
    The first call's seconds (compile included) are printed, and with
    ``warm`` those of a second, warm call."""
    t0 = time.perf_counter()
    vk, proofs, inputs, kinds = lane_plan(protocol, batch)
    want = oracle_verdicts(protocol, vk, proofs, inputs)
    log(f"[{protocol}] lane plan + oracle verdicts: "
        f"{time.perf_counter() - t0:.1f} s (host)")
    if not any(want) or all(want):
        log(f"[{protocol}] lane plan must mix accepted and rejected lanes")
        return False
    verifier = _verifier_cls(protocol)(vk)
    t0 = time.perf_counter()
    first = verifier.verify_batch(proofs, inputs)
    log(f"[{protocol}] verify_batch x{batch}: first call "
        f"{time.perf_counter() - t0:.2f} s (includes compile, informational)")
    ok = _compare(protocol, first, want, kinds)
    if warm:
        t0 = time.perf_counter()
        second = verifier.verify_batch(proofs, inputs)
        log(f"[{protocol}] verify_batch x{batch}: warm call "
            f"{time.perf_counter() - t0:.3f} s (informational)")
        ok &= _compare(protocol + " warm", second, want, kinds)
    return ok


def facade_phase() -> bool:
    """Both facades with backend="jax": a valid proof is accepted and an
    invalid one rejected (False, or the reference's error for PlonK)."""
    from snark_bn254_verifier_tpu import Groth16Verifier, PlonkVerifier

    ok = True
    g = gen_groth16_vector(0, num_inputs=2, proof_seed=0)
    cases = [
        ("groth16 valid", Groth16Verifier, g.proof, g.vk, g.public_inputs, True),
        ("groth16 wrong input", Groth16Verifier, g.proof, g.vk,
         _wrong_inputs("wrong_input_plus1", g.public_inputs), False),
    ]
    # the PlonK reject is decided on the host (linearization check), which
    # keeps the phase short; the batch phase covers device-side rejects
    p = gen_plonk_vector(0, proof_seed=0)
    cases += [
        ("plonk valid", PlonkVerifier, p.proof, p.vk, p.public_inputs, True),
        ("plonk wrong input", PlonkVerifier, p.proof, p.vk,
         _wrong_inputs("wrong_input_plus1", p.public_inputs), False),
    ]
    for label, facade, proof, vk, ins, want in cases:
        t0 = time.perf_counter()
        try:
            got = facade.verify(proof, vk, list(ins), backend="jax")
            how = repr(got)
        except errors.VerifierError as e:
            got, how = False, f"raised {type(e).__name__}"
        dt = time.perf_counter() - t0
        good = (got is True) if want else (got is False)
        ok &= good
        log(f"[facade] {label}: {how} ({'ok' if good else 'WRONG'}; "
            f"{dt:.2f} s incl. compile, informational)")
    return ok


def one_card_groth16(vk: bytes, proofs, inputs, want, kinds):
    """The one-card verdicts the data-parallel batch is compared with,
    checked against the oracle as soon as they arrive."""
    t0 = time.perf_counter()
    got = _verifier_cls("groth16")(vk).verify_batch(proofs, inputs)
    log(f"[groth16 one card] verify_batch x{len(proofs)}: first call "
        f"{time.perf_counter() - t0:.2f} s (includes compile, informational)")
    return _compare("groth16 one card vs oracle", got, want, kinds), got


def data_parallel_groth16(vk: bytes, proofs, inputs, want, kinds, n_cards: int):
    """One Groth16 batch over an n_cards-way "data" mesh
    (``Groth16BatchVerifier(vk, mesh=...)`` places every lane array with
    ``shard_batch``), checked against the oracle after its first call; then
    a warm call."""
    from snark_bn254_verifier_tpu.parallel.batch import Groth16BatchVerifier
    from snark_bn254_verifier_tpu.parallel.sharded import make_mesh

    label = f"groth16 data x{n_cards}"
    verifier = Groth16BatchVerifier(
        vk, mesh=make_mesh(n_cards, model_parallelism=1)
    )
    t0 = time.perf_counter()
    got = verifier.verify_batch(proofs, inputs)
    log(f"[{label}] verify_batch x{len(proofs)}: first call "
        f"{time.perf_counter() - t0:.2f} s (includes compile, informational)")
    ok = _compare(f"{label} vs oracle", got, want, kinds)
    t0 = time.perf_counter()
    warm = verifier.verify_batch(proofs, inputs)
    log(f"[{label}] verify_batch x{len(proofs)}: warm call "
        f"{time.perf_counter() - t0:.3f} s (informational)")
    ok &= _compare(f"{label} warm vs oracle", warm, want, kinds)
    return ok, got


def trapdoor_msm_check(log2_points: int, n_cards: int, seed: int = 11) -> bool:
    """``sharded_msm`` of 2^log2_points points on an n_cards-way "model"
    mesh vs the closed form: with P_i = (k0 + i) G, sum s_i P_i equals
    (sum s_i (k0 + i)) G."""
    import jax

    from snark_bn254_verifier_tpu.models.jax_backend import unpack_g1_jacobian
    from snark_bn254_verifier_tpu.ops import field as F
    from snark_bn254_verifier_tpu.parallel.sharded import make_mesh, sharded_msm

    label = f"sharded msm 2^{log2_points} x{n_cards}"
    t0 = time.perf_counter()
    n = 1 << log2_points
    rng = np.random.default_rng(seed)
    k0 = int(rng.integers(1, 1 << 62))
    pts, acc = [], bn.g1_mul(bn.G1_GEN, k0)
    for _ in range(n):
        pts.append(acc)
        acc = bn.g1_add(acc, bn.G1_GEN)
    scs = [int.from_bytes(rng.bytes(31), "big") % bn.R for _ in range(n)]
    expected = bn.g1_mul(
        bn.G1_GEN, sum(s * (k0 + i) for i, s in enumerate(scs)) % bn.R
    )
    x = np.stack([F.FQ.pack_scalar(p[0]) for p in pts])[..., None]
    y = np.stack([F.FQ.pack_scalar(p[1]) for p in pts])[..., None]
    inf = np.zeros((n, 1), bool)
    sc = np.stack([F.FR.pack_scalar(s, mont=False) for s in scs])[..., None]
    mesh = make_mesh(n_cards, model_parallelism=n_cards)
    log(f"[{label}] points and closed form: {time.perf_counter() - t0:.1f} s (host)")
    t0 = time.perf_counter()
    out = jax.block_until_ready(sharded_msm(mesh, (x, y, inf), sc))
    ok = unpack_g1_jacobian(out)[0] == expected
    log(f"[{label}] matches closed form={ok}; first call "
        f"{time.perf_counter() - t0:.2f} s (includes compile, informational)")
    t0 = time.perf_counter()
    out = jax.block_until_ready(sharded_msm(mesh, (x, y, inf), sc))
    warm_ok = unpack_g1_jacobian(out)[0] == expected
    log(f"[{label}] warm call matches closed form={warm_ok}; "
        f"{time.perf_counter() - t0:.3f} s (informational)")
    return ok and warm_ok


def four_card_phase(batch: int, n_cards: int = 4,
                    msm_log2_points: int = MSM_LOG2_POINTS) -> bool:
    """Data-parallel Groth16 at n_cards x batch lanes vs the one-card
    verdicts and the oracle, and the sharded trapdoor MSM. The three device
    runs go in threads so that their compiles overlap; each logs its own
    result as soon as it has one."""
    vk, proofs, inputs, kinds = lane_plan("groth16", batch)
    want = oracle_verdicts("groth16", vk, proofs, inputs)
    n = n_cards
    with ThreadPoolExecutor(3) as pool:
        one = pool.submit(one_card_groth16, vk, proofs, inputs, want, kinds)
        data = pool.submit(data_parallel_groth16, vk, proofs * n, inputs * n,
                           want * n, kinds * n, n)
        msm = pool.submit(trapdoor_msm_check, msm_log2_points, n)
        (one_ok, one), (data_ok, got) = one.result(), data.result()
        msm_ok = msm.result()
    same = _compare(f"groth16 data x{n} vs one card", got, list(one) * n,
                    kinds * n)
    return one_ok and data_ok and same and msm_ok


def _run(name: str, fn, *args) -> bool:
    t0 = time.perf_counter()
    try:
        ok = bool(fn(*args))
    except Exception:  # noqa: BLE001 — a failed phase fails the run
        log(f"[{name}] FAILED with an exception:")
        log(traceback.format_exc())
        ok = False
    log(f"[{name}] {'passed' if ok else 'FAILED'} in "
        f"{time.perf_counter() - t0:.1f} s")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card data-parallel batch and sharded MSM")
    args = ap.parse_args(argv)

    import jax

    devices = require_gpu(jax.devices(), 4 if args.four_cards else 1)
    for line in card_lines():
        log(f"card: {line}")
    from snark_bn254_verifier_tpu.utils import native
    from snark_bn254_verifier_tpu.utils.config import (
        compilation_cache_dir,
        enable_compilation_cache,
    )

    enable_compilation_cache()
    log(f"jax {jax.__version__}; devices: {len(devices)} x "
        f"{devices[0].device_kind}; compile cache: {compilation_cache_dir()}")
    log("proof parser: " + ("native (native/bn254_host.cc)"
                            if native.native_available() else "python fallback"))

    if args.four_cards:
        ok = _run("four cards", four_card_phase, BATCH)
    else:
        # The phases run in threads of this one process: XLA compiles
        # outside the GIL, so their compiles overlap, and a cold run fits
        # its time limit. Times printed per phase therefore include waits
        # for the others. The SP1-shaped batch differs from "groth16" only
        # in its MSM stage, so it gets no warm call.
        phases = [
            ("groth16", batch_phase, ("groth16", BATCH)),
            ("groth16_sp1", batch_phase, ("groth16_sp1", BATCH, False)),
            ("plonk", batch_phase, ("plonk", BATCH)),
            ("facades", facade_phase, ()),
        ]
        with ThreadPoolExecutor(len(phases)) as pool:
            runs = [pool.submit(_run, name, fn, *a) for name, fn, a in phases]
            ok = all([r.result() for r in runs])
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    print(contract_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
