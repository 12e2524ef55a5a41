"""Benchmark driver: the BASELINE.json configs on the accelerator.

Prints one JSON line per requested config. Every line names the device it
ran on (platform, device kind, device count); the driver refuses to run
without a GPU, so no CPU timing is ever printed under a device metric.

Configs (BASELINE.json `configs`):
  groth16_single  single-proof Groth16 verify latency (jax backend)
  plonk_single    single-proof PlonK verify latency (full transcript + KZG)
  groth16_batch   1024-proof Groth16 batch
  plonk_batch     1024-proof PlonK batch (golden SP1 vector when available)
  msm             2^16-point G1 Pippenger MSM sharded across the devices
  mixed           interleaved Groth16+PlonK batched throughput

Each config runs under fault isolation: a crashing config emits
{"metric": ..., "error": ...} and the remaining configs still produce
their lines.

Usage: python bench.py [--smoke] [--batch N] [--iters K]
                       [--configs a,b,...|all] [--msm-c BITS]
"""

import argparse
import json
import os
import time
import traceback


GOLDEN_DIR = "/root/reference/examples/binaries"
PLONK_VK = os.path.join(
    os.path.dirname(__file__), "snark_bn254_verifier_tpu", "fixtures", "plonk_vk.bin"
)


def _emit(line: dict):
    print(json.dumps(line), flush=True)


def _device_fields() -> dict:
    """The device a line was measured on; refuses anything but a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX found {devs[0].platform!r}"
        )
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "devices": len(devs),
    }


def _plonk_vectors():
    """(vk_bytes, proof_bytes, public_inputs) — golden SP1 fibonacci vector
    when the reference checkout is present, synthetic trapdoor otherwise."""
    if os.path.exists(PLONK_VK) and os.path.isdir(GOLDEN_DIR):
        from snark_bn254_verifier_tpu.utils.sp1_wrapper import load_sp1_wrapper

        w = load_sp1_wrapper(os.path.join(GOLDEN_DIR, "fibonacci_plonk_proof.bin"))
        with open(PLONK_VK, "rb") as f:
            return f.read(), w.raw_proof, list(w.public_inputs), "golden"
    from snark_bn254_verifier_tpu.fixtures.gen import gen_plonk_vector

    v = gen_plonk_vector(0)
    return v.vk, v.proof, list(v.public_inputs), "synthetic"


def bench_groth16_batch(cfg, iters):
    import jax
    import numpy as np

    from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector
    from snark_bn254_verifier_tpu.parallel.batch import Groth16BatchVerifier

    batch = cfg.batch_size
    vec = gen_groth16_vector(0, num_inputs=2)
    verifier = Groth16BatchVerifier(vec.vk)
    proofs = [vec.proof] * batch
    inputs = [vec.public_inputs] * batch

    t0 = time.time()
    ok = verifier.verify_batch(proofs, inputs)
    compile_time = time.time() - t0
    assert bool(np.asarray(ok).all()), "bench verification returned False"

    # pipelined dispatch: batch i+1's host parse/pack overlaps batch i's
    # device execution and result fetch (JAX async dispatch) — the serving
    # pattern
    t0 = time.time()
    pending = []
    for _ in range(iters):
        pending.append(verifier.verify_batch_async(proofs, inputs))
        if len(pending) > 2:
            assert bool(np.asarray(pending.pop(0)).all())
    for p in pending:
        assert bool(np.asarray(p).all())
    elapsed = time.time() - t0
    stats = verifier.last_stats
    n_chips = max(1, len(jax.devices()))
    pps_chip = batch * iters / elapsed / n_chips
    from snark_bn254_verifier_tpu.utils import roofline as RL

    line = {
        "metric": "groth16_batched_verify_throughput",
        "value": round(pps_chip, 2),
        "unit": "proofs/sec/chip",
        "batch": batch,
        "iters": iters,
        "chips": n_chips,
        "compile_s": round(compile_time, 1),
        "pairings_per_sec": round(pps_chip * n_chips * stats.pairings_per_proof, 1),
    }
    line.update(
        RL.roofline_fields(pps_chip, RL.groth16_mults_per_proof(verifier.n_inputs))
    )
    return line


def bench_plonk_batch(cfg, iters):
    import jax
    import numpy as np

    from snark_bn254_verifier_tpu.parallel.batch import PlonkBatchVerifier

    batch = cfg.batch_size
    vk, proof, inputs, source = _plonk_vectors()
    verifier = PlonkBatchVerifier(vk)
    proofs = [proof] * batch
    pins = [inputs] * batch

    t0 = time.time()
    ok = verifier.verify_batch(proofs, pins)
    compile_time = time.time() - t0
    assert bool(np.asarray(ok).all()), "plonk bench verification returned False"

    # pipelined dispatch (see bench_groth16_batch)
    t0 = time.time()
    pending = []
    for _ in range(iters):
        pending.append(verifier.verify_batch_async(proofs, pins))
        if len(pending) > 2:
            assert bool(np.asarray(pending.pop(0)).all())
    for p in pending:
        assert bool(np.asarray(p).all())
    elapsed = time.time() - t0
    stats = verifier.last_stats
    n_chips = max(1, len(jax.devices()))
    pps_chip = batch * iters / elapsed / n_chips
    from snark_bn254_verifier_tpu.utils import roofline as RL

    line = {
        "metric": "plonk_batched_verify_throughput",
        "value": round(pps_chip, 2),
        "unit": "proofs/sec/chip",
        "batch": batch,
        "iters": iters,
        "chips": n_chips,
        "vector": source,
        "compile_s": round(compile_time, 1),
        "host_stage_s": round(stats.extra.get("host_s", 0.0), 3),
        "pairings_per_sec": round(pps_chip * n_chips * stats.pairings_per_proof, 1),
    }
    line.update(
        RL.roofline_fields(
            pps_chip, RL.plonk_mults_per_proof(len(verifier.vk.qcp))
        )
    )
    return line


def _latency(fn, iters):
    fn()  # warm-up / compile
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        assert fn() is True
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def bench_groth16_single(cfg, iters):
    from snark_bn254_verifier_tpu import Groth16Verifier
    from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector

    vec = gen_groth16_vector(0, num_inputs=2)
    med = _latency(
        lambda: Groth16Verifier.verify(
            vec.proof, vec.vk, vec.public_inputs, backend="jax"
        ),
        iters,
    )
    return {
        "metric": "groth16_single_verify_latency",
        "value": round(med * 1e3, 2),
        "unit": "ms",
        "iters": iters,
    }


def bench_plonk_single(cfg, iters):
    from snark_bn254_verifier_tpu import PlonkVerifier

    vk, proof, inputs, source = _plonk_vectors()
    med = _latency(
        lambda: PlonkVerifier.verify(proof, vk, inputs, backend="jax"), iters
    )
    return {
        "metric": "plonk_single_verify_latency",
        "value": round(med * 1e3, 2),
        "unit": "ms",
        "iters": iters,
        "vector": source,
    }


def bench_msm(cfg, iters, log2n):
    import jax
    import numpy as np

    from snark_bn254_verifier_tpu.models.jax_backend import unpack_g1_jacobian
    from snark_bn254_verifier_tpu.oracle import bn254 as bn
    from snark_bn254_verifier_tpu.ops import field as F
    from snark_bn254_verifier_tpu.parallel.sharded import make_mesh, sharded_msm

    n = 1 << log2n
    n_chips = max(1, len(jax.devices()))
    rng = np.random.default_rng(11)
    # trapdoor points P_i = (k0+i)G via incremental adds; closed-form result
    k0 = int(rng.integers(1, 1 << 62))
    pts, acc = [], bn.g1_mul(bn.G1_GEN, k0)
    for _ in range(n):
        pts.append(acc)
        acc = bn.g1_add(acc, bn.G1_GEN)
    scs = [int.from_bytes(rng.bytes(31), "big") % bn.R for i in range(n)]
    expected = bn.g1_mul(
        bn.G1_GEN, sum(s * (k0 + i) for i, s in enumerate(scs)) % bn.R
    )
    x = np.stack([F.FQ.pack_scalar(p[0]) for p in pts])[..., None]
    y = np.stack([F.FQ.pack_scalar(p[1]) for p in pts])[..., None]
    inf = np.zeros((n, 1), bool)
    sc = np.stack([F.FR.pack_scalar(s, mont=False) for s in scs])[..., None]
    mesh = make_mesh(n_chips, model_parallelism=n_chips)

    def run():
        out = sharded_msm(mesh, (x, y, inf), sc, c=cfg.msm_window_bits)
        jax.tree_util.tree_map(lambda a: a.block_until_ready(), out)
        return out

    t0 = time.time()
    out = run()
    compile_time = time.time() - t0
    got = unpack_g1_jacobian(out)[0]
    assert got == expected, "sharded MSM result mismatch vs trapdoor oracle"

    t0 = time.time()
    for _ in range(iters):
        run()
    per_msm = (time.time() - t0) / iters
    return {
        "metric": f"msm_2e{log2n}_sharded_wallclock",
        "value": round(per_msm * 1e3, 2),
        "unit": "ms",
        "points": n,
        "window_bits": cfg.msm_window_bits,
        "points_per_sec": round(n / per_msm, 1),
        "chips": n_chips,
        "compile_s": round(compile_time, 1),
    }


def bench_mixed(cfg, iters):
    import jax
    import numpy as np

    from snark_bn254_verifier_tpu.fixtures.gen import gen_groth16_vector
    from snark_bn254_verifier_tpu.parallel.batch import (
        Groth16BatchVerifier,
        PlonkBatchVerifier,
    )

    batch = cfg.batch_size // 2
    g = gen_groth16_vector(0, num_inputs=2)
    vk, proof, inputs, source = _plonk_vectors()
    gv = Groth16BatchVerifier(g.vk)
    pv = PlonkBatchVerifier(vk)
    g_proofs, g_inputs = [g.proof] * batch, [g.public_inputs] * batch
    p_proofs, p_inputs = [proof] * batch, [inputs] * batch

    t0 = time.time()
    ok1 = gv.verify_batch(g_proofs, g_inputs)
    ok2 = pv.verify_batch(p_proofs, p_inputs)
    compile_time = time.time() - t0
    assert bool(np.asarray(ok1).all()) and bool(np.asarray(ok2).all())

    # interleaved pipelined dispatch across both protocols
    t0 = time.time()
    pending = []
    for _ in range(iters):
        pending.append(gv.verify_batch_async(g_proofs, g_inputs))
        pending.append(pv.verify_batch_async(p_proofs, p_inputs))
        while len(pending) > 2:
            assert bool(np.asarray(pending.pop(0)).all())
    for p in pending:
        assert bool(np.asarray(p).all())
    elapsed = time.time() - t0
    n_chips = max(1, len(jax.devices()))
    total = 2 * batch * iters
    pps_chip = total / elapsed / n_chips
    return {
        "metric": "mixed_groth16_plonk_throughput",
        "value": round(pps_chip, 2),
        "unit": "proofs/sec/chip",
        "batch": 2 * batch,
        "iters": iters,
        "chips": n_chips,
        "vector": source,
        "compile_s": round(compile_time, 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny shapes, quick")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument(
        "--configs",
        default="all",
        help="comma list of groth16_single,plonk_single,groth16_batch,"
        "plonk_batch,msm,mixed (default: all)",
    )
    ap.add_argument("--msm-c", type=int, default=8, help="Pippenger window bits")
    ap.add_argument("--msm-log2n", type=int, default=None)
    args = ap.parse_args()

    from snark_bn254_verifier_tpu.utils.config import (
        VerifierConfig,
        enable_compilation_cache,
    )

    enable_compilation_cache()

    batch = args.batch or (32 if args.smoke else 1024)
    iters = args.iters or (2 if args.smoke else 8)
    log2n = args.msm_log2n or (10 if args.smoke else 16)
    cfg = VerifierConfig(batch_size=batch, msm_window_bits=args.msm_c)

    wanted = (
        ["groth16_batch", "plonk_batch", "msm", "mixed", "groth16_single",
         "plonk_single"]
        if args.configs == "all"
        else args.configs.split(",")
    )
    device = _device_fields()

    runners = {
        "groth16_single": lambda: bench_groth16_single(cfg, max(4, iters)),
        "plonk_single": lambda: bench_plonk_single(cfg, max(4, iters)),
        "groth16_batch": lambda: bench_groth16_batch(cfg, iters),
        "plonk_batch": lambda: bench_plonk_batch(cfg, iters),
        "msm": lambda: bench_msm(cfg, max(2, iters // 2), log2n),
        "mixed": lambda: bench_mixed(cfg, max(2, iters // 2)),
    }
    # Per-config fault isolation: a failing config emits an error line and
    # the rest proceed; the exit code reports whether any failed.
    failed = 0
    for name in wanted:
        try:
            line = runners[name]()
            line.update(device)
            _emit(line)
        except Exception as e:  # noqa: BLE001 — isolation is the point
            failed += 1
            _emit(
                {
                    "metric": name,
                    "error": f"{type(e).__name__}: {e}",
                    "trace_tail": traceback.format_exc().strip().splitlines()[-3:],
                    **device,
                }
            )
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
