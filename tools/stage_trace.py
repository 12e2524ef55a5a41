"""Per-stage times of both batch pipelines at one batch size.

Runs one warm ``verify_batch`` of each protocol with every device stage
made synchronous and wrapped in a host span named
``stage:<protocol>:<stage>``: the input MSMs (``msm``), the mixed Miller
product (``miller``) and the final exponentiation (``final_exp``), and
prints each stage's host-clock seconds. Needs a GPU.

With ``--trace`` the warm runs also go under ``jax.profiler``, and the
reduction attributes each device event to the stage span it falls in:
device busy seconds (the union of event intervals) and the number of
device events (kernel launches and copies). At the full 1,024-lane batch
the trace overflows the profiler's activity buffers on an H100 and no
stage can be reduced; try a small batch.

Usage: python tools/stage_trace.py [--batch N] [--protocols P,..]
                                   [--trace] [--trace-dir DIR] [--out FILE]
The trace goes to DIR (default .stage_trace/, which can be large) and its
JSON summary to FILE (default chiprun_out/stage_trace_summary.json).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

def _staged(name: str, fn, spans: list, protocol: list):
    """fn, made synchronous and wrapped in a host span; host-clock times
    are appended to ``spans`` as (protocol, stage, seconds)."""
    import jax

    def run(*args, **kwargs):
        with jax.profiler.TraceAnnotation(f"stage:{protocol[0]}:{name}"):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args, **kwargs))
            spans.append((protocol[0], name, time.perf_counter() - t0))
        return out

    return run


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str) -> dict:
    """Attribute device events to the ``stage:<protocol>:<stage>`` host
    spans of the trace at ``path``."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    windows, device_events, lines_seen = [], [], {}
    for plane in pd.planes:
        is_device = plane.name.startswith("/device:")
        for line in plane.lines:
            for ev in line.events:
                if is_device:
                    key = f"{plane.name} {line.name}"
                    lines_seen[key] = lines_seen.get(key, 0) + 1
                if ev.name.startswith("stage:") and not is_device:
                    windows.append((ev.start_ns, ev.start_ns + ev.duration_ns, ev.name[6:]))
                elif is_device and line.name.startswith("Stream"):
                    device_events.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    out = {"device_lines": lines_seen, "stages": {}}
    for start, end, name in sorted(set(windows)):  # a span can repeat across lines
        inside = [(s, e) for s, e in device_events if start <= s < end]
        rec = out["stages"].setdefault(name, {"events": 0, "busy_s": 0.0, "span_s": 0.0})
        rec["events"] += len(inside)
        rec["busy_s"] += _union_ns(inside) * 1e-9
        rec["span_s"] += (end - start) * 1e-9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=chip_smoke.BATCH)
    ap.add_argument("--protocols", default="groth16,plonk")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--trace-dir", default=".stage_trace")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "stage_trace_summary.json"))
    args = ap.parse_args(argv)

    import jax

    from snark_bn254_verifier_tpu.ops import pairing as PR
    from snark_bn254_verifier_tpu.parallel import batch as B
    from snark_bn254_verifier_tpu.utils.config import enable_compilation_cache

    chip_smoke.require_gpu(jax.devices())
    enable_compilation_cache()
    for line in chip_smoke.card_lines():
        print(f"card: {line}", flush=True)

    spans, current = [], ["warmup"]
    B._g16_prepare_jit = _staged("msm", B._g16_prepare_jit, spans, current)
    B._msm_affine = _staged("msm", B._msm_affine, spans, current)
    PR.miller_mixed_hostcall = _staged("miller", PR.miller_mixed_hostcall, spans, current)
    PR.final_exponentiation_jit = _staged(
        "final_exp", PR.final_exponentiation_jit, spans, current
    )

    def run(protocol, verifier, proofs, inputs):
        current[0] = protocol
        t0 = time.perf_counter()
        verifier.verify_batch(proofs, inputs)
        spans.append((protocol, "verify_batch", time.perf_counter() - t0))

    runs = []
    for protocol in args.protocols.split(","):
        vk, proofs, inputs, _ = chip_smoke.lane_plan(protocol, args.batch)
        verifier = chip_smoke._verifier_cls(protocol)(vk)
        current[0] = "warmup"
        verifier.verify_batch(proofs, inputs)  # compile outside the timing
        runs.append((protocol, verifier, proofs, inputs))
        if not args.trace:
            spans.clear()
            run(*runs[-1])
            for _, stage, secs in spans:
                print(json.dumps({"host_span": f"{protocol}:{stage}", "s": secs}),
                      flush=True)
    if not args.trace:
        return 0

    spans.clear()
    with jax.profiler.trace(args.trace_dir):
        for r in runs:
            run(*r)

    for protocol, stage, secs in spans:
        print(json.dumps({"host_span": f"{protocol}:{stage}", "s": secs}), flush=True)
    path = sorted(glob.glob(os.path.join(args.trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    t0 = time.perf_counter()
    summary = reduce_trace(path)
    summary["reduce_s"] = time.perf_counter() - t0
    summary["trace_bytes"] = os.path.getsize(path)
    summary["host_spans_s"] = [list(s) for s in spans]
    summary["batch"] = args.batch
    summary["device_kind"] = jax.devices()[0].device_kind
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    for name, rec in sorted(summary["stages"].items()):
        print(json.dumps({"stage": name, **rec}), flush=True)
    print(json.dumps({k: summary[k] for k in ("device_lines", "reduce_s", "trace_bytes")}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
