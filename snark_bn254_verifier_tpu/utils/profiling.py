"""Tracing / profiling / observability.

The reference's only instrumentation is SP1 zkVM cycle-tracker markers
(examples/program/src/groth16.rs:19-21; SURVEY.md §5). The equivalents
here:

  * ``section(name)`` — lightweight wall-clock section timer.
  * ``trace(path)`` — jax.profiler trace context for TensorBoard-compatible
    device profiles of the verification pipeline.
  * ``RunStats`` — structured per-run throughput stats (batch size, mesh,
    proofs/sec/chip, pairings/sec).
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import asdict, dataclass, field
from typing import Dict, Optional


_timings: Dict[str, float] = {}


@contextlib.contextmanager
def section(name: str):
    """Accumulating wall-clock timer; read with get_timings()."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _timings[name] = _timings.get(name, 0.0) + time.perf_counter() - t0


def get_timings() -> Dict[str, float]:
    return dict(_timings)


def reset_timings() -> None:
    _timings.clear()


@contextlib.contextmanager
def trace(path: str):
    """Device-level profiler trace (view with TensorBoard / xprof)."""
    import jax

    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class RunStats:
    """Structured throughput record for a verification run."""

    protocol: str
    batch_size: int
    n_chips: int
    elapsed_s: float
    n_valid: int
    mesh_shape: tuple = ()
    pairings_per_proof: int = 3
    extra: dict = field(default_factory=dict)

    @property
    def proofs_per_sec(self) -> float:
        return self.batch_size / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def proofs_per_sec_per_chip(self) -> float:
        return self.proofs_per_sec / max(1, self.n_chips)

    @property
    def pairings_per_sec(self) -> float:
        return self.proofs_per_sec * self.pairings_per_proof

    def to_json(self) -> str:
        d = asdict(self)
        d["proofs_per_sec"] = round(self.proofs_per_sec, 2)
        d["proofs_per_sec_per_chip"] = round(self.proofs_per_sec_per_chip, 2)
        d["pairings_per_sec"] = round(self.pairings_per_sec, 2)
        return json.dumps(d)
