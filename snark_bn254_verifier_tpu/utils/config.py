"""Framework configuration (mesh shape, batch sizes, compile cache).

The reference has no config system (behavior fully determined by input
bytes; SURVEY.md §5); a small dataclass covers the runtime knobs of the
batched/sharded pipeline, plus the JAX persistent compilation cache (the
pairing graphs are expensive to compile once, then free).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

# Fixed default cache location: the cache key includes the path, so a
# directory that moves between runs never hits.
DEFAULT_CACHE_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")
)


@dataclass
class VerifierConfig:
    batch_size: int = 256          # proofs per device batch
    mesh_shape: Tuple[int, ...] = ()  # () = single device
    mesh_axis_names: Tuple[str, ...] = ("data",)
    msm_window_bits: int = 4


_cache_enabled = False


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives: JAX's own
    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else <repo>/.jax_cache."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compilation_cache() -> None:
    """Enable the persistent XLA compilation cache (idempotent).

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and no
    directory is set here; otherwise the cache goes to the fixed default."""
    global _cache_enabled
    if _cache_enabled:
        return
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    _cache_enabled = True
