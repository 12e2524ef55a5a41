"""Compute-backend interface for the protocol verifiers.

The verifiers (models/groth16.py, models/plonk.py) express all heavy math
through three primitives — MSM, pairing, batched pairing — so the same
protocol logic runs against either:

  * the ``oracle`` backend: pure-Python ints (ground truth, always available)
  * the ``jax`` backend: device kernels (ops/), used by default when the
    device pipeline is built.

Host-side Fr scalar work (transcript challenges, Lagrange/linearization
algebra) is identical for both backends and stays in Python ints — it is
O(#public inputs) and byte-exactness-critical, per SURVEY.md §5.
"""

from __future__ import annotations

from ..oracle import bn254 as bn


class OracleBackend:
    """Ground-truth backend on Python ints."""

    name = "oracle"

    @staticmethod
    def msm(points, scalars):
        return bn.g1_msm(points, scalars)

    @staticmethod
    def g1_mul(point, scalar):
        return bn.g1_mul(point, scalar)

    @staticmethod
    def pairing(p, q):
        return bn.pairing(p, q)

    @staticmethod
    def pairing_batch(pairs):
        return bn.pairing_batch(pairs)

    @staticmethod
    def pairing_batch_is_one(pairs):
        return bn.fq12_is_one(bn.pairing_batch(pairs))


_DEFAULT = OracleBackend()


def get_backend(name_or_backend="default"):
    if name_or_backend in ("default", None):
        return _default_backend()
    if name_or_backend == "oracle":
        return _DEFAULT
    if name_or_backend == "jax":
        from . import jax_backend

        return jax_backend.JaxBackend.instance()
    if hasattr(name_or_backend, "pairing_batch"):
        return name_or_backend
    raise ValueError(f"unknown backend {name_or_backend!r}")


_default_name = "oracle"


def set_default_backend(name: str) -> None:
    global _default_name
    _default_name = name


def _default_backend():
    return get_backend(_default_name)
