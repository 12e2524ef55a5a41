"""Multi-host distribution: 2 JAX processes x 4 CPU devices each.

The reference is single-threaded Rust with no distributed layer
(SURVEY.md §2 parallelism inventory). This test runs the real
multi-process stack — ``jax.distributed.initialize``, a global 8-device
mesh spanning both processes, ``shard_map`` + cross-process combination —
on CPU, the standard proxy without several hosts (process boundaries and
collectives are real; only the transport differs).
"""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

WORKER = os.path.join(os.path.dirname(__file__), "dist_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_msm():
    port = _free_port()
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multi-process workers timed out\n" + "\n".join(outs))
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i]}"
        assert f"process {i}: OK" in outs[i]
