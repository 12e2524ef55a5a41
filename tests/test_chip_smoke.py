"""Host-side tests of chip_smoke.py and of what the GPU bring-up removed.

chip_smoke.py itself needs a GPU; these tests cover the parts that do not:
its device check, its lane plans and their oracle verdicts at a tiny
batch, and the exact form of its last line. They also pin the compile
cache location and scan the program files for TPU-only code.
"""

import json
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke
from snark_bn254_verifier_tpu.utils import config

pytestmark = pytest.mark.smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CACHE_PROBE = """
import os, sys, jax, jax.numpy as jnp
from snark_bn254_verifier_tpu.utils.config import enable_compilation_cache
enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
before = set(os.listdir(sys.argv[1])) if os.path.isdir(sys.argv[1]) else set()
jax.jit(lambda x: jnp.sin(x) * float(sys.argv[2]))(jnp.ones(7)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
print(len(set(os.listdir(sys.argv[1])) - before))
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compilation_cache_location(env_set, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, compiled programs land there and
    the code sets no other directory; unset, they land in <repo>/.jax_cache."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    expected = str(tmp_path / "cache") if env_set else config.DEFAULT_CACHE_DIR
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = expected
    assert config.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    out = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE, expected, str(os.getpid() + env_set)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    cache_dir, n_new = out.stdout.split()[-2:]
    assert cache_dir == expected
    assert int(n_new) >= 1


def test_require_gpu_refuses_cpu():
    import jax

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())
    gpu = SimpleNamespace(platform="gpu", device_kind="card")
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu([gpu], 4)
    assert chip_smoke.require_gpu([gpu] * 4, 4) == [gpu] * 4


def test_bench_refuses_cpu():
    """bench.py prints no timing unless JAX finds a GPU."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(REPO, "bench.py")
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench._device_fields()


def test_contract_line_is_exact():
    devs = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")]
    line = chip_smoke.contract_line(devs)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert json.loads(chip_smoke.contract_line(devs * 4))["device"]["count"] == 4


@pytest.mark.parametrize("protocol", ["groth16", "plonk"])
def test_lane_plan_oracle_verdicts(protocol):
    """At a tiny batch, every mutation appears, all lanes keep one byte
    length, valid lanes carry distinct proofs of one VK, and the oracle
    accepts exactly the valid lanes."""
    mutations = (chip_smoke._PLONK_MUTATIONS if protocol == "plonk"
                 else chip_smoke._G16_MUTATIONS)
    batch = 3 * len(mutations)
    vk, proofs, inputs, kinds = chip_smoke.lane_plan(protocol, batch)
    assert len(proofs) == len(inputs) == len(kinds) == batch
    assert set(kinds) == {"valid", *mutations}
    valid = [p for p, k in zip(proofs, kinds) if k == "valid"]
    assert len(set(valid)) == chip_smoke.N_VALID_PROOFS
    verdicts = chip_smoke.oracle_verdicts(protocol, vk, proofs, inputs)
    assert verdicts == [k == "valid" for k in kinds]


_SCANNED = ["snark_bn254_verifier_tpu", "bench.py", "tools", "chip_smoke.py"]
_FORBIDDEN = [
    r"pallas\.tpu", r"pallas import tpu", r"pltpu",
    r"""platform\s*[!=]=\s*["']tpu["']""",
    r"""default_backend\(\)\s*[!=]=\s*["']tpu["']""",
    r"TPU_BN254_PALLAS", r"TPU_BN254_CACHE",
]


def test_no_tpu_only_code_left():
    hits = []
    for top in _SCANNED:
        path = os.path.join(REPO, top)
        files = [path] if os.path.isfile(path) else [
            os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
            if f.endswith(".py")
        ]
        for fp in files:
            text = open(fp, encoding="utf-8").read()
            hits += [f"{fp}: {pat}" for pat in _FORBIDDEN if re.search(pat, text)]
    assert not hits, hits


@pytest.mark.gpu
def test_groth16_batch_on_card_matches_oracle(gpu_device):
    """The Groth16 batch phase of chip_smoke.py at 1,024 lanes: every lane's
    verdict equals the oracle's."""
    assert chip_smoke.batch_phase("groth16", chip_smoke.BATCH)
