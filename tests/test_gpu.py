"""Tests that need the GPU (marker `gpu`; on the card: `pytest -m gpu`).

The test process itself is held to the CPU (conftest.py), so each test
runs its work in a child process that JAX starts on the card; the
`gpu_env` fixture decides whether there is one."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def gpu_env():
    """Environment for a child process on the card; skips without one."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU here (nvidia-smi not found)")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        env=env, capture_output=True, text=True, timeout=300)
    if probe.stdout.strip().splitlines()[-1:] != ["gpu"]:
        pytest.skip(f"JAX finds no GPU: {probe.stderr[-500:]}")
    return env


_RELATION_CHILD = r"""
import subprocess, sys
import numpy as np
import jax
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import _device_relation, compute_relation

assert jax.devices()[0].platform == "gpu", jax.devices()
fasta = sys.argv[1]
subprocess.run([sys.executable, sys.argv[2], fasta, "--genome-len",
                "4600000", "--coverage", "30", "--read-len", "250",
                "--insert", "500", "--seed", "11"], check=True,
               stdout=subprocess.DEVNULL)
store = ReadStore.from_files([fasta], [], 30)
table = FingerprintTable.build(store, 29)
got = _device_relation(store, table)
want = compute_relation(store, table, backend="native")
assert len(got) == len(want), (len(got), len(want))
for f in ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok"):
    assert np.array_equal(getattr(got, f), getattr(want, f)), f
print("relation rows", len(got))
"""


@pytest.mark.gpu
def test_device_relation_matches_native_on_gpu(gpu_env, tmp_path):
    """The device relation on the card equals the C++ host kernel's on
    the E. coli-shaped isolate (4.6 Mb, 30x, 2x250 bp), all 7 columns."""
    p = subprocess.run(
        [sys.executable, "-c", _RELATION_CHILD, str(tmp_path / "r.fasta"),
         str(ROOT / "tools" / "make_testdata.py")],
        env=gpu_env, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    assert "relation rows" in p.stdout
