"""Run-time setup that must hold on any machine: where compiled programs
and native libraries are kept, and that the GPU smoke refuses to pass
without a GPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _child_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


@pytest.mark.parametrize("set_var", [True, False])
def test_compile_cache_dir(tmp_path, set_var):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed .jax_cache/ at the checkout root."""
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if set_var else {}
    p = subprocess.run(
        [sys.executable, "-c",
         "import disco_tpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=_child_env(**extra), cwd=tmp_path, capture_output=True,
        text=True, check=True)
    want = tmp_path if set_var else ROOT / ".jax_cache"
    assert p.stdout.strip() == str(want)


def test_native_build_key_follows_the_source(tmp_path, monkeypatch):
    """A library is rebuilt when its source changes, reused when not, and
    never written beside the sources."""
    from disco_tpu import native

    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(native._DIR / "refsort.cpp", src / "refsort.cpp")
    build = tmp_path / "build"
    monkeypatch.setattr(native, "_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", build)
    first = native._compile("refsort")
    again = native._compile("refsort")
    assert first._name == again._name
    assert pathlib.Path(first._name).parent.parent == build
    with open(src / "refsort.cpp", "a") as f:
        f.write("\n// edited copy\n")
    changed = native._compile("refsort")
    assert changed._name != first._name
    assert not list(src.glob("*.so"))
    assert not list(build.rglob("*.tmp"))


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """Without a GPU, or without the repository beside it, the smoke exits
    non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    p = subprocess.run([sys.executable, str(script)], cwd=tmp_path,
                       env=_child_env(), capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
