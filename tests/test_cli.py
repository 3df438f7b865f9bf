"""CLI subcommands mirroring the reference executables (buildG /
fullsimplify / parsimplify; reference CLIs: src/BuildGraph/src/main.cpp:95-148,
src/SimplifyGraph/src/Config.cpp:198-288, mainParSimplify.cpp:13-17) —
outputs must stay bit-identical to the golden reference runs."""
import shutil

import pytest

from conftest import GOLDEN, PARAM_FILES
from disco_tpu.cli import main


def test_cli_buildg_micro(tmp_path, monkeypatch):
    d = GOLDEN / "micro"
    shutil.copy(d / "reads.fasta", tmp_path / "reads.fasta")
    shutil.copy(d / "buildg.cfg", tmp_path / "b.cfg")
    monkeypatch.chdir(tmp_path)  # ReadIDMap records the path as given
    prefix = str(tmp_path / "micro")
    assert main(["buildg", "-se", "reads.fasta", "-f", prefix,
                 "-p", "b.cfg", "-t", "1"]) == 0
    for name in ("_ReadIDMap.txt", "_0_containedReads.txt",
                 "_0_parGraph.txt"):
        got = (tmp_path / ("micro" + name)).read_bytes()
        want = (d / ("micro" + name)).read_bytes()
        assert got == want, name


def test_cli_parsimplify_mini(tmp_path):
    d = GOLDEN / "mini"
    out = tmp_path / "pse.txt"
    assert main(["parsimplify", str(d / "mini_0_parGraph.txt"),
                 str(out), "30", "1"]) == 0
    assert out.read_bytes() == (
        d / "simplify" / "mini_parsimple.txt").read_bytes()


def test_cli_simplify_mini(tmp_path):
    d = GOLDEN / "mini"
    for name in ("mini_0_parGraph.txt", "mini_0_containedReads.txt",
                 "reads.fasta"):
        shutil.copy(d / name, tmp_path / name)
    prefix = str(tmp_path / "mini")
    assert main([
        "simplify",
        "-fpi", str(tmp_path / "reads.fasta"),
        "-e", str(tmp_path / "mini_0_parGraph.txt"),
        "-crd", str(tmp_path / "mini_0_containedReads.txt"),
        "-o", prefix,
        "-p", PARAM_FILES[0], "-p2", PARAM_FILES[1],
        "-p3", PARAM_FILES[2]]) == 0
    got = (tmp_path / "mini_scaffoldsFinal_1.fasta").read_bytes()
    want = (d / "simplify" / "mini_scaffoldsFinal_1.fasta").read_bytes()
    assert got == want


def test_cli_buildg_distributed(tmp_path, monkeypatch):
    """`buildg -n 4` (runDisco-MPI equivalent) must write byte-identical
    outputs to the single-device run."""
    d = GOLDEN / "micro"
    shutil.copy(d / "reads.fasta", tmp_path / "reads.fasta")
    monkeypatch.chdir(tmp_path)
    prefix = str(tmp_path / "micro")
    assert main(["buildg", "-se", "reads.fasta", "-f", prefix,
                 "-m-ovl", "30", "-n", "4"]) == 0
    for name in ("_ReadIDMap.txt", "_0_containedReads.txt",
                 "_0_parGraph.txt"):
        got = (tmp_path / ("micro" + name)).read_bytes()
        want = (d / ("micro" + name)).read_bytes()
        assert got == want, name


def test_mesh_refuses_more_devices_than_the_accelerator_has(monkeypatch):
    """-n beyond the accelerator's devices fails; it never moves the run
    onto virtual CPU devices."""
    import jax

    from disco_tpu.cli import _mesh

    class FakeGpu:
        platform = "gpu"
    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    with pytest.raises(SystemExit, match="platform 'gpu' has only 1"):
        _mesh(4)
