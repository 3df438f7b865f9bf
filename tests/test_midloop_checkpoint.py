"""Periodic in-loop graph checkpoint (reference: DISK_GRAPH_UPDATE=18000 s
re-serialization inside graphPathFindInitial/simplifyGraph,
src/SimplifyGraph/src/OverlapGraph.cpp:1183-1188,1282-1289, Config.h:53).

A run killed right after a mid-loop snapshot must resume from that
snapshot (not the phase boundary) and produce byte-identical final
outputs."""
import pathlib
import shutil

import pytest

from conftest import GOLDEN, PARAM_FILES
from disco_tpu.simplify.driver import run_fullsimplify


COMPARE = ["mini_phase_initial_1.txt", "mini_phase_aggressive_1.txt",
           "mini_phase_flow_1.txt", "mini_phase_postflow_1.txt",
           "mini_phase_scaffold_1.txt", "mini_UsedReads_1.txt",
           "mini_scaffoldsFinal_1.fasta"]


class _Killed(RuntimeError):
    pass


def _setup(d, tmp_path, cadence_cfg):
    for name in ("mini_0_parGraph.txt", "mini_0_containedReads.txt",
                 "reads.fasta"):
        shutil.copy(d / name, tmp_path / name)
    cfg = tmp_path / "disco1.cfg"
    cfg.write_text(pathlib.Path(PARAM_FILES[0]).read_text()
                   + f"\nDiskGraphUpdate={cadence_cfg}\n")
    return [str(cfg), PARAM_FILES[1], PARAM_FILES[2]]


def _run(tmp_path, params, on_disk_snapshot=None):
    return run_fullsimplify(
        [], [], [str(tmp_path / "reads.fasta")],
        [str(tmp_path / "mini_0_parGraph.txt")],
        [str(tmp_path / "mini_0_containedReads.txt")],
        str(tmp_path / "mini"), param_files=params,
        on_disk_snapshot=on_disk_snapshot)


def test_midloop_kill_resume_byte_identical(tmp_path):
    d = GOLDEN / "mini"
    if not (d / "mini_0_parGraph.txt").exists():
        pytest.skip("no mini golden")

    # uninterrupted baseline (cadence 0 => snapshot fires every loop pass,
    # exercising the snapshot write itself without any kill)
    base = tmp_path / "base"
    base.mkdir()
    params = _setup(d, base, 0)
    _run(base, params)

    # interrupted: kill right after the FIRST mid-loop snapshot, then
    # resume with a fresh driver invocation
    cut = tmp_path / "cut"
    cut.mkdir()
    params = _setup(d, cut, 0)
    hits = []

    def bomb():
        hits.append(1)
        raise _Killed()

    with pytest.raises(_Killed):
        _run(cut, params, on_disk_snapshot=bomb)
    assert hits, "periodic snapshot never fired"
    # the mid-loop snapshot exists and the phase did NOT complete
    assert (cut / "mini_CurrGraph_.txt").exists()
    ckpt = (cut / "mini_SimplificationCheckpointInfo.txt").read_text()
    assert "ParSimplify=1" in ckpt and "InitialSimplify=1" not in ckpt

    _run(cut, params)  # resume
    for name in COMPARE:
        want = (base / name).read_bytes()
        got = (cut / name).read_bytes()
        assert got == want, f"{name} differs after mid-loop kill/resume"


def test_cadence_never_fires_at_default(tmp_path):
    """At the reference's 18000 s default the snapshot must not fire on a
    short run (parity runs depend on CurrGraph only changing at phase
    boundaries)."""
    d = GOLDEN / "mini"
    if not (d / "mini_0_parGraph.txt").exists():
        pytest.skip("no mini golden")
    w = tmp_path / "w"
    w.mkdir()
    hits = []
    params = _setup(d, w, 18000)
    _run(w, params, on_disk_snapshot=lambda: hits.append(1))
    assert not hits
