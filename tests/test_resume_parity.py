"""Checkpoint/resume parity: restart from a mid-pipeline checkpoint
(FlowAnalysis complete) and match the oracle's resumed outputs
(reference restart contract: README.md:222-226, main.cpp:316-374)."""
import shutil

import pytest

from conftest import GOLDEN, PARAM_FILES
from disco_tpu.simplify.driver import run_fullsimplify



def test_resume_after_flow(tmp_path):
    d = GOLDEN / "mini"
    gold = d / "resume"
    if not (gold / "mini_scaffoldsFinal_1.fasta").exists():
        pytest.skip("no resume goldens")
    for name in ("mini_0_parGraph.txt", "mini_0_containedReads.txt"):
        shutil.copy(d / name, tmp_path / name)
    shutil.copy(d / "reads.fasta", tmp_path / "reads.fasta")
    # interrupted state: phases through FlowAnalysis completed
    (tmp_path / "mini_SimplificationCheckpointInfo.txt").write_text(
        "Iteration=1\nParSimplify=1\nInitialSimplify=1\n"
        "AggressiveSimplify=1\nFlowAnalysis=1\n")
    shutil.copy(d / "simplify" / "mini_phase_flow_1.txt",
                tmp_path / "mini_CurrGraph_.txt")
    shutil.copy(d / "simplify" / "mini_0_ParSimpleEdges.txt",
                tmp_path / "mini_0_ParSimpleEdges.txt")
    prefix = str(tmp_path / "mini")
    run_fullsimplify([], [], [str(tmp_path / "reads.fasta")],
                     [str(tmp_path / "mini_0_parGraph.txt")],
                     [str(tmp_path / "mini_0_containedReads.txt")],
                     prefix, param_files=PARAM_FILES)
    for name in ("mini_scaffoldsFinal_1.fasta", "mini_phase_postflow_1.txt",
                 "mini_phase_scaffold_1.txt", "mini_UsedReads_1.txt"):
        got = (tmp_path / name).read_bytes()
        want = (gold / name).read_bytes()
        assert got == want, f"{name} differs on resume"


def test_resume_between_iterations(tmp_path):
    """Interrupt after iteration 1 completes and resume: the checkpoint
    parser must start at iteration 2 with carried ctg/scf counters, and
    every iteration-2/3 output must match an uninterrupted 3-iteration run
    (reference: readCheckpointInfo, main.cpp:316-374 — Iteration= blocks
    with all seven phases complete advance the start iteration)."""
    import subprocess
    import sys
    import pathlib
    ROOT = pathlib.Path(__file__).resolve().parent.parent
    mk = [sys.executable, str(ROOT / "tools" / "make_testdata.py")]
    args = ["--genome-len", "40000", "--coverage", "15", "--read-len",
            "120", "--insert", "360", "--seed", "888", "--noise-frac",
            "0.30", "--islets", "8"]

    from disco_tpu.buildg.pipeline import run_buildg

    outs = {}
    for mode in ("full", "cut"):
        d = tmp_path / mode
        d.mkdir()
        fasta = d / "reads.fasta"
        subprocess.run(mk + [str(fasta)] + args, check=True,
                       stdout=subprocess.DEVNULL)
        run_buildg([str(fasta)], [], str(d / "X"), min_overlap=40,
                   write_par_graph_size=1000)
        common = ([], [], [str(fasta)], [str(d / "X_0_parGraph.txt")],
                  [str(d / "X_0_containedReads.txt")], str(d / "XS"))
        if mode == "full":
            run_fullsimplify(*common, param_files=PARAM_FILES)
        else:
            run_fullsimplify(*common, param_files=PARAM_FILES, max_iters=1)
            # resume: a fresh driver invocation must pick up at iteration 2
            run_fullsimplify(*common, param_files=PARAM_FILES)
        outs[mode] = d

    compared = 0
    for it in (2, 3):
        for name in (f"XS_phase_scaffold_{it}.txt", f"XS_UsedReads_{it}.txt",
                     f"XS_scaffoldsFinal_{it}.fasta",
                     f"XS_scaffoldEdgesFinal_{it}.txt"):
            ref = outs["full"] / name
            if not ref.exists():
                continue
            got = (outs["cut"] / name).read_bytes()
            assert got == ref.read_bytes(), f"{name} differs after resume"
            compared += 1
    assert compared >= 6, "iterations 2-3 did not run"
