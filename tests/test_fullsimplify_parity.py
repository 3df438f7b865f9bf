"""Bit parity of disco_tpu.simplify vs the reference `fullsimplify` oracle
(phase snapshots + final scaffold outputs; goldens from the patched oracle,
tools/build_reference.sh)."""
import shutil

import pytest

from conftest import GOLDEN, PARAM_FILES
from disco_tpu.simplify.driver import run_fullsimplify


OUTPUTS = [
    "phase_parsimplify_1.txt", "phase_initial_1.txt",
    "phase_aggressive_1.txt", "phase_flow_1.txt", "phase_postflow_1.txt",
    "phase_scaffold_1.txt", "dimacs_dump.txt", "scaffoldsFinal_1.fasta",
    "UsedReads_1.txt", "scaffoldEdgesFinal_1.txt",
    "scaffoldEdgeCoverageFinal_1.txt",
]


@pytest.mark.parametrize("fix", ["mini", "ecoli"])
def test_fullsimplify_parity(fix, tmp_path):
    d = GOLDEN / fix
    gold = d / "simplify"
    if not (gold / f"{fix}_phase_scaffold_1.txt").exists():
        pytest.skip(f"no fullsimplify goldens for {fix}")
    for name in ("_0_parGraph.txt", "_0_containedReads.txt"):
        shutil.copy(d / f"{fix}{name}", tmp_path / f"{fix}{name}")
    shutil.copy(d / "reads.fasta", tmp_path / "reads.fasta")
    prefix = str(tmp_path / fix)
    run_fullsimplify([], [], [str(tmp_path / "reads.fasta")],
                     [str(tmp_path / f"{fix}_0_parGraph.txt")],
                     [str(tmp_path / f"{fix}_0_containedReads.txt")],
                     prefix, param_files=PARAM_FILES)
    for name in OUTPUTS:
        got = (tmp_path / f"{fix}_{name}").read_bytes()
        want = (gold / f"{fix}_{name}").read_bytes()
        assert got == want, f"{fix}_{name} differs"


def test_fullsimplify_parity_mixed(tmp_path):
    """Mixed single-end + two interleaved pair files (reference:
    fullsimplify -fs se.fasta -fpi p1,p2) — multi-dataset mate-pair
    arithmetic and file streaming order."""
    d = GOLDEN / "mixed"
    gold = d / "simplify"
    for name in ("_0_parGraph.txt", "_0_containedReads.txt"):
        shutil.copy(d / f"mixed{name}", tmp_path / f"mixed{name}")
    prefix = str(tmp_path / "mixed")
    run_fullsimplify([str(d / "se.fasta")], [],
                     [str(d / "p1.fasta"), str(d / "p2.fasta")],
                     [str(tmp_path / "mixed_0_parGraph.txt")],
                     [str(tmp_path / "mixed_0_containedReads.txt")],
                     prefix, param_files=PARAM_FILES)
    for name in OUTPUTS:
        got = (tmp_path / f"mixed_{name}").read_bytes()
        want = (gold / f"mixed_{name}").read_bytes()
        assert got == want, f"mixed_{name} differs"
