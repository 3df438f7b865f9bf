"""GFA/GFA2 export + unused-read output parity vs the oracle (mini fixture,
PrintGFA/PrintGFA2/PrintUnused enabled)."""
import shutil

import pytest

from conftest import GOLDEN, PARAM_FILES
from disco_tpu.simplify.driver import run_fullsimplify


def test_gfa_and_unused_parity(tmp_path):
    d = GOLDEN / "mini"
    gold = d / "simplify_gfa"
    if not (gold / "mini_Graph_1.gfa").exists():
        pytest.skip("no GFA goldens")
    for name in ("mini_0_parGraph.txt", "mini_0_containedReads.txt"):
        shutil.copy(d / name, tmp_path / name)
    shutil.copy(d / "reads.fasta", tmp_path / "reads.fasta")
    prefix = str(tmp_path / "mini")
    run_fullsimplify([], [], [str(tmp_path / "reads.fasta")],
                     [str(tmp_path / "mini_0_parGraph.txt")],
                     [str(tmp_path / "mini_0_containedReads.txt")],
                     prefix,
                     param_files=[str(gold / "p1gfa.cfg"),
                                  *PARAM_FILES[1:]])
    for name in ("mini_Graph_1.gfa", "mini_Graph_1.gfa2",
                 "mini_0_UnusedPairedReads.fasta"):
        got = (tmp_path / name).read_bytes()
        want = (gold / name).read_bytes()
        assert got == want, f"{name} differs"


def test_mate_array_matches_mate_pair():
    """The vectorized mate array must equal mate_pair for every read,
    across interleaved, separated, and single datasets."""
    from conftest import GOLDEN, PARAM_FILES
    from disco_tpu.simplify.dataset import SimplifyDataset

    d = SimplifyDataset([str(GOLDEN / "mixed" / "se.fasta")],
                        [str(GOLDEN / "mixed" / "p1.fasta"),
                         str(GOLDEN / "mixed" / "p2.fasta")],
                        [str(GOLDEN / "mini" / "reads.fasta")])
    # mark a few contained reads to exercise the quirk branches
    for rid in range(1, d.size() + 1, 7):
        d.contained_flag[rid] = True
    ma = d.mate_array()
    for rid in range(1, d.size() + 1):
        assert int(ma[rid]) == d.mate_pair(rid), rid
