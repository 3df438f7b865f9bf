"""Peak-RSS regression guard (host memory once ran at 4x the
reference; the round-4 diet cut buildG ~30% — this pins the gains).

Budgets are generous (~2x the measured post-diet peaks at this scale) so
machine variance cannot trip them, while a structural regression — e.g.
reintroducing the full 16 B/row relation export or a whole-file raw
ingest copy — doubles the footprint and fails."""
import json
import pathlib
import subprocess
import sys

import pytest

from conftest import PARAM_FILES

ROOT = pathlib.Path(__file__).resolve().parent.parent

_CHILD = r"""
import json, sys
sys.path.insert(0, %(root)r)
from disco_tpu.buildg.pipeline import run_buildg
from disco_tpu.simplify.driver import run_fullsimplify


def peak_mb():
    # VmHWM, NOT getrusage: Linux does not reset ru_maxrss on execve, so a
    # subprocess forked from a large parent (the pytest process after the
    # virtual-mesh tests) inherits the parent's peak and reads garbage
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM"):
                return int(line.split()[1]) // 1024
    return -1


fasta, prefix = sys.argv[1], sys.argv[2]
run_buildg([fasta], [], prefix, min_overlap=40, write_par_graph_size=20000)
build_peak = peak_mb()
PARAM = %(params)r
run_fullsimplify([], [], [fasta], [prefix + "_0_parGraph.txt"],
                 [prefix + "_0_containedReads.txt"], prefix + "S",
                 param_files=PARAM)
full_peak = peak_mb()
print(json.dumps({"build_mb": build_peak, "full_mb": full_peak}))
"""


@pytest.mark.slow
def test_peak_rss_budget(tmp_path):
    fasta = tmp_path / "reads.fasta"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
         str(fasta), "--genome-len", "2000000", "--coverage", "25",
         "--seed", "19"],
        check=True, stdout=subprocess.DEVNULL)
    p = subprocess.run(
        [sys.executable, "-c", _CHILD % {"root": str(ROOT), "params": PARAM_FILES},
         str(fasta), str(tmp_path / "MB")],
        capture_output=True, text=True,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"})
    assert p.returncode == 0, p.stderr[-2000:]
    peaks = json.loads(p.stdout.strip().splitlines()[-1])
    # bounds ~2x the post-diet peaks at 2 Mb/25x (incl. the ~160 MB
    # python+numpy baseline); pre-diet code exceeds them
    assert peaks["build_mb"] < 700, peaks
    assert peaks["full_mb"] < 1000, peaks
