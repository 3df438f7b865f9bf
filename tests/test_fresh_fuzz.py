"""Fresh-data fuzz parity: generate a new random dataset, run BOTH the
reference binaries and disco_tpu on it, and byte-compare every output.

Unlike the golden tests (frozen fixtures), this exercises the live oracle
on inputs neither implementation has seen, so it catches regressions the
fixtures happen not to reach.  Requires the reference oracle build
(tools/build_reference.sh -> refbuild/); skipped otherwise.  Marked slow:
each case runs the reference end-to-end (~10-30 s).
"""
import pathlib
import shutil
import subprocess
import sys

import pytest

from conftest import PARAM_FILES

ROOT = pathlib.Path(__file__).resolve().parent.parent
REFBUILD = ROOT / "refbuild"

SIMPLIFY_OUTPUTS = [
    "phase_parsimplify_1.txt", "phase_initial_1.txt",
    "phase_aggressive_1.txt", "phase_flow_1.txt", "phase_postflow_1.txt",
    "phase_scaffold_1.txt", "dimacs_dump.txt", "UsedReads_1.txt",
    "scaffoldsFinal_1.fasta", "scaffoldEdgesFinal_1.txt",
    "scaffoldEdgeCoverageFinal_1.txt",
]

CASES = [
    # (seed, genome_len, coverage, read_len, n_genomes, error_rate)
    (101, 40000, 15, 120, 1, 0.0),
    (202, 30000, 20, 150, 1, 0.0),
    (303, 25000, 15, 130, 3, 0.0),   # mock community
    (404, 30000, 20, 140, 1, 0.008),  # sequencing errors: dead-end-branch-
                                      # heavy graphs (clip/bubble/dead-end
                                      # operators do real work)
]


# Multi-iteration case: noise pairs keep the used-read fraction after
# iteration 1 under maxReadsUsed=0.75 (so the reference's iteration loop
# continues, src/SimplifyGraph/src/main.cpp:79-93), and dense sub-300bp
# islets (< minSequenceLengthTobePrinted, hence unused, yet >= 20 inner
# reads so they survive iteration 2-3 dead-end removal) give iterations
# 2-3 a real non-empty graph (an empty graph at the flow phase crashes
# the reference's CS2 with UNFEASIBLE).
MULTI_ITER_CASE = dict(seed=888, glen=40000, cov=15, rlen=120,
                       noise_frac=0.30, islets=8)

MULTI_ITER_OUTPUTS = [
    f"{name}_{it}.txt"
    for it in (2, 3)
    for name in ("phase_parsimplify", "phase_initial", "phase_aggressive",
                 "phase_flow", "phase_postflow", "phase_scaffold",
                 "UsedReads")
] + [
    f"{name}_{it}{ext}"
    for it in (1, 2, 3)
    for name, ext in (("scaffoldsFinal", ".fasta"),
                      ("scaffoldEdgesFinal", ".txt"),
                      ("scaffoldEdgeCoverageFinal", ".txt"))
]


def _have_oracle() -> bool:
    return (REFBUILD / "buildG").exists() and \
        (REFBUILD / "fullsimplify").exists() and \
        pathlib.Path(PARAM_FILES[0]).exists()


@pytest.mark.slow
@pytest.mark.parametrize("seed,glen,cov,rlen,ngen,err", CASES)
def test_fresh_dataset_full_parity(seed, glen, cov, rlen, ngen, err,
                                   tmp_path):
    if not _have_oracle():
        pytest.skip("reference oracle not built (tools/build_reference.sh)")
    fasta = tmp_path / "reads.fasta"
    cmd = [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
           str(fasta), "--genome-len", str(glen), "--coverage", str(cov),
           "--read-len", str(rlen), "--insert", str(3 * rlen),
           "--seed", str(seed)]
    if ngen > 1:
        cmd += ["--n-genomes", str(ngen)]
    if err:
        cmd += ["--error-rate", str(err)]
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL)
    cfg = tmp_path / "b.cfg"
    cfg.write_text("MinOverlap4BuildGraph = 40\n")

    # reference buildG + fullsimplify (single-threaded: parity mode)
    subprocess.run(
        [str(REFBUILD / "buildG"), "-pe", str(fasta), "-f",
         str(tmp_path / "REF"), "-p", str(cfg), "-t", "1", "-m", "4"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    subprocess.run(
        [str(REFBUILD / "fullsimplify"), "-fpi", str(fasta),
         "-e", str(tmp_path / "REF_0_parGraph.txt"),
         "-crd", str(tmp_path / "REF_0_containedReads.txt"),
         "-simPth", str(REFBUILD), "-p", PARAM_FILES[0],
         "-p2", PARAM_FILES[1], "-p3", PARAM_FILES[2],
         "-o", str(tmp_path / "REFS"), "-t", "1", "-log", "INFO"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    from disco_tpu.buildg.pipeline import run_buildg
    from disco_tpu.simplify.driver import run_fullsimplify
    run_buildg([str(fasta)], [], str(tmp_path / "MINE"), min_overlap=40,
               write_par_graph_size=1000)
    for suffix in ("_ReadIDMap.txt", "_0_containedReads.txt",
                   "_0_parGraph.txt"):
        got = (tmp_path / f"MINE{suffix}").read_bytes()
        want = (tmp_path / f"REF{suffix}").read_bytes()
        assert got == want, f"buildG{suffix} differs (seed {seed})"

    run_fullsimplify([], [], [str(fasta)],
                     [str(tmp_path / "MINE_0_parGraph.txt")],
                     [str(tmp_path / "MINE_0_containedReads.txt")],
                     str(tmp_path / "MINES"), param_files=PARAM_FILES)
    # the parsimplify snapshot may differ by the documented reference-UB
    # class (PARITY.md: EdgeSimple::copyEdge leaves dest lengths
    # uninitialized); when it does, the marginal-edge difference can
    # persist through phase_initial before the full engine's real-length
    # dead-end pass washes it out (observed on error-rich datasets) — so
    # phase_initial is only exempt when the UB actually fired
    ub_fired = (tmp_path / "MINES_phase_parsimplify_1.txt").read_bytes() \
        != (tmp_path / "REFS_phase_parsimplify_1.txt").read_bytes()
    for name in SIMPLIFY_OUTPUTS:
        ref = tmp_path / f"REFS_{name}"
        if not ref.exists():
            continue  # e.g. no scaffolds survived on a tiny input
        got = (tmp_path / f"MINES_{name}").read_bytes()
        if name == "phase_parsimplify_1.txt":
            continue
        if ub_fired and name == "phase_initial_1.txt":
            continue
        assert got == ref.read_bytes(), f"{name} differs (seed {seed})"


@pytest.mark.slow
def test_multi_iteration_full_parity(tmp_path):
    """Byte parity of EVERY iteration-2 and iteration-3 output against the
    live reference oracle: per-iteration cfg switching (disco_2/disco_3),
    isUsedEdge edge skipping, ClearEdgeInfo, recursive contained used-read
    accounting, and ctg/scf-count continuation
    (reference: src/SimplifyGraph/src/main.cpp:79-93,296-314)."""
    if not _have_oracle():
        pytest.skip("reference oracle not built (tools/build_reference.sh)")
    c = MULTI_ITER_CASE
    fasta = tmp_path / "reads.fasta"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"), str(fasta),
         "--genome-len", str(c["glen"]), "--coverage", str(c["cov"]),
         "--read-len", str(c["rlen"]), "--insert", str(3 * c["rlen"]),
         "--seed", str(c["seed"]), "--noise-frac", str(c["noise_frac"]),
         "--islets", str(c["islets"])],
        check=True, stdout=subprocess.DEVNULL)
    cfg = tmp_path / "b.cfg"
    cfg.write_text("MinOverlap4BuildGraph = 40\n")

    subprocess.run(
        [str(REFBUILD / "buildG"), "-pe", str(fasta), "-f",
         str(tmp_path / "REF"), "-p", str(cfg), "-t", "1", "-m", "4"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    subprocess.run(
        [str(REFBUILD / "fullsimplify"), "-fpi", str(fasta),
         "-e", str(tmp_path / "REF_0_parGraph.txt"),
         "-crd", str(tmp_path / "REF_0_containedReads.txt"),
         "-simPth", str(REFBUILD), "-p", PARAM_FILES[0],
         "-p2", PARAM_FILES[1], "-p3", PARAM_FILES[2],
         "-o", str(tmp_path / "REFS"), "-t", "1", "-log", "INFO"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    # the oracle must actually have reached iteration 3
    assert (tmp_path / "REFS_phase_scaffold_3.txt").exists()

    from disco_tpu.buildg.pipeline import run_buildg
    from disco_tpu.simplify.driver import run_fullsimplify
    run_buildg([str(fasta)], [], str(tmp_path / "MINE"), min_overlap=40,
               write_par_graph_size=1000)
    for suffix in ("_0_containedReads.txt", "_0_parGraph.txt"):
        assert (tmp_path / f"MINE{suffix}").read_bytes() == \
            (tmp_path / f"REF{suffix}").read_bytes(), f"buildG{suffix}"

    run_fullsimplify([], [], [str(fasta)],
                     [str(tmp_path / "MINE_0_parGraph.txt")],
                     [str(tmp_path / "MINE_0_containedReads.txt")],
                     str(tmp_path / "MINES"), param_files=PARAM_FILES)
    for name in MULTI_ITER_OUTPUTS:
        ref = tmp_path / f"REFS_{name}"
        assert ref.exists(), f"oracle did not produce {name}"
        got = (tmp_path / f"MINES_{name}").read_bytes()
        assert got == ref.read_bytes(), f"{name} differs"


@pytest.mark.slow
def test_fastq_input_full_parity(tmp_path):
    """Full-pipeline live-oracle parity on FASTQ input (4-line records —
    the reference sniffs '@' and parses FASTQ natively; read IDs, the
    ReadIDMap and unused-read emission all differ from the FASTA path)."""
    if not _have_oracle():
        pytest.skip("reference oracle not built (tools/build_reference.sh)")
    fastq = tmp_path / "reads.fastq"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
         str(fastq), "--genome-len", "30000", "--coverage", "18",
         "--read-len", "130", "--insert", "390", "--seed", "505",
         "--fastq"],
        check=True, stdout=subprocess.DEVNULL)
    cfg = tmp_path / "b.cfg"
    cfg.write_text("MinOverlap4BuildGraph = 40\n")
    subprocess.run(
        [str(REFBUILD / "buildG"), "-pe", str(fastq), "-f",
         str(tmp_path / "REF"), "-p", str(cfg), "-t", "1", "-m", "4"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    subprocess.run(
        [str(REFBUILD / "fullsimplify"), "-fpi", str(fastq),
         "-e", str(tmp_path / "REF_0_parGraph.txt"),
         "-crd", str(tmp_path / "REF_0_containedReads.txt"),
         "-simPth", str(REFBUILD), "-p", PARAM_FILES[0],
         "-p2", PARAM_FILES[1], "-p3", PARAM_FILES[2],
         "-o", str(tmp_path / "REFS"), "-t", "1", "-log", "INFO"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    from disco_tpu.buildg.pipeline import run_buildg
    from disco_tpu.simplify.driver import run_fullsimplify
    run_buildg([str(fastq)], [], str(tmp_path / "MINE"), min_overlap=40,
               write_par_graph_size=1000)
    for suffix in ("_ReadIDMap.txt", "_0_containedReads.txt",
                   "_0_parGraph.txt"):
        assert (tmp_path / f"MINE{suffix}").read_bytes() == \
            (tmp_path / f"REF{suffix}").read_bytes(), f"fastq {suffix}"
    run_fullsimplify([], [], [str(fastq)],
                     [str(tmp_path / "MINE_0_parGraph.txt")],
                     [str(tmp_path / "MINE_0_containedReads.txt")],
                     str(tmp_path / "MINES"), param_files=PARAM_FILES)
    for name in SIMPLIFY_OUTPUTS:
        ref = tmp_path / f"REFS_{name}"
        if not ref.exists() or name == "phase_parsimplify_1.txt":
            continue
        assert (tmp_path / f"MINES_{name}").read_bytes() == \
            ref.read_bytes(), f"fastq {name}"


def test_gzip_input_self_consistency(tmp_path):
    """Gzipped inputs take the in-memory scan fallback (the streaming
    scanner handles plain files); outputs must be byte-identical to the
    plain-file run.  (The reference oracle is built READGZ=0, so this is
    a self-consistency check, not an oracle comparison.)"""
    import gzip

    fasta = tmp_path / "reads.fasta"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
         str(fasta), "--genome-len", "20000", "--coverage", "15",
         "--read-len", "120", "--insert", "360", "--seed", "606"],
        check=True, stdout=subprocess.DEVNULL)
    gz = tmp_path / "reads.fasta.gz"
    with open(fasta, "rb") as fin, gzip.open(gz, "wb") as fout:
        fout.write(fin.read())

    from disco_tpu.buildg.pipeline import run_buildg
    run_buildg([str(fasta)], [], str(tmp_path / "PLAIN"), min_overlap=40,
               write_par_graph_size=1000)
    run_buildg([str(gz)], [], str(tmp_path / "GZ"), min_overlap=40,
               write_par_graph_size=1000)
    for suffix in ("_0_containedReads.txt", "_0_parGraph.txt"):
        assert (tmp_path / f"PLAIN{suffix}").read_bytes() == \
            (tmp_path / f"GZ{suffix}").read_bytes(), f"gz {suffix}"


@pytest.mark.slow
def test_separated_pair_files_full_parity(tmp_path):
    """Separated paired files (runDisco's -in1/-in2 -> buildG -pe f1,f2 +
    fullsimplify -fp f1,f2): read IDs assign file-1 block then file-2
    block and mates pair by OFFSET into the r2 range (reference:
    DataSet::getMatePair, DataSet.cpp:385-423) — arithmetic the
    interleaved fuzz cases never touch."""
    if not _have_oracle():
        pytest.skip("reference oracle not built (tools/build_reference.sh)")
    inter = tmp_path / "inter.fasta"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
         str(inter), "--genome-len", "30000", "--coverage", "18",
         "--read-len", "130", "--insert", "390", "--seed", "707"],
        check=True, stdout=subprocess.DEVNULL)
    # split the interleaved records into r1/r2 files
    recs = inter.read_text().strip().split("\n")
    assert len(recs) % 4 == 0
    with open(tmp_path / "r1.fasta", "w") as f1, \
            open(tmp_path / "r2.fasta", "w") as f2:
        for i in range(0, len(recs), 4):
            f1.write(recs[i] + "\n" + recs[i + 1] + "\n")
            f2.write(recs[i + 2] + "\n" + recs[i + 3] + "\n")
    pair = f"{tmp_path}/r1.fasta,{tmp_path}/r2.fasta"
    cfg = tmp_path / "b.cfg"
    cfg.write_text("MinOverlap4BuildGraph = 40\n")

    subprocess.run(
        [str(REFBUILD / "buildG"), "-pe", pair, "-f", str(tmp_path / "REF"),
         "-p", str(cfg), "-t", "1", "-m", "4"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    subprocess.run(
        [str(REFBUILD / "fullsimplify"), "-fp", pair,
         "-e", str(tmp_path / "REF_0_parGraph.txt"),
         "-crd", str(tmp_path / "REF_0_containedReads.txt"),
         "-simPth", str(REFBUILD), "-p", PARAM_FILES[0],
         "-p2", PARAM_FILES[1], "-p3", PARAM_FILES[2],
         "-o", str(tmp_path / "REFS"), "-t", "1", "-log", "INFO"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)

    from disco_tpu.buildg.pipeline import run_buildg
    from disco_tpu.simplify.driver import run_fullsimplify
    pf = [str(tmp_path / "r1.fasta"), str(tmp_path / "r2.fasta")]
    run_buildg(pf, [], str(tmp_path / "MINE"), min_overlap=40,
               write_par_graph_size=1000)
    for suffix in ("_ReadIDMap.txt", "_0_containedReads.txt",
                   "_0_parGraph.txt"):
        assert (tmp_path / f"MINE{suffix}").read_bytes() == \
            (tmp_path / f"REF{suffix}").read_bytes(), f"sep-pair {suffix}"
    run_fullsimplify([], pf, [],
                     [str(tmp_path / "MINE_0_parGraph.txt")],
                     [str(tmp_path / "MINE_0_containedReads.txt")],
                     str(tmp_path / "MINES"), param_files=PARAM_FILES)
    for name in SIMPLIFY_OUTPUTS:
        ref = tmp_path / f"REFS_{name}"
        if not ref.exists() or name == "phase_parsimplify_1.txt":
            continue
        assert (tmp_path / f"MINES_{name}").read_bytes() == \
            ref.read_bytes(), f"sep-pair {name}"


@pytest.mark.slow
def test_single_end_full_parity(tmp_path):
    """Pure single-end pipeline (buildG -se + fullsimplify -fs): no mate
    pairs at all, so the insert-distance / PE-support / scaffolder
    machinery runs degenerate (contigs pass through) — a path the paired
    cases never exercise."""
    if not _have_oracle():
        pytest.skip("reference oracle not built (tools/build_reference.sh)")
    se = tmp_path / "se.fasta"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"), str(se),
         "--genome-len", "25000", "--coverage", "18", "--read-len", "140",
         "--single-end", "--seed", "808"],
        check=True, stdout=subprocess.DEVNULL)
    cfg = tmp_path / "b.cfg"
    cfg.write_text("MinOverlap4BuildGraph = 40\n")
    subprocess.run(
        [str(REFBUILD / "buildG"), "-se", str(se), "-f",
         str(tmp_path / "REF"), "-p", str(cfg), "-t", "1", "-m", "4"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    subprocess.run(
        [str(REFBUILD / "fullsimplify"), "-fs", str(se),
         "-e", str(tmp_path / "REF_0_parGraph.txt"),
         "-crd", str(tmp_path / "REF_0_containedReads.txt"),
         "-simPth", str(REFBUILD), "-p", PARAM_FILES[0],
         "-p2", PARAM_FILES[1], "-p3", PARAM_FILES[2],
         "-o", str(tmp_path / "REFS"), "-t", "1", "-log", "INFO"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    assert (tmp_path / "REFS_scaffoldsFinal_1.fasta").exists()

    from disco_tpu.buildg.pipeline import run_buildg
    from disco_tpu.simplify.driver import run_fullsimplify
    run_buildg([], [str(se)], str(tmp_path / "MINE"), min_overlap=40,
               write_par_graph_size=1000)
    for suffix in ("_0_containedReads.txt", "_0_parGraph.txt"):
        assert (tmp_path / f"MINE{suffix}").read_bytes() == \
            (tmp_path / f"REF{suffix}").read_bytes(), f"se {suffix}"
    run_fullsimplify([str(se)], [], [],
                     [str(tmp_path / "MINE_0_parGraph.txt")],
                     [str(tmp_path / "MINE_0_containedReads.txt")],
                     str(tmp_path / "MINES"), param_files=PARAM_FILES)
    for name in SIMPLIFY_OUTPUTS:
        ref = tmp_path / f"REFS_{name}"
        if not ref.exists() or name == "phase_parsimplify_1.txt":
            continue
        assert (tmp_path / f"MINES_{name}").read_bytes() == \
            ref.read_bytes(), f"se {name}"


@pytest.mark.slow
def test_all_print_flags_full_parity(tmp_path):
    """Live-oracle parity with every output flag on (PrintContigs +
    PrintUnused + PrintGFA + PrintGFA2): covers the contig-print phase
    (whose used-read marking precedes scaffolding and changes UsedReads),
    the unused-read FASTA emission, and both GFA exports on fresh data."""
    if not _have_oracle():
        pytest.skip("reference oracle not built (tools/build_reference.sh)")
    fasta = tmp_path / "reads.fasta"
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"),
         str(fasta), "--genome-len", "30000", "--coverage", "16",
         "--read-len", "125", "--insert", "375", "--seed", "909"],
        check=True, stdout=subprocess.DEVNULL)
    p1 = tmp_path / "p1.cfg"
    txt = pathlib.Path(PARAM_FILES[0]).read_text()
    for flag in ("PrintContigs", "PrintUnused", "PrintGFA", "PrintGFA2"):
        txt = txt.replace(f"{flag} = false", f"{flag} = true")
    p1.write_text(txt)
    cfg = tmp_path / "b.cfg"
    cfg.write_text("MinOverlap4BuildGraph = 40\n")
    subprocess.run(
        [str(REFBUILD / "buildG"), "-pe", str(fasta), "-f",
         str(tmp_path / "REF"), "-p", str(cfg), "-t", "1", "-m", "4"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    subprocess.run(
        [str(REFBUILD / "fullsimplify"), "-fpi", str(fasta),
         "-e", str(tmp_path / "REF_0_parGraph.txt"),
         "-crd", str(tmp_path / "REF_0_containedReads.txt"),
         "-simPth", str(REFBUILD), "-p", str(p1),
         "-p2", PARAM_FILES[1], "-p3", PARAM_FILES[2],
         "-o", str(tmp_path / "REFS"), "-t", "1", "-log", "INFO"],
        check=True, cwd=tmp_path, stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL)
    for must in ("contigsFinal_1.fasta", "Graph_1.gfa", "Graph_1.gfa2",
                 "0_UnusedPairedReads.fasta"):
        assert (tmp_path / f"REFS_{must}").exists(), must

    from disco_tpu.buildg.pipeline import run_buildg
    from disco_tpu.simplify.driver import run_fullsimplify
    run_buildg([str(fasta)], [], str(tmp_path / "MINE"), min_overlap=40,
               write_par_graph_size=1000)
    run_fullsimplify([], [], [str(fasta)],
                     [str(tmp_path / "MINE_0_parGraph.txt")],
                     [str(tmp_path / "MINE_0_containedReads.txt")],
                     str(tmp_path / "MINES"),
                     param_files=[str(p1), PARAM_FILES[1], PARAM_FILES[2]])
    checked = 0
    for ref in sorted(tmp_path.glob("REFS_*")):
        name = ref.name[len("REFS_"):]
        if name == "phase_parsimplify_1.txt":
            continue
        mine = tmp_path / f"MINES_{name}"
        assert mine.exists(), f"missing MINES_{name}"
        assert mine.read_bytes() == ref.read_bytes(), f"allprint {name}"
        checked += 1
    assert checked >= 18, checked
