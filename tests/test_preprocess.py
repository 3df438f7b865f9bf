"""Preprocessing orchestration (runECC.sh / runAssembly.sh equivalent,
disco_tpu/preprocess.py).

BBTools itself is third-party Java the reference bundles; these tests drive
the orchestration against stub bbduk/bbmerge/tadpole scripts that copy
in= -> out= and record their argv, then assert the command sequence and
flags match the reference's invocations (runECC.sh:198-213,263-300)."""
import os
import stat

import pytest

from disco_tpu.preprocess import BBToolsNotFound, run_preprocess

STUB = """#!/bin/sh
# stub BBTools tool: copy each in=/in2= file to the matching out=/out2=
ins=""; outs=""
for a in "$@"; do
  case "$a" in
    in=*)  ins="${a#in=}" ;;
    in2=*) ins="$ins,${a#in2=}" ;;
    out=*) outs="${a#out=}" ;;
    out2=*) outs="$outs,${a#out2=}" ;;
  esac
done
echo "$0 $@" >> "$(dirname "$0")/cmds.log"
oldIFS=$IFS; IFS=,
set -- $outs
for i in $ins; do
  [ -n "$1" ] && cp "$i" "$1" && shift
done
IFS=$oldIFS
exit 0
"""


@pytest.fixture
def bbmap(tmp_path):
    bb = tmp_path / "bbmap"
    (bb / "resources").mkdir(parents=True)
    for name in ("bbduk.sh", "bbmerge.sh", "tadpole.sh"):
        p = bb / name
        p.write_text(STUB)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    for res in ("adapters.fa", "sequencing_artifacts.fa.gz",
                "phix174_ill.ref.fa.gz"):
        (bb / "resources" / res).write_text(">r\nACGT\n")
    return bb


def _fa(path, tag, n=4):
    with open(path, "w") as f:
        for i in range(n):
            f.write(f">{tag}{i}\nACGTACGTACGT\n")
    return str(path)


def test_interleaved_branch(tmp_path, bbmap):
    inp = _fa(tmp_path / "lib.fasta", "p")
    log = []
    paired, single = run_preprocess(str(bbmap), str(tmp_path / "wd"),
                                    inP=[inp], command_log=log)
    assert single == []
    assert [os.path.basename(p) for p in paired] == \
        ["tecc.ftl.trm.lib.fasta"]
    assert open(paired[0]).read() == open(inp).read()
    # reference command sequence: trim -> filter -> bbmerge ecco -> tadpole
    tools = [os.path.basename(c[0]) for c in log]
    assert tools == ["bbduk.sh", "bbduk.sh", "bbmerge.sh", "tadpole.sh"]
    trim, filt, merge, tad = log
    assert {"ktrim=r", "k=23", "mink=7", "hdist=1", "tpe", "tbo", "ftm=5",
            "qtrim=r", "trimq=15"} <= set(trim)   # runECC.sh:198
    assert any(a.startswith("ref=") and "adapters.fa" in a for a in trim)
    assert any("sequencing_artifacts" in a and "phix174" in a for a in filt)
    assert {"ecco", "mix", "adapters=default"} <= set(merge)
    assert {"ecc", "prealloc", "prefilter=2", "tossjunk"} <= set(tad)
    # intermediates removed (runECC.sh:215)
    left = sorted(os.listdir(tmp_path / "wd"))
    assert left == ["tecc.ftl.trm.lib.fasta"]


def test_separated_pairs_branch(tmp_path, bbmap):
    """Pairs-only: R1/R2 separate through trim+filter, ONE pooled bbmerge
    (in=/in2= lists), ONE tadpole; outputs int.tecc.ftl.trm.<i>.<ext>
    (runECC.sh:263-300)."""
    p1 = _fa(tmp_path / "a_r1.fq", "a")
    p2 = _fa(tmp_path / "a_r2.fq", "b")
    q1 = _fa(tmp_path / "b_r1.fq", "c")
    q2 = _fa(tmp_path / "b_r2.fq", "d")
    log = []
    paired, single = run_preprocess(str(bbmap), str(tmp_path / "wd"),
                                    in1=[p1, q1], in2=[p2, q2],
                                    command_log=log)
    assert single == []
    assert [os.path.basename(p) for p in paired] == \
        ["int.tecc.ftl.trm.0.fq", "int.tecc.ftl.trm.1.fq"]
    tools = [os.path.basename(c[0]) for c in log]
    # per-pair trim+filter (2 bbduk each), then ONE bbmerge + ONE tadpole
    assert tools == ["bbduk.sh"] * 4 + ["bbmerge.sh", "tadpole.sh"]
    trim = log[0]
    assert "trimq=10" in trim                     # runECC.sh:263
    assert any(a.startswith("in2=") for a in trim)
    assert any(a.startswith("out2=") for a in trim)
    filt = log[1]
    assert any(a.startswith("out2=") for a in filt)   # stays separated
    merge = log[4]
    assert any(a.startswith("in2=") and "a_r2.fq" in a and "b_r2.fq" in a
               for a in merge)                    # pooled over both pairs


def test_in1_with_inP_rejected(tmp_path, bbmap):
    """The reference's branch ladder ends with 'Invalid combination of
    input files ... exit 1' for -in1/-in2 + -inP (runECC.sh final else)."""
    p1 = _fa(tmp_path / "r1.fq", "a")
    p2 = _fa(tmp_path / "r2.fq", "b")
    pi = _fa(tmp_path / "int.fa", "p")
    with pytest.raises(ValueError, match="cannot combine"):
        run_preprocess(str(bbmap), str(tmp_path / "wd"),
                       in1=[p1], in2=[p2], inP=[pi])


def test_separated_pairs_plus_singles(tmp_path, bbmap):
    """Pairs+singles: pairs interleave at filter (int.ftl.trm.<r1>), ONE
    bbmerge over all pair files, ONE tadpole ecc k=31 pooling pairs AND
    singles (the reference's P1/P2+SE branch)."""
    p1 = _fa(tmp_path / "a_r1.fq", "a")
    p2 = _fa(tmp_path / "a_r2.fq", "b")
    s = _fa(tmp_path / "se.fa", "s")
    log = []
    paired, single = run_preprocess(str(bbmap), str(tmp_path / "wd"),
                                    in1=[p1], in2=[p2], inS=[s],
                                    command_log=log)
    assert [os.path.basename(x) for x in paired] == \
        ["tecc.int.ftl.trm.a_r1.fq"]
    assert [os.path.basename(x) for x in single] == ["tecc.ftl.trm.se.fa"]
    tools = [os.path.basename(c[0]) for c in log]
    # pair trim+filter (2), single trim+filter (2), ONE bbmerge, ONE tadpole
    assert tools == ["bbduk.sh"] * 4 + ["bbmerge.sh", "tadpole.sh"]
    tad = log[-1]
    assert "k=31" in tad
    assert any(a.startswith("in=") and "ftl.trm.se.fa" in a for a in tad)


def test_single_end_branch(tmp_path, bbmap):
    s = _fa(tmp_path / "se.fa", "s")
    paired, single = run_preprocess(str(bbmap), str(tmp_path / "wd"),
                                    inS=[s])
    assert paired == []
    assert [os.path.basename(p) for p in single] == ["tecc.ftl.trm.se.fa"]


def test_mixed_paired_single(tmp_path, bbmap):
    p = _fa(tmp_path / "pe.fa", "p")
    s = _fa(tmp_path / "se.fa", "s")
    log = []
    paired, single = run_preprocess(str(bbmap), str(tmp_path / "wd"),
                                    inP=[p], inS=[s], command_log=log)
    assert [os.path.basename(x) for x in paired] == ["tecc.ftl.trm.pe.fa"]
    assert [os.path.basename(x) for x in single] == ["tecc.ftl.trm.se.fa"]
    tad = log[-1]
    assert os.path.basename(tad[0]) == "tadpole.sh"
    assert "k=31" in tad                          # runECC.sh:337
    # single-end filtered file rides the paired tadpole call
    assert any(a.startswith("in=") and "ftl.trm.se.fa" in a for a in tad)


def test_missing_bbtools(tmp_path):
    with pytest.raises(BBToolsNotFound):
        run_preprocess(str(tmp_path), str(tmp_path / "wd"),
                       inP=[_fa(tmp_path / "x.fa", "x")])


def test_cli_preprocess_and_ecc_assemble(tmp_path, bbmap):
    """End-to-end: `preprocess` subcommand, then `assemble -ecc` over the
    stub toolchain produces the same contigs as assembling the raw reads
    (stubs are copy-through)."""
    import shutil

    from conftest import GOLDEN, PARAM_FILES
    from disco_tpu.cli import main

    d = GOLDEN / "micro"
    reads = tmp_path / "reads.fasta"
    shutil.copy(d / "reads.fasta", reads)
    assert main(["preprocess", "-inS", str(reads), "-d",
                 str(tmp_path / "pp"), "-bbmap", str(bbmap)]) == 0
    assert (tmp_path / "pp" / "tecc.ftl.trm.reads.fasta").exists()

    out = tmp_path / "out"
    assert main(["assemble", "-inS", str(reads), "-d", str(out),
                 "-o", "m", "-ecc", "-bbmap", str(bbmap),
                 "-p", PARAM_FILES[0]]) == 0
    assert (out / "m_contigsFinalCombined.fasta").exists()
