"""End-to-end preprocessing with STUB BBTools binaries: real subprocess
execution of the bbduk/bbmerge/tadpole ladder (catching quoting/path bugs
the command-shape tests cannot), then `assemble -ecc` straight through to
combined contig/scaffold FASTAs."""
import os
import pathlib
import stat
import subprocess

import pytest

from conftest import GOLDEN, PARAM_FILES

STUB = """#!/usr/bin/env bash
# stub BBTools: record the invocation, copy in->out positionally
set -eu
echo "$(basename "$0") $*" >> "${STUB_LOG:?}"
ins=(); in2s=(); outs=(); out2s=()
for a in "$@"; do
  case "$a" in
    in=*)   IFS=, read -ra ins  <<< "${a#in=}";;
    in2=*)  IFS=, read -ra in2s <<< "${a#in2=}";;
    out=*)  IFS=, read -ra outs <<< "${a#out=}";;
    out2=*) IFS=, read -ra out2s <<< "${a#out2=}";;
  esac
done
for i in "${!outs[@]}"; do cp "${ins[$i]}" "${outs[$i]}"; done
for i in "${!out2s[@]}"; do cp "${in2s[$i]}" "${out2s[$i]}"; done
"""


@pytest.fixture
def stub_bbmap(tmp_path):
    bb = tmp_path / "bbmap"
    (bb / "resources").mkdir(parents=True)
    # resource refs passed via ref=...; stubs never read them but the
    # paths appear in the commands
    for r in ("adapters.fa", "sequencing_artifacts.fa.gz",
              "phix174_ill.ref.fa.gz"):
        (bb / "resources" / r).write_bytes(b"")
    for tool in ("bbduk.sh", "bbmerge.sh", "tadpole.sh"):
        p = bb / tool
        p.write_text(STUB)
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    return bb


def test_preprocess_subprocess_ladder(stub_bbmap, tmp_path):
    """run_preprocess executes the real subprocess path; the stub log shows
    the reference's trim -> filter -> bbmerge ecco -> tadpole ecc ladder
    (reference: runECC.sh:196-213)."""
    from disco_tpu.preprocess import run_preprocess

    log = tmp_path / "stub.log"
    os.environ["STUB_LOG"] = str(log)
    reads = GOLDEN / "mini" / "reads.fasta"
    paired, single = run_preprocess(str(stub_bbmap), str(tmp_path / "ecc"),
                                    inP=[str(reads)])
    assert len(paired) == 1 and not single
    out = pathlib.Path(paired[0])
    assert out.exists()
    assert out.read_bytes() == reads.read_bytes()  # stubs copy through
    calls = log.read_text().splitlines()
    tools = [c.split()[0] for c in calls]
    assert tools == ["bbduk.sh", "bbduk.sh", "bbmerge.sh", "tadpole.sh"]
    assert "trimq=15" in calls[0] and "ktrim=r" in calls[0]
    assert "ecco" in calls[2] and "ecc" in calls[3].split()
    # intermediates cleaned up like the reference's rm lines
    leftovers = [p.name for p in (tmp_path / "ecc").iterdir()
                 if p.name.startswith(("trm.", "ftl.", "bbmecc."))]
    assert leftovers == []


def test_assemble_ecc_to_contigs(stub_bbmap, tmp_path):
    """CLI assemble -ecc: preprocessing (stub subprocesses) feeding the real
    assembler through to combined FASTAs (reference: runAssembly.sh)."""
    from disco_tpu.cli import main

    log = tmp_path / "stub.log"
    os.environ["STUB_LOG"] = str(log)
    reads = GOLDEN / "mini" / "reads.fasta"
    out = tmp_path / "asm"
    rc = main(["assemble", "-inP", str(reads), "-d", str(out), "-o", "mini",
               "-p", PARAM_FILES[0], "-p2", PARAM_FILES[1],
               "-p3", PARAM_FILES[2],
               "-ecc", "-bbmap", str(stub_bbmap)])
    assert rc == 0
    assert log.exists() and len(log.read_text().splitlines()) == 4
    # with the reference cfgs only scaffolds are emitted as *Final_* (the
    # golden mini/simplify dir has no contigsFinal either); the combined
    # contig file exists but is empty, exactly like runDisco.sh's cat of
    # an empty glob
    combined = out / "mini_scaffoldsFinalCombined.fasta"
    assert combined.exists() and combined.stat().st_size > 0
    assert (out / "mini_contigsFinalCombined.fasta").exists()
