"""GPU smoke run: `assemble` end to end on one card, checked.

Phases (any failure exits non-zero and prints no result):
  1. card      nvidia-smi name/power limit; JAX must report platform gpu.
  2. data      the E. coli-shaped isolate (4.6 Mb, 30x, 2x250 bp pairs,
               ~500 bp insert) from tools/make_testdata.py, seed 11.
  3. assemble  `python -m disco_tpu assemble` as the README documents it,
               with the committed parameter files and no -backend: the run
               must auto-select the device backend on the GPU.  Prints the
               wall time, per-stage clocks, the device relation's compile
               and steady chunk times and its cand_cap re-runs, and checks
               the largest scaffold covers >= 99% of the genome.
  4. reference `buildg -backend native` (the C++ host kernel) on the same
               reads: the buildG files must be byte-identical.
  5. verify    bench.py: the verify step on 2^20 real candidate pairs,
               exactly equal to verify_windows_gather and a numpy check.
  6. tests     `pytest -m gpu`.

`--four` runs instead only the four-card path (assemble -n 4 -obg, the same
with -rma, and dist.multiproc as four processes with one card each), each
byte-compared with `buildg -backend native`.

At most one process uses a card at any time: this parent never imports
JAX; each phase runs as a child process, one after another (the four
multiproc children each own one card).  The last line of standard output
is one JSON object with the device as JAX reports it.

Usage: python chip_smoke.py [--four]
"""
import argparse
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
GENOME_LEN = 4_600_000
DATA = ["--genome-len", str(GENOME_LEN), "--coverage", "30",
        "--read-len", "250", "--insert", "500", "--seed", "11"]
PARAMS = [str(ROOT / "tests" / "golden" / "params" / n)
          for n in ("disco.cfg", "disco_2.cfg", "disco_3.cfg")]
BUILDG_FILES = ("_0_parGraph.txt", "_0_containedReads.txt",
                "_ReadIDMap.txt")
TIMEOUT = 900

_PROBE = ("import json, jax; d = jax.devices(); print(json.dumps("
          "{'platform': d[0].platform, 'kind': d[0].device_kind, "
          "'count': len(d)}))")


class SmokeError(Exception):
    pass


def say(*a):
    print(*a, flush=True)


def run(cmd, cwd, env=None, host_only=False, timeout=TIMEOUT):
    """Run one child to its end; returns (seconds, stdout, stderr).  A
    host-only child gets JAX_PLATFORMS=cpu so it never opens a card."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    if host_only:
        env["JAX_PLATFORMS"] = "cpu"
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if p.returncode != 0:
        raise SmokeError(f"{' '.join(map(str, cmd))} exited "
                         f"{p.returncode}\n{p.stdout[-4000:]}"
                         f"\n{p.stderr[-4000:]}")
    return dt, p.stdout, p.stderr


def phase_card():
    say("== phase 1: card")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        raise SmokeError(f"nvidia-smi failed: {e}") from e
    say(card)  # name, power limit: as nvidia-smi prints them
    _, out, _ = run([sys.executable, "-c", _PROBE], ROOT)
    dev = json.loads(out.strip().splitlines()[-1])
    say(f"jax: platform={dev['platform']} device_kind={dev['kind']} "
        f"count={dev['count']}")
    if dev["platform"] != "gpu":
        raise SmokeError(f"JAX platform is {dev['platform']!r}, not gpu")
    return dev


def phase_data(work):
    say("== phase 2: data")
    dt, out, _ = run([sys.executable, str(ROOT / "tools" / "make_testdata.py"),
                      "reads.fasta", *DATA], work, host_only=True)
    say(out.strip())
    say(f"data: {dt:.3f}s")


def phase_native(work, prefix):
    """The reference buildG files, from the C++ host kernel."""
    os.makedirs(work / os.path.dirname(prefix), exist_ok=True)
    dt, _, _ = run([sys.executable, "-m", "disco_tpu", "buildg",
                    "-pe", "reads.fasta", "-m-ovl", "30",
                    "-backend", "native", "-f", prefix], work,
                   host_only=True)
    say(f"native buildg: {dt:.3f}s")


def compare(work, got_prefix, want_prefix, what):
    for suffix in BUILDG_FILES:
        got = (work / (got_prefix + suffix)).read_bytes()
        want = (work / (want_prefix + suffix)).read_bytes()
        if got != want:
            raise SmokeError(f"{what}: {got_prefix}{suffix} differs from "
                             f"the native backend's")
    say(f"{what}: {', '.join(BUILDG_FILES)} byte-identical to "
        "buildg -backend native")


def stats(path):
    _, out, _ = run([sys.executable, "-m", "disco_tpu", "stats", str(path)],
                    ROOT, host_only=True)
    vals = dict(re.findall(r"^([A-Za-z0-9 %]+):\s+(\S+)$", out, re.M))
    return {k.strip(): v for k, v in vals.items()}


def phase_assemble(work):
    say("== phase 3: assemble on the card")
    env = dict(os.environ, DISCO_TPU_LOG="INFO")
    cmd = [sys.executable, "-m", "disco_tpu", "assemble",
           "-inP", "reads.fasta", "-d", "out", "-o", "ecoli",
           "-p", PARAMS[0], "-p2", PARAMS[1], "-p3", PARAMS[2]]
    say("command: " + " ".join(cmd[1:]))
    dt, _, err = run(cmd, work, env=env)
    say(f"assemble wall: {dt:.3f}s")
    backend = re.findall(r"overlap backend: .*", err)
    for line in backend:
        say(line)
    if not any(b.startswith("overlap backend: device on gpu")
               for b in backend):
        raise SmokeError("assemble did not select the device backend on "
                         "the gpu")
    for line in re.findall(r"native: built .*", err):
        say(line)
    for line in re.findall(r"device relation: .*", err):
        say(line)
    for name, secs in re.findall(r"<<< (\w+)\(\): ([0-9.]+)s", err):
        say(f"clock {name}: {secs}s")
    out = work / "out"
    for kind in ("contigs", "scaffolds"):
        path = out / f"ecoli_{kind}FinalCombined.fasta"
        if not path.exists():
            raise SmokeError(f"missing {path.name}")
        st = stats(path)
        say(f"{kind}: n={st.get('contigs')} total={st.get('total length')} "
            f"N50={st.get('N50')} max={st.get('max length')}")
        if kind == "scaffolds":
            largest = int(st.get("max length", 0))
            share = largest / GENOME_LEN
            say(f"largest scaffold: {largest} bp = {100 * share:.3f}% of "
                f"the {GENOME_LEN} bp genome")
            if share < 0.99:
                raise SmokeError("largest scaffold covers < 99% of the "
                                 "genome")


def phase_verify(work):
    say("== phase 5: verify step against its references")
    _, out, _ = run([sys.executable, str(ROOT / "bench.py"),
                     "--reads", "reads.fasta"], work)
    lines = out.strip().splitlines()
    for line in lines[:-1]:
        say(line)
    res = json.loads(lines[-1])
    if not res.get("exact"):
        raise SmokeError("verify step differs from its references")
    say(f"verify: {res['pairs']} pairs exactly equal to "
        "verify_windows_gather and the numpy host check")
    say(f"verify step: compile+first {res['compile_and_first_s']:.3f}s, "
        f"median {res['median_s'] * 1e3:.3f} ms, "
        f"{res['value']:.4g} pairs/s")


def phase_tests():
    say("== phase 6: pytest -m gpu")
    _, out, _ = run([sys.executable, "-m", "pytest", "-m", "gpu", "-q",
                     "-rs", "-p", "no:cacheprovider", "tests/"], ROOT)
    summary = out.strip().splitlines()[-1]
    say(summary)
    if "passed" not in summary or re.search(r"skipped|failed|error",
                                            summary):
        raise SmokeError("pytest -m gpu did not pass every test")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_four(work):
    say("== four cards: -n 4, -n 4 -rma, 4-process multiproc")
    phase_native(work, "native/ecoli")
    for name, extra in (("replicated", []), ("dist-mem", ["-rma"])):
        cmd = [sys.executable, "-m", "disco_tpu", "assemble",
               "-inP", "reads.fasta", "-d", name, "-o", "ecoli",
               "-p", PARAMS[0], "-n", "4", "-obg", *extra]
        dt, _, _ = run(cmd, work)
        say(f"assemble -n 4 -obg {' '.join(extra)}: {dt:.3f}s")
        compare(work, f"{name}/graph/ecoli", "native/ecoli", name)
    os.makedirs(work / "mp", exist_ok=True)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "disco_tpu.dist.multiproc",
         "--coordinator", f"localhost:{port}", "--num-processes", "4",
         "--process-id", str(i), "--local-device", str(i),
         "-pe", "reads.fasta", "-f", "mp/ecoli", "-m-ovl", "30"],
        cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SmokeError(f"multiproc process {i} exited "
                             f"{p.returncode}\n{out[-4000:]}")
    say(f"multiproc 4 processes: {time.perf_counter() - t0:.3f}s")
    compare(work, "mp/ecoli", "native/ecoli", "multiproc")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path")
    args = ap.parse_args()
    try:
        if not (ROOT / "disco_tpu").is_dir():
            raise SmokeError(f"no disco_tpu package beside {__file__}; run "
                             "from a checkout of the repository")
        dev = phase_card()
        if args.four and dev["count"] != 4:
            raise SmokeError(f"--four needs 4 cards, JAX sees {dev['count']}")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
            work = pathlib.Path(td)
            phase_data(work)
            if args.four:
                phase_four(work)
            else:
                phase_assemble(work)
                say("== phase 4: native reference")
                phase_native(work, "native/ecoli")
                compare(work, "out/graph/ecoli", "native/ecoli", "assemble")
                phase_verify(work)
                phase_tests()
    except (SmokeError, subprocess.TimeoutExpired) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
