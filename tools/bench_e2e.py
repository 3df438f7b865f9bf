"""End-to-end buildG wall-clock benchmark: device backend vs native backend
(and optionally the reference binary) on a 4.6 Mb/30x isolate by default.

Usage: python tools/bench_e2e.py [--genome-len N] [--coverage C] [--ref]
Prints one JSON line.  Backends run one after another, each in its own
process, so one process at a time holds the accelerator.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--genome-len", type=int, default=4_600_000)
    ap.add_argument("--coverage", type=int, default=30)
    ap.add_argument("--read-len", type=int, default=250)
    ap.add_argument("--min-overlap", type=int, default=40)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--backends", default="device,native")
    ap.add_argument("--ref", action="store_true",
                    help="also time the reference buildG -t 1")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "reads.fasta")
        subprocess.run(
            [sys.executable, str(ROOT / "tools" / "make_testdata.py"), fasta,
             "--genome-len", str(args.genome_len),
             "--coverage", str(args.coverage),
             "--read-len", str(args.read_len), "--insert", "600",
             "--seed", str(args.seed)],
            check=True, stdout=subprocess.DEVNULL)

        results = {}
        outputs = {}
        for backend in args.backends.split(","):
            # fresh subprocess per backend: separate jax platform init and
            # honest cold-to-warm accounting
            t0 = time.perf_counter()
            subprocess.run(
                [sys.executable, "-m", "disco_tpu", "buildg",
                 "-pe", fasta, "-f", os.path.join(td, backend),
                 "-backend", backend, "-m-ovl", str(args.min_overlap)],
                check=True, cwd=td,
                env={**os.environ,
                     "PYTHONPATH": str(ROOT) + ":"
                     + os.environ.get("PYTHONPATH", "")})
            results[backend] = round(time.perf_counter() - t0, 2)
            outputs[backend] = pathlib.Path(
                td, f"{backend}_0_parGraph.txt").read_bytes()

        vals = list(outputs.values())
        identical = all(v == vals[0] for v in vals)

        if args.ref:
            cfg = os.path.join(td, "b.cfg")
            with open(cfg, "w") as f:
                f.write(f"MinOverlap4BuildGraph = {args.min_overlap}\n")
            t0 = time.perf_counter()
            subprocess.run(
                [str(ROOT / "refbuild" / "buildG"), "-pe", fasta, "-f",
                 os.path.join(td, "REF"), "-p", cfg, "-t", "1", "-m", "4"],
                check=True, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
            results["reference_t1"] = round(time.perf_counter() - t0, 2)
            identical = identical and (
                pathlib.Path(td, "REF_0_parGraph.txt").read_bytes()
                == vals[0])

    payload = {"bench": "buildg_e2e_wall_s",
               "genome_len": args.genome_len,
               "coverage": args.coverage,
               "outputs_identical": identical, **results}
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
