"""disco-tpu command line: end-to-end assembly orchestration.

Replaces the reference's bash layer (runDisco.sh:26-257): graph construction
(buildG equivalent) -> graph simplification (fullsimplify equivalent) ->
combined contig/scaffold FASTAs, with the same directory layout
(<out>/graph/<prefix>_*, <out>/assembly/<prefix>_*) and per-iteration
parameter files.

Usage:
  python -m disco_tpu assemble -inP reads.fasta -d out -o prefix \
      -p disco.cfg [-p2 ...] [-p3 ...] [-m 30] [-obg|-osg] [-resimp]
  python -m disco_tpu stats contigs.fasta
"""
import argparse
import glob
import os
import shutil
import sys


def _cfg_min_overlap(path: str, default: int = 30) -> int:
    try:
        with open(path) as f:
            for line in f:
                t = line.strip()
                if t.startswith("MinOverlap4BuildGraph") and "=" in t:
                    return int(t.split("=")[1].split()[0])
    except OSError:
        pass
    return default


def _prepare_devices(n: int) -> None:
    """With JAX_PLATFORMS=cpu, give the CPU backend n virtual devices so
    -n runs on a virtual mesh (testing).  Must run before the first jax
    import (the flag is read at backend init).  On an accelerator the
    real devices are used and nothing is set."""
    if n <= 1 or "jax" in sys.modules:
        return
    if os.environ.get("JAX_PLATFORMS") != "cpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}").strip()


def _mesh(n: int):
    """n-device 1D mesh for the distributed builder (runDisco-MPI's -n,
    reference: runDisco-MPI.sh:214 `mpirun -np N`).  Refuses to run when
    the platform has fewer than n devices: an accelerator run never moves
    to CPU devices."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < n:
        if devs[0].platform != "cpu":
            raise SystemExit(
                f"-n {n}: platform '{devs[0].platform}' has only "
                f"{len(devs)} device(s); pass -n {len(devs)} or fewer.")
        raise SystemExit(
            f"-n {n}: only {len(devs)} CPU devices visible. For CPU testing "
            f"set JAX_PLATFORMS=cpu (assemble/buildg then create {n} "
            "virtual devices).")
    return Mesh(np.array(devs[:n]), ("dp",))


def cmd_assemble(args) -> int:
    if args.backend:
        os.environ["DISCO_TPU_BACKEND"] = args.backend
    if args.n and args.n > 1:
        _prepare_devices(args.n)
    from .buildg.pipeline import run_buildg
    from .simplify.driver import run_fullsimplify

    pair_files = []
    if args.in1 and args.in2:
        pair_files = [args.in1, args.in2]
    inter_files = args.inP.split(",") if args.inP else []
    single_files = args.inS.split(",") if args.inS else []
    if not (pair_files or inter_files or single_files):
        print("No input files specified (-in1/-in2, -inP, -inS).",
              file=sys.stderr)
        return 1

    out = args.d
    if args.ecc:
        # preprocessing layer (runAssembly.sh:195-430): BBTools trim/filter/
        # error-correct, then assemble the corrected reads
        from .preprocess import run_preprocess
        if not args.bbmap:
            print("assemble -ecc: -bbmap <BBTools dir> required",
                  file=sys.stderr)
            return 1
        ecc_dir = os.path.join(out, "ecc")
        paired, singles = run_preprocess(
            args.bbmap, ecc_dir,
            in1=[args.in1] if args.in1 else [],
            in2=[args.in2] if args.in2 else [],
            inP=inter_files, inS=single_files,
            threads=args.ecc_t or None, mem_gb=args.ecc_m or None)
        pair_files, inter_files, single_files = [], paired, singles
    os.makedirs(os.path.join(out, "graph"), exist_ok=True)
    asm_dir = os.path.join(out, "assembly")
    if os.path.isdir(asm_dir) and args.resimp:
        shutil.rmtree(asm_dir)
    os.makedirs(asm_dir, exist_ok=True)

    graph_prefix = os.path.join(out, "graph", args.o)
    asm_prefix = os.path.join(out, "assembly", args.o)
    min_ovl = _cfg_min_overlap(args.p) if args.p else args.m

    # buildG phase: interleaved + separated pairs are "paired" inputs,
    # singles are single (reference: runDisco.sh:195-257)
    if not args.osg:
        buildg_paired = inter_files + pair_files
        if args.n and args.n > 1:
            # distributed graph construction over an n-device mesh
            # (buildG-MPI / buildG-MPIRMA equivalent; -rma is accepted for
            # runDisco-MPI.sh parity — both reference modes map to the one
            # deterministic sharded engine, docs/MULTIHOST.md)
            from .dist.builder import run_buildg_sharded
            run_buildg_sharded(buildg_paired, single_files, graph_prefix,
                               _mesh(args.n), min_overlap=min_ovl,
                               write_par_graph_size=args.write_par_graph_size,
                               dist_mem=args.rma)
        else:
            run_buildg(buildg_paired, single_files, graph_prefix,
                       min_overlap=min_ovl,
                       write_par_graph_size=args.write_par_graph_size)

    if not args.obg:
        edge_files = sorted(glob.glob(graph_prefix + "_*_parGraph.txt"))
        crd_files = sorted(glob.glob(graph_prefix + "_*_containedReads.txt"))
        param_files = [p for p in (args.p, args.p2 or args.p,
                                   args.p3 or args.p2 or args.p) if p]
        run_fullsimplify(single_files, pair_files, inter_files, edge_files,
                         crd_files, asm_prefix,
                         param_files=param_files or None)
        for kind in ("contigs", "scaffolds"):
            parts = sorted(glob.glob(f"{asm_prefix}_{kind}Final_*.fasta"))
            combined = f"{asm_prefix}_{kind}FinalCombined.fasta"
            with open(combined, "w") as outf:
                for p in parts:
                    with open(p) as inf:
                        shutil.copyfileobj(inf, outf)
            shutil.copy(combined, out)
    return 0


def _par_graph_size(mem_gb: int, threads: int) -> int:
    """The reference's memory-based chunk-size rule: per-thread GB bands
    [20,inf)->80000, [10,20)->40000, [5,10)->20000, (0,5)->1000
    (reference: src/BuildGraph/src/OverlapGraph.cpp:67-81, Common.h:51-54;
    the reference subtracts current RSS first — negligible at GB scale)."""
    per_thread_mb = mem_gb * 1024 // max(threads, 1)
    if per_thread_mb >= 20 * 1024:
        return 80000
    if per_thread_mb >= 10 * 1024:
        return 40000
    if per_thread_mb >= 5 * 1024:
        return 20000
    return 1000


def cmd_buildg(args) -> int:
    """`buildG` executable equivalent (reference CLI:
    src/BuildGraph/src/main.cpp:95-148 — -pe/-se comma lists, -f prefix,
    -p cfg with MinOverlap4BuildGraph, -m memory budget (sets the parGraph
    chunk size exactly like the reference), -w explicit chunk override;
    -t accepted for compatibility, scheduling is device-driven here)."""
    if args.backend:
        os.environ["DISCO_TPU_BACKEND"] = args.backend
    if args.n and args.n > 1:
        _prepare_devices(args.n)
    from .buildg.pipeline import run_buildg

    paired = args.pe.split(",") if args.pe else []
    single = args.se.split(",") if args.se else []
    if not (paired or single):
        print("buildg: no input files (-pe/-se)", file=sys.stderr)
        return 1
    min_ovl = _cfg_min_overlap(args.p) if args.p else args.m_ovl
    wsize = args.w or (_par_graph_size(args.m, args.t or 1)
                       if args.m else 1000)
    if args.n and args.n > 1:
        from .dist.builder import run_buildg_sharded
        run_buildg_sharded(paired, single, args.f, _mesh(args.n),
                           min_overlap=min_ovl, write_par_graph_size=wsize,
                           dist_mem=args.rma)
    else:
        run_buildg(paired, single, args.f, min_overlap=min_ovl,
                   write_par_graph_size=wsize, max_mem_gb=args.m)
    return 0


def cmd_preprocess(args) -> int:
    """runECC.sh equivalent: BBTools trim/filter/error-correct; prints the
    corrected file lists (reference: runECC.sh:180-440)."""
    from .preprocess import run_preprocess
    paired, single = run_preprocess(
        args.bbmap, args.d,
        in1=args.in1.split(",") if args.in1 else [],
        in2=args.in2.split(",") if args.in2 else [],
        inP=args.inP.split(",") if args.inP else [],
        inS=args.inS.split(",") if args.inS else [],
        threads=args.n or None, mem_gb=args.m or None,
        keep_intermediates=args.keep)
    if paired:
        print("paired:", ",".join(paired))
    if single:
        print("single:", ",".join(single))
    return 0


def cmd_simplify(args) -> int:
    """`fullsimplify` executable equivalent (reference CLI:
    src/SimplifyGraph/src/Config.cpp:198-288)."""
    from .simplify.driver import run_fullsimplify
    from .utils.logging import set_level

    if args.log:
        set_level(args.log)
    run_fullsimplify(
        args.fs.split(",") if args.fs else [],
        args.fp.split(",") if args.fp else [],
        args.fpi.split(",") if args.fpi else [],
        args.e.split(",") if args.e else [],
        args.crd.split(",") if args.crd else [],
        args.o,
        param_files=[p for p in (args.p, args.p2, args.p3) if p] or None,
        sim_path=args.simPth)
    return 0


def cmd_parsimplify(args) -> int:
    """`parsimplify` executable equivalent (reference CLI:
    src/SimplifyGraph/src/mainParSimplify.cpp:13-17 — positional
    edgeFile outFile minOvl threads)."""
    from .native import parsimplify_run
    parsimplify_run(args.edge_file, args.out_file, args.min_ovl)
    return 0


def cmd_stats(args) -> int:
    """`assemblyStats.py` equivalent. With --mode, writes the reference's
    <base>.stat.txt (+ .filtered.fasta under cutoffs,
    reference: assemblyStats.py:27-35,202-470); without, prints a summary."""
    from .utils.stats import (assembly_stats, denovo_stat_file, format_stats,
                              mapped_stat_file)
    if args.mode == "denovo":
        path = denovo_stat_file(args.fasta, min_len=args.min_len)
        print(path)
    elif args.mode == "mapped":
        if not args.ref:
            print("stats mapped: -r reference fasta required",
                  file=sys.stderr)
            return 1
        path = mapped_stat_file(args.fasta, args.ref, min_len=args.min_len,
                                map_quality=args.q)
        print(path)
    else:
        st = assembly_stats(args.fasta, min_len=args.min_len)
        print(format_stats(st))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="disco-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("assemble", help="end-to-end assembly")
    a.add_argument("-in1", help="forward paired read file")
    a.add_argument("-in2", help="reverse paired read file")
    a.add_argument("-inP", help="interleaved paired read file(s), comma-sep")
    a.add_argument("-inS", help="single read file(s), comma-sep")
    a.add_argument("-d", required=True, help="output directory")
    a.add_argument("-o", required=True, help="output prefix")
    a.add_argument("-p", help="parameter cfg (iteration 1)")
    a.add_argument("-p2", help="parameter cfg (iteration 2)")
    a.add_argument("-p3", help="parameter cfg (iteration 3)")
    a.add_argument("-m", type=int, default=30,
                   help="min overlap for graph build (if no cfg)")
    a.add_argument("-obg", action="store_true",
                   help="only build graph, skip simplification")
    a.add_argument("-osg", action="store_true",
                   help="only simplify (graph files must exist)")
    a.add_argument("-resimp", action="store_true",
                   help="nuke previous assembly dir and re-simplify")
    a.add_argument("-n", type=int, default=0,
                   help="devices for distributed graph build "
                        "(runDisco-MPI -n equivalent)")
    a.add_argument("-rma", action="store_true",
                   help="dist-mem mode (buildG-MPIRMA equivalent): partition "
                        "the packed read payload across the mesh; per-device "
                        "memory O(N/n). Default replicates the payload "
                        "(buildG-MPI equivalent)")
    a.add_argument("-ecc", action="store_true",
                   help="BBTools preprocessing before assembly "
                        "(runAssembly.sh equivalent; needs -bbmap)")
    a.add_argument("-bbmap", help="BBTools install dir (for -ecc)")
    a.add_argument("-ecc-t", dest="ecc_t", type=int, default=0,
                   help="BBTools threads for -ecc (t=N); distinct from -n, "
                        "the device count")
    a.add_argument("-ecc-m", dest="ecc_m", type=int, default=0,
                   help="BBTools max memory GB for -ecc (-Xmx)")
    a.add_argument("--write-par-graph-size", type=int, default=1000)
    a.add_argument("-backend", choices=["device", "native", "xla"],
                   help="overlap-phase engine: device (jit pipeline on the "
                        "accelerator; default when one is present), native "
                        "(C++/OpenMP host kernel; default on CPU-only), "
                        "xla (cross-check oracle)")
    a.set_defaults(fn=cmd_assemble)

    pp = sub.add_parser("preprocess",
                        help="BBTools trim/filter/error-correction "
                             "(runECC.sh equivalent)")
    pp.add_argument("-in1", help="forward paired read file(s), comma-sep")
    pp.add_argument("-in2", help="reverse paired read file(s), comma-sep")
    pp.add_argument("-inP", help="interleaved paired read file(s), comma-sep")
    pp.add_argument("-inS", help="single read file(s), comma-sep")
    pp.add_argument("-d", default=".", help="output directory")
    pp.add_argument("-bbmap", required=True, help="BBTools install dir")
    pp.add_argument("-n", type=int, default=0, help="threads (t=N)")
    pp.add_argument("-m", type=int, default=0, help="max memory GB (-Xmx)")
    pp.add_argument("--keep", action="store_true",
                    help="keep intermediate trm./ftl. files")
    pp.set_defaults(fn=cmd_preprocess)

    b = sub.add_parser("buildg", help="graph construction (buildG)")
    b.add_argument("-pe", help="paired-end file(s), comma-sep")
    b.add_argument("-se", help="single-end file(s), comma-sep")
    b.add_argument("-f", required=True, help="output file prefix")
    b.add_argument("-p", help="parameter cfg (MinOverlap4BuildGraph)")
    b.add_argument("-m-ovl", dest="m_ovl", type=int, default=30,
                   help="min overlap if no cfg")
    b.add_argument("-t", type=int, default=0,
                   help="threads (enters the -m chunk-size rule only)")
    b.add_argument("-m", type=int, default=0,
                   help="max memory GB; sets the parGraph chunk size via "
                        "the reference's per-thread bands (-m 8 -> 20000)")
    b.add_argument("-w", type=int, default=0,
                   help="explicit par-graph chunk size (writeParGraphSize); "
                        "overrides -m (default 1000 if neither given)")
    b.add_argument("-n", type=int, default=0,
                   help="devices for distributed build (buildG-MPI/-MPIRMA "
                        "equivalent)")
    b.add_argument("-backend", choices=["device", "native", "xla"],
                   help="overlap-phase engine (see assemble -backend)")
    b.add_argument("-rma", action="store_true",
                   help="dist-mem mode: partition the read payload across "
                        "the -n device mesh (buildG-MPIRMA equivalent)")
    b.set_defaults(fn=cmd_buildg)

    fsim = sub.add_parser("simplify",
                          help="graph simplification (fullsimplify)")
    fsim.add_argument("-fs", help="single read file(s), comma-sep")
    fsim.add_argument("-fp", help="separated paired read file(s), comma-sep")
    fsim.add_argument("-fpi", help="interleaved paired file(s), comma-sep")
    fsim.add_argument("-e", help="edge file(s), comma-sep")
    fsim.add_argument("-crd", help="contained-read file(s), comma-sep")
    fsim.add_argument("-o", required=True, help="output prefix")
    fsim.add_argument("-p", help="parameter cfg (iteration 1)")
    fsim.add_argument("-p2", help="parameter cfg (iteration 2)")
    fsim.add_argument("-p3", help="parameter cfg (iteration 3)")
    fsim.add_argument("-simPth",
                      help="dir with test/<thresh>.txt post-processing "
                           "tables (parsimplify runs in-process)")
    fsim.add_argument("-t", type=int, default=0, help="accepted, unused")
    fsim.add_argument("-log", help="log level (ERROR..DEBUG4)")
    fsim.set_defaults(fn=cmd_simplify)

    ps = sub.add_parser("parsimplify",
                        help="partial-graph simplification (parsimplify)")
    ps.add_argument("edge_file")
    ps.add_argument("out_file")
    ps.add_argument("min_ovl", type=int)
    ps.add_argument("threads", type=int, nargs="?", default=1)
    ps.set_defaults(fn=cmd_parsimplify)

    s = sub.add_parser("stats", help="assembly N50/size statistics "
                                     "(assemblyStats.py equivalent)")
    s.add_argument("mode", nargs="?", choices=["denovo", "mapped"],
                   help="write <base>.stat.txt like the reference; "
                        "omit for a quick summary to stdout")
    s.add_argument("fasta")
    s.add_argument("-r", "--ref", help="reference fasta (mapped mode)")
    s.add_argument("-q", type=float, default=0.0,
                   help="min mapping rate 1-(edit/mapped) (mapped mode)")
    s.add_argument("-m", "--min-len", type=int, default=0)
    s.set_defaults(fn=cmd_stats)

    args = ap.parse_args(argv)
    # profiler wrap (the reference ships runDisco-MPI-AllineaMAP.sh to run
    # under the Allinea MAP profiler; the analog here is a JAX/XLA
    # profiler trace viewable in TensorBoard/Perfetto)
    trace_dir = os.environ.get("DISCO_TPU_TRACE")
    if trace_dir:
        import jax
        with jax.profiler.trace(trace_dir):
            return args.fn(args)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
