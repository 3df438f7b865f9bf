"""Multi-process (multi-host) distributed buildG.

The equivalent of the reference's real multi-node MPI execution
(reference: runDisco-MPI.sh:214 `mpirun -np N buildG-MPI ...`):

- every process calls `jax.distributed.initialize()` (the MPI_Init
  equivalent) and participates in one global device mesh;
- every process parses every input file and builds the store/table
  host-side — exactly the reference's replicated-parse design
  (reference: src/BuildGraphMPI/src/HashTable.cpp:53, every rank builds
  the full table; src/BuildGraphMPIRMA parses everything and keeps only
  its in-range records);
- per superstep chunk, each process contributes its slice of the query
  axis via `jax.make_array_from_process_local_data`, the SPMD step runs
  over the global mesh (all_to_all over NVLink within a host, the network
  between hosts), and the per-query hit
  grids are gathered back to every process with
  `multihost_utils.process_allgather`;
- process 0 runs the (deterministic) sequential replay and writes the
  output files; everyone joins a final barrier.

Outputs are byte-identical to the single-process builder by construction
— unlike the reference, whose multi-process output depends on rank/thread
scheduling (SURVEY.md §4).

Launch (per process):
  python -m disco_tpu.dist.multiproc --coordinator HOST:PORT \
      --num-processes N --process-id I [--local-device G] \
      -pe reads.fasta -f PREFIX [-rma]
Under srun or mpirun the coordinator, process count and id come from the
scheduler's environment (`derive_cluster_env`).  With several processes on
one host each process must own one GPU: --local-device, SLURM_LOCALID or
OMPI_COMM_WORLD_LOCAL_RANK names it; otherwise every process would claim
every visible card.
"""
import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np


def _global_arrays(mesh, pspec_tree, host_tree):
    """Build global jax.Arrays from process-local host data.  For a sharded
    spec, `host` must be this process's contiguous slice (process-major
    device order); for a replicated spec, the full array."""
    import jax
    from jax.sharding import NamedSharding

    out = []
    for pspec, host in zip(pspec_tree, host_tree):
        sharding = NamedSharding(mesh, pspec)
        out.append(jax.make_array_from_process_local_data(sharding, host))
    return out


def sharded_relation_multiproc(store, table, mesh,
                               hit_cap: Optional[int] = None,
                               route_cap: Optional[int] = None,
                               budget: int = 1 << 25,
                               dist_mem: bool = False):
    """Multi-process version of dist.builder.sharded_relation: identical
    chunking and engines, but all SPMD inputs are global arrays assembled
    from process-local shards, and the hit grids are allgathered so every
    process can run the same deterministic compaction."""
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from ..overlap.relation import OverlapRelation, window_codes
    from ..overlap.verify import make_packed_all
    from .overlap_shard import DistMemOverlapEngine, ShardedOverlapEngine

    n_dev = mesh.devices.size
    nproc = jax.process_count()
    pid = jax.process_index()
    qread, qj, qcode = window_codes(store, table.k)
    q = len(qread)
    if hit_cap is None:
        _, counts = np.unique(table.keys, return_counts=True)
        hit_cap = max(int(counts.max()) if len(counts) else 1, 1)
    chunk = max(budget // hit_cap, n_dev)
    chunk = min(chunk, -(-q // n_dev) * n_dev)
    chunk = -(-chunk // n_dev) * n_dev
    if route_cap is None:
        route_cap = -(-(chunk // n_dev) // 8) * 8

    if dist_mem:
        eng = DistMemOverlapEngine.build(store, table, mesh,
                                         hit_cap=hit_cap,
                                         route_cap=route_cap)
        eng._resolve_fetch_cap(chunk)
        packed_sh, packed_rc_sh, block = eng.shard_payload(store, n_dev)
        fn = jax.jit(eng.shard_fn(store.n_reads, block))

        def payload_slices():
            rows = packed_sh.shape[0] // nproc
            return [packed_sh[pid * rows:(pid + 1) * rows],
                    packed_rc_sh[pid * rows:(pid + 1) * rows]]
        payload_specs = [P("dp"), P("dp")]
    else:
        eng = ShardedOverlapEngine.build(store, table, mesh,
                                         hit_cap=hit_cap,
                                         route_cap=route_cap)
        fn = jax.jit(eng.shard_fn())
        packed_all = np.asarray(make_packed_all(store.packed,
                                                store.packed_rc))

        def payload_slices():
            return [packed_all]
        payload_specs = [P()]

    # table shards: process-local device rows of the (n_dev, M) arrays.
    # The per-process slicing below assumes every process contributes the
    # same device count — fail loudly instead of mis-slicing otherwise.
    if n_dev % nproc != 0:
        raise SystemExit(
            f"multiproc: {n_dev} devices across {nproc} processes is not an "
            f"even split; each process must contribute n_dev/nproc devices")
    if jax.local_device_count() * nproc != n_dev:
        raise SystemExit(
            f"multiproc: local device count {jax.local_device_count()} != "
            f"{n_dev}/{nproc} — uneven per-process device counts are not "
            "supported")
    dpp = n_dev // nproc
    tslice = slice(pid * dpp, (pid + 1) * dpp)
    table_local = [eng.keys[tslice], eng.read[tslice], eng.orient[tslice],
                   eng.typ[tslice], eng.sizes[tslice]]
    table_specs = [P("dp")] * 5

    lengths = np.asarray(store.lengths, np.int32)
    marked = np.zeros(store.n_reads, np.int32)
    marked = np.pad(marked, (0, (-len(marked)) % n_dev))
    mrows = len(marked) // nproc

    const_global = _global_arrays(
        mesh,
        payload_specs + [P()] + table_specs + [P("dp")],
        payload_slices() + [lengths] + table_local
        + [marked[pid * mrows:(pid + 1) * mrows]])
    payload_g = const_global[:len(payload_specs)]
    lengths_g = const_global[len(payload_specs)]
    table_g = const_global[len(payload_specs) + 1:-1]
    marked_g = const_global[-1]

    parts = {k: [] for k in ("r1", "j", "r2", "orient", "typ", "edge",
                             "cont")}

    def collect(s, e, out):
        r2, orient, typ, edge_ok, cont_ok, overflow, _unions = out
        if int(np.asarray(overflow).sum()) != 0:
            raise RuntimeError(
                "sharded overlap overflow: raise hit_cap/route_cap "
                "(dist-mem mode: the counter also includes fetch-exchange "
                "overflow governed by fetch_cap)")
        n = e - s
        r2 = r2[:n]
        orient = orient[:n]
        typ = typ[:n]
        edge_ok = edge_ok[:n]
        cont_ok = cont_ok[:n]
        keep = edge_ok | cont_ok
        qi, hi = np.nonzero(keep)
        parts["r1"].append(qread[s:e][qi].astype(np.int32))
        parts["j"].append(qj[s:e][qi])
        parts["r2"].append(r2[qi, hi].astype(np.int32))
        parts["orient"].append(orient[qi, hi].astype(np.int8))
        parts["typ"].append(typ[qi, hi].astype(np.int8))
        parts["edge"].append(edge_ok[qi, hi])
        parts["cont"].append(cont_ok[qi, hi])

    rows_pp = chunk // nproc
    for s in range(0, q, chunk):
        e = min(s + chunk, q)
        pad = chunk - (e - s)
        qread_p = np.pad(qread[s:e], (0, pad))
        qj_p = np.pad(qj[s:e], (0, pad), constant_values=-1)
        qcode_p = np.pad(qcode[s:e], (0, pad),
                         constant_values=np.uint64(0xFFFFFFFFFFFFFFFF))
        qs = slice(pid * rows_pp, (pid + 1) * rows_pp)
        q_g = _global_arrays(mesh, [P("dp")] * 3,
                             [qread_p[qs], qj_p[qs], qcode_p[qs]])
        out = fn(*payload_g, lengths_g, *q_g, marked_g, *table_g)
        out = multihost_utils.process_allgather(out, tiled=True)
        collect(s, e, out)

    def cat(name, dtype):
        if not parts[name]:
            return np.zeros(0, dtype)
        return np.concatenate(parts[name]).astype(dtype, copy=False)

    r1f = cat("r1", np.int32)
    r2f = cat("r2", np.int32)
    fidx2 = store.file_index[r2f]
    jf = cat("j", np.int32)
    tf = cat("typ", np.int8)
    order = np.lexsort((tf, fidx2, jf, r1f))
    return OverlapRelation(
        r1=r1f[order], j=jf[order], r2=r2f[order],
        orient=cat("orient", np.int8)[order], typ=tf[order],
        cont_ok=cat("cont", np.bool_)[order],
        edge_ok=cat("edge", np.bool_)[order], k=table.k)


def run_buildg_multiproc(paired_files: Sequence[str],
                         single_files: Sequence[str], prefix: str,
                         min_overlap: int = 30,
                         write_par_graph_size: int = 1000,
                         dist_mem: bool = False):
    """Distributed buildG across the already-initialized process group
    (call jax.distributed.initialize first).  Process 0 writes the output
    files; all processes return (store, relation, superread)."""
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh

    from ..buildg import replay
    from ..index.table import FingerprintTable
    from ..io.readstore import ReadStore

    pid = jax.process_index()
    mesh = Mesh(np.array(jax.devices()), ("dp",))
    store = ReadStore.from_files(
        paired_files, single_files, min_overlap,
        id_map_path=(prefix + "_ReadIDMap.txt" if pid == 0 else None))
    table = FingerprintTable.build(store, min_overlap - 1)
    rel = sharded_relation_multiproc(store, table, mesh, dist_mem=dist_mem)

    # the replay is deterministic and cheap relative to the overlap phase;
    # every process computes it (avoiding a broadcast), process 0 writes
    superread, cont_lines = replay.containment_replay(rel, store)
    par_blob, start_blob, _ = replay.build_graph_replay_native(
        rel, store, superread, write_par_graph_size)
    if pid == 0:
        with open(prefix + "_0_containedReads.txt", "w") as f:
            for ln in cont_lines:
                f.write(ln + "\n")
        with open(prefix + "_0_parGraph.txt", "wb") as f:
            f.write(par_blob)
        with open(prefix + "_CheckpointInfo.txt", "w") as f:
            f.write("CCR=Complete\nGC=Complete\n")
        with open(prefix + "_0_startRead.txt", "wb") as f:
            f.write(start_blob)
    multihost_utils.sync_global_devices("buildg_multiproc_done")
    return store, rel, superread


def first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM compact nodelist: 'node[003-006,010],gpu7'
    -> 'node003'.  Only the first element is needed (the coordinator)."""
    head = nodelist.split(",")[0]
    if "[" not in head:
        return head
    prefix, _, spec = head.partition("[")
    first = spec.rstrip("]").split(",")[0].split("-")[0]
    return prefix + first


def derive_cluster_env(env=None):
    """Derive (coordinator, num_processes, process_id) from scheduler
    environment variables when they were not given explicitly — the
    equivalent of the reference's scheduler launch wrappers
    (runDisco-MPI-SLURM.sh:214 `srun`, runDisco-MPI-ALPS.sh `aprun`).

    Recognized: SLURM (srun: SLURM_PROCID/SLURM_NTASKS/SLURM_NODELIST),
    OpenMPI mpirun (OMPI_COMM_WORLD_RANK/_SIZE + coordinator from
    DISCO_TPU_COORDINATOR).  Returns (None, None, None) when nothing is
    recognized; jax.distributed.initialize() then applies its own cluster
    auto-detection, or fails if there is none."""
    env = os.environ if env is None else env
    port = env.get("DISCO_TPU_PORT", "8476")
    if "SLURM_PROCID" in env:
        n = int(env.get("SLURM_STEP_NUM_TASKS", env.get("SLURM_NTASKS", 1)))
        pid = int(env["SLURM_PROCID"])
        nodelist = env.get("SLURM_STEP_NODELIST",
                           env.get("SLURM_JOB_NODELIST", ""))
        coord = env.get("DISCO_TPU_COORDINATOR")
        if coord is None and nodelist:
            coord = f"{first_slurm_host(nodelist)}:{port}"
        return coord, n, pid
    if "OMPI_COMM_WORLD_RANK" in env:
        coord = env.get("DISCO_TPU_COORDINATOR")
        return (coord, int(env["OMPI_COMM_WORLD_SIZE"]),
                int(env["OMPI_COMM_WORLD_RANK"]))
    return None, None, None


def derive_local_rank(env=None) -> Optional[int]:
    """This process's rank among the processes of its host, from the
    scheduler (SLURM_LOCALID under srun, OMPI_COMM_WORLD_LOCAL_RANK under
    mpirun); None when neither is set.  It names the one GPU the process
    drives."""
    env = os.environ if env is None else env
    for name in ("SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if name in env:
            return int(env[name])
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="disco-tpu-multiproc",
        description="one process of a distributed buildG run")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0 (omit under srun/mpirun)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=0,
                    help="virtual CPU devices per process (testing)")
    ap.add_argument("--local-device", type=int, default=None,
                    help="id of the one local GPU this process drives "
                         "(default: SLURM_LOCALID / "
                         "OMPI_COMM_WORLD_LOCAL_RANK if set)")
    ap.add_argument("-pe", help="paired-end file(s), comma-sep")
    ap.add_argument("-se", help="single-end file(s), comma-sep")
    ap.add_argument("-f", required=True, help="output prefix")
    ap.add_argument("-m-ovl", dest="m_ovl", type=int, default=30)
    ap.add_argument("-w", type=int, default=1000)
    ap.add_argument("-rma", action="store_true",
                    help="dist-mem mode (partitioned read payload)")
    args = ap.parse_args(argv)

    if args.local_devices:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count="
                f"{args.local_devices}").strip()
        os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import jax
    coord, nproc, pid = args.coordinator, args.num_processes, args.process_id
    if coord is None and nproc is None and pid is None:
        # scheduler-launched (srun/mpirun): derive from env
        coord, nproc, pid = derive_cluster_env()
    local = (args.local_device if args.local_device is not None
             else derive_local_rank())
    if args.local_devices:
        local = None  # virtual CPU devices: the process owns all of them
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=nproc, process_id=pid,
        local_device_ids=None if local is None else [local])

    run_buildg_multiproc(
        args.pe.split(",") if args.pe else [],
        args.se.split(",") if args.se else [],
        args.f, min_overlap=args.m_ovl, write_par_graph_size=args.w,
        dist_mem=args.rma)
    return 0


if __name__ == "__main__":
    sys.exit(main())
