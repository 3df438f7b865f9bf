"""Distributed graph construction: the BuildGraphMPI / BuildGraphMPIRMA
equivalent (reference: src/BuildGraphMPI/, src/BuildGraphMPIRMA/).

The overlap relation is computed on an n-device mesh via the sharded
superstep (query axis data-parallel, fingerprint table hash-sharded,
all_to_all candidate routing) and assembled into the SAME deterministic
relation order as the single-device host path, so the sequential replay emits
output files byte-identical to a single-process reference run — by
construction, unlike the reference whose multi-process output depends on
rank/thread scheduling (SURVEY.md §4)."""
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..overlap.relation import (OverlapRelation, _xla_rows, window_codes)
from ..overlap.verify import make_packed_all
from .overlap_shard import DistMemOverlapEngine, ShardedOverlapEngine


def _default_route_cap(chunk: int, n_dev: int) -> int:
    """Per-peer routing-slot capacity.  Worst case is chunk//n_dev (every
    query of a device's slice landing on ONE key owner), but shipping that
    worst case makes each all_to_all n_dev-times larger than the real
    traffic and sinks weak scaling.  With uniform key hashing the per-peer
    load is Binomial(chunk/n, 1/n): 4x the mean plus a floor covers any
    realistic skew, and a chunk that still overflows degrades to the exact
    host fallback (_chunk_fallback) instead of aborting — so the cap is a
    performance knob, not a correctness bound."""
    per_dev = max(chunk // n_dev, 1)
    cap = min(per_dev, max(4 * per_dev // n_dev, 1024))
    return max(8, -(-cap // 8) * 8)


def _chunk_fallback(store, table, qread, qj, qcode, s, e):
    """Exact host/XLA recompute of one overflowed superstep chunk
    (hit/route/fetch cap exceeded).  Emits the chunk's kept rows in the
    same (window, table-slot) order the SPMD grid compaction uses, so the
    downstream containment replay and relation sort see identical rows.
    Skipping the marked-prune here is safe: pruned rows are exactly rows
    the replays skip (dist.sharded_relation_pruned docstring).
    The reference has no such path — an overflowing rank aborts; here
    one chunk degrades to the host instead."""
    return _xla_rows(store, table, qread[s:e], qj[s:e], qcode[s:e])


def sharded_relation(store: ReadStore, table: FingerprintTable, mesh: Mesh,
                     hit_cap: Optional[int] = None,
                     route_cap: Optional[int] = None,
                     budget: int = 1 << 25,
                     dist_mem: bool = False,
                     stats: Optional[dict] = None) -> OverlapRelation:
    """Compute the verified overlap relation on the mesh.

    Queries run in fixed-size chunks per superstep so device memory stays
    bounded (grids ≈ budget words per mesh, independent of dataset size);
    every chunk reuses the one compiled SPMD step.  The reference's analog
    is its memory-bounded parGraph chunking
    (src/BuildGraph/src/OverlapGraph.cpp:67-81).

    hit_cap defaults to the table's largest key bucket, so the hit grids
    are lossless by construction; the chunk size shrinks to keep
    chunk * hit_cap at the budget.

    dist_mem=True partitions the packed read payload across the mesh
    (DistMemOverlapEngine — the buildG-MPIRMA equivalent, per-device
    payload O(N/n_dev)); False replicates it (buildG-MPI equivalent)."""
    n_dev = mesh.devices.size
    qread, qj, qcode = window_codes(store, table.k)
    q = len(qread)
    if hit_cap is None:
        # largest bucket in the sorted table = max run of equal keys
        _, counts = np.unique(table.keys, return_counts=True)
        hit_cap = max(int(counts.max()) if len(counts) else 1, 1)
    chunk = max(budget // hit_cap, n_dev)
    chunk = min(chunk, -(-q // n_dev) * n_dev)
    chunk = -(-chunk // n_dev) * n_dev
    if route_cap is None:
        route_cap = _default_route_cap(chunk, n_dev)
    if dist_mem:
        from jax.sharding import NamedSharding, PartitionSpec as P
        eng = DistMemOverlapEngine.build(store, table, mesh,
                                         hit_cap=hit_cap,
                                         route_cap=route_cap)
        step_dm, (packed_sh, packed_rc_sh) = eng.make_step(store,
                                                           q_chunk=chunk)
        # commit the payload to the mesh once, row-sharded: each device
        # holds only its N/n_dev read slice
        shard = NamedSharding(mesh, P("dp"))
        packed_sh = jax.device_put(packed_sh, shard)
        packed_rc_sh = jax.device_put(packed_rc_sh, shard)

        def step(_pa, lengths, qread, qj, qcode, marked):
            return step_dm(packed_sh, packed_rc_sh, lengths, qread, qj,
                           qcode, marked)
        packed_all = None
    else:
        eng = ShardedOverlapEngine.build(store, table, mesh, hit_cap=hit_cap,
                                         route_cap=route_cap)
        step = eng.make_step()
        packed_all = make_packed_all(store.packed, store.packed_rc)
    lengths = np.asarray(store.lengths, np.int32)
    marked = np.zeros(store.n_reads, np.int32)
    marked = np.pad(marked, (0, (-len(marked)) % n_dev))

    parts = {k: [] for k in ("r1", "j", "r2", "orient", "typ", "edge", "cont")}

    stats = stats if stats is not None else {}
    stats.setdefault("fallback_chunks", 0)
    stats.setdefault("chunks", 0)

    def collect(s, e, out):
        r2, orient, typ, edge_ok, cont_ok, overflow, _unions = out
        if int(np.asarray(overflow).sum()) != 0:
            # hit/route/fetch cap exceeded in this chunk: recompute it
            # exactly on the host instead of aborting
            stats["fallback_chunks"] += 1
            rows = _chunk_fallback(store, table, qread, qj, qcode, s, e)
            parts["r1"].append(rows["r1"])
            parts["j"].append(rows["j"])
            parts["r2"].append(rows["r2"])
            parts["orient"].append(rows["orient"])
            parts["typ"].append(rows["typ"])
            parts["edge"].append(rows["edge_ok"])
            parts["cont"].append(rows["cont_ok"])
            return
        n = e - s
        r2 = np.asarray(r2)[:n]
        orient = np.asarray(orient)[:n]
        typ = np.asarray(typ)[:n]
        edge_ok = np.asarray(edge_ok)[:n]
        cont_ok = np.asarray(cont_ok)[:n]
        keep = edge_ok | cont_ok
        qi, hi = np.nonzero(keep)
        parts["r1"].append(qread[s:e][qi].astype(np.int32))
        parts["j"].append(qj[s:e][qi])
        parts["r2"].append(r2[qi, hi].astype(np.int32))
        parts["orient"].append(orient[qi, hi].astype(np.int8))
        parts["typ"].append(typ[qi, hi].astype(np.int8))
        parts["edge"].append(edge_ok[qi, hi])
        parts["cont"].append(cont_ok[qi, hi])

    # 1-deep pipeline: dispatch chunk i+1 (async under jit) before pulling
    # chunk i's results, overlapping host compaction with device compute
    pending = None
    for s in range(0, q, chunk):
        e = min(s + chunk, q)
        pad = chunk - (e - s)
        qread_p = np.pad(qread[s:e], (0, pad))
        qj_p = np.pad(qj[s:e], (0, pad), constant_values=-1)
        qcode_p = np.pad(qcode[s:e], (0, pad),
                         constant_values=np.uint64(0xFFFFFFFFFFFFFFFF))
        out = step(packed_all, lengths, qread_p, qj_p, qcode_p, marked)
        stats["chunks"] += 1
        if pending is not None:
            collect(*pending)
        pending = (s, e, out)
    if pending is not None:
        collect(*pending)

    r1f = np.concatenate(parts["r1"]) if parts["r1"] else np.zeros(0, np.int32)
    jf = np.concatenate(parts["j"]) if parts["j"] else np.zeros(0, np.int32)
    r2f = np.concatenate(parts["r2"]) if parts["r2"] else np.zeros(0, np.int32)
    of = np.concatenate(parts["orient"]) if parts["orient"] else \
        np.zeros(0, np.int8)
    tf = np.concatenate(parts["typ"]) if parts["typ"] else np.zeros(0, np.int8)
    ef = np.concatenate(parts["edge"]) if parts["edge"] else \
        np.zeros(0, np.bool_)
    cf = np.concatenate(parts["cont"]) if parts["cont"] else \
        np.zeros(0, np.bool_)
    fidx2 = store.file_index[r2f]
    order = np.lexsort((tf, fidx2, jf, r1f))
    return OverlapRelation(
        r1=r1f[order], j=jf[order], r2=r2f[order], orient=of[order],
        typ=tf[order], cont_ok=cf[order], edge_ok=ef[order], k=table.k)


def sharded_relation_pruned(store: ReadStore, table: FingerprintTable,
                            mesh: Mesh,
                            hit_cap: Optional[int] = None,
                            route_cap: Optional[int] = None,
                            budget: int = 1 << 25,
                            dist_mem: bool = False,
                            superread_init: Optional[np.ndarray] = None,
                            stats: Optional[dict] = None):
    """Chunked sharded relation WITH in-loop containment marking: after
    each superstep the host advances the (order-exact) containment replay
    and feeds the updated contained-read mask into later supersteps, whose
    all_gathered union prunes candidates touching contained reads before
    verification (and, in dist-mem mode, before the payload fetch) — the
    synchronous equivalent of Disco's superReadID gossip work-pruning
    (reference: src/BuildGraphMPI/src/OverlapGraph.cpp:537-633,
    src/BuildGraph/src/OverlapGraph.cpp:435-436).

    Pruning uses marks that lag by up to two chunks (the dispatch
    pipeline), which is always SAFE: a late mark only means less pruning;
    pruned rows are exactly rows the downstream replays skip (containment:
    superread[r1]!=0 or superread[r2]!=0 already; edges: endpoints must
    both be uncontained).

    Returns (relation, superread, cont_lines).  The relation omits pruned
    rows, so it is NOT row-comparable to the unpruned one — but every
    output file derived from it is byte-identical."""
    from ..buildg import replay

    n_dev = mesh.devices.size
    qread, qj, qcode = window_codes(store, table.k)
    q = len(qread)
    if hit_cap is None:
        _, counts = np.unique(table.keys, return_counts=True)
        hit_cap = max(int(counts.max()) if len(counts) else 1, 1)
    chunk = max(budget // hit_cap, n_dev)
    chunk = min(chunk, -(-q // n_dev) * n_dev)
    chunk = -(-chunk // n_dev) * n_dev
    if route_cap is None:
        route_cap = _default_route_cap(chunk, n_dev)

    if dist_mem:
        from jax.sharding import NamedSharding, PartitionSpec as P
        eng = DistMemOverlapEngine.build(store, table, mesh,
                                         hit_cap=hit_cap,
                                         route_cap=route_cap,
                                         prune_marked=True)
        step_dm, (packed_sh, packed_rc_sh) = eng.make_step(store,
                                                           q_chunk=chunk)
        shard = NamedSharding(mesh, P("dp"))
        packed_sh = jax.device_put(packed_sh, shard)
        packed_rc_sh = jax.device_put(packed_rc_sh, shard)

        def step(lengths, qread_p, qj_p, qcode_p, marked):
            return step_dm(packed_sh, packed_rc_sh, lengths, qread_p, qj_p,
                           qcode_p, marked)
    else:
        eng = ShardedOverlapEngine.build(store, table, mesh,
                                         hit_cap=hit_cap,
                                         route_cap=route_cap,
                                         prune_marked=True)
        step0 = eng.make_step()
        packed_all = make_packed_all(store.packed, store.packed_rc)

        def step(lengths, qread_p, qj_p, qcode_p, marked):
            return step0(packed_all, lengths, qread_p, qj_p, qcode_p,
                         marked)

    lengths = np.asarray(store.lengths, np.int32)
    n = store.n_reads
    superread = (superread_init.copy() if superread_init is not None
                 else np.zeros(n + 1, np.int64))
    cont_lines = []
    pad_n = (-n) % n_dev

    def marked_now():
        return np.pad((superread[1:n + 1] != 0).astype(np.int32),
                      (0, pad_n))

    parts = {k2: [] for k2 in ("r1", "j", "r2", "orient", "typ", "edge",
                               "cont")}

    stats = stats if stats is not None else {}
    stats.setdefault("fallback_chunks", 0)
    stats.setdefault("chunks", 0)

    def collect(s, e, out):
        r2, orient, typ, edge_ok, cont_ok, overflow, _unions = out
        if int(np.asarray(overflow).sum()) != 0:
            # cap exceeded: exact host recompute of this chunk (rows in
            # the same order), then the same containment-replay advance
            stats["fallback_chunks"] += 1
            rows = _chunk_fallback(store, table, qread, qj, qcode, s, e)
            cc = rows["cont_ok"]
            parts["r1"].append(rows["r1"])
            parts["j"].append(rows["j"])
            parts["r2"].append(rows["r2"])
            parts["orient"].append(rows["orient"])
            parts["typ"].append(rows["typ"])
            parts["edge"].append(rows["edge_ok"])
            parts["cont"].append(cc)
            replay.containment_step(superread, cont_lines, store, table.k,
                                    rows["r1"][cc], rows["j"][cc],
                                    rows["r2"][cc], rows["orient"][cc])
            return
        m = e - s
        r2 = np.asarray(r2)[:m]
        orient = np.asarray(orient)[:m]
        typ = np.asarray(typ)[:m]
        edge_ok = np.asarray(edge_ok)[:m]
        cont_ok = np.asarray(cont_ok)[:m]
        keep = edge_ok | cont_ok
        qi, hi = np.nonzero(keep)
        cr1 = qread[s:e][qi].astype(np.int32)
        cj = qj[s:e][qi]
        cr2 = r2[qi, hi].astype(np.int32)
        cori = orient[qi, hi].astype(np.int8)
        cc = cont_ok[qi, hi]
        parts["r1"].append(cr1)
        parts["j"].append(cj)
        parts["r2"].append(cr2)
        parts["orient"].append(cori)
        parts["typ"].append(typ[qi, hi].astype(np.int8))
        parts["edge"].append(edge_ok[qi, hi])
        parts["cont"].append(cc)
        # advance the order-exact containment replay over this chunk's
        # cont rows (rows arrive in relation order)
        replay.containment_step(superread, cont_lines, store, table.k,
                                cr1[cc], cj[cc], cr2[cc], cori[cc])

    pending = None
    for s in range(0, q, chunk):
        e = min(s + chunk, q)
        pad = chunk - (e - s)
        qread_p = np.pad(qread[s:e], (0, pad))
        qj_p = np.pad(qj[s:e], (0, pad), constant_values=-1)
        qcode_p = np.pad(qcode[s:e], (0, pad),
                         constant_values=np.uint64(0xFFFFFFFFFFFFFFFF))
        out = step(lengths, qread_p, qj_p, qcode_p, marked_now())
        stats["chunks"] += 1
        if pending is not None:
            collect(*pending)
        pending = (s, e, out)
    if pending is not None:
        collect(*pending)

    def cat(name, dtype):
        if not parts[name]:
            return np.zeros(0, dtype)
        return np.concatenate(parts[name]).astype(dtype, copy=False)

    r1f = cat("r1", np.int32)
    r2f = cat("r2", np.int32)
    jf = cat("j", np.int32)
    tf = cat("typ", np.int8)
    fidx2 = store.file_index[r2f]
    order = np.lexsort((tf, fidx2, jf, r1f))
    rel = OverlapRelation(
        r1=r1f[order], j=jf[order], r2=r2f[order],
        orient=cat("orient", np.int8)[order], typ=tf[order],
        cont_ok=cat("cont", np.bool_)[order],
        edge_ok=cat("edge", np.bool_)[order], k=table.k)
    return rel, superread, cont_lines


def run_buildg_sharded(paired_files: Sequence[str],
                       single_files: Sequence[str], prefix: str,
                       mesh: Mesh, min_overlap: int = 30,
                       write_par_graph_size: int = 1000,
                       dist_mem: bool = False,
                       budget: int = 1 << 25,
                       route_cap: Optional[int] = None,
                       stats: Optional[dict] = None):
    """Distributed buildG: same outputs as buildg.pipeline.run_buildg, with
    the overlap phase executed over the mesh.  dist_mem selects the
    partitioned-payload engine (buildG-MPIRMA equivalent, CLI -rma)."""
    import os

    from ..buildg import replay
    from ..buildg.pipeline import load_contained_reads, read_checkpoint_info

    ccr_done, gc_done = read_checkpoint_info(prefix)
    if gc_done:
        return None, None, None
    store = ReadStore.from_files(paired_files, single_files, min_overlap,
                                 id_map_path=prefix + "_ReadIDMap.txt")
    table = FingerprintTable.build(store, min_overlap - 1)

    cont_path = prefix + "_0_containedReads.txt"
    superread_init = None
    if ccr_done and os.path.exists(cont_path):
        # resume: seed the in-loop pruning mask with the completed
        # contained-read phase (reference rebroadcasts the bitmap on
        # restart, src/BuildGraphMPI/src/OverlapGraph.cpp:448-509)
        superread_init = load_contained_reads(cont_path, store)
    rel, superread, cont_lines = sharded_relation_pruned(
        store, table, mesh, dist_mem=dist_mem, budget=budget,
        route_cap=route_cap, superread_init=superread_init, stats=stats)
    if superread_init is None:
        with open(cont_path, "w") as f:
            for ln in cont_lines:
                f.write(ln + "\n")
        with open(prefix + "_CheckpointInfo.txt", "w") as f:
            f.write("CCR=Complete\n")

    # incremental parGraph restart — same protocol as the single-node
    # builder (reference: OverlapGraph.cpp:123-211)
    par_path = prefix + "_0_parGraph.txt"
    sr_path = prefix + "_0_startRead.txt"
    start_read = 1
    premarked = None
    mode = "wb"
    if os.path.exists(par_path) and os.path.getsize(par_path) > 0:
        premarked = replay.load_partial_marks(par_path, store)
        start_read = replay.read_start_read(sr_path)
        mode = "ab"
    par_blob, start_blob, _ = replay.build_graph_replay_native(
        rel, store, superread, write_par_graph_size,
        start_read=start_read, premarked=premarked)
    with open(par_path, mode) as f:
        f.write(par_blob)
    with open(sr_path, "wb") as f:
        f.write(start_blob)
    with open(prefix + "_CheckpointInfo.txt", "a") as f:
        f.write("GC=Complete\n")
    return store, rel, superread
