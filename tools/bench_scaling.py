#!/usr/bin/env python
"""Weak-scaling measurement + communication-volume model for the sharded
overlap superstep (the multi-device production path, dist/builder.py).

Runs on the virtual CPU mesh (JAX_PLATFORMS=cpu,
xla_force_host_platform_device_count=N): per n in --devices, builds a
dataset with a FIXED per-device window load, runs the chunked sharded
relation, and reports

  - supersteps, wall per superstep (after a compile-excluded warm chunk),
  - per-device bytes exchanged per superstep, from the engine's actual
    buffer shapes (a count, not a time).

Virtual-mesh caveat: all N "devices" share this host's cores, so wall
clocks here validate that work per device stays flat (no serial
bottleneck growing with N) — they cannot demonstrate real-parallel
speedup, and exchange times on real cards are not measured here.

Reference being modeled: the RMA op counting at
src/BuildGraphMPIRMA/src/OverlapGraph.cpp:388 (per-probe MPI_Get traffic),
replaced by bulk-synchronous all_to_all rounds.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def superstep_bytes(n_dev, chunk, route_cap, hit_cap, n_reads, wp,
                    dist_mem, fetch_cap):
    """Per-device bytes moved through collectives in ONE superstep, from
    the static buffer shapes in dist/overlap_shard.py (send+receive)."""
    per_dev = chunk // n_dev
    # marked all_gather: int32 mask, receive (n-1)/n of N words
    b = 4 * n_reads
    # codes route: (n, route_cap) uint64 + bool, both directions
    b += 2 * n_dev * route_cap * 9
    # hit grids back: read/orient/typ int32 + valid bool
    b += 2 * n_dev * route_cap * hit_cap * 13
    if dist_mem:
        # fetch exchange: requests int32 out, rows (wp words) back, x2 dirs
        b += 2 * n_dev * fetch_cap * (4 + 4 * wp)
    return b, per_dev


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--windows-per-device", type=int, default=120_000)
    ap.add_argument("--read-len", type=int, default=120)
    ap.add_argument("--min-overlap", type=int, default=40)
    ap.add_argument("--dist-mem", action="store_true")
    ap.add_argument("--budget", type=int, default=1 << 21,
                    help="superstep budget (words) => several chunks")
    args = ap.parse_args()

    devs = [int(x) for x in args.devices.split(",")]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={max(devs)}"
        ).strip()

    import numpy as np
    import jax
    jax.config.update("jax_platforms", "cpu")
    from jax.sharding import Mesh

    from disco_tpu.dist import builder
    from disco_tpu.index.table import FingerprintTable
    from disco_tpu.io.readstore import ReadStore
    from disco_tpu.overlap.relation import window_codes

    rows = []
    for n in devs:
        # fixed per-device load: windows ~ n * windows_per_device
        wins_per_read = args.read_len - (args.min_overlap - 1)
        n_reads = max(64, (n * args.windows_per_device) // wins_per_read)
        rng = np.random.default_rng(11)
        glen = max(2000, n_reads * 3)
        genome = "".join(rng.choice(list("ACGT"), glen))
        seqs = []
        for _ in range(n_reads):
            s = int(rng.integers(0, glen - args.read_len))
            seqs.append(genome[s:s + args.read_len])
        store = ReadStore.from_sequences(seqs)
        table = FingerprintTable.build(store, args.min_overlap - 1)
        mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("dp",))

        q = len(window_codes(store, table.k)[0])
        _, counts = np.unique(table.keys, return_counts=True)
        hit_cap = max(int(counts.max()) if len(counts) else 1, 1)
        chunk = max(args.budget // hit_cap, n)
        chunk = min(chunk, -(-q // n) * n)
        chunk = -(-chunk // n) * n
        route_cap = builder._default_route_cap(chunk, n)
        fetch_cap = 0
        if args.dist_mem:
            from disco_tpu.dist.overlap_shard import DistMemOverlapEngine
            eng = DistMemOverlapEngine.build(store, table, mesh,
                                             hit_cap=hit_cap,
                                             route_cap=route_cap)
            eng._resolve_fetch_cap(chunk)
            fetch_cap = eng.fetch_cap

        stats = {}
        t0 = time.perf_counter()
        builder.sharded_relation(store, table, mesh,
                                 budget=args.budget,
                                 dist_mem=args.dist_mem, stats=stats)
        wall = time.perf_counter() - t0
        # re-run (compiled) for the steady-state number
        stats2 = {}
        t0 = time.perf_counter()
        builder.sharded_relation(store, table, mesh,
                                 budget=args.budget,
                                 dist_mem=args.dist_mem, stats=stats2)
        wall2 = time.perf_counter() - t0
        bts, per_dev = superstep_bytes(
            n, chunk, route_cap, hit_cap, store.n_reads,
            store.packed.shape[1], args.dist_mem, fetch_cap)
        pairs = per_dev * hit_cap
        rows.append({
            "n_dev": n, "windows": q, "chunk": chunk,
            "supersteps": stats2["chunks"],
            "fallback_chunks": stats2["fallback_chunks"],
            "route_cap": route_cap, "hit_cap": hit_cap,
            "fetch_cap": fetch_cap,
            "wall_warm_s": round(wall2, 3),
            "wall_per_superstep_ms": round(
                1000 * wall2 / max(stats2["chunks"], 1), 2),
            "bytes_per_dev_per_superstep": bts,
            "pairs_per_dev_per_superstep": pairs,
            "comm_bytes_per_pair": round(bts / max(pairs, 1), 2),
        })
        print(json.dumps(rows[-1]), flush=True)


if __name__ == "__main__":
    main()
