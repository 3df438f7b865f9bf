"""Multi-chip overlap superstep over a jax.sharding.Mesh.

Replacement for the reference's two distribution modes:

- BuildGraphMPI (replicated index, partitioned reads,
  reference: src/BuildGraphMPI/src/OverlapGraph.cpp:294-295): the query axis
  is sharded over the mesh ("dp"), reads replicated.
- BuildGraphMPIRMA (partitioned hash data + passive-target MPI_Get with
  software caches, reference: src/BuildGraphMPIRMA/src/HashTable.cpp:92-119,
  648-708): the fingerprint table is HASH-SHARDED by key
  (owner = key mod n_shards) and each superstep routes query k-mers to their
  owner shard with one fused `all_to_all`; answers return the same way —
  bulk-synchronous exchange instead of latency-bound one-sided Gets
  (SURVEY.md §5.8).
- The reference's async marked-bitmap gossip
  (BuildGraphMPI/src/OverlapGraph.cpp:204-290) becomes a synchronous
  `all_gather`/`pmax` per superstep.

Everything is static-shape: queries are binned into fixed-capacity per-peer
blocks (overflow is counted and reported so the host can re-run those
windows), hits are capped per query at `hit_cap` with validity masks.  The
superstep returns the full verified-hit grids so a distributed buildG can
assemble the same relation (and therefore the same output files) as the
single-chip path.
"""
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..overlap.device import candidate_checks, candidate_checks_rows

AXIS = "dp"


def _bin_by_owner(owner, n_bins, cap):
    """Scatter indices [0, Q) into an (n_bins, cap) slot matrix by owner id.
    Entries with owner >= n_bins are skipped silently (callers use owner =
    n_bins as a "route nowhere" sentinel).  Returns (slots int32, -1
    padding; overflow count of real entries that did not fit their bin)."""
    q = owner.shape[0]
    owner = jnp.minimum(owner.astype(jnp.int32), n_bins)
    order = jnp.argsort(owner, stable=True)
    sowner = owner[order]
    start = jnp.searchsorted(sowner, jnp.arange(n_bins, dtype=jnp.int32))
    in_range = sowner < n_bins
    rank = jnp.arange(q, dtype=jnp.int32) - start[jnp.minimum(
        sowner, n_bins - 1)]
    valid = (rank < cap) & in_range
    row = jnp.where(valid, sowner, n_bins)          # OOB row -> dropped
    col = jnp.where(valid, rank, 0)
    slots = jnp.full((n_bins, cap), -1, jnp.int32)
    slots = slots.at[row, col].set(order.astype(jnp.int32), mode="drop")
    overflow = in_range.sum() - valid.sum()
    return slots, overflow


@dataclass
class ShardedOverlapEngine:
    """Device-sharded candidate lookup + verification.

    Host-side setup shards the sorted fingerprint table by key ownership
    (key mod n_shards) and pads shards to equal length; the device superstep
    does bin -> all_to_all -> local searchsorted -> all_to_all -> verify."""
    mesh: Mesh
    n_words: int
    k: int
    hit_cap: int
    route_cap: int
    keys: np.ndarray    # (n_shards, M_pad) uint64, each row sorted
    read: np.ndarray    # (n_shards, M_pad) int32
    orient: np.ndarray  # (n_shards, M_pad) int32
    typ: np.ndarray     # (n_shards, M_pad) int32
    sizes: np.ndarray   # (n_shards,) int32 — real (unpadded) entry counts
    # prune candidates touching marked (contained) reads using the
    # all_gathered mask union — Disco's superReadID==0 work pruning
    # (reference: src/BuildGraph/src/OverlapGraph.cpp:435-436); safe with
    # stale marks (pruning lags, never wrong), see dist.builder
    prune_marked: bool = False

    @classmethod
    def build(cls, store: ReadStore, table: FingerprintTable, mesh: Mesh,
              hit_cap: int = 8, route_cap: int = 4096,
              prune_marked: bool = False) -> "ShardedOverlapEngine":
        n_shards = mesh.devices.size
        owner = (table.keys % np.uint64(n_shards)).astype(np.int64)
        m_pad = max(int(np.bincount(owner, minlength=n_shards).max()), 1)
        keys = np.full((n_shards, m_pad), np.uint64(0xFFFFFFFFFFFFFFFF))
        read = np.zeros((n_shards, m_pad), np.int32)
        orient = np.zeros((n_shards, m_pad), np.int32)
        typ = np.zeros((n_shards, m_pad), np.int32)
        sizes = np.zeros(n_shards, np.int32)
        for s in range(n_shards):
            sel = owner == s
            m = int(sel.sum())
            keys[s, :m] = table.keys[sel]   # globally sorted => row sorted
            read[s, :m] = table.read[sel]
            orient[s, :m] = table.orient[sel]
            typ[s, :m] = table.typ[sel]
            sizes[s] = m
        return cls(mesh=mesh, n_words=store.n_words, k=table.k,
                   hit_cap=hit_cap, route_cap=route_cap,
                   keys=keys, read=read, orient=orient, typ=typ,
                   sizes=sizes, prune_marked=prune_marked)

    # ------------------------------------------------------------------
    def _superstep(self, packed_all, lengths, qread, qj, qcode, marked,
                   lkeys, lread, lorient, ltyp, lsize):
        """Per-shard body (runs under shard_map).  Local (per-shard query
        slice) outputs: hit grids (Qs, H), overflow (1,), marked union."""
        n_shards = jax.lax.psum(1, AXIS)
        hit_cap = self.hit_cap
        route_cap = self.route_cap
        q_local = qread.shape[0]

        # 1. union of marked bitmaps (replaces async gossip)
        marked_union = jax.lax.all_gather(marked, AXIS, tiled=True)

        # 2. route query codes to their owner shards; PAD windows
        #    (qj < 0, the chunk-tail filler) route nowhere — otherwise they
        #    all share the 0xFF..FF pad code's owner and flood one peer's
        #    route slots on the final partial chunk
        owner = (qcode % jnp.uint64(n_shards)).astype(jnp.int32)
        owner = jnp.where(qj < 0, n_shards, owner)
        slots, overflow = _bin_by_owner(owner, n_shards, route_cap)
        slot_valid = slots >= 0
        q_idx = jnp.clip(slots, 0)
        codes_out = jnp.where(slot_valid, qcode[q_idx], jnp.uint64(0))
        codes_in = jax.lax.all_to_all(codes_out, AXIS, 0, 0, tiled=True)
        valid_in = jax.lax.all_to_all(slot_valid, AXIS, 0, 0, tiled=True)

        # 3. local table lookup — clamped to the shard's REAL entry count:
        #    the pad entries share the key 0xFF..FF, which a genuine poly-T
        #    window can also hash to, so an unclamped hi would sweep the
        #    pad run into that query's bucket (garbage hits / spurious
        #    hit-cap overflow)
        flat_codes = codes_in.reshape(-1)
        lo = jnp.minimum(jnp.searchsorted(lkeys, flat_codes, side="left"),
                         lsize)
        hi = jnp.minimum(jnp.searchsorted(lkeys, flat_codes, side="right"),
                         lsize)
        tpos = lo[:, None] + jnp.arange(hit_cap, dtype=lo.dtype)[None, :]
        hit_valid = (tpos < hi[:, None]) & valid_in.reshape(-1)[:, None]
        overflow = overflow + ((hi - lo) > hit_cap).sum()
        tpos = jnp.clip(tpos, 0, lkeys.shape[0] - 1)
        hit_read = jnp.where(hit_valid, lread[tpos], 0).astype(jnp.int32)
        hit_orient = jnp.where(hit_valid, lorient[tpos], 0).astype(jnp.int32)
        hit_typ = jnp.where(hit_valid, ltyp[tpos], 0).astype(jnp.int32)

        # 4. answers ride back to the querying shard
        def back(x):
            return jax.lax.all_to_all(
                x.reshape(n_shards, route_cap, hit_cap), AXIS, 0, 0,
                tiled=True).reshape(n_shards * route_cap, hit_cap)

        hit_read = back(hit_read)
        hit_orient = back(hit_orient)
        hit_typ = back(hit_typ)
        pair_valid = back(hit_valid)

        # 5. scatter answers back to per-query rows (the slot matrix is the
        #    routing permutation)
        flat_slots = slots.reshape(-1)
        sel = flat_slots >= 0
        # unused slots scatter to an out-of-bounds row (dropped) so they
        # cannot clobber query row 0
        src = jnp.where(sel, flat_slots, q_local)
        r2 = jnp.zeros((q_local, hit_cap), jnp.int32)
        orient = jnp.zeros((q_local, hit_cap), jnp.int32)
        typ = jnp.zeros((q_local, hit_cap), jnp.int32)
        valid = jnp.zeros((q_local, hit_cap), jnp.bool_)
        r2 = r2.at[src].set(hit_read, mode="drop")
        orient = orient.at[src].set(hit_orient, mode="drop")
        typ = typ.at[src].set(hit_typ, mode="drop")
        valid = valid.at[src].set(pair_valid, mode="drop")

        if self.prune_marked:
            valid &= (marked_union[qread] == 0)[:, None]
            valid &= marked_union[r2] == 0

        # 6. verify locally (shared geometry, reference:
        #    src/BuildGraph/src/OverlapGraph.cpp:517-595)
        edge_ok, cont_ok = candidate_checks(
            packed_all, lengths, qread, qj, r2, orient, valid,
            k=self.k, n_words=self.n_words)
        return (r2, orient, typ, edge_ok, cont_ok, overflow[None],
                marked_union[None, :])

    def shard_fn(self):
        """The un-jitted SPMD fn over the mesh, with the table shards as
        explicit arguments (for multi-process drivers, which must construct
        global arrays themselves):
        fn(packed_all, lengths, qread, qj, qcode, marked,
           keys, read, orient, typ, sizes)"""
        def body(packed_all, lengths, qread, qj, qcode, marked,
                 keys_s, read_s, orient_s, typ_s, size_s):
            return self._superstep(packed_all, lengths, qread, qj, qcode,
                                   marked, keys_s[0], read_s[0], orient_s[0],
                                   typ_s[0], size_s[0])

        return jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                      P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                       P(AXIS), P(AXIS)),
            check_vma=False)

    def make_step(self):
        """Returns a jitted SPMD step over the mesh.
        step(packed_all, lengths, qread, qj, qcode, marked) ->
          (r2, orient, typ, edge_ok, cont_ok) per-query grids (Q, H),
          overflows (n_shards,), marked unions (n_shards, N)."""
        keys = jnp.asarray(self.keys)
        read = jnp.asarray(self.read)
        orient = jnp.asarray(self.orient)
        typ = jnp.asarray(self.typ)
        sizes = jnp.asarray(self.sizes)
        fn = self.shard_fn()

        @jax.jit
        def run(packed_all, lengths, qread, qj, qcode, marked):
            return fn(packed_all, lengths, qread, qj, qcode, marked,
                      keys, read, orient, typ, sizes)
        return run


# ---------------------------------------------------------------------------
# Dist-mem mode: read payload partitioned across the mesh
# ---------------------------------------------------------------------------
@dataclass
class DistMemOverlapEngine(ShardedOverlapEngine):
    """The BuildGraphMPIRMA equivalent with a truly partitioned read store.

    Disco's RMA mode partitions the hash DATA table — which holds the packed
    read sequences — across ranks and fetches remote reads on demand with
    MPI_Get + software caches (reference:
    src/BuildGraphMPIRMA/src/HashTable.cpp:92-119,422-435,648-708).  Here the
    packed read payload (forward + rc rows) is sharded over the mesh
    round-robin by read id (owner = read % n_shards — round-robin because a
    superstep's query slice covers a CONTIGUOUS read range, which under
    blocked ownership would direct every read1 fetch at one owner), and each
    superstep fetches exactly the rows it needs with one bulk-synchronous
    all_to_all exchange pair per direction — the latency-amortized
    equivalent of the reference's per-probe one-sided Gets (SURVEY.md §5.8).

    Replicated per device: the fingerprint table SHARD (by key owner), read
    lengths, and the marked bitmap.  The reference replicates strictly more —
    its whole bucket-offset index (HashTable.cpp:92-119 keeps the index
    replicated; only the data window is partitioned).  Lengths are ~2% of
    payload bytes (4 B vs ~2×(L/4) B per read).

    Per-device memory: O(N/n_dev) payload + O(chunk · hit_cap) superstep
    state, so a dataset that does not fit one device's memory fits the
    mesh.
    """
    fetch_cap: int = 0

    @classmethod
    def build(cls, store: ReadStore, table: FingerprintTable, mesh: Mesh,
              hit_cap: int = 8, route_cap: int = 4096,
              fetch_cap: int = 0,
              prune_marked: bool = False) -> "DistMemOverlapEngine":
        base = ShardedOverlapEngine.build(store, table, mesh,
                                          hit_cap=hit_cap,
                                          route_cap=route_cap)
        return cls(mesh=base.mesh, n_words=base.n_words, k=base.k,
                   hit_cap=base.hit_cap, route_cap=base.route_cap,
                   keys=base.keys, read=base.read, orient=base.orient,
                   typ=base.typ, sizes=base.sizes, fetch_cap=fetch_cap,
                   prune_marked=prune_marked)

    @staticmethod
    def shard_payload(store: ReadStore, n_shards: int):
        """Host-side payload layout: permute reads so shard s's contiguous
        slice holds exactly the reads {r : r % n_shards == s} (round-robin
        ownership), padded to n_shards * block rows.  Returns
        (packed_sh, packed_rc_sh, block)."""
        n = store.n_reads
        block = -(-n // n_shards)
        wp = store.packed.shape[1]
        packed_sh = np.zeros((n_shards * block, wp), np.uint32)
        packed_rc_sh = np.zeros((n_shards * block, wp), np.uint32)
        rid = np.arange(n)
        dst = (rid % n_shards) * block + rid // n_shards
        packed_sh[dst] = store.packed
        packed_rc_sh[dst] = store.packed_rc
        return packed_sh, packed_rc_sh, block

    # ------------------------------------------------------------------
    def _fetch_rows(self, row_ids, pfwd, prc, n_reads, block, cap):
        """Exchange-fetch packed rows by global row id in [0, 2N): ids
        [0, N) are forward rows, [N, 2N) rc rows; read r is owned by shard
        r % n_shards.  Returns ((R, W+1) rows, overflow count)."""
        n_shards = jax.lax.psum(1, AXIS)
        r = row_ids.shape[0]
        rid = (jnp.abs(row_ids) % n_reads).astype(jnp.int32)
        # id < 0 = "no fetch needed" sentinel -> owner n_shards (dropped)
        owner = jnp.where(row_ids < 0, n_shards, rid % n_shards)
        slots, overflow = _bin_by_owner(owner, n_shards, cap)
        slot_valid = slots >= 0
        req = jnp.where(slot_valid, row_ids[jnp.clip(slots, 0)], 0)
        req = req.astype(jnp.int32)
        req_in = jax.lax.all_to_all(req, AXIS, 0, 0, tiled=True)
        # owner-local gather
        rid_in = req_in % n_reads
        local = jnp.clip(rid_in // n_shards, 0, block - 1)
        is_rc = (req_in >= n_reads)[..., None]
        rows = jnp.where(is_rc, prc[local], pfwd[local])
        rows_back = jax.lax.all_to_all(rows, AXIS, 0, 0, tiled=True)
        # scatter replies to request order
        flat_slots = slots.reshape(-1)
        src = jnp.where(flat_slots >= 0, flat_slots, r)
        wp = pfwd.shape[-1]
        out = jnp.zeros((r, wp), jnp.uint32).at[src].set(
            rows_back.reshape(-1, wp), mode="drop")
        return out, overflow

    def _superstep_dm(self, pfwd, prc, lengths, qread, qj, qcode, marked,
                      lkeys, lread, lorient, ltyp, lsize, n_reads, block):
        """Dist-mem superstep: key-owner candidate lookup (as in the base
        engine) + payload row fetch + local verification on fetched rows."""
        n_shards = jax.lax.psum(1, AXIS)
        hit_cap = self.hit_cap
        route_cap = self.route_cap
        q_local = qread.shape[0]

        marked_union = jax.lax.all_gather(marked, AXIS, tiled=True)

        owner = (qcode % jnp.uint64(n_shards)).astype(jnp.int32)
        owner = jnp.where(qj < 0, n_shards, owner)  # pads route nowhere
        slots, overflow = _bin_by_owner(owner, n_shards, route_cap)
        slot_valid = slots >= 0
        q_idx = jnp.clip(slots, 0)
        codes_out = jnp.where(slot_valid, qcode[q_idx], jnp.uint64(0))
        codes_in = jax.lax.all_to_all(codes_out, AXIS, 0, 0, tiled=True)
        valid_in = jax.lax.all_to_all(slot_valid, AXIS, 0, 0, tiled=True)

        flat_codes = codes_in.reshape(-1)
        lo = jnp.minimum(jnp.searchsorted(lkeys, flat_codes, side="left"),
                         lsize)
        hi = jnp.minimum(jnp.searchsorted(lkeys, flat_codes, side="right"),
                         lsize)
        tpos = lo[:, None] + jnp.arange(hit_cap, dtype=lo.dtype)[None, :]
        hit_valid = (tpos < hi[:, None]) & valid_in.reshape(-1)[:, None]
        overflow = overflow + ((hi - lo) > hit_cap).sum()
        tpos = jnp.clip(tpos, 0, lkeys.shape[0] - 1)
        hit_read = jnp.where(hit_valid, lread[tpos], 0).astype(jnp.int32)
        hit_orient = jnp.where(hit_valid, lorient[tpos], 0).astype(jnp.int32)
        hit_typ = jnp.where(hit_valid, ltyp[tpos], 0).astype(jnp.int32)

        def back(x):
            return jax.lax.all_to_all(
                x.reshape(n_shards, route_cap, hit_cap), AXIS, 0, 0,
                tiled=True).reshape(n_shards * route_cap, hit_cap)

        hit_read = back(hit_read)
        hit_orient = back(hit_orient)
        hit_typ = back(hit_typ)
        pair_valid = back(hit_valid)

        flat_slots = slots.reshape(-1)
        src = jnp.where(flat_slots >= 0, flat_slots, q_local)
        r2 = jnp.zeros((q_local, hit_cap), jnp.int32)
        orient = jnp.zeros((q_local, hit_cap), jnp.int32)
        typ = jnp.zeros((q_local, hit_cap), jnp.int32)
        valid = jnp.zeros((q_local, hit_cap), jnp.bool_)
        r2 = r2.at[src].set(hit_read, mode="drop")
        orient = orient.at[src].set(hit_orient, mode="drop")
        typ = typ.at[src].set(hit_typ, mode="drop")
        valid = valid.at[src].set(pair_valid, mode="drop")

        if self.prune_marked:
            # prune BEFORE the payload fetch: candidates touching marked
            # (contained) reads cost no exchange bandwidth either
            valid &= (marked_union[qread] == 0)[:, None]
            valid &= marked_union[r2] == 0

        # ---- payload fetch: read1 rows (forward) + candidate rows ------
        from ..overlap.device import _USE_RC
        use_rc = jnp.asarray(_USE_RC)[orient]
        rows2_id = jnp.where(use_rc, r2 + n_reads, r2)
        rows2_id = jnp.where(valid, rows2_id, -1)  # invalid slot: no fetch
        q_ids = jnp.where(qj < 0, -1, qread.astype(jnp.int32))  # pads: none
        if self.prune_marked:
            q_ids = jnp.where(marked_union[qread] == 0, q_ids, -1)
        all_ids = jnp.concatenate([q_ids, rows2_id.reshape(-1)])
        cap = self.fetch_cap
        fetched, f_overflow = self._fetch_rows(all_ids, pfwd, prc, n_reads,
                                               block, cap)
        overflow = overflow + f_overflow
        rows1 = fetched[:q_local]
        rows2 = fetched[q_local:].reshape(q_local, hit_cap, -1)

        edge_ok, cont_ok = candidate_checks_rows(
            rows1, rows2, lengths, qread, qj, r2, orient, valid, k=self.k)
        return (r2, orient, typ, edge_ok, cont_ok, overflow[None],
                marked_union[None, :])

    def _resolve_fetch_cap(self, q_chunk: int = None) -> None:
        if self.fetch_cap <= 0:
            # expected fetch load per peer pair: ids spread ~uniformly under
            # round-robin ownership; 2x headroom, rounded up to lanes
            if q_chunk is None:
                raise ValueError("pass q_chunk or an explicit fetch_cap")
            n_shards = self.mesh.devices.size
            per_shard = q_chunk // n_shards
            ids = per_shard * (1 + self.hit_cap)
            self.fetch_cap = -(-(2 * ids) // (8 * n_shards)) * 8

    def shard_fn(self, n_reads: int, block: int):
        """The un-jitted dist-mem SPMD fn (payload + table as explicit
        args): fn(packed_sh, packed_rc_sh, lengths, qread, qj, qcode,
        marked, keys, read, orient, typ, sizes).  fetch_cap must already be
        resolved."""
        assert self.fetch_cap > 0

        def body(pfwd, prc, lengths, qread, qj, qcode, marked,
                 keys_s, read_s, orient_s, typ_s, size_s):
            return self._superstep_dm(
                pfwd, prc, lengths, qread, qj, qcode, marked,
                keys_s[0], read_s[0], orient_s[0], typ_s[0], size_s[0],
                n_reads, block)

        return jax.shard_map(
            body, mesh=self.mesh,
            in_specs=(P(AXIS), P(AXIS), P(), P(AXIS), P(AXIS), P(AXIS),
                      P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                       P(AXIS), P(AXIS)),
            check_vma=False)

    def make_step(self, store: ReadStore = None, q_chunk: int = None):
        """Returns (step, payload): `payload` = (packed_sh, packed_rc_sh)
        host arrays laid out for sharding; step(packed_sh, packed_rc_sh,
        lengths, qread, qj, qcode, marked) -> same outputs as the base
        engine's step.  The payload enters shard_map with in_spec P(AXIS),
        so each device's addressable shard is its own N/n_dev read slice."""
        assert store is not None, "DistMemOverlapEngine.make_step needs store"
        n_shards = self.mesh.devices.size
        packed_sh, packed_rc_sh, block = self.shard_payload(store, n_shards)
        self._resolve_fetch_cap(q_chunk)

        keys = jnp.asarray(self.keys)
        read = jnp.asarray(self.read)
        orient = jnp.asarray(self.orient)
        typ = jnp.asarray(self.typ)
        sizes = jnp.asarray(self.sizes)
        fn = self.shard_fn(store.n_reads, block)

        @jax.jit
        def run(packed_sh, packed_rc_sh, lengths, qread, qj, qcode, marked):
            return fn(packed_sh, packed_rc_sh, lengths, qread, qj, qcode,
                      marked, keys, read, orient, typ, sizes)
        return run, (packed_sh, packed_rc_sh)
