"""Fully on-device overlap phase: window codes -> sorted-table lookup ->
candidate expansion -> verification, all inside one jit.

This is the performance engine (the parity replay keeps its own host path in
`relation.py`; both produce the same verified-hit relation).  Design:

- Window codes are computed straight from the packed words with a
  three-word funnel (no base unpacking, no (N, L) uint8 intermediates):
  for window j, take words j//16, +1, +2, shift out the 2*(j%16) phase bits
  and keep the top 2k bits.  Replaces the reference's per-substring
  std::string hashing (reference: src/BuildGraph/src/HashTable.cpp:396-416).
- Lookup is a vectorized searchsorted over the sorted fingerprint keys
  (reference's chained-bucket probe, HashTable.cpp:521-571).
- Candidates are expanded to a fixed per-window cap with validity masks
  (static shapes for XLA); overflow beyond the cap is counted and returned
  so callers can fall back to the exact host path for those windows
  (Disco itself caps at MAX_EDGE_PER_KMER=4 candidate INSERTIONS, but
  verification needs every bucket entry, so the cap here is over bucket
  entries; table occupancy makes >hit_cap buckets rare at sane k).
"""
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from .verify import make_packed_all

# numpy (not jnp) so importing this module does not initialize the XLA
# backend — jax.distributed.initialize() must run first in multi-process
# mode; inside jit these convert at trace time
_EDGE_ORIENT = np.asarray([3, 0, 2, 1], np.int32)
_IS_SUFFIX = np.asarray([0, 1, 0, 1], np.bool_)
_USE_RC = np.asarray([0, 0, 1, 1], np.bool_)


class DeviceOverlapResult(NamedTuple):
    """Per (window, slot) candidate grid with verification masks."""
    r2: jax.Array        # (Q, H) int32 candidate read ids
    orient: jax.Array    # (Q, H) int32 hit orientation
    typ: jax.Array       # (Q, H) int32 record type
    edge_ok: jax.Array   # (Q, H) bool
    cont_ok: jax.Array   # (Q, H) bool
    overflow: jax.Array  # () int32 windows with more than H hits
    n_hits: jax.Array    # () int64 occupied candidate slots


def candidate_checks(packed_all, lengths, qread, qj, r2, orient, valid,
                     *, k, n_words):
    """Shared geometry + verification for a (Q, H) candidate grid
    (reference: OverlapGraph.cpp:517-595).  Returns (edge_ok, cont_ok).
    Used by the single-device pipeline below and the sharded superstep
    (disco_tpu.dist.overlap_shard).

    Internally everything runs over FLAT (Q*H,) vectors, so the dense
    pipeline's (cand_cap, 1) grid and the sharded (Q, hit_cap) grid share
    one code path."""
    n_reads = lengths.shape[0]
    q, h = r2.shape
    qread_f = jnp.repeat(qread.astype(jnp.int32), h)
    j = jnp.repeat(qj.astype(jnp.int32), h)
    r2f = r2.reshape(-1)
    orient_f = orient.reshape(-1)
    valid_f = valid.reshape(-1)
    len1 = lengths[qread_f]
    len2 = lengths[r2f]
    suffix_case = jnp.asarray(_IS_SUFFIX)[orient_f]
    use_rc = jnp.asarray(_USE_RC)[orient_f]

    e_valid = jnp.where(suffix_case, j <= len2 - k, (len1 - j) < len2)
    e_valid &= (j >= 1) & (qread_f != r2f) & valid_f
    e_n = jnp.where(suffix_case, j + k, len1 - j).astype(jnp.int32)
    e_n = jnp.where(e_valid, e_n, 0)
    e_o1 = jnp.where(suffix_case, 0, j).astype(jnp.int32)
    e_o2 = jnp.maximum(jnp.where(suffix_case, len2 - e_n, 0), 0)

    c_valid = jnp.where(suffix_case, j >= len2 - k, j + len2 <= len1)
    c_valid &= (qread_f != r2f) & valid_f
    c_n = jnp.where(c_valid, len2, 0).astype(jnp.int32)
    c_o1 = jnp.where(suffix_case, j + k - len2, j).astype(jnp.int32)
    c_o1 = jnp.maximum(c_o1, 0)

    rows2 = (r2f + jnp.where(use_rc, n_reads, 0)).astype(jnp.int32)
    edge_ok, cont_ok = verify_pairs(packed_all, qread_f, rows2, e_o1, e_o2,
                                    e_n, c_o1, c_n, n_words=n_words)
    edge_ok &= e_valid
    cont_ok &= c_valid
    return edge_ok.reshape(q, h), cont_ok.reshape(q, h)


def verify_pairs(packed_all, rows1, rows2, e_o1, e_o2, e_n, c_o1, c_n, *,
                 n_words):
    """The verify step for (P,) pairs of row ids into packed_all: whole-row
    gathers ONCE, then both window checks (`_dual_check`)."""
    return _dual_check(packed_all[rows1], packed_all[rows2], e_o1, e_o2,
                       e_n, c_o1, c_n, n_words=n_words)


def _dual_check(blk1, blk2, e_o1, e_o2, e_n, c_o1, c_n, *, n_words):
    """Edge + containment window compares over gathered row blocks
    (P, W+1): align each window to word 0 (verify.align_window), then a
    masked word compare.  Integer-only (u32 shifts, XOR, masks); XLA fuses
    it into a few loop fusions."""
    from .verify import _masked_equal, align_window

    def check(o1, o2, nl):
        a = align_window(blk1, o1)
        b = align_window(blk2, o2)
        return _masked_equal(a, b, nl, n_words)

    return (check(e_o1, e_o2, e_n),
            check(c_o1, jnp.zeros_like(c_o1), c_n))


@functools.partial(jax.jit,
                   static_argnames=("k", "n_words", "max_len", "hit_cap"))
def device_overlap(packed, packed_all, lengths, starts, keys, tread, torient,
                   ttyp, *, k, n_words, max_len, hit_cap):
    """packed: (N, W+1) uint32 forward reads; packed_all: (2N, W+1);
    lengths: (N,) int32; starts: (Q,) int32 flat window list given as
    (read_id * max_len + j) indices; keys/tread/torient/ttyp: fingerprint
    table columns (sorted by key)."""
    n_reads = lengths.shape[0]
    qread = (starts // max_len).astype(jnp.int32)
    qj = (starts % max_len).astype(jnp.int32)

    # ---- window codes: 3-word funnel ----------------------------------
    wbase = qj // 16
    phase = (2 * (qj % 16)).astype(jnp.uint32)
    wlim = packed.shape[1] - 1
    w0 = packed[qread, jnp.minimum(wbase, wlim)].astype(jnp.uint64)
    w1 = packed[qread, jnp.minimum(wbase + 1, wlim)].astype(jnp.uint64)
    w2 = packed[qread, jnp.minimum(wbase + 2, wlim)].astype(jnp.uint64)
    hi = (w0 << jnp.uint64(32)) | w1
    phase64 = phase.astype(jnp.uint64)
    # w2 holds bases 32..47 in its (32-bit) value: funnel in its top
    # `phase` bits, i.e. >> (32-phase), via a two-step shift to avoid the
    # undefined shift-by-32 at phase 0
    win = jnp.where(
        phase64 == 0, hi,
        (hi << phase64) | ((w2 >> (jnp.uint64(31) - phase64))
                           >> jnp.uint64(1)))
    kk = min(k, 32)
    qcode = win >> jnp.uint64(64 - 2 * kk)

    # ---- table lookup --------------------------------------------------
    lo = jnp.searchsorted(keys, qcode, side="left")
    hi_i = jnp.searchsorted(keys, qcode, side="right")
    overflow = jnp.sum((hi_i - lo) > hit_cap)
    tpos = lo[:, None] + jnp.arange(hit_cap, dtype=lo.dtype)[None, :]
    valid = tpos < hi_i[:, None]
    tpos = jnp.clip(tpos, 0, keys.shape[0] - 1)
    r2 = jnp.where(valid, tread[tpos], 0).astype(jnp.int32)
    orient = jnp.where(valid, torient[tpos], 0).astype(jnp.int32)
    typ = jnp.where(valid, ttyp[tpos], 0).astype(jnp.int32)

    edge_ok, cont_ok = candidate_checks(packed_all, lengths, qread, qj, r2,
                                        orient, valid, k=k, n_words=n_words)
    n_hits = valid.sum()
    return DeviceOverlapResult(r2, orient, typ, edge_ok, cont_ok, overflow,
                               n_hits)


def candidate_checks_rows(rows1, rows2, lengths, qread, qj, r2, orient,
                          valid, *, k):
    """`candidate_checks` over pre-fetched packed rows instead of a resident
    (2N, W+1) store: rows1 (Q, W+1) is read1's forward row, rows2
    (Q, H, W+1) is the candidate's forward-or-rc row (the caller resolves
    orientation before fetching).  Used by the dist-mem superstep
    (disco_tpu.dist.overlap_shard.DistMemOverlapEngine), where the read
    payload is partitioned across the mesh and only the needed rows are
    exchanged (reference's RMA fetch: src/BuildGraphMPIRMA/src/HashTable.cpp:665-708).
    Geometry is identical to `candidate_checks`
    (reference: src/BuildGraph/src/OverlapGraph.cpp:517-595)."""
    len1 = lengths[qread][:, None]
    len2 = lengths[r2]
    j = qj[:, None]
    suffix_case = jnp.asarray(_IS_SUFFIX)[orient]

    e_valid = jnp.where(suffix_case, j <= len2 - k, (len1 - j) < len2)
    e_valid &= (j >= 1) & (qread[:, None] != r2) & valid
    e_n = jnp.where(suffix_case, j + k, len1 - j).astype(jnp.int32)
    e_n = jnp.where(e_valid, e_n, 0)
    e_o1 = jnp.where(suffix_case, 0, j).astype(jnp.int32)
    e_o1 = jnp.broadcast_to(e_o1, r2.shape)
    e_o2 = jnp.maximum(jnp.where(suffix_case, len2 - e_n, 0), 0)

    c_valid = jnp.where(suffix_case, j >= len2 - k, j + len2 <= len1)
    c_valid &= (qread[:, None] != r2) & valid
    c_n = jnp.where(c_valid, len2, 0).astype(jnp.int32)
    c_o1 = jnp.where(suffix_case, j + k - len2, j).astype(jnp.int32)
    c_o1 = jnp.maximum(c_o1, 0)
    c_o1 = jnp.broadcast_to(c_o1, r2.shape)

    n_words = rows1.shape[-1] - 1
    wp = rows1.shape[-1]
    q, h = r2.shape
    blk1 = jnp.broadcast_to(rows1[:, None, :], (q, h, wp)).reshape(-1, wp)
    blk2 = rows2.reshape(-1, wp)
    cz = jnp.broadcast_to(c_n, r2.shape)
    edge_ok, cont_ok = _dual_check(
        blk1, blk2, e_o1.reshape(-1), e_o2.reshape(-1), e_n.reshape(-1),
        c_o1.reshape(-1), cz.reshape(-1), n_words=n_words)
    edge_ok = edge_ok.reshape(q, h) & e_valid
    cont_ok = cont_ok.reshape(q, h) & c_valid
    return edge_ok, cont_ok


class DeviceCompactResult(NamedTuple):
    """Device-side compacted verified hits for one window chunk.

    Rows are emitted in (window, table-slot) order == the reference's
    (r1, j, bucket-scan) relation order.  `count` may exceed `out_cap`
    (compaction overflow) — the caller must then re-run the chunk through
    an exact fallback path."""
    wi: jax.Array        # (out_cap,) int32 window index within the chunk
    r2: jax.Array        # (out_cap,) int32 candidate read id
    orient: jax.Array    # (out_cap,) int32 hit orientation
    typ: jax.Array       # (out_cap,) int32 record type
    flags: jax.Array     # (out_cap,) int32 bit0=edge_ok bit1=cont_ok
    count: jax.Array     # () int32 verified rows in the chunk
    over: jax.Array      # (Q,) bool window's key bucket exceeded hit_cap


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_words", "max_len", "hit_cap", "out_cap"))
def device_overlap_compact(packed, packed_all, lengths, starts, keys, tread,
                           torient, ttyp, *, k, n_words, max_len, hit_cap,
                           out_cap):
    """Same pipeline as `device_overlap`, plus on-device compaction of the
    verified-hit grid into dense rows, so only O(hits) words travel back to
    the host per chunk instead of the full (Q, hit_cap) grids.  This is the
    production single-chip overlap step (the reference's hot loop,
    src/BuildGraph/src/OverlapGraph.cpp:401-478,631-674)."""
    n_reads = lengths.shape[0]
    qread = (starts // max_len).astype(jnp.int32)
    qj = (starts % max_len).astype(jnp.int32)

    wbase = qj // 16
    phase = (2 * (qj % 16)).astype(jnp.uint32)
    wlim = packed.shape[1] - 1
    w0 = packed[qread, jnp.minimum(wbase, wlim)].astype(jnp.uint64)
    w1 = packed[qread, jnp.minimum(wbase + 1, wlim)].astype(jnp.uint64)
    w2 = packed[qread, jnp.minimum(wbase + 2, wlim)].astype(jnp.uint64)
    hi = (w0 << jnp.uint64(32)) | w1
    phase64 = phase.astype(jnp.uint64)
    win = jnp.where(
        phase64 == 0, hi,
        (hi << phase64) | ((w2 >> (jnp.uint64(31) - phase64))
                           >> jnp.uint64(1)))
    kk = min(k, 32)
    qcode = win >> jnp.uint64(64 - 2 * kk)

    # int32 table positions: halves the (Q, H) index temporaries under
    # jax_enable_x64; fingerprint tables are < 2^31 entries (4 per read)
    lo = jnp.searchsorted(keys, qcode, side="left").astype(jnp.int32)
    hi_i = jnp.searchsorted(keys, qcode, side="right").astype(jnp.int32)
    over = (hi_i - lo) > hit_cap
    tpos = lo[:, None] + jnp.arange(hit_cap, dtype=jnp.int32)[None, :]
    valid = (tpos < hi_i[:, None]) & ~over[:, None]
    tpos = jnp.clip(tpos, 0, keys.shape[0] - 1)
    r2 = jnp.where(valid, tread[tpos], 0).astype(jnp.int32)
    orient = jnp.where(valid, torient[tpos], 0).astype(jnp.int32)
    typ = jnp.where(valid, ttyp[tpos], 0).astype(jnp.int32)

    edge_ok, cont_ok = candidate_checks(packed_all, lengths, qread, qj, r2,
                                        orient, valid, k=k, n_words=n_words)

    # ---- compaction: scatter kept rows to their rank ------------------
    q = qread.shape[0]
    keep = (edge_ok | cont_ok).reshape(-1)
    win_idx = jnp.broadcast_to(
        jnp.arange(q, dtype=jnp.int32)[:, None], (q, hit_cap)).reshape(-1)
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep, pos, out_cap)  # OOB -> dropped
    flags = (edge_ok.astype(jnp.int32)
             | (cont_ok.astype(jnp.int32) << 1)).reshape(-1)

    def scat(vals):
        return jnp.zeros(out_cap, jnp.int32).at[idx].set(
            vals, mode="drop")

    return DeviceCompactResult(
        wi=scat(win_idx), r2=scat(r2.reshape(-1)),
        orient=scat(orient.reshape(-1)), typ=scat(typ.reshape(-1)),
        flags=scat(flags), count=keep.sum().astype(jnp.int32), over=over)


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_words", "max_len", "cand_cap", "out_cap"))
def device_overlap_dense(packed, packed_all, lengths, starts, tmeta,
                         keys, *, k, n_words, max_len, cand_cap, out_cap):
    """Dense-candidate device overlap step — the production formulation.

    Instead of a (Q, hit_cap) candidate grid (mostly invalid slots: mean
    bucket occupancy is ~0.5, so a 16-wide grid wastes ~30x of the
    verification work and its memory), candidates are COMPACTED on device
    first: bucket ranges from the searchsorted lookup are flattened into a
    dense (cand_cap,) candidate list via an inverse-searchsorted over the
    per-window prefix sums, and only those are verified.  Hits then
    compact to the same 8-byte wire rows as device_overlap_packed.

    tmeta: (M,) int32 packed table metadata — read << 3 | orient << 1 |
    typ (one gather per candidate instead of three; requires
    n_reads < 2^28, asserted by the engine).

    Returns (data (2, out_cap) int32, meta uint32 vector
    [n_hits, n_candidates]): `meta[1] > cand_cap` or `meta[0] > out_cap`
    means the chunk must be re-run through the exact host path.  There is
    no per-window bucket cap at all — overflow is global per chunk."""
    q = starts.shape[0]
    qread = (starts // max_len).astype(jnp.int32)
    qj = (starts % max_len).astype(jnp.int32)

    wbase = qj // 16
    phase = (2 * (qj % 16)).astype(jnp.uint32)
    wlim = packed.shape[1] - 1
    w0 = packed[qread, jnp.minimum(wbase, wlim)].astype(jnp.uint64)
    w1 = packed[qread, jnp.minimum(wbase + 1, wlim)].astype(jnp.uint64)
    w2 = packed[qread, jnp.minimum(wbase + 2, wlim)].astype(jnp.uint64)
    hi = (w0 << jnp.uint64(32)) | w1
    phase64 = phase.astype(jnp.uint64)
    win64 = jnp.where(
        phase64 == 0, hi,
        (hi << phase64) | ((w2 >> (jnp.uint64(31) - phase64))
                           >> jnp.uint64(1)))
    kk = min(k, 32)
    qcode = win64 >> jnp.uint64(64 - 2 * kk)

    lo = jnp.searchsorted(keys, qcode, side="left").astype(jnp.int32)
    hi_i = jnp.searchsorted(keys, qcode, side="right").astype(jnp.int32)
    counts = hi_i - lo
    cum = jnp.concatenate([jnp.zeros(1, jnp.int64),
                           jnp.cumsum(counts.astype(jnp.int64))])
    n_cand = cum[q]

    # ---- candidate compaction: flat slot -> (window, bucket rank) -----
    slots = jnp.arange(cand_cap, dtype=jnp.int64)
    cwin = (jnp.searchsorted(cum, slots, side="right") - 1).astype(jnp.int32)
    cvalid = slots < n_cand
    cwin = jnp.clip(cwin, 0, q - 1)
    rank = slots - cum[cwin]
    tpos = jnp.clip(lo[cwin] + rank, 0, tmeta.shape[0] - 1)
    meta_g = jnp.where(cvalid, tmeta[tpos], 0)
    r2 = meta_g >> 3
    orient = (meta_g >> 1) & 3
    typ = meta_g & 1

    cread = qread[cwin]
    cj = qj[cwin]
    edge_ok, cont_ok = candidate_checks(
        packed_all, lengths, cread, cj, r2[:, None], orient[:, None],
        cvalid[:, None], k=k, n_words=n_words)
    edge_ok = edge_ok[:, 0]
    cont_ok = cont_ok[:, 0]

    # ---- hit compaction to wire rows ----------------------------------
    keep = edge_ok | cont_ok
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep, pos, out_cap)
    flags = edge_ok.astype(jnp.int32) | (cont_ok.astype(jnp.int32) << 1)
    word0 = cwin | (orient << 21) | (typ << 23) | (flags << 24)

    def scat(vals):
        return jnp.zeros(out_cap, jnp.int32).at[idx].set(vals, mode="drop")

    data = jnp.stack([scat(word0), scat(r2)])
    # clamp so a >=2^32 candidate count saturates instead of wrapping to a
    # small value that would skip the exact host fallback in _device_relation
    meta = jnp.stack([keep.sum().astype(jnp.uint32),
                      jnp.minimum(n_cand, 0xFFFFFFFF).astype(jnp.uint32)])
    return data, meta


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_words", "max_len", "cand_cap", "out_cap",
                     "rbits"))
def device_overlap_dense32(packed, packed_all, lengths, starts, tmeta,
                           keys, *, k, n_words, max_len, cand_cap, out_cap,
                           rbits):
    """device_overlap_dense with a 4-byte wire row (half the device->host
    bytes of the 8-byte rows).

    Row u32 = r2t << (dbits+4) | orient << (dbits+2) | (flags-1) << dbits
    | min(dwi, esc), where r2t = r2 << 1 | typ (rbits bits), dwi is the
    delta of the window index from the previous hit (rows are emitted in
    window order), and dwi == esc marks an escape whose full window index
    ships in a side stream (u32, rare).  Requires rbits + 8 <= 32
    (callers fall back to the 8-byte format otherwise).

    Returns (data (out_cap,) int32, esc (esc_cap,) int32, meta
    [n_hits, n_cand, n_esc])."""
    dbits = 32 - 4 - rbits
    assert dbits >= 4, rbits
    esc = (1 << dbits) - 1
    q = starts.shape[0]
    qread = (starts // max_len).astype(jnp.int32)
    qj = (starts % max_len).astype(jnp.int32)

    wbase = qj // 16
    phase = (2 * (qj % 16)).astype(jnp.uint32)
    wlim = packed.shape[1] - 1
    w0 = packed[qread, jnp.minimum(wbase, wlim)].astype(jnp.uint64)
    w1 = packed[qread, jnp.minimum(wbase + 1, wlim)].astype(jnp.uint64)
    w2 = packed[qread, jnp.minimum(wbase + 2, wlim)].astype(jnp.uint64)
    hi = (w0 << jnp.uint64(32)) | w1
    phase64 = phase.astype(jnp.uint64)
    win64 = jnp.where(
        phase64 == 0, hi,
        (hi << phase64) | ((w2 >> (jnp.uint64(31) - phase64))
                           >> jnp.uint64(1)))
    kk = min(k, 32)
    qcode = win64 >> jnp.uint64(64 - 2 * kk)

    lo = jnp.searchsorted(keys, qcode, side="left").astype(jnp.int32)
    hi_i = jnp.searchsorted(keys, qcode, side="right").astype(jnp.int32)
    counts = hi_i - lo
    cum = jnp.concatenate([jnp.zeros(1, jnp.int64),
                           jnp.cumsum(counts.astype(jnp.int64))])
    n_cand = cum[q]

    slots = jnp.arange(cand_cap, dtype=jnp.int64)
    cwin = (jnp.searchsorted(cum, slots, side="right") - 1).astype(jnp.int32)
    cvalid = slots < n_cand
    cwin = jnp.clip(cwin, 0, q - 1)
    rank = slots - cum[cwin]
    tpos = jnp.clip(lo[cwin] + rank, 0, tmeta.shape[0] - 1)
    meta_g = jnp.where(cvalid, tmeta[tpos], 0)
    r2 = meta_g >> 3
    orient = (meta_g >> 1) & 3
    typ = meta_g & 1

    cread = qread[cwin]
    cj = qj[cwin]
    edge_ok, cont_ok = candidate_checks(
        packed_all, lengths, cread, cj, r2[:, None], orient[:, None],
        cvalid[:, None], k=k, n_words=n_words)
    edge_ok = edge_ok[:, 0]
    cont_ok = cont_ok[:, 0]

    keep = edge_ok | cont_ok
    pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    idx = jnp.where(keep, pos, out_cap)
    flags = edge_ok.astype(jnp.int32) | (cont_ok.astype(jnp.int32) << 1)

    def scat(vals):
        return jnp.zeros(out_cap, jnp.int32).at[idx].set(vals, mode="drop")

    n_hits = keep.sum().astype(jnp.int32)
    wis = scat(cwin)
    dwi = wis - jnp.concatenate([jnp.zeros(1, jnp.int32), wis[:-1]])
    in_range = jnp.arange(out_cap, dtype=jnp.int32) < n_hits
    dwi = jnp.where(in_range, dwi, 0)
    is_esc = dwi >= esc
    r2t = (r2 << 1) | typ
    word = (scat(r2t << (dbits + 4))
            | scat(orient << (dbits + 2))
            | scat((flags - 1) << dbits)
            | jnp.minimum(dwi, esc))
    # escape side stream: full window index per escaping hit, in order
    epos = jnp.cumsum(is_esc.astype(jnp.int32)) - 1
    eidx = jnp.where(is_esc & in_range, epos, out_cap)
    esc_stream = jnp.zeros(out_cap, jnp.int32).at[eidx].set(
        wis, mode="drop")
    n_esc = (is_esc & in_range).sum().astype(jnp.uint32)
    meta = jnp.stack([n_hits.astype(jnp.uint32),
                      jnp.minimum(n_cand, 0xFFFFFFFF).astype(jnp.uint32),
                      n_esc])
    return word, esc_stream, meta


@functools.partial(
    jax.jit,
    static_argnames=("k", "n_words", "max_len", "hit_cap", "out_cap"))
def device_overlap_packed(packed, packed_all, lengths, starts, keys, tread,
                          torient, ttyp, *, k, n_words, max_len, hit_cap,
                          out_cap):
    """`device_overlap_compact` with a transfer-minimal return layout:
    ONE (2, out_cap) int32 data array — row 0 packs
    wi | orient<<21 | typ<<23 | flags<<24 (window index < 2^21 enforced by
    the 2M-window chunk cap), row 1 is r2 — plus ONE small uint32 meta
    vector [count, packed-overflow-bits...].  8 B/hit over the wire; two
    pulls per chunk (meta, then data[:, :count])."""
    assert starts.shape[0] <= (1 << 21), "chunk exceeds wi packing width"
    res = device_overlap_compact(
        packed, packed_all, lengths, starts, keys, tread, torient, ttyp,
        k=k, n_words=n_words, max_len=max_len, hit_cap=hit_cap,
        out_cap=out_cap)
    word0 = (res.wi | (res.orient << 21) | (res.typ << 23)
             | (res.flags << 24))
    data = jnp.stack([word0, res.r2])
    q = res.over.shape[0]
    pad = (-q) % 32
    bits = jnp.pad(res.over.astype(jnp.uint32), (0, pad)).reshape(-1, 32)
    packed_over = (bits << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
        axis=1, dtype=jnp.uint32)
    meta = jnp.concatenate(
        [res.count.astype(jnp.uint32)[None], packed_over])
    return data, meta


class DeviceOverlapEngine:
    """Host wrapper: builds device-resident table/store and exposes the
    jitted overlap step over window chunks."""

    def __init__(self, store: ReadStore, table: FingerprintTable,
                 hit_cap: int = 16):
        self.store = store
        self.k = table.k
        self.hit_cap = hit_cap
        self.packed = jax.device_put(jnp.asarray(store.packed))
        self.packed_all = jax.device_put(
            make_packed_all(store.packed, store.packed_rc))
        self.lengths = jax.device_put(
            jnp.asarray(store.lengths, jnp.int32))
        self.keys = jax.device_put(jnp.asarray(table.keys))
        self.tread = jax.device_put(jnp.asarray(table.read, jnp.int32))
        self.torient = jax.device_put(jnp.asarray(table.orient, jnp.int32))
        self.ttyp = jax.device_put(jnp.asarray(table.typ, jnp.int32))
        # packed metadata column for the dense path (one gather/candidate)
        assert store.n_reads < (1 << 28), "dense path: read id packing"
        self.tmeta = jax.device_put(jnp.asarray(
            (table.read.astype(np.int32) << 3)
            | (table.orient.astype(np.int32) << 1)
            | table.typ.astype(np.int32)))

    def window_starts(self) -> np.ndarray:
        lens = self.store.lengths.astype(np.int64)
        n_win = lens - self.k
        reads = np.repeat(np.arange(self.store.n_reads, dtype=np.int64),
                          n_win)
        offs = np.concatenate([np.arange(c) for c in n_win])
        return (reads * self.store.max_len + offs).astype(np.int64)

    def run(self, starts) -> DeviceOverlapResult:
        return device_overlap(
            self.packed, self.packed_all, self.lengths,
            jnp.asarray(starts), self.keys, self.tread, self.torient,
            self.ttyp, k=self.k, n_words=self.store.n_words,
            max_len=self.store.max_len, hit_cap=self.hit_cap)

    def run_chunked(self, starts: np.ndarray, chunk: int = 1 << 17):
        """Yield per-chunk results over fixed-size window chunks (the last
        chunk is padded with repeats of the final window so every step
        reuses one compiled program and fits HBM)."""
        q = len(starts)
        for s in range(0, q, chunk):
            e = min(s + chunk, q)
            part = starts[s:e]
            if e - s < chunk:
                part = np.concatenate(
                    [part, np.full(chunk - (e - s), part[-1],
                                   part.dtype)])
            yield e - s, self.run(part)

    def run_compact(self, starts, out_cap: int) -> DeviceCompactResult:
        return device_overlap_compact(
            self.packed, self.packed_all, self.lengths,
            jnp.asarray(starts), self.keys, self.tread, self.torient,
            self.ttyp, k=self.k, n_words=self.store.n_words,
            max_len=self.store.max_len, hit_cap=self.hit_cap,
            out_cap=out_cap)

    def run_packed(self, starts, out_cap: int):
        return device_overlap_packed(
            self.packed, self.packed_all, self.lengths,
            jnp.asarray(starts), self.keys, self.tread, self.torient,
            self.ttyp, k=self.k, n_words=self.store.n_words,
            max_len=self.store.max_len, hit_cap=self.hit_cap,
            out_cap=out_cap)

    def run_dense(self, starts, cand_cap: int, out_cap: int):
        return device_overlap_dense(
            self.packed, self.packed_all, self.lengths,
            jnp.asarray(starts), self.tmeta, self.keys, k=self.k,
            n_words=self.store.n_words, max_len=self.store.max_len,
            cand_cap=cand_cap, out_cap=out_cap)

    def run_dense32(self, starts, cand_cap: int, out_cap: int, rbits: int):
        return device_overlap_dense32(
            self.packed, self.packed_all, self.lengths,
            jnp.asarray(starts), self.tmeta, self.keys, k=self.k,
            n_words=self.store.n_words, max_len=self.store.max_len,
            cand_cap=cand_cap, out_cap=out_cap, rbits=rbits)

    def run_dense32_chunked(self, starts: np.ndarray, chunk: int = 1 << 20,
                            cand_cap: int = None, out_cap: int = None,
                            rbits: int = None):
        """run_dense_chunked with the 4-byte wire format (word, esc, meta
        per chunk)."""
        if cand_cap is None:
            cand_cap = 4 * chunk
        if out_cap is None:
            out_cap = chunk
        if rbits is None:
            rbits = max(int(self.store.n_reads).bit_length() + 1, 8)
        q = len(starts)
        pending = None
        for s in range(0, q, chunk):
            e = min(s + chunk, q)
            part = starts[s:e]
            if e - s < chunk:
                part = np.concatenate(
                    [part, np.full(chunk - (e - s), part[-1], part.dtype)])
            res = self.run_dense32(part, cand_cap, out_cap, rbits)
            if pending is not None:
                yield pending
            pending = (e - s,) + res
        if pending is not None:
            yield pending

    def run_dense_chunked(self, starts: np.ndarray, chunk: int = 1 << 20,
                          cand_cap: int = None, out_cap: int = None):
        """Yield (n_real, data, meta) per chunk (1-deep dispatch
        pipeline), dense-candidate formulation."""
        if cand_cap is None:
            cand_cap = 4 * chunk
        if out_cap is None:
            out_cap = chunk
        q = len(starts)
        pending = None
        for s in range(0, q, chunk):
            e = min(s + chunk, q)
            part = starts[s:e]
            if e - s < chunk:
                part = np.concatenate(
                    [part, np.full(chunk - (e - s), part[-1], part.dtype)])
            res = self.run_dense(part, cand_cap, out_cap)
            if pending is not None:
                yield pending
            pending = (e - s,) + res
        if pending is not None:
            yield pending

    def run_packed_chunked(self, starts: np.ndarray, chunk: int = 1 << 21,
                           out_cap: int = None):
        """Yield (n_real, data, meta) per fixed-size chunk with a 1-deep
        dispatch pipeline (chunk i+1 launches before chunk i's results are
        pulled), overlapping host compaction with device work."""
        if out_cap is None:
            out_cap = chunk
        q = len(starts)
        pending = None
        for s in range(0, q, chunk):
            e = min(s + chunk, q)
            part = starts[s:e]
            if e - s < chunk:
                part = np.concatenate(
                    [part, np.full(chunk - (e - s), part[-1], part.dtype)])
            res = self.run_packed(part, out_cap)
            if pending is not None:
                yield pending
            pending = (e - s,) + res
        if pending is not None:
            yield pending
