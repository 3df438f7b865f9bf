"""Full overlap/containment relation computation.

For every read r1 and window j in [0, len1-k) (the reference's substring loop,
reference: src/BuildGraph/src/OverlapGraph.cpp:401,638), look up the window's
(k=minOverlap-1)-mer in the fingerprint table and verify each hit:

- containment check (reference: OverlapGraph.cpp:517-554): read2 lies entirely
  within read1 — windows of length len2;
- edge check (reference: OverlapGraph.cpp:567-595): suffix-prefix overlap that
  extends to the reads' ends — only j >= 1 qualifies
  (reference: OverlapGraph.cpp:638 starts the edge loop at j=1).

The relation is ORDER-COMPLETE: hits per (r1, j) are sorted by
(read2, record-type), which equals the reference's hash-bucket scan order
(file order), so the sequential replay in `disco_tpu.buildg` can reproduce
the reference's outputs bit-for-bit. Unlike the reference, candidate
verification itself is order-free and runs as one big device batch.
"""
import time
from dataclasses import dataclass

import numpy as np

from ..index.table import FingerprintTable
from ..io.readstore import ReadStore
from ..utils.logging import log
from . import verify as _verify

# Orientation tables, indexed by hit orientation 0..3
# (reference: src/BuildGraph/src/OverlapGraph.cpp:428-433,660-666)
_EDGE_ORIENT = np.array([3, 0, 2, 1], np.int8)   # hit orient -> edge orient
_IS_SUFFIX_CASE = np.array([0, 1, 0, 1], np.bool_)  # orient 1/3: match at s2 end
_USE_RC = np.array([0, 0, 1, 1], np.bool_)       # orient 2/3: s2 = rc(read2)


@dataclass
class OverlapRelation:
    """Struct-of-arrays of verified hits, sorted by (r1, j, r2, typ).

    r1, r2 : int32, 0-based read indices
    j      : int32 window start in read1 (reference's substring position)
    orient : int8 hit orientation (0..3, table semantics)
    typ    : int8 table record type (0 prefix, 1 suffix) — tie-break order
    cont_ok: bool — read2 contained in read1 at this hit
    edge_ok: bool — proper suffix-prefix overlap at this hit (j>=1 enforced)
    """
    r1: np.ndarray
    j: np.ndarray
    r2: np.ndarray
    orient: np.ndarray
    typ: np.ndarray
    cont_ok: np.ndarray
    edge_ok: np.ndarray
    k: int

    def __len__(self):
        return len(self.r1)


def window_codes(store: ReadStore, k: int):
    """Return (qread, qj, qcode): one query per (read, window j in [0,len-k)).
    Codes are the first min(k,32) bases of each window, packed uint64,
    computed with a three-word funnel over the packed words (no per-base
    unpacking; same formula as the device pipeline, overlap/device.py)."""
    kk = min(k, 32)
    n = store.n_reads
    lens = store.lengths.astype(np.int64)
    n_win = lens - k  # windows j in [0, len-k)
    if (n_win <= 0).any():
        raise ValueError("read shorter than min overlap")
    qread = np.repeat(np.arange(n, dtype=np.int32), n_win)
    cum = np.cumsum(n_win)
    offs = np.arange(int(cum[-1]), dtype=np.int64) - np.repeat(
        cum - n_win, n_win)
    qj = offs.astype(np.int32)

    words = store.packed
    wlim = words.shape[1] - 1
    wbase = qj // 16
    phase = (2 * (qj % 16)).astype(np.uint64)
    w0 = words[qread, np.minimum(wbase, wlim)].astype(np.uint64)
    w1 = words[qread, np.minimum(wbase + 1, wlim)].astype(np.uint64)
    w2 = words[qread, np.minimum(wbase + 2, wlim)].astype(np.uint64)
    hi = (w0 << np.uint64(32)) | w1
    win = np.where(phase == 0, hi,
                   (hi << phase) | ((w2 >> (np.uint64(31) - phase))
                                    >> np.uint64(1)))
    qcode = win >> np.uint64(64 - 2 * kk)
    return qread, qj, qcode


def default_backend() -> str:
    """Production backend selection: the accelerator (any non-CPU JAX
    platform) when present, else the native C++/OpenMP host kernel.
    Overridable via DISCO_TPU_BACKEND=native|device|xla.  A JAX that
    fails to start raises: it never silently degrades to the host."""
    import os
    env = os.environ.get("DISCO_TPU_BACKEND")
    if env:
        return env
    import jax
    if jax.default_backend() != "cpu":
        return "device"
    return "native"


def compute_relation(store: ReadStore, table: FingerprintTable,
                     chunk: int = 1 << 22,
                     backend: str = None) -> OverlapRelation:
    """Verified overlap/containment relation over all read windows.

    backend="device": the jit device pipeline (overlap/device.py) — window
    codes, sorted-table lookup, candidate verification and hit compaction
    all on the accelerator; per-window bucket overflow beyond the hit cap
    falls back to the exact XLA expansion path.  Default when an
    accelerator is present (see `default_backend`).

    backend="native": the C++/OpenMP kernel (disco_tpu/native/overlap.cpp)
    — window scan, radix-accelerated sorted-table lookup, and packed-word
    verification in one pass, emitting hits directly in relation order.
    Default on CPU-only hosts.

    backend="xla": the jit-verifier path kept as a cross-check oracle.
    Candidate pairs are expanded and verified in chunks of `chunk`
    candidates so the host never materialises the full candidate list."""
    if backend is None:
        backend = default_backend()
        if backend == "device":
            # below ~1M windows the jit compile is assumed to outweigh the
            # device's gain; this threshold is not timed on the H100
            # (pipeline.run_buildg applies the same cut)
            n_win = int(store.lengths.sum()) - store.n_reads * table.k
            if n_win < (1 << 20):
                backend = "native"
    if backend == "native":
        from .. import native
        out = native.overlap_relation(
            store.packed, store.packed_rc, store.lengths, table.keys,
            table.read, table.orient, table.typ, table.k)
        return OverlapRelation(
            r1=out["r1"], j=out["j"], r2=out["r2"], orient=out["orient"],
            typ=out["typ"], cont_ok=out["cont_ok"], edge_ok=out["edge_ok"],
            k=table.k)
    if backend == "device":
        return _device_relation(store, table)
    if backend != "xla":
        raise ValueError(f"unknown backend {backend!r}")
    k = table.k
    qread, qj, qcode = window_codes(store, k)
    rows = _xla_rows(store, table, qread, qj, qcode, chunk)
    return _sorted_relation(store, rows, k)


def _xla_rows(store: ReadStore, table: FingerprintTable, qread, qj, qcode,
              chunk: int = 1 << 22):
    """Expand + verify the given windows with the jitted verifier; returns
    the kept-row dict (unsorted).  Shared by the XLA backend and the device
    backend's bucket-overflow fallback."""
    k = table.k
    lo, hi = table.lookup_ranges(qcode)
    counts = (hi - lo).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])
    total = int(cum[-1])
    # don't pad a small workload up to a huge jit batch: round the chunk
    # down to the next power of two >= total
    while chunk >= 2 and chunk // 2 >= total:
        chunk //= 2

    n = store.n_reads
    packed_all = _verify.make_packed_all(store.packed, store.packed_rc)

    kept = {"r1": [], "j": [], "r2": [], "orient": [], "typ": [],
            "cont_ok": [], "edge_ok": []}

    # chunk boundaries in candidate space aligned to window groups
    q_starts = [0]
    while q_starts[-1] < len(qread):
        nxt = int(np.searchsorted(cum, cum[q_starts[-1]] + chunk,
                                  side="left"))
        nxt = max(nxt, q_starts[-1] + 1)
        q_starts.append(min(nxt, len(qread)))

    for qs, qe in zip(q_starts[:-1], q_starts[1:]):
        cnt = counts[qs:qe]
        tot = int(cnt.sum())
        if tot == 0:
            continue
        pair_q = np.repeat(np.arange(qs, qe, dtype=np.int64), cnt)
        rank = np.arange(tot, dtype=np.int64) - np.repeat(
            (cum[qs:qe] - cum[qs]), cnt)
        tpos = lo[pair_q] + rank

        r1 = qread[pair_q]
        j = qj[pair_q]
        r2 = table.read[tpos]
        orient = table.orient[tpos]
        typ = table.typ[tpos]

        len1 = store.lengths[r1].astype(np.int32)
        len2 = store.lengths[r2].astype(np.int32)
        suffix_case = _IS_SUFFIX_CASE[orient]
        use_rc = _USE_RC[orient]

        # edge (reference: OverlapGraph.cpp:567-595)
        e_valid = np.where(suffix_case, j <= len2 - k, (len1 - j) < len2)
        e_valid &= (j >= 1) & (r1 != r2)
        e_n = np.where(suffix_case, j + k, len1 - j).astype(np.int32)
        e_o1 = np.where(suffix_case, 0, j).astype(np.int32)
        e_o2 = np.where(suffix_case, len2 - e_n, 0).astype(np.int32)

        # containment (reference: OverlapGraph.cpp:517-554)
        c_valid = np.where(suffix_case, j >= len2 - k, j + len2 <= len1)
        c_valid &= r1 != r2
        c_n = len2.astype(np.int32)
        c_o1 = np.where(suffix_case, j + k - len2, j).astype(np.int32)
        c_o2 = np.zeros_like(c_o1)

        rows2 = (r2 + np.where(use_rc, n, 0)).astype(np.int32)

        def run(o1, o2, nlen, valid):
            # pad to a multiple of the chunk size so the jitted verifier
            # compiles for at most a couple of shapes
            nlen = np.where(valid, nlen, 0)
            pad = (-len(o1)) % chunk
            if pad:
                z = np.zeros(pad, np.int32)
                ok = _verify.verify_windows(
                    packed_all,
                    np.concatenate([r1.astype(np.int32), z]),
                    np.concatenate([rows2, z]),
                    np.concatenate([o1, z]), np.concatenate([o2, z]),
                    np.concatenate([nlen, z]), n_words=store.n_words)
                return np.asarray(ok)[:len(o1)] & valid
            ok = _verify.verify_windows(
                packed_all, r1.astype(np.int32), rows2, o1, o2, nlen,
                n_words=store.n_words)
            return np.asarray(ok) & valid

        edge_ok = run(e_o1, e_o2, e_n, e_valid)
        cont_ok = run(c_o1, c_o2, c_n, c_valid)
        keep = edge_ok | cont_ok
        kept["r1"].append(r1[keep].astype(np.int32))
        kept["j"].append(j[keep])
        kept["r2"].append(r2[keep].astype(np.int32))
        kept["orient"].append(orient[keep])
        kept["typ"].append(typ[keep])
        kept["cont_ok"].append(cont_ok[keep])
        kept["edge_ok"].append(edge_ok[keep])

    def cat(name, dtype=None):
        if not kept[name]:
            return np.zeros(0, dtype or np.int32)
        return np.concatenate(kept[name])

    return {"r1": cat("r1"), "j": cat("j"), "r2": cat("r2"),
            "orient": cat("orient", np.int8), "typ": cat("typ", np.int8),
            "cont_ok": cat("cont_ok", np.bool_),
            "edge_ok": cat("edge_ok", np.bool_)}


def _sorted_relation(store: ReadStore, rows: dict, k: int) -> OverlapRelation:
    """Sort kept rows into the reference's relation order: hits per (r1, j)
    ordered like the bucket scan — by the candidate's FILE index (insertion
    order), prefix record first."""
    fidx2 = store.file_index[rows["r2"]]
    order = np.lexsort((rows["typ"], fidx2, rows["j"], rows["r1"]))
    return OverlapRelation(
        r1=rows["r1"][order], j=rows["j"][order], r2=rows["r2"][order],
        orient=rows["orient"][order], typ=rows["typ"][order],
        cont_ok=rows["cont_ok"][order], edge_ok=rows["edge_ok"][order], k=k)


def _device_relation(store: ReadStore, table: FingerprintTable,
                     chunk: int = None, cand_factor: int = 4,
                     ) -> OverlapRelation:
    """Production on-device overlap phase: the full
    window scan runs through the dense-candidate jit pipeline
    (overlap/device.py::device_overlap_dense — candidates compacted on
    device BEFORE verification, hits compacted to 8-byte wire rows; one
    data + one tiny meta pull per chunk).  Chunks whose candidate or hit
    count exceeds the static caps (cand_factor * chunk / chunk) are
    re-verified exactly on the host via the XLA expansion path.  Output
    is identical to the native backend: same rows, same
    (r1, j, bucket-scan) order.

    Displaces the reference's hot loop
    (src/BuildGraph/src/OverlapGraph.cpp:631-674)."""
    import os

    from .device import DeviceOverlapEngine

    if chunk is None:
        chunk = int(os.environ.get("DISCO_TPU_DEVICE_CHUNK", 1 << 20))
    cand_cap = cand_factor * chunk
    k = table.k
    qread, qj, qcode = window_codes(store, k)
    q = len(qread)
    eng = DeviceOverlapEngine(store, table)
    starts = (qread.astype(np.int64) * store.max_len
              + qj.astype(np.int64))

    parts = {n: [] for n in ("r1", "j", "r2", "orient", "typ",
                             "cont_ok", "edge_ok")}
    fallback_windows = []

    def collect(s, n_real, data, meta):
        meta = np.asarray(meta)          # pull 1: [n_hits, n_candidates]
        count = int(meta[0])
        if int(meta[1]) > cand_cap or count > chunk:
            # static-cap overflow: exact host re-run of the whole chunk
            fallback_windows.append(np.arange(s, s + n_real))
            return
        rows = np.asarray(data[:, :count])  # pull 2: only occupied slots
        w0 = rows[0]
        wi = w0 & 0x1FFFFF
        sel = wi < n_real  # drop pad-window repeats
        gwi = s + wi[sel]
        w0 = w0[sel]
        parts["r1"].append(qread[gwi])
        parts["j"].append(qj[gwi])
        parts["r2"].append(rows[1][sel])
        parts["orient"].append(((w0 >> 21) & 3).astype(np.int8))
        parts["typ"].append(((w0 >> 23) & 1).astype(np.int8))
        parts["edge_ok"].append(((w0 >> 24) & 1).astype(bool))
        parts["cont_ok"].append(((w0 >> 25) & 1).astype(bool))

    # 4-byte wire format (r2t | orient | flags | dwi + escape stream)
    # halves the device->host bytes of the 8-byte rows; requires the
    # packed read id to fit its field (fallback: 8-byte format)
    rbits = max(int(store.n_reads).bit_length() + 1, 8)
    # test hook: force a wider read field (= narrower dwi field, more
    # escapes) to exercise the escape stream on small fixtures
    rbits = int(os.environ.get("DISCO_TPU_WIRE_RBITS", rbits))
    wire32 = (32 - 4 - rbits) >= 4 and not os.environ.get(
        "DISCO_TPU_WIRE64")
    dbits = 32 - 4 - rbits
    esc_code = (1 << dbits) - 1

    def collect32(s, n_real, word, esc_stream, meta):
        meta = np.asarray(meta)       # pull 1: [n_hits, n_cand, n_esc]
        count = int(meta[0])
        if int(meta[1]) > cand_cap or count > chunk:
            fallback_windows.append(np.arange(s, s + n_real))
            return
        w = np.asarray(word[:count]).view(np.uint32)   # pull 2
        n_esc = int(meta[2])
        esc_vals = (np.asarray(esc_stream[:n_esc]).astype(np.int64)
                    if n_esc else np.zeros(0, np.int64))  # pull 3 (rare)
        dwi = (w & esc_code).astype(np.int64)
        # window-index reconstruction: cumsum of deltas with absolute
        # resets at escapes (value esc_code), forward-filled adjustment
        c = np.cumsum(np.where(dwi == esc_code, 0, dwi))
        ep = np.flatnonzero(dwi == esc_code)
        if len(ep):
            assert len(ep) == n_esc, (len(ep), n_esc)
            vals = esc_vals - c[ep]
            # forward-fill: adjustment active from each escape onward
            a = np.zeros(count, np.int64)
            a[ep] = np.concatenate([[vals[0]], np.diff(vals)])
            wi = c + np.cumsum(a)
        else:
            wi = c
        sel = wi < n_real
        gwi = s + wi[sel]
        ws = w[sel]
        parts["r1"].append(qread[gwi])
        parts["j"].append(qj[gwi])
        r2t = (ws >> np.uint32(dbits + 4)).astype(np.int64)
        parts["r2"].append((r2t >> 1).astype(np.int32))
        parts["typ"].append((r2t & 1).astype(np.int8))
        parts["orient"].append(
            ((ws >> np.uint32(dbits + 2)) & 3).astype(np.int8))
        flags = ((ws >> np.uint32(dbits)) & 3).astype(np.int8) + 1
        parts["edge_ok"].append((flags & 1).astype(bool))
        parts["cont_ok"].append((flags & 2).astype(bool))

    s = 0
    t0 = time.perf_counter()
    t_first = None
    if wire32:
        chunks = eng.run_dense32_chunked(starts, chunk=chunk,
                                         cand_cap=cand_cap, out_cap=chunk,
                                         rbits=rbits)
        collect_fn = collect32
    else:
        chunks = eng.run_dense_chunked(starts, chunk=chunk,
                                       cand_cap=cand_cap, out_cap=chunk)
        collect_fn = collect
    n_chunks = 0
    for n_real, *res in chunks:
        collect_fn(s, n_real, *res)
        s += n_real
        n_chunks += 1
        if t_first is None:
            t_first = time.perf_counter() - t0
    t_all = time.perf_counter() - t0
    log.info("device relation: %d chunks of %d windows; first chunk "
             "(compile included) %.3fs, other chunks %.3fs; %d chunks over "
             "cand_cap re-run on the host", n_chunks, chunk, t_first or 0.0,
             t_all - (t_first or 0.0), len(fallback_windows))

    if fallback_windows:
        ow = np.concatenate(fallback_windows)
        fb = _xla_rows(store, table, qread[ow], qj[ow], qcode[ow])
        for n in parts:
            parts[n].append(fb[n])

    def cat(name, dtype):
        if not parts[name]:
            return np.zeros(0, dtype)
        return np.concatenate(parts[name]).astype(dtype, copy=False)

    rows = {"r1": cat("r1", np.int32), "j": cat("j", np.int32),
            "r2": cat("r2", np.int32), "orient": cat("orient", np.int8),
            "typ": cat("typ", np.int8), "cont_ok": cat("cont_ok", np.bool_),
            "edge_ok": cat("edge_ok", np.bool_)}
    return _sorted_relation(store, rows, k)
