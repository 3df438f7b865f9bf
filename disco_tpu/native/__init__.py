"""Native (C++) runtime helpers, built on demand with g++ and loaded via
ctypes. Keeps hot or semantics-critical host paths out of Python."""
import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

from ..utils.logging import log

_DIR = pathlib.Path(__file__).resolve().parent
# build outputs live outside the package, under the checkout's ignored
# build/ directory, one subdirectory per (source, compiler, flags) key, so
# a copied tree never loads a library built from other sources or by
# another compiler
BUILD_DIR = _DIR.parent.parent / "build" / "native"
_LOCK = threading.Lock()
_LIB = None


@functools.cache
def _compiler_version() -> str:
    return subprocess.run(["g++", "-dumpfullversion"], check=True,
                          capture_output=True, text=True).stdout.strip()


def _build_key(src: pathlib.Path, cmd) -> str:
    """sha256 over the source, the compiler version and the flags: any
    change of one of them names a new build directory."""
    h = hashlib.sha256(src.read_bytes())
    h.update(_compiler_version().encode())
    h.update(" ".join(cmd).encode())
    return h.hexdigest()[:16]


def _compile(name: str, opt: str = "-O2", extra=()) -> ctypes.CDLL:
    src = _DIR / f"{name}.cpp"
    flags = [opt, "-shared", "-fPIC", "-std=c++17", *extra]
    out_dir = BUILD_DIR / _build_key(src, flags)
    so = out_dir / f"_{name}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        # write through a temp name and rename atomically, so a concurrent
        # process (pytest-xdist workers) never loads a half-written file
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        try:
            subprocess.run(["g++", *flags, "-o", tmp, str(src)], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        log.info("native: built %s", so)
    return ctypes.CDLL(str(so))


def _build_and_load() -> ctypes.CDLL:
    lib = _compile("refsort")
    for name, ktype in (("stdsort_by_key_u64", ctypes.c_uint64),
                        ("stdsort_by_key_i64", ctypes.c_int64),
                        ("stdsort_by_key_i64_desc", ctypes.c_int64)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(ktype), ctypes.POINTER(ctypes.c_int64),
                       ctypes.c_int64]
        fn.restype = None
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _build_and_load()
    return _LIB


def stdsort_permutation(keys, descending: bool = False) -> np.ndarray:
    """Permutation produced by libstdc++ std::sort with a key-only `<`
    comparator — including its exact (unstable) treatment of ties. perm[i] is
    the original index of the element at sorted position i."""
    keys = np.ascontiguousarray(keys)
    n = len(keys)
    out = np.empty(n, np.int64)
    if n == 0:
        return out
    if n <= 16:
        # libstdc++ introsort runs a plain insertion sort on ranges up to
        # _S_threshold=16 — which is STABLE — so the permutation is just a
        # stable argsort; skips the ctypes round-trip on the (overwhelmingly
        # common) small lists
        if descending:
            k2 = keys.astype(np.int64, copy=False)
            return np.lexsort((np.arange(n), -k2))
        return np.argsort(keys, kind="stable")
    lib = _lib()
    if keys.dtype == np.uint64 and not descending:
        fn = lib.stdsort_by_key_u64
        kp = keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    else:
        keys = keys.astype(np.int64, copy=False)
        kp = keys.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        fn = (lib.stdsort_by_key_i64_desc if descending
              else lib.stdsort_by_key_i64)
    fn(kp, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
    return out


# ---------------------------------------------------------------------------
# buildG traversal replay (see replay.cpp header)
# ---------------------------------------------------------------------------
_REPLAY = None


def _replay_lib():
    global _REPLAY
    with _LOCK:
        if _REPLAY is None:
            lib = _compile("replay", opt="-O2", extra=("-fopenmp",))
            p64 = ctypes.POINTER(ctypes.c_int64)
            p32 = ctypes.POINTER(ctypes.c_int32)
            pi8 = ctypes.POINTER(ctypes.c_int8)
            pu8 = ctypes.POINTER(ctypes.c_uint8)
            p16 = ctypes.POINTER(ctypes.c_int16)
            lib.graph_replay.argtypes = [
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, p64,
                p16, p32, pi8, p32, p64, pu8, ctypes.c_int64, p64,
                ctypes.POINTER(ctypes.c_void_p), p64,
                ctypes.POINTER(ctypes.c_void_p), p64]
            lib.graph_replay.restype = ctypes.c_void_p
            lib.replay_free.argtypes = [ctypes.c_void_p]
            lib.replay_free.restype = None
            lib.edge_group_count.argtypes = [p32, p32, pu8, pu8,
                                             ctypes.c_int64]
            lib.edge_group_count.restype = ctypes.c_int64
            lib.edge_group_fill.argtypes = [p32, p32, p32, pi8, pu8, pu8,
                                            ctypes.c_int64, ctypes.c_int64,
                                            p16, p32, pi8, p64]
            lib.edge_group_fill.restype = None
            _REPLAY = lib
    return _REPLAY


def graph_replay(n: int, k: int, wpgs: int, starts, ej, er2, eo, lens, fidx,
                 all_marked, start_read: int = 1):
    """Run the sequential buildG traversal replay from `start_read`.
    Returns (par_blob, start_blob, chunk_ends): the _parGraph.txt content,
    the _startRead.txt content (one line per chunk), and the parGraph byte
    offset after each chunk flush (the valid kill/restart points)."""
    lib = _replay_lib()
    starts = np.ascontiguousarray(starts, np.int64)
    ej = np.ascontiguousarray(ej, np.int16)
    er2 = np.ascontiguousarray(er2, np.int32)
    eo = np.ascontiguousarray(eo, np.int8)
    lens = np.ascontiguousarray(lens, np.int32)
    fidx = np.ascontiguousarray(fidx, np.int64)
    all_marked = np.ascontiguousarray(all_marked, np.uint8)
    size = ctypes.c_int64(0)
    sptr = ctypes.c_void_p()
    ssize = ctypes.c_int64(0)
    cptr = ctypes.c_void_p()
    nch = ctypes.c_int64(0)
    ptr = lib.graph_replay(
        n, k, wpgs, starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ej.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        er2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        eo.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        all_marked.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        start_read, ctypes.byref(size), ctypes.byref(sptr),
        ctypes.byref(ssize), ctypes.byref(cptr), ctypes.byref(nch))
    try:
        par = ctypes.string_at(ptr, size.value)
        start_blob = ctypes.string_at(sptr, ssize.value)
        chunk_ends = np.ctypeslib.as_array(
            ctypes.cast(cptr, ctypes.POINTER(ctypes.c_int64)),
            shape=(nch.value,)).copy()
        return par, start_blob, chunk_ends
    finally:
        lib.replay_free(ptr)
        lib.replay_free(sptr)
        lib.replay_free(cptr)


def edge_hit_groups(r1, j, r2, orient, edge_ok, contained, n: int):
    """Filter the relation to edge rows with both endpoints uncontained and
    compact (j, r2+1, orient) preserving order, plus per-read group bounds
    `starts` (group of 1-based read r = [starts[r-1], starts[r]))."""
    lib = _replay_lib()
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    r1 = np.ascontiguousarray(r1, np.int32)
    j = np.ascontiguousarray(j, np.int32)
    r2 = np.ascontiguousarray(r2, np.int32)
    orient = np.ascontiguousarray(orient, np.int8)
    edge_ok = np.ascontiguousarray(edge_ok, np.uint8)
    contained = np.ascontiguousarray(contained, np.uint8)
    nrows = len(r1)
    total = lib.edge_group_count(
        r1.ctypes.data_as(p32), r2.ctypes.data_as(p32),
        edge_ok.ctypes.data_as(pu8), contained.ctypes.data_as(pu8), nrows)
    out_j = np.empty(total, np.int16)
    out_r2 = np.empty(total, np.int32)
    out_eo = np.empty(total, np.int8)
    starts = np.empty(n + 1, np.int64)
    lib.edge_group_fill(
        r1.ctypes.data_as(p32), j.ctypes.data_as(p32),
        r2.ctypes.data_as(p32), orient.ctypes.data_as(pi8),
        edge_ok.ctypes.data_as(pu8), contained.ctypes.data_as(pu8),
        nrows, n, out_j.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        out_r2.ctypes.data_as(p32),
        out_eo.ctypes.data_as(pi8), starts.ctypes.data_as(p64))
    return starts, out_j, out_r2, out_eo


# ---------------------------------------------------------------------------
# parsimplify phase (see parsimplify.cpp header)
# ---------------------------------------------------------------------------
_PARSIMPLIFY = None


def _parsimplify_lib():
    global _PARSIMPLIFY
    with _LOCK:
        if _PARSIMPLIFY is None:
            lib = _compile("parsimplify", opt="-O2")
            lib.parsimplify_run.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                            ctypes.c_int64]
            lib.parsimplify_run.restype = ctypes.c_int64
            _PARSIMPLIFY = lib
    return _PARSIMPLIFY


def parsimplify_run(edge_file: str, out_file: str, min_ovl: int) -> None:
    """Native parsimplify: edge_file -> out_file (bit-identical to the
    Python oracle disco_tpu.simplify.pargraph.parsimplify)."""
    rc = _parsimplify_lib().parsimplify_run(
        edge_file.encode(), out_file.encode(), min_ovl)
    if rc != 0:
        raise OSError(f"parsimplify_run failed on {edge_file}")


# ---------------------------------------------------------------------------
# Min-cost flow (CS2 replacement; see mcmf.cpp header)
# ---------------------------------------------------------------------------
_MCMF = None


def _mcmf_lib():
    global _MCMF
    with _LOCK:
        if _MCMF is None:
            lib = _compile("mcmf", opt="-O3")
            p64 = ctypes.POINTER(ctypes.c_int64)
            lib.mcmf_solve.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                       p64, p64, p64, p64, p64, p64]
            lib.mcmf_solve.restype = ctypes.c_int64
            _MCMF = lib
    return _MCMF


# ---------------------------------------------------------------------------
# Read QC + 2-bit packing (hot host ingest path; see readqc.cpp header)
# ---------------------------------------------------------------------------
_READQC = None


def _readqc_lib():
    global _READQC
    with _LOCK:
        if _READQC is None:
            lib = _compile("readqc", opt="-O3", extra=("-fopenmp",))
            p64 = ctypes.POINTER(ctypes.c_int64)
            pu32 = ctypes.POINTER(ctypes.c_uint32)
            lib.qc_test_reads.argtypes = [
                ctypes.c_char_p, p64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8)]
            lib.qc_test_reads.restype = None
            lib.pack_reads.argtypes = [
                ctypes.c_char_p, p64, ctypes.c_int64, ctypes.c_int64,
                pu32, pu32]
            lib.pack_reads.restype = ctypes.c_int64
            lib.pack_reads_ordered.argtypes = [
                ctypes.c_char_p, p64, p64, ctypes.c_int64, ctypes.c_int64,
                pu32, pu32]
            lib.pack_reads_ordered.restype = ctypes.c_int64
            lib.seq_scan_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.seq_scan_count.restype = ctypes.c_int64
            lib.seq_scan_open.argtypes = [ctypes.c_char_p, p64, p64]
            lib.seq_scan_open.restype = ctypes.c_void_p
            lib.seq_scan_extract.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_int64,
                                             p64, ctypes.c_int64]
            lib.seq_scan_extract.restype = ctypes.c_int64
            lib.seq_scan_offsets_close.argtypes = [ctypes.c_void_p, p64]
            lib.seq_scan_offsets_close.restype = None
            lib.seq_scan_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                          ctypes.c_char_p, ctypes.c_int64,
                                          p64, ctypes.c_int64]
            lib.seq_scan_fill.restype = ctypes.c_int64
            _READQC = lib
    return _READQC


def qc_test_reads(blob: bytes, offsets: np.ndarray,
                  min_overlap: int) -> np.ndarray:
    """Vectorized Dataset::testRead over reads concatenated in `blob` with
    n+1 boundary `offsets`. Returns a (n,) bool keep-mask."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    n = len(offsets) - 1
    out = np.empty(n, np.uint8)
    lib = _readqc_lib()
    lib.qc_test_reads(_as_char_p(blob), offsets.ctypes.data_as(
        ctypes.POINTER(ctypes.c_int64)), n, min_overlap,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def pack_reads(blob: bytes, offsets: np.ndarray, n_words: int,
               order: "np.ndarray | None" = None):
    """2-bit pack reads (forward + reverse complement) into
    (n, n_words+1) uint32 rows with one zero pad word each; row i packs
    record order[i] (identity when order is None).
    Raises ValueError on a non-ACGT base."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    lib = _readqc_lib()
    p64 = ctypes.POINTER(ctypes.c_int64)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    if order is None:
        n = len(offsets) - 1
        order_p = ctypes.cast(None, p64)
    else:
        order = np.ascontiguousarray(order, np.int64)
        n = len(order)
        order_p = order.ctypes.data_as(p64)
    packed = np.empty((n, n_words + 1), np.uint32)
    packed_rc = np.empty((n, n_words + 1), np.uint32)
    bad = lib.pack_reads_ordered(
        _as_char_p(blob), offsets.ctypes.data_as(p64), order_p, n, n_words,
        packed.ctypes.data_as(pu32), packed_rc.ctypes.data_as(pu32))
    if bad >= 0:
        raise ValueError(f"non-ACGT base in read {bad + 1}")
    return packed, packed_rc


def _as_char_p(x):
    if isinstance(x, bytes):
        return x
    return x.ctypes.data_as(ctypes.c_char_p)


def seq_scan_path(path: str):
    """Streaming scan of an UNCOMPRESSED FASTA/FASTQ file: the raw bytes
    stay a file-backed mapping (released between the counting and fill
    passes) and the sequence blob is allocated at its exact size — the
    in-memory raw buffer + worst-case output buffer of `seq_scan` was the
    largest ingest transient at metagenome scale.  Returns
    (seq_blob uint8, (n+1,) offsets) exactly like seq_scan; returns None
    if the file cannot be scanned this way (caller falls back)."""
    lib = _readqc_lib()
    n = ctypes.c_int64(0)
    tot = ctypes.c_int64(0)
    h = lib.seq_scan_open(os.fsencode(path), ctypes.byref(n),
                          ctypes.byref(tot))
    if not h:
        return None
    offsets = np.zeros(n.value + 1, np.int64)
    buf = np.empty(max(tot.value, 1), np.uint8)
    w = lib.seq_scan_extract(
        h, _as_char_p(buf), tot.value,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n.value)
    if w != tot.value:  # -1 = capacity guard tripped in C++ (file changed)
        raise RuntimeError(
            f"{path}: file changed between scan passes ({w} != {tot.value})")
    return buf, offsets


def seq_scan_lengths(path: str):
    """Lengths-only streaming scan: returns the (n+1,) sequence-length
    boundary offsets without materializing any sequence bytes (the
    simplify DataSet loads read lengths only, reference:
    src/SimplifyGraph/src/DataSet.cpp).  None if not scannable."""
    lib = _readqc_lib()
    n = ctypes.c_int64(0)
    tot = ctypes.c_int64(0)
    h = lib.seq_scan_open(os.fsencode(path), ctypes.byref(n),
                          ctypes.byref(tot))
    if not h:
        return None
    offsets = np.zeros(n.value + 1, np.int64)
    lib.seq_scan_offsets_close(
        h, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return offsets


def seq_scan(raw):
    """Parse a FASTA/FASTQ byte buffer (bytes or uint8 ndarray) into
    (seq_blob, offsets): upper-cased concatenated record sequences
    (uint8 array) + (n+1,) boundaries.
    Raises ValueError on an unknown leading byte."""
    lib = _readqc_lib()
    size = len(raw)
    n = lib.seq_scan_count(_as_char_p(raw), size)
    if n < 0:
        raise ValueError("Unknown input file format")
    offsets = np.zeros(n + 1, np.int64)
    buf = np.empty(max(size, 1), np.uint8)
    total = lib.seq_scan_fill(_as_char_p(raw), size, _as_char_p(buf),
                              len(buf),
                              offsets.ctypes.data_as(
                                  ctypes.POINTER(ctypes.c_int64)), n)
    if total < 0:
        raise RuntimeError("seq_scan: fill pass exceeded counted capacity")
    return buf[:total], offsets


# ---------------------------------------------------------------------------
# Overlap relation (hot host compute path; see overlap.cpp header)
# ---------------------------------------------------------------------------
_OVERLAP = None


def _overlap_lib():
    global _OVERLAP
    with _LOCK:
        if _OVERLAP is None:
            lib = _compile("overlap", opt="-O3", extra=("-fopenmp",))
            p64 = ctypes.POINTER(ctypes.c_int64)
            p32 = ctypes.POINTER(ctypes.c_int32)
            pu32 = ctypes.POINTER(ctypes.c_uint32)
            pu64 = ctypes.POINTER(ctypes.c_uint64)
            pi8 = ctypes.POINTER(ctypes.c_int8)
            pu8 = ctypes.POINTER(ctypes.c_uint8)
            lib.overlap_relation_collect.argtypes = [
                pu32, pu32, p32, ctypes.c_int64, ctypes.c_int64,
                pu64, p32, pi8, pi8, ctypes.c_int64, ctypes.c_int64, p64]
            lib.overlap_relation_collect.restype = ctypes.c_void_p
            lib.overlap_relation_collect_mode.argtypes = [
                pu32, pu32, p32, ctypes.c_int64, ctypes.c_int64,
                pu64, p32, pi8, pi8, ctypes.c_int64, ctypes.c_int64, p64,
                ctypes.c_int64, pu8]
            lib.overlap_relation_collect_mode.restype = ctypes.c_void_p
            lib.overlap_relation_export.argtypes = [
                ctypes.c_void_p, p32, p32, p32, pi8, pi8, pu8, pu8]
            lib.overlap_relation_export.restype = None
            p16 = ctypes.POINTER(ctypes.c_int16)
            lib.overlap_relation_export_grouped.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, p64, p16, p32, pi8]
            lib.overlap_relation_export_grouped.restype = None
            _OVERLAP = lib
    return _OVERLAP


def overlap_relation(packed: np.ndarray, packed_rc: np.ndarray,
                     lengths: np.ndarray, keys: np.ndarray,
                     tread: np.ndarray, torient: np.ndarray,
                     ttyp: np.ndarray, k: int):
    """Full verified overlap/containment relation over all (read, window)
    queries against the sorted fingerprint table, emitted in
    (r1, j, bucket-scan) order. Returns dict of column arrays (see
    overlap.cpp for semantics)."""
    lib = _overlap_lib()
    n, row_words = packed.shape
    m = len(keys)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    packed = np.ascontiguousarray(packed, np.uint32)
    packed_rc = np.ascontiguousarray(packed_rc, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    keys = np.ascontiguousarray(keys, np.uint64)
    tread = np.ascontiguousarray(tread, np.int32)
    torient = np.ascontiguousarray(torient, np.int8)
    ttyp = np.ascontiguousarray(ttyp, np.int8)
    total_c = ctypes.c_int64(0)
    handle = lib.overlap_relation_collect(
        packed.ctypes.data_as(pu32), packed_rc.ctypes.data_as(pu32),
        lengths.ctypes.data_as(p32), n, row_words,
        keys.ctypes.data_as(pu64), tread.ctypes.data_as(p32),
        torient.ctypes.data_as(pi8), ttyp.ctypes.data_as(pi8), m, k,
        ctypes.byref(total_c))
    total = total_c.value
    out = {
        "r1": np.empty(total, np.int32), "j": np.empty(total, np.int32),
        "r2": np.empty(total, np.int32), "orient": np.empty(total, np.int8),
        "typ": np.empty(total, np.int8), "cont_ok": np.empty(total, np.uint8),
        "edge_ok": np.empty(total, np.uint8)}
    lib.overlap_relation_export(handle,
                                out["r1"].ctypes.data_as(p32),
                                out["j"].ctypes.data_as(p32),
                                out["r2"].ctypes.data_as(p32),
                                out["orient"].ctypes.data_as(pi8),
                                out["typ"].ctypes.data_as(pi8),
                                out["cont_ok"].ctypes.data_as(pu8),
                                out["edge_ok"].ctypes.data_as(pu8))
    out["cont_ok"] = out["cont_ok"].astype(bool)
    out["edge_ok"] = out["edge_ok"].astype(bool)
    return out


def overlap_relation_mode(packed: np.ndarray, packed_rc: np.ndarray,
                          lengths: np.ndarray, keys: np.ndarray,
                          tread: np.ndarray, torient: np.ndarray,
                          ttyp: np.ndarray, k: int, mode: int,
                          contained: "np.ndarray | None" = None):
    """Streaming-mode relation passes (see overlap.cpp::collect_impl):
    mode=1 containment-only; mode=2 edge-only over uncontained reads
    (`contained` = (n,) 0-based byte mask).  Returns the same column dict
    as overlap_relation (cont_ok/edge_ok reflect the mode)."""
    lib = _overlap_lib()
    n, row_words = packed.shape
    m = len(keys)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    packed = np.ascontiguousarray(packed, np.uint32)
    packed_rc = np.ascontiguousarray(packed_rc, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    keys = np.ascontiguousarray(keys, np.uint64)
    tread = np.ascontiguousarray(tread, np.int32)
    torient = np.ascontiguousarray(torient, np.int8)
    ttyp = np.ascontiguousarray(ttyp, np.int8)
    if mode == 2:
        contained = np.ascontiguousarray(contained, np.uint8)
        cptr = contained.ctypes.data_as(pu8)
    else:
        cptr = ctypes.cast(None, pu8)
    total_c = ctypes.c_int64(0)
    handle = lib.overlap_relation_collect_mode(
        packed.ctypes.data_as(pu32), packed_rc.ctypes.data_as(pu32),
        lengths.ctypes.data_as(p32), n, row_words,
        keys.ctypes.data_as(pu64), tread.ctypes.data_as(p32),
        torient.ctypes.data_as(pi8), ttyp.ctypes.data_as(pi8), m, k,
        ctypes.byref(total_c), mode, cptr)
    total = total_c.value
    out = {
        "r1": np.empty(total, np.int32), "j": np.empty(total, np.int32),
        "r2": np.empty(total, np.int32), "orient": np.empty(total, np.int8),
        "typ": np.empty(total, np.int8), "cont_ok": np.empty(total, np.uint8),
        "edge_ok": np.empty(total, np.uint8)}
    lib.overlap_relation_export(handle,
                                out["r1"].ctypes.data_as(p32),
                                out["j"].ctypes.data_as(p32),
                                out["r2"].ctypes.data_as(p32),
                                out["orient"].ctypes.data_as(pi8),
                                out["typ"].ctypes.data_as(pi8),
                                out["cont_ok"].ctypes.data_as(pu8),
                                out["edge_ok"].ctypes.data_as(pu8))
    out["cont_ok"] = out["cont_ok"].astype(bool)
    out["edge_ok"] = out["edge_ok"].astype(bool)
    return out


def overlap_relation_mode2_grouped(packed: np.ndarray,
                                   packed_rc: np.ndarray,
                                   lengths: np.ndarray, keys: np.ndarray,
                                   tread: np.ndarray, torient: np.ndarray,
                                   ttyp: np.ndarray, k: int,
                                   contained: np.ndarray):
    """Edge-only (mode=2) relation pass with the slim grouped export:
    returns (starts int64 (n+1), j int16, r2 int32 1-based, orient int8) —
    exactly the traversal replay's inputs, ~7 B/row instead of the 16 B/row
    generic column set, with the native hit blocks freed during export."""
    lib = _overlap_lib()
    n, row_words = packed.shape
    m = len(keys)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    pi8 = ctypes.POINTER(ctypes.c_int8)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    p16 = ctypes.POINTER(ctypes.c_int16)
    packed = np.ascontiguousarray(packed, np.uint32)
    packed_rc = np.ascontiguousarray(packed_rc, np.uint32)
    lengths = np.ascontiguousarray(lengths, np.int32)
    keys = np.ascontiguousarray(keys, np.uint64)
    tread = np.ascontiguousarray(tread, np.int32)
    torient = np.ascontiguousarray(torient, np.int8)
    ttyp = np.ascontiguousarray(ttyp, np.int8)
    contained = np.ascontiguousarray(contained, np.uint8)
    total_c = ctypes.c_int64(0)
    handle = lib.overlap_relation_collect_mode(
        packed.ctypes.data_as(pu32), packed_rc.ctypes.data_as(pu32),
        lengths.ctypes.data_as(p32), n, row_words,
        keys.ctypes.data_as(pu64), tread.ctypes.data_as(p32),
        torient.ctypes.data_as(pi8), ttyp.ctypes.data_as(pi8), m, k,
        ctypes.byref(total_c), 2, contained.ctypes.data_as(pu8))
    total = total_c.value
    starts = np.empty(n + 1, np.int64)
    out_j = np.empty(total, np.int16)
    out_r2 = np.empty(total, np.int32)
    out_eo = np.empty(total, np.int8)
    lib.overlap_relation_export_grouped(
        handle, n, starts.ctypes.data_as(p64),
        out_j.ctypes.data_as(p16), out_r2.ctypes.data_as(p32),
        out_eo.ctypes.data_as(pi8))
    return starts, out_j, out_r2, out_eo


def mcmf_solve(v_nodes: int, tail, head, lb, ub, cost) -> np.ndarray:
    """Solve min-cost flow with per-arc lower bounds (ub<0 = infinite).
    Returns the per-arc flow vector; raises on infeasibility."""
    p64 = ctypes.POINTER(ctypes.c_int64)
    arrs = [np.ascontiguousarray(a, np.int64)
            for a in (tail, head, lb, ub, cost)]
    n_arcs = len(arrs[0])
    out = np.empty(n_arcs, np.int64)
    lib = _mcmf_lib()
    rc = lib.mcmf_solve(v_nodes, n_arcs,
                        *(a.ctypes.data_as(p64) for a in arrs),
                        out.ctypes.data_as(p64))
    if rc != 0:
        raise RuntimeError("infeasible flow problem")
    return out


# ---------------------------------------------------------------------------
# Read -> edge back-index arena (backindex.cpp)
# ---------------------------------------------------------------------------
_BACKINDEX = None


def _backindex_lib():
    global _BACKINDEX
    if _BACKINDEX is None:
        with _LOCK:
            if _BACKINDEX is None:
                lib = _compile("backindex", opt="-O2")
                p32 = ctypes.POINTER(ctypes.c_int32)
                pi8 = ctypes.POINTER(ctypes.c_int8)
                p64 = ctypes.POINTER(ctypes.c_int64)
                lib.backindex_new.argtypes = [ctypes.c_int64]
                lib.backindex_new.restype = ctypes.c_void_p
                lib.backindex_free.argtypes = [ctypes.c_void_p]
                lib.backindex_free.restype = None
                lib.backindex_add_bulk.argtypes = [
                    ctypes.c_void_p, p32, pi8, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64]
                lib.backindex_add_bulk.restype = None
                lib.backindex_remove_bulk.argtypes = [
                    ctypes.c_void_p, p32, pi8, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int64]
                lib.backindex_remove_bulk.restype = None
                lib.backindex_query.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                    p64, p64]
                lib.backindex_query.restype = ctypes.c_int64
                lib.backindex_count.argtypes = [ctypes.c_void_p,
                                                ctypes.c_int64]
                lib.backindex_count.restype = ctypes.c_int64
                lib.backindex_has.argtypes = [ctypes.c_void_p,
                                              ctypes.c_int64]
                lib.backindex_has.restype = ctypes.c_int32
                lib.backindex_head_ptr.argtypes = [ctypes.c_void_p]
                lib.backindex_head_ptr.restype = p32
                lib.backindex_query_cap.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                    p64, p64, ctypes.c_int64]
                lib.backindex_query_cap.restype = ctypes.c_int64
                _BACKINDEX = lib
    return _BACKINDEX


class NativeBackIndex:
    """ctypes wrapper over the backindex.cpp arena; see EdgeLocArena in
    simplify/dataset.py for the public semantics."""
    __slots__ = ("lib", "h", "_p32", "_pi8", "_p64", "head",
                 "_qa", "_qi", "_qa_p", "_qi_p", "_query")

    def __init__(self, n_reads: int):
        self.lib = _backindex_lib()
        self.h = self.lib.backindex_new(n_reads)
        self._p32 = ctypes.POINTER(ctypes.c_int32)
        self._pi8 = ctypes.POINTER(ctypes.c_int8)
        self._p64 = ctypes.POINTER(ctypes.c_int64)
        # zero-copy has-entries view (the C head vector is fixed-size)
        self.head = np.ctypeslib.as_array(
            self.lib.backindex_head_ptr(self.h), shape=(n_reads + 1,))
        # reused query buffers (grown on demand) with their ctypes
        # pointers precomputed — data_as per call dominated the
        # per-read query cost at metagenome scale
        self._qa = np.empty(64, np.int64)
        self._qi = np.empty(64, np.int64)
        self._qa_p = self._qa.ctypes.data_as(self._p64)
        self._qi_p = self._qi.ctypes.data_as(self._p64)
        self._query = self.lib.backindex_query_cap

    def __del__(self):
        if getattr(self, "h", None):
            self.lib.backindex_free(self.h)
            self.h = None

    def add_bulk(self, rids: np.ndarray, ori_bits: np.ndarray, addr: int,
                 idx0: int = 0):
        rids = np.ascontiguousarray(rids, np.int32)
        ori_bits = np.ascontiguousarray(ori_bits, np.int8)
        self.lib.backindex_add_bulk(
            self.h, rids.ctypes.data_as(self._p32),
            ori_bits.ctypes.data_as(self._pi8), len(rids), addr, idx0)

    def remove_bulk(self, rids: np.ndarray, ori_bits: np.ndarray, addr: int,
                    idx0: int = 0):
        rids = np.ascontiguousarray(rids, np.int32)
        ori_bits = np.ascontiguousarray(ori_bits, np.int8)
        self.lib.backindex_remove_bulk(
            self.h, rids.ctypes.data_as(self._p32),
            ori_bits.ctypes.data_as(self._pi8), len(rids), addr, idx0)

    def query(self, rid: int, orient_bit: int):
        """Single-call query into reused buffers; returns (addr_list,
        idx_list) as Python lists (valid until the next query)."""
        w = self._query(self.h, rid, orient_bit, self._qa_p, self._qi_p,
                        len(self._qa))
        if w < 0:
            n = -w
            self._qa = np.empty(2 * n, np.int64)
            self._qi = np.empty(2 * n, np.int64)
            self._qa_p = self._qa.ctypes.data_as(self._p64)
            self._qi_p = self._qi.ctypes.data_as(self._p64)
            w = self._query(self.h, rid, orient_bit, self._qa_p,
                            self._qi_p, len(self._qa))
        if w == 0:
            return None, None
        return self._qa[:w].tolist(), self._qi[:w].tolist()

    def has(self, rid: int) -> bool:
        return bool(self.lib.backindex_has(self.h, rid))


def _seq_scan_window_bind(lib):
    p64 = ctypes.POINTER(ctypes.c_int64)
    if not hasattr(lib.seq_scan_record_pos, "_bound"):
        lib.seq_scan_record_pos.argtypes = [ctypes.c_void_p, p64]
        lib.seq_scan_record_pos.restype = None
        lib.seq_scan_extract_window.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64, p64, ctypes.c_int64]
        lib.seq_scan_extract_window.restype = ctypes.c_int64
        lib.seq_scan_close.argtypes = [ctypes.c_void_p]
        lib.seq_scan_close.restype = None
        lib.seq_scan_record_pos._bound = True


def iter_record_windows(path: str, window_bytes: int = 64 << 20):
    """Yield (seq_blob uint8, (m+1,) offsets, rec_lo) windows of ~
    window_bytes of sequence each, covering all records of an
    uncompressed FASTA/FASTQ file without ever holding the whole blob
    (the reference's contig streamer reads record by record,
    OverlapGraph.cpp:2148-2243).  Yields nothing (falls back) for files
    the streaming scanner cannot handle; caller must check via the
    returned handle sentinel: returns None if unsupported."""
    lib = _readqc_lib()
    _seq_scan_window_bind(lib)
    n = ctypes.c_int64(0)
    tot = ctypes.c_int64(0)
    h = lib.seq_scan_open(os.fsencode(path), ctypes.byref(n),
                          ctypes.byref(tot))
    if not h:
        return None
    n = n.value
    p64 = ctypes.POINTER(ctypes.c_int64)
    # per-record sequence-length boundaries + file positions
    seq_off = np.zeros(n + 1, np.int64)
    lib.seq_scan_offsets_fill = getattr(lib, "seq_scan_offsets_fill", None)
    rec_pos = np.empty(max(n, 1), np.int64)
    lib.seq_scan_record_pos(h, rec_pos.ctypes.data_as(p64))
    # lengths boundaries come from another count walk; reuse rec-length
    # info lazily per window instead (the fill pass recomputes offsets)
    import os as _os
    fsize = _os.path.getsize(path)

    def gen():
        try:
            lo = 0
            while lo < n:
                hi = lo
                start = rec_pos[lo]
                # grow the window by file bytes (sequence <= file bytes)
                while hi < n and (rec_pos[hi] - start) < window_bytes:
                    hi += 1
                file_hi = fsize if hi >= n else int(rec_pos[hi])
                file_lo = int(rec_pos[lo])
                cap = file_hi - file_lo
                buf = np.empty(max(cap, 1), np.uint8)
                offs = np.zeros(hi - lo + 1, np.int64)
                w = lib.seq_scan_extract_window(
                    h, file_lo, file_hi, _as_char_p(buf), cap,
                    offs.ctypes.data_as(p64), hi - lo)
                if w < 0:
                    raise RuntimeError(
                        f"{path}: window extract overflow at records "
                        f"[{lo},{hi})")
                yield buf[:w], offs, lo
                lo = hi
        finally:
            lib.seq_scan_close(h)
    return gen()
