"""Sorted canonical fingerprint table over read end-(L-1)-mers.

Device-friendly replacement for the reference's chained prefix/suffix hash table
(reference: src/BuildGraph/src/HashTable.cpp:341-571). Design differences:

- The reference buckets records by a canonical hash min(h(s), h(rc(s))) and
  re-verifies string equality during the bucket scan; bucket iteration order
  is read-file order. We instead store, per read end, entries under BOTH the
  k-mer code and its reverse-complement code, in one array SORTED by
  (key, read, end-type). A query is then a pure `searchsorted` — vectorizable
  on device — and the hits for a key, ordered by (read, type), reproduce the
  reference's bucket scan order exactly (file order == read-ID order; a
  read's prefix record precedes its suffix record,
  reference: src/BuildGraph/src/HashTable.cpp:450-512).
- Keys are the first min(k, 32) bases packed 2-bit into a uint64. For
  k > 32 the key is a truncation; downstream verification always compares
  the full overlap window including the k-mer, so results stay exact.
- The reference's if/else in the bucket scan emits a single orientation per
  record (reference: src/BuildGraph/src/HashTable.cpp:535-566); for
  palindromic end-mers (kmer == its own rc) we therefore drop the rc-keyed
  entry so only the forward orientation is reported.

Hit orientation encoding (identical to the reference's):
  0 = query == prefix of read2 (forward)
  1 = query == suffix of read2 (forward)
  2 = query == prefix of rc(read2)   [rc of read2's suffix]
  3 = query == suffix of rc(read2)   [rc of read2's prefix]
"""
from dataclasses import dataclass

import numpy as np

from ..io.readstore import ReadStore


def _pack_key(codes: np.ndarray) -> np.ndarray:
    """(N, k) uint8 codes -> uint64 keys over the first min(k,32) bases."""
    k = min(codes.shape[1], 32)
    key = np.zeros(codes.shape[0], np.uint64)
    for t in range(k):
        key = (key << np.uint64(2)) | codes[:, t].astype(np.uint64)
    return key


def end_kmer_codes(store: ReadStore, k: int):
    """Return (prefix_codes, suffix_codes, prefix_rc_codes, suffix_rc_codes)
    as (N, k) uint8 matrices of base codes."""
    n = store.n_reads
    pref = np.zeros((n, k), np.uint8)
    suf = np.zeros((n, k), np.uint8)
    # unpack from packed words (vectorized)
    words = store.packed  # (N, W+1) uint32
    positions = np.arange(k)
    for t in positions:
        w = words[:, t // 16]
        pref[:, t] = (w >> np.uint32(30 - 2 * (t % 16))) & np.uint32(3)
    lens = store.lengths.astype(np.int64)
    for t in positions:
        pos = lens - k + t
        w = words[np.arange(n), pos // 16]
        sh = (30 - 2 * (pos % 16)).astype(np.uint32)
        suf[:, t] = (w >> sh) & np.uint32(3)
    pref_rc = (3 - pref)[:, ::-1]
    suf_rc = (3 - suf)[:, ::-1]
    return pref, suf, pref_rc, suf_rc


@dataclass
class FingerprintTable:
    k: int
    keys: np.ndarray     # (M,) uint64, sorted
    read: np.ndarray     # (M,) int32, 0-based read index
    orient: np.ndarray   # (M,) int8 hit orientation 0..3
    typ: np.ndarray      # (M,) int8, 0=prefix record, 1=suffix record

    @classmethod
    def build(cls, store: ReadStore, k: int) -> "FingerprintTable":
        if k > store.lengths.min():
            raise ValueError("k longer than shortest read")
        pref, suf, pref_rc, suf_rc = end_kmer_codes(store, k)
        n = store.n_reads
        rid = np.arange(n, dtype=np.int32)

        key_p, key_s = _pack_key(pref), _pack_key(suf)
        key_pr, key_sr = _pack_key(pref_rc), _pack_key(suf_rc)
        # palindrome dedup on the FULL kmer (not the truncated key)
        pal_p = (pref == pref_rc).all(axis=1)
        pal_s = (suf == suf_rc).all(axis=1)

        keys = [key_p, key_s, key_pr[~pal_p], key_sr[~pal_s]]
        reads = [rid, rid, rid[~pal_p], rid[~pal_s]]
        orients = [np.full(n, 0, np.int8), np.full(n, 1, np.int8),
                   np.full((~pal_p).sum(), 3, np.int8),
                   np.full((~pal_s).sum(), 2, np.int8)]
        typs = [np.zeros(n, np.int8), np.ones(n, np.int8),
                np.zeros((~pal_p).sum(), np.int8),
                np.ones((~pal_s).sum(), np.int8)]

        keys = np.concatenate(keys)
        reads = np.concatenate(reads)
        orients = np.concatenate(orients)
        typs = np.concatenate(typs)

        # Within a key, hits must come back in the reference's hash-bucket
        # scan order = hash-data insertion order = FILE order (the reference
        # re-reads the files in file order to fill the table,
        # reference: src/BuildGraph/src/HashTable.cpp:97-114), with a read's
        # prefix record before its suffix record. File order is file_index
        # order, which differs from read-ID order when the parser's task
        # permutation applies (see ReadStore.from_files).
        fidx_of = store.file_index
        order = np.lexsort((typs, fidx_of[reads], keys))
        return cls(k=k, keys=keys[order], read=reads[order],
                   orient=orients[order], typ=typs[order])

    def lookup_ranges(self, query_keys: np.ndarray):
        lo = np.searchsorted(self.keys, query_keys, side="left")
        hi = np.searchsorted(self.keys, query_keys, side="right")
        return lo, hi
