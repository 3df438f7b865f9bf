"""Verify-step benchmark: the overlap phase's candidate check on the GPU.

The workload is the overlap phase's inner loop — the reference's hot path
(byte-wise substring compares inside hash-bucket probes,
reference: src/BuildGraph/src/OverlapGraph.cpp:401-478,638-674) — as one
device batch: for every candidate (read1 window j, read2, orientation) of a
contiguous slice of the E. coli-shaped candidate stream, check the edge and
the containment window over 2-bit packed words.

Before timing, the production step (`overlap.device.candidate_checks`) is
checked for EXACT equality against two independent references on the same
pairs: the per-element-gather formulation (`verify.verify_windows_gather`)
on the device, and a base-by-base numpy compare on the host.  The step is
integer-only (u32 shifts, XOR, masks; no float product), so there is no
tolerance.

Usage: python bench.py [--reads FASTA] [--pairs N]
Without --reads it generates the 4.6 Mb / 30x / 2x250 bp isolate from seed
11.  Prints the card's name and power limit, then ONE JSON line.  Exits
non-zero, printing no result, when JAX finds no GPU or a check fails.
"""
import argparse
import functools
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

MIN_OVERLAP = 30
ECOLI = ["--genome-len", "4600000", "--coverage", "30", "--read-len", "250",
         "--insert", "500", "--seed", "11"]


def make_dataset(path: str) -> None:
    subprocess.run(
        [sys.executable, str(ROOT / "tools" / "make_testdata.py"), path,
         *ECOLI], check=True, stdout=subprocess.DEVNULL)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def candidate_batch(store, table, n_pairs: int):
    """The first `n_pairs` candidate pairs of the windows of a contiguous
    read range from the middle of the store, expanded on the host exactly
    like the overlap phase's bucket scan, with the geometry of both checks
    (reference: OverlapGraph.cpp:517-595) computed in numpy."""
    from types import SimpleNamespace

    from disco_tpu.overlap import relation as R

    k = table.k
    n_reads = 4096
    while True:
        r0 = max(store.n_reads // 2 - n_reads // 2, 0)
        r1 = min(r0 + n_reads, store.n_reads)
        sub = SimpleNamespace(packed=store.packed[r0:r1],
                              lengths=store.lengths[r0:r1], n_reads=r1 - r0)
        qread, qj, qcode = R.window_codes(sub, k)
        lo, hi = table.lookup_ranges(qcode)
        counts = (hi - lo).astype(np.int64)
        if counts.sum() >= n_pairs or r1 - r0 == store.n_reads:
            break
        n_reads *= 2
    qread = qread + r0
    total = min(int(counts.sum()), n_pairs)
    pair_q = np.repeat(np.arange(len(qread), dtype=np.int64), counts)[:total]
    cum = np.concatenate([[0], np.cumsum(counts)])[:-1]
    tpos = lo[pair_q] + np.arange(total, dtype=np.int64) - cum[pair_q]

    r1 = qread[pair_q].astype(np.int32)
    j = qj[pair_q].astype(np.int32)
    r2 = table.read[tpos].astype(np.int32)
    orient = table.orient[tpos].astype(np.int32)
    len1 = store.lengths[r1].astype(np.int32)
    len2 = store.lengths[r2].astype(np.int32)
    suffix = R._IS_SUFFIX_CASE[orient]
    e_valid = np.where(suffix, j <= len2 - k, (len1 - j) < len2)
    e_valid &= (j >= 1) & (r1 != r2)
    e_n = np.where(e_valid, np.where(suffix, j + k, len1 - j), 0)
    e_o1 = np.where(suffix, 0, j)
    e_o2 = np.maximum(np.where(suffix, len2 - e_n, 0), 0)
    c_valid = np.where(suffix, j >= len2 - k, j + len2 <= len1) & (r1 != r2)
    c_n = np.where(c_valid, len2, 0)
    c_o1 = np.maximum(np.where(suffix, j + k - len2, j), 0)
    rows2 = r2 + np.where(R._USE_RC[orient], store.n_reads, 0)
    i32 = lambda x: np.ascontiguousarray(x, np.int32)  # noqa: E731
    return dict(r1=r1, j=j, r2=r2, orient=orient, rows2=i32(rows2),
                e_valid=e_valid, c_valid=c_valid, e_o1=i32(e_o1),
                e_o2=i32(e_o2), e_n=i32(e_n), c_o1=i32(c_o1), c_n=i32(c_n))


def host_check(packed_all, rows1, rows2, o1, o2, n, block=1 << 15):
    """Base-by-base numpy compare of window [o1, o1+n) of rows1 with
    [o2, o2+n) of rows2 — no word arithmetic shared with the device."""
    shifts = (30 - 2 * np.arange(16, dtype=np.uint32))
    bases = ((packed_all[:, :, None] >> shifts) & 3).astype(np.uint8)
    bases = bases.reshape(len(packed_all), -1)
    width = int(n.max()) if len(n) else 0
    t = np.arange(width, dtype=np.int64)
    out = np.empty(len(n), bool)
    for s in range(0, len(n), block):
        e = min(s + block, len(n))
        live = t[None, :] < n[s:e, None]
        c1 = np.minimum(o1[s:e, None] + t, bases.shape[1] - 1)
        c2 = np.minimum(o2[s:e, None] + t, bases.shape[1] - 1)
        a = bases[rows1[s:e, None], c1]
        b = bases[rows2[s:e, None], c2]
        out[s:e] = ~((a != b) & live).any(axis=1)
    return out


def time_step(fn, args, reps: int = 20):
    """(compile + first run seconds, median seconds of `reps` runs)."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first, float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", help="interleaved paired FASTA (default: "
                                    "generate the E. coli-shaped isolate)")
    ap.add_argument("--pairs", type=int, default=1 << 20)
    args = ap.parse_args()

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU; JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    import jax.numpy as jnp

    from disco_tpu.index.table import FingerprintTable
    from disco_tpu.io.readstore import ReadStore
    from disco_tpu.overlap import device as D
    from disco_tpu.overlap.verify import make_packed_all, verify_windows_gather

    with tempfile.TemporaryDirectory() as td:
        fasta = args.reads
        if fasta is None:
            fasta = os.path.join(td, "reads.fasta")
            make_dataset(fasta)
        store = ReadStore.from_files([fasta], [], MIN_OVERLAP,
                                     reference_task_order=False)
    table = FingerprintTable.build(store, MIN_OVERLAP - 1)
    c = candidate_batch(store, table, args.pairs)
    n_pairs = len(c["r1"])
    pa_host = np.concatenate([store.packed, store.packed_rc])
    packed_all = make_packed_all(store.packed, store.packed_rc)
    lengths = jnp.asarray(store.lengths, jnp.int32)
    nw = store.n_words

    # production step, from (r1, j, r2, orient) through its own geometry
    checks = jax.jit(lambda pa, ln, q, j, r2, o: D.candidate_checks(
        pa, ln, q, j, r2[:, None], o[:, None],
        jnp.ones((q.shape[0], 1), bool), k=table.k, n_words=nw))
    edge, cont = checks(packed_all, lengths, c["r1"], c["j"], c["r2"],
                        c["orient"])
    edge, cont = np.asarray(edge[:, 0]), np.asarray(cont[:, 0])

    # reference 1: per-element gathers on the device
    g_edge = np.asarray(verify_windows_gather(
        packed_all, c["r1"], c["rows2"], c["e_o1"], c["e_o2"], c["e_n"],
        n_words=nw)) & c["e_valid"]
    g_cont = np.asarray(verify_windows_gather(
        packed_all, c["r1"], c["rows2"], c["c_o1"],
        np.zeros_like(c["c_o1"]), c["c_n"], n_words=nw)) & c["c_valid"]
    # reference 2: bases on the host
    h_edge = host_check(pa_host, c["r1"], c["rows2"], c["e_o1"], c["e_o2"],
                        c["e_n"]) & c["e_valid"]
    h_cont = host_check(pa_host, c["r1"], c["rows2"], c["c_o1"],
                        np.zeros_like(c["c_o1"]), c["c_n"]) & c["c_valid"]
    exact = bool(np.array_equal(edge, g_edge) and np.array_equal(cont, g_cont)
                 and np.array_equal(edge, h_edge)
                 and np.array_equal(cont, h_cont))

    # the production verify step alone, on the same pairs
    step = jax.jit(functools.partial(D.verify_pairs, n_words=nw))
    step_args = (packed_all, c["r1"], c["rows2"], c["e_o1"], c["e_o2"],
                 c["e_n"], c["c_o1"], c["c_n"])
    first, med = time_step(step, step_args)
    e, cn = step(*step_args)
    exact &= bool(np.array_equal(np.asarray(e) & c["e_valid"], g_edge)
                  and np.array_equal(np.asarray(cn) & c["c_valid"], g_cont))

    print(f"card: {card_line()}")
    print("tolerance: exact equality (integer-only u32 shift/XOR/mask "
          "path; no float product, so TF32 cannot arise)")
    if not exact:
        print("bench: verify results differ from the references",
              file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "verify_pairs_per_s", "value": n_pairs / med,
        "unit": "pairs/s", "pairs": n_pairs, "exact": exact,
        "compile_and_first_s": first, "median_s": med,
        "edge_hits": int(edge.sum()), "cont_hits": int(cont.sum()),
        "platform": dev.platform, "device_kind": dev.device_kind,
        "count": len(jax.devices())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
