"""Device overlap pipeline vs the host parity relation (CPU mesh)."""
import numpy as np

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.device import DeviceOverlapEngine
from disco_tpu.overlap.relation import compute_relation


def test_device_overlap_matches_host_relation():
    d = GOLDEN / "mini"
    store = ReadStore.from_files([str(d / "reads.fasta")], [], 30,
                                 reference_task_order=False)
    table = FingerprintTable.build(store, 29)
    rel = compute_relation(store, table)

    eng = DeviceOverlapEngine(store, table, hit_cap=32)
    starts = eng.window_starts()
    res = eng.run(starts)
    assert int(np.asarray(res.overflow)) == 0

    got_edges = int(np.asarray(res.edge_ok).sum())
    got_cont = int(np.asarray(res.cont_ok).sum())
    assert got_edges == int(rel.edge_ok.sum())
    assert got_cont == int(rel.cont_ok.sum())

    # spot-check the actual (r1, j, r2) triples of verified edges
    r2 = np.asarray(res.r2)
    eok = np.asarray(res.edge_ok)
    qread = starts // store.max_len
    qj = starts % store.max_len
    got = set()
    qi, hi = np.nonzero(eok)
    for a, b in zip(qi, hi):
        got.add((int(qread[a]), int(qj[a]), int(r2[a, b])))
    want = set(zip(rel.r1[rel.edge_ok].tolist(), rel.j[rel.edge_ok].tolist(),
                   rel.r2[rel.edge_ok].tolist()))
    assert got == want


def test_aligned_vs_gather_verify():
    """The roll-aligned verify (production) must agree with the
    per-element-gather formulation on randomized windows, including n=0,
    partial-word tails, and maximal offsets."""
    import jax
    import numpy as np

    from disco_tpu.overlap.verify import (make_packed_all, verify_windows,
                                          verify_windows_gather)

    rng = np.random.default_rng(3)
    seqs = ["".join(rng.choice(list("ACGT"), int(rng.integers(40, 200))))
            for _ in range(300)]
    store = ReadStore.from_sequences(seqs)
    packed_all = jax.device_put(make_packed_all(store.packed,
                                                store.packed_rc))
    P = 4096
    lens = store.lengths
    rows1 = rng.integers(0, store.n_reads, P).astype(np.int32)
    rows2 = rng.integers(0, 2 * store.n_reads, P).astype(np.int32)
    l1 = lens[rows1]
    l2 = lens[rows2 % store.n_reads]
    n = (rng.integers(0, 200, P) % np.minimum(l1, l2)).astype(np.int32)
    n[::17] = 0
    o1 = (rng.integers(0, 200, P) % np.maximum(l1 - n, 1)).astype(np.int32)
    o2 = (rng.integers(0, 200, P) % np.maximum(l2 - n, 1)).astype(np.int32)
    a = np.asarray(verify_windows(packed_all, rows1, rows2, o1, o2, n,
                                  n_words=store.n_words))
    b = np.asarray(verify_windows_gather(packed_all, rows1, rows2, o1, o2,
                                         n, n_words=store.n_words))
    np.testing.assert_array_equal(a, b)
    assert a.any() and not a.all()  # non-degenerate case mix

