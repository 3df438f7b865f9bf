"""The production device backend (compute_relation backend="device") must
produce the exact relation of the native host kernel — including when the
bucket-overflow and compaction-overflow fallbacks fire."""
import numpy as np
import pytest

from conftest import GOLDEN
from disco_tpu.index.table import FingerprintTable
from disco_tpu.io.readstore import ReadStore
from disco_tpu.overlap.relation import (_device_relation, compute_relation,
                                        default_backend)


def _load(case="mini", min_ovl=30):
    d = GOLDEN / case
    store = ReadStore.from_files([str(d / "reads.fasta")], [], min_ovl,
                                 reference_task_order=False)
    table = FingerprintTable.build(store, min_ovl - 1)
    return store, table


def _assert_equal(a, b):
    assert len(a) == len(b)
    for f in ("r1", "j", "r2", "orient", "typ", "cont_ok", "edge_ok"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def test_device_backend_matches_native():
    # chunk shrunk from the production 1<<19 so the CPU-mesh grid stays
    # cheap; the chunking logic itself is what matters (multiple chunks +
    # a padded tail)
    store, table = _load()
    want = compute_relation(store, table, backend="native")
    got = _device_relation(store, table, chunk=1 << 14)
    _assert_equal(got, want)


def test_device_backend_cand_cap_overflow_fallback():
    """cand_factor=1 with tiny chunks makes some chunks exceed the static
    candidate cap, exercising the exact whole-chunk host re-run."""
    store, table = _load()
    want = compute_relation(store, table, backend="native")
    got = _device_relation(store, table, chunk=32, cand_factor=1)
    _assert_equal(got, want)


def test_device_backend_small_chunks():
    """Many chunks incl. a padded tail; dense path, no fallback pressure."""
    store, table = _load()
    want = compute_relation(store, table, backend="native")
    got = _device_relation(store, table, chunk=256)
    _assert_equal(got, want)


def test_default_backend_env(monkeypatch):
    monkeypatch.setenv("DISCO_TPU_BACKEND", "xla")
    assert default_backend() == "xla"
    monkeypatch.delenv("DISCO_TPU_BACKEND")
    # tests run under JAX_PLATFORMS=cpu -> native
    assert default_backend() == "native"


def test_device_backend_wire32_escape_stream(monkeypatch):
    """The 4-byte wire format's dwi escape path: forcing a wide read
    field leaves a 4-bit delta field, so window-index gaps > 14 must ride
    the escape side stream and still reconstruct exactly."""
    monkeypatch.setenv("DISCO_TPU_WIRE_RBITS", "24")
    store, table = _load()
    want = compute_relation(store, table, backend="native")
    got = _device_relation(store, table, chunk=1 << 14)
    _assert_equal(got, want)


def test_device_backend_wire64_env(monkeypatch):
    """DISCO_TPU_WIRE64 forces the 8-byte row format (the fallback for
    read counts too large for the packed field)."""
    monkeypatch.setenv("DISCO_TPU_WIRE64", "1")
    store, table = _load()
    want = compute_relation(store, table, backend="native")
    got = _device_relation(store, table, chunk=1 << 14)
    _assert_equal(got, want)


def test_default_backend_propagates_jax_errors(monkeypatch):
    """A JAX that fails to start must not silently pick the host kernel."""
    import jax

    def broken():
        raise RuntimeError("no backend")
    monkeypatch.delenv("DISCO_TPU_BACKEND", raising=False)
    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError, match="no backend"):
        default_backend()
