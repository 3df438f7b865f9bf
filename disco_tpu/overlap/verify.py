"""Device-batched packed-word overlap verification.

Replaces the reference's byte-wise std::string::substr comparisons
(reference: src/BuildGraph/src/OverlapGraph.cpp:534,549,581,593) with 2-bit
packed uint32 word compares: 16 bases per XOR+mask op instead of one
byte-compare per base. All candidate pairs are verified
in one data-parallel batch instead of the reference's per-substring bucket
probes.

The core check: fwd(read1)[o1 : o1+n] == s2[o2 : o2+n], where s2 is either
fwd(read2) or rc(read2). Windows are compared word-by-word with funnel shifts
to handle arbitrary base offsets, with the final partial word masked.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np


def _window_word(packed, rows, base_off, wi):
    """Extract the uint32 word covering bases [base_off+16*wi, +16) of each
    row. `packed` is (R, W+1) with a trailing zero word so w0+1 is in range.
    Per-element 2-D gather; used by the `verify_windows_gather` oracle
    below."""
    word_idx = base_off // 16 + wi
    bit = (2 * (base_off % 16)).astype(jnp.uint32)
    w0 = packed[rows, word_idx]
    w1 = packed[rows, word_idx + 1]
    # (w1 >> (32-bit)) without the undefined shift-by-32: two-step shift
    lo = (w1 >> (jnp.uint32(31) - bit)) >> jnp.uint32(1)
    return jnp.where(bit == 0, w0, (w0 << bit) | lo)


def align_window(blk, o):
    """Align each row's window to word 0, bit 0: roll the (P, Wp) block
    left by o//16 words (log-step masked static rolls — vector ops only,
    no gathers) and funnel-shift left by 2*(o%16) bits.

    Wrapped tail words after the roll only ever reach masked-off window
    positions: a word wi needs its successor's bits only when the window
    still has >=1 base there, which for a valid window (o+n within the
    real words) means the successor is real data, never wrap.  Pure
    elementwise work on the gathered rows: no per-element gathers."""
    wp = blk.shape[1]
    d = (o // 16).astype(jnp.int32)
    x = blk
    b = 0
    while (1 << b) < wp:
        sel = ((d >> b) & 1) == 1
        x = jnp.where(sel[:, None], jnp.roll(x, -(1 << b), axis=1), x)
        b += 1
    s = (2 * (o % 16)).astype(jnp.uint32)[:, None]
    nxt = jnp.concatenate([x[:, 1:], jnp.zeros_like(x[:, :1])], axis=1)
    lo = (nxt >> (jnp.uint32(31) - s)) >> jnp.uint32(1)
    return jnp.where(s == 0, x, (x << s) | lo)


def _masked_equal(a, b, n, n_words):
    """AND over word steps of (a[:, wi] == b[:, wi]) under the window
    length mask; n == 0 rows come out True."""
    n = n.astype(jnp.int32)
    ok = jnp.ones(a.shape[:1], jnp.bool_)
    full = jnp.uint32(0xFFFFFFFF)
    for wi in range(n_words):
        rem = n - 16 * wi
        partial = full << (jnp.uint32(2) * (
            jnp.uint32(16) - jnp.clip(rem, 1, 16).astype(jnp.uint32)))
        mask = jnp.where(rem >= 16, full,
                         jnp.where(rem <= 0, jnp.uint32(0), partial))
        ok &= ((a[:, wi] ^ b[:, wi]) & mask) == 0
    return ok


@functools.partial(jax.jit, static_argnames=("n_words",))
def verify_windows(packed_all, rows1, rows2, o1, o2, n, *, n_words):
    """packed_all: (2N, W+1) uint32 — forward reads stacked over rc reads.
    rows1/rows2: (P,) int32 row indices into packed_all (caller adds N for rc).
    o1/o2: (P,) int32 base offsets; n: (P,) int32 window lengths (0 => True).
    Returns (P,) bool.

    Two whole-ROW gathers (the only gathers — contiguous 4*Wp-byte rows),
    roll-alignment of both windows to word 0, then static-column word
    compares; `verify_windows_gather` is the per-element formulation of the
    same check."""
    blk1 = align_window(packed_all[rows1], o1.astype(jnp.int32))
    blk2 = align_window(packed_all[rows2], o2.astype(jnp.int32))
    return _masked_equal(blk1, blk2, n, n_words)


@functools.partial(jax.jit, static_argnames=("n_words",))
def verify_windows_gather(packed_all, rows1, rows2, o1, o2, n, *, n_words):
    """The original per-element-gather formulation, kept as a second
    independent implementation for cross-checking the aligned path."""
    o1 = o1.astype(jnp.int32)
    o2 = o2.astype(jnp.int32)
    n = n.astype(jnp.int32)
    ok = jnp.ones(rows1.shape, jnp.bool_)
    for wi in range(n_words):
        rem = n - 16 * wi
        x = _window_word(packed_all, rows1, o1, wi)
        y = _window_word(packed_all, rows2, o2, wi)
        full = jnp.uint32(0xFFFFFFFF)
        partial = full << (jnp.uint32(2) * (jnp.uint32(16) - jnp.clip(rem, 1, 16).astype(jnp.uint32)))
        mask = jnp.where(rem >= 16, full, jnp.where(rem <= 0, jnp.uint32(0), partial))
        ok &= ((x ^ y) & mask) == 0
    return ok


def make_packed_all(packed: np.ndarray, packed_rc: np.ndarray) -> jnp.ndarray:
    """Stack forward and rc packed reads: rows [0,N) forward, [N,2N) rc."""
    return jnp.asarray(np.concatenate([packed, packed_rc], axis=0))
