"""Differential tests for the ROW-BATCHED set-op merge path.

optree._pack_rows splits pre-sorted inputs at shared key boundaries into
(R, L) rows so the device sorts short rows instead of one long
lax.sort.  These tests force inputs large
enough to cross ROW_SPLIT_MIN and check exact equality against the
naive dict model, including the all-ones sentinel-key corner.
"""

import numpy as np
import pytest

from meryl_tpu.optree import BucketEvaluator, DBInput, OpNode

K = 21


class _FakeDBInput(DBInput):
    """DBInput stand-in feeding in-memory sorted arrays per bucket."""

    def __init__(self, hi, lo, c):
        self._data = (hi, lo, c)

    def open(self):
        raise AssertionError("not used")


def _make_input(rng, n, k=K, force_allones=False):
    lo = rng.integers(0, 1 << (2 * k - 32), size=n, dtype=np.uint64) << 32
    lo |= rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    lo = np.unique(lo)
    if force_allones and 2 * k == 64:
        lo = np.unique(np.concatenate([lo, [np.uint64(2**64 - 1)]]))
    hi = np.zeros(len(lo), np.uint64)
    c = rng.integers(1, 50, size=len(lo)).astype(np.uint32)
    return hi, lo, c


def _naive(op, dicts, threshold=0):
    keys = set()
    for d in dicts:
        keys |= set(d)
    out = {}
    for key in keys:
        present = [d[key] for d in dicts if key in d]
        first_i = min(i for i, d in enumerate(dicts) if key in d)
        first_v = dicts[first_i][key]
        if op == "union-sum":
            out[key] = sum(present)
        elif op == "union":
            out[key] = len(present)
        elif op == "intersect-min":
            if len(present) == len(dicts):
                out[key] = min(present)
        elif op == "subtract":
            if first_i == 0:
                rest = sum(present) - first_v
                if first_v > rest:
                    out[key] = first_v - rest
        elif op == "difference":
            if first_i == 0 and len(present) == 1:
                out[key] = first_v
        else:
            raise AssertionError(op)
    return {k: v for k, v in out.items() if v > 0}


def _eval_direct(op, ins, m, threshold=0):
    """Drive the row-packing + kernel exactly as eval_buckets does."""
    import jax.numpy as jnp

    from meryl_tpu import kmer as km
    from meryl_tpu.ops import setops

    ev = BucketEvaluator(K)
    planes, values, ids = ev._pack_rows(ins, m)
    splanes, out_vals, keep = setops.merge_op(
        [jnp.asarray(p) for p in planes], jnp.asarray(values),
        jnp.asarray(ids), op, m, jnp.asarray(np.uint32(threshold)))
    idx = np.flatnonzero(np.asarray(keep))
    hi, lo = km.hilo_from_planes([np.asarray(p)[idx] for p in splanes])
    vals = np.asarray(out_vals)[idx]
    assert np.all(np.diff((hi.astype(object) << 64) | lo.astype(object))
                  > 0), "output not strictly ascending"
    return {(int(h) << 64) | int(l): int(v)
            for h, l, v in zip(hi, lo, vals)}


@pytest.mark.parametrize("op", ["union-sum", "union", "intersect-min",
                                "subtract", "difference"])
def test_rowbatch_matches_naive(op):
    rng = np.random.default_rng(5)
    # overlapping inputs: draw from a small key space so runs of 2-3
    # instances are common
    base_lo = rng.integers(0, 1 << 18, size=90000, dtype=np.uint64) * 7919
    ins = []
    dicts = []
    for i, n in enumerate([40000, 35000, 20000]):
        lo = np.unique(base_lo[rng.integers(0, len(base_lo), size=n)])
        hi = np.zeros(len(lo), np.uint64)
        c = rng.integers(1, 50, size=len(lo)).astype(np.uint32)
        ins.append((hi, lo, c))
        dicts.append({int(l): int(v) for l, v in zip(lo, c)})
    got = _eval_direct(op, ins, 3)
    assert got == _naive(op, dicts)


def test_rowbatch_sentinel_key():
    """The all-ones kmer (a REAL key at 2k % 32 == 0) must survive the
    row path even though padding shares its plane pattern."""
    rng = np.random.default_rng(6)
    k = 16
    ev = BucketEvaluator(k)
    ins = []
    dicts = []
    for i in range(2):
        lo = np.unique(rng.integers(0, 1 << 32, size=40000,
                                    dtype=np.uint64))
        lo = np.unique(np.concatenate([lo, [np.uint64((1 << 32) - 1)]]))
        hi = np.zeros(len(lo), np.uint64)
        c = rng.integers(1, 50, size=len(lo)).astype(np.uint32)
        ins.append((hi, lo, c))
        dicts.append({int(l): int(v) for l, v in zip(lo, c)})

    import jax.numpy as jnp

    from meryl_tpu import kmer as km
    from meryl_tpu.ops import setops

    planes, values, ids = ev._pack_rows(ins, 2)
    splanes, out_vals, keep = setops.merge_op(
        [jnp.asarray(p) for p in planes], jnp.asarray(values),
        jnp.asarray(ids), "union-sum", 2, jnp.asarray(np.uint32(0)))
    idx = np.flatnonzero(np.asarray(keep))
    hi, lo = km.hilo_from_planes([np.asarray(p)[idx] for p in splanes])
    got = {int(l): int(v)
           for l, v in zip(lo, np.asarray(out_vals)[idx])}
    assert got == _naive("union-sum", dicts)
    assert (1 << 32) - 1 in got


def test_rowbatch_skewed_inputs():
    """One input concentrated in a narrow key range (quantile cuts must
    still produce exact results, only padding efficiency degrades)."""
    rng = np.random.default_rng(7)
    lo_a = np.unique(rng.integers(0, 1 << 40, size=50000, dtype=np.uint64))
    lo_b = np.unique(rng.integers(1 << 20, (1 << 20) + (1 << 14),
                                  size=30000, dtype=np.uint64))
    ins = []
    dicts = []
    for lo in (lo_a, lo_b):
        hi = np.zeros(len(lo), np.uint64)
        c = rng.integers(1, 9, size=len(lo)).astype(np.uint32)
        ins.append((hi, lo, c))
        dicts.append({int(l): int(v) for l, v in zip(lo, c)})
    got = _eval_direct("union-sum", ins, 2)
    assert got == _naive("union-sum", dicts)
