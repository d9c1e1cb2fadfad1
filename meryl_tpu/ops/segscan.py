"""Scatter-free segmented reductions over sorted runs.

Background: XLA lowers jax.ops.segment_* to scatters.  Runs of equal
kmers are CONTIGUOUS after sorting, so every
per-run reduction can instead be phrased as a segmented prefix scan
(lax.associative_scan with a reset flag) — log-depth, fully vectorized.

The segmented-scan operator is the classic (value, reset-flag) monoid:
    (v1, f1) . (v2, f2) = (v2 if f2 else op(v1, v2), f1 | f2)

`seg_all` broadcasts the FULL-run reduction to every element of the run
by combining a forward (prefix) scan with a backward (suffix) scan —
no gathers or scatters anywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _seg_operator(op):
    def combine(a, b):
        av, af = a
        bv, bf = b
        v = jax.tree.map(lambda x, y: jnp.where(bf, y, op(x, y)), av, bv)
        return v, af | bf
    return combine


def seg_scan(op, vals, start, reverse: bool = False):
    """Inclusive segmented scan of `vals` (a pytree of equal-length
    arrays) within runs delimited by `start` flags.

    reverse=True scans from run ends backwards (suffix scan)."""
    if reverse:
        # a run's LAST element is the one before the next start
        end = jnp.concatenate([start[1:], jnp.ones((1,), bool)])
        rvals = jax.tree.map(lambda x: x[::-1], vals)
        rv, _ = lax.associative_scan(_seg_operator(op), (rvals, end[::-1]))
        return jax.tree.map(lambda x: x[::-1], rv)
    v, _ = lax.associative_scan(_seg_operator(op), (vals, start))
    return v


def seg_all(op, vals, start):
    """Full-run reduction broadcast to every element of its run."""
    fwd = seg_scan(op, vals, start)
    bwd = seg_scan(op, vals, start, reverse=True)
    # full[i] = op(fwd[i], bwd[i+1]) when i+1 continues the run
    def shift_next(x):
        return jnp.concatenate([x[1:], x[-1:]])
    nxt_in_run = jnp.concatenate([~start[1:], jnp.zeros((1,), bool)])
    return jax.tree.map(
        lambda f, b: jnp.where(nxt_in_run, op(f, shift_next(b)), f),
        fwd, bwd)


def seg_sum_all(vals, start):
    return seg_all(jnp.add, vals, start)


def seg_min_all(vals, start):
    return seg_all(jnp.minimum, vals, start)


def seg_max_all(vals, start):
    return seg_all(jnp.maximum, vals, start)
