"""Multiword (N x uint32-plane) integer helpers for JAX.

JAX computes in 32-bit integers by default (x64 off), so a 2k-bit
kmer (k <= 64; the reference's `kmdata` is 128-bit,
src/meryl/merylCountArray.C:512) is modeled as
P = ceil(2k/32) uint32 "planes", least-significant plane first.  All
shift amounts are Python-static so everything unrolls at trace time.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32


def zeros_like_planes(planes):
    return [jnp.zeros_like(p) for p in planes]


def shl(planes, bits: int):
    """Static left shift of a multiword value by `bits`."""
    if bits == 0:
        return list(planes)
    P = len(planes)
    word = bits // 32
    sub = bits % 32
    out = []
    for p in range(P):
        src = p - word
        v = planes[src] << U32(sub) if (src >= 0 and sub) else (planes[src] if src >= 0 else None)
        if v is None:
            out.append(jnp.zeros_like(planes[0]))
            continue
        if sub and src - 1 >= 0:
            v = v | (planes[src - 1] >> U32(32 - sub))
        out.append(v)
    return out


def bor(a, b):
    return [x | y for x, y in zip(a, b)]


def lt(a, b):
    """Lexicographic a < b over planes (MSB plane last in list)."""
    P = len(a)
    less = None
    eq = None
    for p in range(P - 1, -1, -1):
        l_p = a[p] < b[p]
        e_p = a[p] == b[p]
        if less is None:
            less, eq = l_p, e_p
        else:
            less = less | (eq & l_p)
            eq = eq & e_p
    return less


def eq(a, b):
    r = None
    for x, y in zip(a, b):
        e = x == y
        r = e if r is None else (r & e)
    return r


def select(pred, a, b):
    """where(pred, a, b) per plane."""
    return [jnp.where(pred, x, y) for x, y in zip(a, b)]


def run_starts(planes):
    """Boolean run-start mask over SORTED multiword keys: True where an
    entry differs from its predecessor in any plane (position 0 always
    starts a run).  The single shared implementation of the
    neighbor-compare idiom used by counting, set ops, the v2 engine and
    lookup."""
    neq = None
    for p in planes:
        d = p != jnp.concatenate([jnp.full((1,), 0xFFFFFFFF, U32),
                                  p[:-1]])
        neq = d if neq is None else (neq | d)
    return neq | jnp.zeros_like(neq).at[0].set(True)
