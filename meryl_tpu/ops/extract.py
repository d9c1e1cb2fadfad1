"""Device-side canonical k-mer extraction.

Turns a fixed-length chunk of 2-bit base codes into per-position
(fmer, rmer, canonical) multiword kmers plus a validity mask, entirely
with vectorized ops (no scans): windows of length k are built by a
binary-doubling combine, O(log k) multiword shift/or steps.

Shifts are pure `lax.slice`s over progressively shrinking buffers (the
input is padded once by k-1+ codes): slices fuse into their consumers,
whereas the previous concatenate-based shifts materialized a buffer per
shift and broke XLA fusion (~2x the HBM passes).

Semantics matched to the reference:
  * canonical = min(fmer, rmer) in the A=00,C=01,T=10,G=11 integer order
    (/root/reference/src/meryl/merylOp-countThreads.C:244-256)
  * any non-ACGT code invalidates every window containing it — this is
    how both sequence breaks and N bases are handled (reference
    kmerIterator; merylOp-countThreads.C:196-226)
  * count-forward / count-reverse variants keep the forward / reverse
    mer instead (merylOp.H:33-35)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from . import multiword as mw
from ..kmer import num_planes

U32 = jnp.uint32
INVALID_CODE = 255
_PAD = 64  # >= k-1 for k <= 64


def _shift_planes(planes, m: int, out_len: int):
    """Slice-based shift: result[i] = planes[i+m], length out_len."""
    return [lax.slice(p, (m,), (m + out_len,)) for p in planes]


def _trim(planes, out_len: int):
    return [lax.slice(p, (0,), (out_len,)) for p in planes]


def _build_windows(base_f, base_r, base_v, k: int, L: int):
    """Binary-doubling build of length-k windows over padded buffers.

    base_*: arrays of length L + _PAD; every combine shrinks the
    working length by the shift amount (slices, no copies), ending at
    exactly L + _PAD - (k-1) >= L entries.
    """
    bits = bin(k)[2:]  # MSB first
    accf, accr, accv, alen = base_f, base_r, base_v, 1
    cur = L + _PAD

    def combine_f(acc, acc_len, other, other_len, out_len):
        """window(a+b)[i] = window_a[i] << 2b | window_b[i+a]."""
        return mw.bor(mw.shl(_trim(acc, out_len), 2 * other_len),
                      _shift_planes(other, acc_len, out_len))

    def combine_r(acc, acc_len, other, other_len, out_len):
        """rc(a+b)[i] = rc_b[i+a] << 2a | rc_a[i]."""
        return mw.bor(mw.shl(_shift_planes(other, acc_len, out_len),
                             2 * acc_len),
                      _trim(acc, out_len))

    for b in bits[1:]:
        # double: acc_len -> 2*acc_len
        nxt = cur - alen
        accf = combine_f(accf, alen, accf, alen, nxt)
        accr = combine_r(accr, alen, accr, alen, nxt)
        accv = lax.slice(accv, (0,), (nxt,)) & \
            lax.slice(accv, (alen,), (alen + nxt,))
        cur = nxt
        alen *= 2
        if b == "1":
            nxt = cur - 1
            accf = combine_f(accf, alen, base_f, 1, nxt)
            accr = combine_r(accr, alen, base_r, 1, nxt)
            accv = lax.slice(accv, (0,), (nxt,)) & \
                lax.slice(base_v, (alen,), (alen + nxt,))
            cur = nxt
            alen += 1
    assert alen == k and cur == L + _PAD - (k - 1)
    return _trim(accf, L), _trim(accr, L), lax.slice(accv, (0,), (L,))


def _build_windows_rolldot(codes_u32, k: int, L: int):
    """Rolling-dot window build: O(1) passes in k (vs the multiword
    doubling's O(P log k)).

    One shared ladder of 4 fused mul-add passes builds the 16-base
    rolling dot products
        y[m] = sum_{t=0..15} x[m+t] * 4^(15-t)   (forward)
        z[m] = sum_{t=0..15} xc[m+t] * 4^t       (reverse-complement)
    in EXACT uint32 arithmetic (max value 4^16-1 = 2^32-1); every
    32-bit kmer plane is then just a slice of y / z:

      fmer plane p at position i = y[i + lp + k - 16(p+1)]
        (x left-padded with lp = 16P-k zeros so slice starts stay >= 0)
      rmer plane p at position i = z[i + lp + 16p]

    Top planes are AND-masked to 2k-32p bits: taps outside the kmer
    (preceding codes for fmer, following codes for rmer) land at base-4
    digits >= 2k-32p, and digit placement never carries, so the mask
    removes them exactly.
    """
    P = num_planes(k)
    lp = 16 * P - k          # left zero-pad so the top fmer slice >= 0
    rpad = k + 16            # right pad: windows + ladder lookahead
    x = jnp.concatenate([jnp.zeros((lp,), U32), codes_u32,
                         jnp.zeros((rpad,), U32)])
    xc = jnp.concatenate([jnp.zeros((lp,), U32), codes_u32 ^ U32(2),
                          jnp.zeros((rpad,), U32)])

    def ladder(v, wexp):
        # wexp=+1: weights 4^(n-1-t) (forward); -1: 4^t (reverse)
        for step in (1, 2, 4, 8):
            hiw = U32(1 << (2 * step))
            a = lax.slice(v, (0,), (v.shape[0] - step,))
            b = lax.slice(v, (step,), (v.shape[0],))
            v = (a * hiw + b) if wexp > 0 else (a + b * hiw)
        return v

    y = ladder(x, +1)
    z = ladder(xc, -1)

    def top_mask(v, p):
        bits = 2 * k - 32 * p
        return v & U32((1 << bits) - 1) if bits < 32 else v

    fmer = [top_mask(lax.slice(y, (lp + k - 16 * (p + 1),),
                               (lp + k - 16 * (p + 1) + L,)), p)
            for p in range(P)]
    rmer = [top_mask(lax.slice(z, (lp + 16 * p,),
                               (lp + 16 * p + L,)), p)
            for p in range(P)]
    return fmer, rmer


def _valid_windows(is_valid, k: int, L: int):
    """AND of k consecutive validity flags by binary doubling (single
    u32 array, log2(k) fused passes)."""
    bits = bin(k)[2:]
    acc, alen = is_valid, 1
    cur = is_valid.shape[0]
    for b in bits[1:]:
        nxt = cur - alen
        acc = lax.slice(acc, (0,), (nxt,)) & \
            lax.slice(acc, (alen,), (alen + nxt,))
        cur = nxt
        alen *= 2
        if b == "1":
            nxt = cur - 1
            acc = lax.slice(acc, (0,), (nxt,)) & \
                lax.slice(is_valid, (alen,), (alen + nxt,))
            cur = nxt
            alen += 1
    return lax.slice(acc, (0,), (L,))


def _extract_from_u32(codes, k: int, mode: str, n_real=None):
    """Shared core: codes (L,) uint32 (0..3, INVALID_CODE elsewhere) ->
    (planes, valid).  n_real: optional traced scalar — windows starting
    at or past position n_real - k + 1 are invalidated (used by the
    packed wire format, whose trailing pad unpacks to code 0)."""
    L = codes.shape[0]

    padded = jnp.concatenate(
        [codes, jnp.full((_PAD,), INVALID_CODE, U32)])
    is_valid = (padded <= U32(3)).astype(U32)
    c = jnp.where(padded <= U32(3), padded, U32(0))

    fmer, rmer = _build_windows_rolldot(lax.slice(c, (0,), (L,)), k, L)
    valid = _valid_windows(is_valid, k, L)

    # windows that run off the end of the chunk are invalid (the pad is
    # INVALID_CODE, so `valid` already covers this; pos_ok is belt and
    # braces for the L-k+1..L-1 tail)
    last = jnp.int32(L - k) if n_real is None else \
        (n_real.astype(jnp.int32) - jnp.int32(k))
    pos_ok = jnp.arange(L, dtype=jnp.int32) <= last
    validb = (valid == U32(1)) & pos_ok

    if mode == "canonical":
        use_f = mw.lt(fmer, rmer)
        out = mw.select(use_f, fmer, rmer)
    elif mode == "forward":
        out = fmer
    elif mode == "reverse":
        out = rmer
    elif mode == "both":
        # forward and reverse-complement mers per position (the lookup
        # tools query both to support non-canonical DBs, reference
        # dump.C:93-127)
        return fmer, rmer, validb
    else:
        raise ValueError(mode)
    return out, validb


@functools.partial(jax.jit, static_argnames=("k", "mode"))
def extract_kmers(codes, k: int, mode: str = "canonical"):
    """codes: (L,) uint8/uint32 base codes (0..3, INVALID_CODE elsewhere).

    Returns (planes, valid) where planes is a list of P uint32 arrays of
    length L (window starting at each position; windows running past the
    end are invalid) and valid is a bool array of length L.
    """
    return _extract_from_u32(codes.astype(U32), k, mode)


@functools.partial(jax.jit, static_argnames=("k", "mode"))
def extract_kmers_packed(packed2, exc, n_real, k: int,
                         mode: str = "canonical"):
    """Packed-wire variant: the host ships 2-bit codes (16/u32 word,
    code j of word w at bits 2*(j mod 16)) plus a short exception index
    list instead of one byte per base — a 4x host->device wire cut (the
    reference's loader streams 2 MB buffers for the same reason,
    /root/reference/src/meryl/merylOp-countThreads.C:138-168).

    packed2: (L/16,) uint32; exc: (E,) int32 positions of non-ACGT
    codes (N bases / sequence separators), padded with INT32_MAX
    (out-of-bounds entries drop); n_real: traced scalar — codes at
    positions >= n_real are trailing pad.
    Returns (planes, valid) exactly like extract_kmers.
    """
    W = packed2.shape[0]
    sh = U32(2) * jax.lax.broadcasted_iota(U32, (W, 16), 1)
    codes = ((packed2[:, None] >> sh) & U32(3)).reshape(W * 16)
    # exceptions are sparse (~1 per read + N runs): a tiny scatter of
    # a few thousand elements costs far less than a bitmask sideband's
    # L/8 wire bytes
    codes = codes.at[exc].set(U32(INVALID_CODE), mode="drop",
                              unique_indices=True)
    return _extract_from_u32(codes, k, mode, n_real=n_real)
