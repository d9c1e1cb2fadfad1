"""Multi-device sharded k-mer counting: route-first SPMD step over an
all-to-all collective (shard_map; NCCL over NVLink on GPUs).

The reference meryl's only distributed story is external sharding
(`segment=a/b`, /root/reference/src/meryl/merylCommandBuilder.C:313-315)
followed by a DB `union-sum` merge.  The replacement here is one
fused SPMD program per input step, built on the SAME routed dataflow as
the single-device accumulator (ops/accum.py):

  1. every device extracts canonical kmer windows from its own shard of
     the base stream (data parallelism over input),
  2. routes raw windows to B key-range bucket rows with the exact
     integer equal-mass map (accum.row_from_prefix_int) — short
     row-batched sorts, never one long row,
  3. ships the (B, Wc) cell grid through ONE tiled `lax.all_to_all`:
     bucket rows are assigned to owner devices in contiguous blocks of
     rpo = B/n rows, so the collective needs NO gathers and no
     per-destination send-buffer packing — owner blocks are contiguous
     by construction, and each owner receives its rpo rows from all n
     sources side by side as a (rpo, n*Wc) staged cell group,
  4. the owner folds staged groups into its (rpo, La) sorted-unique
     accumulator with the row-batched merge (accum.merge_cells).

Ownership generalizes the reference's 6-bit DB file partition
(/root/reference/documentation/source/reference.rst:71-81) to B
equal-expected-mass key ranges; the on-disk 64-file layout stays at
the DB edges.

Exactness contract (every hatch exact, nothing silently dropped —
the in-collective analog of the reference's out-of-core dump pressure
path, /root/reference/src/meryl/merylOp-countThreads.C:311-380):

  * cell overflow (composition skew): overflowed windows land in a
    per-routing-row capture region; the SOURCE process counts them
    host-side and they are union-merged at finalize,
  * capture overflow (adversarial skew, e.g. poly-A): the source
    device's whole chunk contribution is MASKED out of the staged grid
    (its columns are a contiguous block, set to the sentinel) and that
    chunk is recounted on the host path — the kept chunk codes make
    this exact,
  * accumulator row overflow: the merge is re-dispatched with a grown
    row capacity (old accumulator and staged cells stay alive until
    the new one is verified); past the entry budget the accumulator
    spills to host/disk first (the reference's batch dump, P5),
  * the all-ones kmer (a real key when 2k % 32 == 0) is excluded on
    device and carried by a replicated per-source scalar, so the
    sentinel never aliases a real key.

All control scalars cross as REPLICATED collective outputs (psum of
per-source one-hots), so in multi-host jobs every process takes
identical mask/spill/regrow decisions — lockstep is preserved.  The
few host-side extras that can belong to foreign owners (captures,
recounted chunks) are exchanged at finalize with two allgathers and
split by the SAME integer row map the device used — bit-identical by
construction, which is the reason the map is integer, not float.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..kmer import num_planes
from ..ops import accum
from ..ops import extract as ext
from ..ops.accum import OVF_CAP

U32 = jnp.uint32
SENT = U32(0xFFFFFFFF)

# hatch counters of the most recent finalized ShardedCounter (set at
# iter_finalized_parts; read by the driver dryrun to assert the forced
# hatches really ran through the product CLI)
LAST_SHARD_STATS: dict = {}


def plan_shard_route(chunk_len: int, k: int, n: int) -> dict:
    """Static routing geometry for the SPMD step.

    Mirrors accum.plan_route's trade-offs (short routing rows,
    3-sigma cell slack) with two extra constraints: the bucket-row
    count B must be a multiple of n (the all-to-all splits rows into
    equal owner blocks) and the row map must be the exact integer map
    (bits <= 16).  For tiny k the key space itself caps B — fewer,
    fatter rows keep the cells from being mostly padding."""
    L0 = min(1 << 18, chunk_len)  # as accum.plan_route
    while chunk_len % L0:
        L0 >>= 1
    R0 = chunk_len // L0
    bits = min(16, 2 * k)
    # key-space guard: at most ~2^(2k-5) rows are meaningfully
    # distinct; overall cap 2^10 as in accum.plan_route
    cap = 1 << max(0, min(10, 2 * k - 5))
    b_target = max(n, min(cap, max(1, L0 // 8)))
    rpo = max(1, b_target // n)
    B = n * rpo
    mean = max(1.0, L0 / B)
    c = max(4, int(mean + 3.0 * mean ** 0.5 + 4))
    return {"B": B, "rpo": rpo, "R0": R0, "L0": L0, "c": c,
            "bits": bits, "Wc": R0 * c}


def owner_of_keys(hi: np.ndarray, lo: np.ndarray, k: int, bits: int,
                  B: int, rpo: int, canonical: bool) -> np.ndarray:
    """Owner device of each (hi, lo) kmer key — the HOST mirror of the
    device's routing: top `bits` bits -> integer equal-mass row ->
    row // rpo.  Bit-identical to the device map (integer arithmetic
    only), so extras recounted host-side land on exactly the owner
    whose accumulator holds that key range."""
    twok = 2 * k
    hi = np.asarray(hi, np.uint64)
    lo = np.asarray(lo, np.uint64)
    if twok <= 64:
        pref = lo >> np.uint64(twok - bits) if twok > bits else lo
    else:
        hb = twok - 64  # bits stored in hi
        if bits <= hb:
            pref = hi >> np.uint64(hb - bits)
        else:
            need = bits - hb
            pref = (hi << np.uint64(need)) | (lo >> np.uint64(64 - need))
    row = accum.row_from_prefix_int(pref.astype(np.uint32), bits, B,
                                    canonical, xp=np)
    return (row // rpo).astype(np.int32)


def make_routed_step(mesh: Mesh, k: int, cfg: tuple, n: int,
                     chunk_len: int):
    """Build the jitted SPMD step.  fn(codes) with codes a
    (n * chunk_len,) uint8 array sharded over axis 'd'.

    Per-device outputs (global views):
      staged:  P x (B, n*Wc) uint32 — each owner's rpo rows, all n
               sources' cells side by side (source s = columns
               [s*Wc, (s+1)*Wc)); raw windows, count 1 each, sentinel
               padded
      ovf:     P x (n*R0, OVF_CAP) uint32 — per-source capture regions
      n_ovf_row: (n*R0,) int32 — capture occupancy per routing row
      stats:   (3, n) int32, REPLICATED — per source s:
               [0, s] = 1 if s's captures overflowed (mask + recount s)
               [1, s] = captured windows on s (only valid when not bad)
               [2, s] = s's all-ones kmer count
    """
    nplanes = num_planes(k)
    _, _, _, B, R0, L0, c, bits = cfg

    def step(codes):
        codes = codes.reshape(chunk_len)
        planes, valid = ext.extract_kmers(codes, k, cfg[2])
        cells, ovf, n_ovf_row, n_allones = accum._route_core(
            planes, valid, cfg)
        # owner blocks are contiguous rows of the cell grid: ONE tiled
        # all-to-all, no gathers, no send-buffer packing
        recv = [jax.lax.all_to_all(cl, "d", split_axis=0,
                                   concat_axis=1, tiled=True)
                for cl in cells]
        me = jax.lax.axis_index("d")
        onehot = (jax.lax.iota(jnp.int32, n) == me).astype(jnp.int32)
        bad = (jnp.max(n_ovf_row) > OVF_CAP).astype(jnp.int32)
        ncap = jnp.sum(jnp.minimum(n_ovf_row, OVF_CAP))
        stats = jax.lax.psum(
            jnp.stack([onehot * bad, onehot * ncap,
                       onehot * n_allones]), "d")
        return (tuple(recv), ovf, n_ovf_row, stats)

    fn = jax.shard_map(
        step, mesh=mesh,
        in_specs=P("d"),
        out_specs=(tuple(P("d", None) for _ in range(nplanes)),
                   tuple(P("d", None) for _ in range(nplanes)),
                   P("d"), P()),
        check_vma=False)
    return jax.jit(fn)


def make_routed_merge(mesh: Mesh, nplanes: int, n_staged: int,
                      La_out: int, vmax: int):
    """Jitted sharded fold of `n_staged` staged cell groups into the
    per-owner accumulators: row-batched accum.merge_cells per device
    (rpo rows each).  Returns (planes, counts, nmax) with nmax the
    REPLICATED max run count over all rows — > La_out means entries
    were truncated and the caller must re-dispatch with a larger
    La_out (the old accumulator and staged groups stay alive)."""
    def merge(acc_planes, acc_counts, *staged_flat):
        a_pl = [p for p in acc_planes]
        staged = [tuple(staged_flat[g * nplanes + p]
                        for p in range(nplanes))
                  for g in range(n_staged)]
        planes, counts, n_runs = accum.merge_cells(
            a_pl, acc_counts, tuple(staged), nplanes, La_out, vmax)
        nmax = jax.lax.pmax(jnp.max(n_runs), "d")
        return tuple(planes), counts, nmax

    fn = jax.shard_map(
        merge, mesh=mesh,
        in_specs=(tuple(P("d", None) for _ in range(nplanes)),
                  P("d", None))
                 + tuple(P("d", None) for _ in range(n_staged * nplanes)),
        out_specs=(tuple(P("d", None) for _ in range(nplanes)),
                   P("d", None), P()),
        check_vma=False)
    return jax.jit(fn)


def make_mask_sources(mesh: Mesh, nplanes: int, n: int, Wc: int):
    """Jitted sharded masking of bad sources out of a staged grid:
    source s's contribution is the contiguous column block
    [s*Wc, (s+1)*Wc) of every owner row — set its keys to the sentinel
    (merge_cells drops sentinel-keyed entries), exactly removing that
    chunk so its host recount is the only copy."""
    def mask(bad_vec, *staged):
        cols = jnp.repeat(bad_vec, Wc)  # (n*Wc,), static repeat
        m = cols[None, :] > 0
        return tuple(jnp.where(m, SENT, s) for s in staged)

    fn = jax.shard_map(
        mask, mesh=mesh,
        in_specs=(P(),) + tuple(P("d", None) for _ in range(nplanes)),
        out_specs=tuple(P("d", None) for _ in range(nplanes)),
        check_vma=False)
    return jax.jit(fn)


class ShardedCounter:
    """End-to-end multi-chip counting: feed (n_dev * chunk_len) base
    codes per step; every step routes windows to owner-keyed bucket
    rows, ships them through the all-to-all, and the owners fold them
    into sorted-unique accumulators.  When an accumulator nears its
    entry budget it spills to host RAM / disk (the reference's
    out-of-core batch dump, P5) and resets.  finalize() merges spills +
    accumulators + hatch extras per owner and returns globally sorted
    (hi, lo, counts) — owner key ranges ascend with device id, so
    per-device results concatenate in order.

    This replaces the reference's external count-shards-then-union-sum
    pattern (SURVEY.md P6) with one fused SPMD pass."""

    # staged groups folded per merge dispatch: each group already
    # carries ~n chunks' worth of mass per owner row, so the single
    # chip's M=8 amortization divides by n
    MERGE_EVERY = 2

    def __init__(self, mesh: Mesh, k: int, *, chunk_len: int,
                 mode: str = "canonical", acc_cap: int | None = None,
                 spill_dir: str | None = None):
        self.mesh = mesh
        self.k = int(k)
        self.n = mesh.devices.size
        self.chunk_len = int(chunk_len)
        self.mode = mode
        self.nplanes = num_planes(self.k)
        g = plan_shard_route(self.chunk_len, self.k, self.n)
        self.B, self.rpo, self.Wc = g["B"], g["rpo"], g["Wc"]
        self.bits = g["bits"]
        self.cfg = (self.k, self.nplanes, mode, g["B"], g["R0"],
                    g["L0"], g["c"], g["bits"])
        self._step = make_routed_step(mesh, self.k, self.cfg, self.n,
                                      self.chunk_len)
        self._mask = None  # built on first bad source
        # per-device accumulator entry budget (rpo rows x La columns);
        # MERYL_TPU_SHARD_ACC_CAP (entries) forces it — dryruns/tests
        # use a tiny value to walk the spill hatch through the CLI
        if acc_cap is None and os.environ.get("MERYL_TPU_SHARD_ACC_CAP"):
            acc_cap = int(os.environ["MERYL_TPU_SHARD_ACC_CAP"])
        if acc_cap is None:
            from ..budget import budget_bytes
            acc_cap = int(budget_bytes("acc") /
                          ((self.nplanes + 1) * 4 * 3 * self.n))
        self.acc_cap = int(acc_cap)
        # acc_cap is the TOTAL per-device entry budget; the per-row cap
        # gets 2x slack because the equal-mass map balances rows only
        # in expectation — a transiently hot row may regrow past the
        # mean while the proactive spill (nmax * rpo >= acc_cap after
        # each merge) keeps the total honest
        self.La_max = max(1, 2 * self.acc_cap // self.rpo)
        self.La0 = min(self.La_max,
                       max(64, accum._eighth_round(
                           self.MERGE_EVERY * self.n * self.Wc // 2)))
        self.La = self.La0
        self._acc = None           # (planes tuple, counts) sharded
        self._pending = []         # [(step outputs, codes)]
        self._staged = []          # cleared staged grids awaiting merge
        self._n_allones = 0
        self._captures = []        # per-P lists of raw window planes
        self._fallback_runs = []   # host-recounted chunks (hi, lo, c)
        self.spill_dir = spill_dir
        self._spill_seq = 0
        self._spills: dict = {}
        self._merge_cache: dict = {}
        # hatch observability (LAST_SHARD_STATS mirrors this at
        # finalize; the driver dryrun asserts the hatches it forces
        # really ran through the product CLI)
        self.stats = {"spills": 0, "recount_chunks": 0,
                      "captured_windows": 0, "steps": 0}

    # ---------------- device programs / sharded state ----------------

    def _sharding(self):
        return NamedSharding(self.mesh, P("d", None))

    def _fresh_acc(self, La: int):
        sh = self._sharding()
        np_, B = self.nplanes, self.B

        def mk():
            zp = tuple(jnp.full((B, La), 0xFFFFFFFF, jnp.uint32)
                       for _ in range(np_))
            zc = jnp.zeros((B, La), jnp.uint32)
            return zp, zc

        out_sh = (tuple(sh for _ in range(np_)), sh)
        return jax.jit(mk, out_shardings=out_sh)()

    def _get_merge(self, n_staged: int, La_out: int):
        key = (n_staged, self.La, La_out)
        fn = self._merge_cache.get(key)
        if fn is None:
            from .. import kmer as km
            fn = make_routed_merge(self.mesh, self.nplanes, n_staged,
                                   La_out, int(km.VALUE_MAX))
            self._merge_cache[key] = fn
        return fn

    # ------------------------- feed path ------------------------------

    def add_codes(self, codes) -> None:
        """codes: (n_dev * chunk_len,) uint8 (numpy, or a globally
        sharded jax array in multi-host jobs); device d's shard is an
        independent sequence window (callers insert separators).

        Pipelined 1 deep: the previous step's replicated stats are
        resolved first (by now the device has finished it, so the
        fetch doesn't stall), then this step is dispatched and the
        call returns while it runs.  Hatch handling therefore
        surfaces one call late (or at finalize), always before any
        results."""
        if isinstance(codes, np.ndarray):
            want = self.n * self.chunk_len
            if len(codes) < want:
                from ..io.sequence import SEP
                codes = np.concatenate(
                    [codes, np.full(want - len(codes), SEP, np.uint8)])
            codes = jnp.asarray(codes)
        out = self._step(codes)
        self.stats["steps"] += 1
        self._pending.append((out, codes))
        if len(self._pending) > 1:
            self._resolve_pending(keep_last=True)
        if len(self._staged) >= self.MERGE_EVERY:
            self._merge_staged()

    def _resolve_pending(self, keep_last: bool = False) -> None:
        pend = self._pending[:-1] if keep_last else self._pending
        self._pending = self._pending[-1:] if keep_last else []
        if not pend:
            return
        # ONE fetch for all pending steps' replicated stats
        stats = np.asarray(jnp.stack([p[0][3] for p in pend]))
        for (out, codes), st in zip(pend, stats):
            self._resolve_one(out, codes, st)

    def _resolve_one(self, out, codes, st) -> None:
        staged, ovf, n_ovf_row, _ = out
        bad = st[0] > 0
        ncap = st[1]
        if bad.any():
            # mask every bad source's column block out of the staged
            # grid, then recount the addressable bad chunks host-side
            if self._mask is None:
                self._mask = make_mask_sources(
                    self.mesh, self.nplanes, self.n, self.Wc)
            staged = self._mask(
                jnp.asarray(bad.astype(np.int32)), *staged)
            for s in np.flatnonzero(bad):
                local = self._local_codes(codes, int(s))
                if local is not None:
                    self._recount_chunk(local)
        if (ncap * (~bad)).sum() > 0:
            self._collect_captures(ovf, n_ovf_row, bad)
        # all-ones kmers of GOOD sources only (a bad source's host
        # recount counts its own all-ones kmers)
        self._n_allones += int(st[2][~bad].sum())
        self._staged.append(tuple(staged))

    def _local_codes(self, codes, s: int):
        """Source s's chunk as numpy, if addressable by this process.
        Shards need not be chunk-aligned (a single-process jnp.asarray
        holds the whole feed in one shard) — slice by global offset."""
        lo = s * self.chunk_len
        if isinstance(codes, np.ndarray):
            return codes[lo:lo + self.chunk_len]
        for sh in codes.addressable_shards:
            start = sh.index[0].start or 0
            arr = sh.data
            if start <= lo and lo + self.chunk_len <= start + arr.shape[0]:
                return np.asarray(arr)[lo - start:
                                       lo - start + self.chunk_len]
        return None

    def _recount_chunk(self, codes_np: np.ndarray) -> None:
        from ..counter import _count_chunk, _finish_chunk
        self.stats["recount_chunks"] += 1
        self._fallback_runs.extend(
            _finish_chunk(*_count_chunk(codes_np, self.k, self.mode,
                                        None)))

    def _collect_captures(self, ovf, n_ovf_row, bad) -> None:
        """Collect this process's capture-region windows (rare path:
        two addressable fetches).  Rows of bad sources are skipped —
        their whole chunk is recounted instead."""
        R0 = self.cfg[4]
        nrow_loc = {}  # global routing row -> count
        for sh in n_ovf_row.addressable_shards:
            base = sh.index[0].start or 0
            arr = np.asarray(sh.data)
            for i, v in enumerate(arr):
                nrow_loc[base + i] = int(v)
        plane_loc = []
        for p in range(self.nplanes):
            rows = {}
            for sh in ovf[p].addressable_shards:
                base = sh.index[0].start or 0
                dat = np.asarray(sh.data)
                for i in range(dat.shape[0]):
                    rows[base + i] = dat[i]
            plane_loc.append(rows)
        for r, cnt in nrow_loc.items():
            src = r // R0
            if cnt <= 0 or bad[src]:
                continue
            take = min(cnt, OVF_CAP)
            self.stats["captured_windows"] += take
            self._captures.append(
                [plane_loc[p][r][:take].copy()
                 for p in range(self.nplanes)])

    # ------------------------- merge path -----------------------------

    def _merge_staged(self) -> None:
        """Dispatch the merge and DEFER its nmax verification to the
        next merge cadence (or finalize): the replicated-scalar fetch
        then costs one link round trip instead of merge-latency plus
        one, and the owners fold while the host feeds the next steps.
        The deferral is symmetric across processes (every process
        defers the same replicated scalar), so multi-host lockstep is
        preserved; the pre-merge accumulator and staged groups stay
        alive in _unverified until the check clears."""
        self._verify_merge()
        staged = self._staged
        self._staged = []
        if not staged:
            return
        if self._acc is None:
            self._acc = self._fresh_acc(self.La)
        flat = [pl for grp in staged for pl in grp]
        fn = self._get_merge(len(staged), self.La)
        planes, counts, nmax_d = fn(self._acc[0], self._acc[1], *flat)
        self._unverified = (planes, counts, nmax_d, self._acc, staged,
                            self.La)
        self._acc = (planes, counts)  # optimistic: overflow is rare

    def _verify_merge(self) -> None:
        uv = getattr(self, "_unverified", None)
        if uv is None:
            return
        self._unverified = None
        planes, counts, nmax_d, old_acc, staged, la_then = uv
        nmax = int(np.asarray(nmax_d))  # replicated: lockstep-safe
        if nmax <= la_then:
            self._acc_rows_used = nmax
            if nmax * self.rpo >= self.acc_cap:
                # total-entry budget reached: dump now (reference P5)
                self.spill()
            return
        # truncated: re-dispatch with grown rows against the preserved
        # pre-merge accumulator (blocking — overflow is the rare path)
        self._acc = old_acc
        flat = [pl for grp in staged for pl in grp]
        La_out = self.La
        while True:
            need = accum._eighth_round(nmax)
            if need <= self.La_max:
                La_out = need
            elif self._acc_nonempty():
                # past the budget: spill the current accumulator and
                # retry the same staged groups into a fresh one
                self.spill()
                self._acc = self._fresh_acc(self.La0)
                self.La = self.La0
                La_out = min(self.La_max, max(self.La0, need))
            else:
                raise RuntimeError(
                    f"ShardedCounter accumulator overflow: one merge "
                    f"needs {nmax} entries/row x {self.rpo} rows with "
                    f"acc_cap={self.acc_cap}; raise acc_cap")
            fn = self._get_merge(len(staged), La_out)
            planes, counts, nmax_d = fn(self._acc[0], self._acc[1],
                                        *flat)
            nmax = int(np.asarray(nmax_d))
            if nmax <= La_out:
                break
        self._acc = (planes, counts)
        self.La = La_out
        self._acc_rows_used = nmax
        if nmax * self.rpo >= self.acc_cap:
            self.spill()

    def _acc_nonempty(self) -> bool:
        return self._acc is not None and \
            getattr(self, "_acc_rows_used", 0) > 0

    # ------------------------- spill path -----------------------------

    def _download_acc(self):
        """{device d -> (hi, lo, counts)} for addressable devices; each
        run is sorted ascending (rows partition key space in ascending
        order and entries within a row are sorted)."""
        from .. import kmer as km
        planes, counts = self._acc
        crows = {}
        for sh in counts.addressable_shards:
            d = (sh.index[0].start or 0) // self.rpo
            crows[d] = np.asarray(sh.data)
        prows = [dict() for _ in range(self.nplanes)]
        for p in range(self.nplanes):
            for sh in planes[p].addressable_shards:
                d = (sh.index[0].start or 0) // self.rpo
                prows[p][d] = np.asarray(sh.data)
        runs = {}
        for d, cm in crows.items():
            keep = cm > 0
            if not keep.any():
                continue
            pl = [prows[p][d][keep] for p in range(self.nplanes)]
            hi, lo = km.hilo_from_planes(pl)
            runs[d] = (hi, lo, cm[keep].astype(np.uint64))
        return runs

    def spill(self) -> None:
        """Download every local device's accumulated run to host RAM
        (or spill_dir .npz files) and reset the accumulators — the
        out-of-core batch dump."""
        if self._acc is None or not self._acc_nonempty():
            return
        for d, run in self._download_acc().items():
            if len(run[2]):
                self._spills.setdefault(d, []).append(
                    self._store_run(d, run))
        self.stats["spills"] += 1
        self._acc = None
        self._acc_rows_used = 0
        self.La = self.La0
        self._spill_seq += 1

    def _store_run(self, d: int, run):
        if self.spill_dir is None:
            return run
        os.makedirs(self.spill_dir, exist_ok=True)
        p = os.path.join(self.spill_dir,
                         f"spill_r{d}_s{self._spill_seq}.npz")
        np.savez(p, hi=run[0], lo=run[1], c=run[2])
        return p

    @staticmethod
    def _load_run(run):
        if not isinstance(run, str):
            return run
        z = np.load(run)
        return z["hi"], z["lo"], z["c"]

    # ------------------------ finalize path ---------------------------

    def _extras_run(self):
        """All host-side extras of THIS process as one sorted unique
        (hi, lo, counts) run: captured cell-overflow windows (count 1
        each) union-merged with the recounted chunks."""
        from .. import kmer as km
        from ..counter import merge_runs
        runs = list(self._fallback_runs)
        self._fallback_runs = []
        if self._captures:
            planes = [np.concatenate([c[p] for c in self._captures])
                      for p in range(self.nplanes)]
            self._captures = []
            # defense in depth (against phantom sentinel kmers): the
            # capture region holds real keys only by construction, and
            # the all-ones kmer is excluded at extraction — an
            # all-sentinel entry here can only be padding
            real = ~np.logical_and.reduce(
                [p == 0xFFFFFFFF for p in planes])
            planes = [p[real] for p in planes]
            hi, lo = km.hilo_from_planes(planes)
            order = np.lexsort((lo, hi))
            hi, lo = hi[order], lo[order]
            new = np.empty(len(hi), bool)
            new[:1] = True
            np.logical_or(hi[1:] != hi[:-1], lo[1:] != lo[:-1],
                          out=new[1:])
            st = np.flatnonzero(new)
            cnt = np.diff(np.append(st, len(hi))).astype(np.uint64)
            runs.append((hi[st], lo[st], cnt))
        if not runs:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.uint64)
        hi, lo, c = merge_runs(runs)
        return hi, lo, c.astype(np.uint64)

    def _exchange_extras(self, hi, lo, c):
        """Multi-host: allgather every process's extras (two fixed-
        shape collectives) so each process can keep the entries its
        own devices own.  Extras are hatch tails — thin by
        construction."""
        import jax as _jax
        if _jax.process_count() <= 1:
            return hi, lo, c
        from jax.experimental import multihost_utils as mh
        lens = np.asarray(mh.process_allgather(
            np.array([len(c)], np.int64))).reshape(-1)
        mx = int(lens.max())
        if mx == 0:
            return hi, lo, c
        pad = mx - len(c)
        buf = np.stack([
            np.pad(np.asarray(hi, np.uint64), (0, pad)),
            np.pad(np.asarray(lo, np.uint64), (0, pad)),
            np.pad(np.asarray(c, np.uint64), (0, pad))])
        allb = np.asarray(mh.process_allgather(buf))  # (nproc, 3, mx)
        his, los, cs = [], [], []
        for pidx in range(allb.shape[0]):
            ln = int(lens[pidx])
            his.append(allb[pidx, 0, :ln])
            los.append(allb[pidx, 1, :ln])
            cs.append(allb[pidx, 2, :ln])
        return (np.concatenate(his), np.concatenate(los),
                np.concatenate(cs))

    def iter_finalized_parts(self):
        """Yield (device row, hi, lo, counts) for the process-local
        devices, ascending; spilled runs, the live accumulator and the
        hatch extras are union-sum merged per owner.  A GENERATOR so
        callers can stream owner ranges into a DB writer one device at
        a time — with spill_dir, host peak is one device's merged
        range, never the whole kmer set."""
        from ..counter import merge_runs
        if getattr(self, "_finalized", False):
            raise RuntimeError(
                "ShardedCounter already finalized: finalize()/"
                "finalize_parts()/iter_finalized_parts() consume the "
                "accumulator and may be called only once")
        self._finalized = True
        self._resolve_pending()
        if self._staged:
            self._merge_staged()
        self._verify_merge()
        LAST_SHARD_STATS.clear()
        LAST_SHARD_STATS.update(self.stats)
        acc_runs = {}
        if self._acc_nonempty():
            acc_runs = self._download_acc()
        self._acc = None

        # extras: process-local hatch output, exchanged in multi-host
        # jobs, then split by owner with the SAME integer map the
        # device routed with
        ehi, elo, ec = self._exchange_extras(*self._extras_run())
        extra_by_owner = {}
        if len(ec):
            own = owner_of_keys(ehi, elo, self.k, self.bits, self.B,
                                self.rpo, self.mode == "canonical")
            for d in np.unique(own):
                m = own == d
                extra_by_owner[int(d)] = (ehi[m], elo[m],
                                          ec[m].astype(np.uint64))

        # the all-ones kmer (excluded on device) belongs to the top of
        # key space = the last owner; counted by replicated scalars so
        # every process agrees, appended only by the owner's process
        local_devs = self._local_device_rows()
        if self._n_allones and (self.n - 1) in local_devs:
            twok = 2 * self.k
            ao = (np.array([(1 << max(0, twok - 64)) - 1], np.uint64),
                  np.array([(1 << min(64, twok)) - 1], np.uint64),
                  np.array([self._n_allones], np.uint64))
            prev = extra_by_owner.get(self.n - 1)
            extra_by_owner[self.n - 1] = ao if prev is None else (
                np.concatenate([prev[0], ao[0]]),
                np.concatenate([prev[1], ao[1]]),
                np.concatenate([prev[2], ao[2]]))

        rows = sorted(set(self._spills) | set(acc_runs)
                      | (set(extra_by_owner) & local_devs))
        for d in rows:
            runs = [self._load_run(r) for r in self._spills.get(d, [])]
            if d in acc_runs:
                runs.append(acc_runs.pop(d))
            if d in extra_by_owner and d in local_devs:
                runs.append(extra_by_owner.pop(d))
            hi, lo, c = merge_runs(runs)
            yield (d, hi, lo, c)

    def _local_device_rows(self) -> set:
        """Global device positions addressable by this process."""
        devs = set()
        mesh_devs = list(self.mesh.devices.reshape(-1))
        import jax as _jax
        pid = _jax.process_index()
        for i, dv in enumerate(mesh_devs):
            if dv.process_index == pid:
                devs.add(i)
        return devs

    def finalize_parts(self):
        """-> [(device row, hi, lo, counts)], materialized (see
        iter_finalized_parts for the streaming form)."""
        return list(self.iter_finalized_parts())

    def finalize(self):
        """-> (hi, lo, counts) numpy arrays, globally sorted unique
        (single-process meshes; multi-host assembly uses
        finalize_parts).  Owner key ranges ascend with device id, so
        per-device results concatenate in order.  Value histogram /
        statistics should be computed from these final counts (e.g. by
        MerylDB.write), never from per-step partials."""
        parts = self.finalize_parts()
        if not parts:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.uint32)
        return (np.concatenate([p[1] for p in parts]),
                np.concatenate([p[2] for p in parts]),
                np.concatenate([p[3] for p in parts]).astype(np.uint32))


def demo_codes(n_dev: int, chunk_len: int, seed: int = 7):
    """Deterministic synthetic base codes for dryruns/benches."""
    key = jax.random.PRNGKey(seed)
    return jax.random.randint(key, (n_dev * chunk_len,), 0, 4, jnp.uint8)
