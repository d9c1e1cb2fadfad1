"""Multi-host (multi-process) counting: the product path for meshes
that span more than one host.

The reference meryl has no in-process distributed mode — its one
multi-node story is external sharding (`segment=a/b`,
/root/reference/src/meryl/merylCommandBuilder.C:313-315) followed by a
DB `union-sum` merge run by the user.  Here multi-host is first-class:

  * every process joins one `jax.distributed` job (collectives come
    from XLA: NCCL on GPUs, gloo on CPU test meshes),
  * each process reads a disjoint sequence segment of the SAME input
    (the chunker's sequence-modulo split) and feeds shards for its own
    addressable devices,
  * one global `ShardedCounter` SPMD program counts + all-to-alls
    kmers to owner devices (meryl_tpu/parallel/shard_count.py) — its
    control scalars are replicated, so every process can drive the
    spill logic identically,
  * each process writes its owner ranges as a sorted part file;
    process 0 assembles the final 64-bucket DB (exact histogram and
    statistics from the final merged counts).

Lockstep rule: every process must invoke the same jitted programs the
same number of times.  Processes whose input segment is exhausted keep
feeding separator-padded shards until ALL processes are done (the
per-step `_all_done` allgather), so collectives never deadlock.

Environment contract (the launcher sets these):
  MERYL_TPU_COORD    coordinator address host:port
  MERYL_TPU_NPROCS   number of processes
  MERYL_TPU_PROCID   this process id (0-based)
  MERYL_TPU_LOCAL_DEVICES   optional: virtual CPU devices per process
                            (test meshes)
"""

from __future__ import annotations

import json
import os

import numpy as np

PART_DIR_SUFFIX = ".mhparts"


def env_requested() -> bool:
    return "MERYL_TPU_COORD" in os.environ


_initialized = False


def init_from_env() -> tuple[int, int]:
    """Join the jax.distributed job described by MERYL_TPU_* and return
    (process_id, num_processes).  Idempotent.  Must run before anything
    initializes the JAX backend (jax.devices()/process_count()/first
    computation)."""
    global _initialized
    import jax

    coord = os.environ["MERYL_TPU_COORD"]
    nprocs = int(os.environ["MERYL_TPU_NPROCS"])
    pid = int(os.environ["MERYL_TPU_PROCID"])
    ndev = os.environ.get("MERYL_TPU_LOCAL_DEVICES")
    if ndev:  # virtual CPU mesh (tests / dev boxes)
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(ndev))
    if not _initialized and nprocs > 1:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=nprocs, process_id=pid)
        _initialized = True
    return pid, nprocs


def _all_done(local_done: bool) -> bool:
    """True iff every process's input is exhausted (host-level
    allgather — one tiny collective per step)."""
    from jax.experimental import multihost_utils
    flags = multihost_utils.process_allgather(
        np.array([1 if local_done else 0], np.int32))
    return bool(np.asarray(flags).min() >= 1)


def count_to_arrays_multihost(paths, k: int, mode: str = "canonical",
                              hpc: bool = False,
                              chunk_len: int | None = None,
                              progress=None, **shard_kw):
    """Distributed counting over all processes' devices.

    Returns the process-LOCAL owner parts [(row, hi, lo, counts)];
    rows ascend with global device id, and concatenating all
    processes' parts in row order yields the globally sorted unique
    (kmer, count) set.  Use assemble_db() to build the final DB.
    """
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..counter import default_chunk
    from ..io.sequence import SEP, SequenceChunker
    from .shard_count import ShardedCounter

    chunk_len = chunk_len or default_chunk()
    pid, nprocs = jax.process_index(), jax.process_count()
    mesh = Mesh(np.array(jax.devices()), ("d",))
    n = mesh.devices.size
    n_local = jax.local_device_count()
    sharding = NamedSharding(mesh, P("d"))
    global_shape = (n * chunk_len,)

    sc = ShardedCounter(mesh, k, chunk_len=chunk_len, mode=mode, **shard_kw)

    # each process reads its own sequence-modulo segment
    chunker = iter(SequenceChunker(paths, k, chunk_len, hpc=hpc,
                                   segment=(pid + 1, nprocs)))
    pad = np.full(chunk_len, SEP, np.uint8)
    exhausted = False
    nbases = 0
    while True:
        group = []
        for _ in range(n_local):
            chunk = None if exhausted else next(chunker, None)
            if chunk is None:
                exhausted = True
                group.append(pad)
            else:
                nbases += len(chunk)
                group.append(chunk)
        if _all_done(exhausted and all(c is pad for c in group)):
            break
        codes = jax.make_array_from_process_local_data(
            sharding, np.concatenate(group), global_shape)
        sc.add_codes(codes)
        if progress:
            progress(nbases)
    dbg_dir = os.environ.get("MERYL_TPU_MH_DEBUG")
    if dbg_dir:
        # per-process read volume (one tiny file per process — the
        # launcher swallows non-zero ranks' stderr), read by tests to
        # prove the keep-alive (separator-padded shard) path is what
        # kept the collectives in lockstep on uneven input splits
        os.makedirs(dbg_dir, exist_ok=True)
        with open(os.path.join(dbg_dir,
                               f"mh_read_bases_proc{pid}.json"),
                  "w") as f:
            json.dump({"proc": pid, "read_bases": int(nbases)}, f)
    return sc.finalize_parts()


def write_parts(out_path: str, k: int, parts) -> str:
    """Persist this process's owner parts; returns the parts dir.

    Process 0 removes any pre-existing parts dir first (a previous
    interrupted or different-nprocs run would leave stale proc*.json /
    part files that assemble_db would otherwise merge in); all
    processes barrier on that cleanup before writing."""
    import shutil

    import jax
    from jax.experimental import multihost_utils

    pdir = out_path + PART_DIR_SUFFIX
    if jax.process_index() == 0 and os.path.isdir(pdir):
        shutil.rmtree(pdir)
    multihost_utils.sync_global_devices("meryl_mh_parts_clean")
    os.makedirs(pdir, exist_ok=True)
    pid = jax.process_index()
    meta = []
    for row, hi, lo, c in parts:
        fn = os.path.join(pdir, f"part_r{row:05d}.npz")
        np.savez(fn, hi=hi, lo=lo, counts=c.astype(np.uint32))
        meta.append({"row": int(row), "n": int(len(c)), "file": fn})
    with open(os.path.join(pdir, f"proc{pid}.json"), "w") as f:
        json.dump({"k": int(k), "nprocs": jax.process_count(),
                   "parts": meta}, f)
    return pdir


def assemble_db(out_path: str, k: int, *, mode: str = "canonical",
                hpc: bool = False):
    """Process 0: merge all part files (disjoint, globally ordered by
    device row) into the final 64-bucket DB; histogram/statistics from
    the final merged counts.  Other processes: no-op.  All processes
    barrier before and after, and every process returns only after the
    DB is complete on shared storage."""
    import shutil

    import jax
    from jax.experimental import multihost_utils

    from ..db import stream_sorted_parts

    multihost_utils.sync_global_devices("meryl_mh_parts_written")
    # Validate the parts dir on EVERY process (it is on shared storage):
    # raising only on process 0 between the two barriers would leave the
    # other processes hanging at meryl_mh_db_assembled until the
    # distributed-runtime heartbeat timeout, masking the real error.
    pdir = out_path + PART_DIR_SUFFIX
    metas = []
    proc_files = []
    for fn in sorted(os.listdir(pdir)):
        if fn.startswith("proc") and fn.endswith(".json"):
            proc_files.append(fn)
            with open(os.path.join(pdir, fn)) as f:
                j = json.load(f)
            if j.get("nprocs", jax.process_count()) != \
                    jax.process_count():
                raise RuntimeError(
                    f"{pdir}/{fn}: written by a {j['nprocs']}-process "
                    f"run, this job has {jax.process_count()} — stale "
                    f"parts dir, remove it and rerun")
            metas.extend(j["parts"])
    if len(proc_files) != jax.process_count():
        raise RuntimeError(
            f"{pdir}: {len(proc_files)} proc manifests for "
            f"{jax.process_count()} processes — incomplete or stale "
            f"parts dir")
    db = None
    if jax.process_index() == 0:
        metas.sort(key=lambda m: m["row"])

        # stream parts in global order, cutting at 6-bit-file boundaries
        # (an owner range may straddle a file when prefix_bits > 6)
        def load(m):
            z = np.load(m["file"])
            return z["hi"], z["lo"], z["counts"]

        db = stream_sorted_parts(out_path, k, (load(m) for m in metas),
                                 mode=mode, hpc=hpc)
        shutil.rmtree(pdir, ignore_errors=True)
    multihost_utils.sync_global_devices("meryl_mh_db_assembled")
    if db is None:
        from ..db import MerylDB
        db = MerylDB.open(out_path)
    return db


def count_to_db_multihost(paths, out_path: str, k: int,
                          mode: str = "canonical", hpc: bool = False,
                          chunk_len: int | None = None, progress=None,
                          **shard_kw):
    """The full multi-host product path: distributed count -> per-
    process part files -> process-0 DB assembly."""
    parts = count_to_arrays_multihost(paths, k, mode=mode, hpc=hpc,
                                      chunk_len=chunk_len,
                                      progress=progress, **shard_kw)
    write_parts(out_path, k, parts)
    return assemble_db(out_path, k, mode=mode, hpc=hpc)
