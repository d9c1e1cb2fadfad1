"""Multi-process launcher: run the meryl CLI as one jax.distributed
job of N processes on this machine (or one rank of a multi-machine
job).

    python -m meryl_tpu.parallel.launch --nprocs 2 --devices-per-proc 4 \
        -- count k=21 reads.fa output out.meryldb

Every process executes the same CLI argv; `count` detects the
distributed job and routes through the multi-host SPMD path
(meryl_tpu/parallel/multihost.py).  On a multi-machine cluster each
host runs its own rank with MERYL_TPU_COORD pointing at rank 0 (this
launcher is the single-machine convenience wrapper; set the env vars
directly for real clusters).

On a GPU machine each process gets its own cards: a disjoint
CUDA_VISIBLE_DEVICES slice of --devices-per-proc cards (default: the
visible cards split evenly), so no two processes open the same card.
With JAX_PLATFORMS=cpu, --devices-per-proc is the number of virtual CPU
devices per process instead.

The reference has no such mode — its distributed story is manual
`segment=a/b` jobs plus a DB merge (merylCommandBuilder.C:313-315).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def visible_gpus(env) -> list[str]:
    """Card ids this launcher may hand out; [] on a CPU run or a
    machine without NVIDIA cards.  Never initializes JAX (the parent
    must not open a card its children need)."""
    plat = env.get("JAX_PLATFORMS", "").lower()
    if plat and not any(p in plat for p in ("cuda", "gpu")):
        return []
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [v.strip() for v in vis.split(",") if v.strip()]
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    n = sum(1 for line in r.stdout.splitlines() if line.startswith("GPU "))
    return [str(i) for i in range(n)]


def gpu_slices(gpus: list[str], nprocs: int,
               dev_per_proc: int | None) -> list[str]:
    """Disjoint CUDA_VISIBLE_DEVICES value for each process."""
    per = dev_per_proc or len(gpus) // nprocs
    if per < 1 or per * nprocs > len(gpus):
        raise ValueError(f"{nprocs} processes x {per} cards need "
                         f"{nprocs * max(per, 1)} cards, "
                         f"{len(gpus)} visible")
    return [",".join(gpus[i * per:(i + 1) * per]) for i in range(nprocs)]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    nprocs = 2
    dev_per_proc = None
    while argv and argv[0].startswith("--"):
        if argv[0] == "--nprocs":
            nprocs = int(argv[1])
            argv = argv[2:]
        elif argv[0] == "--devices-per-proc":
            dev_per_proc = int(argv[1])
            argv = argv[2:]
        elif argv[0] == "--":
            argv = argv[1:]
            break
        else:
            sys.stderr.write(f"unknown flag {argv[0]}\n")
            return 2
    if not argv:
        sys.stderr.write(__doc__)
        return 2

    gpus = visible_gpus(os.environ)
    try:
        slices = gpu_slices(gpus, nprocs, dev_per_proc) if gpus else None
    except ValueError as e:
        sys.stderr.write(f"{e}\n")
        return 2
    port = free_port()
    procs = []
    for pid in range(nprocs):
        env = dict(os.environ)
        env["MERYL_TPU_COORD"] = f"127.0.0.1:{port}"
        env["MERYL_TPU_NPROCS"] = str(nprocs)
        env["MERYL_TPU_PROCID"] = str(pid)
        if slices:
            env["CUDA_VISIBLE_DEVICES"] = slices[pid]
        elif dev_per_proc:
            env["MERYL_TPU_LOCAL_DEVICES"] = str(dev_per_proc)
            # an inherited --xla_force_host_platform_device_count (e.g.
            # from a test harness) would override the per-process device
            # count and wedge the distributed topology — strip it
            flags = [f for f in env.get("XLA_FLAGS", "").split()
                     if "xla_force_host_platform_device_count" not in f]
            env["XLA_FLAGS"] = " ".join(flags)
        out = None if pid == 0 else subprocess.DEVNULL
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "meryl_tpu"] + argv,
            env=env, stdout=out,
            stderr=None if pid == 0 else subprocess.STDOUT))
    rc = 0
    for p in procs:
        rc = p.wait() or rc
    return rc


if __name__ == "__main__":
    sys.exit(main())
