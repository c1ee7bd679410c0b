"""Multi-controller (``jax.distributed``) dryrun: the rank-sharded
window engine across PROCESS boundaries.

`multihost.py` scales out by window partitioning across worker
processes (the reference's manual trim workflow, asgart.rs:433-463,
automated). This module exercises the other multi-host axis — ONE
device mesh spanning several controllers, the deployment shape of a
multi-host accelerator cluster: each process initializes
`jax.distributed`, owns a slice of the global mesh, feeds its own
shards of the rank-sharded
window index (`ShardedWindowEngine`), and the stage-1/stage-2 psum
collectives run across the process boundary. Every process computes
the identical replicated outputs, so each can chain + export
independently; byte-equality of their JSONs (and against the
single-process host engine) is the proof the cross-process psum path
is exact.

Run a worker:   python -m asgart_tpu.distributed PID NPROCS PORT FA OUT \
                        TRIM_START TRIM_END [R] [C]
Run the dryrun: asgart_tpu.distributed.dryrun_two_process()
                (spawns two 4-device CPU workers; returns the JSON)
"""

from __future__ import annotations

import os
import subprocess
import sys


def _worker(pid: int, nprocs: int, port: int, fa: str, out: str,
            ws: int, we: int, reverse: bool, complement: bool) -> None:
    import jax

    from asgart_tpu.compile_cache import configure_compile_cache

    jax.config.update("jax_platforms", "cpu")
    configure_compile_cache()
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs, process_id=pid)

    from asgart_tpu.exporters import JSONExporter
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings

    # rank-sharded single window over the GLOBAL mesh; the host build
    # keeps per-process work deterministic and identical
    os.environ["ASGART_RANK_SHARDED"] = "1"
    os.environ["ASGART_RSH_HOST_BUILD"] = "1"
    settings = RunSettings(min_duplication_length=800, trim=(ws, we),
                           reverse=reverse, complement=complement)
    res = search_duplications([fa], settings, engine="tpu")
    with open(f"{out}.{pid}", "w") as fh:
        JSONExporter().save(res, fh)


def dryrun_two_process(n_local: int = 4, timeout: float = 900.0) -> str:
    """Spawn two `jax.distributed` CPU workers (n_local virtual devices
    each — an 2 x n_local global mesh), run the rank-sharded window
    search across the process boundary, assert both processes' JSONs
    are identical AND byte-equal to the single-process host engine.
    Returns the JSON text."""
    import tempfile

    import numpy as np

    from asgart_tpu.exporters import JSONExporter
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings

    rng = np.random.default_rng(77)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = bytearray(rng.choice(acgt, 70000).tobytes())
    g[40000:43000] = g[6000:9000]          # direct pair inside the trim
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rc = bytes(g[20000:22500]).translate(comp)[::-1]
    g[55000:57500] = rc                    # RC pair (direct run ignores)
    ws, we = 1000, 65000

    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "genome.fa")
        with open(fa, "w") as fh:
            fh.write(">chr1\n" + bytes(g).decode() + "\n")
        out = os.path.join(td, "out.json")

        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        flags = env.get("XLA_FLAGS", "")
        # strip any inherited device-count flag, then pin n_local
        flags = " ".join(f for f in flags.split()
                         if "host_platform_device_count" not in f)
        env["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count="
            f"{n_local}").strip()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "asgart_tpu.distributed",
             str(pid), "2", str(port), fa, out, str(ws), str(we)],
            env=env, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            for pid in range(2)]
        for p in procs:
            rc_ = p.wait(timeout=timeout)
            if rc_ != 0:
                for q in procs:
                    q.kill()
                raise RuntimeError(
                    f"distributed worker exited with {rc_}")
        with open(out + ".0") as fh:
            j0 = fh.read()
        with open(out + ".1") as fh:
            j1 = fh.read()
        assert j0 == j1, "per-process JSONs differ"

        # single-process host oracle
        settings = RunSettings(min_duplication_length=800,
                               trim=(ws, we))
        host = search_duplications([fa], settings, engine="host")
        import io

        buf = io.StringIO()
        JSONExporter().save(host, buf)
        assert j0 == buf.getvalue(), \
            "cross-process JSON != host trim JSON"
    return j0


def main(argv: list[str]) -> None:
    pid, nprocs, port = int(argv[0]), int(argv[1]), int(argv[2])
    fa, out = argv[3], argv[4]
    ws, we = int(argv[5]), int(argv[6])
    reverse = len(argv) > 7 and argv[7] == "1"
    complement = len(argv) > 8 and argv[8] == "1"
    _worker(pid, nprocs, port, fa, out, ws, we, reverse, complement)


if __name__ == "__main__":
    main(sys.argv[1:])
