"""Multi-host window driver: one ``--trim`` window per PROCESS.

The reference's documented scale-out is manual: run ``asgart --trim a b``
per memory-bounded window, then merge the partial JSONs with
``asgart-slice`` (``/root/reference/src/structs.rs:114-141`` +
README v2.0 notes). ``--shards N`` automates that in-process; this module
automates it ACROSS processes — the multi-host execution form.
Windows need **zero cross-process communication** (families never span
windows, per reference trim semantics), so the "collective" is just the
window-ordered concatenation of partial results, performed once at the
end by the driver. On a cluster each worker command runs on its own
host against its own devices (the driver's subprocess list IS the
per-host command list — dispatch it via your scheduler of choice);
locally it runs the workers as subprocesses, which exercises the
identical code path end to end. Local device workers get one GPU each
(``CUDA_VISIBLE_DEVICES``), at most one worker per visible GPU at a
time: a JAX process reserves most of its card's memory at start-up, so
two on one card would fail. The parent process never imports JAX.

Output is byte-equal to the in-process ``--shards N`` run and to the
sequential trim+merge workflow (pinned by tests/test_multihost.py).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import sys
import tempfile
from typing import Optional

from .structs import RunResult, RunSettings

log = logging.getLogger("asgart")


def plan_windows(total_len: int, shards: int) -> list[tuple[int, int]]:
    """Equal trim windows covering [0, total_len) — the same split as
    the in-process ``--shards`` path (pipeline
    ._search_duplications_sharded)."""
    per = (total_len + shards - 1) // shards
    windows = [(w * per, min(total_len, (w + 1) * per))
               for w in range(shards)]
    return [w for w in windows if w[0] < w[1]]


def window_argv(strands_files: list[str], settings: RunSettings,
                window: tuple[int, int], out_path: str,
                engine: str = "host") -> list[str]:
    """The worker command for one window: a plain ``asgart`` CLI
    invocation (runnable locally, via ssh, or under a cluster
    scheduler)."""
    argv = [sys.executable, "-m", "asgart_tpu.cli.main",
            *strands_files,
            "--trim", str(window[0]), str(window[1]),
            "--probe-size", str(settings.probe_size),
            "--gap-size",
            str(settings.max_gap_size - settings.probe_size),
            "--min-length", str(settings.min_duplication_length),
            "--max-cardinality", str(settings.max_cardinality),
            "--engine", engine,
            "--out", out_path]
    if settings.reverse:
        argv.append("-R")
    if settings.complement:
        argv.append("-C")
    if settings.skip_masked:
        argv.append("-S")
    if settings.compute_score:
        argv.append("--compute-score")
    if settings.threads_count:
        argv += ["--threads", str(settings.threads_count)]
    return argv


def visible_gpus(env: dict) -> list[str]:
    """The GPUs a worker may be given: ``CUDA_VISIBLE_DEVICES`` when the
    environment sets it, else the cards ``nvidia-smi`` lists (none on a
    machine without it). Never imports JAX."""
    vis = env.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return [c.strip() for c in vis.split(",") if c.strip()]
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def worker_cards(engine: str, env: dict) -> Optional[list]:
    """Cards to hand out to device workers, one per concurrent worker,
    or None when workers need no card (host engine, or the CPU platform
    pinned by ``JAX_PLATFORMS``). Where no GPU can be listed, device
    workers run one at a time on whatever device JAX finds
    (``[None]``)."""
    if engine != "tpu" or env.get("JAX_PLATFORMS", "").strip() == "cpu":
        return None
    return visible_gpus(env) or [None]


def merge_partials(part_files: list[str],
                   settings: RunSettings) -> RunResult:
    """Window-ordered merge of partial results — the reference's
    ``asgart-slice`` concat (``RunResult.from_files``), with the run's
    own (untrimmed) settings stamped, exactly like the in-process
    ``--shards`` merge."""
    merged = RunResult.from_files(part_files)
    merged.settings = dataclasses.replace(settings, trim=None)
    return merged


def search_duplications_multihost(
    strands_files: list[str],
    settings: RunSettings,
    shards: int,
    hosts: int,
    engine: str = "host",
    workdir: Optional[str] = None,
    env: Optional[dict] = None,
) -> RunResult:
    """Run ``shards`` trim windows as worker PROCESSES, at most
    ``hosts`` concurrently (one per host in a real deployment), and
    merge their partial JSONs. Device workers (``engine="tpu"`` off
    the CPU platform) also run at most one per visible GPU, each pinned
    to its own card.

    ``env`` entries overlay ``os.environ`` for the workers (tests pin
    ``JAX_PLATFORMS=cpu``)."""
    if settings.trim is not None:
        raise ValueError("multi-host runs cannot be combined with --trim")
    from .fasta import prepare_data

    # parse once to learn the strand length (window planning only; the
    # workers re-read the inputs themselves, as real remote hosts must)
    _, _, strand = prepare_data(strands_files, settings.skip_masked, None)
    total_len = int(len(strand.data)) - 1
    del strand
    windows = plan_windows(total_len, shards)

    own_tmp = None
    if workdir is None:
        own_tmp = tempfile.TemporaryDirectory(prefix="asgart_mh_")
        workdir = own_tmp.name
    try:
        parts = [os.path.join(workdir, f"window_{i:04d}.json")
                 for i in range(len(windows))]
        wenv = dict(os.environ)
        if env:
            wenv.update(env)
        # workers must import this package wherever they start from;
        # PRESERVE any existing PYTHONPATH (site plugins may live there)
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        prev = wenv.get("PYTHONPATH", "")
        wenv["PYTHONPATH"] = (pkg_root + os.pathsep + prev) if prev \
            else pkg_root

        # device workers: one card each, never two on one card
        cards = worker_cards(engine, wenv)
        slots = max(1, hosts) if cards is None \
            else max(1, min(hosts, len(cards)))
        free_cards = list(cards or [])
        card_of: dict = {}

        procs: list = [None] * len(windows)
        pending = list(range(len(windows)))
        running: list[int] = []
        failures: list[str] = []

        def reap(block: bool) -> None:
            for i in list(running):
                p = procs[i]
                if block:
                    p.wait()
                if p.poll() is not None:
                    running.remove(i)
                    if i in card_of:
                        free_cards.append(card_of.pop(i))
                    if p.returncode != 0:
                        err = p.stderr.read().decode(errors="replace")
                        failures.append(
                            f"window {windows[i]} (rc={p.returncode}):\n"
                            + err[-2000:])
                    p.stderr.close()

        import time as _time

        while pending or running:
            while pending and len(running) < slots and not failures:
                i = pending.pop(0)
                argv = window_argv(strands_files, settings, windows[i],
                                   parts[i], engine=engine)
                penv = wenv
                if cards is not None:
                    card_of[i] = free_cards.pop(0)
                    if card_of[i] is not None:
                        penv = dict(wenv, CUDA_VISIBLE_DEVICES=card_of[i])
                log.info("multihost: launching window %s (%d/%d) GPU %s",
                         windows[i], i + 1, len(windows),
                         card_of.get(i))
                procs[i] = subprocess.Popen(
                    argv, env=penv, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE)
                running.append(i)
            if failures:
                for i in running:
                    procs[i].kill()
                reap(block=True)
                break
            reap(block=False)
            if running:
                _time.sleep(0.2)
        if failures:
            raise RuntimeError("multihost window worker(s) failed:\n"
                               + "\n".join(failures))

        return merge_partials(parts, settings)
    finally:
        if own_tmp is not None:
            own_tmp.cleanup()
