"""Multi-host window driver: worker subprocesses per trim window must
reproduce the in-process ``--shards`` run byte-for-byte (the automated,
cross-process form of the reference's --trim + asgart-slice workflow,
/root/reference/src/structs.rs:114-141)."""

import io
import subprocess
import sys

import numpy as np
import pytest

from asgart_tpu.exporters import JSONExporter
from asgart_tpu.multihost import (plan_windows,
                                  search_duplications_multihost,
                                  window_argv)
from asgart_tpu.pipeline import search_duplications
from asgart_tpu.structs import RunResult, RunSettings
from tests.util import random_dna, revcomp, write_fasta

WENV = {"JAX_PLATFORMS": "cpu"}


def _genome(rng, n=30000):
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[3000:4500] = bytes(g[500:2000])            # within window 1
    g[n - 6000:n - 4500] = bytes(g[n // 2 + 1000:n // 2 + 2500])
    # a duplication whose arms land in different windows (split by the
    # window boundary exactly as the reference trim workflow would)
    g[n - 3000:n - 1500] = bytes(g[6000:7500])
    return bytes(g)


def _json_bytes(result) -> str:
    buf = io.StringIO()
    JSONExporter().save(result, buf)
    return buf.getvalue()


def test_plan_windows_matches_sharded_split():
    assert plan_windows(100, 2) == [(0, 50), (50, 100)]
    assert plan_windows(101, 2) == [(0, 51), (51, 101)]
    assert plan_windows(5, 8) == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]


def test_multihost_equals_inprocess_shards(tmp_path):
    rng = np.random.default_rng(90)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", _genome(rng))])
    settings = RunSettings(min_duplication_length=800)

    inproc = search_duplications([str(fa)], settings, shards=2,
                                 engine="host")
    mh = search_duplications_multihost(
        [str(fa)], settings, shards=2, hosts=2, engine="host", env=WENV)
    assert _json_bytes(mh) == _json_bytes(inproc)
    assert mh.families


@pytest.mark.soak
def test_multihost_rc_three_windows_limited_hosts(tmp_path):
    """3 windows on 2 concurrent 'hosts' (queueing), RC mode."""
    rng = np.random.default_rng(91)
    n = 24000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[18000:19500] = revcomp(bytes(g[2000:3500]))
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=800, reverse=True,
                           complement=True)

    inproc = search_duplications([str(fa)], settings, shards=3,
                                 engine="host")
    mh = search_duplications_multihost(
        [str(fa)], settings, shards=3, hosts=2, engine="host", env=WENV)
    assert _json_bytes(mh) == _json_bytes(inproc)


def test_multihost_worker_failure_propagates(tmp_path):
    fa = tmp_path / "missing_dir" / "nope.fa"
    with pytest.raises((RuntimeError, OSError)):
        search_duplications_multihost(
            [str(fa)], RunSettings(), shards=2, hosts=2,
            engine="host", env=WENV)


def test_window_argv_is_a_plain_cli_command(tmp_path):
    """The worker command is a standalone `asgart` invocation — the
    per-host command a pod scheduler would dispatch. Run ONE of them
    manually and check the partial result loads."""
    rng = np.random.default_rng(92)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", _genome(rng, 20000))])
    settings = RunSettings(min_duplication_length=800)
    out = tmp_path / "part0.json"
    argv = window_argv([str(fa)], settings, (0, 10000), str(out),
                       engine="host")
    assert argv[1:3] == ["-m", "asgart_tpu.cli.main"]
    import os

    env = dict(os.environ)
    env.update(WENV)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    cp = subprocess.run(argv, env=env, capture_output=True)
    assert cp.returncode == 0, cp.stderr.decode()
    part = RunResult.from_file(str(out))
    assert part.settings.trim == (0, 10000)


def test_device_workers_one_per_card(tmp_path, monkeypatch):
    """Local device workers: at most one per visible GPU at a time, each
    given its own card through CUDA_VISIBLE_DEVICES."""
    import asgart_tpu.multihost as mh

    state = {"running": 0, "peak": 0, "live": set()}
    seen = []

    class FakeProc:
        def __init__(self, argv, env, stdout, stderr):
            card = env["CUDA_VISIBLE_DEVICES"]
            assert card not in state["live"], "two workers on one card"
            state["live"].add(card)
            state["running"] += 1
            state["peak"] = max(state["peak"], state["running"])
            seen.append(card)
            self.card, self.polls, self.returncode = card, 0, None
            self.stderr = io.BytesIO()

        def poll(self):
            self.polls += 1
            if self.returncode is None and self.polls > 2:
                self.returncode = 0
                state["running"] -= 1
                state["live"].discard(self.card)
            return self.returncode

        def wait(self):
            while self.poll() is None:
                pass

        def kill(self):
            pass

    monkeypatch.setattr(mh.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(mh, "merge_partials", lambda parts, s: parts)
    rng = np.random.default_rng(93)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", _genome(rng, 20000))])
    parts = search_duplications_multihost(
        [str(fa)], RunSettings(), shards=5, hosts=4, engine="tpu",
        env={"JAX_PLATFORMS": "cuda", "CUDA_VISIBLE_DEVICES": "3,5"})
    assert len(parts) == 5 and len(seen) == 5
    assert state["peak"] == 2          # capped at the card count
    assert set(seen) == {"3", "5"}

    # the host engine (or the CPU platform) takes no card
    assert mh.worker_cards("host", {}) is None
    assert mh.worker_cards("tpu", {"JAX_PLATFORMS": "cpu"}) is None
    assert mh.worker_cards("tpu", {"CUDA_VISIBLE_DEVICES": "0,1"}) \
        == ["0", "1"]


def test_two_process_jax_distributed():
    """Multi-controller axis: two `jax.distributed` CPU processes, one
    global mesh spanning both, the rank-sharded window's psum
    collectives crossing the process boundary — both processes' JSONs
    identical and byte-equal to the single-process host trim engine
    (asserted inside the helper)."""
    from asgart_tpu.distributed import dryrun_two_process

    j = dryrun_two_process()
    assert '"sd"' in j or len(j) > 100
