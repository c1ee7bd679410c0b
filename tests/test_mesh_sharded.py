"""Composed (windows x probes) mesh engine: the index sharded across
device HBMs, one SPMD dispatch per chunk — byte-equal to the sequential
trim+merge workflow (the reference's manual scale-out,
asgart.rs:142-148 + structs.rs:114-141)."""

import io
import json

import numpy as np
import pytest

from asgart_tpu.exporters import JSONExporter
from asgart_tpu.pipeline import search_duplications
from asgart_tpu.structs import RunSettings
from tests.util import random_dna, revcomp, write_fasta


def json_of(result):
    buf = io.StringIO()
    JSONExporter().save(result, buf)
    return buf.getvalue()


def run_shards(tmp_path, body_frags, settings_kw, shards):
    fa = tmp_path / "g.fa"
    write_fasta(fa, body_frags)
    host = search_duplications([str(fa)], RunSettings(**settings_kw),
                               engine="host", shards=shards)
    device = search_duplications([str(fa)], RunSettings(**settings_kw),
                                 engine="tpu", shards=shards)
    return host, device


def test_mesh_engine_is_used(tmp_path, monkeypatch):
    """shards=2 with 8 devices must route through MeshWindowEngine."""
    import asgart_tpu.device_engine as de

    used = {}
    orig = de.MeshWindowEngine.run_windows

    def spy(self, chunks):
        used["mesh"] = (self.mesh.shape["windows"],
                        self.mesh.shape["probes"])
        return orig(self, chunks)

    monkeypatch.setattr(de.MeshWindowEngine, "run_windows", spy)
    rng = np.random.default_rng(20)
    g = bytearray(random_dna(rng, 20000, b"ACGT"))
    g[12000:13500] = bytes(g[2000:3500])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    r = search_duplications([str(fa)],
                            RunSettings(min_duplication_length=800),
                            engine="tpu", shards=2)
    assert used.get("mesh") == (2, 4)
    assert r.families


@pytest.mark.parametrize("shards", [
    2, pytest.param(4, marks=pytest.mark.soak),
    pytest.param(8, marks=pytest.mark.soak)])
def test_mesh_sharded_byte_equal(tmp_path, shards):
    """Every feasible mesh shape reproduces the sequential workflow's
    bytes, including duplications straddling window boundaries."""
    rng = np.random.default_rng(21)
    n = 48000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    # right arms crossing the 2/4/8-window boundaries (24000, 12000, 6000)
    g[23000:25500] = bytes(g[1000:3500])
    g[11000:13000] = bytes(g[30000:32000])
    g[5000:7000] = bytes(g[40000:42000])
    host, device = run_shards(tmp_path, [("chr1", bytes(g))],
                              dict(min_duplication_length=800), shards)
    assert json_of(device) == json_of(host)
    assert host.families


@pytest.mark.soak
def test_mesh_sharded_rc_multi_fragment(tmp_path):
    """RC mode over two fragments with an N-run chunk split."""
    rng = np.random.default_rng(22)
    f1 = bytearray(random_dna(rng, 30000, b"ACGT"))
    f2 = bytearray(random_dna(rng, 18000, b"ACGT"))
    f2[8000:10000] = revcomp(bytes(f1[4000:6000]))
    f1[14000:20000] = b"N" * 6000
    f1[25000:26500] = revcomp(bytes(f1[1000:2500]))
    host, device = run_shards(
        tmp_path, [("chr1", bytes(f1)), ("chr2", bytes(f2))],
        dict(reverse=True, complement=True, min_duplication_length=800),
        4)
    assert json_of(device) == json_of(host)
    assert host.families


@pytest.mark.soak
def test_mesh_sharded_uneven_last_window(tmp_path):
    """A genome length not divisible by the shard count: the last
    window is shorter and is padded with sentinel keys on device."""
    rng = np.random.default_rng(23)
    n = 19037  # prime-ish; 8 windows of 2380 except a short last
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[17500:18800] = bytes(g[600:1900])   # right arm in the short window
    g[9000:10200] = bytes(g[3000:4200])
    host, device = run_shards(tmp_path, [("chr1", bytes(g))],
                              dict(min_duplication_length=600), 8)
    assert json_of(device) == json_of(host)
    assert host.families


@pytest.mark.soak
def test_mesh_sharded_repeat_heavy(tmp_path):
    """Cardinality skipping across sharded windows (matches of one probe
    spread over several windows must count per window, like separate
    trim runs do)."""
    rng = np.random.default_rng(24)
    n = 32000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    alu = random_dna(rng, 240, b"ACGT")
    for i in range(36):
        p = 200 + i * 850
        g[p:p + 240] = alu
    g[n - 2600:n - 600] = bytes(g[300:2300])
    host, device = run_shards(
        tmp_path, [("chr1", bytes(g))],
        dict(max_cardinality=12, min_duplication_length=500), 4)
    assert json_of(device) == json_of(host)


def test_indivisible_device_count_falls_back(tmp_path):
    """shards=3 with 8 devices cannot form the grid; the per-window
    fallback must still produce identical output."""
    rng = np.random.default_rng(25)
    g = bytearray(random_dna(rng, 21000, b"ACGT"))
    g[15000:16500] = bytes(g[2000:3500])
    host, device = run_shards(tmp_path, [("chr1", bytes(g))],
                              dict(min_duplication_length=800), 3)
    assert json_of(device) == json_of(host)
    assert host.families


@pytest.mark.soak
def test_mesh_batched_stage1_many_chunks(tmp_path):
    """Chunk-heavy mesh run (6 chunks of uneven sizes -> differing
    per-chunk b_local lane origins) through the batched SPMD stage 1:
    byte equality with the sequential trim+merge workflow, direct and
    RC."""
    rng = np.random.default_rng(26)
    n = 150000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[30000:31500] = bytes(g[4000:5500])       # window-straddling pair
    g[100000:101800] = bytes(g[60000:61800])
    g[140000:141200] = revcomp(bytes(g[85000:86200]))
    # uneven N-runs -> chunks of 12k..40k (different probe buckets)
    for p in (12000, 50000, 75000, 110000, 128000):
        g[p:p + 6000] = b"N" * 6000
    for kw in ({}, dict(reverse=True, complement=True)):
        host, device = run_shards(
            tmp_path, [("chr1", bytes(g))],
            dict(min_duplication_length=700, **kw), 2)
        assert json_of(device) == json_of(host), kw
    assert host.families
