"""Fused-probe engine (round 5): byte-equality against the host
oracle, the decimation-by-transpose rewrite, routing, and the
tied-overflow fallback.

The fused build (device_index.FusedIndex) co-sorts the direct text's
key rows with the probe-lane keys in ONE flagged sort — the appended
half of the doubled design existed only to be probed, but only every
step-th appended position ever IS a probe. Reference parity target:
the SA + per-probe equal-range search of searcher.rs:99-171 with the
automaton's probe enumeration (automaton.rs:90-102).
"""

import io
import os

import numpy as np
import pytest

from asgart_tpu.exporters import JSONExporter
from asgart_tpu.pipeline import search_duplications
from asgart_tpu.structs import RunSettings

from util import plant_duplication, random_dna, revcomp, write_fasta


def _json(res) -> str:
    buf = io.StringIO()
    JSONExporter().save(res, buf)
    return buf.getvalue()


def _run_pair(fa, settings, monkeypatch):
    host = search_duplications([str(fa)], settings, engine="host")
    monkeypatch.setenv("ASGART_FUSED", "1")
    fused = search_duplications([str(fa)], settings, engine="tpu")
    monkeypatch.delenv("ASGART_FUSED")
    return host, fused


def _assert_fused_used(caplog=None):
    # the fused engine logs nothing special; routing is pinned by
    # test_fused_routing below
    pass


@pytest.mark.parametrize("reverse,complement", [
    (False, False), (True, True), (True, False), (False, True)])
def test_fused_byte_equal_transforms(tmp_path, monkeypatch, reverse,
                                     complement):
    rng = np.random.default_rng(31)
    n = 90000
    tf = {  # plant a duplication matching the searched transform
        (False, False): None,
        (True, True): revcomp,
        (True, False): lambda s: s[::-1],
        (False, True): lambda s: s.translate(
            bytes.maketrans(b"ACGT", b"TGCA")),
    }[(reverse, complement)]
    g = plant_duplication(rng, n, 3000, 10000, 60000, noise=0.01,
                          transform=tf)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=reverse, complement=complement)
    host, fused = _run_pair(fa, s, monkeypatch)
    assert sum(len(f) for f in host.families) >= 1
    assert _json(host) == _json(fused)


def test_fused_byte_equal_chunked_masked(tmp_path, monkeypatch):
    """N-runs split chunks (>5000 N) and in-chunk N probes mask lanes;
    soft-masked lowercase interacts with --skip-masked."""
    rng = np.random.default_rng(32)
    g = bytearray(plant_duplication(rng, 120000, 2500, 5000, 80000,
                                    noise=0.0, transform=revcomp))
    g[30000:36000] = b"N" * 6000       # chunk split
    g[70000:70100] = b"N" * 100        # in-chunk N probes
    low = bytes(g[90000:92000]).lower()
    g[90000:92000] = low               # soft-masked region
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    for skip in (False, True):
        s = RunSettings(reverse=True, complement=True,
                        skip_masked=skip)
        host, fused = _run_pair(fa, s, monkeypatch)
        assert _json(host) == _json(fused)


def test_fused_byte_equal_multifasta(tmp_path, monkeypatch):
    rng = np.random.default_rng(33)
    g1 = plant_duplication(rng, 40000, 2000, 3000, 30000, noise=0.0)
    g2 = bytes(random_dna(rng, 25000))
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chrA", g1), ("chrB", g2)])
    s = RunSettings()
    host, fused = _run_pair(fa, s, monkeypatch)
    assert sum(len(f) for f in host.families) >= 1
    assert _json(host) == _json(fused)


def test_fused_tied_overflow_falls_back(tmp_path, monkeypatch):
    """Hyper-repetitive input past the tied-set bailout: the fused
    engine must fall back to the classic table engine, byte-equal."""
    import asgart_tpu.device_index as di

    rng = np.random.default_rng(34)
    # tiled vocabulary: nearly every position tied (its k-mer recurs
    # ~8x) but per-probe cardinality stays small — past M // 4 even
    # with the 2^16 lane-bucket floor in M, without the pathological
    # single-k-mer blowup that no gather capacity could serve
    vocab = [random_dna(rng, 50) for _ in range(750)]
    tiles = rng.integers(0, len(vocab), 6000)
    g = b"".join(vocab[t] for t in tiles)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    monkeypatch.setattr(di, "FUSED_TIED_BAILOUT_MIN", 64)
    s = RunSettings(reverse=True, complement=True)
    host = search_duplications([str(fa)], s, engine="host")
    monkeypatch.setenv("ASGART_FUSED", "1")
    # the bailout path must actually trigger
    called = {}
    orig = di.FusedIndex.build.__func__

    def spy(cls, *a, **kw):
        try:
            return orig(cls, *a, **kw)
        except di.FusedTiedOverflow:
            called["bailed"] = True
            raise

    monkeypatch.setattr(di.FusedIndex, "build", classmethod(spy))
    prof: dict = {}
    fused = search_duplications([str(fa)], s, engine="tpu", profile=prof)
    assert called.get("bailed")
    assert _json(host) == _json(fused)
    # the bail-out is visible in the run profile
    assert prof["device_engine"] == "FusedEngine->DeviceEngine"


def test_fused_probe_size_boundaries(tmp_path, monkeypatch):
    """k = 8 (single-plane keys, step 4) and k = 20 (the 2-plane max)
    through the fused engine."""
    rng = np.random.default_rng(35)
    g = plant_duplication(rng, 50000, 2000, 4000, 35000, noise=0.0,
                          transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    for k in (8, 20):
        s = RunSettings(reverse=True, complement=True, probe_size=k)
        host, fused = _run_pair(fa, s, monkeypatch)
        assert _json(host) == _json(fused)


def test_fused_routing(tmp_path, monkeypatch):
    """fused gates: env on/off, k <= 30 (3-plane ceiling), HBM fit —
    for both the whole-genome and the trim-window predicates."""
    from asgart_tpu.device_engine import (fused_applicable,
                                          fused_window_applicable)

    s = RunSettings()
    monkeypatch.setenv("ASGART_FUSED", "0")
    assert not fused_applicable(10000, s)
    assert not fused_window_applicable(10000, 5000, s)
    monkeypatch.setenv("ASGART_FUSED", "1")
    assert fused_applicable(10000, s)
    assert fused_window_applicable(10000, 5000, s)
    assert fused_applicable(10000, RunSettings(probe_size=25))
    assert not fused_applicable(10000, RunSettings(probe_size=31))
    assert not fused_window_applicable(
        10000, 5000, RunSettings(probe_size=31))
    monkeypatch.setenv("ASGART_HBM_BYTES", "1000")
    assert not fused_applicable(10000, s)
    assert not fused_window_applicable(10000, 5000, s)


def test_decimate_transpose_equals_sort():
    """`_decimate_codes_t` (blocked transpose) is bit-equal to the
    block-sort `_decimate_codes` for awkward lengths and steps."""
    import asgart_tpu.device_index as di

    rng = np.random.default_rng(36)
    for n, step in [(1, 1), (97, 10), (1000, 10), (12345, 7),
                    (65536, 10), (100003, 12)]:
        L = ((n + 64 + step - 1) // step) * step
        codes = np.asarray(rng.integers(0, 6, n), dtype=np.uint8)
        import jax.numpy as jnp

        c = jnp.asarray(codes)
        a = np.asarray(di._decimate_codes(c, step=step, L=L, n=n))
        b = np.asarray(di._decimate_codes_t(c, step=step, L=L, n=n))
        assert (a == b).all(), (n, step)


def test_fused_trim_window(tmp_path, monkeypatch):
    """Fused build over a --trim window (stage 1 fused into the window
    sort): byte-equal to the host trim engine, incl. a window whose
    right arm falls outside (reference trim semantics)."""
    rng = np.random.default_rng(38)
    g = plant_duplication(rng, 60000, 2500, 4000, 42000, noise=0.0,
                          transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    for trim in [(0, 30000), (20000, 59999), (1000, 50000)]:
        s = RunSettings(reverse=True, complement=True, trim=trim)
        host, fused = _run_pair(fa, s, monkeypatch)
        assert _json(host) == _json(fused), trim


@pytest.mark.parametrize("k,shards", [(25, 2), (21, 2), (30, 2)])
def test_fused_wide_k_shards(tmp_path, monkeypatch, k, shards):
    """k = 21..30 under --shards runs on the DEVICE via the fused
    window engine (3-plane co-sort) — the reference searches any k on
    its one engine (searcher.rs:145-171); before round 5 these routed
    to the host ByteIndex."""
    rng = np.random.default_rng(39)
    g = plant_duplication(rng, 50000, 2000, 3000, 30000, noise=0.0,
                          transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=True, complement=True, probe_size=k)
    host = search_duplications([str(fa)], s, engine="host",
                               shards=shards)
    monkeypatch.setenv("ASGART_FUSED", "1")
    fused = search_duplications([str(fa)], s, engine="tpu",
                                shards=shards)
    assert _json(host) == _json(fused)


def test_fused_wide_k_whole_genome(tmp_path, monkeypatch):
    """k = 25 whole-genome through the fused engine (3-plane)."""
    rng = np.random.default_rng(40)
    g = plant_duplication(rng, 50000, 2000, 3000, 30000, noise=0.0,
                          transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=True, complement=True, probe_size=25)
    host, fused = _run_pair(fa, s, monkeypatch)
    assert _json(host) == _json(fused)


def test_fused_checkpoint_uses_classic(tmp_path, monkeypatch):
    """checkpoint runs journal per chunk — they keep the classic
    engines (the fused build is keyed by the whole chunk set) and stay
    byte-equal."""
    rng = np.random.default_rng(37)
    g = plant_duplication(rng, 40000, 2000, 3000, 30000, noise=0.0,
                          transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", g)])
    s = RunSettings(reverse=True, complement=True)
    host = search_duplications([str(fa)], s, engine="host")
    monkeypatch.setenv("ASGART_FUSED", "1")
    ck = tmp_path / "ck.jsonl"
    device = search_duplications([str(fa)], s, engine="tpu",
                                 checkpoint=str(ck))
    assert _json(host) == _json(device)
