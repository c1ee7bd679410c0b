"""Windowed (``--trim``) device engine vs the host trim path: full-pipeline
output equality on the CPU backend (reference trim semantics,
asgart.rs:142-148: SA over the window only, whole genome probed)."""

import dataclasses
import json

import numpy as np
import pytest

from asgart_tpu.pipeline import search_duplications
from asgart_tpu.structs import RunSettings
from tests.util import plant_duplication, random_dna, revcomp, write_fasta


def run_both(tmp_path, text_body: bytes, settings_kw: dict):
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", text_body)])
    host = search_duplications([str(fa)], RunSettings(**settings_kw),
                               engine="host")
    device = search_duplications([str(fa)], RunSettings(**settings_kw),
                                 engine="tpu")
    return host, device


def assert_results_equal(host, device):
    h = [[vars(sd) for sd in fam] for fam in host.families]
    t = [[vars(sd) for sd in fam] for fam in device.families]
    assert json.dumps(t, sort_keys=True) == json.dumps(h, sort_keys=True)


def test_window_engine_direct(tmp_path):
    """Copies into / out of / across the window boundary; only pairs
    whose right arm lies in the window are found (trim semantics)."""
    rng = np.random.default_rng(10)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[12000:14000] = bytes(g[2000:4000])     # right arm inside window
    g[30000:32000] = bytes(g[5000:7000])     # right arm outside window
    g[19000:21000] = bytes(g[8000:10000])    # right arm straddles edge
    host, device = run_both(tmp_path, bytes(g),
                            dict(trim=(10000, 20000),
                              min_duplication_length=800))
    assert_results_equal(host, device)
    assert host.families, "expected in-window duplications"


def test_window_engine_rc(tmp_path):
    rng = np.random.default_rng(11)
    g = bytearray(random_dna(rng, 30000, b"ACGT"))
    g[15000:17000] = revcomp(bytes(g[3000:5000]))
    host, device = run_both(
        tmp_path, bytes(g),
        dict(trim=(12000, 26000), reverse=True, complement=True,
             min_duplication_length=800))
    assert_results_equal(host, device)
    assert host.families


@pytest.mark.soak
def test_window_engine_multi_chunk(tmp_path):
    """N-run chunk splits with a trim window: probes stay chunk-local,
    the window index serves every chunk."""
    rng = np.random.default_rng(12)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[6000:7500] = bytes(g[1000:2500])
    g[16000:22000] = b"N" * 6000
    g[30000:31500] = bytes(g[25000:26500])
    host, device = run_both(tmp_path, bytes(g),
                            dict(trim=(0, 35000),
                              min_duplication_length=700))
    assert_results_equal(host, device)
    assert sum(len(f) for f in host.families) >= 2


@pytest.mark.parametrize("trial", range(4))
@pytest.mark.soak
def test_window_engine_fuzz(tmp_path, trial):
    rng = np.random.default_rng(200 + trial)
    k = int(rng.choice([10, 14, 20]))
    reverse = bool(rng.integers(0, 2))
    n = int(rng.integers(9000, 18000))
    ws = int(rng.integers(0, n // 3))
    we = int(rng.integers(ws + 2000, n))
    kw = dict(
        probe_size=k,
        max_gap_size=int(rng.integers(k + 5, 120)),
        min_duplication_length=int(rng.integers(150, 500)),
        max_cardinality=int(rng.integers(10, 120)),
        reverse=reverse, complement=reverse,
        trim=(ws, we))
    g = bytearray(random_dna(rng, n, b"ACGT" if trial % 2 else b"ACG"))
    for _ in range(int(rng.integers(1, 4))):
        L = int(rng.integers(300, 900))
        src = int(rng.integers(0, n // 2 - L))
        dst = int(rng.integers(n // 2, n - L))
        seg = bytes(g[src:src + L])
        if reverse:
            seg = revcomp(seg)
        g[dst:dst + L] = seg
    host, device = run_both(tmp_path, bytes(g), kw)
    assert_results_equal(host, device)


@pytest.mark.soak
def test_window_engine_repeat_heavy(tmp_path):
    """Cardinality skips must agree when many matches land in the
    window."""
    rng = np.random.default_rng(13)
    n = 24000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    alu = random_dna(rng, 250, b"ACGT")
    for i in range(30):
        p = 200 + i * 700
        g[p:p + 250] = alu
    g[n - 2500:n - 500] = bytes(g[400:2400])
    host, device = run_both(
        tmp_path, bytes(g),
        dict(trim=(0, 22000), max_cardinality=15,
             min_duplication_length=500))
    assert_results_equal(host, device)


@pytest.mark.soak
def test_window_engine_tiny_window(tmp_path):
    """A window smaller than min_duplication_length still runs (and
    finds nothing or short right arms, identically to the host)."""
    rng = np.random.default_rng(14)
    text = plant_duplication(rng, 16000, 1500, 2000, 9000)
    host, device = run_both(tmp_path, text,
                            dict(trim=(100, 700)))
    assert_results_equal(host, device)


def test_shards_tpu_engine_byte_equal(tmp_path):
    """--shards with engine=device: byte-equal JSON vs engine=host."""
    import io

    from asgart_tpu.exporters import JSONExporter

    rng = np.random.default_rng(15)
    g = bytearray(random_dna(rng, 36000, b"ACGT"))
    g[20000:22500] = bytes(g[2000:4500])     # straddles the 18000 line
    g[30000:31500] = bytes(g[8000:9500])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=800)
    host = search_duplications([str(fa)], settings, engine="host",
                               shards=2)
    device = search_duplications(
        [str(fa)], dataclasses.replace(settings), engine="tpu", shards=2)
    bh, bt = io.StringIO(), io.StringIO()
    JSONExporter().save(host, bh)
    JSONExporter().save(device, bt)
    assert bt.getvalue() == bh.getvalue()
    assert host.families


def test_window_index_matches_host_index():
    """DeviceWindowIndex suffix order + by-value ranges vs the host
    GenomeIndex on a fuzzed repeat-dense genome."""
    import jax.numpy as jnp

    from asgart_tpu.device_engine import _bucket, _window_ranges
    from asgart_tpu.device_index import DeviceWindowIndex
    from asgart_tpu.index import CODE, GenomeIndex
    from asgart_tpu.pipeline import (_pack_probe_kmers, probe_positions,
                                     transform_needle)

    rng = np.random.default_rng(16)
    n, k = 6000, 12
    g = bytearray(random_dna(rng, n, b"ACG"))
    g[3000:3800] = bytes(g[500:1300])
    data = np.concatenate([np.frombuffer(bytes(g), np.uint8),
                           np.frombuffer(b"$", np.uint8)])
    for (ws, we) in [(0, n), (1000, 4000), (2500, 2600)]:
        gidx = GenomeIndex.build(data, k, trim=(ws, we))
        widx = DeviceWindowIndex.build(data, k, trim=(ws, we))
        np.testing.assert_array_equal(
            np.asarray(widx.sa[:widx.W]), gidx.sa)

        needle = transform_needle(data[:-1], False, False)
        is_ = probe_positions(needle, k)
        codes = np.zeros(len(needle) + k, dtype=np.uint8)
        codes[:len(needle)] = CODE[needle]
        pk = _pack_probe_kmers(codes, is_, k)
        lo_h, hi_h = gidx.lookup(pk)

        b_pad = _bucket(len(is_), lo=1 << 8)
        lo_d, hi_d, mask, total = _window_ranges(
            widx.key_hi, widx.key_lo, widx.codes,
            jnp.int32(0), jnp.int32(len(needle)),
            jnp.int32(widx.first_len), jnp.int32(0),
            k=k, reverse=False, complement=False, b_pad=b_pad)
        lo_d = np.asarray(lo_d)[:len(is_)]
        hi_d = np.asarray(hi_d)[:len(is_)]
        np.testing.assert_array_equal(lo_d, lo_h)
        np.testing.assert_array_equal(hi_d, hi_h)
        assert int(float(total)) == int(np.sum(hi_h - lo_h))


# ---- big-genome window mode (window-relative engine, forced at small
# scale via ASGART_BIG_WINDOW; the real trigger is doubled text >= 2^31,
# untestable in-image) --------------------------------------------------

def test_big_window_engine_selected(tmp_path, monkeypatch):
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    from asgart_tpu.device_engine import BigWindowEngine
    from asgart_tpu.fasta import prepare_data
    from asgart_tpu.pipeline import _DeviceEngineAdapter

    rng = np.random.default_rng(40)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", random_dna(rng, 5000, b"ACGT"))])
    _, _, strand = prepare_data([str(fa)], False, None)
    ad = _DeviceEngineAdapter(strand, RunSettings(), trim=(0, 4000))
    assert isinstance(ad.dev, BigWindowEngine)


def test_big_window_direct(tmp_path, monkeypatch):
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    rng = np.random.default_rng(41)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[12000:14000] = bytes(g[2000:4000])
    g[30000:32000] = bytes(g[5000:7000])
    g[19000:21000] = bytes(g[8000:10000])
    host, device = run_both(tmp_path, bytes(g),
                            dict(trim=(10000, 20000),
                              min_duplication_length=800))
    assert_results_equal(host, device)
    assert host.families


def test_big_window_rc(tmp_path, monkeypatch):
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    rng = np.random.default_rng(42)
    g = bytearray(random_dna(rng, 30000, b"ACGT"))
    g[15000:17000] = revcomp(bytes(g[3000:5000]))
    host, device = run_both(
        tmp_path, bytes(g),
        dict(trim=(12000, 26000), reverse=True, complement=True,
             min_duplication_length=800))
    assert_results_equal(host, device)
    assert host.families


@pytest.mark.soak
def test_big_window_multi_chunk_and_repeats(tmp_path, monkeypatch):
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    rng = np.random.default_rng(43)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    alu = random_dna(rng, 250, b"ACGT")
    for i in range(12):
        g[10000 + i * 400: 10000 + i * 400 + 250] = alu
    g[6000:7500] = bytes(g[1000:2500])
    g[16000:22000] = b"N" * 6000
    g[30000:31500] = bytes(g[25000:26500])
    host, device = run_both(tmp_path, bytes(g),
                            dict(trim=(0, 35000), max_cardinality=15,
                              min_duplication_length=700))
    assert_results_equal(host, device)
    assert sum(len(f) for f in host.families) >= 2


@pytest.mark.parametrize("trial", range(4))
@pytest.mark.soak
def test_big_window_fuzz(tmp_path, trial, monkeypatch):
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    rng = np.random.default_rng(900 + trial)
    k = int(rng.choice([10, 14, 20]))
    reverse = bool(rng.integers(0, 2))
    n = int(rng.integers(9000, 18000))
    ws = int(rng.integers(0, n // 3))
    we = int(rng.integers(ws + 2000, n))
    kw = dict(
        probe_size=k,
        max_gap_size=int(rng.integers(k + 5, 120)),
        min_duplication_length=int(rng.integers(150, 500)),
        max_cardinality=int(rng.integers(10, 120)),
        reverse=reverse, complement=reverse,
        trim=(ws, we))
    g = bytearray(random_dna(rng, n, b"ACGT" if trial % 2 else b"ACG"))
    for _ in range(int(rng.integers(1, 4))):
        L = int(rng.integers(300, 900))
        src = int(rng.integers(0, n // 2 - L))
        dst = int(rng.integers(n // 2, n - L))
        seg = bytes(g[src:src + L])
        if reverse:
            seg = revcomp(seg)
        g[dst:dst + L] = seg
    host, device = run_both(tmp_path, bytes(g), kw)
    assert_results_equal(host, device)


@pytest.mark.soak
def test_big_window_shards_byte_equal(tmp_path, monkeypatch):
    """--shards engine=device in forced big mode (the whole-human-genome
    shape: every window a BigWindowEngine): byte-equal JSON vs host."""
    import io

    from asgart_tpu.exporters import JSONExporter

    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    rng = np.random.default_rng(44)
    g = bytearray(random_dna(rng, 36000, b"ACGT"))
    g[20000:22500] = revcomp(bytes(g[2000:4500]))
    g[30000:31500] = bytes(g[8000:9500])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=800, reverse=True,
                           complement=True)
    host = search_duplications([str(fa)], settings, engine="host",
                               shards=3)
    device = search_duplications(
        [str(fa)], dataclasses.replace(settings), engine="tpu", shards=3)
    bh, bt = io.StringIO(), io.StringIO()
    JSONExporter().save(host, bh)
    JSONExporter().save(device, bt)
    assert bt.getvalue() == bh.getvalue()
    assert host.families


@pytest.mark.soak
def test_one_window_many_chunks_batch(tmp_path, monkeypatch):
    """Chunk-heavy genome (many N-run splits) through the one-window
    engine: the batched stage-1 (`_window_ranges_batch`) must reproduce
    the host engine byte-for-byte across 6+ chunks."""
    import io

    import numpy as np

    from asgart_tpu.exporters import JSONExporter
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings
    from tests.util import random_dna, revcomp, write_fasta

    rng = np.random.default_rng(91)
    g = bytearray(random_dna(rng, 120000, b"ACGT"))
    # duplications in distinct chunks, one RC pair, one cross-chunk pair
    g[30000:32000] = bytes(g[4000:6000])
    g[76000:77500] = bytes(g[50000:51500])
    # NB: mid-chunk source — a source at an exact chunk start sits at
    # the reversed needle's END, and the reference discards arms still
    # alive at end-of-needle (automaton.rs; oracle docstring)
    g[110000:112000] = revcomp(bytes(g[24000:26000]))
    for nstart in (15000, 40000, 60000, 85000, 100000):
        g[nstart:nstart + 6000] = b"N" * 6000
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    for kw in ({}, dict(reverse=True, complement=True)):
        settings = RunSettings(min_duplication_length=800, **kw)
        host = search_duplications([str(fa)], settings, engine="host")
        # force the one-window strategy (table engine would fit)
        monkeypatch.setenv("ASGART_HBM_BYTES",
                           str(120002 * 50))
        device = search_duplications([str(fa)], settings, engine="tpu")
        monkeypatch.delenv("ASGART_HBM_BYTES")
        bh, bt = io.StringIO(), io.StringIO()
        JSONExporter().save(host, bh)
        JSONExporter().save(device, bt)
        assert bt.getvalue() == bh.getvalue(), kw
    assert host.families


@pytest.mark.soak
def test_big_window_chunk_heavy_batched(tmp_path, monkeypatch):
    """6 chunks through the forced big-window engine's batched stage 1
    (one concatenated needle upload + one co-sort + grouped rebased
    cores), split over TWO batches by a tiny batch budget; RC mode."""
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    monkeypatch.setenv("ASGART_BIG_BATCH_BYTES", str(3 * (1 << 20)))
    rng = np.random.default_rng(47)
    g = bytearray(random_dna(rng, 130000, b"ACGT"))
    g[30000:31500] = revcomp(bytes(g[4000:5500]))
    g[100000:101800] = revcomp(bytes(g[60000:61800]))
    g[125000:126200] = bytes(g[90000:91200])
    for p in (12000, 50000, 70000, 110000, 118000):
        g[p:p + 6000] = b"N" * 6000
    host, device = run_both(
        tmp_path, bytes(g),
        dict(reverse=True, complement=True, trim=(0, 128000),
             min_duplication_length=700))
    assert_results_equal(host, device)
    assert host.families


def _satellite_genome(rng, n=40000):
    g = bytearray(random_dna(rng, n, b"ACGT"))
    unit = random_dna(rng, 40, b"ACGT")
    g[15000:25000] = (unit * 250)[:10000]    # raw-match explosion
    # an RC satellite block too, so the raw explosion also exists for
    # -RC runs (RC probes of a non-palindromic satellite otherwise
    # match nothing — the r2 test only "sliced" in RC because the old
    # 2^16 cap floor exceeded the test budget vacuously)
    g[5000:9000] = revcomp(bytes(g[15000:19000]))
    g[30000:32000] = bytes(g[2000:4000])     # plain duplication
    return bytes(g)


@pytest.mark.soak
def test_window_engine_sliced_dispatch(tmp_path, monkeypatch):
    """Repeat-heavy trim run: stage 2 must slice into bounded windows
    with output identical to the host trim engine."""
    import asgart_tpu.device_engine as de

    monkeypatch.setattr(de, "MIN_CAP", 2048)  # cap floor below
    # the slice budget: pow4 cap buckets start at MIN_CAP, and the
    # conftest test floor (8192) equals the budget, so slicing
    # would never trigger
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", "8192")
    rng = np.random.default_rng(21)
    g = _satellite_genome(rng)
    de._CAP_CACHE.clear()
    host, device = run_both(tmp_path, g,
                            dict(trim=(10000, 35000),
                              min_duplication_length=500))
    assert_results_equal(host, device)
    assert any(v == "sliced" for v in de._CAP_CACHE.values()), \
        "expected the sliced window dispatch to trigger"


@pytest.mark.soak
def test_big_window_sliced_dispatch(tmp_path, monkeypatch):
    """Same for the forced big-genome (window-relative) engine."""
    import asgart_tpu.device_engine as de

    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    monkeypatch.setattr(de, "MIN_CAP", 128)  # cap floor below
    # the slice budget: pow4 cap buckets start at MIN_CAP, and the
    # conftest test floor (8192) equals the budget, so slicing
    # would never trigger (this config's exact totals are smaller
    # than the table-engine flavors', hence the lower budget too)
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", "256")
    rng = np.random.default_rng(22)
    g = _satellite_genome(rng)
    de._CAP_CACHE.clear()
    host, device = run_both(tmp_path, g,
                            dict(trim=(10000, 35000), reverse=True,
                              complement=True,
                              min_duplication_length=500))
    assert_results_equal(host, device)
    assert any(v == "sliced" for v in de._CAP_CACHE.values())


def test_window_stage1_persists_on_cached_index(tmp_path, monkeypatch):
    """Rescan regime (VERDICT r2 #7): a second run over the same genome
    + trim + chunk set must reuse the batched stage-1 merge-join result
    persisted on the HBM-cached window index — zero co-sorts — with
    byte-identical JSON."""
    import io

    import asgart_tpu.device_engine as de
    from asgart_tpu import device_index as di
    from asgart_tpu.exporters import JSONExporter

    rng = np.random.default_rng(83)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[9000:11000] = bytes(g[2000:4000])
    g[20000:26000] = b"N" * 6000          # 2 chunks
    g[32000:33500] = bytes(g[27000:28500])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    kw = dict(min_duplication_length=800, trim=(0, 39000))

    di._DEVICE_INDEX_CACHE.clear()
    r1 = search_duplications([str(fa)], RunSettings(**kw), engine="tpu")

    calls = {"batch": 0}
    orig = de._window_ranges_batch

    def spy(*a, **k):
        calls["batch"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(de, "_window_ranges_batch", spy)
    r2 = search_duplications([str(fa)], RunSettings(**kw), engine="tpu")
    assert calls["batch"] == 0, "rescan must reuse the persisted stage 1"
    b1, b2 = io.StringIO(), io.StringIO()
    JSONExporter().save(r1, b1)
    JSONExporter().save(r2, b2)
    assert b1.getvalue() == b2.getvalue()
    assert r1.families
    di._DEVICE_INDEX_CACHE.clear()


def test_batched_stage1_grouped_joins(tmp_path, monkeypatch):
    """HBM-projected probe-side grouping of the batched stage-1 merge
    join (the 1 Gbp OOM fix): forcing a tiny group width splits chunks
    into (spec, j0) pieces across several donated joins — output must
    stay byte-identical to the single-shot join and the host engine."""
    import io

    from asgart_tpu import device_index as di
    from asgart_tpu.device_engine import _plan_mj_groups
    from asgart_tpu.exporters import JSONExporter

    # piece planner: chunk split across groups, exact coverage
    groups = _plan_mj_groups([(0, 100, 7), (100, 50, 3)], 4)
    assert groups == [[(0, 100, 4, 0)], [(0, 100, 3, 4), (100, 50, 1, 0)],
                      [(100, 50, 2, 1)]]
    assert sum(nc for g in groups for (_, _, nc, _) in g) == 10

    rng = np.random.default_rng(97)
    g = bytearray(random_dna(rng, 90000, b"ACGT"))
    g[30000:32000] = bytes(g[4000:6000])
    g[76000:77500] = revcomp(bytes(g[50000:51500]))
    for nstart in (15000, 40000, 60000):
        g[nstart:nstart + 6000] = b"N" * 6000
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    for kw in ({}, dict(reverse=True, complement=True)):
        settings = RunSettings(min_duplication_length=800,
                               trim=(0, 89000), **kw)
        host = search_duplications([str(fa)], settings, engine="host")
        di._DEVICE_INDEX_CACHE.clear()
        single = search_duplications([str(fa)], settings, engine="tpu")
        # ~1000-lane groups force several joins + intra-chunk pieces
        monkeypatch.setenv("ASGART_MJ_B_MAX", "1000")
        di._DEVICE_INDEX_CACHE.clear()
        grouped = search_duplications([str(fa)], settings, engine="tpu")
        monkeypatch.delenv("ASGART_MJ_B_MAX")
        bh, bs, bg = io.StringIO(), io.StringIO(), io.StringIO()
        JSONExporter().save(host, bh)
        JSONExporter().save(single, bs)
        JSONExporter().save(grouped, bg)
        assert bg.getvalue() == bs.getvalue() == bh.getvalue(), kw
    assert host.families
    di._DEVICE_INDEX_CACHE.clear()


@pytest.mark.parametrize("reverse,complement", [
    (False, False), (True, False), (False, True), (True, True)])
def test_needle_batch_device_bit_equal(reverse, complement):
    """`_needle_batch_device` (on-device needle derivation: code-space
    complement LUT + flipped slices from the resident strand codes)
    reproduces the HOST batch buffer byte-for-byte — including '$'/N
    bytes inside chunks (code-space complement maps every code-0 byte
    to N, exactly CODE[complemented(byte)]), uneven chunk lengths, and
    inter-region zero gaps."""
    import jax.numpy as jnp

    from asgart_tpu.device_engine import _needle_batch_device
    from asgart_tpu.index import CODE
    from asgart_tpu.pipeline import transform_needle

    rng = np.random.default_rng(911)
    strand = rng.choice(np.frombuffer(b"ACGTN$", dtype=np.uint8), 5000,
                        p=[0.24, 0.24, 0.24, 0.24, 0.03, 0.01])
    chunks = [(0, 900), (1200, 537), (2000, 1601), (4000, 999)]
    bases = {}
    off = 0
    for c in chunks:
        bases[c] = off
        off += ((c[1] + 63) // 64 + 4) * 64  # uneven padded regions
    host = np.zeros(off, dtype=np.uint8)
    for c in chunks:
        host[bases[c]: bases[c] + c[1]] = CODE[transform_needle(
            strand[c[0]: c[0] + c[1]], reverse, complement)]
    cap = (max(c[1] for c in chunks) + 7) & ~7
    dev = _needle_batch_device(
        jnp.asarray(CODE[strand]),
        jnp.asarray(np.array([c[0] for c in chunks], np.int32)),
        jnp.asarray(np.array([c[1] for c in chunks], np.int32)),
        jnp.asarray(np.array([bases[c] for c in chunks], np.int32)),
        off, cap, reverse, complement)
    assert np.array_equal(np.asarray(dev), host)


def test_big_window_host_upload_fallback(tmp_path, monkeypatch):
    """ASGART_BIG_DEVCODES=0 (the host-upload path for windows +
    needle batches) stays byte-equal to the device-derivation default."""
    monkeypatch.setenv("ASGART_BIG_WINDOW", "1")
    rng = np.random.default_rng(912)
    g = bytearray(random_dna(rng, 30000, b"ACGT"))
    g[20000:22000] = revcomp(bytes(g[5000:7000]))
    kw = dict(min_duplication_length=800, reverse=True, complement=True)
    host, tpu_dev = run_both(tmp_path, bytes(g), kw)
    assert_results_equal(host, tpu_dev)
    monkeypatch.setenv("ASGART_BIG_DEVCODES", "0")
    host2, tpu_host = run_both(tmp_path, bytes(g), kw)
    assert_results_equal(host2, tpu_host)


def test_needle_batch_device_cap_exceeds_strand():
    """cap (bucketed max chunk length) rounded past n1: the eff-clamped
    slice + zero pad path stays bit-equal to the host buffer."""
    import jax.numpy as jnp

    from asgart_tpu.device_engine import _needle_batch_device
    from asgart_tpu.index import CODE
    from asgart_tpu.pipeline import transform_needle

    rng = np.random.default_rng(913)
    strand = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 999)
    for reverse, complement in ((True, True), (False, False),
                                (True, False)):
        chunks = [(1, 998)]
        off = 1040
        host = np.zeros(off, dtype=np.uint8)
        host[:998] = CODE[transform_needle(strand[1:999], reverse,
                                           complement)]
        cap = (998 + 7) & ~7  # = 1000 > n1 = 999
        assert cap > len(strand)
        dev = _needle_batch_device(
            jnp.asarray(CODE[strand]),
            jnp.asarray(np.array([1], np.int32)),
            jnp.asarray(np.array([998], np.int32)),
            jnp.asarray(np.array([0], np.int32)),
            off, cap, reverse, complement)
        assert np.array_equal(np.asarray(dev), host), (reverse,
                                                       complement)
