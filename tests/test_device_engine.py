"""Device engine (device index + scan + event chain) vs the host
engine: full-pipeline output equality on the CPU backend."""

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


def test_device_engine_direct(tmp_path):
    rng = np.random.default_rng(0)
    text = plant_duplication(rng, 30000, 2000, 5000, 20000, noise=0.01)
    host, device = run_both(tmp_path, text, {})
    assert_results_equal(host, device)
    assert host.families, "nothing found"


def test_device_engine_rc(tmp_path):
    rng = np.random.default_rng(1)
    text = plant_duplication(rng, 24000, 1500, 3000, 15000,
                             transform=revcomp)
    host, device = run_both(tmp_path, text,
                            dict(reverse=True, complement=True))
    assert_results_equal(host, device)
    assert host.families


def test_device_engine_multi_chunk_and_ns(tmp_path):
    """N-runs split chunks; probes and aging must stay chunk-local."""
    rng = np.random.default_rng(2)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[9000:11000] = bytes(g[2000:4000])
    g[20000:26000] = b"N" * 6000          # chunk split (> 5000)
    g[32000:33500] = bytes(g[27000:28500])
    host, device = run_both(tmp_path, bytes(g),
                            dict(min_duplication_length=800))
    assert_results_equal(host, device)
    assert sum(len(f) for f in host.families) >= 2


@pytest.mark.soak
def test_device_engine_repeat_heavy_cardinality(tmp_path):
    """Alu-like scatter: many matches per probe, cardinality skips, and a
    valid medium-cardinality family."""
    rng = np.random.default_rng(3)
    n = 30000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    alu = random_dna(rng, 300, b"ACGT")
    for i in range(40):  # 40 noisy copies -> probes above max_cardinality
        p = 300 + i * 700
        elt = bytearray(alu)
        for _ in range(12):
            elt[int(rng.integers(0, 300))] = int(rng.integers(65, 68))
        g[p:p + 300] = bytes(elt)
    g[n - 3000:n - 1000] = bytes(g[500:2500])
    host, device = run_both(
        tmp_path, bytes(g),
        dict(max_cardinality=20, min_duplication_length=500))
    assert_results_equal(host, device)


@pytest.mark.soak
def test_device_engine_overflow_retry(tmp_path):
    """Forced cap/ev_cap overflow: dispatching with tiny capacities must
    retry-with-doubling in _collect_chunk and still match the host
    engine exactly (drives the compacted-probe CSR path through its
    overflow regime, which the 1M default floor never reaches at test
    sizes)."""
    from asgart_tpu.device_engine import DeviceEngine
    from asgart_tpu.fasta import prepare_data
    from asgart_tpu.pipeline import SearchEngine, raw_families_to_protosds

    rng = np.random.default_rng(9)
    n = 20000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[12000:14500] = bytes(g[1000:3500])   # direct dup
    alu = random_dna(rng, 200, b"ACGT")
    for i in range(25):                    # repeat scatter -> many matches
        g[4000 + i * 230: 4000 + i * 230 + 200] = alu
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=500, max_cardinality=60)
    _, chunks, strand = prepare_data([str(fa)], settings.skip_masked, None)

    host_se = SearchEngine(strand, settings, None, engine="host")
    host_fams = [f for c in chunks for f in host_se.run_chunk(c)]

    dev = DeviceEngine(strand, settings, mesh=False)
    device_fams = []
    for c in chunks:
        st = dev._dispatch_chunk(c, cap=256, ev_cap=8)
        assert st is not None
        device_fams.extend(raw_families_to_protosds(
            dev._collect_chunk(st), settings, c[0], c[1]))
    assert len(device_fams) >= 1
    h = [[vars(sd) for sd in fam] for fam in host_fams]
    t = [[vars(sd) for sd in fam] for fam in device_fams]
    assert json.dumps(t, sort_keys=True) == json.dumps(h, sort_keys=True)


@pytest.mark.parametrize("trial", range(5))
@pytest.mark.soak
def test_device_engine_fuzz(tmp_path, trial):
    rng = np.random.default_rng(100 + trial)
    k = int(rng.choice([10, 14, 20]))
    reverse = bool(rng.integers(0, 2))
    kw = dict(
        probe_size=k,
        max_gap_size=int(rng.integers(k + 5, 120)),
        min_duplication_length=int(rng.integers(150, 600)),
        max_cardinality=int(rng.integers(10, 120)),
        reverse=reverse, complement=reverse)
    n = int(rng.integers(8000, 20000))
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


def test_device_engine_json_byte_equal(tmp_path):
    """The full exported JSON must be byte-identical across engines."""
    import io

    from asgart_tpu.exporters import JSONExporter

    rng = np.random.default_rng(9)
    text = plant_duplication(rng, 16000, 1200, 2000, 9000)
    host, device = run_both(tmp_path, text, {})
    bh, bt = io.StringIO(), io.StringIO()
    JSONExporter().save(host, bh)
    JSONExporter().save(device, bt)
    assert bt.getvalue() == bh.getvalue()
    assert len(bh.getvalue()) > 200


def test_sharded_equals_single_device(tmp_path):
    """The 8-shard mesh scan must reproduce the single-device event
    stream and families exactly — shard boundaries drop nothing (the
    global event chain subsumes any boundary-crossing arm)."""
    import jax

    from asgart_tpu.device_engine import DeviceEngine
    from asgart_tpu.fasta import Strand, find_chunks_to_process
    from asgart_tpu.structs import RunSettings, Start

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(55)
    g = bytearray(random_dna(rng, 50000, b"ACGT"))
    # duplications straddling shard boundaries: each shard covers ~1/8 of
    # the probe stream, i.e. ~6250 bp — plant copies across those lines
    for (src, dst, L) in [(1000, 5500, 2500), (11000, 17500, 3000),
                          (24000, 30500, 2000), (36000, 43500, 2500)]:
        g[dst:dst + L] = bytes(g[src:src + L])
    data = np.concatenate([np.frombuffer(bytes(g), dtype=np.uint8),
                           np.frombuffer(b"$", dtype=np.uint8)])
    strand = Strand(file_names="t", data=data,
                    map=[Start("chr1", 0, len(g))])
    chunks = find_chunks_to_process(np.frombuffer(bytes(g), np.uint8))
    settings = RunSettings(min_duplication_length=800)

    single = DeviceEngine(strand, settings, mesh=False)
    sharded = DeviceEngine(strand, settings)
    assert sharded.mesh is not None
    fams_single, fams_sharded = [], []
    for c in chunks:
        fams_single.extend(single.run_chunk(c))
        fams_sharded.extend(sharded.run_chunk(c))
    assert fams_sharded == fams_single
    assert sum(len(f) for f in fams_single) >= 4


@pytest.mark.soak
def test_wide_probe_bounds(tmp_path):
    """k=21 exceeds the two-int32-plane packing (33 bits in the hi
    plane would merge distinct k-mer groups — found by review); round 4
    adds a THIRD plane to the table build for k = 21..30, and k > 30
    must still be rejected with the host engine producing identical
    output through the pipeline's routing."""
    import pytest

    from asgart_tpu.device_index import DeviceIndex

    rng = np.random.default_rng(4)
    text = plant_duplication(rng, 16000, 1500, 2000, 9000)
    data = np.concatenate([np.frombuffer(text, np.uint8),
                           np.frombuffer(b"$", np.uint8)])
    with pytest.raises(ValueError, match="probe_size"):
        DeviceIndex.build(data, 31)
    # k=21 now builds on device (3-plane) — equality pinned here and in
    # test_device_engine_wide_probes
    host, device = run_both(tmp_path, text, dict(probe_size=21))
    assert_results_equal(host, device)
    assert host.families
    # k=31+ routes through the host (ByteIndex) path, byte-equal
    host31, device31 = run_both(tmp_path, text, dict(probe_size=31))
    assert_results_equal(host31, device31)


def test_empty_family_postprocess_no_crash():
    from asgart_tpu import postprocess

    out = postprocess.reduce_overlap([[]])
    assert out == [[]]


@pytest.mark.soak
def test_device_chain_mode_matches_host(tmp_path, monkeypatch):
    """ASGART_DEVICE_CHAIN=1: the full on-device burst chain must keep
    the pipeline byte-equal to the host engine."""
    monkeypatch.setenv("ASGART_DEVICE_CHAIN", "1")
    rng = np.random.default_rng(64)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[9000:11500] = bytes(g[2000:4500])
    g[30000:31500] = bytes(g[21000:22500])
    # long quiet gaps between duplications -> multiple bursts
    host, device = run_both(tmp_path, bytes(g),
                            dict(min_duplication_length=900))
    assert_results_equal(host, device)
    assert sum(len(f) for f in host.families) >= 2


def test_hbm_budget_fallback_to_host(tmp_path, monkeypatch, caplog):
    """A genome whose device index would overflow the HBM budget must
    degrade to the host engine (identical output + a warning), not
    crash mid-build (pipeline.search_duplications guard)."""
    import logging

    rng = np.random.default_rng(77)
    text = plant_duplication(rng, 24000, 1500, 3000, 15000,
                             transform=revcomp)
    kw = dict(reverse=True, complement=True)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", text)])
    host = search_duplications([str(fa)], RunSettings(**kw),
                               engine="host")
    monkeypatch.setenv("ASGART_HBM_BYTES", "1000")
    with caplog.at_level(logging.WARNING, logger="asgart"):
        device = search_duplications([str(fa)], RunSettings(**kw),
                                     engine="tpu")
    assert any("one-HBM" in r.message for r in caplog.records)
    assert_results_equal(host, device)
    assert host.families


def test_hbm_budget_one_window_strategy(tmp_path, monkeypatch, caplog):
    """Between the table-engine and window-engine HBM budgets, a
    whole-genome run must route through the one-window merge-join
    device engine with byte-identical JSON (untrimmed settings)."""
    import io
    import logging

    from asgart_tpu.exporters import JSONExporter

    rng = np.random.default_rng(78)
    text = plant_duplication(rng, 24000, 1500, 3000, 15000,
                             transform=revcomp)
    kw = dict(reverse=True, complement=True)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", text)])
    host = search_duplications([str(fa)], RunSettings(**kw),
                               engine="host")
    # n1 = 24001, doubled = 48001: table needs 48001*26 B, window
    # 24001*44 B — a budget between them forces the window strategy
    monkeypatch.setenv("ASGART_HBM_BYTES", "1100000")
    with caplog.at_level(logging.INFO, logger="asgart"):
        device = search_duplications([str(fa)], RunSettings(**kw),
                                     engine="tpu")
    assert any("one-window" in r.message for r in caplog.records)
    bh, bt = io.StringIO(), io.StringIO()
    JSONExporter().save(host, bh)
    JSONExporter().save(device, bt)
    assert bt.getvalue() == bh.getvalue()
    assert host.families


def test_grouped_dispatch_many_chunks(tmp_path):
    """9 N-run chunks run as grouped lax.map dispatches (pow2-padded
    with inert dummy rows — 9 live chunks pad to G=16): host equality
    through the public pipeline, direct and RC."""
    import io

    from asgart_tpu.exporters import JSONExporter

    rng = np.random.default_rng(31)
    g = bytearray(random_dna(rng, 180000, b"ACGT"))
    g[24000:25500] = bytes(g[2000:3500])          # dup within chunk 1
    g[63000:64200] = bytes(g[42000:43200])        # dup within chunk 3
    g[156000:158000] = bytes(g[130000:132000])    # dup near the tail
    g[90000:91500] = revcomp(bytes(g[70000:71500]))
    for i in range(8):                            # 8 N-runs -> 9 chunks
        p = 17000 + i * 20000
        g[p:p + 6000] = b"N" * 6000
    for kw in ({}, dict(reverse=True, complement=True)):
        host, device = run_both(
            tmp_path, bytes(g), dict(min_duplication_length=700, **kw))
        assert_results_equal(host, device)
        bh, bt = io.StringIO(), io.StringIO()
        JSONExporter().save(host, bh)
        JSONExporter().save(device, bt)
        assert bt.getvalue() == bh.getvalue(), kw
    assert host.families


@pytest.mark.soak
def test_grouped_overflow_retry(tmp_path):
    """A grouped dispatch with tiny capacities: overflowed chunks must
    retry through the single-chunk path inside _collect_group and the
    merged output must still equal the host engine."""
    from asgart_tpu.device_engine import DeviceEngine
    from asgart_tpu.fasta import prepare_data
    from asgart_tpu.pipeline import SearchEngine, raw_families_to_protosds

    rng = np.random.default_rng(33)
    n = 60000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    g[12000:14000] = bytes(g[1000:3000])
    alu = random_dna(rng, 200, b"ACGT")
    for i in range(25):                    # repeat scatter -> overflow
        g[30000 + i * 230: 30000 + i * 230 + 200] = alu
    g[20000:26000] = b"N" * 6000           # chunk split
    g[40000:46000] = b"N" * 6000           # chunk split -> 3 chunks
    g[55000:56500] = bytes(g[47000:48500])  # dup within chunk 3
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=500, max_cardinality=60)
    _, chunks, strand = prepare_data([str(fa)], settings.skip_masked, None)
    assert len(chunks) >= 3

    host_se = SearchEngine(strand, settings, None, engine="host")
    host_fams = [f for c in chunks for f in host_se.run_chunk(c)]

    dev = DeviceEngine(strand, settings, mesh=False)
    live = [c for c in chunks if dev._chunk_geometry(c) is not None]
    b_pad = dev._chunk_geometry(live[0])[0]
    assert all(dev._chunk_geometry(c)[0] == b_pad for c in live)
    gst = dev._dispatch_group(live, b_pad, cap=256, ev_cap=8)
    res = dev._collect_group(gst)
    device_fams = []
    for c in chunks:
        device_fams.extend(raw_families_to_protosds(
            res.get(c, []), settings, c[0], c[1]))
    h = [[vars(sd) for sd in fam] for fam in host_fams]
    t = [[vars(sd) for sd in fam] for fam in device_fams]
    assert json.dumps(t, sort_keys=True) == json.dumps(h, sort_keys=True)
    assert len(device_fams) >= 2


@pytest.mark.soak
def test_sliced_dispatch_repeat_explosion(tmp_path, monkeypatch):
    """A chunk whose RAW match-window total exceeds the slice budget
    (unmasked satellite-like repeats) must scan as bounded-memory probe
    slices with output identical to the host engine — the reference
    survives such regions (slowly, asgart.rs:291-301 keeps them), so
    the device engine may not OOM on them."""
    import asgart_tpu.device_engine as de

    monkeypatch.setattr(de, "MIN_CAP", 128)  # cap floor below
    # the slice budget: pow4 cap buckets start at MIN_CAP, and the
    # conftest test floor (8192) equals the budget, so slicing
    # would never trigger
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", "256")
    rng = np.random.default_rng(11)
    n = 40000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    # satellite block: a 40-mer repeated ~250x back-to-back -> every
    # probe in the block has ~hundreds of raw matches (kept counts stay
    # below max_cardinality only for some; the explosion is in RAW)
    unit = random_dna(rng, 40, b"ACGT")
    block = (unit * 250)[:10000]
    g[15000:25000] = block
    # an RC satellite block too: RC probes of a non-palindromic
    # satellite otherwise match nothing (the r2 test only "sliced" in
    # RC because the old 2^16 cap floor exceeded the budget vacuously)
    g[5000:9000] = revcomp(bytes(g[15000:19000]))
    # plus a plain duplication elsewhere (must still be found exactly)
    g[30000:32000] = bytes(g[2000:4000])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])

    de._CAP_CACHE.clear()
    settings = dict(min_duplication_length=500, max_cardinality=500)
    host = search_duplications([str(fa)], RunSettings(**settings),
                               engine="host")
    device = search_duplications([str(fa)], RunSettings(**settings),
                                 engine="tpu")
    assert_results_equal(host, device)
    assert any(v == "sliced" for v in de._CAP_CACHE.values()), \
        "expected the sliced dispatch path to trigger"
    assert sum(len(f) for f in host.families) >= 1

    # rc flavor over the same genome (reversed probe->table mapping)
    de._CAP_CACHE.clear()
    settings["reverse"] = settings["complement"] = True
    host = search_duplications([str(fa)], RunSettings(**settings),
                               engine="host")
    device = search_duplications([str(fa)], RunSettings(**settings),
                                 engine="tpu")
    assert_results_equal(host, device)
    assert any(v == "sliced" for v in de._CAP_CACHE.values())


def test_mesh_grouped_dispatch_equals_single(tmp_path, monkeypatch):
    """Mesh parity for GROUPED dispatch (VERDICT r2 #2): a chunk-heavy
    genome must run its same-geometry groups as `_sharded_scan_group`
    SPMD dispatches on the 8-device mesh, byte-equal to the
    single-device run."""
    import jax

    from asgart_tpu import device_engine as de
    from asgart_tpu.device_engine import DeviceEngine
    from asgart_tpu.fasta import prepare_data

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(41)
    g = bytearray(random_dna(rng, 120000, b"ACGT"))
    g[16000:17500] = bytes(g[2000:3500])
    g[60000:61500] = bytes(g[40000:41500])
    g[112000:113500] = bytes(g[100000:101500])
    for i in range(5):                       # 5 N-runs -> 6 chunks
        p = 18000 + i * 18000
        g[p:p + 6000] = b"N" * 6000
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=700)
    _, chunks, strand = prepare_data([str(fa)], settings.skip_masked,
                                     None)
    assert len(chunks) >= 5

    de._CAP_CACHE.clear()
    single = DeviceEngine(strand, settings, mesh=False)
    fams_single = single.run_chunks(chunks)

    de._CAP_CACHE.clear()
    calls = {"groups": 0}
    orig = DeviceEngine._dispatch_group

    def spy(self, group, b_pad, cap, ev_cap):
        calls["groups"] += 1
        return orig(self, group, b_pad, cap, ev_cap)

    monkeypatch.setattr(DeviceEngine, "_dispatch_group", spy)
    sharded = DeviceEngine(strand, settings)
    assert sharded.mesh is not None
    fams_sharded = sharded.run_chunks(chunks)
    assert calls["groups"] >= 1, "mesh run must use grouped dispatch"
    assert fams_sharded == fams_single
    assert sum(len(f) for fams in fams_single for f in fams) >= 2


@pytest.mark.soak
def test_mesh_sliced_dispatch_equals_single(tmp_path, monkeypatch):
    """Mesh parity for SLICED dispatch: a repeat-heavy chunk must scan
    as SPMD slice rounds on the mesh, byte-equal to the single-device
    sliced scan."""
    import jax

    from asgart_tpu import device_engine as de
    from asgart_tpu.device_engine import DeviceEngine
    from asgart_tpu.fasta import prepare_data

    assert len(jax.devices()) == 8
    monkeypatch.setattr(de, "MIN_CAP", 2048)  # cap floor below
    # the slice budget: pow4 cap buckets start at MIN_CAP, and the
    # conftest test floor (8192) equals the budget, so slicing
    # would never trigger
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", "8192")
    rng = np.random.default_rng(42)
    n = 40000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    unit = random_dna(rng, 40, b"ACGT")
    g[15000:25000] = (unit * 250)[:10000]
    g[30000:32000] = bytes(g[2000:4000])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=500,
                           max_cardinality=500)
    _, chunks, strand = prepare_data([str(fa)], settings.skip_masked,
                                     None)

    de._CAP_CACHE.clear()
    single = DeviceEngine(strand, settings, mesh=False)
    fams_single = [single.run_chunk(c) for c in chunks]
    assert any(v == "sliced" for v in de._CAP_CACHE.values())

    de._CAP_CACHE.clear()
    sharded = DeviceEngine(strand, settings)
    assert sharded.mesh is not None
    fams_sharded = [sharded.run_chunk(c) for c in chunks]
    assert any(v == "sliced" for v in de._CAP_CACHE.values())
    assert fams_sharded == fams_single
    assert sum(len(f) for fams in fams_single for f in fams) >= 1


@pytest.mark.parametrize("k", [21, 25, 30])
def test_device_engine_wide_probes(tmp_path, k):
    """k = 21..30 on the device TABLE engine (3-plane keys): byte-equal
    to the host engine (PositionIndex at k<=21, ByteIndex beyond) for
    direct and RC runs, incl. N-probe skips."""
    import io

    from asgart_tpu.exporters import JSONExporter

    rng = np.random.default_rng(400 + k)
    g = bytearray(random_dna(rng, 60000, b"ACGT"))
    g[30000:32000] = bytes(g[4000:6000])
    g[50000:51500] = revcomp(bytes(g[20000:21500]))
    g[40000:40300] = b"N" * 300  # N content without a chunk split
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    for kw in ({}, dict(reverse=True, complement=True)):
        settings = RunSettings(probe_size=k, min_duplication_length=800,
                               **kw)
        host = search_duplications([str(fa)], settings, engine="host")
        device = search_duplications([str(fa)], settings, engine="tpu")
        bh, bt = io.StringIO(), io.StringIO()
        JSONExporter().save(host, bh)
        JSONExporter().save(device, bt)
        assert bt.getvalue() == bh.getvalue(), (k, kw)
    assert host.families


def test_device_engine_wide_probe_trim_routes_host(tmp_path):
    """k > 20 with --trim stays on the (2-plane-only) windowed path's
    byte-equal host fallback instead of the device window engines."""
    import io

    from asgart_tpu.exporters import JSONExporter

    rng = np.random.default_rng(77)
    g = bytearray(random_dna(rng, 40000, b"ACGT"))
    g[20000:22000] = bytes(g[3000:5000])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(probe_size=24, trim=(0, 39000),
                           min_duplication_length=800)
    host = search_duplications([str(fa)], settings, engine="host")
    device = search_duplications([str(fa)], settings, engine="tpu")
    bh, bt = io.StringIO(), io.StringIO()
    JSONExporter().save(host, bh)
    JSONExporter().save(device, bt)
    assert bt.getvalue() == bh.getvalue()
    assert host.families
