import io

import numpy as np
import pytest

from asgart_tpu.exporters import JSONExporter
from asgart_tpu.pipeline import search_duplications
from asgart_tpu.structs import RunResult, RunSettings
from tests.util import plant_duplication, random_dna, revcomp, write_fasta


def default_settings(**kw) -> RunSettings:
    base = dict(probe_size=20, max_gap_size=120,
                min_duplication_length=1000, max_cardinality=500)
    base.update(kw)
    return RunSettings(**base)


def test_end_to_end_direct(tmp_path):
    rng = np.random.default_rng(1)
    g = plant_duplication(rng, 20000, 2000, 3000, 12000, noise=0.01)
    p = tmp_path / "genome.fa"
    write_fasta(p, [("chrT", g)])
    result = search_duplications([str(p)], default_settings())

    assert result.strand.name == str(p)
    assert result.strand.length == 20000
    assert [s.name for s in result.strand.map] == ["chrT"]
    assert result.families, "no families found"
    sds = [sd for fam in result.families for sd in fam]
    best = max(sds, key=lambda sd: sd.right_length)
    assert best.chr_left == "chrT" and best.chr_right == "chrT"
    assert abs(best.global_left_position - 3000) < 300
    assert abs(best.global_right_position - 12000) < 300
    assert best.right_length > 1500
    assert not best.reversed and not best.complemented
    # global == chr-relative for a single fragment
    assert best.global_left_position == best.chr_left_position


def test_end_to_end_reversed_complemented(tmp_path):
    rng = np.random.default_rng(2)
    g = plant_duplication(rng, 20000, 2000, 3000, 12000,
                          noise=0.01, transform=revcomp)
    p = tmp_path / "genome.fa"
    write_fasta(p, [("chrT", g)])

    # not found by the direct search
    direct = search_duplications([str(p)], default_settings())
    direct_sds = [sd for fam in direct.families for sd in fam]
    assert all(sd.right_length < 1500 for sd in direct_sds)

    # found by the -RC search
    result = search_duplications(
        [str(p)], default_settings(reverse=True, complement=True))
    sds = [sd for fam in result.families for sd in fam]
    assert sds, "RC duplication not found"
    best = max(sds, key=lambda sd: sd.right_length)
    assert best.reversed and best.complemented
    assert abs(best.global_left_position - 3000) < 300
    assert abs(best.global_right_position - 12000) < 300
    assert best.right_length > 1500


def test_end_to_end_two_fragments_inter(tmp_path):
    rng = np.random.default_rng(3)
    a = bytearray(random_dna(rng, 9000))
    b = bytearray(random_dna(rng, 9000))
    b[4000:5500] = a[2000:3500]  # cross-fragment duplication
    p = tmp_path / "two.fa"
    write_fasta(p, [("chrA", bytes(a)), ("chrB", bytes(b))])
    result = search_duplications([str(p)], default_settings())
    sds = [sd for fam in result.families for sd in fam]
    inter = [sd for sd in sds if sd.chr_left != sd.chr_right]
    assert inter, "inter-fragment duplication not found"
    best = max(inter, key=lambda sd: sd.right_length)
    assert best.chr_left == "chrA" and best.chr_right == "chrB"
    assert abs(best.chr_left_position - 2000) < 300
    assert abs(best.chr_right_position - 4000) < 300
    assert best.global_right_position == best.chr_right_position + 9000


def test_json_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    g = plant_duplication(rng, 15000, 1500, 2000, 9000)
    p = tmp_path / "g.fa"
    write_fasta(p, [("chr", g)])
    result = search_duplications([str(p)], default_settings())
    buf = io.StringIO()
    JSONExporter().save(result, buf)
    text = buf.getvalue()
    assert text.endswith("}\n")
    out = tmp_path / "r.json"
    out.write_text(text)
    again = RunResult.from_file(str(out))
    assert again.strand.name == result.strand.name
    assert len(again.families) == len(result.families)
    buf2 = io.StringIO()
    JSONExporter().save(again, buf2)
    assert buf2.getvalue() == text  # byte-stable through a round trip

    # settings block serialized with skip rules
    assert '"reverse"' not in text
    assert '"threads_count"' not in text
    assert '"skip_masked": false' in text
    assert '"trim": null' in text


def test_identical_fragments_with_compute_score(tmp_path):
    rng = np.random.default_rng(6)
    g = plant_duplication(rng, 8000, 1500, 1000, 5000)  # exact copy
    p = tmp_path / "g.fa"
    write_fasta(p, [("chr", g)])
    result = search_duplications(
        [str(p)], default_settings(compute_score=True))
    sds = [sd for fam in result.families for sd in fam]
    assert sds
    best = max(sds, key=lambda sd: sd.right_length)
    assert best.identity > 95.0


def test_skip_masked_hides_masked_duplication(tmp_path):
    rng = np.random.default_rng(8)
    g = bytearray(plant_duplication(rng, 16000, 1500, 2000, 9000))
    # soft-mask the right copy
    g[9000:10500] = bytes(g[9000:10500]).lower()
    p = tmp_path / "m.fa"
    write_fasta(p, [("chr", bytes(g))])

    found = search_duplications([str(p)], default_settings())
    assert found.families, "unmasked run must find the duplication"

    masked = search_duplications(
        [str(p)], default_settings(skip_masked=True))
    sds = [sd for fam in masked.families for sd in fam]
    assert all(sd.right_length < 1400 for sd in sds), \
        "soft-masked copy must be invisible with --skip-masked"


def test_trim_windows_merge_equals_full_run(tmp_path):
    """The reference's manual scale-out: partial --trim runs merged with
    slice must recover the duplications of the full run."""
    import io

    from asgart_tpu.exporters import JSONExporter
    from asgart_tpu.structs import RunResult

    rng = np.random.default_rng(12)
    g = bytearray(random_dna(rng, 30000))
    g[20000:21500] = g[3000:4500]    # right arm in window 2
    g[25000:26200] = g[8000:9200]    # right arm in window 2
    p = tmp_path / "t.fa"
    write_fasta(p, [("chr", bytes(g))])

    full = search_duplications([str(p)], default_settings())

    paths = []
    for i, trim in enumerate([(0, 15000), (15000, 30000)]):
        r = search_duplications(
            [str(p)], default_settings(trim=trim))
        buf = io.StringIO()
        JSONExporter().save(r, buf)
        fp = tmp_path / f"part{i}.json"
        fp.write_text(buf.getvalue())
        paths.append(str(fp))
    merged = RunResult.from_files(paths)

    def sd_set(result):
        return {(sd.global_left_position, sd.global_right_position,
                 sd.left_length, sd.right_length)
                for fam in result.families for sd in fam}

    assert sd_set(merged) == sd_set(full)
    assert len(sd_set(full)) >= 2


def test_trim_with_rc_mode(tmp_path):
    """--trim combined with -RC: windowed SA, whole-genome probing."""
    rng = np.random.default_rng(19)
    g = bytearray(random_dna(rng, 24000))
    seg = bytes(g[2000:3500])
    g[16000:17500] = revcomp(seg)
    p = tmp_path / "t.fa"
    write_fasta(p, [("chr", bytes(g))])

    full = search_duplications(
        [str(p)], default_settings(reverse=True, complement=True))
    window = search_duplications(
        [str(p)], default_settings(reverse=True, complement=True,
                                   trim=(12000, 24000)))

    def sd_set(r):
        return {(sd.global_left_position, sd.global_right_position)
                for fam in r.families for sd in fam}

    assert sd_set(full), "fixture found nothing"
    # the RC pair (left 2000, right 16000) has its right arm inside the
    # window, so the trimmed run must find it too
    assert sd_set(window) == sd_set(full)


def test_odd_probe_size_end_to_end(tmp_path):
    """k=15 (odd stride 7) through the full pipeline."""
    rng = np.random.default_rng(21)
    g = plant_duplication(rng, 12000, 1200, 1500, 8000, noise=0.01)
    p = tmp_path / "g.fa"
    write_fasta(p, [("chr", g)])
    r = search_duplications(
        [str(p)], default_settings(probe_size=15, max_gap_size=115))
    sds = [sd for fam in r.families for sd in fam]
    assert sds
    best = max(sds, key=lambda sd: sd.right_length)
    assert abs(best.global_left_position - 1500) < 300
    assert abs(best.global_right_position - 8000) < 300


def test_probe_size_over_21_uses_byte_index():
    """k > 21 overflows 3-bit/symbol int64 packing (ADVICE r1 high): the
    packed builders reject it, while the pipeline routes wide probes to
    the byte-compare strategy (reference parity: any -k works)."""
    import numpy as np
    import pytest

    from asgart_tpu.index import GenomeIndex, PositionIndex
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings

    data = np.frombuffer(b"ACGTACGTACGTACGTACGTACGTACGT$", dtype=np.uint8)
    for builder in (lambda: PositionIndex.build(data, 24),
                    lambda: PositionIndex.build_single(data, 22),
                    lambda: GenomeIndex.build(data, 30)):
        with pytest.raises(ValueError, match="probe_size"):
            builder()
    with pytest.raises(ValueError, match="probe_size"):
        search_duplications(["/nonexistent.fa"],
                            RunSettings(probe_size=20000))


def test_wide_probe_cli_end_to_end(tmp_path):
    import json

    import numpy as np

    from asgart_tpu.cli.main import main
    from tests.util import plant_duplication

    rng = np.random.default_rng(3)
    text = plant_duplication(rng, 16000, 1500, 1000, 9000)
    fa = tmp_path / "g.fa"
    fa.write_text(">chr\n" + text.decode() + "\n")
    out = tmp_path / "o.json"
    rc = main([str(fa), "-k", "24", "--out", str(out)])
    assert rc == 0
    res = json.loads(out.read_text())
    assert sum(len(f) for f in res["families"]) >= 1
    assert res["settings"]["probe_size"] == 24


def test_index_cache_roundtrip(tmp_path):
    """--index-cache: one cached single-text index serves direct AND RC
    runs with byte-identical output; the second run loads from disk."""
    import numpy as np

    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings
    from tests.util import plant_duplication, revcomp, write_fasta

    rng = np.random.default_rng(21)
    text = plant_duplication(rng, 20000, 1500, 2000, 12000,
                             transform=revcomp)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", text)])
    cache = str(tmp_path / "cache")

    kw = dict(reverse=True, complement=True)
    plain = search_duplications([str(fa)], RunSettings(**kw))
    first = search_duplications([str(fa)], RunSettings(**kw),
                                index_cache=cache)
    import os
    assert any(f.endswith(".sa.npy") for f in os.listdir(cache))
    second = search_duplications([str(fa)], RunSettings(**kw),
                                 index_cache=cache)
    # direct run served by the same cache entry
    direct = search_duplications([str(fa)], RunSettings(),
                                 index_cache=cache)
    assert len(os.listdir(cache)) == 4  # sa/ranges/keys/meta — one entry

    def dump(r):
        return [[vars(sd) for sd in fam] for fam in r.families]

    assert dump(first) == dump(plain)
    assert dump(second) == dump(plain)
    assert dump(direct) is not None


def test_shards_equals_sequential_trim_merge(tmp_path):
    """--shards N reproduces the reference's manual scale-out exactly:
    N sequential --trim runs merged in window order (the asgart-slice
    workflow)."""
    import dataclasses

    import numpy as np

    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings
    from tests.util import plant_duplication, random_dna, write_fasta

    rng = np.random.default_rng(77)
    n = 40000
    g = bytearray(random_dna(rng, n, b"ACGT"))
    # duplications whose arms land in different windows, plus one whose
    # right arm crosses a window boundary
    g[22000:24000] = bytes(g[3000:5000])
    g[9000:10500] = bytes(g[30000:31500])
    g[19500:20500] = bytes(g[34000:35000])  # spans the 2-shard boundary
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = RunSettings(min_duplication_length=600)

    sharded = search_duplications([str(fa)], settings, shards=4)

    per = (n + 3) // 4
    manual = []
    for w in range(4):
        win = (w * per, min(n, (w + 1) * per))
        s = dataclasses.replace(settings, trim=win)
        manual.append(search_duplications([str(fa)], s))
    merged = manual[0]
    for r in manual[1:]:
        merged.families.extend(r.families)

    def dump(r):
        return [[vars(sd) for sd in fam] for fam in r.families]

    assert dump(sharded) == dump(merged)
    assert sum(len(f) for f in sharded.families) >= 2
    # the merged settings carry no window trim
    assert sharded.settings.trim is None


def test_tpu_engine_trim_fallback_matches_host(tmp_path):
    """engine=device with --trim uses the windowed-SA strategy (legacy
    device binary-search lookup); output must equal the host trim run."""
    import numpy as np

    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings
    from tests.util import plant_duplication, write_fasta

    rng = np.random.default_rng(13)
    text = plant_duplication(rng, 24000, 1500, 1000, 15000)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", text)])
    kw = dict(trim=(0, 20000), min_duplication_length=800)
    host = search_duplications([str(fa)], RunSettings(**kw))
    device = search_duplications([str(fa)], RunSettings(**kw), engine="tpu")

    def dump(r):
        return [[vars(sd) for sd in fam] for fam in r.families]

    assert dump(device) == dump(host)
    assert host.families, "duplication inside the window must be found"


def test_wide_probe_matches_oracle(tmp_path):
    """k in {22, 25, 40}: byte-index pipeline vs the Python oracle
    automaton on fuzzed genomes (direct + RC + trim)."""
    import numpy as np

    from asgart_tpu import automaton, native
    from asgart_tpu.index import ByteIndex
    from asgart_tpu.pipeline import probe_positions
    from asgart_tpu.structs import RunSettings
    from tests.util import random_dna, revcomp

    for trial, k in enumerate((22, 25, 40)):
        rng = np.random.default_rng(500 + trial)
        reverse = trial % 2 == 1
        settings = RunSettings(
            probe_size=k, max_gap_size=k + 60,
            min_duplication_length=300, max_cardinality=50,
            reverse=reverse, complement=reverse)
        n = 6000
        g = bytearray(random_dna(rng, n, b"ACGT"))
        L = 600
        seg = bytes(g[800:800 + L])
        if reverse:
            seg = revcomp(seg)
        g[4000:4000 + L] = seg
        text = bytes(g) + b"$"
        data = np.frombuffer(text, dtype=np.uint8)

        bidx = ByteIndex.build(data, k)
        needle = text[:-1]
        if reverse:
            needle = needle.translate(
                bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]
        arr = np.frombuffer(needle, dtype=np.uint8)

        oracle = automaton.search_duplications(
            needle, 0, lambda pat: bidx.search(pat), settings)

        is_ = probe_positions(arr, k)
        padded = np.zeros(len(arr) + k, dtype=np.uint8)
        padded[:len(arr)] = arr
        lo, hi = bidx.lookup_needle(padded, is_)
        got = native.chain(
            bidx.sa, is_, lo, hi, probe_size=k, step_size=k // 2,
            max_gap_size=settings.max_gap_size,
            min_duplication_length=settings.min_duplication_length,
            max_cardinality=settings.max_cardinality,
            needle_offset=0, needle_len=len(arr), reverse=reverse)
        assert got == oracle
        assert oracle, f"k={k}: planted duplication not found"


def test_wide_probe_trim(tmp_path):
    import numpy as np

    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings
    from tests.util import plant_duplication, write_fasta

    rng = np.random.default_rng(8)
    text = plant_duplication(rng, 20000, 1500, 1000, 9000)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", text)])
    res = search_duplications(
        [str(fa)], RunSettings(probe_size=26, trim=(0, 15000),
                               min_duplication_length=800))
    assert sum(len(f) for f in res.families) >= 1


def test_two_files_rc_like_human_vs_chimp(tmp_path):
    """BASELINE config #5 shape: two FASTA files concatenated into one
    strand (asgart.rs:273-311), -RC search finding a cross-file inverted
    duplication; engines agree byte-for-byte."""
    rng = np.random.default_rng(23)
    a = bytearray(random_dna(rng, 20000))
    b = bytearray(random_dna(rng, 18000))
    b[9000:11000] = revcomp(bytes(a[5000:7000]))
    fa_a = tmp_path / "human.fa"
    fa_b = tmp_path / "chimp.fa"
    write_fasta(fa_a, [("h_chr1", bytes(a))])
    write_fasta(fa_b, [("c_chr1", bytes(b))])

    kw = dict(reverse=True, complement=True, min_duplication_length=1000)
    host = search_duplications([str(fa_a), str(fa_b)], RunSettings(**kw))
    device = search_duplications([str(fa_a), str(fa_b)], RunSettings(**kw),
                                 engine="tpu")
    sds = [sd for fam in host.families for sd in fam]
    cross = [sd for sd in sds if sd.chr_left != sd.chr_right]
    assert cross, "cross-file RC duplication not found"
    best = max(cross, key=lambda sd: sd.right_length)
    assert best.chr_left == "h_chr1" and best.chr_right == "c_chr1"
    assert abs(best.chr_left_position - 5000) < 300
    assert abs(best.chr_right_position - 9000) < 300

    buf_h, buf_t = io.StringIO(), io.StringIO()
    JSONExporter().save(host, buf_h)
    JSONExporter().save(device, buf_t)
    assert buf_t.getvalue() == buf_h.getvalue()
    # two input files join the strand name with "; " like from_files
    assert "human" in host.strand.name and "chimp" in host.strand.name


def test_checkpoint_resume_with_tpu_engine(tmp_path):
    """--checkpoint with engine=device: journaled chunks restore and the
    final result matches an uncheckpointed run."""
    rng = np.random.default_rng(31)
    g = bytearray(random_dna(rng, 30000))
    g[20000:22000] = bytes(g[3000:5000])
    g[12000:18500] = b"N" * 6500  # chunk split
    p = tmp_path / "c.fa"
    write_fasta(p, [("chr", bytes(g))])
    ck = str(tmp_path / "journal.jsonl")
    kw = dict(min_duplication_length=900)

    full = search_duplications([str(p)], RunSettings(**kw), engine="tpu")
    first = search_duplications([str(p)], RunSettings(**kw), engine="tpu",
                                checkpoint=ck)
    resumed = search_duplications([str(p)], RunSettings(**kw),
                                  engine="tpu", checkpoint=ck)

    def dump(r):
        return [[vars(sd) for sd in fam] for fam in r.families]

    assert dump(first) == dump(full)
    assert dump(resumed) == dump(full)
    assert full.families


def _backend_down(*a, **kw):
    raise RuntimeError("Unable to initialize backend 'cuda': "
                       "UNAVAILABLE: no CUDA-capable device is detected")


def test_backend_init_error_propagates(tmp_path, monkeypatch):
    """A device backend-init failure propagates out of engine=device: the
    run fails instead of quietly running the host engine."""
    import pytest

    import asgart_tpu.pipeline as pl

    rng = np.random.default_rng(77)
    g = plant_duplication(rng, 20000, 2000, 3000, 12000, noise=0.01)
    p = tmp_path / "genome.fa"
    write_fasta(p, [("chrT", g)])
    monkeypatch.setattr(pl, "_DeviceEngineAdapter", _backend_down)
    with pytest.raises(RuntimeError, match="Unable to initialize backend"):
        search_duplications([str(p)], default_settings(), engine="tpu")
    # the host engine is untouched by the device backend
    assert search_duplications([str(p)], default_settings()).families


def test_shards_backend_init_error_propagates(tmp_path, monkeypatch):
    """--shards with engine=device: a backend that cannot start fails the
    run (no host-window substitution)."""
    import jax
    import pytest

    rng = np.random.default_rng(78)
    g = plant_duplication(rng, 24000, 1500, 2000, 15000, noise=0.0)
    p = tmp_path / "genome.fa"
    write_fasta(p, [("chrT", g)])
    monkeypatch.setattr(jax, "devices", _backend_down)
    with pytest.raises(RuntimeError, match="Unable to initialize backend"):
        search_duplications([str(p)],
                            default_settings(min_duplication_length=800),
                            shards=2, engine="tpu")


@pytest.mark.parametrize("where", ["dispatch", "tail"])
def test_window_failure_fails_the_run(tmp_path, monkeypatch, where):
    """The pipelined window driver reruns nothing: a window whose device
    dispatch or host tail raises fails the run, and no window is handed
    to the host engine."""
    import jax

    import asgart_tpu.pipeline as pl

    rng = np.random.default_rng(79)
    g = plant_duplication(rng, 24000, 1500, 2000, 15000, noise=0.0)
    p = tmp_path / "genome.fa"
    write_fasta(p, [("chrT", g)])
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **kw: one)

    real = pl._DeviceEngineAdapter
    built = []

    class Faulty(real):
        def __init__(self, strand, settings, **kw):
            built.append(settings.trim)
            if where == "dispatch" and len(built) == 2:
                raise RuntimeError("window dispatch failed")
            super().__init__(strand, settings, **kw)

        def run_chunks_deferred(self, chunks):
            tail = super().run_chunks_deferred(chunks)
            if where == "tail" and len(built) == 1:
                def broken():
                    raise RuntimeError("window tail failed")
                return broken
            return tail

    def no_host(*a, **kw):
        raise AssertionError("a window was rerun on the host engine")

    monkeypatch.setattr(pl, "_DeviceEngineAdapter", Faulty)
    monkeypatch.setattr(pl, "SearchEngine", no_host)
    with pytest.raises(RuntimeError, match=f"window {where} failed"):
        search_duplications([str(p)],
                            default_settings(min_duplication_length=800),
                            shards=2, engine="tpu")


def test_profile_records_device_engine(tmp_path):
    """engine=device records the engine class that served the run; a
    device run planned onto the host engine says so and why."""
    rng = np.random.default_rng(80)
    g = plant_duplication(rng, 20000, 2000, 3000, 12000, noise=0.01)
    p = tmp_path / "genome.fa"
    write_fasta(p, [("chrT", g)])
    from asgart_tpu import device_engine

    prof: dict = {}
    search_duplications([str(p)], default_settings(), engine="tpu",
                        profile=prof)
    assert isinstance(getattr(device_engine, prof["device_engine"]), type)
    assert "host_route" not in prof

    prof = {}
    search_duplications([str(p)], default_settings(probe_size=40),
                        engine="tpu", profile=prof)
    assert prof["device_engine"] == "host"
    assert "probe_size 40" in prof["host_route"]

    prof = {}
    search_duplications([str(p)], default_settings(), profile=prof)
    assert "device_engine" not in prof  # the host engine was asked for


def test_record_engine_lists_window_engines_once():
    from asgart_tpu.pipeline import _record_engine

    prof: dict = {}
    for name in ("FusedEngine", "FusedEngine", "DeviceWindowEngine",
                 "FusedEngine"):
        _record_engine(prof, name)
    assert prof == {"device_engine": "FusedEngine,DeviceWindowEngine"}
    _record_engine(prof, "host", "windows exceed the budget")
    assert prof["device_engine"].endswith(",host")
    assert prof["host_route"] == "windows exceed the budget"


def test_auto_shards_when_past_window_budget(tmp_path, monkeypatch,
                                             caplog):
    """engine=device on a genome past even the one-window HBM budget
    auto-shards into the smallest fitting window count, byte-equal to
    the explicit --shards run (round 3; previously degraded to the
    host whole-genome engine). The fit predicates are monkeypatched —
    this pins the ROUTING; the real HBM formulas are calibration
    constants pinned elsewhere."""
    import logging

    import asgart_tpu.device_index as di

    rng = np.random.default_rng(88)
    g = plant_duplication(rng, 30000, 1500, 2000, 20000, noise=0.0)
    p = tmp_path / "genome.fa"
    write_fasta(p, [("chrT", g)])
    settings = default_settings(min_duplication_length=800)
    n1 = 30002

    explicit = search_duplications([str(p)], settings, engine="tpu",
                                   shards=3)

    monkeypatch.setattr(di, "device_index_fits", lambda *a: False)
    monkeypatch.setattr(di, "device_window_whole_fits", lambda *a: False)
    # the fused engine would otherwise serve the whole genome (its HBM
    # reach exceeds the table engine's) and the routing under test here
    # is the auto-shard fallback
    monkeypatch.setenv("ASGART_FUSED", "0")
    # windows fit only at 1/3 of the genome or smaller -> S = 3
    monkeypatch.setattr(di, "device_window_fits",
                        lambda _n1, W, d, k=20: W <= (n1 - 1 + 2) // 3 + 1)
    with caplog.at_level(logging.WARNING, logger="asgart"):
        auto = search_duplications([str(p)], settings, engine="tpu")
    assert any("auto-sharding into 3" in r.message
               for r in caplog.records)
    ba, be = io.StringIO(), io.StringIO()
    JSONExporter().save(auto, ba)
    JSONExporter().save(explicit, be)
    assert ba.getvalue() == be.getvalue()
    assert auto.families


def _json_bytes(res) -> str:
    buf = io.StringIO()
    JSONExporter().save(res, buf)
    return buf.getvalue()


def test_window_pipeline_byte_equal(tmp_path, monkeypatch):
    """The two-stage sharded window pipeline (window w's host tail
    overlapped with window w+1's device phase) is byte-equal to the
    serial driver (`ASGART_WINDOW_PIPELINE=0`) and to the host engine,
    on both window engines:

      * merge-join windows (`ASGART_FUSED=0`),
      * fused windows (`ASGART_FUSED=1`),

    with a boundary-straddling RC duplication and an N-split chunk so
    the tails carry real chaining work. shards=3 on the 8-device CPU
    mesh keeps the per-window route (8 % 3 != 0 — no mesh grid)."""
    import dataclasses

    rng = np.random.default_rng(4242)
    g = bytearray(random_dna(rng, 30000, b"ACGT"))
    g[21000:23000] = revcomp(bytes(g[9000:11000]))  # straddles 10000/20000
    g[15000:15020] = b"N" * 20
    g[26000:27000] = bytes(g[1000:2000])
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", bytes(g))])
    settings = default_settings(min_duplication_length=800,
                                reverse=True, complement=True)

    host = search_duplications([str(fa)], settings, engine="host",
                               shards=3)
    for fused in ("0", "1"):
        monkeypatch.setenv("ASGART_FUSED", fused)
        monkeypatch.setenv("ASGART_WINDOW_PIPELINE", "0")
        serial = search_duplications([str(fa)],
                                     dataclasses.replace(settings),
                                     engine="tpu", shards=3)
        monkeypatch.setenv("ASGART_WINDOW_PIPELINE", "1")
        piped = search_duplications([str(fa)],
                                    dataclasses.replace(settings),
                                    engine="tpu", shards=3)
        assert _json_bytes(piped) == _json_bytes(serial) \
            == _json_bytes(host), f"fused={fused}"
    assert host.families


def test_window_pipeline_headroom_serializes(tmp_path, monkeypatch):
    """Under HBM pressure the pipeline driver falls back to the serial
    order (waits for the in-flight tail before dispatching the next
    window) — output stays byte-equal."""
    import dataclasses

    import asgart_tpu.pipeline as pl

    rng = np.random.default_rng(77)
    g = plant_duplication(rng, 24000, 1500, 2000, 14000, noise=0.0)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chrT", g)])
    settings = default_settings(min_duplication_length=800)

    host = search_duplications([str(fa)], settings, engine="host",
                               shards=3)
    calls = {"n": 0}
    real = pl._window_pipeline_headroom

    def tiny_headroom(n1, W, s):
        calls["n"] += 1
        real(n1, W, s)  # exercise the projection itself
        return False

    monkeypatch.setattr(pl, "_window_pipeline_headroom", tiny_headroom)
    piped = search_duplications([str(fa)],
                                dataclasses.replace(settings),
                                engine="tpu", shards=3)
    assert calls["n"] >= 2  # consulted for every window after the first
    assert _json_bytes(piped) == _json_bytes(host)
