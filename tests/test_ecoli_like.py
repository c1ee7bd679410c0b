"""E. coli K-12-like surrogate run (BASELINE.json config #1 stand-in).

No genome data ships in this image and there is no network egress
(documented in CONFORMANCE.md), so config #1 runs on a surrogate with
K-12's duplication structure: 4.6 Mbp, GC~0.5, seven rRNA-like operons
(~5 kbp at ~99% identity — the main real segmental duplications in
K-12), IS1/IS3-like element families, and REP-like short repeats.
Golden JSON is committed; the run must stay byte-identical, on both
engines.
"""

import io
import json
import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def ecoli_like_genome() -> bytes:
    rng = np.random.default_rng(4_600_000)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    n = 4_600_000
    g = rng.choice(acgt, n)

    def mutate(seg, rate):
        seg = seg.copy()
        mask = rng.random(len(seg)) < rate
        seg[mask] = rng.choice(acgt, int(mask.sum()))
        return seg

    # seven rrn operons (~5 kbp, ~99% identity), real K-12 layout spirit:
    # scattered around the chromosome, two of them inverted
    rrn = rng.choice(acgt, 5000)
    sites = [85000, 510000, 1_370_000, 2_120_000, 2_760_000,
             3_540_000, 4_210_000]
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    for i, p in enumerate(sites):
        elt = mutate(rrn, 0.01)
        if i in (2, 5):
            elt = comp[elt][::-1]
        g[p:p + 5000] = elt

    # IS1-like (768 bp, ~8 copies) and IS3-like (1258 bp, ~5 copies)
    for (size, copies, seed_p) in ((768, 8, 0.02), (1258, 5, 0.015)):
        elt0 = rng.choice(acgt, size)
        for _ in range(copies):
            p = int(rng.integers(0, n - size))
            g[p:p + size] = mutate(elt0, seed_p)

    # REP-like 38 bp palindromic repeats, ~200 copies (below min length,
    # exercises cardinality/noise paths)
    rep = rng.choice(acgt, 38)
    for _ in range(200):
        p = int(rng.integers(0, n - 38))
        g[p:p + 38] = mutate(rep, 0.05)
    return g.tobytes()


@pytest.fixture(scope="module")
def genome_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("ecoli")
    fa = d / "ecoli_like.fa"
    body = ecoli_like_genome()
    with open(fa, "w") as fh:
        fh.write(">U00096.3-like\n")
        for i in range(0, len(body), 70):
            fh.write(body[i:i + 70].decode() + "\n")
    return str(fa)


@pytest.mark.parametrize("mode", ["direct", "rc"])
def test_ecoli_like_golden(genome_file, mode):
    from asgart_tpu.exporters import JSONExporter
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings

    kw = {} if mode == "direct" else dict(reverse=True, complement=True)
    res = search_duplications([genome_file], RunSettings(**kw))
    buf = io.StringIO()
    JSONExporter().save(res, buf)
    text = buf.getvalue()
    # strand name embeds the tmp path; normalize it for the golden
    text = text.replace(json.dumps(genome_file), '"ecoli_like.fa"')

    golden_path = os.path.join(GOLDEN_DIR, f"ecoli_like_{mode}.json")
    if not os.path.exists(golden_path):  # first generation
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        with open(golden_path, "w") as fh:
            fh.write(text)
    with open(golden_path) as fh:
        assert text == fh.read()

    n_sds = sum(len(f) for f in res.families)
    if mode == "direct":
        # the 5 direct-orientation rrn operons pair up, plus IS elements
        assert n_sds >= 8
    else:
        assert n_sds >= 2  # the inverted rrn copies


def test_ecoli_like_engines_agree(genome_file):
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings

    host = search_duplications([genome_file], RunSettings())
    device = search_duplications([genome_file], RunSettings(), engine="tpu")
    assert ([[vars(s) for s in f] for f in device.families] ==
            [[vars(s) for s in f] for f in host.families])
