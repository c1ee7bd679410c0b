"""One-off deep equivalence fuzz: host vs device (mesh) vs --shards over
randomized genomes/settings on the virtual CPU mesh. Not part of CI
(minutes of runtime); run before a release."""
import io
import os
import sys
import tempfile

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from asgart_tpu.exporters import JSONExporter  # noqa: E402
from asgart_tpu.pipeline import search_duplications  # noqa: E402
from asgart_tpu.structs import RunSettings  # noqa: E402
from tests.util import random_dna, revcomp, write_fasta  # noqa: E402

TRIALS = int(os.environ.get("FUZZ_TRIALS", "60"))


def one_trial(t, d):
    rng = np.random.default_rng(777_000 + t)
    k = int(rng.choice([8, 12, 16, 20, 21, 24]))
    reverse = bool(rng.integers(0, 2))
    complement = bool(rng.integers(0, 2)) if rng.integers(0, 4) else reverse
    kw = dict(
        probe_size=k,
        max_gap_size=int(rng.integers(k + 4, 150)),
        min_duplication_length=int(rng.integers(100, 900)),
        max_cardinality=int(rng.integers(5, 200)),
        reverse=reverse, complement=complement,
        skip_masked=bool(rng.integers(0, 2)))
    n = int(rng.integers(5000, 60000))
    alpha = [b"ACGT", b"ACG", b"ACGTN"][t % 3]
    g = bytearray(random_dna(rng, n, alpha))
    # N runs (some > 5000 for chunk splits)
    for _ in range(int(rng.integers(0, 3))):
        p = int(rng.integers(0, n - 100))
        ln = int(rng.integers(10, 7000))
        g[p:p + ln] = b"N" * min(ln, n - p)
    # masked zone
    p = int(rng.integers(0, n - 500))
    g[p:p + 500] = bytes(g[p:p + 500]).lower()
    # planted duplications
    for _ in range(int(rng.integers(1, 5))):
        L = int(rng.integers(120, 1200))
        if n // 2 - L <= 1 or n - L <= n // 2:
            continue
        src = int(rng.integers(0, n // 2 - L))
        dst = int(rng.integers(n // 2, n - L))
        seg = bytes(g[src:src + L]).upper()
        if reverse and complement:
            seg = revcomp(seg)
        elif reverse:
            seg = seg[::-1]
        elif complement:
            seg = seg.translate(bytes.maketrans(b"ACGTN", b"TGCAN"))
        g[dst:dst + L] = seg

    fa = os.path.join(d, f"g{t}.fa")
    write_fasta(fa, [("chr1", bytes(g))])

    def js(r):
        buf = io.StringIO()
        JSONExporter().save(r, buf)
        return buf.getvalue()

    host = js(search_duplications([fa], RunSettings(**kw)))
    device = js(search_duplications([fa], RunSettings(**kw), engine="tpu"))
    if k <= 21:
        assert device == host, f"trial {t}: device != host (k={k}, kw={kw})"
    if k <= 20:
        # force the big-genome one-window merge-join strategy for
        # doubled runs (the budget sits between the doubled-table and
        # window-engine footprints; direct-run tables always fit
        # whenever the window would, so direct trials just re-run device)
        os.environ["ASGART_HBM_BYTES"] = str((n + 1) * 50)
        try:
            win = js(search_duplications([fa], RunSettings(**kw),
                                         engine="tpu"))
        finally:
            del os.environ["ASGART_HBM_BYTES"]
        assert win == host, \
            f"trial {t}: one-window != host (k={k}, kw={kw})"
    if k <= 20 and t % 3 == 0:
        # forced big-window engine with a tiny batch budget: exercises
        # the batched needle upload + multi-batch split + grouped
        # rebased cores
        os.environ["ASGART_BIG_WINDOW"] = "1"
        os.environ["ASGART_BIG_BATCH_BYTES"] = str(1 << 20)
        try:
            big = js(search_duplications(
                [fa], RunSettings(trim=(0, n), **kw), engine="tpu"))
            bh = js(search_duplications(
                [fa], RunSettings(trim=(0, n), **kw), engine="host"))
        finally:
            del os.environ["ASGART_BIG_WINDOW"]
            del os.environ["ASGART_BIG_BATCH_BYTES"]
        assert big == bh, f"trial {t}: big-window != host (k={k}, kw={kw})"
    sh = search_duplications([fa], RunSettings(**kw), shards=3)
    n_sh = sum(len(f) for f in sh.families)
    return sum(len(f) for f in
               search_duplications([fa], RunSettings(**kw)).families), n_sh


def main():
    with tempfile.TemporaryDirectory() as d:
        total = 0
        for t in range(TRIALS):
            n_sds, n_sh = one_trial(t, d)
            total += n_sds
            print(f"trial {t}: ok ({n_sds} SDs, {n_sh} sharded)",
                  flush=True)
        print(f"deep fuzz: {TRIALS} trials OK, {total} SDs total")


if __name__ == "__main__":
    main()
