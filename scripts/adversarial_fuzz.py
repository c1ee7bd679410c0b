"""Adversarial-genome equivalence fuzz: host vs device on repeat
structures that stress equal-range explosions, cardinality skips and
the sliced dispatch — homopolymers, dinucleotide satellites, tandem
arrays, nested duplications, identical halves, boundary-straddlers.
Not CI (minutes); run before a release alongside deep_fuzz.py.

Env: FUZZ_TRIALS (default 24), plus the usual engine forcings
(ASGART_DEVICE_SLICE_LANES, ASGART_BIG_WINDOW, ...).
"""
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

TRIALS = int(os.environ.get("FUZZ_TRIALS", "24"))


def adversarial_genome(rng, t):
    n = int(rng.integers(16000, 40000))
    g = bytearray(random_dna(rng, n, b"ACGT"))
    kind = t % 6
    if kind == 0:        # homopolymer block (maximal equal ranges)
        L = int(rng.integers(2000, min(8000, n // 2)))
        p = int(rng.integers(0, n - L))
        g[p:p + L] = b"A" * L
    elif kind == 1:      # dinucleotide satellite
        L = int(rng.integers(2000, min(8000, n // 2)))
        p = int(rng.integers(0, n - L))
        g[p:p + L] = (b"AT" * L)[:L]
    elif kind == 2:      # tandem array of a short unit
        unit = random_dna(rng, int(rng.integers(20, 200)), b"ACGT")
        L = int(rng.integers(3000, min(9000, n // 2)))
        p = int(rng.integers(0, n - L))
        g[p:p + L] = (unit * (L // len(unit) + 1))[:L]
    elif kind == 3:      # nested/overlapping duplications
        a = int(rng.integers(0, n // 4 - 3000)) if n // 4 > 3000 else 0
        g[n // 2:n // 2 + 3000] = bytes(g[a:a + 3000])
        L2 = min(1500, n - 3 * n // 4)
        g[3 * n // 4:3 * n // 4 + L2] = bytes(g[a + 500:a + 500 + L2])
    elif kind == 4:      # identical halves (one giant duplication)
        g[n // 2:] = bytes(g[:n - n // 2])
    else:                # straddler across an N-run chunk split
        mid = n // 3
        g[mid:mid + 6000] = b"N" * 6000
        end = min(mid + 9000, n)
        g[end - 2000:end] = bytes(g[1000:3000])
    if rng.integers(0, 2):
        p = int(rng.integers(2000, n - 2500))
        g[p + 500:p + 2500] = revcomp(bytes(g[p - 2000:p]))
    return bytes(g)


def main():
    failures = 0
    for t in range(TRIALS):
        rng = np.random.default_rng(555_000 + t)
        g = adversarial_genome(rng, t)
        k = int(rng.choice([12, 16, 20]))
        kw = dict(probe_size=k,
                  max_gap_size=int(rng.integers(k + 4, 140)),
                  min_duplication_length=int(rng.integers(300, 1200)),
                  max_cardinality=int(rng.choice([5, 50, 500])),
                  reverse=bool(rng.integers(0, 2)))
        kw["complement"] = kw["reverse"] or bool(rng.integers(0, 2))
        with tempfile.TemporaryDirectory() as d:
            fa = os.path.join(d, "g.fa")
            write_fasta(fa, [("chr1", g)])
            settings = RunSettings(**kw)
            outs = {}
            for eng in ("host", "tpu"):
                r = search_duplications([fa], settings, engine=eng)
                buf = io.StringIO()
                JSONExporter().save(r, buf)
                outs[eng] = buf.getvalue()
            n_sds = sum(len(f) for f in r.families)
            if outs["host"] != outs["tpu"]:
                failures += 1
                print(f"trial {t}: MISMATCH kind={t % 6} kw={kw}")
            else:
                print(f"trial {t}: ok (kind={t % 6}, {n_sds} SDs)",
                      flush=True)
    print(f"adversarial fuzz: {TRIALS} trials, {failures} failures")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
