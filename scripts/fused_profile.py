"""Device fresh-genome profile of the FUSED engine vs the classic
table engine: synthesizes a bench-style genome, runs the full
`engine=device` pipeline twice per engine (pass 1 warms compiles; pass 2
on the COMPLEMENT genome = the fresh-genome regime: same chunk/spec
structure, different content, so every compile is warm but every build
runs), and prints per-pass index/scan timings.

Usage: python scripts/fused_profile.py [MBP] [table|fused|both]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from asgart_tpu.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

MBP = float(sys.argv[1]) if len(sys.argv) > 1 else 128.0
WHICH = sys.argv[2] if len(sys.argv) > 2 else "both"

from bench import synthetic_genome, complement_genome, make_strand  # noqa: E402
from asgart_tpu.pipeline import search_duplications  # noqa: E402
from asgart_tpu.structs import RunSettings  # noqa: E402
from asgart_tpu.exporters import JSONExporter  # noqa: E402
import io  # noqa: E402
import tempfile  # noqa: E402

n = int(MBP * 1e6)
rng = np.random.default_rng(1234)
t0 = time.time()
g = synthetic_genome(n, rng)
gc = complement_genome(g)
print(f"genome {MBP:.0f} Mbp: {time.time()-t0:.1f}s", flush=True)

settings = RunSettings(reverse=True, complement=True)


def run(fa, tag, engine_env):
    os.environ["ASGART_FUSED"] = engine_env
    prof = {}
    t0 = time.time()
    res = search_duplications([fa], settings, engine="tpu",
                              profile=prof)
    wall = time.time() - t0
    nsd = sum(len(f) for st in [res] for f in st.families)
    print(f"  {tag}: wall {wall:.2f}s index {prof.get('index_s')}s "
          f"scan {prof.get('scan_s')}s post {prof.get('post_s')}s "
          f"-> {n/1e6/wall:.1f} Mbp/s, {nsd} SDs", flush=True)
    return res


with tempfile.TemporaryDirectory() as td:
    fas = []
    for name, gg in (("a", g), ("b", gc)):
        fa = os.path.join(td, f"{name}.fa")
        with open(fa, "wb") as f:
            f.write(b">chr1\n")
            for off in range(0, n, 1 << 20):
                f.write(gg[off: off + (1 << 20)].tobytes())
                f.write(b"\n")
        fas.append(fa)

    outs = {}
    for env, tag in (("0", "table"), ("1", "fused")):
        if WHICH not in ("both", tag):
            continue
        print(f"[{tag}]", flush=True)
        run(fas[0], f"{tag} pass1 (cold-ish)", env)
        outs[tag, "a2"] = run(fas[0], f"{tag} pass2 rescan (warm svc)",
                              env)
        outs[tag, "b"] = run(fas[1], f"{tag} FRESH genome", env)

    if WHICH == "both":
        for key in ("a2", "b"):
            ba, bb = io.StringIO(), io.StringIO()
            JSONExporter().save(outs["table", key], ba)
            JSONExporter().save(outs["fused", key], bb)
            print(f"byte-equal [{key}]: {ba.getvalue() == bb.getvalue()}",
                  flush=True)
