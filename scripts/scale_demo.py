"""Device scale demo: end-to-end `engine=device` run at sizes beyond the
single-device table engine, exercising the scale ladder's `--shards` rung
(windowed merge-join device indexes, reference trim semantics).

Usage: python scripts/scale_demo.py [MBP] [SHARDS]
       python scripts/scale_demo.py build [MBP]   # index-build laps only
Env:   SCALE_HOST=1 also runs the host engine and compares JSON bytes.
       SCALE_RESCAN=1 runs a second (warm-service) device pass.
The `build` mode (with ASGART_DEVICE_PROFILE=1) profiles the on-device
whole-genome index build at bench scale: 3 passes, per-stage laps.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from asgart_tpu.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

if len(sys.argv) > 1 and sys.argv[1] == "build":
    # index-build profiling mode (ex scripts/didx_profile.py)
    from bench import synthetic_genome
    from asgart_tpu.device_index import DeviceIndex

    mbp = float(sys.argv[2]) if len(sys.argv) > 2 else 128.0
    n = int(mbp * 1e6)
    rng = np.random.default_rng(1234)
    t0 = time.time()
    g = synthetic_genome(n, rng)
    data = np.concatenate([g, np.frombuffer(b"$", dtype=np.uint8)])
    print(f"genome {mbp:.0f} Mbp: {time.time()-t0:.1f}s", flush=True)
    codes = DeviceIndex.upload_codes(data)
    jax.block_until_ready(codes)
    print("uploaded", flush=True)
    for p in range(3):
        t0 = time.time()
        idx = DeviceIndex.build(data, 20, reverse=True, complement=True,
                                codes_device=codes)
        jax.block_until_ready(idx.sa)
        print(f"pass {p}: {time.time()-t0:.2f}s", flush=True)
        del idx
    sys.exit(0)

MBP = float(sys.argv[1]) if len(sys.argv) > 1 else 512.0
SHARDS = int(sys.argv[2]) if len(sys.argv) > 2 else 2

from bench import synthetic_genome  # noqa: E402
from asgart_tpu.pipeline import search_duplications  # noqa: E402
from asgart_tpu.structs import RunSettings  # noqa: E402
from asgart_tpu.exporters import JSONExporter  # noqa: E402

n = int(MBP * 1e6)
rng = np.random.default_rng(4242)
t0 = time.time()
g = synthetic_genome(n, rng)
print(f"genome {MBP:.0f} Mbp synthetic: {time.time() - t0:.1f}s",
      flush=True)

import tempfile  # noqa: E402

with tempfile.TemporaryDirectory() as td:
    fa = os.path.join(td, "scale.fa")
    with open(fa, "wb") as f:
        f.write(b">chr_scale\n")
        for off in range(0, n, 1 << 20):
            f.write(g[off: off + (1 << 20)].tobytes())
            f.write(b"\n")

    settings = RunSettings(reverse=True, complement=True)

    def run(engine, shards):
        prof = {}
        t0 = time.time()
        res = search_duplications([fa], settings, engine=engine,
                                  shards=shards, profile=prof)
        dt = time.time() - t0
        nsd = sum(len(f) for f in res.families)
        print(f"{engine} shards={shards}: {dt:.1f}s -> "
              f"{MBP / dt:.2f} Mbp/s, {len(res.families)} families / "
              f"{nsd} SDs  prof={prof}", flush=True)
        return res, dt

    res_t, dt_t = run("tpu", SHARDS)
    if os.environ.get("SCALE_RESCAN") == "1":
        # warm-service regime: the multi-entry HBM index cache keeps
        # every window's index + persisted stage-1 join resident, so a
        # rescan runs scan + chain only
        res_r, dt_r = run("tpu", SHARDS)
        import io

        def _js(r):
            buf = io.StringIO()
            JSONExporter().save(r, buf)
            return buf.getvalue()

        print(f"rescan JSON byte-equal: {_js(res_r) == _js(res_t)}",
              flush=True)
    if os.environ.get("SCALE_HOST") == "1":
        res_h, dt_h = run("host", SHARDS)
        import io

        def js(r):
            buf = io.StringIO()
            JSONExporter().save(r, buf)
            return buf.getvalue()

        eq = js(res_t) == js(res_h)
        print(f"JSON byte-equal: {eq}", flush=True)
