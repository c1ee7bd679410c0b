"""On-device probe: doubling round schedule for the fused build.

Compares the current schedule (4 rounds/call at cap <= 2^22) against a
2-round first call (earlier cap shrink costs one extra sync but runs
fewer rounds at the big cap). Usage: python scripts/rounds_probe.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

from asgart_tpu.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from bench import synthetic_genome, complement_genome  # noqa: E402
import asgart_tpu.device_index as di  # noqa: E402

n = int(128e6)
rng = np.random.default_rng(1234)
g = synthetic_genome(n, rng)
variants = [g, complement_genome(g)]

specs_for = []


def build(data, rpc):
    from asgart_tpu.fasta import find_chunks_to_process

    chunks = find_chunks_to_process(data[:-1])
    k = 20
    step = 10
    specs = tuple((int(c[0]), int(c[1]),
                   (c[1] - k - step + step - 1) // step)
                  for c in chunks)
    t0 = time.time()
    idx = di.FusedIndex.build(data, 20, specs=specs, reverse=True,
                              complement=True, rounds_per_call=rpc)
    jax.block_until_ready(idx.sa)
    return time.time() - t0, idx


for bigcap in (1 << 22, 1 << 20, 1 << 19):
    os.environ["ASGART_ROUNDS_BIGCAP"] = str(bigcap)
    for i, gg in enumerate(variants):
        data = np.concatenate([gg, np.frombuffer(b"$", dtype=np.uint8)])
        t, idx = build(data, 2)
        print(f"bigcap=2^{bigcap.bit_length()-1} genome {i}: build {t:.2f}s", flush=True)
        del idx
        di._DEVICE_INDEX_CACHE.clear()
        di._FUSED_DEC_CACHE.clear()
