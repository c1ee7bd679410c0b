"""Cost-model probe for the FUSED index build.

Measures on the device the pieces of the proposed fused-probe build
(direct-text rows co-sorted with probe-lane rows in one flagged sort):

  1. 3-operand sort at 141M rows (n1 + B) vs the current 256M (2*n1);
  2. decimation of the APPENDED half only (n1 rows) vs the full doubled
     text, via the existing block-sort `_decimate_codes`;
  3. a blocked-TRANSPOSE decimation variant (bounded padding);
  4. inversion-style 3-op sort at 141M rows.

Usage: python scripts/probe_fused.py [MBP]
"""
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from asgart_tpu.compile_cache import configure_compile_cache  # noqa: E402

configure_compile_cache()

from asgart_tpu.device_index import _decimate_codes  # noqa: E402

I32 = jnp.int32
MBP = float(sys.argv[1]) if len(sys.argv) > 1 else 128.0
n1 = int(MBP * 1e6) + 1
B = n1 // 10 + (1 << 20)
n = 2 * n1 - 1
M = n1 + B


def _force(out):
    jax.block_until_ready(out)


def lap(tag, f, *args, reps=3):
    out = f(*args)  # compile
    _force(out)
    ts = []
    for _ in range(reps):
        t0 = time.time()
        out = f(*args)
        _force(out)
        ts.append(time.time() - t0)
    print(f"{tag}: {min(ts):.3f}s (reps {['%.3f' % t for t in ts]})",
          flush=True)
    return out


@functools.partial(jax.jit, static_argnames=("rows",))
def mk(rows: int):
    kh = jnp.arange(rows, dtype=I32) * jnp.int32(-1640531535) >> 2
    kl = (jnp.arange(rows, dtype=I32) * jnp.int32(40503)) >> 1
    return kh, kl


def sort3(kh, kl):
    return jax.lax.sort((kh, kl, jnp.arange(kh.shape[0], dtype=I32)),
                        num_keys=2)


print(f"n1={n1} B={B} M=n1+B={M} n=2n1-1={n}", flush=True)

for rows, tag in ((M, "fused (n1+B)"), (n, "doubled (2n1)")):
    kh, kl = mk(rows)
    jax.block_until_ready((kh, kl))
    lap(f"3-op sort {tag} {rows} rows",
        jax.jit(sort3), kh, kl)

# decimation: block-sort (current) at n1 vs n rows
codes_n1 = jnp.ones(n1 + 20, dtype=jnp.uint8)
codes_n = jnp.ones(n + 20, dtype=jnp.uint8)
step = 10
L1 = ((n1 + 64 + step - 1) // step) * step
L2 = ((n + 64 + step - 1) // step) * step
dec_jit = jax.jit(_decimate_codes, static_argnames=("step", "L", "n"))
lap(f"block-sort decimate n1 ({n1})", lambda: dec_jit(
    codes_n1, step=step, L=L1, n=n1))
lap(f"block-sort decimate 2n1 ({n})", lambda: dec_jit(
    codes_n, step=step, L=L2, n=n))


# blocked-transpose decimation: [Bb/step, step] -> [step, Bb/step]
# transposes on bounded blocks (padding is bounded by the block size)
def _dec_transpose(codes, step: int, L: int, n: int,
                   blk: int = 1 << 24):
    C = L // step
    out = jnp.zeros(L, dtype=codes.dtype)
    Bb = (blk // step) * step
    b0 = 0
    while b0 < n:
        nb = min(Bb, n - b0)
        nbp = ((nb + step - 1) // step) * step
        t = jnp.zeros(nbp, codes.dtype).at[:nb].set(
            jax.lax.dynamic_slice(codes, (b0,), (nb,)))
        tt = t.reshape(nbp // step, step).T.reshape(-1)  # [step, Cb]
        q0 = b0 // step
        Cb = nbp // step
        for r in range(step):
            out = jax.lax.dynamic_update_slice(
                out, jax.lax.dynamic_slice(tt, (r * Cb,), (Cb,)),
                (r * C + q0,))
        b0 += nb
    return out


dect_jit = jax.jit(_dec_transpose, static_argnames=("step", "L", "n"))
lap(f"blocked-transpose decimate n1 ({n1})", lambda: dect_jit(
    codes_n1, step=step, L=L1, n=n1))

# inversion-style: key = permutation-ish, 2 payloads
kh, kl = mk(M)
perm = lap("perm-gen", jax.jit(
    lambda kh, kl: sort3(kh, kl)[2]), kh, kl)


def inv3(perm, a, b):
    p = jax.lax.optimization_barrier(perm)
    return jax.lax.sort((p, a, b), num_keys=1)


lap(f"3-op inversion sort {M} rows", jax.jit(inv3), perm, kh, kl)
