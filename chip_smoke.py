"""Smoke test of the device engine on NVIDIA GPUs, end to end.

Everything runs in ONE process, the only one to open the card:

  phase 1  main path at real size: bench.py's synthetic chr1-like genome
           (128 Mbp, seed 1234) written as FASTA and searched with
           ``-R -C -k 20`` through the CLI and through
           ``pipeline.search_duplications`` on the device engine, then a
           warm rescan served from the device index cache. Every JSON is
           byte-equal to the host engine's, the planted families are
           found, and the route is a device engine;
  phase 2  the same genome with ``--shards 4`` (the window pipeline);
  phase 3  the index layer at 16 Mbp: ``DeviceIndex`` and ``FusedIndex``
           builds against the host ``PositionIndex``;
  phase 4  a route sweep at 8 Mbp: every device engine forced through
           its switch, each byte-equal to the host engine.

``--multi`` runs only the multi-device paths on every visible GPU (the
automatic probe-axis mesh, mesh windows, a rank-sharded window), each
against the host engine. ``--only N`` runs phase N alone; a fresh
process isolates that phase's peak device memory.

JAX is held to CUDA: without a GPU the script fails before any phase.
Any mismatch or error exits non-zero without a result line. The last
line of stdout is ``{"ok": true, "device": {...}}``.

Usage: python chip_smoke.py [--multi | --only N]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

SEED = 1234
MAIN_MBP = 128.0
INDEX_MBP = 16.0
SWEEP_MBP = 8.0
RC = dict(reverse=True, complement=True)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


@contextlib.contextmanager
def env(**kv):
    """Set (or, with None, unset) environment switches for a block."""
    old = {k: os.environ.get(k) for k in kv}
    try:
        for k, v in kv.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def json_text(result) -> str:
    from asgart_tpu.exporters import JSONExporter

    buf = io.StringIO()
    JSONExporter().save(result, buf)
    return buf.getvalue()


def search(fa: str, engine: str, **kw):
    """One library run; returns (result, JSON text, profile, seconds)."""
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings

    run_kw = {k: kw.pop(k) for k in ("shards", "checkpoint") if k in kw}
    prof: dict = {}
    t0 = time.time()
    result = search_duplications([fa], RunSettings(**kw), engine=engine,
                                 profile=prof, **run_kw)
    return result, json_text(result), prof, time.time() - t0


def device_route(prof: dict) -> str:
    route = prof.get("device_engine", "")
    check(route and "host" not in route.split(","),
          f"device run took no device engine (profile {prof})")
    return route


def memory(tag: str) -> dict:
    """Print peak device memory against the allocator limit."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        log(f"[{tag}] peak_bytes_in_use {stats['peak_bytes_in_use']} of "
            f"bytes_limit {stats['bytes_limit']}")
    else:
        log(f"[{tag}] device memory stats: not reported")
    return stats


def write_fasta(path: str, records) -> None:
    with open(path, "wb") as fh:
        for name, seq in records:
            fh.write(b">" + name.encode() + b"\n")
            fh.write(seq)
            fh.write(b"\n")


# --- phase 1/2: the main genome ----------------------------------------

def main_genome(workdir: str, mbp: float = MAIN_MBP, seed: int = SEED):
    """bench.py's synthetic chr1-like genome as FASTA; returns (path,
    planted families, length)."""
    import numpy as np

    from bench import synthetic_genome

    n = int(mbp * 1e6)
    planted: list = []
    t0 = time.time()
    g = synthetic_genome(n, np.random.default_rng(seed), planted)
    fa = os.path.join(workdir, "main.fa")
    write_fasta(fa, [("chr1", g.tobytes())])
    log(f"main genome: {n} bp, {len(planted)} planted families "
        f"({time.time() - t0:.1f}s)")
    return fa, planted, n


def intact_plants(planted, n: int):
    """Planted families whose two copies no later plant (nor the
    centromere-like N run at n/2) overwrote."""
    mid = (n // 2, n // 2 + 30_000)

    def hit(a, la, b, lb):
        return a < b + lb and b < a + la

    out = []
    for i, (src, dst, ln, rc) in enumerate(planted):
        later = [(d, l) for (_, d, l, _) in planted[i + 1:]] + \
            [(mid[0], mid[1] - mid[0])]
        if not any(hit(src, ln, d, l) or hit(dst, ln, d, l)
                   for d, l in later):
            out.append((src, dst, ln, rc))
    return out


def plants_found(result, plants) -> int:
    import numpy as np

    sds = [sd for fam in result.families for sd in fam]
    if not sds:
        return 0
    L = np.array([sd.global_left_position for sd in sds])
    LL = np.array([sd.left_length for sd in sds])
    R = np.array([sd.global_right_position for sd in sds])
    RL = np.array([sd.right_length for sd in sds])

    def over(a, la, b, lb):
        return (a < b + lb) & (b < a + la)

    found = 0
    for src, dst, ln, _ in plants:
        hit = (over(L, LL, src, ln) & over(R, RL, dst, ln)) | \
            (over(L, LL, dst, ln) & over(R, RL, src, ln))
        found += bool(hit.any())
    return found


def phase_main(fa: str, planted, n: int) -> dict:
    """Phase 1: CLI and library device runs, warm rescan, vs host."""
    from asgart_tpu.cli.main import main as cli_main

    host, host_json, _, t_host = search(fa, "host", probe_size=20, **RC)
    log(f"[1] host engine: {t_host:.2f}s, {len(host_json)} JSON bytes")

    out = os.path.join(os.path.dirname(fa), "main_cli.json")
    err = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli_main([fa, "-R", "-C", "-k", "20", "--engine", "tpu",
                       "--out", out, "--profile"])
    t_cli = time.time() - t0
    check(rc == 0, f"CLI exited {rc}: {err.getvalue()[-2000:]}")
    cli_prof = json.loads(next(ln for ln in err.getvalue().splitlines()
                               if ln.startswith("{")))
    with open(out) as fh:
        check(fh.read() == host_json, "CLI device JSON != host JSON")
    log(f"[1] CLI device (cold): {t_cli:.2f}s, route "
        f"{device_route(cli_prof)}, byte-equal")

    res, lib_json, prof, t_lib = search(fa, "tpu", probe_size=20, **RC)
    check(lib_json == host_json, "library device JSON != host JSON")
    log(f"[1] library device: {t_lib:.2f}s, route {device_route(prof)}, "
        f"byte-equal; profile {json.dumps(prof)}")
    _, warm_json, wprof, t_warm = search(fa, "tpu", probe_size=20, **RC)
    check(warm_json == host_json, "warm rescan JSON != host JSON")
    log(f"[1] warm rescan: {t_warm:.2f}s, route {device_route(wprof)}, "
        f"byte-equal; profile {json.dumps(wprof)}")

    # an -R -C run reports reverse-complemented duplications only
    plants = [p for p in intact_plants(planted, n) if p[3]]
    found = plants_found(res, plants)
    check(found == len(plants),
          f"planted RC families found: {found} of {len(plants)}")
    log(f"[1] planted RC families found: {found} of {len(plants)} "
        "intact")
    stats = memory("1")
    return {"route": prof["device_engine"], "stats": stats}


def phase_shards(fa: str, shards: int = 4) -> dict:
    """Phase 2: ``--shards`` windows, device vs host."""
    _, host_json, _, t_host = search(fa, "host", shards=shards, **RC)
    log(f"[2] host engine --shards {shards}: {t_host:.2f}s")
    _, dev_json, prof, t_dev = search(fa, "tpu", shards=shards, **RC)
    check(dev_json == host_json, f"--shards {shards} device JSON != host")
    log(f"[2] device --shards {shards}: {t_dev:.2f}s, route "
        f"{device_route(prof)}, byte-equal; profile {json.dumps(prof)}")
    _, warm_json, wprof, t_warm = search(fa, "tpu", shards=shards, **RC)
    check(warm_json == host_json, "warm --shards rescan JSON != host")
    log(f"[2] warm --shards {shards} rescan: {t_warm:.2f}s, byte-equal")
    return {"route": prof["device_engine"], "stats": memory("2")}


# --- phase 3: the index layer ------------------------------------------

def _windows(arr, lo, hi):
    """Concatenation of arr[lo[i]:hi[i]] over i."""
    import numpy as np

    lens = (hi - lo).astype(np.int64)
    starts = np.cumsum(lens) - lens
    idx = np.repeat(lo.astype(np.int64) - starts, lens) \
        + np.arange(int(lens.sum()), dtype=np.int64)
    return arr[idx]


def check_doubled_index(didx, pidx) -> None:
    """A doubled-text DeviceIndex against the host PositionIndex: each
    k-mer group lists its direct (first-half) suffixes first, in host
    suffix order; an appended position's window spans exactly its
    group's direct entries; direct positions carry empty windows."""
    import numpy as np

    sa_d, r_d = didx.to_host_arrays()
    sa_h, r_h = pidx.sa.astype(np.int64), pidx.ranges
    first = pidx.first_len
    check(didx.first_len == first and len(sa_d) == len(sa_h),
          "index shape differs")
    direct = sa_h < first
    group = r_h[sa_h, 0]
    order = np.lexsort((~direct, group))
    expect_sa = sa_h[order]
    is_dir = expect_sa < first
    check(np.array_equal(sa_d[is_dir], expect_sa[is_dir].astype(np.int32)),
          "direct suffix order differs")
    cumdir = np.concatenate([[0], np.cumsum(direct)])
    app = slice(first, None)
    ndir = cumdir[r_h[app, 1]] - cumdir[r_h[app, 0]]
    lo_d, hi_d = r_d[app, 0], r_d[app, 1]
    check(np.array_equal(hi_d - lo_d, ndir), "window sizes differ")
    live = ndir > 0
    check(np.array_equal(lo_d[live], r_h[app, 0][live]),
          "window starts differ")
    check(np.array_equal(r_d[:first, 0], r_d[:first, 1]),
          "direct positions carry non-empty windows")


def check_fused_index(fidx, pidx, data, settings) -> None:
    """FusedIndex lane windows against the host PositionIndex: every
    live lane is one probe, and its window lists the probe's direct
    matches in host suffix order."""
    import numpy as np

    from asgart_tpu.pipeline import probe_positions, transform_needle

    k = settings.probe_size
    step = k // 2
    first = pidx.first_len
    sa_h = pidx.sa.astype(np.int64)
    cumdir = np.concatenate([[0], np.cumsum(sa_h < first)])
    lane_lo = np.asarray(fidx.lane_lo).astype(np.int64)
    lane_hi = np.asarray(fidx.lane_hi).astype(np.int64)
    mask = np.asarray(fidx.lane_mask)
    sa_f = np.asarray(fidx.sa)
    for cs, cl, nc in fidx.specs:
        off = fidx.offs[(cs, cl)][0]
        needle = transform_needle(data[cs: cs + cl], settings.reverse,
                                  settings.complement)
        is_ = probe_positions(needle, k)
        lanes = off + is_ // step - 1
        live = np.zeros(len(mask), bool)
        live[lanes] = True
        check(np.array_equal(mask[off: off + nc], live[off: off + nc]),
              f"lane mask differs in chunk {cs}")
        x = pidx.probe_table_positions(cs, cl, is_)
        lo_h, hi_h = pidx.ranges[x, 0], pidx.ranges[x, 1]
        check(np.array_equal(lane_hi[lanes] - lane_lo[lanes],
                             cumdir[hi_h] - cumdir[lo_h]),
              f"lane window sizes differ in chunk {cs}")
        want = _windows(sa_h, lo_h, hi_h)
        check(np.array_equal(_windows(sa_f, lane_lo[lanes],
                                      lane_hi[lanes]),
                             want[want < first]),
              f"lane windows differ in chunk {cs}")


def phase_index(mbp: float = INDEX_MBP, seed: int = SEED) -> None:
    """Phase 3: device index builds against the host builder."""
    import numpy as np

    from asgart_tpu.device_engine import FusedEngine
    from asgart_tpu.device_index import DeviceIndex, FusedIndex
    from asgart_tpu.fasta import Strand, find_chunks_to_process
    from asgart_tpu.index import PositionIndex
    from asgart_tpu.structs import RunSettings, Start
    from bench import synthetic_genome

    n = int(mbp * 1e6)
    g = synthetic_genome(n, np.random.default_rng(seed))
    data = np.concatenate([g, np.frombuffer(b"$", dtype=np.uint8)])

    t0 = time.time()
    didx = DeviceIndex.build(data, 20)
    sa_d, r_d = didx.to_host_arrays()
    pidx = PositionIndex.build(data, 20)
    check(np.array_equal(sa_d, pidx.sa.astype(np.int32))
          and np.array_equal(r_d, pidx.ranges),
          "direct DeviceIndex differs from the host index")
    log(f"[3] DeviceIndex direct ({n} bp): sa, pos_lo, pos_hi bit-equal "
        f"({time.time() - t0:.2f}s)")
    del didx, pidx

    t0 = time.time()
    pidx = PositionIndex.build(data, 20, **RC)
    didx = DeviceIndex.build(data, 20, **RC)
    check_doubled_index(didx, pidx)
    log(f"[3] DeviceIndex -RC ({2 * n + 1} rows): equal to the host "
        f"index ({time.time() - t0:.2f}s)")
    del didx

    t0 = time.time()
    settings = RunSettings(probe_size=20, **RC)
    strand = Strand(file_names="index", data=data,
                    map=[Start("chr1", 0, n)])
    specs = FusedEngine(strand, settings)._specs_for(
        find_chunks_to_process(g))
    fidx = FusedIndex.build(data, 20, specs=specs, **RC)
    check_fused_index(fidx, pidx, data, settings)
    log(f"[3] FusedIndex -RC ({len(specs)} chunks): lane windows equal "
        f"to the host index ({time.time() - t0:.2f}s)")
    memory("3")


# --- phase 4: route sweep ----------------------------------------------

def sweep_genome(workdir: str, mbp: float = SWEEP_MBP, seed: int = 4242):
    """Planted direct and RC duplications, a satellite block (a raw-match
    explosion: the sliced dispatch), an N run that splits chunks and a
    soft-masked run."""
    import numpy as np

    n = int(mbp * 1e6)
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = rng.choice(acgt, n)
    comp = np.zeros(256, dtype=np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    d = max(n // 400, 1200)
    g[n // 2: n // 2 + d] = g[n // 400: n // 400 + d]
    src = g[2 * n // 400: 2 * n // 400 + d]
    g[3 * n // 4: 3 * n // 4 + d] = comp[src][::-1]
    unit = rng.choice(acgt, 40)
    sat = np.resize(unit, n // 20)
    g[n // 3: n // 3 + len(sat)] = sat
    g[n // 5: n // 5 + 6000] = ord("N")
    # soft-masked run holding one more planted copy
    m0 = 5 * n // 8
    g[m0: m0 + d] = g[n // 10: n // 10 + d]
    g[m0 - d: m0 + 2 * d] += 32  # lowercase
    fa = os.path.join(workdir, "sweep.fa")
    write_fasta(fa, [("chrS", g.tobytes())])
    return fa, n


def sweep_routes(n: int, workdir: str):
    """(name, settings, run options, switches, expected engine)."""
    trim = (n // 4, 3 * n // 4)
    fused_off = {"ASGART_FUSED": "0"}
    return [
        ("fused -RC", dict(RC), {}, {}, "FusedEngine"),
        ("fused direct", {}, {}, {}, "FusedEngine"),
        ("table -RC (ASGART_FUSED=0)", dict(RC), {}, fused_off,
         "DeviceEngine"),
        ("merge-join window --trim", dict(RC, trim=trim), {}, fused_off,
         "DeviceWindowEngine"),
        ("fused window --trim", dict(RC, trim=trim), {}, {},
         "FusedEngine"),
        ("big window --trim (ASGART_BIG_WINDOW=1)", dict(RC, trim=trim),
         {}, dict(fused_off, ASGART_BIG_WINDOW="1"), "BigWindowEngine"),
        ("fused k=24 (3-plane key)", dict(RC, probe_size=24), {}, {},
         "FusedEngine"),
        ("table k=24 (3-plane key)", dict(RC, probe_size=24), {},
         fused_off, "DeviceEngine"),
        ("--skip-masked", dict(RC, skip_masked=True), {}, {},
         "FusedEngine"),
        ("--checkpoint", dict(RC),
         {"checkpoint": os.path.join(workdir, "journal.jsonl")}, {},
         "DeviceEngine"),
        ("device chain (ASGART_DEVICE_CHAIN=1)", dict(RC), {},
         {"ASGART_DEVICE_CHAIN": "1"}, "FusedEngine"),
    ]


def phase_sweep(workdir: str, mbp: float = SWEEP_MBP) -> None:
    """Phase 4: every device engine, forced through its switch, against
    the host engine."""
    fa, n = sweep_genome(workdir, mbp)
    host: dict = {}
    for name, kw, opts, switches, expect in sweep_routes(n, workdir):
        key = json.dumps(kw, sort_keys=True)
        if key not in host:
            host[key] = search(fa, "host", **kw)[1]
        with env(**switches):
            _, dev_json, prof, t = search(fa, "tpu", **kw, **opts)
        route = device_route(prof)
        check(route == expect, f"{name}: route {route}, expected {expect}")
        check(dev_json == host[key], f"{name}: device JSON != host JSON")
        log(f"[4] {name}: {route}, byte-equal ({len(dev_json)} bytes, "
            f"{t:.2f}s)")
    memory("4")


# --- --multi: every visible device -------------------------------------

def phase_multi(fa: str, n: int) -> None:
    """Multi-device paths, each against the host engine: the automatic
    probe-axis mesh, MeshWindowEngine at 2 and 4 windows, and a
    rank-sharded window."""
    runs = [
        ("probe-axis mesh -RC", dict(RC), {}, "DeviceEngine"),
        ("--shards 2", dict(RC, shards=2), {}, "MeshWindowEngine"),
        ("--shards 4", dict(RC, shards=4), {}, "MeshWindowEngine"),
        ("rank-sharded window --trim", dict(RC, trim=(n // 4, 3 * n // 4)),
         {"ASGART_RANK_SHARDED": "1"}, "ShardedWindowEngine"),
    ]
    for name, kw, switches, expect in runs:
        _, host_json, _, t_host = search(fa, "host", **dict(kw))
        with env(**switches):
            _, dev_json, prof, t = search(fa, "tpu", **dict(kw))
        route = device_route(prof)
        check(route == expect, f"{name}: route {route}, expected {expect}")
        check(dev_json == host_json, f"{name}: device JSON != host JSON")
        log(f"[multi] {name}: {route}, byte-equal ({t:.2f}s device, "
            f"{t_host:.2f}s host)")
    memory("multi")


# --- entry point -------------------------------------------------------

def start_cuda(multi: bool):
    """Hold JAX to CUDA (no CPU fallback); one card unless ``multi``."""
    if not multi:
        vis = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = \
            vis.split(",")[0] if vis else "0"
    import jax

    from asgart_tpu.compile_cache import configure_compile_cache

    jax.config.update("jax_platforms", "cuda")
    configure_compile_cache()
    try:
        devs = jax.devices()
    except Exception as e:  # noqa: BLE001 — any backend start failure
        raise SystemExit(f"chip_smoke: JAX found no CUDA device ({e!r})")
    check(devs[0].platform == "gpu",
          f"JAX platform is {devs[0].platform}, not gpu")
    return jax, devs


def print_card(jax, devs) -> None:
    from asgart_tpu.device_index import hbm_budget_bytes

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    for line in smi.stdout.strip().splitlines():
        log(line)
    stats = devs[0].memory_stats() or {}
    log(f"jax {jax.__version__}; devices {devs}")
    log(f"bytes_limit {stats.get('bytes_limit')}; plan budget "
        f"hbm_budget_bytes() {hbm_budget_bytes()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-device paths, on every "
                         "visible GPU")
    ap.add_argument("--only", type=int, choices=[1, 2, 3, 4],
                    help="run one phase alone")
    args = ap.parse_args(argv)
    logging_to_stderr()
    jax, devs = start_cuda(args.multi)
    print_card(jax, devs)
    phases = {args.only} if args.only else {1, 2, 3, 4}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        t_all = time.time()
        if args.multi:
            check(len(devs) > 1, f"--multi needs several GPUs, have "
                                 f"{len(devs)}")
            fa, _, n = main_genome(work)
            phase_multi(fa, n)
        else:
            if phases & {1, 2}:
                fa, planted, n = main_genome(work)
            for p in sorted(phases):
                t0 = time.time()
                if p == 1:
                    phase_main(fa, planted, n)
                elif p == 2:
                    phase_shards(fa)
                elif p == 3:
                    phase_index()
                else:
                    phase_sweep(work)
                log(f"phase {p}: {time.time() - t0:.2f}s")
        log(f"all phases: {time.time() - t_all:.2f}s")
    dev = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devs)}}), flush=True)
    return 0


def logging_to_stderr() -> None:
    """Bind the package log to the real stderr before the CLI phase
    redirects it (the CLI's own basicConfig is then a no-op)."""
    import logging

    logging.basicConfig(level=logging.WARNING,
                        format="%(levelname)s - %(message)s",
                        stream=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
