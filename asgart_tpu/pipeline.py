"""End-to-end search pipeline: prepare → index → probe/chain → post → result.

Orchestrates the equivalent of the reference's Step chain
(``src/bin/asgart.rs:731-822``). Probe-lookup strategies (all exact):

  * direct runs — single-text position index, one table gather per probe;
  * R/C/RC on the host — single-text index + parallel bucketed
    equal-range over the retained sorted keys;
  * R/C/RC on the device (``engine="tpu"``) — doubled-text position
    index, probe ranges by device gather (the mesh-scaling attach point);
  * ``--trim`` windows — packed-k-mer binary search over the windowed
    suffix array, like the reference's trim workflow.

Chaining always runs in the native automaton (bit-identical to the
Python oracle in ``asgart_tpu.automaton``).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import numpy as np

from . import native, postprocess
from .fasta import Strand, prepare_data
from .index import (CODE, MAX_PROBE_SIZE, ByteIndex, GenomeIndex, PositionIndex)
from .structs import (ProtoSD, RunResult, RunSettings, SD, StrandResult)
from .utils import complemented

log = logging.getLogger("asgart")


def _record_engine(prof: dict, name: str,
                   host_route: Optional[str] = None) -> None:
    """Note in the run profile which engine served the run (sharded
    runs list each distinct window engine once, in window order), and
    why a device run was planned onto the host engine."""
    names = prof.get("device_engine")
    if not names:
        prof["device_engine"] = name
    elif name not in names.split(","):
        prof["device_engine"] = f"{names},{name}"
    if host_route:
        prof["host_route"] = host_route


def _engine_name(dev) -> str:
    """Profile name of a device engine; a fused engine whose build bailed
    out to a classic engine shows both (``FusedEngine->DeviceEngine``)."""
    name = type(dev).__name__
    delegate = getattr(dev, "_delegate", None)
    return f"{name}->{type(delegate).__name__}" if delegate else name


def probe_positions(needle: np.ndarray, probe_size: int) -> np.ndarray:
    """Needle indices probed by the automaton: ``i = step, 2*step, …`` while
    ``i < len - probe - step`` pre-increment (automaton.rs:90-97), minus
    probes starting with 'N' (automaton.rs:100-102)."""
    step = probe_size // 2
    bound = len(needle) - probe_size - step
    if bound <= 0:
        return np.zeros(0, dtype=np.int64)
    last = ((bound - 1) // step) * step + step  # largest i reached
    is_ = np.arange(step, last + 1, step, dtype=np.int64)
    return is_[needle[is_] != ord("N")]


def transform_needle(chunk: np.ndarray, reverse: bool,
                     complement: bool) -> np.ndarray:
    """R/C needle transform (asgart.rs:206-218): complement first, then
    reverse."""
    needle = chunk
    if complement:
        needle = complemented(needle)
    if reverse:
        needle = needle[::-1]
    return np.ascontiguousarray(needle)


def _pack_probe_kmers(needle_codes_padded: np.ndarray, is_: np.ndarray,
                      k: int) -> np.ndarray:
    out = np.zeros(len(is_), dtype=np.int64)
    for j in range(k):
        out <<= 3
        out |= needle_codes_padded[is_ + j].astype(np.int64)
    return out


def raw_families_to_protosds(raw_families, s: RunSettings, start: int,
                             length: int) -> list[list[ProtoSD]]:
    """Chunk-engine output → ProtoSDs in global coordinates with
    direction flags stamped (coordinate fixup, asgart.rs:229-253)."""
    families = []
    for fam in raw_families:
        family = []
        for (left, right, llen, rlen) in fam:
            if not s.reverse:
                left = left + start
            else:
                left = start + length - left - llen
            family.append(ProtoSD(
                left=left, right=right,
                left_length=llen, right_length=rlen,
                identity=0.0,
                reversed=s.reverse, complemented=s.complement))
        families.append(family)
    return families


class SearchEngine:
    """Seed lookup + chaining over one prepared strand (see the module
    docstring for the strategy matrix)."""

    def __init__(self, strand: Strand, settings: RunSettings,
                 trim: Optional[tuple[int, int]], engine: str = "host",
                 attach_device: bool = True,
                 index_cache: Optional[str] = None):
        self.strand = strand
        self.settings = settings
        self.engine = engine
        t0 = time.time()
        self.pidx: Optional[PositionIndex] = None
        self.index: Optional[GenomeIndex] = None
        self.bidx: Optional[ByteIndex] = None
        transformed = settings.reverse or settings.complement
        if settings.probe_size > MAX_PROBE_SIZE:
            # wide probes: full SA + byte-compare equal-range (the
            # reference's own strategy for arbitrary k); host engine
            if engine == "tpu":
                log.warning("probe_size > %d runs on the host engine",
                            MAX_PROBE_SIZE)
            self.bidx = ByteIndex.build(
                strand.data, settings.probe_size, trim=trim,
                n_threads=settings.threads_count or 0)
        elif trim is None and index_cache is not None and engine != "tpu":
            # one cached single-text index serves every run mode
            self.pidx = PositionIndex.build_single_cached(
                strand.data, settings.probe_size, index_cache,
                n_threads=settings.threads_count or 0)
        elif trim is None:
            if engine == "tpu" or not transformed:
                # table strategy: every probe is one gather (device-ready);
                # direct runs need no appended half
                self.pidx = PositionIndex.build(
                    strand.data, settings.probe_size,
                    reverse=settings.reverse,
                    complement=settings.complement,
                    n_threads=settings.threads_count or 0)
            else:
                # host fast path for R/C/RC: single text + batched search
                self.pidx = PositionIndex.build_single(
                    strand.data, settings.probe_size,
                    n_threads=settings.threads_count or 0)
        else:
            self.index = GenomeIndex.build(
                strand.data, settings.probe_size, trim=trim)
        log.debug("Index built in %.2fs", time.time() - t0)
        self._device = None
        if engine == "tpu" and attach_device and self.bidx is None:
            # (wide probes run fully on the host: no device attachment)
            if self.pidx is not None:
                from .seed import DevicePositionTables
                self._device = DevicePositionTables(self.pidx)
            elif settings.probe_size * 3 <= 60:
                from .seed import DeviceSeedIndex
                self._device = DeviceSeedIndex(self.index)
            else:
                # k=21 exceeds the two-plane device packing: host lookup
                log.warning("probe_size %d trim lookup runs on the host",
                            settings.probe_size)

    def run_chunk(self, chunk: tuple[int, int]) -> list[list[ProtoSD]]:
        """Search one chunk; returns families in global coordinates with
        direction flags stamped (asgart.rs:201-253)."""
        s = self.settings
        start, length = chunk
        needle = transform_needle(
            self.strand.data[start: start + length], s.reverse, s.complement)

        if len(needle) < s.min_duplication_length:
            return []

        is_ = probe_positions(needle, s.probe_size)
        if len(is_) == 0:
            return []

        k = s.probe_size
        transformed = s.reverse or s.complement
        if self.bidx is not None:
            padded = np.zeros(len(needle) + k, dtype=np.uint8)
            padded[:len(needle)] = needle
            lo, hi = self.bidx.lookup_needle(
                padded, is_, n_threads=s.threads_count or 0)
            sa = self.bidx.sa
            max_match_pos = 1 << 62
        elif self.pidx is not None:
            needs_search = transformed and not (
                self.pidx.reverse or self.pidx.complement)
            if needs_search:
                # single-text strategy: transformed probes by value
                pk = native.pack_at(CODE[needle], k, is_,
                                    s.threads_count or 0)
                lo, hi = self.pidx.search_ranges(
                    pk, s.threads_count or 0)
            elif self._device is not None:
                x = self.pidx.probe_table_positions(start, length, is_)
                lo, hi = self._device.gather_ranges(x)
            else:
                lo, hi = self.pidx.probe_ranges(start, length, is_)
            sa = self.pidx.sa
            max_match_pos = self.pidx.first_len - 1
        else:
            codes = np.zeros(len(needle) + k, dtype=np.uint8)
            codes[:len(needle)] = CODE[needle]
            probe_kmers = _pack_probe_kmers(codes, is_, k)
            if self._device is not None:
                lo, hi = self._device.lookup(probe_kmers)
            else:
                lo, hi = self.index.lookup(probe_kmers)
            sa = self.index.sa
            max_match_pos = 1 << 62

        raw_families = native.chain(
            sa, is_, lo, hi,
            probe_size=s.probe_size,
            step_size=s.probe_size // 2,
            max_gap_size=s.max_gap_size,
            min_duplication_length=s.min_duplication_length,
            max_cardinality=s.max_cardinality,
            needle_offset=start,
            needle_len=len(needle),
            reverse=s.reverse,
            max_match_pos=max_match_pos,
        )

        return raw_families_to_protosds(raw_families, s, start, length)


def _window_pipeline_headroom(n1: int, W: int, settings) -> bool:
    """Whether the NEXT window's device phase (build/stage-1 peak) can
    be dispatched while the previous window's tail (downloads + chain)
    is still in flight. Projected against :func:`device_index
    .hbm_free_estimate` (which already accounts every tracked cache);
    the in-flight window's scan outputs are untracked — covered by a
    1 GB slack. When short, the driver waits for the tail first — the
    serial order, never an OOM for overlap's sake."""
    from .device_engine import fused_window_applicable
    from .device_index import (FUSED_PEAK_BYTES_PER_ROW,
                               WINDOW_PEAK_BYTES_PER_ROW,
                               device_index_cache_enabled,
                               hbm_free_estimate)

    step = max(1, settings.probe_size // 2)
    b = n1 // step + (1 << 21)
    doubled = settings.reverse or settings.complement
    if fused_window_applicable(n1, W, settings):
        peak = FUSED_PEAK_BYTES_PER_ROW * (W + b) + 3 * n1
    else:
        peak = WINDOW_PEAK_BYTES_PER_ROW * (W + b) \
            + (2 * n1 if doubled else n1)
    if not device_index_cache_enabled():
        # the in-flight window's resident arrays sit in NO tracked
        # cache (the tail closure keeps them alive) — account them
        peak += 13 * W + 9 * b
    return hbm_free_estimate() >= peak + (1 << 30)


def _window_tail(tail, strand, settings) -> RunResult:
    """Host tail of one pipelined window: block on the deferred
    downloads + chain, then run the post-processing Step chain."""
    fams: list[list[ProtoSD]] = []
    for chunk_fams in tail():
        fams.extend(chunk_fams)
    return _finalize_result(fams, strand, settings)


def _run_device_windows_pipelined(windows, to_process, strand, settings,
                                  codes_dev, prof: dict) -> list:
    """Two-stage pipeline over a sharded run's trim windows: the main
    thread runs each window's DEVICE phase (index build or device-cache
    hit, stage 1, scan dispatches — strictly in window order), while
    ONE tail thread runs the previous window's HOST phase (event
    downloads, native chaining, the post-processing Steps). The device
    work of window w+1 overlaps the host work of window w; byte-equal
    to the serial driver — same windows, same order, same per-window
    finalization (reference trim semantics, asgart.rs:433-463).

    A window whose dispatch or tail raises fails the run.
    ``ASGART_WINDOW_PIPELINE=0`` restores the fully serial window loop."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    n1 = int(len(strand.data))
    futs: list = []
    with ThreadPoolExecutor(max_workers=1) as tail_ex:
        for w in windows:
            W = int(w[1]) - int(w[0]) + 1
            if futs and not _window_pipeline_headroom(n1, W, settings):
                futs[-1].result()  # serialize under memory pressure
            s = dataclasses.replace(settings, trim=w)
            se = _DeviceEngineAdapter(strand, s, trim=w,
                                      codes_device=codes_dev,
                                      chunks=to_process)
            _record_engine(prof, _engine_name(se.dev))
            tail = se.run_chunks_deferred(to_process)
            futs.append(tail_ex.submit(_window_tail, tail, strand, s))
        return [f.result() for f in futs]


def _search_duplications_sharded(
    strands_files: list[str],
    settings: RunSettings,
    shards: int,
    engine: str = "host",
    profile: Optional[dict] = None,
) -> RunResult:
    """Index-sharded run: the automated version of the reference's manual
    scale-out (``--trim`` windows + ``asgart-slice`` merge,
    asgart.rs:142-148,433-463 + structs.rs:114-141 + README v2.0 notes).

    The genome is split into ``shards`` equal trim windows; each window
    gets its own (1/N-sized) index while the whole genome is probed
    against it, and the per-window families are concatenated in window
    order — exactly what ``RunResult.from_files`` does with sequential
    partial runs, so the output is byte-equal to that workflow. Windows
    run concurrently (the native index build and chain release the GIL).
    On a multi-host deployment each window maps to one host; within a
    host the device engine's probe-axis mesh sharding composes with it.
    """
    from concurrent.futures import ThreadPoolExecutor

    prof = profile if profile is not None else {}
    t0 = time.time()
    _, to_process, strand = prepare_data(
        strands_files, settings.skip_masked, None)
    total_len = int(len(strand.data)) - 1  # drop '$'
    per = (total_len + shards - 1) // shards
    windows = [(w * per, min(total_len, (w + 1) * per))
               for w in range(shards)]
    windows = [w for w in windows if w[0] < w[1]]
    prof["prepare_s"] = round(time.time() - t0, 3)

    from .device_index import DEVICE_MAX_K

    if engine == "tpu" and settings.probe_size <= DEVICE_MAX_K:
        # composed (windows x probes) mesh: the index sharded across the
        # devices' HBM, every window scanned in one SPMD dispatch per
        # chunk — byte-equal to the sequential trim+merge workflow
        import jax

        n_dev = len(jax.devices())
        if n_dev > 1 and n_dev >= len(windows) \
                and n_dev % len(windows) == 0:
            from jax.sharding import Mesh

            from .device_engine import MeshWindowEngine

            S = len(windows)
            mesh = Mesh(np.array(jax.devices()).reshape(S, n_dev // S),
                        ("windows", "probes"))
            t0 = time.time()
            eng = MeshWindowEngine(strand, settings, windows, mesh,
                                   profile=prof)
            _record_engine(prof, "MeshWindowEngine")
            raw_by_window = eng.run_windows(to_process)
            prof["scan_s"] = round(time.time() - t0, 3)
            merged = None
            for raws in raw_by_window:
                fams: list[list[ProtoSD]] = []
                for chunk, raw in zip(to_process, raws):
                    fams.extend(raw_families_to_protosds(
                        raw, settings, chunk[0], chunk[1]))
                r = _finalize_result(fams, strand, settings)
                if merged is None:
                    merged = r
                else:
                    merged.families.extend(r.families)
            merged.settings = settings
            return merged

    # one codes upload serves every device window
    codes_dev = None
    if engine == "tpu" and settings.probe_size <= DEVICE_MAX_K:
        from .device_index import upload_codes_cached

        codes_dev = upload_codes_cached(strand.data)

    def run_window(w):
        import dataclasses

        s = dataclasses.replace(settings, trim=w)
        wprof: dict = {}
        # the strand is already parsed (window planning above): windows
        # reuse it instead of re-reading the FASTA per window (read-only
        # numpy, safe across the window threads)
        r = search_duplications(strands_files, s, engine=engine,
                                profile=wprof,
                                _prepared=(to_process, strand),
                                _codes_device=codes_dev)
        return r, wprof

    if engine == "tpu" and windows:
        from .device_engine import fused_window_applicable
        from .device_index import device_window_fits

        per_w = max(we - ws for ws, we in windows) + 1
        doubled = settings.reverse or settings.complement
        if 2 * total_len + 1 < (1 << 31) \
                and not device_window_fits(total_len + 1, per_w, doubled,
                                           k=settings.probe_size) \
                and not fused_window_applicable(total_len + 1, per_w,
                                                settings) \
                and not rank_sharded_window_applies(
                    total_len + 1, per_w, doubled,
                    k=settings.probe_size):
            # capacity planning: a single window of this size + the
            # whole-genome probe side would overrun one device mid-run;
            # the host engine produces byte-identical windows (same
            # trim semantics). (Beyond int32 doubled addressing the
            # BigWindowEngine takes over with its own budgeting.)
            log.warning(
                "--shards %d gives %d-row device windows that exceed "
                "the device memory budget; running the windows on the "
                "byte-equal host engine (use more shards for the device "
                "path)", shards, per_w)
            _record_engine(prof, "host", "windows exceed the device "
                           "memory budget")
            engine = "host"

    t0 = time.time()
    _pipe_ok = False
    if engine == "tpu" and windows \
            and os.environ.get("ASGART_WINDOW_PIPELINE", "1") != "0":
        from .device_engine import fused_window_applicable
        from .device_index import DEVICE_MAX_K

        per_w = max(we - ws for ws, we in windows) + 1
        _pipe_ok = settings.probe_size <= DEVICE_MAX_K \
            or fused_window_applicable(total_len + 1, per_w, settings)
    if _pipe_ok:
        # two-stage window pipeline: window w's host tail (downloads +
        # chain + finalize) overlaps window w+1's device phase; the
        # headroom check serializes under memory pressure (see
        # _run_device_windows_pipelined)
        results = _run_device_windows_pipelined(
            windows, to_process, strand, settings, codes_dev, prof)
    else:
        # device windows serialize: on a single device, concurrent
        # windows would hold several window indexes + their merge-join
        # co-sort transients in one memory at once; device work queues
        # on the device anyway, so full-window concurrency only buys
        # host-side overlap. Host windows keep the thread-pool fan-out.
        workers = 1 if engine == "tpu" else min(len(windows),
                                                os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            results = []
            for r, wprof in ex.map(run_window, windows):
                results.append(r)
                if "device_engine" in wprof:
                    for name in wprof["device_engine"].split(","):
                        _record_engine(prof, name, wprof.get("host_route"))
    prof["scan_s"] = round(time.time() - t0, 3)

    merged = results[0]
    for r in results[1:]:
        merged.families.extend(r.families)
    merged.settings = settings  # the user's settings, not a window's
    return merged


def rank_sharded_window_applies(n1: int, W: int, doubled: bool,
                                n_dev: int | None = None,
                                k: int = 20) -> bool:
    """Whether a trim window should be served by the rank-sharded
    engine: forced via ``ASGART_RANK_SHARDED=1``, or the window exceeds
    a single device (rows or HBM) while a multi-device mesh can hold it
    at ~12 B/row per shard plus bounded scan transients."""
    import jax

    from .device_index import device_window_fits, hbm_budget_bytes

    if os.environ.get("ASGART_RANK_SHARDED") == "1":
        return True
    if n_dev is None:
        n_dev = len(jax.devices())
    if n_dev < 2 or device_window_fits(n1, W, doubled, k=k):
        return False
    per_shard = 12 * (-(-W // n_dev)) + (1 << 28)
    return per_shard <= hbm_budget_bytes()


def _select_device_engine(strand, settings, profile, codes_device, trim,
                          allow_fused, chunks):
    """The device engine that serves one run (or one trim window)."""
    from .device_engine import (BigWindowEngine, DeviceEngine,
                                DeviceWindowEngine, FusedEngine,
                                fused_applicable,
                                fused_window_applicable)
    from .device_index import (device_index_fits,
                               device_window_whole_fits)

    if trim is None and allow_fused and fused_applicable(
            len(strand.data), settings):
        # the probe join fused into the index build: two
        # (n1 + B)-row sorts instead of the doubled design's two
        # 2*n1-row ones, and no stage-1 join (device_engine
        # .FusedEngine); byte-equal, and it fits genomes the
        # doubled-table build cannot (~46 B vs ~84 B per bp)
        dev = FusedEngine(strand, settings, profile=profile,
                          codes_device=codes_device)
        if chunks is not None:
            dev._ensure(chunks)  # eager: index_s attribution
        return dev
    if trim is not None and allow_fused and fused_window_applicable(
            len(strand.data),
            int(trim[1]) - int(trim[0]) + 1, settings):
        # windowed fused build: stage 1 fused into the window sort;
        # also the ONLY device path for k = 21..30 trim windows
        # (the merge-join engines are 2-plane)
        dev = FusedEngine(strand, settings, profile=profile,
                          codes_device=codes_device, trim=trim)
        if chunks is not None:
            dev._ensure(chunks)
        return dev
    if trim is None and not device_index_fits(
            len(strand.data), settings.reverse, settings.complement) \
            and device_window_whole_fits(len(strand.data)):
        # big-genome strategy: the whole genome as ONE trim window —
        # a W = n1 row index (the doubled-table sort at 2*n1 rows is
        # the first thing to outgrow the device) with merge-join probe
        # ranges per chunk. Output is identical to the whole-genome
        # run: a window covering the entire text has the reference's
        # untrimmed semantics (direct-suffix order is the same in
        # both texts — the unique '$' decides every comparison), and
        # `settings` stays untrimmed for the JSON.
        log.info("whole-genome table index exceeds the memory budget; "
                 "using the one-window merge-join device engine")
        trim = (0, int(len(strand.data)) - 1)
    if trim is not None:
        from .device_index import DEVICE_MAX_K

        if settings.probe_size > DEVICE_MAX_K:
            # windowed engines are 2-plane (k <= 20); the pipeline
            # routes wider probes to the host engine before ever
            # building an adapter — this guards direct construction
            raise ValueError(
                f"device window engines support probe_size <= "
                f"{DEVICE_MAX_K}; use the host engine")
        n1 = int(len(strand.data))
        doubled = (2 * n1 - 1
                   if (settings.reverse or settings.complement)
                   else n1)
        W = int(trim[1]) - int(trim[0]) + 1
        if rank_sharded_window_applies(n1, W,
                                       settings.reverse
                                       or settings.complement,
                                       k=settings.probe_size):
            # window larger than one device (rows or memory) but a
            # mesh is present: the index lives sharded across it
            from .device_engine import ShardedWindowEngine

            return ShardedWindowEngine(strand, settings, trim,
                                       profile=profile)
        if (doubled >= (1 << 31)
                or os.environ.get("ASGART_BIG_WINDOW") == "1"):
            # genome beyond int32 doubled-text addressing (e.g.
            # whole human genome -RC): window-relative engine with
            # per-chunk needle uploads
            return BigWindowEngine(strand, settings, trim,
                                   profile=profile)
        return DeviceWindowEngine(strand, settings, trim,
                                  profile=profile,
                                  codes_device=codes_device)
    return DeviceEngine(strand, settings, profile=profile,
                        codes_device=codes_device)


class _DeviceEngineAdapter:
    """Pipeline-facing wrapper of the device engines
    (:mod:`asgart_tpu.device_engine`), same ``run_chunk`` contract as
    SearchEngine. The engine class it built is recorded in the run
    profile as ``device_engine``."""

    def __init__(self, strand, settings, profile=None,
                 codes_device=None, trim=None, allow_fused=True,
                 chunks=None):
        self.settings = settings
        self.dev = _select_device_engine(strand, settings, profile,
                                         codes_device, trim, allow_fused,
                                         chunks)
        if profile is not None:
            _record_engine(profile, _engine_name(self.dev))

    def run_chunk(self, chunk):
        start, length = chunk
        raw = self.dev.run_chunk(chunk)
        return raw_families_to_protosds(raw, self.settings, start, length)

    def run_chunks(self, chunks):
        """Pipelined multi-chunk execution (device dispatch of chunk i+1
        overlaps chunk i's downloads)."""
        raws = self.dev.run_chunks(chunks)
        return [raw_families_to_protosds(raw, self.settings, c[0], c[1])
                for raw, c in zip(raws, chunks)]

    def run_chunks_deferred(self, chunks):
        """Split execution for the sharded window pipeline: enqueue
        every chunk's device work NOW (index build / cache hit +
        stage 1 + scan dispatches), return a closure that blocks on
        the downloads and chains — the driver runs it on a tail thread
        overlapped with the next window's device phase."""
        st = self.dev.dispatch_chunks(chunks)

        def tail():
            raws = self.dev.collect_chunks(st, chunks)
            return [raw_families_to_protosds(raw, self.settings,
                                             c[0], c[1])
                    for raw, c in zip(raws, chunks)]

        return tail


def search_duplications(
    strands_files: list[str],
    settings: RunSettings,
    engine: str = "host",
    checkpoint: Optional[str] = None,
    profile: Optional[dict] = None,
    index_cache: Optional[str] = None,
    shards: int = 1,
    _prepared=None,
    _codes_device=None,
) -> RunResult:
    """The full pipeline (asgart.rs:731-822).

    ``checkpoint``: path of a JSONL journal; completed chunks are appended
    as they finish and skipped on a rerun with the same inputs/settings
    (crash/preemption recovery — the reference's only resumability is the
    manual trim workflow). ``profile``: dict to fill with phase timings.
    """
    if not (1 <= settings.probe_size <= 10000):
        raise ValueError(
            f"probe_size {settings.probe_size} is out of range (1..10000)")
    if shards > 1:
        if settings.trim is not None:
            raise ValueError("--shards cannot be combined with --trim")
        if checkpoint is not None:
            log.warning("--checkpoint is not supported with --shards; "
                        "windows restart from scratch on failure")
        if index_cache is not None:
            log.warning("--index-cache applies to whole-genome indexes "
                        "only and is ignored with --shards")
        return _search_duplications_sharded(
            strands_files, settings, shards, engine=engine,
            profile=profile)
    total = time.time()
    prof = profile if profile is not None else {}
    log.info("Preprocessing data")
    t0 = time.time()
    if _prepared is not None:
        # sharded runs parse once and hand each window the strand
        # (settings.trim windows are pre-validated by the planner)
        to_process, strand = _prepared
        trim = settings.trim
    else:
        trim, to_process, strand = prepare_data(
            strands_files, settings.skip_masked, settings.trim)
    prof["prepare_s"] = round(time.time() - t0, 3)

    # checkpoint journal: header identifies the run; completed chunks are
    # keyed by their (start, length)
    ckpt_done: dict = {}
    ckpt_fh = None
    if checkpoint is not None:
        import json as _json

        header = {"files": strands_files,
                  "settings": settings.to_json_obj(),
                  "reverse": settings.reverse,
                  "complement": settings.complement}
        if os.path.exists(checkpoint):
            with open(checkpoint) as fh:
                lines = fh.read().splitlines()
            if lines and _json.loads(lines[0]) == header:
                for line in lines[1:]:
                    rec = _json.loads(line)
                    ckpt_done[tuple(rec["chunk"])] = rec["families"]
                log.info("checkpoint: %d chunks already done",
                         len(ckpt_done))
            else:
                log.warning("checkpoint mismatch; starting fresh")
        ckpt_fh = open(checkpoint, "a" if ckpt_done else "w")
        if not ckpt_done:
            ckpt_fh.write(_json.dumps(header) + "\n")
            ckpt_fh.flush()

    # [1/N] proto-duplication search
    log.info("[1] Looking for proto-duplications...")
    t0 = time.time()
    from .device_index import (DEVICE_MAX_K, DEVICE_MAX_K_TABLE,
                               device_index_fits,
                               device_window_whole_fits)

    # k <= 20 rides every device strategy; k = 21..30 only the
    # whole-genome 3-plane TABLE engine (windowed/merge-join engines
    # are 2-plane — wider probes there keep the byte-equal host path)
    from .device_engine import (fused_applicable,
                                fused_window_applicable)

    # fused engine: needs the chunk set at build time — checkpoint
    # runs (per-chunk journaling) keep the classic engines
    allow_fused = checkpoint is None and (
        (trim is None and fused_applicable(len(strand.data), settings))
        or (trim is not None and fused_window_applicable(
            len(strand.data), int(trim[1]) - int(trim[0]) + 1,
            settings)))
    requested_device = engine == "tpu"
    host_route = None
    use_device = engine == "tpu" and (
        settings.probe_size <= DEVICE_MAX_K
        or (trim is None
            and settings.probe_size <= DEVICE_MAX_K_TABLE
            and device_index_fits(len(strand.data), settings.reverse,
                                  settings.complement))
        or (settings.probe_size <= DEVICE_MAX_K_TABLE and allow_fused))
    if use_device and trim is None and not allow_fused \
            and not device_index_fits(
            len(strand.data), settings.reverse, settings.complement) \
            and not device_window_whole_fits(len(strand.data)):
        # capacity planning beyond even the one-window merge-join
        # strategy (which the adapter below auto-selects): AUTO-SHARD
        # into the smallest window count whose windows fit (the
        # automated form of the
        # reference's --trim workflow, asgart.rs:142-148) — byte-equal
        # to the sequential trim+merge; degrade to the host engine only
        # when no shard count fits (then the sharded path's own guards
        # pick byte-equal host windows anyway)
        if checkpoint is None and _prepared is None:
            n1 = int(len(strand.data))
            total_len = n1 - 1
            doubled = settings.reverse or settings.complement
            from .device_index import device_window_fits

            # past int32 doubled addressing the windows run on the
            # BigWindowEngine, which never holds doubled codes resident
            # (needle-local batches) — size S accordingly
            doubled_resident = doubled and (2 * n1 - 1) < (1 << 31)
            from .device_index import (big_window_fits,
                                       device_window_join_single)

            kk = settings.probe_size

            def _w_fits(W):
                if doubled_resident or not doubled:
                    return device_window_fits(n1, W, doubled_resident,
                                              k=kk)
                # >int32-doubled windows run on the BigWindowEngine,
                # whose per-chunk/batched stage 1 bounds the probe side
                # — its own fit predicate (fed the REAL chunk list)
                # admits far larger windows (e.g. whole-human -RC at
                # ~14 windows instead of none <= 256)
                return big_window_fits(n1, W, k=kk, chunks=to_process)

            S = 2
            while S <= 256 and not _w_fits(
                    (total_len + S - 1) // S + 1):
                S += 1
            # prefer the smallest S whose stage-1 joins also run
            # single-shot (each grouped join re-pays the co-sort's W
            # side): e.g. 512 Mbp -RC picks 3 windows over 2. (The
            # big-window regime skips this: its stage 1 is batched by
            # design, so the join-single refinement has no meaning.)
            if doubled_resident or not doubled:
                S2 = S
                while S2 < min(4 * S, 256) \
                        and not device_window_join_single(
                        n1, (total_len + S2 - 1) // S2 + 1,
                        doubled_resident, k=kk):
                    S2 += 1
                if device_window_join_single(
                        n1, (total_len + S2 - 1) // S2 + 1,
                        doubled_resident, k=kk):
                    S = S2
            if S <= 256:
                log.warning(
                    "genome too large for a one-HBM device index; "
                    "auto-sharding into %d trim windows — output is "
                    "byte-equal to the reference's --trim + merge "
                    "workflow (families never span windows); run with "
                    "engine=host for whole-genome trim-free semantics",
                    S)
                return _search_duplications_sharded(
                    strands_files, settings, S, engine="tpu",
                    profile=profile)
        log.warning(
            "genome too large for a one-HBM device index; falling back "
            "to the host engine (use --shards N for the sharded device "
            "path)")
        host_route = "no window count fits the device memory budget"
        use_device = False
        engine = "host"  # skip the device-table upload path too
    if use_device:
        # device path: index built in device memory (whole genome — with
        # automatic one-window demotion past the memory budget — or the
        # trim window with merge-join probe lookup), scan + compaction
        # on device, event chaining on host (device_engine docstring)
        from .device_index import FusedTiedOverflow

        try:
            se = _DeviceEngineAdapter(strand, settings, profile=prof,
                                      trim=trim,
                                      codes_device=_codes_device,
                                      allow_fused=allow_fused,
                                      chunks=to_process)
        except FusedTiedOverflow as e:
            # k = 21..30 trim window on a hyper-repetitive input: no
            # 3-plane merge-join engine exists — byte-equal host path
            log.warning("fused window build bailed (%s); host engine",
                        e)
            host_route = "fused window tie overflow"
            use_device = False
            engine = "host"
    elif engine == "tpu":
        host_route = (f"probe_size {settings.probe_size} has no device "
                      "engine for this layout")
    if not use_device:
        # wide probes (k > 20) keep the host strategies
        se = SearchEngine(strand, settings, trim, engine=engine,
                          index_cache=index_cache)
        if requested_device:
            _record_engine(prof, type(se._device).__name__
                           if se._device is not None else "host",
                           host_route)
    prof["index_s"] = round(time.time() - t0, 3)
    t0 = time.time()
    families: list[list[ProtoSD]] = []
    from .utils import ProgressBar
    bar = ProgressBar(sum(c[1] for c in to_process))

    def run_or_restore(chunk):
        if tuple(chunk) in ckpt_done:
            return [[ProtoSD(**sd) for sd in fam]
                    for fam in ckpt_done[tuple(chunk)]]
        fams = se.run_chunk(chunk)
        if ckpt_fh is not None:
            import json as _json

            rec = {"chunk": list(chunk),
                   "families": [[vars(sd) for sd in fam] for fam in fams]}
            ckpt_fh.write(_json.dumps(rec) + "\n")
            ckpt_fh.flush()
        return fams

    # chunk-level parallelism (the reference's rayon axis,
    # asgart.rs:201-240): the native chain releases the GIL, so host
    # threads overlap chaining across chunks; device lookups serialize
    # internally. Results keep chunk order.
    import os as _os
    from concurrent.futures import ThreadPoolExecutor

    workers = settings.threads_count or _os.cpu_count() or 1
    if engine == "tpu" or ckpt_fh is not None:
        workers = 1  # one device queue / ordered journal writes
    done = 0
    if (ckpt_fh is None and not ckpt_done
            and hasattr(se, "run_chunks")):
        # device engine: pipelined dispatch across chunks
        for chunk, fams in zip(to_process, se.run_chunks(to_process)):
            families.extend(fams)
            done += chunk[1]
            bar.update(done)
    elif workers > 1 and len(to_process) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            futs = [ex.submit(se.run_chunk, c) for c in to_process]
            for chunk, fut in zip(to_process, futs):
                families.extend(fut.result())
                done += chunk[1]
                bar.update(done)
    else:
        for chunk in to_process:
            families.extend(run_or_restore(chunk))
            done += chunk[1]
            bar.update(done)
    bar.finish()
    if ckpt_fh is not None:
        ckpt_fh.close()
    prof["scan_s"] = round(time.time() - t0, 3)

    t0 = time.time()
    result = _finalize_result(families, strand, settings)
    prof["post_s"] = round(time.time() - t0, 3)
    prof["total_s"] = round(time.time() - total, 3)

    log.info("%s processed in %.2fs",
             ", ".join(strands_files), time.time() - total)
    return result


def _finalize_result(families: list[list[ProtoSD]], strand: Strand,
                     settings: RunSettings) -> RunResult:
    """Post-processing Step chain + chromosome projection (the pipeline
    tail, asgart.rs:81-112,776-821) — shared by the single-run path and
    the per-window finalization of sharded runs."""
    strand_bytes = strand.data.tobytes()
    log.info("[2] Filtering uncertain duplications...")
    families = postprocess.filter_ns(families, strand_bytes)
    log.info("[3] Re-ordering...")
    families = postprocess.re_order(families)
    log.info("[4] Reducing overlap...")
    families = postprocess.reduce_overlap(families)
    if settings.compute_score:
        log.info("[5] Computing Levenshtein distance...")
        families = postprocess.compute_score(families, strand_bytes)
    log.info("[%d] Sorting...", 6 if settings.compute_score else 5)
    families = postprocess.sort_families(families)

    strand_result = StrandResult(
        name=strand.file_names,
        length=sum(chr_.length for chr_ in strand.map),
        map=list(strand.map),
    )

    def project(sd: ProtoSD) -> SD:
        cl = strand_result.find_chr_by_pos(sd.left)
        cr = strand_result.find_chr_by_pos(sd.right)
        return SD(
            chr_left=cl.name if cl else "unknown",
            chr_right=cr.name if cr else "unknown",
            global_left_position=sd.left,
            global_right_position=sd.right,
            chr_left_position=sd.left - (cl.position if cl else 0),
            chr_right_position=sd.right - (cr.position if cr else 0),
            left_length=sd.left_length,
            right_length=sd.right_length,
            left_seq=None,
            right_seq=None,
            identity=sd.identity,
            reversed=sd.reversed,
            complemented=sd.complemented,
        )

    return RunResult(
        strand=strand_result,
        settings=settings,
        families=[[project(sd) for sd in fam] for fam in families],
    )
