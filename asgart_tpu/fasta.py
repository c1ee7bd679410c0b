"""FASTA reading, normalization, fragment mapping and N-run chunking.

Reproduces the reference's data preparation (``src/bin/asgart.rs:273-471``):

  * multiFASTA records are concatenated into one strand with a fragment map,
  * unless ``skip_masked``, the sequence is uppercased; with ``skip_masked``
    soft-masked (lowercase) bases become ``N``,
  * any byte outside {A,T,G,C,N} becomes ``N``,
  * per fragment, chunks to process are the segments between runs of more
    than 5000 consecutive Ns (chunk boundaries never cross fragments),
  * a ``$`` sentinel is appended for suffix-array construction,
  * ``trim`` bounds are validated/clamped.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .structs import Start

log = logging.getLogger("asgart")

N_RUN_THRESHOLD = 5000  # asgart.rs:326

_ALPHABET = frozenset(b"ATGCN")
_ALPHABET_MASKED = frozenset(b"atgcn")

# byte → normalized byte, without masking (uppercase, non-ACGTN → N)
_NORM_PLAIN = np.full(256, ord("N"), dtype=np.uint8)
for _c in b"ATGCN":
    _NORM_PLAIN[_c] = _c
    _NORM_PLAIN[_c + 32] = _c  # lowercase → uppercase

# byte → normalized byte with skip_masked (lowercase acgtn → N)
_NORM_MASKED = np.full(256, ord("N"), dtype=np.uint8)
for _c in b"ATGCN":
    _NORM_MASKED[_c] = _c
    _NORM_MASKED[_c + 32] = ord("N")


@dataclass
class Strand:
    """The concatenated, normalized genome (asgart.rs:267-271)."""

    file_names: str
    data: np.ndarray  # uint8, includes the trailing '$'
    map: list[Start] = field(default_factory=list)

    @property
    def data_bytes(self) -> bytes:
        return self.data.tobytes()


def read_fasta(filename: str, skip_masked: bool) -> tuple[list[Start], np.ndarray]:
    """Parse one (multi)FASTA file into a fragment map and normalized bytes
    (asgart.rs:278-313). Record ids are the first whitespace-delimited token
    of the header (rust-bio's ``record.id()``)."""
    table = _NORM_MASKED if skip_masked else _NORM_PLAIN

    # Bulk parse: one read + vectorized newline handling. Real-width
    # FASTA (60-80 bp lines) has millions of lines per chromosome; a
    # per-line Python loop costs tens of seconds at whole-genome scale
    # while this path is two passes over the bytes.
    data = np.fromfile(filename, dtype=np.uint8)
    if data.size and data[-1] != ord("\n"):
        data = np.concatenate(
            [data, np.frombuffer(b"\n", dtype=np.uint8)])
    nl_pos = np.flatnonzero(data == ord("\n"))
    line_starts = np.concatenate(
        [np.zeros(1, dtype=np.int64), nl_pos[:-1] + 1]) \
        if nl_pos.size else np.zeros(0, dtype=np.int64)
    is_header = data[line_starts] == ord(">") if line_starts.size \
        else np.zeros(0, dtype=bool)
    header_idx = np.flatnonzero(is_header)
    if header_idx.size == 0:
        # non-blank sequence-only content is an error with a distinct
        # message (matching the loop reader's two failure modes)
        keep = (data != ord("\n")) & (data != ord("\r"))
        if bool(keep.any()):
            raise ValueError(f"Unable to parse `{filename}`: "
                             "sequence data before first header")
        raise ValueError(f"Unable to read FASTA file `{filename}`")
    first_h = line_starts[header_idx[0]]
    if first_h != 0:
        pre = data[:first_h]
        if bool(((pre != ord("\n")) & (pre != ord("\r"))).any()):
            raise ValueError(f"Unable to parse `{filename}`: "
                             "sequence data before first header")

    map_: list[Start] = []
    seqs: list[np.ndarray] = []
    counter = 0
    h_starts = line_starts[header_idx]
    h_ends = nl_pos[header_idx]  # the header line's own newline
    bounds = np.concatenate([h_starts[1:],
                             np.asarray([data.size], dtype=np.int64)])
    for hs, he, be in zip(h_starts, h_ends, bounds):
        header = bytes(data[hs + 1: he]).rstrip(b"\r")
        toks = header.split(None, 1)
        name = toks[0].decode() if toks else ""
        body = data[he + 1: be]
        keep = (body != ord("\n")) & (body != ord("\r"))
        seq = table[body[keep]]
        map_.append(Start(name=name, position=counter, length=len(seq)))
        counter += len(seq)
        seqs.append(seq)
    total = (np.concatenate(seqs) if seqs
             else np.zeros(0, dtype=np.uint8))
    return map_, total


def find_chunks_to_process(strand: np.ndarray) -> list[tuple[int, int]]:
    """Split a fragment at runs of > 5000 consecutive Ns
    (asgart.rs:317-366). Coordinates are fragment-relative.

    Note the reference's exact behavior: runs of Ns ≤ 5000 are *included*
    in the current chunk (count += n_count) even when no chunk has started
    yet — in which case `start` keeps its previous value; we reproduce the
    state machine faithfully.
    """
    is_n = (strand == ord("N")) | (strand == ord("n"))
    n_ = len(strand)
    chunks: list[tuple[int, int]] = []

    # Precompute run-lengths of Ns starting at each N position.
    # run_len[i] = number of consecutive Ns starting at i (only queried at
    # run starts, so compute lazily with a helper on the boolean array).
    start = 0
    count = 0
    i = 0
    # Identify maximal N-run starts and lengths up front for O(n) total.
    # diff-based run extraction:
    if n_ == 0:
        return [(0, 0)]
    padded = np.concatenate(([False], is_n, [False]))
    d = np.diff(padded.astype(np.int8))
    run_starts = np.flatnonzero(d == 1)
    run_ends = np.flatnonzero(d == -1)
    run_len_at = dict(zip(run_starts.tolist(),
                          (run_ends - run_starts).tolist()))

    while i < n_:
        if is_n[i]:
            n_count = run_len_at[i]
            if n_count > N_RUN_THRESHOLD:
                if count > 0:
                    chunks.append((start, count))
                    count = 0
                start = i + n_count
            else:
                count += n_count
            i += n_count
        else:
            # jump to the next N (or the end) in one step
            nxt = run_starts[np.searchsorted(run_starts, i)] \
                if np.searchsorted(run_starts, i) < len(run_starts) else n_
            span = int(nxt) - i
            if count == 0:
                count = span
                start = i
            else:
                count += span
            i = int(nxt)
    if count != 0:
        chunks.append((start, count))
    if not chunks:
        chunks.append((0, n_))
    return chunks


# one-entry parse cache for warm-service rescans: a rescan of the same
# files would re-pay the full FASTA parse although it is pure in (file
# contents, skip_masked). Guarded by per-file (size, mtime_ns) fingerprints;
# ASGART_PREPARE_CACHE=0 disables. The cached strand/map/chunks are
# returned as-is — callers treat them read-only (windows of a sharded
# run already share one parse the same way).
_PREPARE_CACHE: dict = {}


def _prepare_fingerprint(strands_files, skip_masked):
    import os

    if os.environ.get("ASGART_PREPARE_CACHE", "1") == "0":
        return None
    try:
        sig = tuple((f, os.stat(f).st_size, os.stat(f).st_mtime_ns)
                    for f in strands_files)
    except OSError:
        return None
    return (sig, bool(skip_masked))


def prepare_data(
    strands_files: list[str],
    skip_masked: bool,
    trim: Optional[tuple[int, int]],
) -> tuple[Optional[tuple[int, int]], list[tuple[int, int]], Strand]:
    """Read all FASTA files, build the concatenated strand + chunk list
    (asgart.rs:273-471). The trim-independent parse is served from a
    one-entry fingerprint cache across calls (warm-service rescans);
    trim validation always runs on the current call's ``trim``."""
    key = _prepare_fingerprint(strands_files, skip_masked)
    if key is not None:
        hit = _PREPARE_CACHE.get(key)
        if hit is not None:
            chunks_to_process, strand_obj = hit
            return (_checked_trim(trim, strand_obj.data),
                    chunks_to_process, strand_obj)
    maps: list[Start] = []
    strand_parts: list[np.ndarray] = []
    offset = 0
    chunks_to_process: list[tuple[int, int]] = []

    for file_name in strands_files:
        fmap, new_strand = read_fasta(file_name, skip_masked)
        # chunks are computed per fragment so they never cross fragments
        for chr_ in fmap:
            for (start, length) in find_chunks_to_process(
                    new_strand[chr_.position: chr_.position + chr_.length]):
                chunks_to_process.append(
                    (chr_.position + offset + start, length))
        for s in fmap:
            maps.append(Start(name=s.name, position=s.position + offset,
                              length=s.length))
        offset += len(new_strand)
        strand_parts.append(new_strand)

    strand = (np.concatenate(strand_parts) if strand_parts
              else np.zeros(0, dtype=np.uint8))
    log.info(
        "Parsed %d file%s containing a total of %d fragments",
        len(strands_files), "s" if len(strands_files) > 1 else "", len(maps))

    chunks_length = sum(c[1] for c in chunks_to_process)
    total_len = len(strand)
    if total_len:
        log.info(
            "Processing %d chunks totalling %dbp, skipping %dbp out of %d (%d%%)",
            len(chunks_to_process), chunks_length, total_len - chunks_length,
            total_len,
            int((total_len - chunks_length) * 100.0 / total_len))

    strand = np.concatenate(
        [strand, np.frombuffer(b"$", dtype=np.uint8)])  # SA sentinel

    strand_obj = Strand(file_names=", ".join(strands_files),
                        data=strand, map=maps)
    if key is not None:
        _PREPARE_CACHE.clear()
        _PREPARE_CACHE[key] = (chunks_to_process, strand_obj)

    return (_checked_trim(trim, strand), chunks_to_process, strand_obj)


def _checked_trim(trim: Optional[tuple[int, int]],
                  strand: np.ndarray) -> Optional[tuple[int, int]]:
    """Validate/clamp a trim request against the strand (asgart.rs
    trim checks; warnings preserved)."""
    if trim is None:
        return None
    shift, stop = trim
    if stop >= len(strand):
        log.warning("Trimming: %d greater than total length (%dbp)",
                    stop, len(strand))
        log.warning("Using %d instead of %d", len(strand) - 1, stop)
        stop = len(strand) - 1
    if stop <= shift:
        log.warning("Trimming: %d greater than %d, skipping trimming",
                    shift, stop)
    elif shift >= len(strand):
        log.warning(
            "Trimming: %d greater than total length (%dbp), skipping trimming",
            shift, len(strand))
    else:
        return (shift, stop)
    return None
