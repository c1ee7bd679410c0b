"""Device seed lookup (JAX, CPU backend here) vs host searchsorted."""

import jax.numpy as jnp
import numpy as np
import pytest

from asgart_tpu.index import CODE, GenomeIndex
from asgart_tpu.pipeline import _pack_probe_kmers, probe_positions
from asgart_tpu.seed import DeviceSeedIndex, pack_probe_planes, split_planes
from tests.util import plant_duplication, random_dna


def build_index(text: bytes, k: int) -> GenomeIndex:
    return GenomeIndex.build(np.frombuffer(text, dtype=np.uint8), k)


@pytest.mark.parametrize("seed,n,k", [(0, 3000, 20), (1, 5000, 12),
                                      (2, 2000, 8), (3, 4000, 20)])
def test_device_lookup_matches_host(seed, n, k):
    rng = np.random.default_rng(seed)
    text = random_dna(rng, n, b"ACGTN") + b"$"
    idx = build_index(text, k)
    dsi = DeviceSeedIndex(idx, batch=256)

    arr = np.frombuffer(text[:-1], dtype=np.uint8)
    is_ = probe_positions(arr, k)
    codes = np.zeros(len(arr) + k, dtype=np.uint8)
    codes[:len(arr)] = CODE[arr]
    pk = _pack_probe_kmers(codes, is_, k)

    lo_h, hi_h = idx.lookup(pk)
    lo_d, hi_d = dsi.lookup(pk)
    np.testing.assert_array_equal(lo_d, lo_h)
    np.testing.assert_array_equal(hi_d, hi_h)


def test_device_lookup_low_complexity():
    # huge equal ranges (poly-A etc.) stress bucket + binary search depth
    rng = np.random.default_rng(9)
    text = (b"A" * 500 + random_dna(rng, 1000, b"AC") + b"A" * 300) + b"$"
    k = 10
    idx = build_index(text, k)
    dsi = DeviceSeedIndex(idx, batch=128)
    arr = np.frombuffer(text[:-1], dtype=np.uint8)
    is_ = probe_positions(arr, k)
    codes = np.zeros(len(arr) + k, dtype=np.uint8)
    codes[:len(arr)] = CODE[arr]
    pk = _pack_probe_kmers(codes, is_, k)
    lo_h, hi_h = idx.lookup(pk)
    lo_d, hi_d = dsi.lookup(pk)
    np.testing.assert_array_equal(lo_d, lo_h)
    np.testing.assert_array_equal(hi_d, hi_h)


def test_pack_probe_planes_matches_host_packing():
    rng = np.random.default_rng(4)
    text = random_dna(rng, 500, b"ACGTN")
    k = 20
    arr = np.frombuffer(text, dtype=np.uint8)
    is_ = probe_positions(arr, k)
    codes = np.zeros(len(arr) + k, dtype=np.uint8)
    codes[:len(arr)] = CODE[arr]
    pk = _pack_probe_kmers(codes, is_, k)
    want_hi, want_lo = split_planes(pk)
    got_hi, got_lo = pack_probe_planes(
        jnp.asarray(codes), jnp.asarray(is_.astype(np.int32)), k)
    np.testing.assert_array_equal(np.asarray(got_hi), want_hi)
    np.testing.assert_array_equal(np.asarray(got_lo), want_lo)


def test_tpu_engine_end_to_end(tmp_path):
    from asgart_tpu.pipeline import search_duplications
    from asgart_tpu.structs import RunSettings
    from tests.util import write_fasta

    rng = np.random.default_rng(10)
    g = plant_duplication(rng, 15000, 1500, 2000, 9000, noise=0.005)
    p = tmp_path / "g.fa"
    write_fasta(p, [("chr", g)])
    host = search_duplications([str(p)], RunSettings())
    device = search_duplications([str(p)], RunSettings(), engine="tpu")
    import io
    from asgart_tpu.exporters import JSONExporter
    b1, b2 = io.StringIO(), io.StringIO()
    JSONExporter().save(host, b1)
    JSONExporter().save(device, b2)
    assert b1.getvalue() == b2.getvalue()
    assert host.families
