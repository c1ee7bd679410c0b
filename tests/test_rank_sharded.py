"""Rank-sharded single-window engine: the window index sharded across
the 8-device CPU mesh must reproduce the host trim engine byte-for-byte
(VERDICT r2 #4 — lifts the one-HBM / 2^30-row window caps; reference
analog surpassed: the --trim memory bound, asgart.rs:142-148)."""

import json

import numpy as np
import pytest

from asgart_tpu.pipeline import search_duplications
from asgart_tpu.structs import RunSettings
from tests.util import plant_duplication, random_dna, revcomp, write_fasta


def assert_results_equal(host, device):
    h = [[vars(sd) for sd in fam] for fam in host.families]
    t = [[vars(sd) for sd in fam] for fam in device.families]
    assert json.dumps(t, sort_keys=True) == json.dumps(h, sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_window_arrays_bit_equal_device(seed):
    """The host window builder (the >HBM build path) must produce the
    device builder's arrays bit-exactly."""
    import jax

    from asgart_tpu.device_engine import host_window_arrays
    from asgart_tpu.device_index import build_window_arrays
    from asgart_tpu.index import CODE

    rng = np.random.default_rng(seed)
    n = int(rng.integers(2000, 6000))
    data = np.frombuffer(random_dna(rng, n, b"ACGT" if seed else b"ACG")
                         + b"$", np.uint8)
    ws, we = 100, n - 200
    k = 20
    hkh, hkl, hrl, hsa, hW = host_window_arrays(data, k, ws, we)
    codes1 = jax.device_put(CODE[data])
    dkh, dkl, drl, dsa, dW = build_window_arrays(codes1, k, ws, we)
    assert hW == dW
    np.testing.assert_array_equal(hkh, np.asarray(dkh))
    np.testing.assert_array_equal(hkl, np.asarray(dkl))
    np.testing.assert_array_equal(hrl, np.asarray(drl))
    np.testing.assert_array_equal(hsa + ws, np.asarray(dsa))


def _trim_both(tmp_path, body, kw, trim, monkeypatch, host_build=None):
    fa = tmp_path / "g.fa"
    write_fasta(fa, [("chr1", body)])
    s = RunSettings(trim=trim, **kw)
    host = search_duplications([str(fa)], s, engine="host")
    monkeypatch.setenv("ASGART_RANK_SHARDED", "1")
    if host_build is not None:
        monkeypatch.setenv("ASGART_RSH_HOST_BUILD",
                           "1" if host_build else "0")
    device = search_duplications([str(fa)], s, engine="tpu")
    monkeypatch.delenv("ASGART_RANK_SHARDED")
    return host, device


def test_rank_sharded_trim_direct(tmp_path, monkeypatch):
    import jax

    assert len(jax.devices()) == 8
    rng = np.random.default_rng(70)
    body = plant_duplication(rng, 30000, 2000, 5000, 20000, noise=0.01)
    host, device = _trim_both(tmp_path, body, {}, (2000, 26000),
                              monkeypatch)
    assert_results_equal(host, device)
    assert host.families, "nothing found"


def test_rank_sharded_trim_rc(tmp_path, monkeypatch):
    rng = np.random.default_rng(71)
    body = plant_duplication(rng, 24000, 1500, 3000, 15000,
                             transform=revcomp)
    host, device = _trim_both(tmp_path, body,
                              dict(reverse=True, complement=True),
                              (1000, 20000), monkeypatch)
    assert_results_equal(host, device)
    assert host.families


@pytest.mark.soak
def test_rank_sharded_host_built_window(tmp_path, monkeypatch):
    """The host-side window build (the true >HBM path) through the
    same sharded serving stages."""
    rng = np.random.default_rng(72)
    body = plant_duplication(rng, 20000, 1500, 2500, 12000)
    host, device = _trim_both(tmp_path, body, {}, (500, 18000),
                              monkeypatch, host_build=True)
    assert_results_equal(host, device)
    assert host.families


@pytest.mark.soak
def test_rank_sharded_fuzz(tmp_path, monkeypatch):
    for trial in range(3):
        rng = np.random.default_rng(400 + trial)
        reverse = bool(trial % 2)
        n = int(rng.integers(12000, 24000))
        g = bytearray(random_dna(rng, n, b"ACGT"))
        for _ in range(2):
            L = int(rng.integers(400, 1200))
            src = int(rng.integers(0, n // 2 - L))
            dst = int(rng.integers(n // 2, n - L))
            seg = bytes(g[src:src + L])
            if reverse:
                seg = revcomp(seg)
            g[dst:dst + L] = seg
        a = int(rng.integers(0, n // 4))
        b = int(rng.integers(3 * n // 4, n - 1))
        host, device = _trim_both(
            tmp_path, bytes(g),
            dict(reverse=reverse, complement=reverse,
                 min_duplication_length=300), (a, b), monkeypatch)
        assert_results_equal(host, device)
