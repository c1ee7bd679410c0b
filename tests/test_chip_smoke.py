"""CPU rehearsal of chip_smoke.py's phases at a tiny size (the script's
CUDA check is left out: only ``main`` makes it), plus its refusal to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MBP = 0.2


@pytest.fixture
def rehearsal(monkeypatch, tmp_path):
    # the test tier's 8 virtual devices would turn the fused engine off
    # (one-device routing); force it so the routes match one GPU's
    monkeypatch.setenv("ASGART_FUSED", "1")
    return str(tmp_path)


def test_phase_main_rehearsal(rehearsal):
    fa, planted, n = cs.main_genome(rehearsal, mbp=MBP)
    assert n == int(MBP * 1e6) and planted
    out = cs.phase_main(fa, planted, n)
    assert out["route"] == "FusedEngine"


def test_phase_shards_rehearsal(rehearsal):
    fa, _, _ = cs.main_genome(rehearsal, mbp=MBP)
    out = cs.phase_shards(fa)
    assert "host" not in out["route"]


def test_phase_index_rehearsal(rehearsal):
    cs.phase_index(mbp=MBP)


def test_phase_sweep_rehearsal(rehearsal, monkeypatch):
    # small slices so the satellite block takes the sliced dispatch
    monkeypatch.setenv("ASGART_DEVICE_SLICE_LANES", "16384")
    cs.phase_sweep(rehearsal, mbp=MBP)


def test_phase_multi_rehearsal(tmp_path):
    """--multi's paths on the test tier's 8 virtual devices."""
    fa, _, n = cs.main_genome(str(tmp_path), mbp=MBP)
    cs.phase_multi(fa, n)


def test_check_doubled_index_catches_a_swap():
    """The index comparison is not vacuous: swapping two direct suffixes
    of the device index fails it."""
    import numpy as np

    from asgart_tpu.device_index import DeviceIndex
    from asgart_tpu.index import PositionIndex
    from tests.util import plant_duplication, revcomp

    rng = np.random.default_rng(5)
    text = plant_duplication(rng, 4000, 500, 300, 2500,
                             transform=revcomp) + b"$"
    data = np.frombuffer(text, dtype=np.uint8)
    didx = DeviceIndex.build(data, 12, reverse=True, complement=True)
    pidx = PositionIndex.build(data, 12, reverse=True, complement=True)
    cs.check_doubled_index(didx, pidx)
    sa = np.asarray(didx.sa).copy()
    i, j = np.flatnonzero(sa < pidx.first_len)[[10, 20]]
    sa[[i, j]] = sa[[j, i]]
    didx.sa = sa
    with pytest.raises(AssertionError, match="suffix order"):
        cs.check_doubled_index(didx, pidx)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_to_run_without_a_gpu(tmp_path, alone):
    """No GPU (or no repository beside the script): a non-zero exit
    before any phase, and no result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    cp = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                        capture_output=True, text=True, timeout=300)
    assert cp.returncode != 0
    assert '"ok"' not in cp.stdout
    assert "[1]" not in cp.stdout and "phase" not in cp.stdout
