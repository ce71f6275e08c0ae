"""chip_smoke.py (repo root): its helpers, its refusal to run without a
GPU, and every phase rehearsed at a tiny size on the CPU backend (the
timings a CPU run prints are not device numbers; only the control flow and
the comparisons are checked here)."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tpuwave import config

REPO = Path(__file__).resolve().parent.parent


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load()


@pytest.fixture
def keep_x64():
    """The phases flip jax_enable_x64 as the CLI does; restore f64."""
    yield
    config.use_x64(True)


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_parse_nvidia_smi():
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 500.00 W\n\n")
    assert cs.parse_nvidia_smi(text) == [
        ("NVIDIA H100 80GB HBM3", "700.00 W"),
        ("NVIDIA H100 80GB HBM3", "500.00 W")]
    assert cs.parse_nvidia_smi("") == []


def test_result_line_contract():
    rec = json.loads(cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 4))
    assert rec == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_compare_runs_tolerance(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for d, probe, energy in ((a, "1.0000001", "2.0"), (b, "1.0", "2.0")):
        d.mkdir()
        (d / "probe.csv").write_text(
            f"timestep,time,u_probe\n1,0.1,0.5\n2,0.2,{probe}\n")
        (d / "energy.csv").write_text(
            f"timestep,time,energy\n1,0.1,{energy}\n2,0.2,{energy}\n")
    diffs = cs.compare_runs(a, b)
    assert diffs["probe.csv:u_probe"] == pytest.approx(1e-7, rel=1e-3)
    assert diffs["energy.csv:energy"] == 0.0
    assert cs.check_compare("t", diffs, 2e-7)
    assert not cs.check_compare("t", diffs, 5e-8)
    (b / "probe.csv").write_text("timestep,time,u_probe\n1,0.1,0.5\n")
    with pytest.raises(ValueError):
        cs.compare_runs(a, b)


def test_check_relative_tolerance():
    assert cs.check("rel L2", 2.656e-7, cs.ANCHOR_REL_L2, cs.ANCHOR_L2_RTOL)
    assert not cs.check("rel H1", 9.3e-6, cs.ANCHOR_REL_H1,
                        cs.ANCHOR_H1_RTOL)


def test_anchor_case_is_the_published_configuration():
    case = cs.anchor_case()
    assert (case["Nel"], case["R"], case["Dt"], case["T"]) == \
        ("320", "2", "0.0001", "1.0")
    assert (case["Beta"], case["Gamma"]) == ("0.25", "0.5")
    assert case["Save Solution"] == "false"
    assert "Solution" in case   # the exact solution drives the errors


def test_refuses_without_gpu():
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, env=_cpu_env(),
                          cwd=REPO, timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs a GPU" in proc.stderr


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"],
                          capture_output=True, text=True, env=_cpu_env(),
                          cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_anchor_small(tmp_path, keep_x64):
    """The anchor phase end to end on a coarse case: it runs and reads the
    final errors back (a coarse mesh misses the published values)."""
    case = cs.standing_case(**{"Nel": "8", "R": "2", "T": "0.02",
                               "Dt": "0.01", "Beta": "0.25",
                               "Log Every": "1"})
    assert cs.phase_anchor(tmp_path, case) is False


def test_phase_fill_small(tmp_path, keep_x64):
    assert cs.phase_fill(tmp_path, nel=8, steps=2)


def test_phase_parity_small(tmp_path, keep_x64):
    assert cs.phase_parity(tmp_path, nel=16, steps=2)


def test_phase_stream_small(keep_x64, monkeypatch):
    monkeypatch.setattr(cs, "nvidia_smi", lambda query: "n/a")
    assert cs.phase_stream(nel=32, steps=2)


def test_phase_four_small(tmp_path, keep_x64):
    """--shard rows / blocks over the virtual CPU devices vs one device."""
    import jax
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual multi-device CPU mesh")
    assert cs.phase_four(tmp_path, nel=8, steps=2)


@pytest.mark.gpu
def test_phase_fill_on_gpu(gpu_device, tmp_path, keep_x64):
    """The fill phase at a small size on a real card."""
    assert cs.phase_fill(tmp_path, nel=64, steps=2)
