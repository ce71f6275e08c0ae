"""Contract test for the repo-root ``bench.py``: it measures on a GPU or
not at all — without one it exits non-zero with a message on stderr and
prints nothing on stdout (a CPU number is not a device number)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_bench_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(REPO / "bench.py")],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "needs a GPU" in proc.stderr


def test_bench_device_info_names_the_device():
    import importlib.util
    spec = importlib.util.spec_from_file_location("bench", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    info = bench.device_info()
    assert set(info) == {"platform", "kind", "count"}
    assert info["platform"] == "cpu" and info["count"] >= 1
