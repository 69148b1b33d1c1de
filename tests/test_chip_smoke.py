"""chip_smoke.py refuses to run anywhere but on a GPU with the repo beside
it: it exits non-zero and prints no result line."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=120
    )


def test_exits_nonzero_without_gpu():
    out = _run(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exits_nonzero_without_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
