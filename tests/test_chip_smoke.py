"""chip_smoke.py refuses to run without a GPU: on a CPU-only host, and in
a directory that holds the script and nothing else of the repository, it
exits non-zero and prints no result line."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
        cwd = tmp_path
    res = _run(cwd, str(script))
    assert res.returncode != 0, res
    assert '"ok"' not in res.stdout, res.stdout


def test_chip_smoke_rejects_other_chip_counts():
    bad = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--chips", "2"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert bad.returncode == 2 and "invalid choice" in bad.stderr
