"""chip_smoke.py never fails silently: wherever it cannot run, its last
stdout line is {"ok": false, "error": ...} and it exits non-zero.

- with ``python -P`` from a working directory outside the repo, and a
  PYTHONPATH that hides the port: the import error is named;
- copied alone into an empty directory (as it is run to show that it
  needs the program beside it): the same;
- with no CUDA device visible: the missing device is named.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = REPO / "chip_smoke.py"


def run(args, cwd, pythonpath, **env_extra):
    env = dict(os.environ, PYTHONPATH=str(pythonpath), **env_extra)
    proc = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert lines, f"no stdout; stderr: {proc.stderr[-2000:]}"
    return proc.returncode, json.loads(lines[-1])


@pytest.mark.parametrize("how", ["dash_P_outside", "copied_alone"])
def test_without_the_port_the_import_is_named(tmp_path, how):
    if how == "dash_P_outside":
        rc, last = run(["-P", str(SCRIPT)], tmp_path, tmp_path)
    else:
        shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
        rc, last = run(["chip_smoke.py"], tmp_path, tmp_path)
    assert rc != 0
    assert last["ok"] is False
    assert "ModuleNotFoundError" in last["error"]
    assert "dfmir_tpu_torch" in last["error"]


def test_without_cuda_the_device_is_named():
    rc, last = run([str(SCRIPT)], REPO, REPO, CUDA_VISIBLE_DEVICES="")
    assert rc != 0
    assert last["ok"] is False
    assert "CUDA" in last["error"] and "device" in last["error"]


def test_a_failing_phase_is_named(monkeypatch, capsys):
    """A phase that raises prints its own result line naming it, and the
    error propagates (the script then exits non-zero)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    monkeypatch.setattr(chip_smoke.torch.cuda, "is_available", lambda: True)

    def broken():
        raise RuntimeError("the card fell over")

    monkeypatch.setattr(chip_smoke, "phase_device", broken)
    with pytest.raises(RuntimeError, match="fell over"):
        chip_smoke.main([])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": False, "phase": "device",
                    "error": "RuntimeError: the card fell over"}
