"""`chip_smoke.py` refuses to run without a CUDA device: it exits nonzero
and prints no result line, here and from a directory that holds nothing
else of the repository."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def _run(cwd: Path):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True,
        text=True, timeout=120,
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _run(cwd)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert '"kernels"' not in proc.stdout


GROUPS = ("loss", "backbone", "neck", "encoder", "decoder", "head")


def _errs(**given):
    return {g: given.get(g, 1e-5) for g in GROUPS}


@pytest.mark.parametrize("damped,errs,noisy,refused", [
    # undamped: every key within 10x of the noisy path
    (False, _errs(neck=6e-3), _errs(neck=7e-4), []),
    (False, _errs(neck=8e-3), _errs(neck=7e-4), ["neck: kernel vs plain"]),
    # damped: the transformer side to 1e-3, the backbone within 10x of noisy
    (True, _errs(backbone=3e-3, neck=9e-4), _errs(backbone=1e-3), []),
    (True, _errs(decoder=2e-3), _errs(), ["decoder: kernel vs plain"]),
    # a batch whose noisy path misses 1e-3 damped is refused as a batch,
    # whatever the kernel path reads
    (True, _errs(neck=9e-5), _errs(neck=2.45e-3), ["neck: noisy plain vs plain"]),
], ids=["undamped_within", "undamped_past", "damped_within", "damped_past", "degenerate_batch"])
def test_training_witness_limits(damped, errs, noisy, refused):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    fails = chip_smoke.witness_failures(errs, noisy, damped)
    assert len(fails) == len(refused)
    for msg, want in zip(fails, refused):
        assert msg.startswith(want), (msg, want)
