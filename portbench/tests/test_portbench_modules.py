"""The run refuses a process that holds JAX or the JAX package, and the
reference imports nothing of the program."""

import subprocess
import sys
import types

from portbench import harness


def test_forbidden_modules_by_top_level_name():
    assert "bevformer_tpu" not in harness.forbidden_modules()
    sys.modules["bevformer_tpu.models"] = types.ModuleType("bevformer_tpu.models")
    try:
        assert harness.forbidden_modules() == ["bevformer_tpu"]
    finally:
        del sys.modules["bevformer_tpu.models"]
    import bevformer_torch  # noqa: F401  its name begins with the JAX package's

    assert "bevformer_torch" in {m.partition(".")[0] for m in sys.modules}
    assert harness.forbidden_modules() == []


def _fresh(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=harness.ROOT)


def test_reference_imports_nothing_of_the_program():
    p = _fresh("import sys, portbench.reference.model, portbench.reference.train, "
               "portbench.weights, portbench.traffic, portbench.yardstick.work; "
               "print(sorted({m.partition('.')[0] for m in sys.modules} & "
               "{'bevformer_torch', 'bevformer_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert p.returncode == 0 and p.stdout.strip() == "[]", p.stderr


def test_run_without_a_card_prints_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run on a machine without one")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "base.video",
                        "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr
