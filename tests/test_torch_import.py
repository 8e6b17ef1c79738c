"""The port stands without JAX: with `jax`, `flax` and `bevformer_tpu`
blocked, and cv2, every module of `bevformer_torch` imports and one tiny
frame runs on the CPU (in a subprocess, so the block cannot leak into other
tests). No source file of the port, nor `chip_smoke.py`, names them in an
import, and cv2 is imported only inside the functions that read or write
an image (`data/image_io.py`'s camera JPEGs, `utils/visual.py`, the BEV
renderings of `tools/misc/visualize_results.py`).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "bevformer_tpu")

RUN_BLOCKED = f"""
import sys
for name in {BLOCKED + ("cv2",)!r}:
    sys.modules[name] = None
import importlib, pkgutil
import bevformer_torch
for mod in pkgutil.walk_packages(bevformer_torch.__path__, "bevformer_torch."):
    importlib.import_module(mod.name)

import torch
torch.set_num_threads(1)
from bevformer_torch.configs import DataConfig, get_config
from bevformer_torch.data import SyntheticVideo
from bevformer_torch.runtime import VideoEvaluator, build_model, init_state_dict

cfg = get_config("bevformer_base", backbone_depth=10, bev_h=8, bev_w=8,
                 encoder_layers=1, decoder_layers=1, num_query=20,
                 data=DataConfig(raw_size=(64, 96)))
model = build_model(cfg, init_state_dict(cfg, seed=0), "cpu")
res = VideoEvaluator(model).run(SyntheticVideo(cfg, (1,), seed=0, device="cpu"), progress_every=0)
assert len(res) == 1 and res[0]["boxes_3d"].shape[1] == 9, res
loaded = [k for k, v in sys.modules.items()
          if v is not None and k.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("PORT_RAN_WITHOUT_JAX")
"""


def test_port_imports_and_runs_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", RUN_BLOCKED], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PORT_RAN_WITHOUT_JAX" in proc.stdout


def _port_sources():
    return sorted((ROOT / "bevformer_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, f"{path}: imports {name}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_cv2_only_to_read_a_jpeg(path):
    tree = ast.parse(path.read_text())
    parent = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}
    where = []
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        if any(n.split(".")[0] == "cv2" for n in names):
            scope = node
            while scope in parent and not isinstance(scope, ast.FunctionDef):
                scope = parent[scope]
            where.append(getattr(scope, "name", "<module>"))
    # cv2 loads inside the functions that read or write an image: the
    # cameras' JPEGs, a feature-map grid, the BEV renderings
    allowed = {
        "bevformer_torch/data/image_io.py": ["_cv2"],
        "bevformer_torch/utils/visual.py": ["save_tensor"],
        "bevformer_torch/tools/misc/visualize_results.py": ["draw_box_bev", "main"],
    }.get(str(path.relative_to(ROOT)), [])
    assert where == allowed, f"{path}: imports cv2 in {where}"
