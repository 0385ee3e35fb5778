"""The port's two isolation rules: ``cgnn_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX, Flax or the JAX package (nor
``jax_checkpoint_to_torch.py``, which imports JAX by design), and
``chip_smoke.py`` refuses to report a result where it cannot run (no
CUDA, or a directory without the rest of the repository)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "cgnn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cgnn_tpu",
             "jax_checkpoint_to_torch")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_sources_name_no_jax_module():
    assert len(_port_files()) > 20
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


_PROBE = """
import importlib, json, pkgutil, sys
import cgnn_tpu_torch
mods = sorted(m.name for m in pkgutil.walk_packages(
    cgnn_tpu_torch.__path__, "cgnn_tpu_torch."))
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "optax", "orbax", "cgnn_tpu",
              "jax_checkpoint_to_torch"))
print(json.dumps({"imported": mods, "bad": bad}))
"""


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter: this process already imported jax."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "cgnn_tpu_torch.serve.server" in res["imported"]
    for mod in ("ops.fused_cgconv", "ops.fused_epilogue", "ops.scatter",
                "ops.windowed_gather", "train.state", "train.step",
                "train.loop", "train.__main__", "train.checkpoint",
                "train.metrics", "train.infer", "resilience.integrity",
                "resilience.guard", "resilience.preempt",
                "resilience.faultinject",
                "predict", "data.cif", "data.cache", "data.preprocess",
                "data.compact", "data.pipeline", "data.loader"):
        assert f"cgnn_tpu_torch.{mod}" in res["imported"], mod
    assert res["bad"] == []


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_its_card_or_repo(where, tmp_path):
    """Here there is no CUDA; alone, the port is not importable either.
    Either way: a non-zero exit and no result line."""
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_bytes(
            (ROOT / "chip_smoke.py").read_bytes())
        cwd = tmp_path
    else:
        cwd = ROOT
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
