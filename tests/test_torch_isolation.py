"""The port stands alone: no module of ``dla_tpu_torch`` (and not
``chip_smoke.py``) imports jax or the JAX package ``dla_tpu``, nor the HF
packages the GPU machine lacks (``safetensors``, ``transformers``,
``tokenizers``, ``huggingface_hub``, ``datasets``); ``matplotlib`` only
inside the function that draws a curve, never at import time."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dla_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


HF = ("safetensors", "transformers", "tokenizers", "huggingface_hub",
      "datasets")
BLOCKED = ("jax", "jaxlib", "dla_tpu") + HF + ("matplotlib",)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "dla_tpu") + HF


def _imported_names(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    if (isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", ""))
            in ("import_module", "__import__") and node.args
            and isinstance(node.args[0], ast.Constant)):
        return [str(node.args[0].value)]
    return []


def test_sources_name_no_jax_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            bad += [f"{path.name}: {n}" for n in _imported_names(node)
                    if _forbidden(n)]
    assert not bad, bad


def test_matplotlib_is_imported_inside_functions_only():
    """A module-level import of matplotlib would fail on the GPU machine
    at import time; only a function body may import it."""
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        inside = {id(n) for f in ast.walk(tree)
                  if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        bad += [f"{path.name}: {n}" for node in ast.walk(tree)
                if id(node) not in inside
                for n in _imported_names(node)
                if n.split(".")[0] == "matplotlib"]
    assert not bad, bad


BLOCKER = """
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
for mod in sys.argv[1:]:
    importlib.import_module(mod)
assert not any(m.split(".")[0] in BLOCKED
               for m in sys.modules), "a blocked module was loaded"
print("imported", len(sys.argv) - 1)
"""


def test_every_module_imports_without_jax():
    mods = list(_modules())
    assert "dla_tpu_torch.models.transformer" in mods
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    assert "dla_tpu_torch.eval.package_report" in mods
    assert "dla_tpu_torch.models.hf_import" in mods
    code = f"BLOCKED = {BLOCKED!r}\n" + BLOCKER
    res = subprocess.run([sys.executable, "-c", code, *mods],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"imported {len(mods)}" in res.stdout
