"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and no script of ``scripts/`` imports JAX or the JAX
package ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py"))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_sources_found():
    assert len(SOURCES) > 20
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
            / "lns_mac.cu").exists()
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for pkg in ("distributed", "kernels/lns_boxsum", "obs", "resil",
                "launch", "nn", "configs", "optim", "data", "train", "ckpt",
                "serve", "search"):
        assert f"src/repro_torch/{pkg}/__init__.py" in names, pkg


@pytest.mark.parametrize("module", [
    "repro_torch.paper", "repro_torch.distributed",
    "repro_torch.kernels.lns_boxsum", "repro_torch.kernels.lns_matmul",
    "repro_torch.obs", "repro_torch.resil", "repro_torch.launch.drill",
    "repro_torch.launch.train", "repro_torch.core.qat",
    "repro_torch.core.numerics", "repro_torch.nn.moe", "repro_torch.nn.ssm",
    "repro_torch.nn.paged", "repro_torch.serve",
    "repro_torch.serve.engine", "repro_torch.serve.queue",
    "repro_torch.serve.paged_cache", "repro_torch.launch.serve",
    "repro_torch.search", "repro_torch.launch.search",
    "repro_torch.kernels.autotune"])
def test_import_loads_no_jax(module):
    """Importing the module in a fresh interpreter loads neither JAX nor
    the JAX package."""
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
