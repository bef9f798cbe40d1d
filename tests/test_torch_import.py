"""Importing the PyTorch port must need neither JAX nor imageio nor triton
(nor sklearn nor tqdm), touch no CUDA context and build no kernel.

The card's machine has no JAX, flax, orbax, imageio, sklearn or tqdm, and
a CPU-only install has no triton: a module-level import of any of them
breaks the port there.  The port imports nothing of the JAX package, not
even its stdlib-only modules (it keeps its own copy of ``config``).
Kernels are built at their first launch, never at import.
"""

import subprocess
import sys

SCRIPT = r"""
import sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "imageio", "triton",
             "sklearn", "tqdm"):
    sys.modules[name] = None          # any import of them now fails
import importlib, pkgutil
import torch
import probav_tpu_torch

def _fail(name):
    raise ImportError(f"could not import {name}")

names = set()
for m in pkgutil.walk_packages(probav_tpu_torch.__path__,
                               "probav_tpu_torch.", onerror=_fail):
    importlib.import_module(m.name)
    names.add(m.name)
kernel_modules = {"probav_tpu_torch.ops." + n for n in (
    "tstack", "wide_block", "block_stack", "shift_table", "shift_loss")}
assert kernel_modules <= names, kernel_modules - names
preprocess_modules = {"probav_tpu_torch." + n for n in (
    "preprocess", "ops.registration", "data.pipeline", "data.ingest",
    "data.qc", "data._native", "data.augment", "data.random_patches")}
assert preprocess_modules <= names, preprocess_modules - names
jax_pkg = sorted(n for n in sys.modules
                 if n == "probav_tpu" or n.startswith("probav_tpu."))
assert jax_pkg == [], jax_pkg
assert not torch.cuda.is_initialized(), "an import initialized CUDA"
from probav_tpu_torch.ops import _build
assert _build.library.cache_info().currsize == 0, "kernels built at import"
from probav_tpu_torch.data import _native
assert _native.library.cache_info().currsize == 0, "selector built at import"
print("IMPORT_SAFE")
"""


def test_port_imports_without_jax_imageio_triton_or_cuda():
    r = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True,
                       timeout=300, text=True)
    assert r.returncode == 0, r.stderr
    assert "IMPORT_SAFE" in r.stdout


def test_chip_smoke_fails_without_cuda(tmp_path):
    """chip_smoke.py exits non-zero and prints no result line without a
    card (this machine), and equally from a directory holding nothing else
    of the repository."""
    import shutil
    from pathlib import Path

    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present")
    src = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(src, lone)
    for script in (src, lone):
        r = subprocess.run([sys.executable, str(script)], capture_output=True,
                           timeout=300, text=True, cwd=tmp_path)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    """Nor imageio, sklearn or tqdm.  Imports inside functions too (the runtime check above sees only
    module-level ones): every import statement of probav_tpu_torch/**.py
    and chip_smoke.py, read from the source."""
    import ast
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "probav_tpu_torch").rglob("*.py")) + \
        [root / "chip_smoke.py"]
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "probav_tpu",
              "imageio", "sklearn", "tqdm")
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    found.append(f"{path.relative_to(root)}: {name}")
    assert len(files) > 20
    assert found == []
