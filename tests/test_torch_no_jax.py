"""The port and chip_smoke.py run without JAX and without an image
library: an AST scan finds no import of jax, optax or flax, nor of the
JAX package, nor of cv2, imageio, PIL, yaml, trimesh, skimage or
tensorboardX (the card's machine has none of them), in any of their files (the port's config, synthetic-scene and
split modules included, its own copies of the JAX package's), and they
import in a process where those imports fail."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "s_volsdf_tpu", "cv2",
             "imageio", "PIL", "yaml", "trimesh", "skimage", "tensorboardX"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def _port_files():
    files = sorted((ROOT / "s_volsdf_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert not bad, f"{path}: {bad}"


def test_scan_sees_imports(tmp_path):
    """The scan would catch an import of JAX in any of its forms."""
    probe = tmp_path / "probe.py"
    probe.write_text("import jax\nfrom jax import numpy\nimport optax as o\n"
                     "from flax import struct\n"
                     "from s_volsdf_tpu.config import Config\n"
                     "def f():\n    import cv2\n"
                     "    import imageio.v2 as imageio\n"
                     "    from PIL import Image\n    import yaml\n"
                     "    import trimesh\n    from skimage import measure\n"
                     "    from tensorboardX import SummaryWriter\n")
    mods = {m for _, m in _imported_roots(probe)}
    assert mods == {"jax", "optax", "flax", "s_volsdf_tpu", "cv2",
                    "imageio", "PIL", "yaml", "trimesh", "skimage",
                    "tensorboardX"}


def test_imports_with_jax_blocked():
    """Every port module and chip_smoke.py import in a process where
    importing any of FORBIDDEN fails."""
    mods = ["chip_smoke"] + [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in (ROOT / "s_volsdf_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"]
    code = ("import sys\n"
            f"for m in {sorted(FORBIDDEN)!r}: sys.modules[m] = None\n"
            f"import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
