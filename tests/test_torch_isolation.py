"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package."""
import ast
import pathlib

import pytest
import torch_threads

torch_threads.apply()

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path) -> list[str]:
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def test_the_port_has_modules_and_a_smoke_script():
    assert len(FILES) > 20 and FILES[-1].exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_catches_a_banned_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import os\nfrom repro.core import futures\n"
                     "import jax.numpy as jnp\nfrom . import sibling\n")
    assert [m for m in _imports(probe) if m.split(".")[0] in BANNED] == [
        "repro.core", "jax.numpy"]
