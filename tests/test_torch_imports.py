"""The port imports no JAX and nothing of the JAX package.

An AST scan of every module of horovod_tpu_torch/, of the scripts
that drive the port on a card that has no JAX (chip_smoke.py,
chip_profile.py) and of the port's own examples (examples/torch_port/).
A scan and not
``sys.modules``: the test process imports JAX anyway, for the parity
tests beside this one.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "horovod_tpu_torch"
FILES = sorted(str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py"))
FILES += ["chip_smoke.py", "chip_profile.py"]
FILES += sorted(str(p.relative_to(REPO))
                for p in (REPO / "examples" / "torch_port").glob("*.py"))
BANNED = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _banned(name):
    top = name.split(".")[0]
    return top in BANNED


def _imports(path, root=REPO):
    """(line, module) of every import, relative ones resolved against
    the file's package; a relative import that climbs out of the
    package resolves to '..' and is reported."""
    rel = path.relative_to(root)
    package = list(rel.parent.parts)
    out = []
    for node in ast.walk(ast.parse(path.read_text(), str(rel))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                out.append((node.lineno, node.module))
                continue
            if node.level > len(package):
                out.append((node.lineno, ".."))
                continue
            base = package[:len(package) - node.level + 1]
            out.append((node.lineno,
                        ".".join(base + ([node.module] if node.module
                                         else []))))
    return out


def test_scan_covers_the_package():
    assert "horovod_tpu_torch/ops/flash_attention.py" in FILES
    assert "examples/torch_port/transformer_long_context.py" in FILES
    assert (REPO / "chip_smoke.py").exists()


@pytest.mark.parametrize("rel", FILES)
def test_imports_no_jax_and_nothing_of_horovod_tpu(rel):
    bad = [(line, mod) for line, mod in _imports(REPO / rel)
           if mod == ".." or _banned(mod)]
    assert not bad, f"{rel} imports {bad}"


def test_scan_catches_a_banned_import(tmp_path):
    probe = tmp_path / "horovod_tpu_torch" / "ops" / "probe.py"
    probe.parent.mkdir(parents=True)
    probe.write_text("import jax.numpy as jnp\n"
                     "from horovod_tpu.serve import api\n"
                     "from ... import horovod_tpu\n"
                     "from ..serve import engine\n"
                     "import horovod_tpu_torch\n")
    found = _imports(probe, tmp_path)
    assert [m for _, m in found if m == ".." or _banned(m)] == \
        ["jax.numpy", "horovod_tpu.serve", ".."]
    assert (4, "horovod_tpu_torch.serve") in found
