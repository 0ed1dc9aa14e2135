"""Nothing the benchmark runs loads JAX or the JAX package; the
reference loads nothing of the program either. Names are compared whole
by their top-level part."""

import ast
import subprocess
import sys
from pathlib import Path

from yardstick import imports

BENCH = Path(__file__).resolve().parents[1]
HARNESS = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def imported(path):
    """The top-level names a Python file imports, by its syntax tree
    (relative imports left out)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(imports.top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(imports.top(node.module))
    return out


def test_names_are_compared_whole():
    mods = {"horovod_tpu_torch": 1, "horovod_tpu_torch.models": 1,
            "horovod_tpux": 1, "jaxtyping": 1, "numpy": 1}
    assert imports.loaded(mods) == []
    mods.update({"horovod_tpu": 1, "horovod_tpu.ops": 1, "jax.numpy": 1,
                 "jaxlib": 1, "flax.linen": 1})
    assert imports.loaded(mods) == ["flax.linen", "horovod_tpu",
                                    "horovod_tpu.ops", "jax.numpy", "jaxlib"]


def test_no_file_of_the_harness_imports_jax():
    for path in HARNESS:
        bad = imported(path) & set(imports.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not {n for n in imported(path)
                    if n.startswith("horovod_tpu")}, path


def test_loading_the_harness_and_the_program_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run, calibrate\n"
            "from yardstick import cell, imports, spec\n"
            "b = spec.Bench(%r)\n"
            "[b.metric(m['name']) for m in b.doc['per_layer']]\n"
            "[b.entry(n) for n in ('compiled_step', 'eager_hooks')]\n"
            "b.reference('transformer_lm')\n"
            "import horovod_tpu_torch, horovod_tpu_torch.models.transformer\n"
            "print(imports.loaded())\n"
            % (str(BENCH), str(BENCH.parent), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_no_program_module():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from yardstick import spec\n"
            "spec.Bench(%r).reference('transformer_lm')\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0]"
            ".startswith('horovod_tpu')))\n"
            % (str(BENCH), str(BENCH.parent), str(BENCH.parent)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
