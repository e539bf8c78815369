"""Nothing a run imports is the JAX stack or the JAX package: the
harness's sources, a whole run in a fresh process, and the guard's
comparison of whole top-level names (sunscreen_tpu_torch begins with
sunscreen_tpu). The references import nothing of the program."""

import ast
import glob
import os
import subprocess
import sys
import types

from portbench import harness
from portbench.tests import tiny


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def _sources(*parts) -> list:
    return sorted(glob.glob(os.path.join(harness.HERE, *parts, "*.py")))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources() + _sources("*"):
        assert not _imports(path) & set(harness.BANNED), path


def test_references_import_nothing_of_the_program():
    for path in _sources("reference"):
        assert _imports(path) <= {"__future__", "torch", "numpy"}, path


def test_guard_compares_whole_top_level_names(monkeypatch):
    for name in ("sunscreen_tpu_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "sunscreen_tpu",
                        types.ModuleType("sunscreen_tpu"))
    assert harness.banned_modules() == ["jax", "sunscreen_tpu"]


def test_a_whole_run_imports_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {tiny.ROOT!r})\n"
        "from portbench.tests import tiny\n"
        "result, banned, _ = tiny.run('bfv8192.chi_sq.b128', traced=True)\n"
        "assert result['correct'], result\n"
        "print(banned, sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'sunscreen_tpu')))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=tiny.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] []"
