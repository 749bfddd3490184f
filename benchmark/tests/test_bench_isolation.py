"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference uses nothing of the program."""

import ast
import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gpuseqalign_tpu"}


def _top_level_after(code: str, cwd: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    loaded = _top_level_after(
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "for w in ('upstream_nw_lg.pg1_tiny', "
        "'upstream_nw_lg.release_tiny'):\n"
        "    for t in (False, True):\n"
        "        harness.run_cell(w, 3, 0.1, t, device='cpu', root=%r)"
        % (ROOT, tiny_root, tiny_root), tiny_root)
    assert "gpuseqalign_tpu_torch" in loaded  # the port did run
    assert not loaded & FORBIDDEN


def test_run_py_names_what_it_finds():
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    fake = ["jax.numpy", "gpuseqalign_tpu.core", "flax"]
    for name in fake:
        sys.modules.setdefault(name, type(sys)(name))
    try:
        assert run.forbidden_modules() == ["flax", "gpuseqalign_tpu", "jax"]
    finally:
        for name in fake:
            del sys.modules[name]
    assert "gpuseqalign_tpu" not in run.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_the_reference_imports_torch_numpy_and_the_standard_library():
    ref = os.path.join(ROOT, "benchmark", "reference")
    allowed = {"__future__", "typing", "numpy", "torch"}
    for name in os.listdir(ref):
        if name.endswith(".py"):
            mods = {m.split(".")[0] for m in _imports(os.path.join(ref, name))}
            assert mods <= allowed, (name, mods)


def test_importing_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.reference.dp" % ROOT, ROOT)
    assert not loaded & (FORBIDDEN | {"gpuseqalign_tpu_torch"})
