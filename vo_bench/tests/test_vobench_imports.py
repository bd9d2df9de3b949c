"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port.  Top-level names are compared
whole: the port's name begins with the JAX package's."""

import ast
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "stereo_semantic_vo_tpu"}
PORT = "stereo_semantic_vo_tpu_torch"


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources(under):
    for d, _, files in os.walk(under):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    seen = {p: set(imports(p)) & FORBIDDEN for p in sources(HERE)}
    assert len(seen) > 20
    assert not {p: s for p, s in seen.items() if s}


def test_top_level_names_are_compared_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("stereo_semantic_vo_tpu")


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "contextlib", "contextvars", "dataclasses", "functools", "math", "typing",
               "collections", "numpy", "torch", "vo_bench"}
    for p in sources(os.path.join(HERE, "reference")):
        names = set(imports(p))
        assert PORT not in names, p
        assert names <= allowed, (p, names - allowed)
        with open(p) as f:
            assert PORT + "." not in f.read(), p   # no import by string either


def test_the_reference_detector_loads_neither_jax_nor_either_package():
    """Imported alone, in a fresh interpreter, the plain darknet reference
    leaves no module of JAX, the JAX package or the port loaded."""
    import subprocess
    import sys

    code = ("import sys; import vo_bench.reference.detector; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', "
            "'stereo_semantic_vo_tpu', 'stereo_semantic_vo_tpu_torch'}))")
    root = os.path.dirname(HERE)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=root))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert set(imports(os.path.join(HERE, "reference", "detector.py"))) <= {"__future__", "contextlib", "math",
                                                                             "typing", "numpy", "torch", "vo_bench"}
