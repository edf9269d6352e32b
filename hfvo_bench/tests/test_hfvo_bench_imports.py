"""Nothing the harness runs imports JAX or the JAX package (top-level
module names compared whole), and the reference imports nothing of the
program either."""
import ast
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "hfvo_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    code = ("import hfvo_bench.run as r, hfvo_bench.control, hfvo_bench.trace, hfvo_bench.roofline\n"
            "for w in ('vo_orbit', 'batch8_orbit'):\n"
            "    for t in (0, 1):\n"
            "        f = r.discover(r.ROOT, w, t)\n"
            "        f['driver'].Driver\n"
            "from hfvo_tpu_torch.system import VOSystem\n"
            "from hfvo_tpu_torch.parallel.multiseq import BatchTracker\n")
    mods = _loaded(code)
    assert "hfvo_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import hfvo_bench.reference.fast, hfvo_bench.reference.pyramid, hfvo_bench.reference.sobel, "
                   "hfvo_bench.reference.hough, hfvo_bench.reference.ba, hfvo_bench.reference.poses, hfvo_bench.gen")
    assert not mods & (FORBIDDEN | {"hfvo_tpu_torch"})
    for path in (ROOT / "hfvo_bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            assert not {n.split(".")[0] for n in names} & (FORBIDDEN | {"hfvo_tpu_torch"}), (path, names)
