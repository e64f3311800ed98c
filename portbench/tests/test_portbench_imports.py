"""Nothing the benchmark runs is JAX or the JAX package, and the reference
imports nothing of the program; top-level module names compared whole (the
port's name begins with the JAX package's)."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "oai_analysis_2_tpu"}


def _top_levels(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))  # noqa: S307 — our own printed list


def test_sources_import_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not set(_top_levels(path)) & FORBIDDEN, path


def test_reference_sources_import_nothing_of_the_program():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "oai_analysis_2_tpu_torch" not in set(_top_levels(path)), path


def test_loaded_modules():
    code = ("import portbench.run, portbench.harness, portbench.drivers.knee, portbench.drivers.train\n"
            "import oai_analysis_2_tpu_torch.engine.pipeline, oai_analysis_2_tpu_torch.models.synthetic\n"
            "import oai_analysis_2_tpu_torch.utils.optim")
    assert not _loaded_after(code) & FORBIDDEN
    ref = _loaded_after("import portbench.reference, portbench.reference.train, portbench.reference.thickness")
    assert not ref & FORBIDDEN
    assert "oai_analysis_2_tpu_torch" not in ref
