"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the program: by the sources' imports, and at run
time.  Module names are compared by their whole top-level name, so the
port (``audio_fewshot_tpu_torch``) is not the JAX package
(``audio_fewshot_tpu``)."""

import ast
import subprocess
import sys

import pytest

from gpu_bench import manifest
from gpu_bench.run import FORBIDDEN, forbidden_modules

SOURCES = sorted(p for p in manifest.HERE.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((manifest.HERE / "reference").glob("*.py"))


def imported(path):
    """``(level, top-level name)`` of every import in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield 0, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield node.level, (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(manifest.HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not [name for level, name in imported(path) if level == 0 and name in FORBIDDEN]


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for level, name in imported(path):
        assert level <= 1, "the reference reaches outside its package"
        assert level == 1 or name in ("__future__", "contextlib", "dataclasses", "math",
                                      "typing", "numpy", "torch"), name


def test_whole_top_level_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "audio_fewshot_tpu_torch_probe", object())
    assert "audio_fewshot_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "audio_fewshot_tpu.probe", object())
    assert "audio_fewshot_tpu" in forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    """Every module of the benchmark and the port's entries it drives,
    imported in a fresh process as a run imports them."""
    code = ("import sys\n"
            "from gpu_bench import run, manifest, calibrate, faults\n"
            "run.prepare_environment()\n"
            "import audio_fewshot_tpu_torch.eval\n"
            "for name in ('deepbdc-eval-b16', 'protonet-eval-b16', 'deepbdc-episode'):\n"
            "    cell = manifest.load_cell(name)\n"
            "    manifest.driver(cell); manifest.reference(cell); manifest.flops(cell)\n"
            "    [manifest.reader(m['name']) for m in cell.per_layer]\n"
            "from audio_fewshot_tpu_torch.utils.meters import TensorboardWriter\n"
            "TensorboardWriter('unused', enabled=True)\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
