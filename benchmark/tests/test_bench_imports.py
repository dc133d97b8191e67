"""Nothing the benchmark runs loads JAX or the JAX package: every module
of the benchmark is read for its imports, the reference imports nothing of
the program, a whole run leaves none of them in ``sys.modules``, and a run
that finds one there prints no result and fails.  Names are compared by
their top-level part, whole (the port's name begins with the JAX
package's)."""

import ast
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from benchmark import run

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
PORT = "dphubert_torch"


def imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_of_the_benchmark_imports_jax(path):
    tops = {name.split(".")[0] for name in imports(path)}
    assert not tops & set(run.FORBIDDEN), path
    if "reference" in path.parts:
        assert tops <= {"__future__", "math", "dataclasses", "typing", "numpy", "torch"}, tops


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("dphubert_torch.ops", "jaxtyping", "benchmark.lib"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "dphubert" + "_tpu.ops", sys)
    assert run.loaded_forbidden() == ["dphubert" + "_tpu"]


def _script(body: str, tmp_path) -> subprocess.CompletedProcess:
    code = textwrap.dedent(f"""
        import sys, pathlib
        sys.path.insert(0, {str(ROOT)!r})
        from benchmark.tests import tiny
        from benchmark import run
        root = tiny.write_tree(pathlib.Path({str(tmp_path)!r}))
        {body}
        rc = run.main(["--workload", "tiny_hubert.serve", "--seed", "5", "--seconds", "0.1",
                       "--trace", "0"], root=root, device="cpu")
        print("MODULES", sorted({{m.split(".")[0] for m in sys.modules}}))
        sys.exit(rc)
    """)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})


def test_a_whole_run_loads_no_jax(tmp_path):
    proc = _script("", tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    result, modules = json.loads(lines[-2]), lines[-1]
    assert result["correct"] is True
    loaded = set(ast.literal_eval(modules[len("MODULES "):]))
    assert PORT in loaded and not loaded & set(run.FORBIDDEN)


def test_a_run_with_jax_loaded_prints_no_result(tmp_path):
    stub = tmp_path / "stub"
    stub.mkdir()
    (stub / "jax.py").write_text("")
    proc = _script(f"sys.path.insert(0, {str(stub)!r}); import jax", tmp_path)
    assert proc.returncode == 4
    assert "jax" in proc.stderr
    assert not any(l.startswith("{") for l in proc.stdout.splitlines())
