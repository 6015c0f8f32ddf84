"""What a run loads: nothing of jax or of the JAX package (``repro``,
compared by whole top-level names: the port's ``repro_torch`` begins with
it), and a reference that imports nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _python(code: str, cwd: Path = ROOT, paths=None) -> subprocess.CompletedProcess:
    paths = paths or [str(ROOT), str(ROOT / "src")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(paths))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_a_run_of_each_cell_loads_no_jax_and_no_repro():
    out = _python(
        "import json\n"
        "from portbench import harness, tiny\n"
        "lines = [tiny.run(n['name'], dtype='bfloat16', trace=t, guard=True)[0]"
        " for n in harness.load_spec()['workloads'] for t in (False, True)]\n"
        "print(json.dumps([l is not None for l in lines]))\n"
        "print(json.dumps(harness.forbidden_modules()))\n")
    assert out.returncode == 0, out.stderr[-3000:]
    ran, found = (json.loads(l) for l in out.stdout.strip().splitlines()[-2:])
    assert ran and all(ran)
    assert found == []


def test_the_check_is_by_whole_top_level_names():
    out = _python(
        "import sys, types\n"
        "from portbench import harness\n"
        "sys.modules['repro_torch_x'] = types.ModuleType('repro_torch_x')\n"
        "sys.modules['jaxlike'] = types.ModuleType('jaxlike')\n"
        "a = harness.forbidden_modules()\n"
        "sys.modules['repro.core'] = types.ModuleType('repro.core')\n"
        "print(a, harness.forbidden_modules())\n")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[] ['repro.core']"


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro",
                                               "jax", "portbench"), (path, n)
    out = _python("import sys\n"
                  "import portbench.reference.decoder, "
                  "portbench.reference.weights\n"
                  "print(sorted(m for m in sys.modules "
                  "if m.split('.')[0] in ('repro_torch', 'repro', 'jax')))")
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"


def _cli(cwd: Path) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "phi4-serve-chat",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=240)


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_with_only_the_benchmark_files_the_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""
