"""The PyTorch port's single-session slice against the JAX reference.

The same forced-cost notebook goes through both packages' ``run_notebook``
single-session paths on the CPU: decisions must be equal, ``migrated_bytes``
equal, and ``modeled_seconds`` within rtol 1e-12 (the reference itself drifts
in the last ULP between runs, see ROADMAP queue C).  The port's table2 and
fig11 rows must equal a live reference run.  The port must import and run
without jax, and no module of it may import jax, ml_dtypes or ``repro``.

The notebooks define no functions: a function travels by value, and its
pickle names each package's own rebuild helper, so those bytes differ by
the module name (see ROADMAP queue C).
"""
import ast
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch.notebook import run_notebook as ref_run  # noqa: E402
from repro_torch.launch import notebook as port_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

CELLS = [
    ("import numpy as np\n"
     "rng = np.random.default_rng(0)\n"
     "xs = rng.standard_normal(60000)\n"
     "img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)\n"
     "tree = {'w': xs[:700].astype(np.float32), "
     "'b': [xs[:9], (np.arange(5, dtype=np.int32),)], 'c': None}\n"
     "scratch = np.zeros((200, 200))\n", 0.3),
    ("feat = img.astype(np.float32) / 255.0\n"
     "y = float((xs ** 2).sum()) + float(tree['w'].sum())\n", 15.0),
    ("z = y + 1\nxs = xs * 1.0001\n", 0.1),
    ("stats = [float(feat.mean()), float(np.abs(xs).max())]\n", 8.0),
]


def _ipynb(tmp_path) -> str:
    nb = {"nbformat": 4, "nbformat_minor": 5, "metadata": {"name": "slice"},
          "cells": [{"id": f"c{i}", "cell_type": "code",
                     "metadata": {"repro": {"cost": cost}}, "source": src}
                    for i, (src, cost) in enumerate(CELLS)]}
    p = tmp_path / "slice.ipynb"
    p.write_text(json.dumps(nb))
    return str(p)


@pytest.mark.parametrize("policy", ["block", "single", "cost", "horizon"])
@pytest.mark.parametrize("codec", ["zlib", "none", "quant8+zstd"])
def test_single_session_matches_reference(tmp_path, codec, policy):
    path = _ipynb(tmp_path)
    want, _ = ref_run(path, sessions=3, codec=codec, policy=policy)
    got, _ = port_cli.run_notebook(path, sessions=3, codec=codec,
                                   policy=policy, device="cpu")
    assert got["decisions"] == want["decisions"]
    assert got["migrated_bytes"] == want["migrated_bytes"]
    assert got["migrations"] == want["migrations"]
    assert got["modeled_seconds"] == pytest.approx(want["modeled_seconds"],
                                                   rel=1e-12)
    assert got["migrations"] > 0


def _port_benchmark(name: str) -> types.ModuleType:
    """A benchmark module of the reference with its imports rebound to the
    port and the port's reducer on the CPU."""
    path = ROOT / "benchmarks" / f"{name}.py"
    src = path.read_text().replace("from repro.core import",
                                   "from repro_torch.core import")
    mod = types.ModuleType(f"port_{name}")
    exec(compile(src, str(path), "exec"), mod.__dict__)  # noqa: S102
    if hasattr(mod, "StateReducer"):
        mod.StateReducer = functools.partial(mod.StateReducer, device="cpu")
    return mod


def _assert_rows_equal(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    for (label, g, _), (_, w, _) in zip(got, want):
        assert g == pytest.approx(w, rel=1e-12), label


@pytest.mark.parametrize("name", ["table2_state_sizes",
                                  "fig11_knowledge_policy"])
def test_benchmark_rows_match_a_live_reference_run(name, monkeypatch):
    """table2's full state holds a cell-defined function (``sobel``); its
    pickle names the package's rebuild helper.  With the port's helper
    standing in under the reference's name, every row is equal."""
    import importlib

    import repro.core.reducer as ref_reducer
    import repro_torch.core.reducer as port_reducer
    want = importlib.import_module(f"benchmarks.{name}").run(smoke=True)
    monkeypatch.setattr(port_reducer, "_make_function",
                        ref_reducer._make_function)
    _assert_rows_equal(_port_benchmark(name).run(smoke=True), want)


def test_function_pickles_differ_only_by_the_helper_module_name():
    import importlib
    want = dict((r[0], r[1]) for r in importlib.import_module(
        "benchmarks.table2_state_sizes").run(smoke=True))
    got = dict((r[0], r[1]) for r in
               _port_benchmark("table2_state_sizes").run(smoke=True))
    # full states carry ``sobel`` once; reduced states never need it
    extra = len("repro_torch") - len("repro")
    for k in want:
        if k.endswith("_bytes"):
            assert got[k] - want[k] == (extra if "full_state" in k else 0), k


_ISOLATED = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["ml_dtypes"] = None
from repro_torch.core import ExecutionEnvironment, MigrationEngine, StateReducer
local = ExecutionEnvironment("local")
remote = ExecutionEnvironment("remote", speedup=8.0)
local.execute('''
import numpy as np
corpus = np.arange(200000, dtype=np.float32)   # needed by the cell
scratch = np.zeros((1000, 1000))               # NOT needed -> pruned
def summarize(x):
    return float(x.mean())
''')
engine = MigrationEngine(StateReducer(codec="zlib", device="cpu"),
                         bandwidth=1e9, latency=0.1)
cell = "report = summarize(corpus)"
m1 = engine.migrate(local, remote, cell)
m2 = engine.migrate(local, remote, cell)
remote.execute(cell)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(repr((m1.names, m2.names, m2.nbytes, remote.state["report"], loaded)))
"""


def test_port_runs_the_quickstart_migration_without_jax():
    env = {k: os.environ[k] for k in ("HOME", "TMPDIR", "PATH")
           if k in os.environ}
    out = subprocess.run([sys.executable, "-c", _ISOLATED],
                         capture_output=True, text=True, timeout=120,
                         env={**env, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    m1, m2, m2_bytes, report, loaded = eval(out.stdout.strip())  # noqa: S307
    assert m1 == ("corpus", "summarize")            # scratch pruned
    assert m2 == () and m2_bytes == 0               # delta: nothing moves
    assert report == 99999.5
    assert loaded == []


_ISOLATED_SERVE = r"""
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["ml_dtypes"] = None
import repro_torch.configs
import repro_torch.models
import repro_torch.models.griffin
from repro_torch.launch.serve import serve_lm
shapes = []
for arch, prompt in (("yi-6b", 12), ("mamba2-370m", 40),
                     ("recurrentgemma-9b", 40)):
    out = serve_lm(repro_torch.configs.get_config(arch, reduced=True),
                   batch=2, prompt_len=prompt, gen=3, device="cpu")
    shapes.append(out["ids"].shape)
loaded = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
print(repr((shapes, loaded)))
"""


def test_port_serves_a_reduced_lm_without_jax():
    env = {k: os.environ[k] for k in ("HOME", "TMPDIR", "PATH")
           if k in os.environ}
    out = subprocess.run([sys.executable, "-c", _ISOLATED_SERVE],
                         capture_output=True, text=True, timeout=120,
                         env={**env, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    shapes, loaded = eval(out.stdout.strip())  # noqa: S307
    assert shapes == [(2, 3), (2, 3), (2, 3)]
    assert loaded == []


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_module_imports_jax_ml_dtypes_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes", "repro"), (f, name)


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    path = _ipynb(tmp_path)
    report = tmp_path / "report.json"
    port_cli.main([path, "--sessions", "2", "--device", "cpu",
                   "--report", str(report)])
    assert "per-cell decisions" in capsys.readouterr().out
    rep = json.loads(report.read_text())
    assert rep["device"] == "cpu" and rep["migrations"] > 0
    assert len(rep["migration_log"]) == rep["migrations"]


@pytest.mark.parametrize("flag", [["--fleet", "2"], ["--race"],
                                  ["--replicas", "1"], ["--autoscale"]])
def test_cli_names_the_options_not_ported_yet(tmp_path, capsys, monkeypatch,
                                              flag):
    """The options the port once turned away are ported: each one parses,
    runs or is refused exactly as the reference's CLI does it."""
    from test_torch_notebook_cli import assert_cli_agrees
    assert_cli_agrees([_ipynb(tmp_path), *flag], monkeypatch, capsys)


def test_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.run_notebook(_ipynb(tmp_path), sessions=1)
