"""The port's launchers against the JAX reference's, on the CPU: the fleet
cases of ``tests/test_notebook_cli.py``, every option of the reference's
notebook runner that the port once turned away, and the server's
notebook-fleet and gateway modes.

The port runs with ``--device cpu``.  Its reports carry the reference's
keys (compared: equal, floats within rtol 1e-12, wall-clock fields aside)
plus its own (the reducer's device, chunk keys, per-session bytes and wall
seconds), which are checked where they say something.
"""
import json
import sys

import pytest

torch = pytest.importorskip("torch")

from test_torch_fleet import _cpu_budget, assert_same  # noqa: E402,F401

import repro.launch.notebook as ref_cli  # noqa: E402
import repro.launch.serve as ref_serve  # noqa: E402
import repro_torch.launch.notebook as port_cli  # noqa: E402
import repro_torch.launch.serve as port_serve  # noqa: E402

CLI = {"reference": ref_cli, "port": port_cli}
WALL_KEYS = ("transfer_wall_seconds", "decision_ms_p99", "wall_seconds")


def strip(rep):
    """A report without its wall-clock keys."""
    if isinstance(rep, dict):
        return {k: strip(v) for k, v in rep.items() if k not in WALL_KEYS}
    if isinstance(rep, list):
        return [strip(v) for v in rep]
    return rep


def project(port, ref):
    """The port's report cut to the reference's keys."""
    if isinstance(ref, dict):
        assert set(ref) <= set(port), set(ref) - set(port)
        return {k: project(port[k], ref[k]) for k in ref}
    if isinstance(ref, list) and isinstance(port, list) \
            and len(port) == len(ref):
        return [project(p, r) for p, r in zip(port, ref)]
    return port


def assert_reports_agree(port, ref):
    """Through JSON, so tuples and lists compare alike."""
    ref = json.loads(json.dumps(strip(ref)))
    port = json.loads(json.dumps(strip(port)))
    assert_same(project(port, ref), ref)


def _demo_ipynb(tmp_path):
    nb = {"nbformat": 4, "nbformat_minor": 5, "metadata": {"name": "t"},
          "cells": [
              {"id": "c0", "cell_type": "code",
               "metadata": {"repro": {"cost": 0.3}},
               "source": "import numpy as np\nxs = np.arange(1000.0)"},
              {"id": "c1", "cell_type": "markdown", "metadata": {},
               "source": "# only code cells are managed"},
              {"id": "c2", "cell_type": "code",
               "metadata": {"repro": {"cost": 15.0}},
               "source": "y = float((xs ** 2).sum())"},
              {"id": "c3", "cell_type": "code",
               "metadata": {"repro": {"cost": 0.1}},
               "source": "z = y + 1"},
          ]}
    p = tmp_path / "demo.ipynb"
    p.write_text(json.dumps(nb))
    return str(p)


def run_both(path, **kw):
    ref, _ = ref_cli.run_notebook(path, **kw)
    port, _ = port_cli.run_notebook(path, device="cpu", **kw)
    assert_reports_agree(port, ref)
    return port, ref


# -- the fleet cases of tests/test_notebook_cli.py ---------------------------

def test_socket_transport_rejects_fleet_mode(tmp_path):
    path = _demo_ipynb(tmp_path)
    msgs = []
    for name, cli in CLI.items():
        kw = {"device": "cpu"} if name == "port" else {}
        with pytest.raises(ValueError, match="incompatible") as e:
            cli.run_notebook(path, fleet=2, transport="socket", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_run_notebook_fleet_over_fabric(tmp_path):
    port, _ = run_both(
        _demo_ipynb(tmp_path), sessions=2, policy="cost",
        use_knowledge=False, extra_envs=["tpu-mesh:40:1"],
        links=["local:tpu-mesh:1e8:0.5"], fleet=3)
    assert port["fleet"] == 3 and len(port["per_session"]) == 3
    assert port["makespan"] > 0
    assert set(port["env_utilization"]) == {"local", "remote", "tpu-mesh"}
    assert port["device"] == "cpu"
    assert all(s["device"] == "cpu" for s in port["per_session"])
    assert {k: len(v) for k, v in port["chunk_keys"].items()} \
        == port["chunks_held"]


def test_run_notebook_fleet_with_workload_and_recovery(tmp_path):
    port, _ = run_both(
        _demo_ipynb(tmp_path), sessions=2, policy="cost",
        use_knowledge=False, fleet=3, arrivals=0.1, think_time=2.0, seed=7,
        fail_envs=[("remote", 10.0, 20.0)], recovery="checkpoint",
        checkpoint_interval=5.0)
    assert port["failures"] == [("remote", 10.0)]
    assert port["total_think_time"] > 0.0
    assert any(s["arrival"] > 0.0 for s in port["per_session"])
    assert port["lifecycle_events"]
    for s in port["per_session"]:
        log = port["migration_logs"][next(
            k for k in port["migration_logs"] if k.startswith(s["session"]))]
        assert s["migrated_bytes"] == sum(m["nbytes"] for m in log)


def test_run_notebook_fleet_with_replication(tmp_path):
    port, _ = run_both(_demo_ipynb(tmp_path), sessions=2, policy="cost",
                       use_knowledge=False, fleet=2, replicate=True,
                       think_time=4.0)
    assert port["replicate"] is True and port["trickled_bytes"] >= 0
    for s in port["per_session"]:
        assert "trickled_bytes" in s and "trickle_claimed_bytes" in s


def test_parse_fail_spec():
    for cli in CLI.values():
        assert cli.parse_fail_spec("remote:30") == ("remote", 30.0, None)
        assert cli.parse_fail_spec("remote:30:60") == ("remote", 30.0, 60.0)
        with pytest.raises(ValueError, match="expected env:time"):
            cli.parse_fail_spec("remote")
        with pytest.raises(ValueError, match="must be numbers"):
            cli.parse_fail_spec("remote:soon")


def test_parse_rate_spec():
    for cli in CLI.values():
        p = cli.parse_rate_spec
        assert p("50MB/s") == pytest.approx(50e6)
        assert p("2.5KB") == pytest.approx(2500.0)
        assert p("1e6") == pytest.approx(1e6)
        assert p("3GB/s") == pytest.approx(3e9)
        for bad in ("fast", "0MB/s", "-5KB", "", "MB/s"):
            with pytest.raises(ValueError):
                p(bad)


def _main(name, argv, monkeypatch, capsys):
    """One CLI run: (exit code, stdout, stderr's last line)."""
    monkeypatch.setattr(sys, "argv", ["notebook", *argv])
    code = 0
    try:
        if name == "port":
            port_cli.main([*argv, "--device", "cpu"])
        else:
            ref_cli.main()
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    lines = out.err.strip().splitlines()
    return code, out.out, lines[-1] if lines else ""


def _report(stdout):
    return json.loads(stdout.split("\nper-cell decisions:")[0])


def assert_cli_agrees(argv, monkeypatch, capsys):
    """Both CLIs on one command line: the same exit code; an argparse
    error word for word; a run's report equal."""
    ref = _main("reference", argv, monkeypatch, capsys)
    port = _main("port", argv, monkeypatch, capsys)
    assert port[0] == ref[0], (port, ref)
    assert "is not ported" not in port[2]
    if ref[0]:
        assert port[2] == ref[2] and "error:" in ref[2]
        assert "Traceback" not in port[2]
        return None
    assert_reports_agree(_report(port[1]), _report(ref[1]))
    return _report(port[1])


@pytest.mark.parametrize("bad", [
    ["--env", "remote:5"], ["--env", "foo:abc"], ["--link", "a:b:xx:1"],
    ["--fail-env", "remote:soon"], ["--fail-env", "nosuch:5", "--fleet", "2"],
    ["--replicate"], ["--trickle-rate", "10MB/s"],
    ["--fleet", "2", "--replicate", "--trickle-rate", "slow"],
    ["--fleet", "2", "--replicate", "--transport", "socket"],
], ids=lambda a: " ".join(a))
def test_main_reports_spec_errors_as_the_reference_does(
        bad, tmp_path, monkeypatch, capsys):
    assert_cli_agrees([_demo_ipynb(tmp_path), *bad], monkeypatch, capsys)


# -- every option the port's runner once turned away ---------------------------

FLEET = ["--fleet", "2", "--policy", "cost", "--no-knowledge"]
ONCE_REJECTED = {
    "--workload": ["--workload", "gpu-training", "--fleet", "2",
                   "--sessions", "1"],
    "--fleet": FLEET,
    "--arrivals": FLEET + ["--arrivals", "0.2"],
    "--think-time": FLEET + ["--think-time", "3"],
    "--seed": FLEET + ["--arrivals", "0.2", "--think-time", "3",
                       "--seed", "4"],
    "--fail-env": FLEET + ["--fail-env", "remote:5:10"],
    "--recovery": FLEET + ["--fail-env", "remote:5:10",
                           "--recovery", "rerun"],
    "--checkpoint-interval": FLEET + ["--fail-env", "remote:5:10",
                                      "--recovery", "checkpoint",
                                      "--checkpoint-interval", "2"],
    "--autoscale": FLEET + ["--env", "burst:10:1:down", "--autoscale",
                            "--arrivals", "0.5", "--think-time", "2"],
    "--replicate": FLEET + ["--think-time", "4", "--replicate"],
    "--trickle-rate": FLEET + ["--think-time", "4", "--replicate",
                               "--trickle-rate", "2MB/s"],
    "--liveness": FLEET + ["--think-time", "4", "--replicate",
                           "--liveness", "off"],
    "--replicas": FLEET + ["--think-time", "2", "--replicas", "1",
                           "--env", "standby:10:1"],
    "--race": FLEET + ["--think-time", "2", "--replicas", "1",
                       "--env", "standby:10:1", "--race", "on"],
    "--hazard": FLEET + ["--env", "spot:8:2", "--hazard", "spot:600/h",
                         "--recovery", "checkpoint"],
}


@pytest.mark.parametrize("flag", sorted(ONCE_REJECTED))
def test_every_reference_option_parses_and_runs(flag, tmp_path, monkeypatch,
                                                capsys):
    argv = ONCE_REJECTED[flag]
    if flag != "--workload":
        argv = [_demo_ipynb(tmp_path), *argv]
    rep = assert_cli_agrees(argv, monkeypatch, capsys)
    assert rep is not None and rep["fleet"] == 2 and rep["device"] == "cpu"


def test_replicas_given_twice_is_an_error(tmp_path, monkeypatch, capsys):
    argv = [_demo_ipynb(tmp_path), *FLEET, "--replicas", "1",
            "--replicas", "2"]
    assert assert_cli_agrees(argv, monkeypatch, capsys) is None


# -- the server's notebook-fleet mode (its gateway mode: test_torch_gateway) --

def serve_cli(argv, capsys):
    """``python -m repro_torch.launch.serve ARGV --device cpu``: its JSON."""
    port_serve.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "ok"
    return json.loads("\n".join(out[:-1]))


def test_serve_notebook_fleet_equals_the_reference(capsys):
    port = serve_cli(["--notebook-fleet", "8"], capsys)
    assert port["device"] == "cpu" and port["sessions"] == 8
    assert_reports_agree(port, ref_serve.serve_notebook_fleet(8))
