"""Port parity of ``python -m repro_torch.deploy`` (``deploy/cli.py``)
against the JAX package's CLI (``tests/test_deploy_cli.py``), in process
with ``--device cpu``: the ``--smoke`` sweep, ``report``, ``replay`` and
``--plan`` print and write what the reference prints and writes, wall times
aside. Without ``--device cpu`` and without a card, the CLI refuses."""
import json
import os

import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.deploy import cli as r_cli  # noqa: E402

from repro_torch.deploy import cli as p_cli  # noqa: E402

CPU = ["--device", "cpu"]


def _run(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out


def _rows(out):
    """CSV rows without the wall-time column and the '# wrote' lines."""
    return [line.rsplit(",", 1)[0] for line in out.strip().splitlines()
            if not line.startswith("#")]


def _strip_times(obj):
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("stage_times_s", "wall_time_s")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def test_smoke_sweep_matches_reference(tmp_path, capsys):
    ref_json, port_json = tmp_path / "ref.json", tmp_path / "port.json"
    ref = _run(capsys, r_cli.main, ["--smoke", "--json", str(ref_json)])
    port = _run(capsys, p_cli.main, ["--smoke", "--json", str(port_json)]
                + CPU)
    assert _rows(port)[0] == ",".join(p_cli.COLUMNS[:-1])
    assert len(_rows(port)) == 7              # header + 3 methods x 2 objs
    assert _rows(port) == _rows(ref)
    assert _strip_times(json.loads(port_json.read_text())) == \
        _strip_times(json.loads(ref_json.read_text()))


def test_report_matches_reference(tmp_path, capsys):
    argv = ["report", "--topology", "hier:2x2:2x2", "--method", "sa",
            "--budget", "200", "--objective", "max_link", "--top-k", "4"]
    ref = _run(capsys, r_cli.main, argv + ["--json", str(tmp_path / "r")])
    port = _run(capsys, p_cli.main, argv + ["--json", str(tmp_path / "p")]
                + CPU)
    assert "flow report" in port and "interchip bytes" in port
    assert port.replace(str(tmp_path / "p"), "") == \
        ref.replace(str(tmp_path / "r"), "")
    r, p = (json.loads((tmp_path / x).read_text()) for x in ("r", "p"))
    assert p["flow"] == r["flow"]
    assert _strip_times(p["plan"]) == _strip_times(r["plan"])


def test_replay_matches_reference(tmp_path, capsys):
    argv = ["replay", "--cores", "16", "--scenario",
            "steps=4;drift=diurnal:0.6:4;fault=link:5@1", "--budget", "48",
            "--threshold", "0.05", "--migration-weight", "0.1",
            "--compare-cold"]
    ref = _run(capsys, r_cli.main, argv + ["--json", str(tmp_path / "r")])
    port = _run(capsys, p_cli.main, argv + ["--json", str(tmp_path / "p")]
                + CPU)
    assert "recoveries" in port and "final placement" in port
    assert port.replace(str(tmp_path / "p"), "") == \
        ref.replace(str(tmp_path / "r"), "")
    assert json.loads((tmp_path / "p").read_text()) == \
        json.loads((tmp_path / "r").read_text())


def test_plan_flag_reuses_a_served_plan(tmp_path, capsys):
    """A DeployResponse saved by the port's service drives ``report`` and
    ``replay --plan`` in both packages to the same output."""
    from repro_torch.core.noc import NoC
    from repro_torch.deploy import DeployRequest, PlacementService
    from repro_torch.snn import spike_resnet18

    req = DeployRequest.from_call(spike_resnet18(n_classes=10, in_res=32,
                                                 T=4), NoC(4, 4),
                                  method="sa", budget=80, schedule="none")
    resp = PlacementService(device="cpu").submit(req)
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(resp.to_dict()))
    for argv in (["report", "--plan", str(path), "--top-k", "3"],
                 ["replay", "--plan", str(path), "--scenario",
                  "steps=3;fault=link:5@1", "--budget", "32"]):
        ref = _run(capsys, r_cli.main, argv)
        port = _run(capsys, p_cli.main, argv + CPU)
        assert port == ref


@pytest.mark.parametrize("argv", [
    ["--cores", "33"] + CPU,                      # unknown grid
    ["--models", "nope"] + CPU,                   # unknown model
    ["--topology", "bogus:4x4"] + CPU,            # bad topology kind
    ["--topology", "hier:2x2"] + CPU,             # missing core grid
    ["--smoke", "--backend", "device"] + CPU,     # device runs sa/ga only
    ["report", "--plan", "/nonexistent/plan.json"] + CPU,
])
def test_cli_rejects_bad_specs(argv, capsys):
    with pytest.raises(SystemExit):
        p_cli.main(argv)


def test_runs_on_the_card_unless_told_otherwise(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--smoke"], ["report"], ["replay", "--scenario", "steps=1"],
                 ["serve"]):
        with pytest.raises(SystemExit):
            p_cli.main(argv)
        assert "CUDA is not available" in capsys.readouterr().err
