"""Whole runs of the harness on the CPU at a small size: a sound run of
each kind comes out correct; a run with the program's timed path broken
underneath comes out not correct, once for each fault a cell can have; a
cell, a configuration, a traffic mix and a metric added as new files and
entries run without an edit of any file the benchmark has."""
import json

import pytest

from portbench import run as run_mod

TRAIN = "tiny_lowrank.tiny_train_flat"
SERVE = "tiny_lowrank.tiny_serve_orbit"


def one_run(root, capsys, cell, seed=3_000_000_017, trace=0):
    """The result of one CPU run of ``cell``, and its exit code."""
    rc = run_mod.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.5", "--trace", str(trace)], root=root,
                      device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 else None)


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_sound_run_is_correct(tiny_root, capsys, cell):
    rc, res = one_run(tiny_root, capsys, cell)
    assert rc == 0 and res["correct"], res
    assert list(res)[-1] == "check"
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert len(res["metrics"]) >= 2
    for k, v in res["check"].items():
        assert v["value"] <= v["limit"], k


def test_traced_run_reports_per_layer(tiny_root, capsys):
    rc, res = one_run(tiny_root, capsys, SERVE, trace=1)
    assert rc == 0 and res["correct"]
    assert "rounds_per_frame" in res["metrics"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _state_unchanged(monkeypatch):
    from mfnerf_tpu_torch import train
    configure = train.NeRFSystem.configure

    def broken(self, seed=0):
        configure(self, seed)
        self.optimizer.step = lambda *a, **k: None
    monkeypatch.setattr(train.NeRFSystem, "configure", broken)


def _half_batch(monkeypatch):
    from mfnerf_tpu_torch import train
    step_loss = train.NeRFSystem.step_loss

    def broken(self, img, pix, noise, bg=None, grad_noise=None):
        k = img.shape[0] // 2
        return step_loss(self, img[:k], pix[:k], noise[:k], bg, grad_noise)
    monkeypatch.setattr(train.NeRFSystem, "step_loss", broken)


def _answer_altered(monkeypatch):
    from mfnerf_tpu_torch.models import rendering
    render_test = rendering.render_test

    def broken(*args, **kwargs):
        out = render_test(*args, **kwargs)
        out["rgb"] = out["rgb"] + 0.01
        return out
    broken.host_reads = 0      # the serving loop counts its reads here
    monkeypatch.setattr(rendering, "render_test", broken)


@pytest.mark.parametrize("cell, fault", [
    (TRAIN, _state_unchanged), (TRAIN, _half_batch),
    (SERVE, _answer_altered)])
def test_broken_timed_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                          cell, fault):
    fault(monkeypatch)
    rc, res = one_run(tiny_root, capsys, cell)
    assert rc == 0 and res["correct"] is False, res["check"]


def test_new_cell_config_traffic_metric_are_new_files(tiny_root, capsys):
    """A new configuration, traffic mix, per-layer metric and cell: files
    and entries only."""
    bench = tiny_root / "portbench"
    cfg = json.loads((bench / "configs" / "tiny_lowrank.json").read_text())
    cfg["hparams"]["rgb_channels"] = 32
    (bench / "configs" / "tiny_wide.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "tiny_serve_orbit.json")
                         .read_text())
    traffic.update(T_threshold=1e-4, stride=1)
    (bench / "traffic" / "tiny_close.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "samples_per_frame.py").write_text(
        "def read(rec):\n"
        "    if rec['kind'] != 'serve':\n"
        "        return None\n"
        "    return sum(f[2] for f in rec['frames']) / len(rec['frames'])\n")
    (bench / "limits" / "tiny_wide.tiny_close.json").write_text(
        (bench / "limits" / f"{SERVE}.json").read_text())
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="tiny_wide",
                                file="portbench/configs/tiny_wide.json"))
    spec["workloads"].append(dict(name="tiny_wide.tiny_close",
                                  config="tiny_wide", traffic="tiny_close",
                                  chips=1, why="a test"))
    for m in spec["end_to_end"]:
        if "workloads" in m and SERVE in m["workloads"]:
            m["workloads"].append("tiny_wide.tiny_close")
    spec["per_layer"].append(dict(
        name="samples_per_frame", unit="samples", better="lower",
        source="program_counter", layer="render loop", moves="frames_per_s",
        workloads=["tiny_wide.tiny_close"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, res = one_run(tiny_root, capsys, "tiny_wide.tiny_close", trace=1)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["samples_per_frame"]["value"] > 0
    rc, res = one_run(tiny_root, capsys, "tiny_wide.tiny_close")
    assert {"frames_per_s", "frame_ms_p95", "setup_s"} <= set(res["metrics"])


def test_without_a_card_there_is_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_mod.main(["--workload", "lowrank.train", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
