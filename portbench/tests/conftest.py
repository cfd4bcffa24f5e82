"""The benchmark's tests: on the CPU at small sizes, and (marked ``card``)
on the card. Neither JAX nor the JAX package is imported here.

    python -m pytest portbench/tests -q

``tiny_root`` is a copy of the benchmark under a temporary checkout root
with cells of its own at a size the CPU runs in seconds: the configurations
are the committed ones with every size cut, the traffic mixes the
committed ones with few steps and frames, the limits the committed cells'.
"""
import json
import pathlib
import shutil
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# config -> the cut sizes; traffic -> the cut parameters
TINY_CONFIGS = {
    "lowrank": dict(batch_size=128, grid_size=16, max_samples=64,
                    s_max_train=16, s_max_test=16, lr_levels=2, lr_rank=4,
                    lr_k_max=16, L=4, rgb_channels=16, s_flat=0),
}
TINY_SCENE = dict(n_train=4, n_test=6, wh=24)
TINY_TRAFFIC = {
    "train_flat": dict(warm_steps=20, block_steps=4, trace_steps=4),
    "serve_orbit": dict(train_steps=20, warm_frames=2, trace_frames=2,
                        check_frames=2, check_pixels=64, stride=5),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _one_thread():
    """Many small torch ops: one intra-op thread keeps parallel workers
    from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device; skips the test without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def make_tiny_root(dest):
    """A checkout root at ``dest`` holding the benchmark and tiny cells
    ``tiny_<config>.<traffic>``; returns its BENCHMARK.json as a dict."""
    dest = pathlib.Path(dest)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = dest / "portbench"
    configs, cells = [], []
    for entry in spec["configs"]:
        cfg = json.loads((REPO / entry["file"]).read_text())
        cfg["hparams"].update(TINY_CONFIGS[entry["name"]])
        cfg["scene"] = dict(TINY_SCENE)
        name = "tiny_" + entry["name"]
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        configs.append(dict(entry, name=name,
                            file=f"portbench/configs/{name}.json"))
    for name, cut in TINY_TRAFFIC.items():
        t = json.loads((bench / "traffic" / f"{name}.json").read_text())
        t.update(cut)
        (bench / "traffic" / f"tiny_{name}.json").write_text(json.dumps(t))
    renamed = {}
    for w in spec["workloads"]:
        name = f"tiny_{w['config']}.tiny_{w['traffic']}"
        renamed[w["name"]] = name
        cells.append(dict(w, name=name, config="tiny_" + w["config"],
                          traffic="tiny_" + w["traffic"]))
        shutil.copy(bench / "limits" / f"{w['name']}.json",
                    bench / "limits" / f"{name}.json")

    def rename(metric):
        if "workloads" in metric:
            metric = dict(metric, workloads=[renamed[w]
                                             for w in metric["workloads"]])
        return metric

    spec.update(configs=configs, workloads=cells,
                end_to_end=[rename(m) for m in spec["end_to_end"]],
                per_layer=[rename(m) for m in spec["per_layer"]])
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return spec


@pytest.fixture
def tiny_root(tmp_path):
    make_tiny_root(tmp_path)
    return tmp_path
