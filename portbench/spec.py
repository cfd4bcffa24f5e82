"""``BENCHMARK.json`` and the files it names, found by name.

Under the benchmark's folder (``portbench/`` beside ``BENCHMARK.json``):

* ``configs/<config>.json``: a configuration (its file is named in
  ``BENCHMARK.json``): ``hparams`` (the trainer's), ``scene``, ``source``,
  ``reduced``, ``assumed``;
* ``traffic/<mix>.json``: a traffic mix's parameters, with its ``kind``;
* ``kinds/<kind>.py``: the runner of a kind of traffic (``Run``);
* ``metrics/<metric>.py``: a metric's reader, ``read(record)``, which
  returns the value or None where the run has nothing to read;
* ``limits/<cell>.json``: the limits of a cell's check, each with the
  readings it was set from.

A cell, a configuration, a traffic mix of a known kind or a metric is
added by new files and new entries in ``BENCHMARK.json``; nothing here
changes.
"""
import importlib.util
import json
import pathlib

FORBIDDEN = ("jax", "jaxlib", "flax", "mfnerf_tpu")


class Layout:
    """The benchmark rooted at ``root`` (the directory holding
    ``BENCHMARK.json``)."""

    def __init__(self, root):
        self.root = pathlib.Path(root)
        self.bench = self.root / "portbench"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def limits(self, cell):
        return json.loads((self.bench / "limits" / f"{cell}.json")
                          .read_text())

    def kind(self, name):
        return _load(self.bench / "kinds" / f"{name}.py", f"kind_{name}")

    def metric(self, name):
        return _load(self.bench / "metrics" / f"{name}.py",
                     "metric_" + name.replace(".", "_"))

    def metrics_of(self, cell, trace):
        """The metrics a run of ``cell`` reports: with ``trace`` the
        per-layer ones listed for it (or, without a list, every one whose
        end-to-end metric it reports), else its end-to-end ones."""
        e2e = [m for m in self.spec["end_to_end"]
               if cell in m.get("workloads", [cell])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{name}", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules):
    """The names among ``modules`` whose top-level name (the part before
    the first dot) is one of FORBIDDEN, compared whole."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
