"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
BENCHMARK.json gives, and a traffic mix, ``traffic/<name>.json`` beside
this file.  A per-layer metric lists the cells that report it under
``workloads`` and is read by ``metrics/<name>.py``, a module with
``read(obs) -> float | None``.  A traffic mix's ``send`` names a wire
form, ``wire/<form>.py`` (what a form module gives: wire/components.py).
Nothing here imports torch.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


class Catalog:
    """The benchmark of the checkout at `repo`."""

    def __init__(self, repo: pathlib.Path = REPO):
        self.repo = pathlib.Path(repo)
        self.home = self.repo / "benchmark"
        self.spec = json.loads((self.repo / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def cells(self) -> list[str]:
        return [w["name"] for w in self.spec["workloads"]]

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.repo / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def traffic_names(self) -> list[str]:
        return sorted(p.stem for p in (self.home / "traffic").glob("*.json"))

    def metric_files(self) -> dict:
        """Metric name -> the file that reads it."""
        return {p.name[:-3]: p
                for p in sorted((self.home / "metrics").glob("*.py"))}

    def reader(self, name: str):
        """The module of metrics/<name>.py."""
        return _load(self.metric_files()[name], "benchmark_metric", name)

    def wire_files(self) -> dict:
        """Wire form name -> the file that reads it."""
        return {p.name[:-3]: p
                for p in sorted((self.home / "wire").glob("*.py"))}

    def wire(self, form: str):
        """The module of wire/<form>.py; ValueError for a form there is no
        file of."""
        files = self.wire_files()
        if form not in files:
            raise ValueError(f"no wire form {form!r}: benchmark/wire/ has "
                             f"{sorted(files)}")
        return _load(files[form], "benchmark_wire", form)

    def end_to_end(self, cell: str) -> list[dict]:
        """Every cell reports every end-to-end metric."""
        return list(self.spec["end_to_end"])

    def per_layer(self, cell: str) -> list[dict]:
        """The per-layer metrics a traced run of `cell` reports: those
        whose `workloads` list it (every per-layer metric has the list)."""
        return [m for m in self.spec["per_layer"] if cell in m["workloads"]]


def _load(path: pathlib.Path, prefix: str, name: str):
    """The module of the file at `path`, named after `prefix` and `name`."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
