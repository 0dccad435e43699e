"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration, `configs/<name>.json`
beside its entry's `file`, and a traffic mix, `traffic/<name>.json`, whose
`driver` names `drivers/<driver>.py`. Each metric is `metrics/<name>.py`
with a `read(ctx)` that returns a number or None. Nothing here names a
cell, a mix or a metric: adding one is adding its files and entries.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """The Python file at `path` as a module named `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    """A metric without `workloads` applies to every cell."""
    return cell in entry.get("workloads", [cell])


class Cell:
    """One workload with its configuration, traffic mix, driver and
    metrics, resolved from the manifest at `root`."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        self.manifest = m = load(root)
        got = [w for w in m["workloads"] if w["name"] == name]
        if not got:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = got[0]
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg = [c for c in m["configs"] if c["name"] == self.workload["config"]]
        if not cfg:
            raise KeyError(f"no configuration {self.workload['config']!r}")
        self.config_entry = cfg[0]
        self.config = self._json(self.config_entry["file"])
        self.traffic = self._json(os.path.join(
            "pigobench", "traffic", self.workload["traffic"] + ".json"))
        self.driver_path = self.path("pigobench", "drivers",
                                     self.traffic["driver"] + ".py")
        self.end_to_end = [e for e in m["end_to_end"] if applies(e, name)]
        self.per_layer = [e for e in m["per_layer"] if applies(e, name)]

    def path(self, *parts: str) -> str:
        return os.path.join(self.root, *parts)

    def _json(self, rel: str) -> dict:
        with open(self.path(rel)) as fh:
            return json.load(fh)

    def driver(self):
        return load_module(self.driver_path, "pigobench_driver_"
                           + self.traffic["driver"])

    def metric_path(self, name: str) -> str:
        return self.path("pigobench", "metrics", name + ".py")

    def metric(self, name: str):
        return load_module(self.metric_path(name), "pigobench_metric_"
                           + name.replace(".", "_").replace("-", "_"))


def problems(m: dict, root: str = ROOT) -> list[str]:
    """What in the manifest breaks the naming rules or names a file that
    is not there."""
    out = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in m[kind]:
            if not NAME_RE.fullmatch(e["name"]):
                out.append(f"{kind}: bad name {e['name']!r}")
            if e["name"] in seen:
                out.append(f"{kind}: {e['name']!r} twice")
            seen.add(e["name"])
    metrics = m["end_to_end"] + m["per_layer"]
    if len({e["name"] for e in metrics}) != len(metrics):
        out.append("a metric name is used twice")
    for e in metrics:
        if not UNIT_RE.fullmatch(e["unit"]):
            out.append(f"{e['name']}: bad unit {e['unit']!r}")
        if not os.path.isfile(os.path.join(root, "pigobench", "metrics",
                                           e["name"] + ".py")):
            out.append(f"{e['name']}: no metrics/{e['name']}.py")
    for w in m["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.fullmatch(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
        try:
            cell = Cell(w["name"], root)
        except (KeyError, OSError) as exc:
            out.append(f"{w['name']}: {exc}")
            continue
        if not os.path.isfile(cell.driver_path):
            out.append(f"{w['name']}: no driver {cell.driver_path}")
    for c in m["configs"]:
        for key in c["reduced"]:
            if not NAME_RE.fullmatch(key):
                out.append(f"{c['name']}: bad reduced key {key!r}")
    return out
