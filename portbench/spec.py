"""The benchmark's data, found by name: `suite.json` (command, paths,
run_seconds), `configs/<config>.json`, `workloads/<cell>.json` and
`metrics/<metric>.json`.  A configuration, a cell or a metric is added by
adding its file; `benchmark()` writes `BENCHMARK.json` from them
(`python3 -m portbench.spec > BENCHMARK.json`), and a test holds the
committed file to it.

A workload file: name, config, traffic (the mix's name), generator (a
module of `portbench/traffic/`), params (what the generator reads), limits (the
numbers that decide `correct`), chips, why, order, and optionally reports
(metrics whose own files do not list the cell: a cell added later names
there the metrics it reports, so that no metric's file is edited).  A
metric file: name, kind (end_to_end | per_layer), unit, better, source,
workloads (left out where every cell reports the metric, as setup_s), order;
an end-to-end metric its bound, a per-layer one its layer, moves and
reader (a function of a module of `portbench/readers/`) with the reader's
args.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.abspath(__file__))

CONFIG_KEYS = ("name", "source", "file", "reduced", "why")
CELL_KEYS = ("name", "config", "traffic", "chips", "why")
E2E_KEYS = ("name", "unit", "better", "bound", "source")
LAYER_KEYS = ("name", "unit", "better", "source", "layer", "moves")


class Spec:
    def __init__(self, root: Optional[str] = None):
        self.root = root or ROOT

    def _load(self, *parts) -> dict:
        with open(os.path.join(self.root, *parts)) as f:
            return json.load(f)

    def _all(self, folder: str) -> List[dict]:
        items = []
        for path in glob.glob(os.path.join(self.root, folder, "*.json")):
            with open(path) as f:
                item = json.load(f)
            if item["name"] + ".json" != os.path.basename(path):
                raise ValueError(f"{path}: its name is {item['name']!r}")
            items.append(item)
        return sorted(items, key=lambda d: (d.get("order", 0), d["name"]))

    def suite(self) -> dict:
        return self._load("suite.json")

    def config(self, name: str) -> dict:
        return self._load("configs", name + ".json")

    def workload(self, name: str) -> dict:
        path = os.path.join(self.root, "workloads", name + ".json")
        if not os.path.exists(path):
            raise SystemExit(f"no workload {name!r}: no file {path}")
        return self._load("workloads", name + ".json")

    def configs(self) -> List[dict]:
        return self._all("configs")

    def workloads(self) -> List[dict]:
        return self._all("workloads")

    def metrics(self) -> List[dict]:
        """The metrics, each with the cells that report it: those its own
        file lists and those whose workload file names it under
        `reports`, in the cells' order; every cell where its file lists
        none (`every_cell`)."""
        cells = self.workloads()
        out = []
        for m in self._all("metrics"):
            every = "workloads" not in m
            named = set(m.get("workloads", [])) | {
                c["name"] for c in cells if m["name"] in c.get("reports", [])}
            out.append(dict(m, every_cell=every, workloads=[
                c["name"] for c in cells if every or c["name"] in named]))
        return out

    def metrics_for(self, cell: str, kind: str) -> List[dict]:
        return [m for m in self.metrics()
                if m["kind"] == kind and cell in m["workloads"]]

    def benchmark(self) -> Dict:
        suite = self.suite()
        rel = os.path.relpath(self.root, os.path.dirname(self.root))
        cells = self.workloads()
        used = {c["config"] for c in cells}
        configs = [{k: (f"{rel}/configs/{c['name']}.json" if k == "file"
                        else c[k]) for k in CONFIG_KEYS}
                   for c in self.configs() if c["name"] in used]
        metrics = self.metrics()

        def listed(m, keys):
            out = {k: m[k] for k in keys}
            if not m["every_cell"]:
                out["workloads"] = m["workloads"]
            return out
        return {
            "command": suite["command"],
            "paths": suite["paths"],
            "run_seconds": suite["run_seconds"],
            "configs": configs,
            "workloads": [{k: c[k] for k in CELL_KEYS} for c in cells],
            "end_to_end": [listed(m, E2E_KEYS)
                           for m in metrics if m["kind"] == "end_to_end"],
            "per_layer": [listed(m, LAYER_KEYS)
                          for m in metrics if m["kind"] == "per_layer"],
        }


if __name__ == "__main__":
    print(json.dumps(Spec().benchmark(), indent=1))
