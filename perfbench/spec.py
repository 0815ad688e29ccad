"""``BENCHMARK.json`` and the files it names, found by name.

A cell (one entry of ``workloads``) is made of files of its own, so a
later change adds a cell by adding files and entries, never by editing:

- ``configs/<config>.json``: the configuration as it is run (its path is
  the ``file`` of its ``configs`` entry);
- ``traffic/<traffic>.json``: the mix's parameters, read by ``loadgen``;
- ``cells/<workload>.json``: what belongs to the cell alone, such as the
  rate its sweep found and the limits of its ``correct``;
- ``reference/<reference>.py``: the plain reference named by the
  configuration's ``reference`` key;
- ``metrics/<metric>.py``: the reader of each per-layer metric.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    own: dict                 # cells/<name>.json
    end_to_end: list[dict]    # the metrics this cell reports with --trace 0
    per_layer: list[dict]     # ... and with --trace 1


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_spec(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _read_json(root / conf["file"])
    traffic = _read_json(root / "perfbench" / "traffic" / f"{w['traffic']}.json")
    own = _read_json(root / "perfbench" / "cells" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, own=own,
                end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def reference(name: str):
    """The reference module ``reference/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"reference name {name!r} is not a module name")
    return importlib.import_module(f"perfbench.reference.{name}")


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``metrics/<name>.py`` (a name may hold dots, so the
    file is loaded by its path)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    if loader is None or not path.exists():
        raise FileNotFoundError(f"no reader {path} for metric {name!r}")
    mod = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(mod)
    return mod.read
