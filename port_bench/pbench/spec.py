"""Resolve a cell of ``BENCHMARK.json`` to its files, by name.

Everything that belongs to one configuration, one traffic mix, one cell or
one per-layer metric lives in a file of its own, found by the name that
``BENCHMARK.json`` gives it:

- a configuration: the ``file`` of its entry (encoder settings, source,
  ``reduced`` and ``assumed``);
- a traffic mix: ``traffic/<traffic>.json`` under the harness's folder;
- a cell's correctness limits: ``cells/<workload>.json``;
- a per-layer metric's reader: ``metrics/<metric>.py``, whose ``read``
  takes the traced slice's readings and returns a number or None.

A later PR adds a cell, a configuration or a metric by adding such files
and entries; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# the harness's folder, relative to the checkout's root
BENCH_REL = os.path.relpath(BENCH_DIR, ROOT)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict           # the configuration file's content
    traffic_name: str
    traffic: dict          # the traffic file's content
    limits: dict           # the cell file's content
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_reader(path: str) -> Callable:
    """The ``read`` function of one per-layer metric's reader file."""
    name = "pbench_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def bench_dir(root: str) -> str:
    return os.path.join(root, BENCH_REL)


def resolve(workload: str, root: str = ROOT,
            bench: Optional[dict] = None) -> Cell:
    """The cell named ``workload`` with its configuration, traffic, limits,
    metrics and readers loaded from their files.  Raises KeyError for a
    name that BENCHMARK.json does not hold and FileNotFoundError for a
    file that is missing."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    here = bench_dir(root)
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    readers = {m["name"]: load_reader(
        os.path.join(here, "metrics", m["name"] + ".py")) for m in per_layer}
    return Cell(
        name=workload, chips=int(w["chips"]), config_name=w["config"],
        config=_json(os.path.join(root, entry["file"])),
        traffic_name=w["traffic"],
        traffic=_json(os.path.join(here, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(here, "cells", workload + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=per_layer, readers=readers)
