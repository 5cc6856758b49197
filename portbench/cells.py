"""Finds a cell's files by the names ``BENCHMARK.json`` gives them.

A configuration is ``configs/<config>.json`` (its template file beside it),
a traffic mix ``traffic/<traffic>.json``, a cell's limits
``limits/<cell>.json`` and a per-layer metric ``metrics/<metric>.py``.  A
later change adds a cell, a mix or a metric by adding such files and
entries; nothing here names one.
"""

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load_json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(root=ROOT):
    """The parsed ``BENCHMARK.json`` at the checkout's root."""
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench, name):
    """The ``workloads`` entry called ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_path(name):
    return os.path.join(HERE, "configs", f"{name}.json")


def load_config(name):
    """A configuration, with ``template_path`` resolved beside it."""
    cfg = _load_json(config_path(name))
    cfg["template_path"] = os.path.join(HERE, "configs", cfg["template"])
    return cfg


def load_traffic(name):
    return _load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def load_limits(cell):
    """{number name: limit} of one cell's comparison."""
    return _load_json(os.path.join(HERE, "limits", f"{cell}.json"))["limits"]


def metric_path(name):
    return os.path.join(HERE, "metrics", f"{name}.py")


def metric_reader(name):
    """The ``read(ctx)`` function of per-layer metric ``name``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", metric_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench, cell, kind):
    """The ``end_to_end`` or ``per_layer`` entries that cell ``cell``
    reports: those without a ``workloads`` key and those listing it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]
