"""A cell of the benchmark, found by its name in ``BENCHMARK.json``.

The cell names its configuration and its traffic mix; each is a data file
of its own: ``BENCHMARK.json`` gives the configuration's file, the traffic
mix is ``portbench/traffic/<traffic>.json``, the limits of the numbers its
check compares are ``portbench/limits/<cell>.json``, and each metric that
the cell reports (every ``end_to_end`` and ``per_layer`` entry without a
``workloads`` list, or whose list names the cell) is read by
``portbench/metrics/<metric>.py``; a metric split by the cells that
report it (``lm_it_per_s.dense``, and a later ``lm_it_per_s.<group>``
with a bound of its own) is read by the file of the name before the first
dot.
"""

from __future__ import annotations

import importlib
import json
import pathlib
from typing import NamedTuple

PKG = pathlib.Path(__file__).resolve().parent
ROOT = PKG.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic mix's file
    limits: dict          # number -> limit of the check
    end_to_end: list      # BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def traffic(name: str) -> dict:
    """The traffic mix ``portbench/traffic/<name>.json``."""
    return _json(PKG / "traffic" / f"{name}.json")


def load(name: str, bench_path: pathlib.Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root)."""
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(ROOT / conf["file"]),
        traffic=traffic(w["traffic"]),
        limits=_json(PKG / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(run)`` function of ``portbench/metrics/<metric>.py``
    (``<metric>`` up to its first dot)."""
    base = metric.split(".")[0]
    return importlib.import_module(f"portbench.metrics.{base}").read
