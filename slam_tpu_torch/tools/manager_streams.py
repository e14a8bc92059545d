"""Decision streams of methods 3 and 4: read from a run's log, compacted
from the manager oracle, and diffed.

The log parsers and diffs follow ``scripts/manager_oracle_check.py``:
method 3 per edge -- the UCT top-k, the Delta of each candidate layer,
the split and the target layer; method 4 per edge -- the action (skip,
expand, assign), the selected layer, the Mahalanobis residual and the
split value.  Once one decision flips, the two managers carry different
layer trees, so the identical prefix and the first divergence are the
parity statement; ``divergences`` counts every later mismatch as well.

``slam_tpu_torch/data/manager_decisions.json`` holds the oracle's streams
of the card's cells (``scripts/torch_manager_reference.py``).
"""

from __future__ import annotations

import json
import os

DECISIONS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "manager_decisions.json")


def reference(cell: str) -> dict:
    """The oracle's record of ``cell`` (e.g. ``"intel50"``)."""
    with open(DECISIONS) as f:
        return json.load(f)[cell]


def cell_graph(dataset: str, outliers: int, seed: int):
    """The graph of ``python -m slam_tpu_torch.cli DATASET OUTLIERS {3,4}
    --seed SEED`` after its init (``layering.load_for_manager``)."""
    from slam_tpu_torch.config import RunConfig
    from slam_tpu_torch.io import g2o
    from slam_tpu_torch.solver.init import apply_init
    from slam_tpu_torch.utils.logging import RunLogger

    g = g2o.load_g2o(g2o.find_dataset(dataset))
    g = g.add_random_outliers(outliers, seed=seed)
    return apply_init(g, RunConfig(dataset=dataset), RunLogger(echo=False))


# ---------------------------------------------------------------------------
# Log parsing (RunLogger text format: "[tag] k=v k=v ...")
# ---------------------------------------------------------------------------

def _parse_line(line):
    line = line.strip()
    if not line.startswith("["):
        return None, {}
    tag, _, rest = line[1:].partition("]")
    fields = {}
    for tok in rest.split():
        if "=" in tok:
            k, _, v = tok.partition("=")
            fields[k.rstrip(",")] = v.rstrip(",")
    return tag, fields


def parse_m3_log(lines) -> list[dict]:
    """Per-edge decision records of a method-3 log."""
    records, cur = [], None
    for line in lines:
        tag, f = _parse_line(line)
        if tag == "uct":
            cur = dict(topk=[int(s.split("(")[0][1:])
                             for s in f["topk"].split(",")],
                       deltas=[], split=False)
        elif tag == "conflict" and cur is not None:
            cur["deltas"].append(float(f["Delta"]))
        elif tag == "split" and cur is not None:
            cur["split"] = True
            cur["child"] = int(f["child_layer"])
        elif tag == "assign" and cur is not None:
            cur["target"] = int(f["to_layer"])
        elif tag == "residual" and cur is not None and "layer" in f:
            cur["r_new"] = float(f["r_new"])
            cur["ema"] = float(f["ema_now"])
        elif tag == "uct_update" and cur is not None:
            cur["reward"] = float(f["reward"])
            records.append(cur)
            cur = None
    return records


def parse_m4_log(lines) -> list[dict]:
    """Per-edge decision records of a method-4 log."""
    records, cur = [], None
    for line in lines:
        tag, f = _parse_line(line)
        if tag is not None and tag.startswith("step"):
            if cur is not None:
                records.append(cur)
            cur = dict(action=None)
        elif cur is None:
            continue
        elif tag == "residual":
            cur["residual"] = float(f["edge_residual"])
        elif tag == "skip":
            cur["action"] = "skip"
        elif tag == "split_check":
            cur["split_value"] = float(f["split_value"])
        elif tag == "expand":
            cur["action"] = "expand"
            cur["selected"] = f["created"]
        elif tag == "assign":
            cur["action"] = "assign"
            cur["selected"] = f["layer"]
    if cur is not None:
        records.append(cur)
    return records


def best_layer(lines, method: int) -> str:
    """The chosen layer of a run log: method 3's ``[finish] best_layer``
    (as ``L<k>``), method 4's ``[summary] best``."""
    best = None
    for line in lines:
        tag, f = _parse_line(line)
        if method == 3 and tag == "finish":
            best = f"L{f['best_layer']}"
        elif method == 4 and tag == "summary" and "best" in f:
            best = f["best"]
    if best is None:
        raise ValueError(f"no method-{method} result line in the log")
    return best


# ---------------------------------------------------------------------------
# Oracle streams
# ---------------------------------------------------------------------------

def compact_m3(decisions: list[dict]) -> list[dict]:
    """What the card is held to of each Method3Oracle decision."""
    keys = ("topk", "deltas", "split", "target", "best_delta", "r_new")
    return [{k: d[k] for k in keys} for d in decisions]


def compact_m4(decisions: list[dict]) -> list[dict]:
    """What the card is held to of each Method4Oracle decision."""
    keys = ("action", "selected", "child", "residual", "split_value")
    return [{k: d[k] for k in keys if k in d} for d in decisions]


# ---------------------------------------------------------------------------
# Decision diffs
# ---------------------------------------------------------------------------

def diff_m3(prod: list[dict], oracle: list[dict], tau: float) -> dict:
    """Method-3 records against the oracle's: the identical prefix, the
    divergences, the largest Delta and residual differences before the
    first divergence (and of every comparable record), and the closest
    split margin."""
    n = min(len(prod), len(oracle))
    divergences = []
    max_ddiff = max_ddiff_pre = max_rdiff_pre = 0.0
    min_margin = 1e100
    for i in range(n):
        p, o = prod[i], oracle[i]
        same = (p["topk"] == o["topk"] and p["split"] == o["split"]
                and p["target"] == o["target"])
        ddiff = 0.0
        if len(p["deltas"]) == len(o["deltas"]):
            ddiff = max((abs(a - b)
                         for a, b in zip(p["deltas"], o["deltas"])),
                        default=0.0)
            max_ddiff = max(max_ddiff, ddiff)
        min_margin = min(min_margin, abs(o["best_delta"] - tau))
        if not divergences and same:
            max_ddiff_pre = max(max_ddiff_pre, ddiff)
            if "r_new" in p:
                max_rdiff_pre = max(max_rdiff_pre,
                                    abs(p["r_new"] - o["r_new"]))
        if not same:
            divergences.append(dict(
                edge=i, delta_diff=ddiff,
                split_margin=abs(o["best_delta"] - tau),
                prod={k: p.get(k) for k in
                      ("topk", "split", "target", "deltas")},
                oracle={k: o.get(k) for k in
                        ("topk", "split", "target", "deltas")}))
    return dict(
        edges=n, count_mismatch=len(prod) != len(oracle),
        identical_prefix=(divergences[0]["edge"] if divergences else n),
        divergences=len(divergences),
        first_divergence=divergences[0] if divergences else None,
        max_delta_diff=max_ddiff,
        max_delta_diff_pre_divergence=max_ddiff_pre,
        max_residual_diff_pre_divergence=max_rdiff_pre,
        min_split_margin=min_margin,
    )


def diff_m4(prod: list[dict], oracle: list[dict], tau: float,
            residual_high: float = 50.0) -> dict:
    """Method-4 records against the oracle's (see :func:`diff_m3`): the
    largest Mahalanobis-residual and split-value differences before the
    first divergence, and the closest gate and split margins."""
    n = min(len(prod), len(oracle))
    divergences = []
    max_rdiff = max_svdiff = 0.0
    min_gate_margin = min_split_margin = 1e100
    for i in range(n):
        p, o = prod[i], oracle[i]
        same = p["action"] == o["action"] and (
            p["action"] == "skip"
            or p.get("selected") in (o.get("selected"), o.get("child")))
        if not divergences and same:
            max_rdiff = max(max_rdiff, abs(p.get("residual", 0.0)
                                           - o.get("residual", 0.0)))
            if "split_value" in p and "split_value" in o:
                max_svdiff = max(max_svdiff, abs(p["split_value"]
                                                 - o["split_value"]))
        if "split_value" in o:
            min_split_margin = min(min_split_margin,
                                   abs(o["split_value"] - tau))
        min_gate_margin = min(min_gate_margin,
                              abs(o.get("residual", 1e9) - residual_high))
        if not same:
            divergences.append(dict(
                edge=i,
                prod={k: p.get(k) for k in
                      ("action", "selected", "residual", "split_value")},
                oracle={k: o.get(k) for k in
                        ("action", "selected", "child", "residual",
                         "split_value")}))
    return dict(
        edges=n, count_mismatch=len(prod) != len(oracle),
        identical_prefix=(divergences[0]["edge"] if divergences else n),
        divergences=len(divergences),
        first_divergence=divergences[0] if divergences else None,
        max_residual_diff_pre_divergence=max_rdiff,
        max_split_value_diff_pre_divergence=max_svdiff,
        min_gate_margin=min_gate_margin,
        min_split_margin=min_split_margin,
    )
