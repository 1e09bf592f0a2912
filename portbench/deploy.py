"""Configuration files, and the rule lists that both the program and the
plain reference read.

A configuration (``portbench/configs/<config>.json``) names the program
under test (``"deployment"``: ``portbench/deployments/<name>.py``), its
plain reference (``"reference"``: ``portbench/reference/<name>.py``) and
its rule kinds (``"rule_kinds"``: ``portbench/rules/<kind>.py``, the
rules of each under ``"<kind>_rules"``). It holds the program's sizes
(``sentinel``: ``SentinelConfig`` fields) and the number of interned
resource names (``names``; name ``r<i>`` has popularity rank ``i``).

A rule group is ``{"first": a, "count": n, "rules": [...]}``: for each
name ``r<i>``, ``i`` from ``a`` to ``a+n-1``, each entry ``{"mod": m,
"rem": [...], "rule": {...}}`` of ``rules`` in turn adds its rule where
``i % m`` is in ``rem`` (every ``i`` without ``mod``); ``"rule": {...}``
in place of ``rules`` puts that one rule on every name. A string field
of a rule may be a template: ``{"prefix": "app-", "mod": 64}`` is
``app-<i % 64>``, ``{"prefix": "r", "add": -1}`` is ``r<i - 1>``. The
program is imported only where it is built; the reference never
imports it.
"""

from __future__ import annotations

import importlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_config(name: str, root: str = HERE) -> dict:
    with open(os.path.join(root, "configs", name + ".json")) as fh:
        return json.load(fh)


def name_of(rank: int) -> str:
    return f"r{rank}"


def _field(value, i: int):
    if isinstance(value, dict):
        n = i % value["mod"] if "mod" in value else i + value.get("add", 0)
        return f"{value['prefix']}{n}"
    return value


def expand(groups, codes) -> list:
    """Rule groups → ``[(resource rank, fields)]`` in load order, the
    ``codes`` fields turned from names into codes."""
    out = []
    for group in groups:
        entries = group.get("rules") or [{"rule": group["rule"]}]
        for i in range(group["first"], group["first"] + group["count"]):
            for e in entries:
                if "mod" in e and i % e["mod"] not in e["rem"]:
                    continue
                fields = {k: _field(v, i) for k, v in e["rule"].items()}
                for key, (table, default) in codes.items():
                    if key in fields or default is not None:
                        fields[key] = table[fields.get(key, default)]
                out.append((i, fields))
    return out


def rule_kind(kind: str):
    return importlib.import_module(f"portbench.rules.{kind}")


def rules_of(config: dict) -> dict:
    """``{kind: [(resource rank, fields)]}`` of every rule kind the
    configuration lists, in its order."""
    return {kind: expand(config.get(f"{kind}_rules", ()),
                         rule_kind(kind).CODES)
            for kind in config["rule_kinds"]}


def build(config: dict, device):
    """The program under test, by the deployment the configuration
    names."""
    mod = importlib.import_module(
        f"portbench.deployments.{config['deployment']}")
    return mod.build(config, device)


def alt_rows(rows, kind: int, ids, ra: int):
    """The node-table row of (resource row, origin (kind 0) or context
    (kind 1) id): the published hash the program's raw callers use."""
    h = ((rows.astype(np.uint64) * np.uint64(0x9E3779B1))
         ^ ((ids.astype(np.uint64) * 2 + kind) * np.uint64(0x85EBCA6B))) \
        & np.uint64(0xFFFFFFFF)
    return (h % np.uint64(ra)).astype(np.int32)
