"""``scatter_add_roofline`` (layer: kernel ``csrc/scatter_add.cu``): the
least time the traced steps' counter scatter-adds need at the card's
peak memory rate (``portbench/roofline.py``, from the batches and
verdicts alone), over the device time of the kernels that carry them,
in %.

The kernels are the port's hand-written scatter-add, by the names of its
instantiations in ``csrc/scatter_add.cu`` (``KERNELS``)."""

import torch

from portbench import deploy, roofline
from portbench.rules import flow

KERNELS = ("scatter_add_global", "scatter_add_shared")


def read(ctx):
    steps = ctx.traced_steps
    if ctx.events is None or not len(steps):
        return None
    kernel_us = 0.0
    for e in ctx.events:
        if e.get("cat") == "kernel" and any(
                k in e.get("name", "") for k in KERNELS):
            s = float(e["ts"])
            if ctx.lo <= s <= ctx.hi:
                kernel_us += float(e.get("dur", 0))
    if kernel_us <= 0:
        return None
    run, traffic = ctx.run, ctx.traffic
    sp = ctx.config["sentinel"]
    second_b = sp.get("second_sample_count", 2)
    second_ms = sp.get("second_interval_ms", 1000) // second_b
    dev = ctx.device
    rules = deploy.rules_of(ctx.config)
    deg_of_rank = torch.full((ctx.config["names"],), -1, dtype=torch.int64)
    for j, (rank, _f) in enumerate(rules.get("degrade", ())):
        deg_of_rank[rank] = j
    deg = deg_of_rank.to(dev)
    thread = flow.CODES["grade"][0]["THREAD"]
    gauges = any(f.get("grade") == thread for _r, f in rules.get("flow", ()))
    least = 0.0
    for k in steps:
        st = run.steps[k]
        cols = ctx.pool[k % len(ctx.pool)]
        ranks = torch.from_numpy(traffic.ranks(k)).to(dev).long()
        allow = torch.from_numpy(st.allow()).to(dev)
        if traffic.exits and k >= traffic.lag and st.exit_n:
            j = k - traffic.lag
            prev_np = run.steps[j].allow()
            prev = torch.from_numpy(prev_np).to(dev)
            xcols = {c: torch.from_numpy(v).to(dev).long()[prev]
                     for c, v in ctx.pool[j % len(ctx.pool)].items()}
            ex = torch.from_numpy(traffic.ranks(j)).to(dev).long()[prev]
            _lanes, rt, err = traffic.exit_lanes(k, prev_np)
            rt = torch.from_numpy(rt)
            err = torch.from_numpy(err).to(dev)
        else:
            xcols = {c: torch.from_numpy(v[:0]).to(dev).long()
                     for c, v in cols.items()}
            ex = ranks[:0]
            rt = torch.zeros(0, dtype=torch.int32)
            err = torch.zeros(0, dtype=torch.bool, device=dev)
        sk = (st.at_ms // second_ms) % second_b
        windows = [(sk, second_b)]
        if sp.get("minute_enabled", True):
            windows.append(((st.at_ms // 1000) % 60, 60))
        nodes = exit_nodes = None
        if "origin_rows" in cols:
            nodes = _nodes({c: torch.from_numpy(v).to(dev).long()
                            for c, v in cols.items()}, ctx.alt_rows)
            exit_nodes = _nodes(xcols, ctx.alt_rows)
        least += roofline.bound_s(roofline.fused_step_updates(
            ranks + 1, allow, ex + 1, rt.to(dev).long(), err, deg[ex],
            windows, nodes, exit_nodes, (sk, second_b), gauges))
    return 100.0 * least / (kernel_us / 1e6)


def _nodes(cols, alt_rows):
    """(lane index, node row) of every lane's origin and context node."""
    lanes, node = [], []
    for c in ("origin_rows", "chain_rows"):
        v = cols[c]
        has = v < alt_rows
        lanes.append(torch.nonzero(has).view(-1))
        node.append(v[has])
    return torch.cat(lanes), torch.cat(node)
