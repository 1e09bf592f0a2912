"""TRACE001 torch fixtures: host syncs in device-step code (compiled,
graph-wrapped, captured, declared), suppression, and the static-metadata
patterns that must stay clean."""

import functools

import torch


@torch.compile
def tp_item(x):
    return x.sum().item()                     # TRACE001: host sync


@functools.partial(torch.compile, dynamic=False)
def tp_branch(x):
    if torch.any(x > 0):                      # TRACE001: branch on a tensor
        x = x + 1
    return x


def _graphed_body(x):
    return x[x > 0]                           # TRACE001: via wrap site below


def build(sample):
    return torch.cuda.make_graphed_callables(_graphed_body, (sample,))


def capture(g, static_x):
    with torch.cuda.graph(g):
        total = static_x.sum()
        n = int(total)                        # TRACE001: inside a capture
    return n


@torch.compile
def suppressed(x):
    return float(x[0])  # graftlint: disable=TRACE001 -- fixture: demonstrates an accepted readback in a debug-only path


@torch.compile
def tn_static_meta(x):
    n = int(x.shape[0])                       # static: no sync
    m = float(len(x.shape))                   # static: no sync
    return torch.where(x > 0, x * n, x * m)   # the branch stays on the card


def declared_step(x):
    return x.tolist()                         # flags only under a table naming it


def tn_not_a_step(x):
    return x.sum().item()                     # plain function: no finding
