"""The JAX runtime's row-sharded engine over processes, for the tests.

Spawned by ``sentinel_tpu.multihost.launch.launch`` (each process a few
virtual CPU devices): each rank builds the JAX ``Sentinel`` on
``multihost.mesh.global_mesh(axis="rows")`` and replays the port
worker's :func:`~sentinel_tpu_torch.multihost._rows_worker.twin_stream`
on the ``sentinel_tpu`` package — the same calls the port's ranks make
(its full stream costs the JAX runtime a minute on a CPU mesh).
Each rank prints one ``ROWS_JSON:`` line and saves its state at each
checkpoint to ``<out>/<checkpoint>.<rank>.npz`` in the port's per-rank
layout (a row-split leaf holds the rows of this rank's shards, its
first global row in ``offsets``). ``--refusals`` then calls the host
readers that the JAX runtime cannot serve on such a mesh and records
what they raised. Run it with ``SENTINEL_OBS_DISABLE=1``: with obs on,
the JAX runtime's first rule load raises (ROADMAP C19).
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _rank_leaves(tree, prefix, leaves, offsets):
    if tree is None:
        return
    if isinstance(tree, tuple):
        names = (tree._fields if hasattr(tree, "_fields")
                 else [str(i) for i in range(len(tree))])
        for name, item in zip(names, tree):
            _rank_leaves(item, prefix + name + ".", leaves, offsets)
        return
    key = prefix[:-1]
    if getattr(tree, "is_fully_addressable", True):
        leaves[key] = np.array(tree, copy=True)
    elif tree.is_fully_replicated:
        leaves[key] = np.array(tree.addressable_data(0), copy=True)
    else:
        parts = {}
        for sh in tree.addressable_shards:
            start = sh.index[0].start or 0
            parts[start] = np.asarray(sh.data)
        first = min(parts)
        leaves[key] = np.concatenate([parts[k] for k in sorted(parts)])
        offsets[key] = int(first)


def rank_state(s):
    leaves, offsets = {}, {}
    _rank_leaves(s._state, "", leaves, offsets)
    sketch = getattr(getattr(s, "tiering", None), "_sketch", None)
    if sketch is not None:
        _rank_leaves((sketch,), "", leaves, offsets)
        leaves["tiering.sketch"] = leaves.pop("0")
    return leaves, offsets


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--refusals", action="store_true")
    opts = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import sentinel_tpu as stpu
    from sentinel_tpu import multihost
    from sentinel_tpu.core import snapshot
    from sentinel_tpu.multihost import mesh as mh_mesh
    from sentinel_tpu_torch.multihost import _rows_worker as w

    os.makedirs(opts.out, exist_ok=True)
    with multihost.initialize() as rt:
        rank = rt.process_index
        s = w.make_sentinel(stpu, mesh=mh_mesh.global_mesh(axis="rows"))
        assert s.is_multihost
        offsets = {}

        def checkpoint(tag):
            leaves, offs = rank_state(s)
            offsets.update(offs)
            np.savez(os.path.join(opts.out, f"{tag}.{rank}.npz"), **leaves)

        obs = w.twin_stream(stpu, s, checkpoint)
        line = {"rank": rank, "observations": obs,
                "counters": s.obs.counters.snapshot(), "offsets": offsets}
        if opts.refusals:
            line["refusals"] = w.refusals(stpu, s, snapshot, opts.out)
        print("ROWS_JSON:" + json.dumps(line), flush=True)
        rt.barrier("rows-done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
