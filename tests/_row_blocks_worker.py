"""Row blocks in the rank-local form, for the tests: one rank of a
``"rows"`` mesh over processes (``sentinel_tpu_torch.multihost.launch``,
``platform="cpu"``).

Each rank holds its blocks of the tables :func:`tables` builds (16 rows:
float32 with ``-0.0`` and NaN payloads, int32 with its extremes), reads
lanes with :meth:`RowBlocks.__getitem__` (negative rows, a row past the
table), sums with :meth:`RowBlocks.sum`, writes through
:meth:`RowBlocks.local_rows` (negative rows, pads past the table) and
:meth:`RowBlocks.add_row_`, and prints one ``BLOCKS_JSON:`` line: the
reads and sums as int bit patterns, its rows of each table after the
writes, and the collectives it issued. ``tests/test_torch_rows_
multiprocess.py`` holds them to the same calls on one process's blocks.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

ROWS = 16
READ_ROWS = [0, 2, 3, 4, 7, 8, 9, 11, 12, 15, -1, -16, -5, -7, 16, 5, 5, 13]
WRITE_ROWS = [1, -1, 16, 17, -17, 6, 6, 9, -7, 40, 12, 0]
NAN_BITS = [0x7FC00123, 0xFFC0BEEF]


def tables():
    """→ ``(float32[16, 3], int32[16])`` (numpy, the same on every rank)."""
    rng = np.random.default_rng(99)
    f = rng.standard_normal((ROWS, 3)).astype(np.float32)
    f[2, 0] = -0.0
    f[9, 1] = -0.0
    bits = f.view(np.int32)
    bits[5, 2] = np.int32(np.uint32(NAN_BITS[0]).view(np.int32))
    bits[13, 0] = np.int32(np.uint32(NAN_BITS[1]).view(np.int32))
    i = rng.integers(-1000, 1000, ROWS).astype(np.int32)
    i[4] = np.iinfo(np.int32).min
    i[11] = np.iinfo(np.int32).max
    return f, i


def bits(t) -> list:
    a = t.detach().cpu().numpy().reshape(-1)
    if a.dtype == np.float32:
        a = a.view(np.int32)
    if a.dtype == np.int64:
        a = a.view(np.int32)            # both words of each value
    return a.astype(np.int64).ravel().tolist()


def run(make_blocks):
    """The calls on blocks made by ``make_blocks(table)`` → a dict."""
    import torch

    from sentinel_tpu_torch.ops import scatter_add as sa
    from sentinel_tpu_torch.parallel.row_blocks import read_rows
    f, i = tables()
    fb = make_blocks(torch.from_numpy(f))
    ib = make_blocks(torch.from_numpy(i))
    rows = torch.tensor(READ_ROWS, dtype=torch.int32)
    out = {"read_f": bits(fb[rows]), "read_f_col": bits(fb[rows, 1]),
           "read_i": bits(ib[rows]), "read_f_int": bits(fb[13]),
           "read_i_int": bits(ib[-1]),
           "sum_f": bits(fb.sum()), "sum_i": bits(ib.sum())}
    # one packed read of four tables (float32, int32, bool and int64
    # words) and an int row
    bb = make_blocks(torch.from_numpy(i % 3 == 0))
    lb = make_blocks(torch.from_numpy(i.astype(np.int64) * 3_000_000_019))
    packed = read_rows([(fb, (rows, 2)), (ib, (rows,)), (bb, (rows,)),
                        (lb, (rows,)), (fb, (9,))])
    out["packed"] = [bits(t) for t in packed]
    out["packed_dtypes"] = [str(t.dtype) for t in packed]
    w = torch.tensor(WRITE_ROWS, dtype=torch.int32)
    amt = torch.arange(1, len(WRITE_ROWS) + 1, dtype=torch.int32)
    for k, b, lr in ib.owned(w):
        sa.scatter_add(b[:, None], lr, None, amt[:, None])
    for k, b, lr in fb.owned(w):
        sa.scatter_add(b, lr, None, amt[:, None].expand(-1, 3) * 3)
    ib.add_row_(0, torch.tensor(7, dtype=torch.int32))
    ib.add_row_(-2, torch.tensor(-3, dtype=torch.int32))
    out["write_i"] = [bits(b) for b in ib.blocks]
    out["write_f"] = [bits(b) for b in fb.blocks]
    out["first"] = ib.first
    return out


def main() -> int:
    import torch

    from sentinel_tpu_torch import multihost
    from sentinel_tpu_torch.multihost import mesh as mh_mesh
    from sentinel_tpu_torch.parallel import local_shard

    torch.set_num_threads(1)
    with multihost.initialize() as rt:
        mesh = mh_mesh.global_mesh(axis="rows")
        m = local_shard.as_row_mesh(mesh)
        out = run(m.blocks_of)
        out["rank"] = rt.process_index
        out["collectives"] = mesh.stats.snapshot()
        # a host read of the whole table is refused, before any collective
        try:
            m.blocks_of(torch.zeros(ROWS)).to_numpy()
            out["to_numpy"] = "returned"
        except RuntimeError as exc:
            out["to_numpy"] = type(exc).__name__
        out["collectives_after"] = mesh.stats.snapshot()
        print("BLOCKS_JSON:" + json.dumps(out), flush=True)
        rt.barrier("blocks-done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
