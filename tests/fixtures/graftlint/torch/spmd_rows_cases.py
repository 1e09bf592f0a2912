"""SPMD001 fixtures on the row-sharded engine over processes: the
rank-local read seam of ``RowBlocks`` and the mesh's bit-view reduce —
true positives and true negatives."""

from sentinel_tpu_torch.parallel.row_blocks import RowBlocks



def tp_row_read_on_one_rank(rt, table: RowBlocks, rows):
    # a per-lane read of row blocks is an all_reduce every rank joins
    if rt.process_index == 0:
        return table[rows]
    return None


def tp_row_sum_after_guard(rt, mesh, t, rows):
    blocks = mesh.blocks_of(t)
    if rt.is_coordinator:
        return None
    # the other ranks' sums wait for the coordinator, which left
    return blocks.sum()


def tp_bit_reduce_on_one_rank(rt, mesh, x):
    if rt.process_index == 1:
        x = mesh.all_reduce_bits(x)
    return x


def tn_row_reads_on_every_rank(rt, table: RowBlocks, rows):
    got = table[rows]
    total = table.sum()
    if rt.process_index == 0:
        print("rows:", got, total)         # host-side effect is fine
    return got


def tn_plain_tensor_under_branch(rt, t, rows):
    if rt.process_index == 0:
        return t[rows]                     # a tensor: no collective
    return None
