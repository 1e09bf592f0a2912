"""SPMD001 fixtures on the port's multihost entry points: true positives
and true negatives."""

from sentinel_tpu_torch import multihost
from sentinel_tpu_torch.multihost.obs_agg import aggregate_counters


def tp_process_index_barrier(rt):
    # only the coordinator reaches the runtime's barrier
    if rt.process_index == 0:
        rt.barrier("done")


def tp_coordinator_aggregate(rt, sph):
    # the fleet aggregate is a gather every process must join
    if rt.is_coordinator:
        return aggregate_counters(sph)
    return None


def tp_guard_return_mesh(rt, mesh, x):
    if rt.process_index != 0:
        return x
    # ranks past the early exit never join the namespace sum
    return mesh.all_reduce_sum(x)


def tp_initialize_on_one_rank(rank):
    if rank.process_index == 1:
        multihost.initialize()


def tn_every_rank(rt, sph, mesh, x):
    out = aggregate_counters(sph)
    y = mesh.all_reduce_sum(x)
    if rt.process_index == 0:
        print("TOPK_JSON:", out)            # host-side effect is fine
    rt.barrier("done")
    return y
