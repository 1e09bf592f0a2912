"""SPMD001 torch fixtures: true positives, a suppressed site, true
negatives."""

import os

import torch.distributed as dist


def tp_lexical(x):
    # collective only executed on rank 0 → the other ranks never join
    if dist.get_rank() == 0:
        dist.all_reduce(x)
    return x


def tp_env_branch(x):
    if int(os.environ.get("LOCAL_RANK", "0")) == 0:
        dist.broadcast(x, src=0)
    return x


def tp_guard_return(out, x):
    if dist.get_rank() != 0:
        return None
    # only rank 0 reaches the rendezvous below
    dist.all_gather_into_tensor(out, x)
    return out


def suppressed_site(x):
    if is_coordinator():
        dist.barrier()  # graftlint: disable=SPMD001 -- fixture: documents the suppression syntax; never executed
    return x


def tn_uniform_branch(x, world_size):
    # uniform config value: every rank takes the same side
    if world_size > 1:
        dist.all_reduce(x)
    return x


def tn_collective_outside(x):
    dist.all_reduce(x)
    if dist.get_rank() == 0:
        print("rank 0 log only")              # host-side effect is fine
    return x
