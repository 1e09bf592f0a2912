"""DEV001 torch fixtures beyond the window regression: context calls,
class bodies, default args, pinning, suppression, and safe module-scope
patterns."""

import torch
import torch.distributed as dist

STREAM = torch.cuda.Stream()                  # DEV001: creates the context


class Config:
    scale = torch.full((4,), 2.0).cuda()      # DEV001: class body runs at import


def bad_default(x, pad=torch.zeros(8, device="cuda:0")):  # DEV001: default evaluates at import
    return x + pad


PINNED = torch.empty(64, pin_memory=True)     # DEV001: pinned through CUDA
MOVED = torch.arange(4).to(torch.device("cuda"))  # DEV001: placed on the card
GEN = torch.Generator(device="cuda")          # DEV001: a CUDA generator
WORLD = dist.get_world_size()                 # DEV001: process group at import

SUPPRESSED = torch.ones(3, device="cuda")  # graftlint: disable=DEV001 -- fixture: demonstrates an explicitly accepted device constant

SAFE_HOST = torch.zeros(8)                    # CPU factory: no context
SAFE_DEVICE = torch.device("cuda")            # metadata: no context
SAFE_PROBE = torch.cuda.is_available()        # count query: fork-safe
SAFE_COUNT = torch.cuda.device_count()        # count query: fork-safe
SAFE_DIST = dist.is_available()               # build probe
_compiled = torch.compile(bad_default)        # compiles lazily: no context


def safe_inside():
    return torch.arange(16, device="cuda")    # call time, not import time
