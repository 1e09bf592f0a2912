"""Regression fixture, torch's spelling of the stats-window import bug.

The reference's seed held its NEVER sentinel as a module-scope device
constant, which initialised the backend at import. The same constant
written for the port — a module-scope CUDA tensor — creates the CUDA
context while the module is imported: every forked worker of the
importing process then fails to re-initialise CUDA. DEV001 must flag the
``NEVER`` line (the port's stats/window.py keeps a Python int).
"""

import torch

INT32_MAX = torch.iinfo(torch.int32).max      # metadata only: must NOT flag

NEVER = torch.tensor(-(2 ** 30), dtype=torch.int32, device="cuda")  # DEV001
