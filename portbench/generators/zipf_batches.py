"""Batches of Zipf-drawn resources, with origins, contexts and the
completions of earlier batches.

Parameters of a mix:

* ``pool_batches`` batches of ``batch`` resource ranks, Zipf(``zipf_s``)
  over the configuration's ``names`` (rank 0 is the hottest name); step
  ``k`` sends pool batch ``k % pool_batches``;
* with ``exit_lag`` > 0, each step reports the completions of the events
  admitted ``exit_lag`` steps back: one stream of response times
  (log-normal, median ``rt_median_ms``, sigma ``rt_sigma``, capped at
  ``rt_max_ms``) and one of business errors (share ``error_share``),
  which the exits of step ``k`` read from an offset of their own; every
  exit of the ``failing_ranks`` hottest names raises;
* with ``origins``, an origin for a share ``origin_share`` of the
  events, Zipf(``origin_zipf_s``) over ``origins`` names
  (``origin_prefix<k>``), and with ``contexts`` an entrance context
  for a share ``context_share``, uniform over ``contexts`` names
  (``context_prefix<k>``); index -1 is none;
* which batches keep their whole verdicts for the comparison
  (``verdict_sample``, a share), and ``warmup_steps``.

The same seed gives the same inputs on the same kind of device.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import deploy
from portbench.traffic import SAMPLE_PLAN, seed64, zipf_ranks

#: a batch column → the exit column of its completions
EXIT_OF = {"rows": "exit_rows", "origin_rows": "exit_origin_rows",
           "chain_rows": "exit_chain_rows"}


class Traffic:
    """The inputs of one run of a cell (see the module docstring)."""

    def __init__(self, mix: dict, config: dict, seed: int, device):
        self.batch = int(mix["batch"])
        self.lag = int(mix.get("exit_lag", 0))
        self.warmup = int(mix["warmup_steps"])
        names = int(config["names"])
        dev = torch.device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed64(seed, 1))
        pool = int(mix["pool_batches"])
        ranks = zipf_ranks(pool * self.batch, names, float(mix["zipf_s"]),
                           gen, dev)
        self.pool = list(ranks.view(pool, self.batch).cpu().numpy())
        self.origin_names = [f"{mix.get('origin_prefix', 'app-')}{k}"
                             for k in range(int(mix.get("origins", 0)))]
        self.context_names = [f"{mix.get('context_prefix', 'ctx-')}{k}"
                              for k in range(int(mix.get("contexts", 0)))]
        n = pool * self.batch
        self.origin = self.context = None
        if self.origin_names:
            o = zipf_ranks(n, len(self.origin_names),
                           float(mix["origin_zipf_s"]), gen, dev)
            u = torch.rand(n, generator=gen, device=dev)
            o = torch.where(u < float(mix["origin_share"]), o, -1)
            self.origin = list(o.view(pool, self.batch).cpu().numpy())
        if self.context_names:
            c = torch.randint(len(self.context_names), (n,), generator=gen,
                              device=dev, dtype=torch.int32)
            u = torch.rand(n, generator=gen, device=dev)
            c = torch.where(u < float(mix["context_share"]), c, -1)
            self.context = list(c.view(pool, self.batch).cpu().numpy())
        self.exits = self.lag > 0
        self._rt_dev = None
        if self.exits:
            # twice a batch, so that every step's exits find a window
            z = torch.randn(2 * self.batch, generator=gen,
                            dtype=torch.float64, device=dev)
            rt = torch.exp(z * float(mix["rt_sigma"])) * float(
                mix["rt_median_ms"])
            rt = torch.clamp(torch.round(rt), 0, int(mix["rt_max_ms"]))
            self.rt = rt.to(torch.int32).cpu().numpy()
            u = torch.rand(2 * self.batch, generator=gen, device=dev)
            self.noise_err = (u < float(mix["error_share"])).cpu().numpy()
            # the names whose every exit raises, lane by lane
            failing = int(mix["failing_ranks"])
            self.failing = [r < failing for r in self.pool]
        keep = np.random.default_rng(seed64(seed, 2)).random(SAMPLE_PLAN)
        self.keep_plan = keep < float(mix["verdict_sample"])

    def ranks(self, k: int) -> np.ndarray:
        """The resource ranks of step ``k``'s batch."""
        return self.pool[k % len(self.pool)]

    def inputs(self, p: int) -> dict:
        """Pool batch ``p`` by name, origin and context index: what the
        reference is given."""
        out = {"ranks": self.pool[p]}
        if self.origin is not None:
            out["origin"] = self.origin[p]
        if self.context is not None:
            out["context"] = self.context[p]
        return out

    def program_pool(self, prog) -> list:
        """Every pool batch as the program's raw entry takes it: the
        rows it interned, and with origins or contexts their ids
        (interned in the traffic's order) and node-table rows."""
        sph, rows = prog.sph, prog.rows
        ra = sph.spec.alt_rows
        ids_of = {}
        for key, names, table in (("origin", self.origin_names, sph.origins),
                                  ("context", self.context_names,
                                   sph.contexts)):
            if getattr(self, key) is not None:
                ids_of[key] = np.array([table.get_or_create(n)
                                        for n in names], np.int32)
        out = []
        for p in range(len(self.pool)):
            cols = {"rows": rows[self.pool[p]]}
            for key, kind in (("origin", 0), ("context", 1)):
                if key not in ids_of:
                    continue
                i = getattr(self, key)[p]
                ids = np.where(i >= 0, ids_of[key][np.maximum(i, 0)],
                               0).astype(np.int32)
                node = np.where(i >= 0, deploy.alt_rows(cols["rows"], kind,
                                                        ids, ra), ra)
                cols[f"{key}_ids"] = ids
                cols["origin_rows" if kind == 0 else "chain_rows"] = \
                    node.astype(np.int32)
            out.append(cols)
        return out

    def exit_offset(self, k: int) -> int:
        """Where step ``k``'s exits start in the RT and error streams."""
        return (k * 104_729) % self.batch

    def exit_columns(self, k: int, n: int):
        """(rt_ms, business-error noise) of step ``k``'s ``n`` exits:
        views of the streams, no copy."""
        off = self.exit_offset(k)
        return self.rt[off:off + n], self.noise_err[off:off + n]

    def exit_lanes(self, k: int, allow: np.ndarray):
        """``(lanes, rt, err)`` of step ``k``'s exits: the lanes admitted
        in step ``k - lag`` (``allow``), their RT and whether each
        raised."""
        # torch's nonzero and numpy's take: several times a numpy
        # boolean index on a random mask of 2^20
        lanes = torch.nonzero(torch.from_numpy(allow)).view(-1).numpy()
        rt, noise = self.exit_columns(k, lanes.shape[0])
        err = self.failing[(k - self.lag) % len(self.pool)].take(lanes) \
            | noise
        return lanes, rt, err

    def program_exits(self, k: int, allow: np.ndarray, pool: list) -> dict:
        """Step ``k``'s exits as the program's fused entry takes them."""
        lanes, rt, err = self.exit_lanes(k, allow)
        prev = pool[(k - self.lag) % len(pool)]
        out = {EXIT_OF[c]: v.take(lanes) for c, v in prev.items()
               if c in EXIT_OF}
        out["exit_rt_ms"] = rt
        out["exit_error"] = err
        return out

    def reference_exits(self, k: int, allow: np.ndarray, inputs: list,
                        device) -> dict:
        """Step ``k``'s exits as the reference takes them (``inputs``:
        the pool's reference columns on ``device``)."""
        lanes, _rt, err = self.exit_lanes(k, allow)
        if self._rt_dev is None:
            self._rt_dev = torch.from_numpy(self.rt).to(device)
        mask = torch.from_numpy(allow).to(device)
        prev = inputs[(k - self.lag) % len(inputs)]
        out = {"exit_" + c: v[mask] for c, v in prev.items()}
        off = self.exit_offset(k)
        out["exit_rt"] = self._rt_dev[off:off + lanes.shape[0]]
        out["exit_err"] = torch.from_numpy(err).to(device)
        return out

    def keep_verdicts(self, k: int) -> bool:
        return bool(self.keep_plan[k % SAMPLE_PLAN])
