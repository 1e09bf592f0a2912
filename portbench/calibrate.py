"""The readings that the comparison's limits are set from.

    python3 -m portbench.calibrate --workload flow_1m.fused \\
        --seconds 5 --seeds 101 102 103 ...

For each seed, in one process: the program runs the cell's traffic for
a short window at the cell's own size and load, then the plain
reference replays it (the program's readings: the lower ones), then
each control is put in the program's place and judged by the same
comparison (the upper readings): the reference computed below the
configuration's precision (16-bit counters, bfloat16 RT sums), and the
reference without the guarantee of arrival order (every event judged
against the window as it stood before its batch). One JSON line a seed;
the benchmark's own runs never run the controls.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import types

import torch

from portbench import compare, harness, run

CONTROLS = {"precision": {"counter_bits": 16, "rt_dtype": torch.bfloat16},
            "order": {"batch_order": False}}


def numbers_against(ref, ref_kept, other, other_kept, at_ms,
                    device) -> dict:
    """The comparison's numbers of ``other`` (a reference engine in the
    program's place) against ``ref``."""
    state = {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
             for k, v in other.leaves().items()}
    out = {"verdicts_differ": sum(
        compare.verdicts_differ(types.SimpleNamespace(
            allow=other_kept[k][0].cpu().numpy(),
            reason=other_kept[k][1].cpu().numpy(),
            wait_ms=other_kept[k][2].cpu().numpy()), v)
        for k, v in ref_kept.items())}
    out.update(compare.state_numbers(state, ref.leaves(), at_ms,
                                     ref.windows, device))
    return out


def readings(workload: str, seed: int, seconds: float, device="cuda",
             config_override=None, mix_override=None, bench=None) -> dict:
    """The program's and the controls' numbers on one seed."""
    su = harness.set_up(workload, seed, device,
                        bench or harness.load_benchmark(), config_override,
                        mix_override)
    r = harness.drive(su, seconds, None, device)
    prog = harness.free_program(su, device)
    at_ms = r.steps[-1].at_ms
    ref, kept = harness.replay_reference(su.ref_mod, su.config, su.traffic,
                                         r, su.epoch_ms, device)
    program = {"verdicts_differ": sum(
        compare.verdicts_differ(r.steps[k].kept(), v)
        for k, v in kept.items())}
    program.update(compare.state_numbers(prog, ref.leaves(), at_ms,
                                         ref.windows, device))
    del prog
    out = {"seed": seed, "steps": len(r.steps), "kept_batches": len(kept),
           "program": program}
    for name, kw in CONTROLS.items():
        ctl, ctl_kept = harness.replay_reference(
            su.ref_mod, su.config, su.traffic, r, su.epoch_ms, device, **kw)
        out[f"control_{name}"] = numbers_against(ref, kept, ctl, ctl_kept,
                                                 at_ms, device)
        del ctl, ctl_kept
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    run.set_paths()
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device; not run", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
