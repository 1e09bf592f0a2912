"""``python -m sentinel_tpu_torch.tune`` — run a serving-knob sweep on
the GPU and pin the winner as a hardware-fingerprinted ``TUNED.json``.

The flags are the reference's (``python -m sentinel_tpu.tune``), plus
``--device`` (``cuda`` unless given). Typical uses:

    # default two-knob space on the card
    python -m sentinel_tpu_torch.tune --out TUNED.json

    # wider space, longer episodes
    python -m sentinel_tpu_torch.tune --out TUNED.json \\
        --knobs SENTINEL_PIPELINE_DEPTH,SENTINEL_FRONTEND_BATCH,\\
SENTINEL_FRONTEND_BUDGET_MS \\
        --rate 20000 --rungs 500,2000 --slo-p99-ms 20

    # deploy: every process on this hardware starts pre-tuned
    SENTINEL_TUNED_CONFIG=TUNED.json python my_service.py
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sentinel_tpu_torch.tune",
        description="sweep serving knobs through the real serving path "
                    "and pin a per-hardware TUNED.json")
    ap.add_argument("--out", default="TUNED.json",
                    help="artifact path (default TUNED.json)")
    ap.add_argument("--knobs",
                    default="SENTINEL_PIPELINE_DEPTH,"
                            "SENTINEL_FRONTEND_BATCH",
                    help="comma-separated knob envs to sweep")
    ap.add_argument("--workload", default="steady",
                    help="workload-zoo episode (frontend/workloads.py)")
    ap.add_argument("--device", default="cuda",
                    help="device the episodes run on (default cuda)")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered req/s per episode")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="p99 constraint the objective is subject to")
    ap.add_argument("--rungs", default="150,450",
                    help="comma-separated per-rung episode ms "
                         "(successive-halving budgets)")
    ap.add_argument("--passes", type=int, default=1,
                    help="coordinate-descent passes over the space")
    args = ap.parse_args(argv)

    from sentinel_tpu_torch.tune.runner import run_sweep
    out = run_sweep(
        envs=tuple(k.strip() for k in args.knobs.split(",") if k.strip()),
        workload=args.workload, seed=args.seed, rate_rps=args.rate,
        slo_p99_ms=args.slo_p99_ms,
        rung_ms=tuple(int(m) for m in args.rungs.split(",")),
        passes=args.passes, out_path=args.out, device=args.device)
    res = out["result"]
    for rec in res.history:
        print(json.dumps({
            "config": rec.config, "episode_ms": rec.episode_ms,
            "rung": rec.rung, "score": rec.score,
            "decisions_per_s": rec.outcome.decisions_per_s,
            "p99_ms": rec.outcome.p99_ms,
            "parity_ok": rec.outcome.parity_ok}), file=sys.stderr)
    summary = {
        "converged": res.converged,
        "best_config": res.best_config,
        "best_decisions_per_s": res.best_outcome.decisions_per_s,
        "best_p99_ms": res.best_outcome.p99_ms,
        "baseline_decisions_per_s":
            res.baseline_outcome.decisions_per_s,
        "baseline_p99_ms": res.baseline_outcome.p99_ms,
        "trials": out["trials"], "parity_checks": out["parity_checks"],
        "artifact": args.out if out["artifact"] else None,
    }
    print(json.dumps(summary))
    return 0 if res.converged else 1


if __name__ == "__main__":
    raise SystemExit(main())
