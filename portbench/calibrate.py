"""The readings that a cell's limits are set from, in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,... \\
        [--stand-in-seeds 1,2,3] [--seconds 4] [--out FILE.jsonl]

For each seed it makes a run of the cell (``harness.run_cell``, a window of
``--seconds`` at the cell's own load and sizes) and prints the program's
readings against the plain reference; on the stand-in seeds also those of
every stand-in served in the program's place (``check.STAND_INS``: the
control, the reference at TF32, and planted faults). The lower reading of a
number is the largest the program gives over the seeds, the upper the
smallest that the control or a fault gives; ``PERF.md`` records both and the
limit set between them. Needs the card, like ``run``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--stand-in-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from portbench import check, harness

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",") if s]
    stand = {int(s) for s in args.stand_in_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    try:
        for seed in sorted(set(seeds) | stand):
            t0 = time.perf_counter()
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 t_start=t0,
                                 stand_ins=tuple(check.STAND_INS) if seed in stand else ())
            line = dict(workload=args.workload, seed=seed, correct=r["correct"],
                        attempted=r["attempted"], check_s=r["check_s"],
                        metrics={k: v["value"] for k, v in r["metrics"].items()},
                        readings=r["readings"], window=r["window"],
                        wall_s=time.perf_counter() - t0)
            print(json.dumps(line), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
