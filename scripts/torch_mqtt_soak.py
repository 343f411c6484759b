#!/usr/bin/env python3
"""Run the port's MQTT launcher job again and again, and count the runs
that do not end.

The job is chip_smoke.py's distributed (d): 1 server + 2 client processes
of fedml_tpu_torch.experiments.distributed_launch over the bundled MQTT
broker (hosted by rank 0), on FEMNIST-shaped data at the main path's width
(3,400 clients, CNNOriginalFedAvg), 2 rounds of 2 clients. Each run gets a
free port and a directory of its own; a run whose three ranks are not all
out with code 0 within --timeout_s is killed, and its ranks' logs are kept
under --out.

    python3 scripts/torch_mqtt_soak.py --runs 10
    python3 scripts/torch_mqtt_soak.py --runs 10 --trees . ../other_checkout

With several --trees the runs alternate between them (each run puts its
tree's package on PYTHONPATH), so two versions of the transport are held
side by side on one machine in one call. The ranks run on the CUDA card.
Prints one line a run and, last, one JSON object with the counts by tree.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10,
                    help="runs of each tree")
    ap.add_argument("--trees", nargs="+", default=[str(REPO)],
                    help="checkouts whose fedml_tpu_torch the ranks import")
    ap.add_argument("--timeout_s", type=float, default=120.0,
                    help="a run not over by then counts as hung")
    ap.add_argument("--out", default=str(REPO / "chiprun_out" / "mqtt_soak"))
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    import chip_smoke

    chip_smoke.LAUNCH_TIMEOUT_S = args.timeout_s
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trees = [Path(t).resolve() for t in args.trees]
    runs = []
    for i in range(args.runs):
        for tree in trees:
            d = Path(tempfile.mkdtemp(dir=tree, prefix="soak-"))
            t0 = time.time()
            try:
                stdout, _, t_launch, t_exit = chip_smoke._launch_job(
                    chip_smoke._launch_argv(), d)
                rounds = [h["round"] for h in
                          json.loads(stdout.strip().splitlines()[-1])]
                ok = rounds == list(range(chip_smoke.LAUNCH_ROUNDS))
                why = "" if ok else f"history rounds {rounds}"
                exit_s = t_exit - t_launch
            except (AssertionError, subprocess.TimeoutExpired) as e:
                # a rank failed, or the run hung and was killed
                ok, why, exit_s = False, str(e)[:300], time.time() - t0
            if not ok:
                shutil.copytree(d, out / f"run{i}-{tree.name}",
                                dirs_exist_ok=True)
            shutil.rmtree(d, ignore_errors=True)
            runs.append(dict(run=i, tree=str(tree), ok=ok, seconds=exit_s,
                             why=why))
            print(f"soak: run {i} tree {tree}: {'ok' if ok else 'FAILED'} "
                  f"in {exit_s:.2f} s {why}", flush=True)
    summary = {str(t): {"runs": sum(r["tree"] == str(t) for r in runs),
                        "failed": sum(r["tree"] == str(t) and not r["ok"]
                                      for r in runs),
                        "seconds": [r["seconds"] for r in runs
                                    if r["tree"] == str(t)]}
               for t in trees}
    (out / "runs.json").write_text(json.dumps(runs, indent=1))
    print(json.dumps(summary))
    return 0 if all(r["ok"] for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
