"""Read the compared numbers of a cell under the control and the faults
(``pbench/alter.py``), and of the sound program, on several seeds in one
process, at the cell's own size.  The benchmark's own runs never run it;
it is how the limits in ``cells/<cell>.json`` were read.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 \\
        --modes program,control_7bit,stale --seconds 0 [--out FILE]

``--seconds 0`` closes each window at its first burst.  Prints one JSON
line per seed and mode (and appends it to ``--out``).
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control_7bit")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(1, ROOT)
    import torch
    from pbench import drive, spec
    cell = spec.resolve(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    warm = True
    for seed in [int(s) for s in args.seeds.split(",")]:
        for mode in args.modes.split(","):
            t = time.perf_counter()
            out = drive.run_cell(cell, seed, args.seconds, False, device,
                                 fault=None if mode == "program" else mode,
                                 warm=warm)
            warm = False
            line = json.dumps(dict(
                workload=args.workload, seed=seed, mode=mode,
                correct=out["result"]["correct"], numbers=out["numbers"],
                window=out["window"], seconds=time.perf_counter() - t))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
