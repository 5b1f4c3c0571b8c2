"""One run of one cell of the benchmark of ``svt_av1_tpu_torch``, the
PyTorch and CUDA port of the encoder, on the card it is started on.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Set-up makes the cell's clip from the
seed and warms up its shapes; the window drives the encoder's API for
``--seconds`` and closes at the first burst of packets after that; the
check decodes a seeded sample of the window's packets with the frozen
copy of the port's decoder under ``port_bench/av1ref``.  The last line of
standard output is the result's JSON object; the compared numbers, each with its
limit, are the last lines of standard error.  Exits 2 without a result
when the cell needs more CUDA devices than there are, and 3 when a module
of JAX or of the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(1, ROOT)
    # caches of the program and of PyTorch stay inside the checkout, at
    # fixed paths, whatever the environment says (the port itself builds
    # into build/kernels and build/native there)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    from pbench import drive, isolation, spec
    cell = spec.resolve(args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = drive.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                         device, t_start=T_START)
    for line in out["lines"]:
        print(line)
    bad = isolation.forbidden(sys.modules)
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"modules: no top-level {', '.join(isolation.FORBIDDEN)} among "
          f"the {len(sys.modules)} loaded")
    for line in out["check_lines"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
