"""The lower-precision control of the benchmark's check.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's inputs as a run makes them, then the plain
reference twice over the same sampled batches (``check.py``), once as
the port computes (DP costs in float32) and once in the nearest
precision below (bfloat16) put in the program's place, and the numbers
``check.compare`` gives the bfloat16 answers against the float32 ones.
A sound check reads them above its limits.  The benchmark's runs never
run this; it prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))


def control(name: str, seed: int, device, bench=None, root=None) -> dict:
    import torch

    from benchmark import check, inputs, registry
    bench = bench or registry.load_benchmark()
    cell = registry.workload(bench, name)
    root = root or registry.ROOT
    inp = inputs.make(registry.config(cell["config"], root),
                      registry.traffic(cell["traffic"], root), seed)
    t0 = time.time()
    ref = check.run_reference(inp, seed, device)
    t1 = time.time()
    low = check.run_reference(inp, seed, device, dtype=torch.bfloat16)
    t2 = time.time()
    program = [c if c is not None else ((), ()) for c in low.reads]
    numbers = check.compare(program, ref)
    correct, _ = check.verdict(numbers)
    return dict(workload=name, seed=seed, correct=correct,
                batches=sorted(ref.batches), reference_s=t1 - t0,
                control_s=t2 - t1, **numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    for seed in a.seeds:
        print(json.dumps(control(a.workload, seed, torch.device("cuda"))),
              flush=True)
    return 0


if __name__ == "__main__":
    if os.path.abspath(sys.path[0] or ".") == _HERE:
        sys.path[0] = os.path.dirname(_HERE)
    else:
        sys.path.insert(0, os.path.dirname(_HERE))
    sys.exit(main())
