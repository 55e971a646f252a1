"""The control of a cell's comparison: the plain reference computed in a
lower precision than the configuration states (bfloat16 for float32), put
in the program's place, and held to the same numbers and limits. A sound
comparison finds it not correct. The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed ...]
        [--passes N] [--dtype bfloat16]

For each seed: the cell's set-up, ``--passes`` passes of the program (an
SPPM iteration cell's control starts from the program's own states before
its sampled iterations), then the control's numbers. Prints one JSON line
per seed: the numbers, their limits, and whether any number fails."""

from __future__ import annotations

import json
import sys

import run


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--passes", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    run._env()
    import torch
    if not torch.cuda.is_available():
        run.log("the control runs on a CUDA card")
        return 2
    for seed in args.seed:
        print(json.dumps(control(args.workload, seed, args.passes,
                                 getattr(torch, args.dtype), "cuda")),
              flush=True)
    return 0


def control(name: str, seed: int, passes: int, dtype, device,
            root=run.ROOT, data_root=run.ROOT) -> dict:
    """The control's numbers of cell ``name`` for ``seed``."""
    import torch
    from harness import registry
    from harness import trace as tracing
    cell = registry.resolve(name, root)
    drv = cell.driver().Driver(cell, seed, torch.device(device), data_root)
    drv.setup()
    spans = tracing.Spans()
    for k in range(passes):
        drv.run_pass(k, spans)
    drv.release()
    numbers = drv.control(cell.check.get("control_passes", 0), dtype)
    limits = cell.check["limits"]
    return {"workload": name, "seed": seed, "dtype": str(dtype),
            "numbers": numbers, "limits": limits,
            "fails": any(v > limits[k] for k, v in numbers.items())}


if __name__ == "__main__":
    sys.exit(main())
