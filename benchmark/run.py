"""The benchmark of raytracer_tpu_torch: one cell of ``BENCHMARK.json`` on
CUDA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout. Set-up imports the program, builds its
libraries at first use (into its own build directory inside the
checkout), loads the scene and runs one warm pass at the cell's shapes;
``setup_s`` is the process's age when the first timed pass starts. Then a
closed loop with one client issues passes of the cell's traffic through
the program's entry, each ending in a device synchronise, until
``--seconds`` have passed; the window is whole passes. With ``--trace 1``
the window is followed by a short stretch under ``torch.profiler``, and
the line carries the per-layer metrics; with ``--trace 0`` the end-to-end
metrics. Either way the program's answers are then compared with the
plain reference (``benchmark/reference/``), and the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, (traced) ``breakdown``, and last
``compared``, each number compared with its limit. Those numbers are also
the last lines of standard error.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is present, and 3 when a module of ``jax``, ``jaxlib``, ``flax`` or
``raytracer_tpu`` is loaded once the window has closed."""

from __future__ import annotations

import itertools
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracer_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``raytracer_tpu_torch`` is not ``raytracer_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _env():
    """Fixed cache directories inside the checkout, before torch loads."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE / "torch_extensions"))
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))


def device_info(device, chips: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": chips,
            "memory_peak_bytes": int(max(
                torch.cuda.max_memory_allocated(i) for i in range(chips)))}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", "; ")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: Path = ROOT, data_root: Path = ROOT,
             age=process_age) -> dict:
    """One run of cell ``name`` on ``device``, everything but the look for
    a card. Returns the result line as a dict (``compared`` last), or
    raises ``SystemExit(3)`` on a forbidden module."""
    import torch
    from harness import registry, stats
    from harness import trace as tracing

    cell = registry.resolve(name, root)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    drv = cell.driver().Driver(cell, seed, dev, data_root, trace)
    spans = tracing.Spans()
    t_imported = age()
    torch.zeros((), device=dev)                 # the device's context
    t_context = age()
    drv.setup()
    sync()
    log(f"set-up: interpreter and imports {t_imported:.3f} s, device "
        f"context {t_context - t_imported:.3f} s, the driver's set-up "
        f"{age() - t_context:.3f} s")

    passes = []
    w0 = time.perf_counter()
    setup_s = age()
    while True:
        t0 = time.perf_counter()
        rec = drv.run_pass(len(passes), spans)
        sync()
        t1 = time.perf_counter()
        rec["s"] = t1 - t0
        passes.append(rec)
        if t1 - w0 >= seconds:
            break
    window_s = t1 - w0
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        raise SystemExit(3)
    dev_rec = device_info(dev, cell.workload["chips"])

    summary = None
    if trace:
        n0 = len(passes)

        def stretch():
            spans.active = True
            try:
                return [drv.run_pass(n0 + i, spans)
                        for i in range(cell.traffic["trace_passes"])]
            finally:
                spans.active = False
        summary = tracing.profile(stretch, dev)

    attempted, failed = len(passes), drv.failed()
    drv.release()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = drv.compare()
    log(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s")
    limits = cell.check["limits"]
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in numbers.items()}
    correct = (failed == 0
               and all(c["value"] <= c["limit"] for c in compared.values()))

    from types import SimpleNamespace
    ctx = SimpleNamespace(cell=cell, passes=passes, window_s=window_s,
                          setup_s=setup_s, stages=drv.stage_ms(),
                          trace=summary, data_root=data_root)
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = cell.metric_reader(m["name"]).read(ctx)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if summary is not None:
        dev_rec["busy_s"] = summary.busy_s
        dev_rec["window_s"] = summary.window_s

    fifths = [0] * 5
    for end in itertools.accumulate(p["s"] for p in passes):
        fifths[min(4, int(5 * end / window_s))] += 1
    log(f"passes a fifth of the window: {fifths}")
    log(f"window: {attempted} passes in {window_s:.4f} s; pass seconds "
        f"p50 {stats.percentile([p['s'] for p in passes], 50):.6f} "
        f"p95 {stats.percentile([p['s'] for p in passes], 95):.6f}; "
        f"setup {setup_s:.3f} s; failed passes {failed}")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        raise SystemExit(3)
    line = {"correct": bool(correct), "attempted": attempted,
            "failed": failed, "metrics": metrics, "device": dev_rec}
    if summary is not None:
        line["breakdown"] = {"device_ops": summary.top_ops(),
                             "idle_gaps": summary.gaps}
    line["compared"] = compared
    return line


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    _env()
    import torch
    from harness import registry
    cell = registry.resolve(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                    "cuda")
    log(f"card (after the run): {power_limit()}")
    emit(line)
    return 0


def emit(line: dict):
    """The numbers compared, each with its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    import json
    for k, c in line["compared"].items():
        log(f"compared {k}: {c['value']!r} (limit {c['limit']!r})")
        if not math.isfinite(c["value"]):        # JSON has no inf or nan
            c["value"] = sys.float_info.max
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
