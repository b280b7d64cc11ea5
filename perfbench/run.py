"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload solar.tile_sweep --seed 7 --seconds 30 --trace 0

Set-up (``setup_s``, from the start of this process: imports, CUDA, the
kernels' build on a checkout's first run, inputs, weights, warm-up), then
the window of ``--seconds`` (``--trace 1``: a profiled window of at most
the traffic's ``trace_seconds``, and the per-layer metrics), then the
comparison with the plain reference. The last line of standard output is
one JSON object; the compared numbers, each beside its limit, are the
last lines of standard error and the last key of that object.

Exits 2 without the CUDA devices the cell asks for, and 3 if JAX or the
JAX package is loaded once the window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "satellite_computervision_tpu")


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = REPO / "build" / "perfbench-cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)


def forbidden_modules():
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()
    # run as a script, this folder heads sys.path; its module names must
    # not shadow others, and the package is imported from the root
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(REPO))

    from perfbench import harness, manifest

    cell = manifest.resolve(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import satellite_computervision_tpu_torch  # noqa: F401 - fails outside a full checkout

    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, STARTED)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
