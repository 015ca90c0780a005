"""Run one cell of the benchmark of ``ocpg_tpu_torch`` once, on the card.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic mix and
limits are the files that ``BENCHMARK.json`` names (``manifest.py``); the
traffic file's ``"work"`` picks the module that runs it (``kinds/<work>.py``), which
sets up from the seed, warms up, runs the measured window, traces a short
span after it with ``--trace 1``, and then checks the window's outputs
against the plain reference (``reference/``).  The metrics are read by
``metrics/<name>.py``: the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the checks also end standard error.  Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded
after the window, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import List, Mapping, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ocpg_tpu")


def set_cache_dirs(root: str = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the port's
    own kernels build into ``ocpg_tpu_torch/_build/``); keep libraries from
    loading JAX on their own."""
    cache = os.path.join(root, "output", "benchmark_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (compared whole: ``ocpg_tpu_torch`` is not ``ocpg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def device_record(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


def run_cell(args: argparse.Namespace, device: str = "cuda", root: str = ROOT,
             base: str = HERE, t0: float = T0) -> Mapping:
    """Drive the cell and read its metrics; returns the result's fields.
    ``root`` holds the manifest, ``base`` the cell's files."""
    from .manifest import find_cell, work_module, load_manifest, read_metrics

    cell = find_cell(load_manifest(root), args.workload, base)
    runner = work_module(cell.traffic["work"])
    out = runner.run(cell, args, device=device, t0=t0)
    metrics = cell.per_layer if args.trace else cell.end_to_end
    out["metrics"] = read_metrics(metrics, out["ctx"])
    return out


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    set_cache_dirs()
    import torch

    from .manifest import find_cell, load_manifest

    chips = int(find_cell(load_manifest(), args.workload).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: JAX or the JAX package was loaded: {loaded}", file=sys.stderr)
        return 3
    checks = out["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": out["metrics"],
              "device": device_record(chips, out["memory_peak_bytes"])}
    if args.trace:
        result["device"]["busy_s"] = out["ctx"]["trace"].busy_us() / 1e6
        result["device"]["window_s"] = out["ctx"]["trace"].wall_us / 1e6
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
