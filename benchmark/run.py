#!/usr/bin/env python3
"""Runs one cell of the port's benchmark once, on the machine it is
started on, and prints the result as the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Cells, configurations, traffic mixes and per-layer metrics are found by
name from ``BENCHMARK.json`` (``benchmark/spec.py``).  With ``--trace
1`` the port is imported under ``SPARTAN_TPU_PROFILE=1`` (its spans then
synchronise the card), the window's first requests (the traffic's
``traced_requests``) run under ``torch.profiler``, and the result
carries the per-layer metrics; with ``--trace 0`` it carries the
end-to-end metrics.  The numbers that decide ``correct`` are printed
beside their limits as the last lines of standard error and under
``checks``, the result's last key.  Exits non-zero, with no result,
without a CUDA card, or when JAX or the JAX package was loaded: at the
window's close and again just before the result is printed.

``--control wrong-inputs`` proves every request for other inputs than
it claims (a broken guarantee, for the control runs)."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment(trace: bool) -> None:
    """The default path of the port, its caches inside the checkout."""
    for k in ("SPARTAN_TPU_DEVICE_PROVER", "SPARTAN_TPU_DEVICE_NONZK",
              "SPARTAN_TPU_NATIVE", "SPARTAN_TPU_NATIVE_CACHE",
              "SPARTAN_TPU_MINIZ_LIB", "SPARTAN_TPU_PROFILE"):
        os.environ.pop(k, None)
    if trace:
        os.environ["SPARTAN_TPU_PROFILE"] = "1"
    cache = os.path.join(ROOT, "build", "benchmark-cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")
    # one host thread for torch's and numpy's CPU ops: the prover's host
    # work is one Python thread, and the card's host is shared
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("wrong-inputs",), default=None)
    args = ap.parse_args(argv)
    _environment(bool(args.trace))
    sys.path.insert(0, ROOT)

    import torch

    from benchmark import spec
    from benchmark.loop import run_cell

    cell = spec.Spec().cell(args.workload)  # unknown names fail here
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds,
                   bool(args.trace), T_START, control=args.control)
    return emit(out)


def emit(out: dict) -> int:
    """Prints the checks beside their limits on standard error, then the
    result as the last line of standard output, unless JAX or the JAX
    package has been loaded by now."""
    from benchmark.loop import forbidden_loaded

    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    loaded = forbidden_loaded()
    if loaded:
        print(f"run.py: JAX or the JAX package loaded: {', '.join(loaded)}",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
