"""Run one cell of the port's benchmark once, on the card.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell, its configuration, traffic mix
and metrics come from ``BENCHMARK.json`` (see ``portbench/harness.py``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, the card's name and power limit under ``card``, and last
``compared``: each number the correctness check compared, with its
limit, also printed as the last lines of standard error.

Exits with 2 and prints no result when there is no card, or fewer than
the cell asks for; with 3 when the process holds a module of the JAX
package or of JAX after the window.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cess_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``cess_tpu_torch`` is the port and allowed)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def card_line() -> str:
    """``<name>, <power limit>`` of the first card, from ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e!r})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    compared = result.pop("compared")
    setup_s = result.pop("setup_s")
    result["card"] = card_line()
    result["compared"] = compared
    print(f"portbench: {cell.name} seed {args.seed} setup {setup_s:.3f} s "
          f"correct {result['correct']}", file=sys.stderr)
    for name, c in compared.items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    # a library that would load JAX on its own is kept from it
    os.environ.setdefault("USE_FLAX", "0")
    sys.path[0] = str(HERE.parent)      # the checkout, not portbench/
    sys.exit(main())
