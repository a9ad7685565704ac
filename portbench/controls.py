"""The control of the correctness check: the plain reference put in the
program's place, breaking one guarantee the configurations state, in
the step that would tempt a faster program. A sound check reads it as
not correct.

- ``upload``: the tags' weighted sum taken in float64 matrix products on
  whole field elements, the step below exact integer arithmetic (terms
  to 2^47, sums past 2^53 round), breaking "PoDR2 tags exact in every
  limb".

Run on the card at a cell's own size over some seeds:

    python portbench/controls.py --workload <cell> --seeds 1 2 3 \
        --seconds <s>

Prints one JSON line a seed: the check's numbers and ``correct``.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np

HERE = Path(__file__).resolve().parent
P = (1 << 31) - 1                 # the field of the PoDR2 MACs


def _key(key) -> tuple[np.ndarray, np.ndarray]:
    """The benchmark's key material, read back from the key it built."""
    return (key.alpha.cpu().numpy().astype(np.int64),
            key.prf_key.cpu().numpy().astype(np.uint32))


def _float_dot(m: np.ndarray, w: np.ndarray) -> np.ndarray:
    """sum m * w mod p in float64: rounds once a sum passes 2^53."""
    return np.fmod(m.astype(np.float64) @ w.astype(np.float64), P).astype(
        np.int64)


def upload_batch(pipeline, data, *, tenant=None, file=None):
    from portbench import data as inputs
    from portbench.reference import gf256, m31, threefry

    cfg = pipeline.config
    k, m, seg = cfg.k, cfg.m, cfg.segment_size
    alpha, prf_key = _key(pipeline.podr2_key)
    t0 = time.perf_counter()
    buf = np.frombuffer(data, np.uint8)
    pad = np.zeros(-(-buf.size // seg) * seg, np.uint8)
    pad[:buf.size] = buf
    segs = pad.reshape(-1, seg)
    with ThreadPoolExecutor(inputs.WORKERS) as pool:
        frags = np.stack(list(pool.map(lambda s: gf256.encode(k, m, s),
                                       segs)))
        rows = frags.reshape(-1, frags.shape[-1])
        hashes = list(pool.map(lambda r: hashlib.sha256(r).digest(), rows))
        ids = np.stack([threefry.fragment_id(h) for h in hashes])

        def tag(i):
            e = m31.elems(rows[i]).reshape(-1, alpha.shape[0])
            f = threefry.prf(prf_key, ids[i][None],
                             np.arange(e.shape[0]), alpha.shape[1])[0]
            return (f + _float_dot(e, alpha)) % P

        tags = np.stack(list(pool.map(tag, range(len(rows)))))
        seg_hashes = list(pool.map(lambda s: hashlib.sha256(s).digest(),
                                   segs))
    n = k + m
    frag_hashes = [tuple(hashes[i * n:(i + 1) * n]) for i in range(len(segs))]
    return SimpleNamespace(
        fragments=frags, tags=tags.reshape(len(segs), n, -1, alpha.shape[1])
        .astype(np.uint32), ids=ids.reshape(len(segs), n, 2),
        fragment_hashes=frag_hashes, segment_hashes=seg_hashes,
        file_hash=hashlib.sha256(b"".join(hashes)).digest(), fetches=0,
        seconds={"encode": 0.0, "fetch": 0.0, "hash": 0.0,
                 "tag": time.perf_counter() - t0})


def entries():
    from portbench import program

    return program.Entries(upload_batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the check's controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench import harness

    cell = harness.load_cell(args.workload)
    for seed in args.seeds:
        r = harness.run_cell(cell, seed, args.seconds, False, "cuda",
                             entries())
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": r["correct"],
                          "attempted": r["attempted"],
                          "compared": r["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(HERE.parent)
    sys.exit(main())
