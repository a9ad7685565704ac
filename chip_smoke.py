#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cess_tpu_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py [--parent DIR]

Phases, one line each (every number carries the card's name and power
limit):

1. build: nvcc builds ``cess_tpu_torch/csrc/*.cu`` for sm_90a;
2. kernels: each kernel against its plain PyTorch version on the card,
   byte-exact, at the main paths' shapes (``gf_apply`` also with 3 and 5
   output rows, on the RS(4,8) decode and RS(2,1) repair matrices, a
   ragged n, an unaligned view, RS(64,64) and RS(128,128); ``gf_xor`` on
   the RS(4,8) encode and decode, the RS(2,1) repair, the [1, 2] symbol
   fold, a ragged n, an unaligned view, and the RS(16,16) encode, the
   largest schedule that fits a block; ``prf_blocks`` on one fragment of
   16384 blocks and on the main path's 96 fragments x 16384 blocks, both
   layouts, and on 96 fragments x 753 challenged blocks);
3. main path: ``StoragePipeline`` RS(2,1) on 32 segments of 16 MiB (a
   512 MiB upload, 96 fragments of 8 MiB), one audit round (challenge,
   aggregation coefficients, aggregated proof, verification), a
   tampered fragment that must fail, and a byte-exact repair of a lost
   data fragment; the kernels' launch counters are zeroed just before
   and read just after;
4. RS(4,8) on 8 segments of 16 MiB: forward, audit round, and a decode
   of the data from four parity fragments;
5. xor path: ``StoragePipeline`` RS(4,8) under strategy "xor" on 32
   segments of 16 MiB (384 fragments of 4 MiB), byte-equal to the dense
   pipeline's fragments and tags; an audit round; ``RegenCodec(4, 8,
   strategy="xor")`` rebuilds lost fragment 0 of every segment from
   (1, 3, 5, 9) by reconstruct, by a four-hop symbol chain and by a
   warm (CUDA graph) reconstruct; "auto" reads dense at one row and xor
   at 32. Counters are zeroed just before; ``gf_apply`` must not launch
   in the xor forward;
6. known answer: the port at ``cess_tpu_torch.kat``'s configuration
   reproduces the digest the test suite computes with the TPU package,
   under the dense strategy and under "xor";
7. kernel times beside the plain versions' times and each kernel's
   bound: bytes over 3.35 TB/s or integer operations over
   SMs x 128 lanes x 1.98 GHz, whichever is larger (``gf_xor``'s
   operations: per 32-byte group the schedule's XORs and the bit
   transposes of every input and output row, ``rs_xor.kernel_ops``;
   ``gf_apply``'s: per byte position and group of 4 output rows, 2
   lookups and 2 XORs an input row and 2 byte permutes of the
   transpose, ``gf_apply_ops``), with ``gf_apply`` at the RS(2,1) and
   the RS(4,8) encode, and ``gf_xor`` beside ``gf_apply`` on the same
   RS(4,8) encode in turns (the "auto" verdict); and what the card's
   memory sustains: a 512 MiB device copy and a 1.5 GiB fill;
8. with ``--parent DIR`` (another checkout of the repository, e.g. the
   parent commit unpacked by ``git archive``): its ``csrc/*.cu`` are
   built too, and ``gf_apply`` (RS(2,1) and RS(4,8) encode) and
   ``prf_blocks`` are timed through the same wrappers on the same inputs
   with that checkout's kernel and with this one's, in turns parent,
   change, change, parent (``graph_ms``), the outputs compared byte for
   byte.

A kernel's ``ms`` is one wrapper call between two events, the median of
20 (``event_ms``): the host's time to launch is included. Its
``device_ms`` leaves that out: ``graph_ms`` captures 20 calls of the
wrapper in a CUDA graph and replays it.

The line before the last is the ``{"kernels": [...]}`` record; the last
is ``{"ok": true, "device": {...}}``. Any failed check raises and the
script exits non-zero; without a CUDA device it exits 2 and prints no
result. It imports neither jax nor ``cess_tpu``.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time

MIB = 1 << 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA data sheet
# 32-bit integer peak = SMs x lanes dispatched per SM and clock x boost
# clock: a Hopper SM's 4 schedulers dispatch one warp instruction (32
# lanes) each a clock, and integer adds and multiply-adds also run as
# IMAD on the 128 FP32 lanes beside the 64 INT32 ones, so 128 lanes a
# clock is the most any mix reaches (64 INT32 lanes alone is no bound:
# prf_blocks has run faster than its operations over that rate); 1.98
# GHz is the H100 SXM boost clock (its 67 TFLOP/s FP32 rate is 132 SMs x
# 128 FP32 lanes x 2 x 1.98 GHz; NVIDIA H100 architecture white paper)
INT_LANES_PER_SM = 128
BOOST_HZ = 1.98e9
THREEFRY_OPS = 79                # 20 x (add, rotate, xor) + 5 key injections x 3 + 4
TIMED_LAUNCHES = 20
GRAPH_REPLAYS = 5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi cannot name the card and its power limit: "
          f"{out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def max_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def rand_bytes(shape, seed: int, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                         generator=g)


def gf_apply_ops(b: int, n: int, r: int, q: int) -> int:
    """Integer operations of ``gf_apply`` on [b, q, n] -> [b, r, n]: per
    byte position and group of 4 output rows, 2 table lookups and 2 XORs
    for each input row, and 2 byte permutes (a 4 x 4 byte transpose is 8
    for 4 positions)."""
    return b * n * -(-r // 4) * (4 * q + 2)


def event_ms(fn, runs: int) -> float:
    """Median time of one ``fn`` call between two events over ``runs``
    calls, after warm-up: the host's time to launch is included."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, runs: int = TIMED_LAUNCHES, reps: int = GRAPH_REPLAYS
             ) -> float:
    """Device time of one ``fn`` call: ``runs`` calls captured in one CUDA
    graph, the graph replayed ``reps`` times between events; the median
    replay over ``runs``."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(runs):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def parent_turns(parent: str, cases, tag: str) -> None:
    """Time each case's wrapper with the kernels built from ``parent``'s
    sources and with this tree's, in turns parent, change, change,
    parent (``graph_ms``), and check that both give the same bytes.

    ``cases``: (label, module, attribute, name, run) where
    ``module.attribute`` holds the loaded C function ``name`` that the
    wrapper calls (or a dict of them by name; its C interface is the same
    in both trees) and ``run()`` calls the wrapper."""
    from pathlib import Path

    import torch
    from cess_tpu_torch import _build

    csrc = Path(parent) / "cess_tpu_torch" / "csrc"
    lib = ctypes.CDLL(str(_build.build(csrc)))
    # a tree without csrc/prf_blocks.cu keeps prf_blocks in podr2_tag.cu,
    # where it sizes its own launch: no (threads, tile, grid) arguments
    own_launch = not (csrc / "prf_blocks.cu").exists()

    def swapped(module, attr, name):
        mine = getattr(module, attr)
        if isinstance(mine, dict):
            mine = mine[name]
        theirs = getattr(lib, name)
        theirs.restype = mine.restype
        if name == "prf_blocks" and own_launch:
            theirs.argtypes = mine.argtypes[:10] + mine.argtypes[-1:]
            return mine, lambda *a: theirs(*a[:10], a[-1])
        theirs.argtypes = mine.argtypes
        return mine, theirs

    def use(module, attr, name, fn):
        if isinstance(getattr(module, attr), dict):
            getattr(module, attr)[name] = fn
        else:
            setattr(module, attr, fn)

    for label, module, attr, name, run in cases:
        mine, theirs = swapped(module, attr, name)
        use(module, attr, name, theirs)
        want = run().clone()
        times = {}
        try:
            for turn, fn in enumerate((theirs, mine, mine, theirs)):
                use(module, attr, name, fn)
                times[turn] = graph_ms(run)
        finally:
            use(module, attr, name, mine)
        got = run()
        check(torch.equal(got, want),
              f"{label}: this tree's kernel and the parent's differ")
        del want, got
        torch.cuda.empty_cache()
        print(f"turns {label}: parent {times[0]:.4f} ms, change "
              f"{times[1]:.4f} / {times[2]:.4f} ms, parent {times[3]:.4f} "
              f"ms (graph_ms, byte-equal) {tag}")


def main(argv: list[str]) -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout whose gf_apply and "
                    "prf_blocks kernels are timed beside this tree's")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device present", file=sys.stderr)
        return 2
    from cess_tpu_torch import _build, kat
    from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
    from cess_tpu_torch.ops import gf, podr2, prf, regen
    from cess_tpu_torch.ops import rs_kernel, podr2_kernel, rs_xor, xor_sched
    from cess_tpu_torch.ops.rs import TorchCodec

    dev = torch.device("cuda", 0)
    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}")
    kernels = {
        "gf_apply": rs_kernel.gf_apply,
        "podr2_tag": podr2_kernel.podr2_tag,
        "prf_blocks": podr2_kernel.prf_blocks,
        "gf_xor": rs_xor.gf_xor,
    }
    errs = {name: 0 for name in kernels}

    def zero_counts():
        for fn in kernels.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in kernels.items()}

    # 1. build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    for ln in ptxas:
        print(f"  ptxas: {ln}")
    print(f"phase build: {build_s:.3f} s for {len(_build.sources())} "
          f"sources {tag}")

    # 2. kernels against their plain versions -----------------------------
    def gf_case(mat, b, n, seed, encode, unaligned=False):
        tab = rs_kernel.tables(mat, dev)
        r, q = mat.shape
        data = rand_bytes((b, q, n), seed, dev)
        if unaligned:
            view = torch.empty((b, q, n + 1), dtype=torch.uint8,
                               device=dev)[:, :, 1:]
            view.copy_(data)
            got = rs_kernel.gf_apply(tab, view)
        elif encode:
            out = torch.empty((b, q + r, n), dtype=torch.uint8, device=dev)
            rs_kernel.gf_apply(tab, data, out=out[:, q:], sys_out=out[:, :q])
            torch.cuda.synchronize()
            check(torch.equal(out[:, :q], data), "gf_apply systematic copy")
            got = out[:, q:]
        else:
            got = rs_kernel.gf_apply(tab, data)
        want = rs_kernel.gf_apply_plain(tab, data)
        e = max_err(got, want)
        errs["gf_apply"] = max(errs["gf_apply"], e)
        check(e == 0, f"gf_apply {r}x{q} n={n} differs from its plain version")
        del data, got, want
        return f"{r}x{q} n={n}{' unaligned' if unaligned else ''}"

    done = [
        gf_case(gf.cauchy_parity_matrix(2, 1), 32, 8 * MIB, 1, True),
        gf_case(gf.cauchy_parity_matrix(4, 8), 8, 4 * MIB, 2, True),
        gf_case(gf.cauchy_parity_matrix(4, 3), 8, 4 * MIB, 30, True),
        gf_case(gf.cauchy_parity_matrix(4, 5), 8, 4 * MIB, 31, True),
        gf_case(gf.decode_matrix(4, 8, (4, 5, 6, 7)), 8, 4 * MIB, 3, False),
        gf_case(gf.repair_matrix(2, 1, (1, 2), (0,)), 8, 8 * MIB, 32, False),
        gf_case(gf.cauchy_parity_matrix(4, 8), 3, 4 * MIB + 3, 33, True),
        gf_case(gf.cauchy_parity_matrix(4, 5), 3, 4 * MIB + 3, 34, False,
                unaligned=True),
        # 128 KB of tables (one launch) and 512 KB (split over output rows)
        gf_case(gf.cauchy_parity_matrix(64, 64), 2, MIB, 10, True),
        gf_case(gf.cauchy_parity_matrix(128, 128), 2, 64 * 1024, 11, True),
    ]
    torch.cuda.empty_cache()

    def xor_case(mat, b, n, seed, encode, cut=2, unaligned=False):
        """gf_xor on [b, q, n] against its plain version on ``cut`` rows
        at each end of the batch."""
        r, q = mat.shape
        sched = xor_sched.compile_schedule(gf.expand_bitmatrix(mat))
        ops = rs_xor.stage_ops(sched, dev)
        data = rand_bytes((b, q, n), seed, dev)
        if unaligned:
            view = torch.empty((b, q, n + 1), dtype=torch.uint8,
                               device=dev)[:, :, 1:]
            view.copy_(data)
            got = rs_xor.gf_xor(sched, ops, view)
        elif encode:
            out = torch.empty((b, q + r, n), dtype=torch.uint8, device=dev)
            rs_xor.gf_xor(sched, ops, data, out=out[:, q:], sys_out=out[:, :q])
            torch.cuda.synchronize()
            check(torch.equal(out[:, :q], data), "gf_xor systematic copy")
            got = out[:, q:]
        else:
            got = rs_xor.gf_xor(sched, ops, data)
        rows = sorted(set(range(min(cut, b))) | set(range(max(b - cut, 0), b)))
        want = rs_xor.xor_apply_plain(sched, data[rows])
        e = max_err(got[rows], want)
        errs["gf_xor"] = max(errs["gf_xor"], e)
        check(e == 0, f"gf_xor {r}x{q} n={n} differs from its plain version")
        del data, got, want
        torch.cuda.empty_cache()
        return (f"{r}x{q} [{b}, {q}, {n}]{' unaligned' if unaligned else ''}"
                f" T={rs_xor.threads_for(sched)} words={rs_xor.words(sched)}")

    xdone = [
        xor_case(gf.cauchy_parity_matrix(4, 8), 32, 4 * MIB, 20, True),
        xor_case(gf.decode_matrix(4, 8, (4, 5, 6, 7)), 32, 4 * MIB, 21, False),
        xor_case(gf.repair_matrix(2, 1, (1, 2), (0,)), 32, 8 * MIB, 22, False),
        xor_case(np.array([[1, 213]], dtype=np.uint8), 32, 4 * MIB, 23, False),
        xor_case(gf.cauchy_parity_matrix(4, 8), 3, 4 * MIB + 3, 24, True),
        xor_case(gf.cauchy_parity_matrix(4, 8), 3, 4 * MIB + 3, 25, False,
                 unaligned=True),
        xor_case(gf.cauchy_parity_matrix(16, 16), 2, MIB, 26, True),
    ]
    key0 = podr2.Podr2Key.generate(0, device=dev)
    sub_f, blocks = 6, 8 * MIB // podr2.BLOCK_BYTES
    gen = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, 1 << 32, (sub_f, 2), dtype=torch.int64,
                        device=dev, generator=gen)
    prf_k = podr2_kernel.prf_blocks(key0.prf_key, ids, None, blocks, 2,
                                    limb_major=True)
    prf_p = prf.prf_plain(key0.prf_key, ids, torch.arange(
        blocks, device=dev), 2).transpose(1, 2)
    errs["prf_blocks"] = max_err(prf_k, prf_p)
    challenged = torch.randint(0, blocks, (753,), dtype=torch.int64,
                               device=dev, generator=gen)
    errs["prf_blocks"] = max(errs["prf_blocks"], max_err(
        podr2_kernel.prf_blocks(key0.prf_key, ids, challenged, 753, 2),
        prf.prf_plain(key0.prf_key, ids, challenged, 2)))
    # one fragment of a whole fragment's blocks, both layouts (prf_elems),
    # and the audit's 96 fragments x 753 challenged blocks
    one = ids[:1]
    every = torch.arange(blocks, device=dev)
    for limb_major in (False, True):
        want = prf.prf_plain(key0.prf_key, one, every, 2)
        errs["prf_blocks"] = max(errs["prf_blocks"], max_err(
            podr2_kernel.prf_blocks(key0.prf_key, one, None, blocks, 2,
                                    limb_major=limb_major),
            want.transpose(1, 2) if limb_major else want))
    ids96 = torch.randint(0, 1 << 32, (96, 2), dtype=torch.int64,
                          device=dev, generator=gen)
    errs["prf_blocks"] = max(errs["prf_blocks"], max_err(
        podr2_kernel.prf_blocks(key0.prf_key, ids96, challenged, 753, 2),
        prf.prf_plain(key0.prf_key, ids96, challenged, 2)))
    # the main path's tag generation, 96 x 16384 (8 blocks a thread)
    want = prf.prf_plain(key0.prf_key, ids96, every, 2)
    for limb_major in (False, True):
        errs["prf_blocks"] = max(errs["prf_blocks"], max_err(
            podr2_kernel.prf_blocks(key0.prf_key, ids96, None, blocks, 2,
                                    limb_major=limb_major),
            want.transpose(1, 2) if limb_major else want))
    del want
    check(errs["prf_blocks"] == 0, "prf_blocks differs from its plain version")
    data = rand_bytes((sub_f, blocks, podr2.BLOCK_BYTES), 5, dev)
    errs["podr2_tag"] = max_err(
        podr2_kernel.podr2_tag(key0.weights, prf_k, data),
        podr2_kernel.podr2_tag_plain(key0.weights, prf_k, data))
    check(errs["podr2_tag"] == 0, "podr2_tag differs from its plain version")
    del prf_k, prf_p, data
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"phase kernels: gf_apply {', '.join(done)} byte-exact; "
          f"gf_xor {'; '.join(xdone)} byte-exact; "
          f"prf_blocks and podr2_tag byte-exact on {sub_f} fragments x "
          f"{blocks} blocks; prf_blocks on 1 and 96 x {blocks} (both "
          f"layouts), {sub_f} and 96 fragments x 753 challenged blocks {tag}")

    # 3. main path: a 512 MiB RS(2,1) upload, audited and repaired ---------
    cfg = PipelineConfig()
    b = 32
    pipe = StoragePipeline(cfg, device=dev)
    segments = rand_bytes((b, cfg.segment_size), 6, dev)
    rows = cfg.k + cfg.m
    nfrag = b * rows
    id_pairs = torch.stack([torch.arange(nfrag, device=dev),
                            torch.zeros(nfrag, dtype=torch.int64,
                                        device=dev)], dim=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()

    t0 = time.perf_counter()
    out = pipe(segments)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    frags = out["fragments"]
    check(tuple(frags.shape) == (b, rows, cfg.fragment_size),
          "fragment shape")
    check(tuple(out["tags"].shape) == (b, rows, cfg.blocks_per_fragment, 2),
          "tag shape")
    check(torch.equal(frags[:, :cfg.k],
                      segments.view(b, cfg.k, cfg.fragment_size)),
          "systematic rows differ from the input")
    flat = frags.view(nfrag, cfg.fragment_size)
    tags = out["tags"].view(nfrag, cfg.blocks_per_fragment, 2)
    seed = b"chip-smoke-round-1"

    def audit(fr):
        idx, nu = podr2.gen_challenge(seed, cfg.blocks_per_fragment,
                                      device=dev)
        r = podr2.aggregate_coeffs(seed, id_pairs, device=dev)
        mu, sigma = podr2.prove_aggregate(fr, tags, idx, nu, r)
        ok = bool(podr2.verify_aggregate(pipe.podr2_key, id_pairs,
                                         cfg.blocks_per_fragment, idx, nu, r,
                                         mu, sigma))
        return ok, idx

    t0 = time.perf_counter()
    ok, idx = audit(flat)
    torch.cuda.synchronize()
    audit_s = time.perf_counter() - t0
    check(ok, "honest aggregated proof did not verify")
    check(idx.numel() == 753, f"challenge has {idx.numel()} indices, not 753")
    pos = int(idx[0]) * podr2.BLOCK_BYTES
    flat[5, pos] ^= 0xFF
    tampered_ok, _ = audit(flat)
    flat[5, pos] ^= 0xFF
    check(not tampered_ok, "proof over a tampered fragment verified")
    codec = TorchCodec(cfg.k, cfg.m, device=dev)
    t0 = time.perf_counter()
    rebuilt = codec.reconstruct(frags[:, 1:], present=(1, 2), missing=(0,))
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - t0
    check(torch.equal(rebuilt, frags[:, :1]), "repaired fragment differs")
    launches = counts()
    main_kernels = ("gf_apply", "podr2_tag", "prf_blocks")
    check(all(launches[k] > 0 for k in main_kernels),
          f"a kernel was not launched on the main path: {launches}")
    print(f"phase main: RS(2,1) {b} x 16 MiB segments ({b * 16} MiB) -> "
          f"{nfrag} fragments; forward {fwd_s * 1e3:.3f} ms, audit round "
          f"{audit_s * 1e3:.3f} ms (753 blocks, verify true, tampered "
          f"false), repair {repair_s * 1e3:.3f} ms byte-exact; peak "
          f"{peak / MIB:.1f} MiB; launches {launches} {tag}")
    del out, frags, flat, tags, rebuilt, segments
    torch.cuda.empty_cache()

    # 4. BASELINE geometry RS(4,8) ----------------------------------------
    cfg8 = PipelineConfig(k=4, m=8)
    b8 = 8
    pipe8 = StoragePipeline(cfg8, device=dev)
    seg8 = rand_bytes((b8, cfg8.segment_size), 7, dev)
    zero_counts()
    t0 = time.perf_counter()
    out8 = pipe8(seg8)
    torch.cuda.synchronize()
    fwd8_s = time.perf_counter() - t0
    n8 = b8 * 12
    ids8 = torch.stack([torch.arange(n8, device=dev),
                        torch.zeros(n8, dtype=torch.int64, device=dev)], dim=1)
    blocks8 = cfg8.blocks_per_fragment
    idx8, nu8 = podr2.gen_challenge(b"chip-smoke-round-2", blocks8, device=dev)
    r8 = podr2.aggregate_coeffs(b"chip-smoke-round-2", ids8, device=dev)
    mu8, sg8 = podr2.prove_aggregate(
        out8["fragments"].view(n8, -1),
        out8["tags"].view(n8, blocks8, 2), idx8, nu8, r8)
    check(bool(podr2.verify_aggregate(pipe8.podr2_key, ids8, blocks8, idx8,
                                      nu8, r8, mu8, sg8)),
          "RS(4,8) aggregated proof did not verify")
    codec8 = TorchCodec(4, 8, device=dev)
    decoded = codec8.decode_data(out8["fragments"][:, 4:8], (4, 5, 6, 7))
    check(torch.equal(decoded, seg8.view(b8, 4, -1)),
          "RS(4,8) decode from four parity fragments differs")
    launches8 = counts()
    print(f"phase rs48: RS(4,8) {b8} x 16 MiB segments -> {n8} fragments of "
          f"4 MiB; forward {fwd8_s * 1e3:.3f} ms; audit verify true; 4-erasure "
          f"decode byte-exact; launches {launches8} {tag}")
    del out8, seg8, decoded
    torch.cuda.empty_cache()

    # 5. the xor path: RS(4,8) under strategy "xor", audited and repaired --
    bx = 32
    cfgx = PipelineConfig(k=4, m=8, strategy="xor")
    nx = cfgx.fragment_size
    segx = rand_bytes((bx, cfgx.segment_size), 12, dev)
    dense = StoragePipeline(PipelineConfig(k=4, m=8), device=dev)(segx)
    pipex = StoragePipeline(cfgx, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    outx = pipex(segx)
    torch.cuda.synchronize()
    fwdx_s = time.perf_counter() - t0
    fwd_launches = counts()
    check(fwd_launches["gf_xor"] > 0 and fwd_launches["gf_apply"] == 0,
          f"the xor forward did not run on gf_xor alone: {fwd_launches}")
    fragsx = outx["fragments"]
    check(torch.equal(fragsx, dense["fragments"]),
          "xor fragments differ from the dense pipeline's")
    check(torch.equal(outx["tags"], dense["tags"]),
          "xor tags differ from the dense pipeline's")
    del dense
    nfx = bx * 12
    idsx = torch.stack([torch.arange(nfx, device=dev),
                        torch.zeros(nfx, dtype=torch.int64, device=dev)], dim=1)
    blocksx = cfgx.blocks_per_fragment
    seedx = b"chip-smoke-round-xor"
    idxx, nux = podr2.gen_challenge(seedx, blocksx, device=dev)
    rx = podr2.aggregate_coeffs(seedx, idsx, device=dev)
    mux, sgx = podr2.prove_aggregate(fragsx.view(nfx, -1),
                                     outx["tags"].view(nfx, blocksx, 2),
                                     idxx, nux, rx)
    check(bool(podr2.verify_aggregate(pipex.podr2_key, idsx, blocksx, idxx,
                                      nux, rx, mux, sgx)),
          "xor-path aggregated proof did not verify")
    codecx = regen.RegenCodec(4, 8, device=dev, strategy="xor")
    present, lost = (1, 3, 5, 9), fragsx[:, :1]
    surv = fragsx[:, list(present)]
    t0 = time.perf_counter()
    rebuilt = codecx.reconstruct(surv, present, (0,))
    torch.cuda.synchronize()
    repairx_s = time.perf_counter() - t0
    check(torch.equal(rebuilt, lost), "regen reconstruct differs")
    coeffs = codecx.repair_coeffs(present, (0,))
    acc = torch.zeros_like(lost)
    for p, row in enumerate(present):
        acc = codecx.fold_symbol(
            torch.cat([acc, fragsx[:, row:row + 1]], dim=1), coeffs[p])
    check(torch.equal(acc, lost), "four-hop symbol chain differs")
    codecx.warm_reconstruct(present, (0,), surv.shape)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = codecx.reconstruct(surv, present, (0,))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    check(codecx.warm_hits == 1, f"warm_hits {codecx.warm_hits} != 1")
    check(torch.equal(warm, lost), "warm (CUDA graph) reconstruct differs")
    auto = TorchCodec(4, 8, device=dev, strategy="auto")
    verdicts = [dict(auto.program_meta("encode", shape=(rows, 4, nx)))[
        "strategy"] for rows in (1, 32)]
    check(verdicts == ["auto:dense", "auto:xor"],
          f"auto verdicts {verdicts} != ['auto:dense', 'auto:xor']")
    launchesx = counts()
    xor_kernels = ("gf_xor", "podr2_tag", "prf_blocks")
    check(all(launchesx[k] > 0 for k in xor_kernels),
          f"a kernel was not launched on the xor path: {launchesx}")
    print(f"phase xor: RS(4,8) strategy xor {bx} x 16 MiB segments "
          f"({bx * 16} MiB) -> {nfx} fragments of 4 MiB; forward "
          f"{fwdx_s * 1e3:.3f} ms, fragments and tags byte-equal to the dense "
          f"pipeline; audit verify true; regen reconstruct of fragment 0 from "
          f"{present} {repairx_s * 1e3:.3f} ms, 4-hop symbol chain and warm "
          f"CUDA-graph reconstruct ({warm_s * 1e3:.3f} ms, warm_hits 1) "
          f"byte-exact; auto at 1 and 32 rows: {verdicts}; forward launches "
          f"{fwd_launches}; phase launches {launchesx} {tag}")
    del outx, fragsx, segx, surv, rebuilt, acc, warm, lost, codecx
    torch.cuda.empty_cache()

    # 6. known answer -------------------------------------------------------
    for strategy in (None, "xor"):
        digest, kat_ok = kat.run_port(dev, strategy)
        check(kat_ok, f"known-answer proof did not verify ({strategy})")
        check(digest == kat.DIGEST,
              f"known-answer digest {digest} != {kat.DIGEST} ({strategy})")
    print(f"phase kat: digest {digest} matches the TPU package's, dense and "
          f"xor")

    # 7. kernel times at the main paths' shapes ----------------------------
    n = cfg.fragment_size
    data = rand_bytes((b, cfg.k, n), 8, dev)
    enc = torch.empty((b, rows, n), dtype=torch.uint8, device=dev)
    tab = pipe.parity_tables
    blocks = cfg.blocks_per_fragment
    frag_bytes = rand_bytes((nfrag, blocks, podr2.BLOCK_BYTES), 9, dev)
    w = pipe.podr2_key.weights
    prf_lm = podr2_kernel.prf_blocks(pipe.prf_key, id_pairs, None, blocks, 2,
                                     limb_major=True)
    datax = rand_bytes((bx, 4, nx), 13, dev)
    encx = torch.empty((bx, 12, nx), dtype=torch.uint8, device=dev)
    schedx, opsx = pipex.parity_sched, pipex.parity_ops
    tab48 = pipe8.parity_tables
    runs = {
        "gf_xor": (
            lambda: rs_xor.gf_xor(schedx, opsx, datax, out=encx[:, 4:],
                                  sys_out=encx[:, :4]),
            lambda: rs_xor.xor_apply_plain(schedx, datax)),
        "gf_apply": (
            lambda: rs_kernel.gf_apply(tab, data, out=enc[:, cfg.k:],
                                       sys_out=enc[:, :cfg.k]),
            lambda: rs_kernel.gf_apply_plain(tab, data)),
        "gf_apply RS(4,8)": (
            lambda: rs_kernel.gf_apply(tab48, datax, out=encx[:, 4:],
                                       sys_out=encx[:, :4]),
            lambda: rs_kernel.gf_apply_plain(tab48, datax)),
        "prf_blocks": (
            lambda: podr2_kernel.prf_blocks(pipe.prf_key, id_pairs, None, blocks,
                                            2, limb_major=True),
            lambda: prf.prf_plain(pipe.prf_key, id_pairs, torch.arange(
                blocks, device=dev), 2)),
        "podr2_tag": (
            lambda: podr2_kernel.podr2_tag(w, prf_lm, frag_bytes),
            lambda: podr2_kernel.podr2_tag_plain(w, prf_lm, frag_bytes)),
    }
    seg_bytes = b * cfg.segment_size
    tag_out = nfrag * blocks * 2 * 4
    bounds = {
        # bytes: data in, systematic + parity out; ops: gf_apply_ops
        "gf_apply": (seg_bytes + b * rows * n,
                     gf_apply_ops(b, n, cfg.m, cfg.k)),
        "gf_apply RS(4,8)": (bx * 4 * nx + bx * 12 * nx,
                             gf_apply_ops(bx, nx, 8, 4)),
        # bytes: ids in, field elements out; ops: 2 id folds per fragment,
        # one block fold and one hash per limb per block
        "prf_blocks": (nfrag * 16 + tag_out,
                       (nfrag * 2 + nfrag * blocks * 3) * THREEFRY_OPS),
        # bytes: fragment bytes, weights and PRF in, tags out; ops: one
        # multiply and one add per byte and limb
        "podr2_tag": (nfrag * n + w.numel() * 4 + 2 * tag_out,
                      nfrag * n * 2 * 2),
        # bytes: data in, systematic + parity out; ops: per 32-byte group
        # the schedule's XORs and one 8-word bit transpose per input and
        # output row
        "gf_xor": (bx * 4 * nx + bx * 12 * nx,
                   bx * -(-nx // rs_xor.GROUP) * rs_xor.kernel_ops(schedx)),
    }
    sources = {
        "gf_apply": ("cess_tpu_torch/csrc/gf_apply.cu",
                     "cess_tpu/ops/rs_pallas.py:46"),
        "podr2_tag": ("cess_tpu_torch/csrc/podr2_tag.cu",
                      "cess_tpu/ops/podr2_pallas.py:67"),
        "prf_blocks": ("cess_tpu_torch/csrc/prf_blocks.cu",
                       "cess_tpu/ops/podr2.py:170"),
        "gf_xor": ("cess_tpu_torch/csrc/gf_xor.cu",
                   "cess_tpu/ops/rs_xor.py:96"),
    }
    # the path whose run gives each kernel's launches: the RS(2,1) main
    # path, the RS(4,8) phase for gf_apply there, the xor path for gf_xor
    path_launches = {**launches, "gf_xor": launchesx["gf_xor"],
                     "gf_apply RS(4,8)": launches8["gf_apply"]}
    rs48 = f"RS(4,8) encode [{bx}, 4, {nx}] -> [{bx}, 12, {nx}]"
    shapes = {
        "gf_apply": f"RS(2,1) encode [{b}, 2, {n}] -> [{b}, 3, {n}]",
        "gf_apply RS(4,8)": rs48,
        "podr2_tag": f"[{nfrag}, {blocks}, 512] x 2 limbs",
        "prf_blocks": f"{nfrag} x {blocks} blocks x 2 limbs, limb-major",
        "gf_xor": rs48,
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = sms * INT_LANES_PER_SM * BOOST_HZ
    print(f"bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM; "
          f"{int_ops_per_s / 1e12:.3f} T int32 ops/s ({sms} SMs x "
          f"{INT_LANES_PER_SM} lanes x {BOOST_HZ / 1e9:.2f} GHz) {tag}")
    record = []
    for label in ("gf_apply", "gf_apply RS(4,8)", "podr2_tag", "prf_blocks",
                  "gf_xor"):
        name = label.split()[0]
        kern, plain = runs[label]
        ms = event_ms(kern, TIMED_LAUNCHES)
        device_ms = graph_ms(kern)
        plain_ms = event_ms(plain, 3)
        torch.cuda.empty_cache()
        nbytes, ops = bounds[label]
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / int_ops_per_s * 1e3
        bound_ms = max(t_bytes, t_ops)
        record.append({
            "name": name, "shape": shapes[label], "route": "cuda",
            "source": sources[name][0], "replaces": sources[name][1],
            "launches": path_launches[label], "max_abs_err": errs[name],
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
        print(f"time {label}: {ms:.4f} ms a call (device {device_ms:.4f}), "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
              f"{record[-1]['bound_by']}, roofline share {bound_ms / ms:.1%} "
              f"(device {bound_ms / device_ms:.1%}) {tag}")
    # the "auto" verdict on this card: both lowerings of the RS(4,8) encode
    # on the same data, in turns (dense, xor, xor, dense)
    dense_run = runs["gf_apply RS(4,8)"][0]
    turns = [graph_ms(fn) for fn in
             (dense_run, runs["gf_xor"][0], runs["gf_xor"][0], dense_run)]
    dense_ms = statistics.median([turns[0], turns[3]])
    xor_ms = statistics.median([turns[1], turns[2]])
    dense_bound = max((bx * 4 * nx + bx * 12 * nx) / HBM_BYTES_PER_S,
                      gf_apply_ops(bx, nx, 8, 4) / int_ops_per_s) * 1e3
    print(f"auto verdict at RS(4,8) [{bx}, 4, {nx}] encode: gf_xor "
          f"{turns[1]:.4f}/{turns[2]:.4f} ms, gf_apply {turns[0]:.4f}/"
          f"{turns[3]:.4f} ms (turns dense, xor, xor, dense; bounds "
          f"{record[-1]['bound_ms']:.4f} and {dense_bound:.4f} ms); the TPU "
          f"cost model's 'xor' {'holds' if xor_ms < dense_ms else 'does not hold'}"
          f" on this card {tag}")
    # what the card's memory sustains, for the byte-bound kernels beside
    # it: a device copy of datax's 512 MiB and a fill of encx's 1.5 GiB
    # (library calls, timed here only)
    flat_in, flat_out = datax.view(-1), encx.view(-1)
    copy_ms = graph_ms(lambda: flat_out[:flat_in.numel()].copy_(flat_in))
    fill_ms = graph_ms(lambda: flat_out.fill_(0))
    print(f"hbm: copy {flat_in.numel() / MIB:.0f} MiB {copy_ms:.4f} ms = "
          f"{2 * flat_in.numel() / copy_ms / 1e9:.3f} TB/s read + written; "
          f"fill {flat_out.numel() / MIB:.0f} MiB {fill_ms:.4f} ms = "
          f"{flat_out.numel() / fill_ms / 1e9:.3f} TB/s (device times) {tag}")
    if args.parent:
        parent_turns(args.parent, [
            ("gf_apply RS(2,1) encode", rs_kernel, "_fn", "gf_apply",
             runs["gf_apply"][0]),
            ("gf_apply RS(4,8) encode", rs_kernel, "_fn", "gf_apply",
             runs["gf_apply RS(4,8)"][0]),
            ("prf_blocks 96 x 16384 x 2 limb-major", podr2_kernel, "_fns",
             "prf_blocks", runs["prf_blocks"][0]),
            ("prf_blocks 96 x 753 x 2 block-major", podr2_kernel, "_fns",
             "prf_blocks", lambda: podr2_kernel.prf_blocks(
                 pipe.prf_key, id_pairs, idx, idx.shape[0], 2)),
            ("prf_blocks 1 x 16384 x 2 block-major", podr2_kernel, "_fns",
             "prf_blocks", lambda: podr2_kernel.prf_blocks(
                 pipe.prf_key, id_pairs[:1], None, blocks, 2)),
        ], tag)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
