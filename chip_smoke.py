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
4. serve: the submission engine (``cess_tpu_torch.serve``) at the main
   path's RS(2,1) and 16 MiB segments, default ``AdmissionPolicy``, 8
   submitter threads (4 pass numpy, 4 CUDA tensors): encodes of 512 MiB
   in all, tags of their 96 fragments, one round's aggregated proofs and
   verifications (one tampered), and, after ``warm_repair``, 4
   reconstructs; every result byte-equal to the direct path; then each
   kernel the engine ran, at every bucket shape it ran (read from its
   program cache: the 96 fragments' tag padded to 128, verify_agg's
   missions x F bucket x 753, the encode and warm repair buckets), on
   the phase's inputs, byte-exact against its plain version; per-class
   batches, occupancy, pad waste and latency, program-cache and warm
   counts; ``gf_apply``, ``prf_blocks`` and ``podr2_tag`` must launch
   under the engine and some class must coalesce;
5. stream: 70 pinned segments of 16 MiB through ``StreamingIngest(pipe,
   batch=32)`` at depth 2 and 1, every batch byte-equal to the direct
   forward, GiB/s from host bytes and the stage clocks beside a pinned
   ``copy_`` of the same bytes (the stream's bound);
6. chaos: the engine with ``resilience`` and a tracer at the main
   path's width (RS(2,1), 16 MiB segments, the chain's key), twice:
   4 encodes of [2, 2, 8 MiB], 2 tags of 12 fragments, a proof and its
   verification of numpy members, one at a time, under
   ``FaultPlan.seeded(b"chip-chaos", ...)`` (``engine.dispatch``,
   ``rs.encode``, ``podr2.tag.cuda``): every result byte-equal to the
   fault-free path, each request's degradation, fallback and kernel
   launches as the plan's crossings and firings say, both breakers
   tripped, then probed closed by clean requests, after which the
   kernels launch again; with the codec breaker held open a CUDA member
   is refused (the engine never computes a payload on the card on the
   host) and a numpy one is served; the firings equal across the two
   runs; the Chrome trace's batch and device spans name their backend
   and the flight recorder pinned an anomalous trace. Then
   ``StreamingIngest`` over 8 pinned 16 MiB segments under a 10 ms
   ``stream.h2d`` delay (byte-equal) and a ``stream.dispatch`` raise
   (surfaces). After the launches are read, each kernel the engines ran
   is held against its plain version at every shape in their program
   caches. Every other phase builds its engines without
   ``resilience``;
7. RS(4,8) on 8 segments of 16 MiB: forward, audit round, and a decode
   of the data from four parity fragments;
8. xor path: ``StoragePipeline`` RS(4,8) under strategy "xor" on 32
   segments of 16 MiB (384 fragments of 4 MiB), byte-equal to the dense
   pipeline's fragments and tags; an audit round; ``RegenCodec(4, 8,
   strategy="xor")`` rebuilds lost fragment 0 of every segment from
   (1, 3, 5, 9) by reconstruct, by a four-hop symbol chain and by a
   warm (CUDA graph) reconstruct; "auto" reads dense at one row and xor
   at 32. Counters are zeroed just before; ``gf_apply`` must not launch
   in the xor forward;
9. known answer: the port at ``cess_tpu_torch.kat``'s configuration
   reproduces the digest the test suite computes with the TPU package,
   under the dense strategy and under "xor";
10. kernel times beside the plain versions' times and each kernel's
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
11. with ``--parent DIR`` (another checkout of the repository, e.g. the
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

The line before the last is the ``{"kernels": [...]}`` record (each
entry's ``launches`` from the main path, ``launches_serve``,
``launches_stream`` and ``launches_chaos`` from phases 4, 5 and 6); the
last
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


def host_ms(fn, runs: int = 3) -> float:
    """Median host-clock time of ``fn`` followed by a synchronize."""
    import torch

    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def class_line(snap: dict) -> str:
    """Each engine class that ran: batches, batched requests, occupancy,
    pad waste, p50/p99 latency."""
    parts = []
    for cls, st in snap["classes"].items():
        if st["batches"]:
            parts.append(
                f"{cls} {st['batches']} batches / {st['completed']} requests "
                f"(occupancy {st['batch_occupancy']}, pad waste "
                f"{st['pad_waste']}, p50 {st['latency_p50'] * 1e3:.3f} ms, "
                f"p99 {st['latency_p99'] * 1e3:.3f} ms)")
    return "; ".join(parts)


def serve_kernel_checks(progs, pipe, dev, data, encs, ids, idx,
                        repairers: int, errs: dict, phase: str = "serve"
                        ) -> str:
    """Each kernel the engine launched, at every bucket shape it ran: the
    shapes come from the keys of the engine's program cache (``progs``;
    the CPU references' ``cpu-fallback`` keys run no kernel and are
    skipped), the inputs are the phase's own, stacked and zero-padded as
    the engine pads them (verify_agg: ``ids[0]`` then each of ``ids`` as
    a mission, each padded to F_bucket). The kernel runs at the whole
    shape; its plain version runs on slices of rows (every op keeps rows
    apart) and must give the same bytes. Returns the shapes held."""
    import torch
    from cess_tpu_torch.ops import gf, podr2, podr2_kernel, prf, rs_kernel

    cfg = pipe.config
    key = pipe.podr2_key
    n, blocks, limbs = cfg.fragment_size, cfg.blocks_per_fragment, key.limbs
    every = torch.arange(blocks, device=dev)

    def padded(x, rows):
        out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=dev)
        out[:min(rows, x.shape[0])] = x[:rows]
        return out

    def held(name, got, plain, step):
        for s in range(0, got.shape[0], step):
            e = max_err(got[s:s + step], plain(s, s + step))
            errs[name] = max(errs[name], e)
            check(e == 0, f"{phase}: {name} at {tuple(got.shape)} differs "
                  f"from its plain version")

    def gf_at(mat, x):
        tab = rs_kernel.tables(mat, dev)
        got = rs_kernel.gf_apply(tab, x)
        held("gf_apply", got, lambda s, e: rs_kernel.gf_apply_plain(
            tab, x[s:e]), 4)
        return f"gf_apply {tuple(x.shape)}"

    frags = torch.cat(encs).reshape(-1, n)
    id_rows = torch.cat(ids)
    missions = [ids[0]] + list(ids)
    done = []
    for k in progs:
        if "cpu-fallback" in k:
            continue
        if k[0] == "encode":
            done.append(gf_at(gf.cauchy_parity_matrix(cfg.k, cfg.m),
                              padded(torch.cat(data), k[3])))
        elif k[0] == "repair":
            present, missing, bucket = k[1], k[2], k[4]
            surv = torch.cat([x[:, list(present)] for x in encs[:repairers]])
            done.append(gf_at(gf.repair_matrix(cfg.k, cfg.m, present,
                                               missing),
                              padded(surv, bucket)))
        elif k[0] == "tag":
            b = k[2]
            f, i = padded(frags, b), padded(id_rows, b)
            prf_lm = podr2_kernel.prf_blocks(key.prf_key, i, None, blocks,
                                             limbs, limb_major=True)
            held("prf_blocks", prf_lm, lambda s, e: prf.prf_plain(
                key.prf_key, i[s:e], every, limbs).transpose(1, 2), 8)
            tags = podr2_kernel.podr2_tag(
                key.weights, prf_lm, f.view(b, blocks, podr2.BLOCK_BYTES))
            held("podr2_tag", tags, lambda s, e: podr2_kernel.podr2_tag_plain(
                key.weights, prf_lm[s:e],
                f[s:e].view(e - s, blocks, podr2.BLOCK_BYTES)), 8)
            done.append(f"prf_blocks (limb-major) and podr2_tag {b} x "
                        f"{blocks}")
            del f, prf_lm, tags
        elif k[0] == "verify_agg":
            fb, rb = k[2], k[3]
            st = torch.zeros((rb, fb, 2), dtype=torch.int64, device=dev)
            for j, m in enumerate(missions[:rb]):
                st[j, :m.shape[0]] = m
            flat = st.view(-1, 2)
            got = podr2_kernel.prf_blocks(key.prf_key, flat, idx,
                                          idx.numel(), limbs)
            held("prf_blocks", got, lambda s, e: prf.prf_plain(
                key.prf_key, flat[s:e], idx, limbs), 64)
            done.append(f"prf_blocks {rb} x {fb} x {idx.numel()}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ", ".join(done)


def serve_phase(pipe, dev, zero_counts, counts, errs: dict,
                tag: str) -> dict:
    """The submission engine at full width: RS(2,1), 16 MiB segments, the
    default AdmissionPolicy, 8 submitter threads (even ones pass numpy,
    odd ones CUDA tensors). In stages, all threads together: an encode of
    4 segments each (512 MiB in all), a tag of the thread's 12 fragments
    with id pairs, one challenge round's aggregated proof and its
    verification (thread 0 also a tampered one); then, after
    ``warm_repair``, threads 0-3 reconstruct fragment 0 of their segments
    from (1, 2). Every result is held byte for byte to the direct path
    on the same inputs. Returns the launches of the engine's work."""
    import threading

    import numpy as np
    import torch
    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.rs import TorchCodec
    from cess_tpu_torch.serve import make_engine

    cfg = pipe.config
    n, rows, blocks = cfg.fragment_size, cfg.k + cfg.m, cfg.blocks_per_fragment
    threads, per, repairers = 8, 4, 4
    seed = b"chip-smoke-serve-round"
    idx, nu = podr2.gen_challenge(seed, blocks, device=dev)
    data = [rand_bytes((per, cfg.k, n), 40 + i, dev) for i in range(threads)]
    ids = [torch.stack([torch.arange(i * per * rows, (i + 1) * per * rows,
                                     device=dev),
                        torch.full((per * rows,), 7, device=dev)], dim=1)
           for i in range(threads)]
    coeffs = [podr2.aggregate_coeffs(seed, x, device=dev) for x in ids]

    def side(i, x):
        """Thread i's view of x: numpy (the JAX package's uint32 for field
        elements and ids) for even threads, the CUDA tensor for odd."""
        if i % 2:
            return x
        x = x.cpu().numpy()
        return x if x.dtype == np.uint8 else x.astype(np.uint32)

    payload = [side(i, d) for i, d in enumerate(data)]
    host_ids = [side(i, x) for i, x in enumerate(ids)]
    host_r = [side(i, x) for i, x in enumerate(coeffs)]
    torch.cuda.synchronize()
    eng = make_engine(cfg.k, cfg.m, podr2_key=pipe.podr2_key)
    res = [dict() for _ in range(threads)]
    errors = []
    stage = threading.Barrier(threads + 1)

    def worker(i):
        try:
            stage.wait()
            enc = eng.encode(payload[i])
            res[i]["enc"] = enc
            frs = enc.reshape(per * rows, n)
            stage.wait()
            stage.wait()
            tags = eng.tag_fragments(host_ids[i], frs)
            res[i]["tags"] = tags
            stage.wait()
            stage.wait()
            mu, sigma = eng.prove_aggregate(frs, tags, idx, nu, host_r[i])
            res[i]["proof"] = (mu, sigma)
            futs = [eng.submit_verify_aggregate(host_ids[i], blocks, idx, nu,
                                                host_r[i], mu, sigma)]
            if i == 0:
                bad = (np.asarray(sigma).astype(np.int64) + 1) % podr2.pf.P
                futs.append(eng.submit_verify_aggregate(
                    host_ids[i], blocks, idx, nu, host_r[i], mu, bad))
            res[i]["verdicts"] = [f.result() for f in futs]
            stage.wait()
            stage.wait()
            if i < repairers:
                res[i]["rebuilt"] = eng.reconstruct(enc[:, 1:], (1, 2), (0,))
            stage.wait()
        except BaseException as e:      # reported by the main thread
            errors.append((i, e))
            stage.abort()

    workers = [threading.Thread(target=worker, args=(i,))
               for i in range(threads)]
    for w in workers:
        w.start()
    zero_counts()
    t0 = time.perf_counter()
    try:
        for _ in range(3):                  # encode, tag, prove + verify
            stage.wait()
            stage.wait()
        # warm the repair buckets the 4 x 4 rows can land in while no
        # thread works on the card (CUDA graph captures)
        eng.warm_repair([((1, 2), (0,))], n, buckets=(4, 8, 16))
        stage.wait()
        stage.wait()
    except threading.BrokenBarrierError:
        pass
    for w in workers:
        w.join(600)
    wall_s = time.perf_counter() - t0
    launches = counts()
    snap = eng.stats_snapshot()
    progs = eng.programs.keys()
    warm_hits = eng.codec.warm_hits
    eng.close()
    check(not errors, f"serve: a submitter failed: {errors[:1]}")
    check(not any(w.is_alive() for w in workers), "serve: a submitter hung")

    def t(x):
        return torch.as_tensor(x).to(dev)

    codec = TorchCodec(cfg.k, cfg.m, device=dev)
    key = pipe.podr2_key
    encs = []
    for i in range(threads):
        r = res[i]
        check(isinstance(r["enc"], np.ndarray) == (i % 2 == 0)
              and isinstance(r["tags"], np.ndarray) == (i % 2 == 0),
              f"serve: thread {i} got results in the wrong domain")
        enc = codec.encode(data[i])
        encs.append(enc)
        check(torch.equal(t(r["enc"]), enc), f"serve: encode {i} differs")
        frs = enc.reshape(per * rows, n)
        tags = podr2.tag_fragments(key, ids[i], frs)
        check(torch.equal(t(r["tags"]), tags), f"serve: tags {i} differ")
        mu, sigma = podr2.prove_aggregate(frs, tags, idx, nu, coeffs[i])
        check(torch.equal(t(r["proof"][0]), mu)
              and torch.equal(t(r["proof"][1]), sigma),
              f"serve: proof {i} differs")
        ok = bool(podr2.verify_aggregate(key, ids[i], blocks, idx, nu,
                                         coeffs[i], mu, sigma))
        want = [ok] if i else [ok, bool(podr2.verify_aggregate(
            key, ids[i], blocks, idx, nu, coeffs[i], mu,
            (sigma.to(torch.int64) + 1) % podr2.pf.P))]
        check(r["verdicts"] == want == ([True] if i else [True, False]),
              f"serve: verdicts {i} {r['verdicts']} != {want}")
        if i < repairers:
            rebuilt = codec.reconstruct(enc[:, 1:], (1, 2), (0,))
            check(torch.equal(t(r["rebuilt"]), rebuilt)
                  and torch.equal(rebuilt, enc[:, :1]),
                  f"serve: reconstruct {i} differs")
    del res, payload, enc, frs, tags
    held = serve_kernel_checks(progs, pipe, dev, data, encs, ids, idx,
                               repairers, errs)
    del data, encs
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")),
          f"serve: a kernel was not launched by the engine: {launches}")
    coalesced = [c for c, st in snap["classes"].items()
                 if st["batches"] and st["batch_occupancy"] > 1]
    check(coalesced, "serve: no class coalesced two requests into a batch")
    check(warm_hits > 0, "serve: no reconstruct replayed a warm program")
    # what a host member's copies cost on the card's host: one numpy
    # submitter's 64 MiB in, its 96 MiB of fragments back (pageable)
    host_in = np.ones((per, cfg.k, n), np.uint8)
    on_card = torch.empty(host_in.shape, dtype=torch.uint8, device=dev)
    out_card = torch.empty((per, rows, n), dtype=torch.uint8, device=dev)
    h2d_ms = host_ms(lambda: on_card.copy_(torch.from_numpy(host_in)))
    d2h_ms = host_ms(lambda: out_card.cpu())
    del host_in, on_card, out_card
    print(f"phase serve: RS(2,1) engine, {threads} submitter threads (4 "
          f"numpy, 4 CUDA tensors), {threads * per} x 16 MiB segments "
          f"encoded, {threads * per * rows} fragments tagged, {threads} "
          f"proofs verified (tampered false), {repairers} reconstructs; all "
          f"byte-equal to the direct path; kernels at the engine's shapes "
          f"byte-exact against their plain versions: {held}; "
          f"{class_line(snap)}; "
          f"programs_built {snap['programs_built']}, programs_reused "
          f"{snap['programs_reused']}, warm_hits {warm_hits}; phase wall "
          f"{wall_s * 1e3:.3f} ms; one numpy member's pageable copies: 64 "
          f"MiB in {h2d_ms:.3f} ms ({64 * MIB / h2d_ms / 1e6:.3f} GB/s), 96 "
          f"MiB out {d2h_ms:.3f} ms ({96 * MIB / d2h_ms / 1e6:.3f} GB/s); "
          f"launches {launches} {tag}")
    return launches


def stream_phase(pipe, dev, zero_counts, counts, tag: str) -> dict:
    """70 segments of 16 MiB (1.09 GiB; the last batch holds 6 rows and
    is padded) in pinned host memory through ``StreamingIngest(pipe,
    batch=32)`` at depth 2 and 1. A first run at each depth holds every
    yielded batch byte for byte to ``pipe`` on the same rows with the
    stream's global ids; a second, timed run gives GiB/s from host bytes
    and the stage clocks. Beside them, the stream's bound: a pinned
    ``copy_`` of the same bytes to the card. Returns the launches of the
    timed depth-2 run."""
    import torch
    from cess_tpu_torch.serve import StreamingIngest

    cfg = pipe.config
    nseg, batch = 70, 32
    rows = cfg.k + cfg.m
    seg_dev = rand_bytes((nseg, cfg.segment_size), 60, dev)
    src = torch.empty(seg_dev.shape, dtype=torch.uint8, pin_memory=True)
    src.copy_(seg_dev)
    nbytes = src.numel()
    gib = nbytes / (1 << 30)
    line = {}
    launches = None
    for depth in (2, 1):
        ing = StreamingIngest(pipe, batch, depth=depth)
        off = 0
        for out in ing.run(src):
            real = out["rows"]
            want = pipe(seg_dev[off:off + real],
                        torch.arange(off * rows, (off + real) * rows,
                                     device=dev))
            check(torch.equal(out["fragments"], want["fragments"])
                  and torch.equal(out["tags"], want["tags"]),
                  f"stream: batch at row {off} (depth {depth}) differs from "
                  f"the direct forward")
            off += batch
            del out, want
        check(off == 3 * batch, f"stream: {off // batch} batches, not 3")
        before = ing.stats.raw()
        torch.cuda.synchronize()
        if depth == 2:
            zero_counts()
        t0 = time.perf_counter()
        for out in ing.run(src):
            del out
        wall = time.perf_counter() - t0
        if depth == 2:
            launches = counts()
        d = {k: v - before[k] for k, v in ing.stats.raw().items()}
        line[depth] = (gib / wall, wall, d)
        del ing
        torch.cuda.empty_cache()
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")),
          f"stream: a kernel was not launched by the stream: {launches}")
    dst = torch.empty_like(seg_dev)
    copy_ms = event_ms(lambda: dst.copy_(src, non_blocking=True), 3)
    copy_gibs = gib / (copy_ms / 1e3)
    del dst, seg_dev, src
    rate2 = line[2][0]

    def stages(depth):
        rate, wall, d = line[depth]
        return (f"depth {depth}: {rate:.3f} GiB/s from host bytes ({wall * 1e3:.3f} "
                f"ms wall; h2d_s {d['h2d_s']:.6f}, dispatch_s "
                f"{d['dispatch_s']:.6f}, stall_s {d['stall_s']:.6f}, "
                f"{d['batches']} batches, {d['padded_segments']} padded "
                f"segments)")

    print(f"phase stream: {nseg} x 16 MiB pinned segments ({gib:.3f} GiB) "
          f"through StreamingIngest(batch={batch}), every batch byte-equal to "
          f"the direct forward at both depths; {stages(2)}; {stages(1)}; "
          f"bound: pinned copy_ of the same bytes {copy_ms:.3f} ms = "
          f"{copy_gibs:.3f} GiB/s ({nbytes / copy_ms / 1e6:.3f} GB/s); depth 2 "
          f"at {rate2 / copy_gibs:.1%} of the copy; launches {launches} {tag}")
    return launches


# the kernels each engine class launches on a batch that ran on the
# card (prove runs plain tensor ops: it has none)
CLASS_KERNELS = {"encode": ("gf_apply",), "tag": ("prf_blocks", "podr2_tag"),
                 "prove": (), "verify": ("prf_blocks",)}
CHAOS_SITES = {"engine.dispatch": (0.5, "raise"), "rs.encode": (0.4, "raise"),
               "podr2.tag.cuda": (0.5, "raise")}


def chaos_run(pipe, counts, want: dict) -> dict:
    """One run of the chaos workload on a fresh engine with resilience,
    a tracer and an attached, armed flight recorder, under
    ``FaultPlan.seeded(b"chip-chaos", CHAOS_SITES, horizon=256)``.
    Submits and waits one request at a time, so the replay is exact: 4
    encodes of [2, 2, 8 MiB], 2 tags of 12 fragments, one aggregated
    proof of the round and its verification, every member numpy (the
    engine serves only host members on the CPU references). Each
    request's degradation, fallback and kernel launches are read against
    the plan's crossings and firings it caused. Then, unarmed, clean
    requests until both breakers close, a last encode and tag on the
    kernels, and, with the codec breaker held open, a CUDA member is
    refused without a launch while a numpy one is served on the host.
    Returns the run's record, with the program-cache keys the engine
    ran."""
    import numpy as np
    import torch
    from cess_tpu_torch.obs import flight, trace
    from cess_tpu_torch.resilience import (FaultPlan, HealthMonitor,
                                           ResilienceConfig, faults)
    from cess_tpu_torch.serve import EngineUnavailable, make_engine

    cfg = pipe.config
    blocks = cfg.blocks_per_fragment
    res = ResilienceConfig(monitor=lambda: HealthMonitor(min_samples=2,
                                                         probe_every=2))
    tracer = trace.Tracer(device_annotations=True)
    rec = flight.FlightRecorder(b"chip-chaos")
    tracer.attach_flight(rec)
    eng = make_engine(cfg.k, cfg.m, podr2_key=pipe.podr2_key,
                      resilience=res, tracer=tracer)
    plan = FaultPlan.seeded(b"chip-chaos", CHAOS_SITES, horizon=256)
    expect = {"degraded": {}, "fallback": {}}
    outs = []
    hd = want["host"]           # numpy copies of the direct path's arrays
    ids, idx, nu, r = hd["ids"], hd["idx"], hd["nu"], hd["r"]

    def request(cls, fn):
        """Run one request; check what the plan says its batch did."""
        crossed0 = plan.counts().get("engine.dispatch", 0)
        fired0 = len(plan.fired_log())
        launched0 = counts()
        out = fn()
        torch.cuda.synchronize()
        crossed = plan.counts().get("engine.dispatch", 0) - crossed0
        fired = len(plan.fired_log()) - fired0
        launched = {k: v - launched0[k] for k, v in counts().items()}
        ran = []
        if not crossed:                      # breaker open: host only
            expect["degraded"][cls] = expect["degraded"].get(cls, 0) + 1
        elif fired:                          # failed attempt: fallback
            expect["fallback"][cls] = expect["fallback"].get(cls, 0) + 1
        else:
            ran = CLASS_KERNELS[cls]
        check(all(launched[k] > 0 for k in ran)
              and not any(launched[k] for k in launched if k not in ran),
              f"chaos: {cls} launched {launched}, expected {ran} (crossed "
              f"{crossed}, fired {fired})")
        outs.append(out)
        return out

    try:
        with flight.armed(rec), faults.armed(plan):
            encs = [request("encode", lambda d=d: eng.encode(d))
                    for d in hd["data"]]
            frs = np.concatenate(encs).reshape(-1, cfg.fragment_size)
            half = frs.shape[0] // 2
            tags = np.concatenate([request(
                "tag", lambda s=s: eng.tag_fragments(ids[s], frs[s]))
                for s in (slice(0, half), slice(half, None))])
            mu, sigma = request("prove", lambda: eng.prove_aggregate(
                frs, tags, idx, nu, r))
            ok = request("verify", lambda: eng.verify_aggregate(
                ids, blocks, idx, nu, r, mu, sigma))
        log = plan.fired_log()
        chaos_snap = res.stats.snapshot()
        check(all(isinstance(x, np.ndarray) for x in encs + [tags, mu, sigma])
              and all(np.array_equal(a, b) for a, b in zip(encs, hd["enc"]))
              and np.array_equal(tags, hd["tags"])
              and np.array_equal(mu, hd["mu"])
              and np.array_equal(sigma, hd["sigma"]) and ok is True,
              "chaos: a result differs from the fault-free direct path")
        check(log, "chaos: the plan never fired")
        check(chaos_snap["degraded_batches"] == expect["degraded"]
              and chaos_snap["fallback_batches"] == expect["fallback"]
              and sum(expect["fallback"].values()) == len(log),
              f"chaos: degradations {chaos_snap['degraded_batches']} / "
              f"{chaos_snap['fallback_batches']} != the plan's {expect} "
              f"({len(log)} firings)")
        trips = {b: chaos_snap["breakers"][b]["trips"]
                 for b in ("codec", "audit")}
        check(all(trips.values()), f"chaos: a breaker never tripped: {trips}")
        # unarmed: clean requests probe both breakers closed
        for _ in range(8):
            if eng.monitors["codec"].state != "closed":
                check(np.array_equal(eng.encode(hd["data"][0]),
                                     hd["enc"][0]), "chaos: clean encode")
            if eng.monitors["audit"].state != "closed":
                check(np.array_equal(eng.tag_fragments(ids[:half],
                                                       frs[:half]),
                                     hd["tags"][:half]), "chaos: clean tag")
        snap = res.stats.snapshot()
        check(all(snap["breakers"][b]["state"] == "closed"
                  and snap["breakers"][b]["recoveries"] >= 1
                  for b in ("codec", "audit")),
              f"chaos: a breaker did not recover: {snap['breakers']}")
        before = counts()
        check(np.array_equal(eng.encode(hd["data"][1]), hd["enc"][1])
              and np.array_equal(eng.tag_fragments(ids[half:], frs[half:]),
                                 hd["tags"][half:]),
              "chaos: a result after recovery differs")
        torch.cuda.synchronize()
        after = counts()
        check(all(after[k] > before[k] for k in ("gf_apply", "prf_blocks",
                                                 "podr2_tag")),
              f"chaos: the kernels did not launch after recovery: "
              f"{before} -> {after}")
        # a payload on the card is never computed on the host
        eng.monitors["codec"].hold_open("chip-smoke")
        fut = eng.submit_encode(want["data"][2])
        try:
            fut.result(600)
            refused = False
        except EngineUnavailable:
            refused = True
        held_host = eng.encode(hd["data"][2])
        eng.monitors["codec"].release()
        torch.cuda.synchronize()
        check(refused and counts() == after
              and np.array_equal(held_host, hd["enc"][2]),
              "chaos: with the codec breaker held open a CUDA member was "
              "not refused, or a numpy member differs or launched a kernel")
        progs = eng.programs.keys()
    finally:
        eng.close()
    spans = tracer.export_chrome()["traceEvents"]
    for name in ("engine.batch", "device.encode", "device.tag"):
        check(any(e["name"] == name and "backend" in e["args"]
                  for e in spans),
              f"chaos: no {name} span with a backend in the trace")
    check(any(e["args"].get("backend") == "cpu-fallback" for e in spans),
          "chaos: no span says cpu-fallback")
    check(rec.snapshot()["anomaly_pins"] >= 1,
          "chaos: the flight recorder pinned no anomalous trace")
    journal = [e["kind"] for e in rec.journal_tail("breaker")]
    check("trip" in journal and "recover" in journal,
          f"chaos: breaker journal {journal}")
    # completed dispatches by op and backend, and the members a failed
    # attempt sent to the CPU (their resilience.fallback spans)
    device_ms = {}
    for e in spans:
        if e["name"].startswith("device.") and "error" not in e["args"]:
            key = (e["name"][7:], e["args"]["backend"])
        elif e["name"] == "resilience.fallback":
            key = (e["args"]["cls"], "fallback")
        else:
            continue
        device_ms.setdefault(key, []).append(e["dur"] / 1e3)
    return {"log": log, "snap": chaos_snap, "final": snap,
            "device_ms": device_ms, "pins": rec.snapshot()["anomaly_pins"],
            "progs": progs,
            "outs": [x for o in outs
                     for x in (o if isinstance(o, tuple) else (o,))]}


def chaos_phase(pipe, dev, zero_counts, counts, errs: dict,
                tag: str) -> dict:
    """The resilience and tracing planes on the card at the main path's
    width (RS(2,1), 16 MiB segments, 8 MiB fragments, the chain's key):
    ``chaos_run`` twice in this process (the same firings, the same
    bytes); then a ``StreamingIngest`` of 8 pinned segments of 16 MiB
    under a 10 ms ``stream.h2d`` delay (its tags equal the clean run's)
    and under a ``stream.dispatch`` raise (it surfaces). After the
    launches are read, each kernel the engines ran is held against its
    plain version at every shape in their program caches. Returns the
    launches of the phase."""
    import statistics as stats

    import numpy as np
    import torch
    from cess_tpu_torch.obs import flight
    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.rs import TorchCodec
    from cess_tpu_torch.resilience import (FaultInjected, FaultPlan,
                                           FaultSpec, faults)
    from cess_tpu_torch.serve import StreamingIngest

    cfg = pipe.config
    n, rows = cfg.fragment_size, cfg.k + cfg.m
    seed = b"chip-smoke-chaos-round"
    codec = TorchCodec(cfg.k, cfg.m, device=dev)
    data = [rand_bytes((2, cfg.k, n), 70 + i, dev) for i in range(4)]
    enc = [codec.encode(d) for d in data]
    frs = torch.cat(enc).reshape(-1, n)
    ids = torch.stack([torch.arange(frs.shape[0], device=dev),
                       torch.full((frs.shape[0],), 11, device=dev)], dim=1)
    tags = podr2.tag_fragments(pipe.podr2_key, ids, frs)
    idx, nu = podr2.gen_challenge(seed, cfg.blocks_per_fragment, device=dev)
    r = podr2.aggregate_coeffs(seed, ids, device=dev)
    mu, sigma = podr2.prove_aggregate(frs, tags, idx, nu, r)
    want = {"data": data, "enc": enc, "ids": ids, "tags": tags, "idx": idx,
            "nu": nu, "r": r, "mu": mu, "sigma": sigma}
    want["host"] = {k: [x.cpu().numpy() for x in v] if isinstance(v, list)
                    else v.cpu().numpy() for k, v in want.items()}
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    runs = [chaos_run(pipe, counts, want) for _ in range(2)]
    wall_s = time.perf_counter() - t0
    a, b = runs
    check(a["log"] == b["log"], f"chaos: firings differ across runs: "
          f"{a['log']} / {b['log']}")
    check(len(a["outs"]) == len(b["outs"])
          and all(np.array_equal(x, y) for x, y in zip(a["outs"], b["outs"])),
          "chaos: outputs differ across runs")

    def counted(snap):
        """A resilience snapshot without the breakers' host-clock mean."""
        return {**snap, "breakers": {
            name: {f: v for f, v in br.items() if f != "mean_latency_s"}
            for name, br in snap["breakers"].items()}}

    check(counted(a["snap"]) == counted(b["snap"]),
          "chaos: degradations or breaker states differ across runs")
    # the stream's seams at the main path's width
    src = torch.empty((8, cfg.segment_size), dtype=torch.uint8,
                      pin_memory=True)
    src.copy_(rand_bytes(tuple(src.shape), 80, dev))
    clean = StreamingIngest(pipe, 4).ingest(src)
    plan = FaultPlan({"stream.h2d": {0: FaultSpec("delay", delay_s=0.01)}})
    with faults.armed(plan):
        delayed = StreamingIngest(pipe, 4).ingest(src)
    check(plan.fired_log() == (("stream.h2d", 0, "delay"),)
          and torch.equal(delayed["tags"], clean["tags"])
          and torch.equal(delayed["fragments"], clean["fragments"]),
          "chaos: the delayed stream differs from the clean one")
    rec = flight.FlightRecorder(b"chip-chaos-stream")
    raised = False
    with flight.armed(rec), faults.armed(FaultPlan(
            {"stream.dispatch": {1: FaultSpec("raise")}})):
        try:
            StreamingIngest(pipe, 4).ingest(src)
        except FaultInjected:
            raised = True
    check(raised and [e["kind"] for e in rec.journal_tail("stream")]
          == ["escape"], "chaos: the stream.dispatch raise did not surface")
    torch.cuda.synchronize()
    launches = counts()
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")),
          f"chaos: a kernel was not launched: {launches}")
    del src, clean, delayed
    held = serve_kernel_checks(
        list(dict.fromkeys(a["progs"] + b["progs"])), pipe, dev, data, enc,
        [ids], idx, 0, errs, "chaos")
    del want, data, enc, frs, tags
    fired = {}
    for site, _, _ in a["log"]:
        fired[site] = fired.get(site, 0) + 1
    spans = ", ".join(f"{op} {backend} {stats.median(v):.3f} ms (n={len(v)})"
                      for (op, backend), v in sorted(a["device_ms"].items()))
    snap, final = a["snap"], a["final"]
    breakers = "; ".join(
        f"{name} trips {final['breakers'][name]['trips']}, recoveries "
        f"{final['breakers'][name]['recoveries']}"
        for name in ("codec", "audit"))
    print(f"phase chaos: RS(2,1) engine with resilience and tracing, 2 runs "
          f"of 4 encodes [2, 2, 8 MiB], 2 tags of 12 fragments, a proof and "
          f"its verification under FaultPlan.seeded(b'chip-chaos'): "
          f"{len(a['log'])} firings {fired}, equal in both runs; degraded "
          f"batches {snap['degraded_batches']}, fallback batches "
          f"{snap['fallback_batches']}; {breakers}; every result "
          f"byte-equal to the fault-free path (numpy members; a CUDA member "
          f"refused while the codec breaker was held open); kernels at the "
          f"engine's shapes byte-exact against their plain versions: {held}; "
          f"{a['pins']} anomalous traces "
          f"pinned; median span (host clock) of completed device.<op> "
          f"dispatches and of fallbacks: {spans}; stream of 8 "
          f"x 16 MiB under "
          f"a 10 ms stream.h2d delay byte-equal, stream.dispatch raise "
          f"surfaced; phase wall {wall_s * 1e3:.3f} ms (both runs); "
          f"launches {launches} {tag}")
    return launches


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

    # 4. serve: the submission engine under 8 submitter threads ----------
    launches_serve = serve_phase(pipe, dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 5. stream: pinned staging of 70 segments through StreamingIngest ---
    launches_stream = stream_phase(pipe, dev, zero_counts, counts, tag)
    torch.cuda.empty_cache()

    # 6. chaos: the resilience and tracing planes under a seeded plan ---
    launches_chaos = chaos_phase(pipe, dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 7. BASELINE geometry RS(4,8) ----------------------------------------
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

    # 8. the xor path: RS(4,8) under strategy "xor", audited and repaired --
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

    # 9. known answer -------------------------------------------------------
    for strategy in (None, "xor"):
        digest, kat_ok = kat.run_port(dev, strategy)
        check(kat_ok, f"known-answer proof did not verify ({strategy})")
        check(digest == kat.DIGEST,
              f"known-answer digest {digest} != {kat.DIGEST} ({strategy})")
    print(f"phase kat: digest {digest} matches the TPU package's, dense and "
          f"xor")

    # 10. kernel times at the main paths' shapes ---------------------------
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
            "launches": path_launches[label],
            "launches_serve": launches_serve.get(name, 0),
            "launches_stream": launches_stream.get(name, 0),
            "launches_chaos": launches_chaos.get(name, 0),
            "max_abs_err": errs[name],
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
