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
7. agents: the off-chain agents' device half (``cess_tpu_torch.node``)
   at the main path's width, RS(2,1) with 16 MiB segments and the chain's
   key ``Podr2Key.generate(7)``: a gateway's ``upload_batch`` of 512 MiB
   (encode, one fetch of the fragments, sha256 identities, tags from the
   fragments left on the card), byte-equal to ``StoragePipeline``; three
   miners holding one row of every segment (32 fragments) and 4
   certified fillers of 8 MiB each; one audit round of ``prove_owed``
   and ``verify_owed``: honest proofs true, an empty owed set with a zero
   proof true, a dropped fragment, storage XORed with 0xA5 and a wrong
   owed set false; the same upload and round through a port engine (the
   miners prove from three threads at once, the prove class coalesces),
   every fragment, tag, proof and verdict byte-equal; then the dropped
   fragment and one lost fragment of each row rebuilt cold, warm (after
   ``warm_restoral``) and by regen symbol chains, each hashing to its
   identity. Counters are zeroed just before and read just after;
   ``gf_apply``, ``prf_blocks`` and ``podr2_tag`` must launch, and each
   is then held against its plain version at every shape the phase ran
   (the engine's from its program cache); the line gives the upload's
   stages, the round direct and through the engine, the repairs and the
   peak device memory;
8. mesh: the multi-device data plane (``cess_tpu_torch.parallel``) at
   the main path's width, RS(2,1), the chain's key: the sharded step over
   32 segments on ``make_mesh()`` (every card present) and on the card
   listed 4 times as (4, 1), (2, 2) and (1, 4), fragments and tags
   byte-equal to the forward, every verdict true, one fragment's byte
   shard XORed with 0xA5 failing exactly that fragment; RS(4,8) "xor" on
   8 segments over (2, 2), byte-equal to the dense forward (``gf_xor``
   must launch); ``StreamingIngest(pool=DevicePool([card, card]))``
   over 70 pinned segments, each batch byte-equal to the forward;
   ``run_corpus`` over 1 GiB in batches of 24 (the last partial), every
   batch verified; ``init_multihost`` on ``nccl`` (a world of one) with a
   (1, 2) global mesh, its corpus count and ``psum_mod`` reduced by
   NCCL's int64 ``all_reduce``. Counters zeroed just before and read
   just after; then each kernel held against its plain version at the
   phase's new shapes (byte-shard columns, PRF ranges at an offset); the
   line gives the walls, the peak device memory and the launches;
9. pool: the engine over ``DevicePool([card, card])`` at the main
   path's width with resilience: encodes (staggered numpy), tags of the
   96 fragments, one round's proofs and checks and, after
   ``warm_repair``, 4 reconstructs, byte-equal to the direct path, both
   lanes serving batches and warm hits on each lane; then the chaos
   drill of ``tests/test_pool.py`` twice (lane 0 raising: its breaker
   trips, lane 1 absorbs every batch by requeue, nothing degrades to the
   CPU, a probe reaches lane 0, equal firings and placement logs);
   counters zeroed just before and read just after; then each kernel
   the engine ran held against its plain version at every shape in its
   program cache;
10. slo: the engine's control planes (``obs/slo.py``,
   ``serve/adaptive.py``, ``obs/profile.py``, ``obs/incident.py``) at
   the main path's width with the chain's key: the SLO drill of
   ``tests/test_slo.py`` twice (a seeded 250 ms ``engine.dispatch`` delay
   turns verify burning: encodes of one segment are shed, the codec
   breaker is held, a numpy repair is served on the CPU reference
   byte-equal and a CUDA repair refused with no launch; fault-free,
   verify walks back through warn to ok and encodes launch ``gf_apply``
   again; equal transition logs, shed counts and incident witnesses,
   ``slo-burning`` and ``breaker-hold`` bundles); the engine's encode
   GiB/s of 32 segments measured on this card as the watchdog's baseline,
   and the perf drill twice anchored on it (ok -> regressed -> ok, one
   ``perf-regression`` bundle with both ledgers, equal witnesses); 70
   pinned segments through ``StreamingIngest(batch=32)`` on the drill's
   engine, byte-equal, the tail's 26 pad rows in the engine's pad
   ledger and the profile's stream GiB/s no higher than the stream's own
   from host bytes; phase serve's burst on engines disarmed and fully
   armed, in turns, with each class's p50; counters zeroed just before
   and read just after, then each kernel held against its plain version
   at every shape in the engines' program caches;
11. remediate: the remediation loop (``serve/remediate.py``, fed by
   ``obs/profile.py``'s watchdog and ``obs/fleet.py``'s straggler
   detector) at the main path's width with the chain's key: the engine's
   encode and repair GiB/s of 32 segments measured on this card as the
   watchdog's baseline; the pin drill twice (a single-device engine: a
   seeded 100 ms ``engine.dispatch`` delay regresses encode, ``perf-pin``
   holds the codec breaker on the next tick, a CUDA encode is refused
   with no launch and a numpy one served on the CPU reference byte-equal,
   the re-probe releases it and ``gf_apply`` launches again, the watchdog
   returns to ok; a repair regression pins again and its bundle carries
   the journal) and the quarantine drill twice (``DevicePool([card] *
   4)``, a seeded 80 ms delay at ``engine.dispatch.encode.d2``: the
   straggler detector flags ``card.d2`` alone over window medians of 8
   batches a lane, ``straggler-quarantine`` holds lane 2's breakers on
   the next tick, 16 encodes land on lanes 0, 1 and 3 byte-equal, the
   re-probe returns lane 2 to service); equal plane witnesses and
   placement logs in each pair; counters zeroed just before and read
   just after, then each kernel held against its plain version at every
   shape in the engines' program caches;
12. chain: one storage-audit round from the card's encode to the
   port's ``Runtime`` (``cess_tpu_torch.chain.runtime``,
   ``RuntimeConfig(era_blocks=50)``) at the main path's width (RS(2,1),
   32 segments of 16 MiB, the chain's key ``Podr2Key.generate(7)``),
   driven by ``tests/torch_chain_wiring.py``'s ``audit_round`` as a node
   applies blocks: every call a ``SignedExtrinsic`` of its account's
   ed25519 key through ``Runtime.apply_in_block`` (signature, nonce,
   first-use key binding and fee), block by block. Genesis keys through
   ``System``, the audit keys, the attestation root pinned and the
   enclave whitelisted (root, the chain spec's role); three miners'
   ``sminer.regnstk`` and the TEE's ``tee_worker.register`` (an RSA
   attestation from ``issue_cert`` and ``issue_report``, a BLS key with
   its proof of possession); 4 fillers of 8 MiB a miner certified by
   ``certify_fillers`` on the card and registered through
   ``file_bank.upload_filler`` under the TEE's ed25519 certificate; then
   ``upload_batch`` on the card, the user's ``buy_space``,
   ``create_bucket`` and ``upload_declaration``, every
   ``transfer_report`` and sudo's ``calculate_end``, three validators'
   signed proposals (the challenge starts at 2/3, the third fails with
   ``audit.ChallengeInProgress``), each miner's ``audit.submit_proof``
   of ``build_proof`` wire bytes computed on the card (at most
   SIGMA_MAX), the TEE's decode and ``verify_owed`` on the card and its
   BLS seals through ``audit.submit_verify_result``, after a forged seal
   that fails (``audit.BadVerdictSignature``): honest miners true, a
   miner holding a fragment XORed with 0xA5 false with its
   ``fail_count`` raised, the sealed log re-verified by
   ``reverify_verdicts_batch``. Then empty blocks to the era boundary
   (block 50), where each honest miner's first reward tranche reaches
   its beneficiary and the tampered miner's does not, and the
   validators keep their audit keys. Each block's ``ExtrinsicFailed``
   events must be exactly the two failures named. The native BLS
   library must have loaded. Counters zeroed just before and read just
   after (``gf_apply``, ``podr2_tag`` and ``prf_blocks`` must launch),
   then each kernel held against its plain version at the phase's
   shapes; the line gives the upload's stages, the round's host wall
   split into snapshot and proposals, proofs, checks, seals, pallet
   calls (``apply_in_block``) and block hooks (``init_block``), the era
   block's ``init_block`` apart, the count of signed extrinsics, BLS
   sign and verify times and the final ``state_root``;
13. node: the port's own storage network through its node
   (``cess_tpu_torch.node``), no test helper on it, in the shape of the
   reference's ``storage_net`` fixture (``tests/test_network.py``): 3
   validator ``Node``s in one ``Network``, ``OssGateway``, 4
   ``MinerAgent``s, a ``TeeAgent`` with its BLS key and 2
   ``ValidatorOcw``s, RS(2,1) with 16 MiB segments and the chain's key,
   the agents on an ``AgentPipeline`` on the card. Setup as the fixture
   does it, reduced to 4 fillers of 8 MiB a miner certified on the card
   (the fixture has 400; the other 396 fillers' idle space is granted on
   every replica at genesis); a 512 MiB ``gw.upload`` (32 segments, 96
   fragments), fetched and reported by the miners' ``on_block``, made
   active by ``calculate_end`` through a block, every miner's bytes
   hashing to the on-chain fragment hashes; one fragment of one miner
   XORed with 0xA5, the validators' workers added, slots until every
   miner's ``audit.VerifyResult``: honest true, the tampered service
   proof false, ``RewardPaid``, the sealed verdicts re-verified on
   ``nodes[1]``, the replicas' state roots equal; a lost fragment
   repaired in "fragments" mode and another in "symbols" mode, each
   hashing to its identity, ``RestoralComplete`` naming the rescuer.
   Then the same network, upload and round on one port engine
   (``make_engine(2, 1, podr2_key=key)``) under the gateway, miners and
   TEE: every fragment hash, proof's wire bytes and verdict and the state
   root at the round's last block equal to the direct run's; an
   ``RpcServer`` on ``nodes[0]`` answers ``chain_getFinalizedHead``,
   ``cess_engineStats`` (encode, tag, prove and verify batches) and GET
   /metrics (``cess_engine_*``). Counters zeroed before the first run
   and read after the second (``gf_apply``, ``podr2_tag`` and
   ``prf_blocks`` must launch), then each kernel held against its plain
   version at every shape the phase ran, the engine's from its program
   cache. Last, ``python -m cess_tpu_torch.node.cli --dev --blocks 20
   --block-time 0.1 --rpc-port P`` as a subprocess with ``--engine
   cuda`` (``cess_engineStats`` polled while it runs names a codec on
   the card) and with ``--engine cpu`` and no card visible, each exiting
   0 after block #20. The line gives the upload's stages, slots to the
   verdict, the round's host wall by agent (proofs, the TEE's checks,
   pallet calls, block hooks), the repairs' ms by mode, the peak device
   memory and the final state root;
14. sim: the port's simulated network (``cess_tpu_torch.sim``) on the
   card: ``run_scenario`` of the library's ``adversarial_audit`` at its
   100-node tier-1 scale (5 validators, 4 miners, m1 and m2 storing
   corrupted bytes, 30 rounds, its per-round and final invariants) with
   ``devices=[card]``, cut from the library's test sizes to RS(2,1)
   segments of 16 MiB (fragments and fillers of 8 MiB), a 512 MiB upload
   (32 segments, 96 fragments) and 32 fillers a miner (not 40: 4 x 32 x 8
   MiB is the 1 GiB its ``buy_space`` needs); counters zeroed just
   before and read just after (``gf_apply``, ``podr2_tag`` and
   ``prf_blocks`` launch, ``gf_xor`` does not); each assigned
   adversarial miner's service verdict false and every other true; each
   kernel then held against its plain version at the phase's shapes.
   Then ``adversarial_audit``, ``repair_storm`` (its 3-lane pool on the
   card listed 3 times) and ``miner_attrition`` at 20 nodes on the card
   and on 8 host devices: equal witnesses and pool counts. The line
   gives rounds, slots to the verdict, the upload's, the filler
   streams', the rounds' and the phase's walls and the peak device
   memory;
15. RS(4,8) on 8 segments of 16 MiB: forward, audit round, and a decode
   of the data from four parity fragments;
16. xor path: ``StoragePipeline`` RS(4,8) under strategy "xor" on 32
   segments of 16 MiB (384 fragments of 4 MiB), byte-equal to the dense
   pipeline's fragments and tags; an audit round; ``RegenCodec(4, 8,
   strategy="xor")`` rebuilds lost fragment 0 of every segment from
   (1, 3, 5, 9) by reconstruct, by a four-hop symbol chain and by a
   warm (CUDA graph) reconstruct; "auto" reads dense at one row and xor
   at 32. Counters are zeroed just before; ``gf_apply`` must not launch
   in the xor forward;
17. known answer: the port at ``cess_tpu_torch.kat``'s configuration
   reproduces the digest the test suite computes with the TPU package,
   under the dense strategy and under "xor";
18. kernel times beside the plain versions' times and each kernel's
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
19. native: the C++ host codec (``ops/rs_native.py``, built by g++ into
   ``build/native/``) on the timing phase's RS(4,8) input [32, 4, 4 MiB]:
   ``NativeCodec(4, 8)`` parity on 1 thread and on ``os.cpu_count()``
   threads and the decode of the data from four parity fragments,
   byte-equal to ``gf_apply`` on the card and to ``TorchCodec(4, 8,
   "cpu")`` on a slice; the native GiB/s, ``gf_apply``'s device GiB/s on
   the same bytes and their ratio, ``bench.py``'s CPU-speedup measure (a
   measurement, not a gate);
20. with ``--parent DIR`` (another checkout of the repository, e.g. the
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
``launches_stream``, ``launches_chaos``, ``launches_agents``,
``launches_mesh``, ``launches_pool``, ``launches_slo``,
``launches_remediate``, ``launches_chain``, ``launches_node`` and
``launches_sim`` from phases 4 to 14); the last is ``{"ok": true, "device": {...}}``.
Any failed check raises and the script exits non-zero; without a CUDA device it exits 2 and prints no
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
    a mission, each cut or padded to F_bucket). The kernel runs at the whole
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
                st[j, :min(fb, m.shape[0])] = m[:fb]
            flat = st.view(-1, 2)
            got = podr2_kernel.prf_blocks(key.prf_key, flat, idx,
                                          idx.numel(), limbs)
            held("prf_blocks", got, lambda s, e: prf.prf_plain(
                key.prf_key, flat[s:e], idx, limbs), 64)
            done.append(f"prf_blocks {rb} x {fb} x {idx.numel()}")
    if dev.type == "cuda":
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


def agents_phase(dev, zero_counts, counts, errs: dict, tag: str, cfg=None,
                 nseg: int = 32) -> dict:
    """The off-chain agents' device half (``cess_tpu_torch.node``) at the
    main path's width: RS(2,1), 16 MiB segments, the chain's key
    ``Podr2Key.generate(7)``. A gateway uploads ``nseg`` segments
    (``upload_batch``: encode, one fetch, sha256 identities, tags from the
    fragments left on the card); three miners hold one row of every
    segment each and 4 fillers of a fragment's size the TEE certifies;
    one audit
    round (each miner's service and idle proofs, ``prove_owed``, checked
    by ``verify_owed``) in which miner 1 has dropped a fragment, an
    adversary serves miner 2's deal from bytes XORed with 0xA5, a proof
    is checked against another owed set and an empty set proves zero;
    the upload and round again through a port engine (the miners prove
    from three threads at once), byte-equal; then repairs of the dropped
    fragment and one lost fragment of each row, cold, after
    ``warm_restoral`` and by regen symbol chains, each hashing to its
    identity. Counters are zeroed just before and read just after; then
    each kernel is held against its plain version at every shape the
    phase ran, the engine's program-cache shapes included. A smaller
    ``cfg`` and ``nseg`` (at least 13) rehearse the phase on the CPU.
    Returns the launches of the phase."""
    import threading

    import numpy as np
    import torch
    from cess_tpu_torch.models.pipeline import PipelineConfig
    from cess_tpu_torch.node import offchain as oc
    from cess_tpu_torch.node.hashing import filler_bytes, fragment_hash
    from cess_tpu_torch.ops import gf, podr2, podr2_kernel, prf, regen
    from cess_tpu_torch.ops import rs_kernel
    from cess_tpu_torch.serve import AdmissionPolicy, make_engine

    cfg = cfg or PipelineConfig()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n, rows, blocks = cfg.fragment_size, cfg.k + cfg.m, cfg.blocks_per_fragment
    key = podr2.Podr2Key.generate(7, device=dev)
    pipe = oc.AgentPipeline(cfg, podr2_key=key, device=dev)
    data = rand_bytes((nseg, cfg.segment_size), 90, dev).cpu().numpy()
    seed = b"chip-smoke-agents-round"
    miners = [f"m{j}" for j in range(rows)]
    fillers = 4
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_phase = time.perf_counter()

    # the gateway's upload
    t0 = time.perf_counter()
    up = oc.upload_batch(pipe, data, tenant="alice")
    upload_s = time.perf_counter() - t0
    check(up.fetches == 1 and pipe.fragment_uploads == 0,
          f"agents: the upload fetched {up.fetches} times and uploaded "
          f"fragments {pipe.fragment_uploads} times (want 1 and 0)")

    # the deal: miner j holds row j of every segment, and its fillers
    owed = [[hs[j] for hs in up.fragment_hashes] for j in range(rows)]
    stores = [{h: up.fragments[i, j] for i, h in enumerate(owed[j])}
              for j in range(rows)]
    tagmaps = [{h: up.tags[i, j] for i, h in enumerate(owed[j])}
               for j in range(rows)]
    t0 = time.perf_counter()
    idle, fstores, ftags = [], [], []
    for miner in miners:
        blobs = [filler_bytes(miner, i, n) for i in range(fillers)]
        hashes, ftag = oc.certify_fillers(key, miner, range(fillers), blobs,
                                          blocks, device=dev)
        idle.append(hashes)
        fstores.append(dict(zip(hashes, blobs)))
        ftags.append(dict(zip(hashes, ftag)))
    filler_s = time.perf_counter() - t0
    dropped_seg = 3
    dropped = owed[1][dropped_seg]
    del stores[1][dropped]
    adversary = {h: np.bitwise_xor(f, 0xA5) for h, f in stores[2].items()}

    # one audit round: every miner's proofs, then the TEE's checks
    def audit_round(engine):
        """(proofs, verdicts, seconds proving, seconds checking)."""
        proofs = {}
        t0 = time.perf_counter()

        def prove(j):
            proofs["service", j] = oc.prove_owed(
                seed, owed[j], stores[j], tagmaps[j], engine=engine,
                tenant=miners[j], device=dev)
            proofs["idle", j] = oc.prove_owed(
                seed, idle[j], fstores[j], ftags[j], engine=engine,
                tenant=miners[j], device=dev)

        if engine is None:
            for j in range(rows):
                prove(j)
        else:
            errors = []
            start = threading.Barrier(rows)

            def worker(j):
                try:
                    start.wait()
                    prove(j)
                except BaseException as e:  # reported by the main thread
                    errors.append((j, e))
                    start.abort()

            workers = [threading.Thread(target=worker, args=(j,))
                       for j in range(rows)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(600)
            check(not errors and not any(w.is_alive() for w in workers),
                  f"agents: a proving miner failed or hung: {errors[:1]}")
        proofs["adversary"] = oc.prove_owed(seed, owed[2], adversary,
                                            tagmaps[2], engine=engine,
                                            tenant="mx", device=dev)
        proofs["empty"] = oc.prove_owed(seed, [], {}, {}, engine=engine,
                                        device=dev)
        t1 = time.perf_counter()
        checks = {("service", j): (owed[j], ("service", j))
                  for j in range(rows)}
        checks.update({("idle", j): (idle[j], ("idle", j))
                       for j in range(rows)})
        checks["adversary"] = (owed[2], "adversary")
        checks["wrong owed set"] = (owed[2], ("service", 0))
        checks["empty"] = ([], "empty")
        # the TEE derives the round's challenge once, as TeeAgent does
        idx, nu = oc.HostPodr2(dev).gen_challenge(seed, blocks)
        verdicts = {name: oc.verify_owed(key, blocks, seed, hashes,
                                         *proofs[proof], idx=idx, nu=nu,
                                         engine=engine, tenant="tee0",
                                         device=dev)
                    for name, (hashes, proof) in checks.items()}
        return proofs, verdicts, t1 - t0, time.perf_counter() - t1

    proofs, verdicts, prove_s, verify_s = audit_round(None)
    false = {("service", 1), "adversary", "wrong owed set"}
    want = {name: name not in false for name in verdicts}
    check(verdicts == want, f"agents: verdicts {verdicts} != {want}")

    # the same upload and round through a port engine
    eng = make_engine(cfg.k, cfg.m, podr2_key=key, rs_backend=dev.type,
                      audit_backend=dev.type,
                      policy=AdmissionPolicy(max_delay=0.05))
    pipe.engine = eng
    try:
        t0 = time.perf_counter()
        up_e = oc.upload_batch(pipe, data, tenant="alice")
        upload_e_s = time.perf_counter() - t0
        proofs_e, verdicts_e, prove_e_s, verify_e_s = audit_round(eng)
        snap = eng.stats_snapshot()
        progs = eng.programs.keys()
    finally:
        pipe.engine = None
        eng.close()
    check(np.array_equal(up_e.fragments, up.fragments)
          and np.array_equal(up_e.tags, up.tags)
          and np.array_equal(up_e.ids, up.ids)
          and up_e.fragment_hashes == up.fragment_hashes
          and up_e.file_hash == up.file_hash and up_e.fetches == 1,
          "agents: the engine's upload differs from the direct one")
    check(proofs_e.keys() == proofs.keys()
          and all(np.array_equal(proofs_e[p][i], proofs[p][i])
                  and proofs_e[p][i].dtype == np.uint32
                  for p in proofs for i in (0, 1)),
          "agents: a proof through the engine differs from the direct one")
    check(verdicts_e == verdicts, f"agents: the engine's verdicts "
          f"{verdicts_e} != the direct path's {verdicts}")
    prove_cls = snap["classes"]["prove"]
    check(prove_cls["batch_occupancy"] > 1,
          f"agents: the miners' proofs did not coalesce: {prove_cls}")

    # repair: the dropped fragment and one lost fragment of each row
    lost = [(1, dropped_seg)] + [(j, 10 + j) for j in range(rows)]

    def survivors(row, s):
        present = tuple(x for x in range(rows) if x != row)[:cfg.k]
        return present, [stores[x][up.fragment_hashes[s][x]]
                         for x in present]

    def repaired(rebuild) -> list[float]:
        times = []
        for row, s in lost:
            present, surv = survivors(row, s)
            t0 = time.perf_counter()
            blob = rebuild(present, surv, row)
            times.append((time.perf_counter() - t0) * 1e3)
            check(blob is not None and fragment_hash(blob)
                  == up.fragment_hashes[s][row],
                  f"agents: the repair of row {row} of segment {s} does not "
                  f"hash to its identity")
        return times

    def by_fragments(present, surv, row):
        return oc.repair_via_fragments(cfg.k, cfg.m, surv, present, row,
                                       tenant="m0", device=dev)

    codec = oc.host_codec(cfg.k, cfg.m, device=dev)
    cold = repaired(by_fragments)
    oc.warm_restoral(cfg.k, cfg.m, n, device=dev)
    hits = codec.warm_hits
    warm = repaired(by_fragments)
    check(codec.warm_hits - hits == len(lost),
          f"agents: {codec.warm_hits - hits} warm hits, not {len(lost)}")
    symbol_codec = oc.host_codec(cfg.k, cfg.m, "regen", device=dev)
    symbols = repaired(lambda present, surv, row: oc.repair_via_symbols(
        cfg.k, cfg.m, present, row, surv, codec=symbol_codec, device=dev))
    sync()
    phase_s = time.perf_counter() - t_phase
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")),
          f"agents: a kernel was not launched by the agents: {launches}")

    # each kernel at every shape the phase ran, against its plain version
    def held(name, got, plain):
        e = max_err(got, plain)
        errs[name] = max(errs[name], e)
        check(e == 0, f"agents: {name} at {tuple(got.shape)} differs from "
              f"its plain version")

    seg_t = torch.from_numpy(data).to(dev).view(nseg, cfg.k, n)
    frags_t = torch.from_numpy(np.array(up.fragments)).to(dev)
    want = pipe.pipeline(seg_t.view(nseg, -1), torch.from_numpy(
        up.ids.astype(np.int64)).to(dev))
    check(torch.equal(want["fragments"], frags_t)
          and np.array_equal(want["tags"].cpu().numpy(), up.tags),
          "agents: the upload differs from StoragePipeline.forward on the "
          "same segments and ids")
    del want
    # the fetch's bound on this host: the same bytes copied into pinned
    # memory, and what allocating that memory costs
    t0 = time.perf_counter()
    pinned = torch.empty(tuple(frags_t.shape), dtype=torch.uint8,
                         pin_memory=cuda)
    pin_alloc_ms = (time.perf_counter() - t0) * 1e3
    pinned_ms = host_ms(lambda: pinned.copy_(frags_t)) if cuda else 0.0
    fetched = frags_t.numel()
    del pinned
    shapes = []

    seen = set()

    def gf_at(mat, x, what):
        mat = np.asarray(mat, np.uint8)
        if (mat.tobytes(), mat.shape, x.shape) in seen:
            return
        seen.add((mat.tobytes(), mat.shape, x.shape))
        tab = rs_kernel.tables(mat, dev)
        held("gf_apply", rs_kernel.gf_apply(tab, x),
             rs_kernel.gf_apply_plain(tab, x))
        shapes.append(f"gf_apply {what} {tuple(x.shape)}")

    gf_at(gf.cauchy_parity_matrix(cfg.k, cfg.m), seg_t, "encode")
    for row, s in lost:
        present, _ = survivors(row, s)
        surv = frags_t[s:s + 1, list(present)]
        gf_at(gf.repair_matrix(cfg.k, cfg.m, present, (row,)), surv,
              f"repair {present}->{row}")
        for p, c in enumerate(regen.repair_coeffs(cfg.k, cfg.m, present,
                                                  (row,))):
            pair = torch.stack([frags_t[s, present[0]],
                                frags_t[s, present[p]]])[None]
            gf_at(np.array([[1, c]]), pair, f"fold {c}")
    id_t = torch.from_numpy(up.ids.reshape(-1, 2).astype(np.int64)).to(dev)
    filler_t = torch.from_numpy(np.stack([np.frombuffer(b, np.uint8)
                                          for b in fstores[0].values()])).to(dev)
    filler_ids = torch.from_numpy(np.stack([
        podr2.fragment_id_from_hash(h) for h in idle[0]]).astype(
            np.int64)).to(dev)
    every = torch.arange(blocks, device=dev)
    for ids, fr in ((id_t, frags_t.view(-1, n)), (filler_ids, filler_t)):
        prf_lm = podr2_kernel.prf_blocks(key.prf_key, ids, None, blocks,
                                         key.limbs, limb_major=True)
        held("prf_blocks", prf_lm, prf.prf_plain(key.prf_key, ids, every,
                                                 key.limbs).transpose(1, 2))
        fb = fr.view(-1, blocks, podr2.BLOCK_BYTES)
        held("podr2_tag", podr2_kernel.podr2_tag(key.weights, prf_lm, fb),
             podr2_kernel.podr2_tag_plain(key.weights, prf_lm, fb))
        shapes.append(f"prf_blocks (limb-major) and podr2_tag "
                      f"{ids.shape[0]} x {blocks}")
        del prf_lm, fb
    idx = podr2.gen_challenge(seed, blocks, device=dev)[0]
    owed_ids = [torch.from_numpy(np.stack([
        podr2.fragment_id_from_hash(h) for h in hs]).astype(np.int64)).to(dev)
        for hs in owed]
    for ids in (owed_ids[0], filler_ids):
        held("prf_blocks", podr2_kernel.prf_blocks(
            key.prf_key, ids, idx, idx.numel(), key.limbs),
            prf.prf_plain(key.prf_key, ids, idx, key.limbs))
        shapes.append(f"prf_blocks {ids.shape[0]} x {idx.numel()}")
    del frags_t, filler_t
    sync()
    engine_shapes = serve_kernel_checks(
        progs, pipe.pipeline, dev, [seg_t],
        [torch.from_numpy(np.array(up.fragments)).to(dev)], owed_ids, idx,
        0, errs, "agents")
    del seg_t
    if cuda:
        torch.cuda.empty_cache()
    split = ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in up.seconds.items())
    split_e = ", ".join(f"{k} {v * 1e3:.3f} ms"
                        for k, v in up_e.seconds.items())
    print(f"phase agents: RS(2,1) upload of {nseg} x "
          f"{cfg.segment_size // MIB} MiB segments ({nseg * rows} fragments "
          f"of {n // MIB} MiB) {upload_s * 1e3:.3f} ms ({split}; one fetch, "
          f"no fragment re-upload), through the engine "
          f"{upload_e_s * 1e3:.3f} ms ({split_e}), byte-equal; {rows} miners x "
          f"{nseg} fragments + {fillers} fillers each (filler generation and "
          f"certification {filler_s * 1e3:.3f} ms); audit round direct "
          f"{(prove_s + verify_s) * 1e3:.3f} ms (9 proofs {prove_s * 1e3:.3f}, "
          f"9 checks {verify_s * 1e3:.3f}), through the engine "
          f"{(prove_e_s + verify_e_s) * 1e3:.3f} ms (proofs "
          f"{prove_e_s * 1e3:.3f}, checks {verify_e_s * 1e3:.3f}; prove "
          f"occupancy {prove_cls['batch_occupancy']}, "
          f"{prove_cls['batches']} batches), every proof and verdict "
          f"byte-equal; verdicts {sorted(str(k) for k, v in verdicts.items() if v)} "
          f"true, {sorted(str(k) for k in false)} false; repairs of "
          f"{len(lost)} fragments (ms each) cold "
          f"{', '.join(f'{t:.3f}' for t in cold)}, warm "
          f"{', '.join(f'{t:.3f}' for t in warm)} ({len(lost)} warm hits), "
          f"by symbols {', '.join(f'{t:.3f}' for t in symbols)}, each "
          f"hashing to its identity; the fetch's bound: a pinned copy_ of the "
          f"same {fetched // MIB} MiB {pinned_ms:.3f} ms "
          f"({fetched / max(pinned_ms, 1e-9) / 1e6:.3f} GB/s), its "
          f"pinned allocation {pin_alloc_ms:.3f} ms; peak {peak / MIB:.1f} "
          f"MiB; phase wall "
          f"{phase_s * 1e3:.3f} ms; kernels byte-exact against their plain "
          f"versions at the phase's shapes: {', '.join(shapes)}; at the "
          f"engine's: {engine_shapes}; launches {launches} {tag}")
    return launches


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def mesh_phase(dev, zero_counts, counts, errs: dict, tag: str, cfg=None,
               nseg: int = 32, corpus_segs: int = 64, corpus_batch: int = 24,
               stream_segs: int = 70, stream_batch: int = 32,
               xor_segs: int = 8, rendezvous: str | None = None) -> dict:
    """The multi-device data plane (``cess_tpu_torch.parallel``) at the
    main path's width: RS(2,1), 16 MiB segments, the chain's key
    ``Podr2Key.generate(7)``. ``sharded_pipeline_step`` over 32 segments
    (512 MiB, 96 fragments of 8 MiB) on ``make_mesh()`` (every card) and
    on the card listed 4 times as (4, 1), (2, 2) and (1, 4): fragments
    and tags byte-equal to ``StoragePipeline.forward``, every verdict
    true, and with one fragment's byte shard that holds a challenged
    block XORed with 0xA5 (the step's ``audit``) exactly that fragment
    false; the RS(4,8) "xor"
    pipeline on 8 segments over (2, 2), byte-equal to the dense forward;
    ``StreamingIngest(pipe, 32, pool=DevicePool([card, card]))`` over 70
    pinned segments, every batch byte-equal to the direct forward;
    ``run_corpus`` in one process over a 1 GiB corpus (64 segments) in
    batches of 24 (the last holds 16), verified == expected on every
    batch; then ``init_multihost`` on ``nccl`` (a world of one at
    ``127.0.0.1:<free port>``) with a (1, 2) ``global_mesh``: a corpus
    batch through it (its verified count summed by NCCL's int64
    ``all_reduce``) and ``psum_mod`` of the step's partials over the
    world group equal to the in-process sum; ``destroy_process_group``.
    Counters are zeroed just before and read just after; then each
    kernel is held against its plain version at the phase's new shapes
    (byte-shard columns, PRF ranges at an offset). A smaller ``cfg`` and
    counts rehearse the phase on the CPU (with a ``file://``
    ``rendezvous`` for ``gloo``). Returns the launches of the phase."""
    import torch
    import torch.distributed as dist
    from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
    from cess_tpu_torch.ops import pfield as pf
    from cess_tpu_torch.ops import gf, podr2, podr2_kernel, prf, rs_kernel
    from cess_tpu_torch.ops import rs_xor
    from cess_tpu_torch.parallel import (CorpusPlan, global_mesh,
                                         init_multihost, make_mesh,
                                         run_corpus, sharded_pipeline_step)
    from cess_tpu_torch.serve import DevicePool, StreamingIngest

    cfg = cfg or PipelineConfig()
    cuda = dev.type == "cuda"
    n, rows, blocks = cfg.fragment_size, cfg.k + cfg.m, cfg.blocks_per_fragment
    key = podr2.Podr2Key.generate(7, device=dev)
    pipe = StoragePipeline(cfg, podr2_key=key, device=dev)
    segs = rand_bytes((nseg, cfg.segment_size), 110, dev)
    ids = torch.arange(nseg * rows, device=dev).reshape(nseg, rows)
    idx, nu = podr2.gen_challenge(b"chip-smoke-mesh-round", blocks,
                                  device=dev)
    # the references, computed before the counters are zeroed
    ref = pipe(segs, ids)
    cfgx = PipelineConfig(k=4, m=8, segment_size=cfg.segment_size,
                          strategy="xor")
    pipex = StoragePipeline(cfgx, podr2_key=key, device=dev)
    dense = StoragePipeline(PipelineConfig(k=4, m=8,
                                           segment_size=cfg.segment_size),
                            podr2_key=key, device=dev)
    segx = rand_bytes((xor_segs, cfg.segment_size), 111, dev)
    idsx = torch.arange(xor_segs * 12, device=dev).reshape(xor_segs, 12)
    idx4, nu4 = podr2.gen_challenge(b"chip-smoke-mesh-xor",
                                    cfgx.blocks_per_fragment, device=dev)
    refx = dense(segx, idsx)
    sseg = rand_bytes((stream_segs, cfg.segment_size), 112, dev)
    srefs = [pipe(sseg[a:a + stream_batch], torch.arange(
        a * rows, min(a + stream_batch, stream_segs) * rows, device=dev))
        for a in range(0, stream_segs, stream_batch)]
    sseg = sseg.cpu()
    pinned = sseg.pin_memory() if cuda else sseg
    cards = make_mesh() if cuda else make_mesh([dev])
    meshes = [("make_mesh()", cards)] + [
        (f"({s}, {b})", make_mesh([dev] * 4, seg=s, byte=b))
        for s, b in ((4, 1), (2, 2), (1, 4))]
    walls = {}
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_phase = time.perf_counter()
    for name, mesh in meshes:
        step = sharded_pipeline_step(pipe, mesh)
        t0 = time.perf_counter()
        frags, tags, ok = step(segs.view(nseg, cfg.k, n), ids, idx, nu)
        verdicts = ok.gather()
        walls[name] = time.perf_counter() - t0
        check(torch.equal(frags.gather(), ref["fragments"])
              and torch.equal(tags.gather(), ref["tags"]),
              f"mesh {name}: fragments or tags differ from the forward")
        check(bool(verdicts.all()), f"mesh {name}: an honest proof failed")
        # segment 0, fragment 1: its byte shard holding a challenged block
        hit = (0, int(idx[0]) // (blocks // mesh.shape["byte"]))
        frags.pieces[hit][1][0, 1] ^= 0xA5
        bad = step.audit(frags, tags, ids, idx, nu).gather()
        want = torch.ones_like(bad)
        want[0, 1] = False
        check(torch.equal(bad, want), f"mesh {name}: the tampered byte "
              "shard did not fail exactly its fragment")
        del frags, tags, ok, bad
    # RS(4,8) under "xor", over (2, 2)
    xor_before = counts()["gf_xor"]
    t0 = time.perf_counter()
    fx, tx, okx = sharded_pipeline_step(
        pipex, make_mesh([dev] * 4, seg=2, byte=2))(
            segx.view(xor_segs, 4, -1), idsx, idx4, nu4)
    okx = okx.gather()
    walls["xor (2, 2)"] = time.perf_counter() - t0
    check(counts()["gf_xor"] > xor_before, "mesh: gf_xor did not launch "
          "in the xor pipeline over (2, 2)")
    check(torch.equal(fx.gather(), refx["fragments"])
          and torch.equal(tx.gather(), refx["tags"]) and bool(okx.all()),
          "mesh: RS(4,8) xor over (2, 2) differs from the dense forward")
    del fx, tx, refx, segx
    # the stream over a two-lane pool on the card
    ing = StreamingIngest(pipe, stream_batch,
                          pool=DevicePool([dev, dev]))
    _sync(dev)
    t0 = time.perf_counter()
    outs = list(ing.run(pinned))
    walls["stream (first run)"] = time.perf_counter() - t0
    # a second run: the ragged tail's pinned buffer is made by the first
    first = dict(ing.stats.raw())
    t0 = time.perf_counter()
    for _ in ing.run(pinned):
        pass
    walls["stream"] = time.perf_counter() - t0
    stages = {k: round(v - first[k], 6) for k, v in ing.stats.raw().items()
              if k.endswith("_s")}
    check(len(outs) == len(srefs) and sum(o["rows"] for o in outs)
          == stream_segs, "mesh: the stream yielded other batches")
    for b, (out, want) in enumerate(zip(outs, srefs)):
        check(torch.equal(out["fragments"].gather(), want["fragments"])
              and torch.equal(out["tags"].gather(), want["tags"]),
              f"mesh: pooled stream batch {b} differs from the forward")
    stream_gib = stream_segs * cfg.segment_size / (1 << 30)
    del outs, pinned, sseg, srefs
    # run_corpus in one process: 1 GiB in batches of 24 (24, 24, 16)
    plan = CorpusPlan(total_bytes=corpus_segs * cfg.segment_size,
                      segment_size=cfg.segment_size,
                      batch_segments=corpus_batch)

    def local_batch(b, want):
        return rand_bytes((want, cfg.k, n), 200 + b, dev)

    t0 = time.perf_counter()
    corpus = list(run_corpus(pipe, global_mesh(seg=2, byte=2,
                                               devices=[dev] * 4),
                             plan, local_batch))
    walls["corpus"] = time.perf_counter() - t0
    want_segs = [min(corpus_batch, corpus_segs - b * corpus_batch)
                 for b in range(plan.num_batches)]
    check([r["segments"] for r in corpus] == want_segs
          and all(r["verified"] == r["expected"] == r["segments"] * rows
                  for r in corpus), f"mesh: corpus batches {corpus}")
    # a process group of one: nccl on the card
    url = rendezvous or f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    check(init_multihost(url, 1, 0) == 1, "mesh: init_multihost")
    backend = dist.get_backend()
    try:
        gmesh = global_mesh(seg=1, byte=2, devices=[dev, dev])
        small = CorpusPlan(total_bytes=2 * cfg.segment_size,
                           segment_size=cfg.segment_size, batch_segments=2)
        (one,) = run_corpus(pipe, gmesh, small, local_batch)
        check(one["verified"] == one["expected"] == 2 * rows,
              f"mesh: the corpus batch over the process group: {one}")
        parts = [torch.randint(0, pf.P, (nseg * rows, cfg.sectors + 2),
                               device=dev, dtype=torch.int64)
                 for _ in range(2)]
        check(torch.equal(pf.psum_mod(parts, dist.group.WORLD),
                          pf.psum_mod(parts)),
              "mesh: psum_mod over the process group differs")
    finally:
        dist.destroy_process_group()
    walls["process group"] = time.perf_counter() - t0
    _sync(dev)
    phase_s = time.perf_counter() - t_phase
    launches = counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag", "gf_xor")),
          f"mesh: a kernel was not launched: {launches}")

    # each kernel at the phase's new shapes, against its plain version
    shapes = []

    def held(name, got, plain):
        e = max_err(got, plain)
        errs[name] = max(errs[name], e)
        check(e == 0, f"mesh: {name} at {tuple(got.shape)} differs from "
              "its plain version")
        shapes.append(f"{name} {tuple(got.shape)}")

    tab = rs_kernel.tables(gf.cauchy_parity_matrix(cfg.k, cfg.m), dev)
    for byte in (2, 4):
        cols = n // byte
        col = segs.view(nseg, cfg.k, n)[:8, :, cols * (byte - 1):].contiguous()
        held("gf_apply", rs_kernel.gf_apply(tab, col),
             rs_kernel.gf_apply_plain(tab, col))
        bl = blocks // byte
        at = torch.arange(bl * (byte - 1), blocks, device=dev)
        pairs = podr2.fragment_ids(ids[:8].reshape(-1), dev)
        prf_lm = podr2_kernel.prf_blocks(key.prf_key, pairs, at, bl,
                                         key.limbs, limb_major=True)
        held("prf_blocks", prf_lm, prf.prf_plain(
            key.prf_key, pairs, at, key.limbs).transpose(1, 2))
        frag = ref["fragments"][:8].reshape(8 * rows, n)[:, cols * (byte - 1):]
        frag = frag.contiguous().view(8 * rows, bl, podr2.BLOCK_BYTES)
        held("podr2_tag", podr2_kernel.podr2_tag(key.weights, prf_lm, frag),
             podr2_kernel.podr2_tag_plain(key.weights, prf_lm, frag))
    schedx, opsx = pipex.parity_sched, pipex.parity_ops
    colx = rand_bytes((4, 4, cfgx.fragment_size // 2), 113, dev)
    held("gf_xor", rs_xor.gf_xor(schedx, opsx, colx),
         rs_xor.xor_apply_plain(schedx, colx))
    del ref, segs
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
    print(f"phase mesh: RS(2,1) {nseg} x 16 MiB segments, the chain's key; "
          f"sharded step over make_mesh() ({cards.devices.size} card(s) "
          f"present, torch.cuda.device_count() "
          f"{torch.cuda.device_count() if cuda else 0}) and the card listed 4 "
          f"times as (4, 1), (2, 2), (1, 4): fragments and tags byte-equal "
          f"to the forward, verdicts true, the tampered byte shard false "
          f"alone; walls "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in walls.items())
          + f"; RS(4,8) xor over (2, 2) byte-equal to dense; pooled stream "
          f"{stream_segs} pinned segments {stream_gib / walls['stream']:.3f} "
          f"GiB/s from host bytes (2 lanes on one card; second run's stages "
          f"{stages}); corpus "
          f"{[r['segments'] for r in corpus]} verified; process group "
          f"{backend} world of 1 reduced (int64 all_reduce); kernels "
          f"byte-exact at the phase's shapes: {', '.join(shapes)}; phase "
          f"wall {phase_s * 1e3:.3f} ms; peak {peak / MIB:.1f} MiB; "
          f"launches {launches} {tag}")
    return launches


def pool_phase(dev, zero_counts, counts, errs: dict, tag: str, cfg=None,
               per: int = 4, threads: int = 8, drill_batches: int = 12
               ) -> dict:
    """The multi-device serving plane (``serve/pool.py``) at the main
    path's width: ``make_engine(2, 1, podr2_key=Podr2Key.generate(7),
    resilience=ResilienceConfig(), pool=DevicePool([card, card]))``.
    Encodes of 8 requests of 4 segments (512 MiB, numpy, staggered by 5
    ms so that batches overlap), tags of their 96 fragments (8 requests
    of 12, CUDA tensors), one round's 8 aggregated proofs and their
    checks (one tampered), and after ``warm_repair`` of RS(2,1)'s three
    single-loss patterns 4 reconstructs submitted together: every result
    byte-equal to the direct path, both lanes serving batches and warm
    hits landing on each lane's codec. Then the chaos drill of
    ``tests/test_pool.py`` at this width, twice: 12 encodes of [3, 2, 8
    MiB] CUDA tensors under a plan raising at ``engine.dispatch.d0``:
    lane 0's breaker trips, lane 1 absorbs every batch through
    ``requeue``, nothing degrades to the CPU, a probe reaches lane 0,
    and the two runs give equal firings and placement logs. Counters are
    zeroed just before and read just after; then each kernel the engine
    ran is held against its plain version at every shape in its program
    cache (both lanes share the card: each shape once), and the
    staggered encodes are timed on a fresh engine of two lanes and of
    one, in turns. Returns the launches of the phase."""
    import types

    import numpy as np
    import torch
    from cess_tpu_torch.models.pipeline import PipelineConfig
    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.rs import TorchCodec
    from cess_tpu_torch.resilience import FaultPlan, ResilienceConfig, faults
    from cess_tpu_torch.serve import DevicePool, make_engine

    cfg = cfg or PipelineConfig()
    cuda = dev.type == "cuda"
    n, rows, blocks = cfg.fragment_size, cfg.k + cfg.m, cfg.blocks_per_fragment
    key = podr2.Podr2Key.generate(7, device=dev)
    codec = TorchCodec(cfg.k, cfg.m, device=dev)
    seed = b"chip-smoke-pool-round"
    idx, nu = podr2.gen_challenge(seed, blocks, device=dev)
    data = [rand_bytes((per, cfg.k, n), 120 + i, dev) for i in range(threads)]
    ids = [torch.stack([torch.arange(i * per * rows, (i + 1) * per * rows,
                                     device=dev),
                        torch.full((per * rows,), 9, device=dev)], dim=1)
           for i in range(threads)]
    coeffs = [podr2.aggregate_coeffs(seed, x, device=dev) for x in ids]
    host = [d.cpu().numpy() for d in data]
    patterns = [((1, 2), (0,)), ((0, 2), (1,)), ((0, 1), (2,))]
    drill_in = [rand_bytes((3, cfg.k, n), 300 + i, dev)
                for i in range(drill_batches)]


    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_phase = time.perf_counter()
    eng = make_engine(cfg.k, cfg.m, rs_backend=dev.type, podr2_key=key,
                      audit_backend=dev.type, resilience=ResilienceConfig(),
                      pool=DevicePool([dev, dev]))
    walls = {}
    try:
        t0 = time.perf_counter()
        futs = []
        for x in host:
            futs.append(eng.submit_encode(x))
            time.sleep(0.005)
        encs = [f.result(600) for f in futs]
        walls["encode"] = time.perf_counter() - t0
        frs = [torch.as_tensor(e).to(dev).reshape(per * rows, n)
               for e in encs]
        t0 = time.perf_counter()
        futs = [eng.submit_tag(ids[i], frs[i]) for i in range(threads)]
        tags = [f.result(600) for f in futs]
        walls["tag"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        futs = [eng.submit_prove_aggregate(frs[i], tags[i], idx, nu,
                                           coeffs[i])
                for i in range(threads)]
        proofs = [f.result(600) for f in futs]
        futs = [eng.submit_verify_aggregate(ids[i], blocks, idx, nu,
                                            coeffs[i], *proofs[i])
                for i in range(threads)]
        mu0, sigma0 = proofs[0]
        futs.append(eng.submit_verify_aggregate(
            ids[0], blocks, idx, nu, coeffs[0], mu0,
            (sigma0.to(torch.int64) + 1) % podr2.pf.P))
        verdicts = [bool(f.result(600)) for f in futs]
        walls["round"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # a pattern's two requests may coalesce: warm both buckets
        eng.warm_repair(patterns, n, buckets=(per, 2 * per))
        walls["warm_repair"] = time.perf_counter() - t0
        reps = [(i, patterns[i % 3]) for i in range(4)]
        survivors = [np.ascontiguousarray(encs[i][:, list(p)])
                     for i, (p, _) in reps]
        t0 = time.perf_counter()
        # submitted together: their batches are placed while earlier
        # ones are in flight, so they spread over the lanes
        futs = [eng.submit_reconstruct(s, p, mi)
                for s, (_, (p, mi)) in zip(survivors, reps)]
        rebuilt = [f.result(600) for f in futs]
        walls["reconstruct"] = time.perf_counter() - t0
        check(eng.flush(600), "pool: the engine did not drain")
        snap = eng.stats_snapshot()
        psnap = eng.pool.snapshot()
        # the program cache's shapes; a lane's key ends in ("device", i):
        # both lanes run on this card, so each shape is held once
        progs = sorted({k[:-1] if isinstance(k[-1], tuple)
                        and k[-1][:1] == ("device",) else k
                        for k in eng.programs.keys()}, key=repr)
        hits = [lane.codec.warm_hits for lane in eng.pool.lanes]
        log = eng.pool.placement_log()
    finally:
        eng.close()

    # the chaos drill, twice
    def drill():
        res = ResilienceConfig()
        e = make_engine(cfg.k, cfg.m, rs_backend=dev.type, resilience=res,
                        pool=DevicePool([dev, dev]))
        plan = FaultPlan.seeded(b"chip-pool-drill",
                                {"engine.dispatch.d0": (1.0, "raise")},
                                horizon=64)
        outs = []
        try:
            with faults.armed(plan):
                for i in range(drill_batches):
                    outs.append(e.encode(drill_in[i], timeout=600))
                    check(e.flush(600), "pool: the drill did not drain")
            return (outs, e.pool.snapshot(), res.stats.snapshot(),
                    e.pool.placement_log(), plan.fired_log())
        finally:
            e.close()

    t0 = time.perf_counter()
    runs = [drill(), drill()]
    walls["drill x2"] = time.perf_counter() - t0
    _sync(dev)
    phase_s = time.perf_counter() - t_phase
    launches = counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")),
          f"pool: a kernel was not launched: {launches}")
    # every result against the direct path, after the counters are read
    for i in range(threads):
        enc = codec.encode(data[i])
        check(np.array_equal(encs[i], enc.cpu().numpy()),
              f"pool: encode {i} differs")
        t = podr2.tag_fragments(key, ids[i], frs[i])
        check(torch.equal(tags[i], t), f"pool: tags {i} differ")
        mu, sigma = podr2.prove_aggregate(frs[i], t, idx, nu, coeffs[i])
        check(torch.equal(proofs[i][0], mu) and torch.equal(proofs[i][1],
                                                            sigma),
              f"pool: proof {i} differs")
    check(verdicts == [True] * threads + [False],
          f"pool: verdicts {verdicts}")
    for (i, (p, mi)), out in zip(reps, rebuilt):
        want = codec.encode(data[i])[:, list(mi)].cpu().numpy()
        check(np.array_equal(out, want), f"pool: reconstruct {i} differs")
    served = [ln["batches"] for ln in psnap["lanes"]]
    check(all(served), f"pool: a lane served no batch: {served}")
    check(all(hits), f"pool: warm hits by lane {hits}: not on each lane")
    for outs, dsnap, rsnap, dlog, fired in runs:
        for i, out in enumerate(outs):
            check(torch.equal(out, codec.encode(drill_in[i])),
                  f"pool: drill encode {i} differs")
        br = rsnap["breakers"]
        check(br["codec.d0"]["state"] == "open" and br["codec.d0"]["trips"]
              == 1 and br["codec.d1"]["trips"] == 0
              and br["codec"]["trips"] == 0,
              f"pool: drill breakers {br}")
        lanes = dsnap["lanes"]
        check(lanes[0]["batches"] == 0 and lanes[1]["batches"] == len(outs)
              and lanes[1]["requeues"] > 0, f"pool: drill lanes {lanes}")
        check(rsnap["degraded_batches"] == {} and not rsnap[
            "fallback_batches"], "pool: the drill degraded to the CPU")
        check(fired and all(s == "engine.dispatch.d0" for s, _, _ in fired),
              f"pool: drill firings {fired}")
        check((0, "probe") in [(r[4], r[5]) for r in dlog],
              "pool: no probe reached lane 0")
    check(runs[0][4] == runs[1][4] and runs[0][3] == runs[1][3],
          "pool: the two drills' firings or placements differ")

    # two lanes on one card against one: the staggered encodes on a
    # fresh engine of each width, in turns (two, one, one, two)
    def encode_wall(width):
        e = make_engine(cfg.k, cfg.m, rs_backend=dev.type,
                        pool=DevicePool([dev] * width))
        try:
            t0 = time.perf_counter()
            fs = []
            for x in host:
                fs.append(e.submit_encode(x))
                time.sleep(0.005)
            for f in fs:
                f.result(600)
            return time.perf_counter() - t0
        finally:
            e.close()

    turns = [encode_wall(w) for w in (2, 1, 1, 2)]
    two_s, one_s = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    held = serve_kernel_checks(
        progs, types.SimpleNamespace(config=cfg, podr2_key=key), dev, data,
        [codec.encode(d) for d in data], ids, idx, 4, errs, phase="pool")
    print(f"phase pool: RS(2,1) engine over DevicePool([card, card]), the "
          f"chain's key; {threads * per} x 16 MiB segments encoded (numpy, "
          f"staggered), {threads * per * rows} fragments tagged, {threads} "
          f"proofs verified (tampered false), 4 warm reconstructs; all "
          f"byte-equal to the direct path; batches by lane {served}, warm "
          f"hits by lane {hits}, {len(log)} placements "
          f"({sum(r[5] == 'least-loaded' for r in log)} least-loaded); "
          f"{class_line(snap)}; chaos drill twice: lane 0 tripped, lane 1 "
          f"served {runs[0][1]['lanes'][1]['batches']} batches "
          f"({runs[0][1]['lanes'][1]['requeues']} by requeue), no CPU "
          f"degradation, a probe reached lane 0, firings "
          f"{len(runs[0][4])} equal in both runs, placement logs equal; "
          f"kernels at the engine's shapes byte-exact against their plain "
          f"versions: {held}; the staggered encodes in turns (two lanes, "
          f"one, one, two): "
          + "/".join(f"{t * 1e3:.3f}" for t in turns)
          + f" ms, two lanes at {one_s / two_s:.3f}x one lane's rate; walls "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in walls.items())
          + f"; phase wall {phase_s * 1e3:.3f} ms; peak {peak / MIB:.1f} "
          f"MiB; launches {launches} {tag}")
    return launches


# the SLO drill (phase slo): verify's p99 objective, the seeded dispatch
# delay of its first half (5x the objective); the perf drill's delay, its
# windows and its guard (a faulted window of 512 MiB runs at most 5
# GiB/s, a clean one at the baseline's rate of a few hundred: a guard of
# a quarter keeps both verdicts decisive through a slow encode or two)
SLO_OBJECTIVE_S = 0.05
SLO_DELAY_S = 0.25
PERF_DELAY_S = 0.1
PERF_WINDOW = 2
PERF_GUARD = 0.25
PERF_METRIC = "rs_4p8_encode_GiBps_per_chip"


def slo_drill(cfg, key, dev, fix: dict, counts) -> tuple:
    """One run of the SLO drill of ``tests/test_slo.py`` on an engine with
    every plane: resilience, a tracer attached to a FlightRecorder with an
    IncidentReporter, a SloBoard (verify: p99 ``SLO_OBJECTIVE_S``), an
    AdaptiveBatchPolicy, ``AdmissionController(protect=("verify",),
    shed=("encode",))`` and a ProfilePlane. Phase 1, under a seeded
    ``engine.dispatch`` delay of ``SLO_DELAY_S``: a numpy encode of one
    segment (tenant bulk), 4 verifications of the 96 fragments' honest
    aggregated proof (tenant auditor, CUDA tensors; the 4th turns verify
    burning), 3 encodes (shed), a numpy repair (served on the CPU
    reference through the held codec breaker) and a CUDA-tensor repair
    (refused, no kernel launched). Phase 2, fault-free: 20 rounds of an
    encode (shed until verify is back at ok) and a verification. Returns
    the run's record and the engine, still open."""
    from cess_tpu_torch.obs import IncidentReporter, flight, trace
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.obs.slo import SloBoard, SloTarget
    from cess_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                           ResilienceConfig, faults)
    from cess_tpu_torch.serve import (AdaptiveBatchPolicy,
                                      AdmissionController, AdmissionPolicy,
                                      EngineShed, EngineUnavailable,
                                      make_engine)

    board = SloBoard((SloTarget("verify", SLO_OBJECTIVE_S, 0.01),),
                     fast_window=4, slow_window=16, eval_every=4)
    adaptive = AdaptiveBatchPolicy(board=board)
    admission = AdmissionController(board, adaptive, protect=("verify",),
                                    shed=("encode",))
    tracer = trace.Tracer()
    rec = flight.FlightRecorder(b"chip-slo")
    tracer.attach_flight(rec)
    eng = make_engine(cfg.k, cfg.m, rs_backend=dev.type, podr2_key=key,
                      audit_backend=dev.type,
                      policy=AdmissionPolicy(max_delay=0.002),
                      resilience=ResilienceConfig(), tracer=tracer, slo=board,
                      adaptive=adaptive, admission=admission,
                      profile=ProfilePlane())
    reporter = IncidentReporter(rec, engine=eng)
    plan = FaultPlan.seeded(b"chip-slo", {"engine.dispatch": (
        1.0, FaultSpec("delay", delay_s=SLO_DELAY_S))}, horizon=64)
    blocks = cfg.blocks_per_fragment
    out = {"sheds": 0, "verdicts": [], "encoded": [], "lat2": []}

    def encode():
        try:
            out["encoded"].append(eng.encode(fix["bulk"], timeout=600,
                                             tenant="bulk"))
        except EngineShed:
            out["sheds"] += 1

    def verify():
        t0 = time.perf_counter()
        out["verdicts"].append(eng.verify_aggregate(
            fix["ids"], blocks, fix["idx"], fix["nu"], fix["r"], fix["mu"],
            fix["sigma"], timeout=600, tenant="auditor"))
        return time.perf_counter() - t0

    try:
        with flight.armed(rec):
            with faults.armed(plan):
                encode()
                for _ in range(4):
                    verify()
                for _ in range(3):
                    encode()
                out["held"] = (board.state("verify"),
                               eng.monitors["codec"].state)
                _sync(dev)
                before = counts()
                out["repaired"] = eng.reconstruct(
                    fix["surv_host"], (1, 2), (0,), timeout=600,
                    tenant="repairer")
                try:
                    eng.reconstruct(fix["surv_card"], (1, 2), (0,),
                                    timeout=600, tenant="repairer")
                    out["refused"] = False
                except EngineUnavailable:
                    out["refused"] = True
                _sync(dev)
                out["quiet"] = counts() == before
            launched = counts()["gf_apply"]
            for _ in range(20):
                encode()
                out["lat2"].append(verify())
            _sync(dev)
            out["relaunched"] = counts()["gf_apply"] - launched
    except BaseException:
        eng.close()
        raise
    out.update(log=board.transition_log(), fired=plan.fired_log(),
               snap=eng.stats_snapshot(), witness=reporter.witness(),
               bundles=[(b["trigger"], b["key"]) for b in reporter.bundles()],
               admission=admission.snapshot(), pins=rec.witness())
    return out, eng


def engine_gibps(cfg, dev, cls: str, call, runs: int = 8) -> tuple:
    """A class's GiB/s through the engine on this device: ``call(eng)``
    once to build its program, then ``runs`` times on an engine with an
    unanchored ProfilePlane of window ``runs``; returns the window's GiB/s
    (a watchdog's baseline) and the engine's program keys."""
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.serve import make_engine

    plane = ProfilePlane(window=runs)
    eng = make_engine(cfg.k, cfg.m, rs_backend=dev.type, profile=plane)
    try:
        for _ in range(runs + 1):
            call(eng)
        return plane.ops.windowed_gibps()[cls], eng.programs.keys()
    finally:
        eng.close()


def perf_drill(cfg, dev, data, baseline, seed: bytes) -> dict:
    """The perf drill of ``tests/test_profile.py`` at the main path's
    width: an engine with a ProfilePlane anchored on ``baseline``
    (window ``PERF_WINDOW``, guard ``PERF_GUARD``), CUDA-tensor encodes of ``data`` (32
    segments), the first two windows under a seeded ``engine.dispatch``
    delay of ``PERF_DELAY_S``, the next two fault-free, with a flight
    recorder and a profile-aware IncidentReporter armed."""
    from cess_tpu_torch.obs import IncidentReporter, flight
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.resilience import FaultPlan, FaultSpec, faults
    from cess_tpu_torch.serve import make_engine

    plane = ProfilePlane(baseline=baseline, guard=PERF_GUARD,
                         window=PERF_WINDOW)
    eng = make_engine(cfg.k, cfg.m, rs_backend=dev.type, profile=plane)
    rec = flight.FlightRecorder(seed)
    reporter = IncidentReporter(rec, engine=eng, profile=plane)
    plan = FaultPlan.seeded(seed, {"engine.dispatch": (
        1.0, FaultSpec("delay", delay_s=PERF_DELAY_S))}, horizon=16)
    outs = []
    try:
        with flight.armed(rec):
            with faults.armed(plan):
                for _ in range(2 * PERF_WINDOW):
                    outs.append(eng.encode(data, timeout=600))
            for _ in range(2 * PERF_WINDOW):
                outs.append(eng.encode(data, timeout=600))
        progs = eng.programs.keys()
    finally:
        eng.close()
    return {"plane": plane, "reporter": reporter, "fired": plan.fired_log(),
            "first": outs[0], "last": outs[-1], "progs": progs}


def burst(eng, cfg, load: dict) -> dict:
    """Phase serve's burst without its stages: 8 threads, each an encode
    of 4 segments (even threads numpy, odd CUDA tensors), a tag of its 12
    fragments, the round's aggregated proof and its verification. Returns
    the engine's stats snapshot; every verdict must be true."""
    import threading

    n = cfg.fragment_size
    verdicts, errors = [], []

    def worker(i):
        try:
            enc = eng.encode(load["payload"][i], timeout=600)
            frs = enc.reshape(-1, n)
            tags = eng.tag_fragments(load["ids"][i], frs, timeout=600)
            mu, sigma = eng.prove_aggregate(frs, tags, load["idx"],
                                            load["nu"], load["r"][i],
                                            timeout=600)
            verdicts.append(eng.verify_aggregate(
                load["ids"][i], cfg.blocks_per_fragment, load["idx"],
                load["nu"], load["r"][i], mu, sigma, timeout=600))
        except BaseException as e:      # reported by the caller
            errors.append((i, e))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(load["payload"]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    check(not errors, f"slo: a burst submitter failed: {errors[:1]}")
    check(verdicts == [True] * len(threads), f"slo: burst verdicts {verdicts}")
    return eng.stats_snapshot()


def slo_phase(dev, zero_counts, counts, errs: dict, tag: str, cfg=None,
              nseg: int = 32, stream_segs: int = 70, stream_batch: int = 32
              ) -> dict:
    """The engine's control planes (``obs/slo.py``, ``serve/adaptive.py``,
    ``obs/profile.py``, ``obs/incident.py``) at the main path's width:
    RS(2,1), 16 MiB segments, the chain's key ``Podr2Key.generate(7)``.

    (a) ``slo_drill`` twice: verify walks ok -> burning -> warn -> ok,
    encodes are shed while it burns and then admitted (``gf_apply``
    launches again), the held codec breaker serves the numpy repair on
    the CPU reference byte-equal and refuses the CUDA repair with no
    launch; the transition logs, shed counts and reporter witnesses of
    the two runs are equal, and the reporter holds a ``slo-burning`` and
    a ``breaker-hold`` bundle. (b) An unanchored plane measures the
    engine's encode GiB/s over fault-free windows of CUDA-tensor encodes
    of 32 segments: the baseline of ``rs_4p8_encode_GiBps_per_chip`` on
    this card; then ``perf_drill`` twice, anchored on it: the watchdog
    goes regressed at the first closed window and back to ok, one
    ``perf-regression`` bundle embeds both ledgers, and the two runs'
    ``witness()`` bytes are equal. (c) ``StreamingIngest(pipe,
    batch=32, engine=eng)`` over 70 pinned segments with the drill's
    engine, byte-equal to the forward: its ragged tail's 26 pad rows land
    in the engine's pad ledger, and the profile's stream GiB/s is no
    higher than the stream's own rate from host bytes. (d) The burst of
    ``burst`` on fresh engines, disarmed and fully armed (resilience,
    tracer, flight recorder and reporter, board with loose targets,
    tuner, admission, profile), in turns disarmed, armed, armed,
    disarmed: the per-class p50 of each. Counters are zeroed after the
    inputs are made and read at the end; ``gf_apply``, ``prf_blocks`` and
    ``podr2_tag`` must launch, and each is then held against its plain
    version at every shape in the engines' program caches. A smaller
    ``cfg`` and ``nseg`` rehearse the phase on the CPU (the checks that
    count launches or pin memory need the card). Returns the launches."""
    import contextlib
    import types

    import numpy as np
    import torch
    from cess_tpu_torch.models.pipeline import PipelineConfig, StoragePipeline
    from cess_tpu_torch.obs import IncidentReporter, flight, trace
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.obs.slo import SloBoard, SloTarget
    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.rs import TorchCodec
    from cess_tpu_torch.resilience import ResilienceConfig
    from cess_tpu_torch.serve import (AdaptiveBatchPolicy, StreamingIngest,
                                      make_engine)

    cfg = cfg or PipelineConfig()
    cuda = dev.type == "cuda"
    n, rows, blocks = cfg.fragment_size, cfg.k + cfg.m, cfg.blocks_per_fragment
    key = podr2.Podr2Key.generate(7, device=dev)
    codec = TorchCodec(cfg.k, cfg.m, device=dev)
    seed = b"chip-smoke-slo-round"
    idx, nu = podr2.gen_challenge(seed, blocks, device=dev)
    # the drill's inputs: 32 segments' 96 fragments, their tags and one
    # honest aggregated proof; one segment for the bulk encodes
    data = rand_bytes((nseg, cfg.k, n), 140, dev)
    enc = codec.encode(data)
    frs = enc.reshape(-1, n)
    ids = torch.stack([torch.arange(frs.shape[0], device=dev),
                       torch.full((frs.shape[0],), 13, device=dev)], dim=1)
    r = podr2.aggregate_coeffs(seed, ids, device=dev)
    mu, sigma = podr2.prove_aggregate(frs, podr2.tag_fragments(key, ids, frs),
                                      idx, nu, r)
    fix = {"ids": ids, "idx": idx, "nu": nu, "r": r, "mu": mu,
           "sigma": sigma, "bulk": data[:1].cpu().numpy(),
           "bulk_enc": enc[:1].cpu().numpy(),
           "surv_host": enc[:1, 1:].cpu().numpy(), "surv_card": enc[:1, 1:]}
    # the burst's inputs, as phase serve's
    per = 4
    bdata = [rand_bytes((per, cfg.k, n), 150 + i, dev) for i in range(8)]
    bids = [torch.stack([torch.arange(i * per * rows, (i + 1) * per * rows,
                                      device=dev),
                         torch.full((per * rows,), 17, device=dev)], dim=1)
            for i in range(8)]
    load = {"idx": idx, "nu": nu,
            "payload": [d if i % 2 else d.cpu().numpy()
                        for i, d in enumerate(bdata)],
            "ids": bids, "r": [podr2.aggregate_coeffs(seed, x, device=dev)
                               for x in bids]}
    _sync(dev)
    zero_counts()
    t_phase = time.perf_counter()
    progs = []

    # (a) the SLO drill, twice
    first, eng = slo_drill(cfg, key, dev, fix, counts)
    progs += eng.programs.keys()
    eng.close()
    second, eng = slo_drill(cfg, key, dev, fix, counts)
    want_log = (("verify", "ok", "burning", 4),
                ("verify", "burning", "warn", 8),
                ("verify", "warn", "ok", 20))
    try:
        for run in (first, second):
            check(run["log"] == want_log, f"slo: transitions {run['log']}")
            check(run["held"] == ("burning", "held"),
                  f"slo: under the burn {run['held']}")
            check(run["sheds"] == 19 and run["snap"]["classes"]["encode"][
                "shed"] == 19, f"slo: {run['sheds']} sheds, not 19")
            check(len(run["encoded"]) == 5 and all(
                np.array_equal(e, fix["bulk_enc"]) for e in run["encoded"]),
                "slo: an admitted encode differs from the direct path")
            check(np.array_equal(run["repaired"], fix["bulk_enc"][:, :1]),
                  "slo: the numpy repair under the hold differs")
            check((run["refused"] and run["quiet"]) or not cuda,
                  "slo: the CUDA repair under the hold was not refused, or "
                  "a kernel launched")
            check(run["relaunched"] > 0 or not cuda,
                  "slo: gf_apply did not launch after the release")
            check(all(v is True for v in run["verdicts"])
                  and len(run["verdicts"]) == 24, "slo: a verdict is false")
            check({("slo-burning", "verify"),
                   ("breaker-hold", "codec:slo:verify")}
                  <= set(run["bundles"]), f"slo: bundles {run['bundles']}")
            res = run["snap"]["resilience"]
            # on the CPU (a rehearsal) the second repair is a host one
            check(res["degraded_batches"].get("repair") == (1 if cuda else 2)
                  and res["breakers"]["codec"]["holds"] == 1
                  and res["breakers"]["codec"]["state"] == "closed",
                  f"slo: resilience {res['degraded_batches']}")
        for k in ("log", "sheds", "witness", "bundles", "admission", "pins"):
            check(first[k] == second[k], f"slo: the two drills' {k} differ")

        # (c) the stream's pad bill, on the drill's engine
        pipe = StoragePipeline(cfg, podr2_key=key, device=dev)
        seg_dev = rand_bytes((stream_segs, cfg.segment_size), 160, dev)
        src = seg_dev.cpu()
        if cuda:
            src = src.pin_memory()
        ing = StreamingIngest(pipe, stream_batch, engine=eng, tenant="gateway")
        got = ing.ingest(src)
        want = pipe(seg_dev, torch.arange(stream_segs * rows, device=dev))
        check(torch.equal(got["fragments"], want["fragments"])
              and torch.equal(got["tags"], want["tags"]),
              "slo: the stream differs from the direct forward")
        plane = eng.profile
        pads = plane.pads.total()
        tail = -stream_segs % stream_batch
        acct = [a for a in plane.snapshot()["ops"]["accounts"]
                if a["cls"] == "stream"][0]
        st = ing.stats
        prof_gibs = acct["bytes"] / (1 << 30) / (acct["h2d_s"]
                                                 + acct["dispatch_s"])
        host_gibs = st.bytes_in / (1 << 30) / st.wall_s
        check(pads["sources"].get("stream") == tail
              and pads["sources"].get("engine", 0) > 0,
              f"slo: pad bill {pads}")
        # (on the CPU a batch's time is its staging and program alone,
        # the run's wall holds more: the check is the card's)
        check(prof_gibs <= host_gibs or not cuda,
              f"slo: the profile's stream {prof_gibs:.3f} GiB/s exceeds the "
              f"stream's own {host_gibs:.3f} GiB/s from host bytes")
        slo_snap = eng.stats_snapshot()
        progs += eng.programs.keys()
        del got, want, src, seg_dev
    finally:
        eng.close()

    # (b) the perf drill: a baseline measured on this card, then anchored
    base, keys = engine_gibps(cfg, dev, "encode",
                              lambda e: e.encode(data, timeout=600))
    progs += keys
    check(base is not None and base > 0, f"slo: baseline {base}")
    baseline = {PERF_METRIC: base}
    drills = [perf_drill(cfg, dev, data, baseline, b"chip-perf")
              for _ in range(2)]
    want_wd = ((PERF_WINDOW, PERF_METRIC, "ok", "regressed", 1),
               (3 * PERF_WINDOW, PERF_METRIC, "regressed", "ok", 3))
    for d in drills:
        wd = d["plane"].watchdog
        check(wd.transition_log() == want_wd,
              f"slo: watchdog transitions {wd.transition_log()}")
        bundles = d["reporter"].bundles()
        check([(b["trigger"], b["key"]) for b in bundles]
              == [("perf-regression", PERF_METRIC)]
              and {"pads", "compiles"} <= set(bundles[0]["snapshots"][
                  "profile"]), "slo: not one perf-regression bundle with "
              "both ledgers")
        check(torch.equal(d["first"], enc) and torch.equal(d["last"], enc),
              "slo: a perf drill encode differs")
        progs += d["progs"]
    check(drills[0]["plane"].witness() == drills[1]["plane"].witness()
          and drills[0]["fired"] == drills[1]["fired"],
          "slo: the perf drill's replay differs")
    last_gibs = drills[0]["plane"].watchdog.snapshot()["last_GiBps"][
        PERF_METRIC]
    # a faulted window's GiB/s is at most its bytes over its delays
    faulted_gibs = data.numel() / (1 << 30) / PERF_DELAY_S

    # (d) what the planes cost: the burst, disarmed and armed in turns
    def armed_engine():
        board = SloBoard(tuple(SloTarget(c, 60.0) for c in
                               ("encode", "tag", "prove", "verify")))
        tracer = trace.Tracer()
        rec = flight.FlightRecorder(b"chip-slo-burst")
        tracer.attach_flight(rec)
        e = make_engine(cfg.k, cfg.m, rs_backend=dev.type, podr2_key=key,
                        audit_backend=dev.type,
                        resilience=ResilienceConfig(), tracer=tracer,
                        slo=board, adaptive=AdaptiveBatchPolicy(board=board),
                        profile=ProfilePlane())
        IncidentReporter(rec, engine=e)
        return e, rec

    p50 = {"disarmed": [], "armed": []}
    walls = {"disarmed": [], "armed": []}
    for kind in ("disarmed", "armed", "armed", "disarmed"):
        rec = None
        if kind == "armed":
            e, rec = armed_engine()
        else:
            e = make_engine(cfg.k, cfg.m, rs_backend=dev.type, podr2_key=key,
                            audit_backend=dev.type)
        try:
            t0 = time.perf_counter()
            with (flight.armed(rec) if rec is not None
                  else contextlib.nullcontext()):
                snap = burst(e, cfg, load)
            walls[kind].append(time.perf_counter() - t0)
            progs += e.programs.keys()
        finally:
            e.close()
        check(all(st["shed"] == 0 for st in snap["classes"].values()),
              "slo: the armed burst shed a request")
        p50[kind].append({c: st["latency_p50"] for c, st in
                          snap["classes"].items() if st["batches"]})
    _sync(dev)
    phase_s = time.perf_counter() - t_phase
    launches = counts()
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")) or not cuda,
          f"slo: a kernel was not launched: {launches}")
    progs = list(dict.fromkeys(progs))
    held = serve_kernel_checks(
        progs, types.SimpleNamespace(config=cfg, podr2_key=key), dev, bdata,
        [codec.encode(d) for d in bdata], [ids] + bids, idx, 1, errs,
        phase="slo")

    def turns(kind):
        return ", ".join(
            f"{c} {'/'.join(f'{t[c] * 1e3:.3f}' for t in p50[kind])}"
            for c in p50[kind][0])

    snap_t = slo_snap["slo"]["targets"]["verify"]
    print(f"phase slo: RS(2,1) engine with resilience, a tracer, a flight "
          f"recorder and incident reporter, an SLO board (verify p99 "
          f"{SLO_OBJECTIVE_S * 1e3:.0f} ms), the adaptive tuner, admission "
          f"(protect verify, shed encode) and a profile plane, the chain's "
          f"key; drill twice under a seeded {SLO_DELAY_S * 1e3:.0f} ms "
          f"engine.dispatch delay then fault-free: verify transitions "
          f"{[(a, b, c) for _, a, b, c in first['log']]} equal in both "
          f"runs, {first['sheds']} encodes shed (EngineShed) then admitted "
          f"with gf_apply launching again ({first['relaunched']}), the "
          f"codec breaker held: the numpy repair served on the CPU "
          f"reference byte-equal, the CUDA repair refused with no launch; "
          f"bundles {first['bundles']}, reporter witnesses equal; phase-2 "
          f"verify p50 {statistics.median(first['lat2']) * 1e3:.3f} ms, max "
          f"{max(first['lat2']) * 1e3:.3f} ms; verify observations "
          f"{snap_t['observations']}, budget remaining "
          f"{snap_t['budget_remaining']}; baseline "
          f"{PERF_METRIC} = {base:.3f} GiB/s (the engine's CUDA-tensor "
          f"encode of [{nseg}, 2, {n}] over 8 calls, on this card), the perf "
          f"drill twice (guard {PERF_GUARD}): watchdog ok -> regressed "
          f"(window 1) -> ok (window 3), "
          f"one perf-regression bundle with both ledgers, witnesses equal, "
          f"last window {last_gibs:.3f} GiB/s (faulted windows at most "
          f"{faulted_gibs:.3f}); stream of {stream_segs} x 16 MiB pinned "
          f"byte-equal, pad bill {pads} (the tail's {tail} in the engine's "
          f"ledger), profile {prof_gibs:.3f} GiB/s <= stream "
          f"{host_gibs:.3f} GiB/s from host bytes; burst p50 ms disarmed "
          f"(turns 1, 4): {turns('disarmed')}; armed (turns 2, 3): "
          f"{turns('armed')}; burst walls "
          + "/".join(f"{w * 1e3:.3f}" for w in (
              walls["disarmed"][0], walls["armed"][0], walls["armed"][1],
              walls["disarmed"][1]))
          + f" ms; kernels at the engines' shapes byte-exact against their "
          f"plain versions: {held}; phase wall {phase_s * 1e3:.3f} ms; "
          f"launches {launches} {tag}")
    return launches


# the remediation drills (phase remediate). The pin drill's second
# regression is of the repair class, a watchdog metric of its own: the
# incident reporter drops a repeated (trigger, key), so a second
# regression of the encode metric would leave no bundle. The straggler
# drill: lane 2's seeded delay (tens of times a clean batch of 4
# segments), and the waves of 4 encodes before the scan (window medians
# over 8 batches a lane) and under the quarantine
REPAIR_METRIC = "rs_2p1_repair_GiBps_per_chip"
STRAGGLER_DELAY_S = 0.08
STRAGGLER_WAVES = 8
QUARANTINE_WAVES = 4


def pin_drill(cfg, key, dev, fix: dict, baseline: dict, counts,
              seed: bytes) -> dict:
    """Drill (a) of phase remediate: a single-device engine with
    resilience and a ProfilePlane anchored on ``baseline`` (encode and
    repair, window ``PERF_WINDOW``, guard ``PERF_GUARD``), a
    RemediationPlane with the default policies bound to it and listening
    on an armed FlightRecorder, and an IncidentReporter with the plane.
    One plane tick a round. Under a seeded ``engine.dispatch`` delay of
    ``PERF_DELAY_S`` two CUDA encodes of 32 segments turn the encode
    metric regressed and the next tick pins it (``perf-pin`` holds the
    codec breaker). Delay lifted: a CUDA encode is refused with no
    launch, a numpy one is served on the CPU reference; the re-probe
    releases the pin after ``release_after`` ticks (the watchdog sees
    only the reference path while pinned), and three CUDA encodes launch
    ``gf_apply`` again and bring the watchdog back to ok. After the
    cooldown, two delayed reconstructs turn the repair metric regressed:
    the pin fires again and that regression's bundle carries the
    journal. Then the re-probe, a clean reconstruct and the tags of the
    encoded fragments. Returns the run's record."""
    import torch
    from cess_tpu_torch.obs import IncidentReporter, flight
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                           ResilienceConfig, faults)
    from cess_tpu_torch.serve import (EngineUnavailable, RemediationPlane,
                                      make_engine)

    profile = ProfilePlane(baseline=baseline, guard=PERF_GUARD,
                           window=PERF_WINDOW,
                           tracked={"encode": PERF_METRIC,
                                    "repair": REPAIR_METRIC})
    eng = make_engine(cfg.k, cfg.m, rs_backend=dev.type, podr2_key=key,
                      audit_backend=dev.type, resilience=ResilienceConfig(),
                      profile=profile)
    rec = flight.FlightRecorder(seed)
    plane = RemediationPlane(seed)
    rec.add_listener(plane.on_note)
    plane.bind_engine(eng)
    reporter = IncidentReporter(rec, engine=eng, remediation=plane)
    plan = FaultPlan.seeded(seed, {"engine.dispatch": (
        1.0, FaultSpec("delay", delay_s=PERF_DELAY_S))}, horizon=64)
    mon = eng.monitors["codec"]
    out = {"states": [], "tick_s": []}

    def round_(fn=None):
        if fn is not None:
            fn()
        t = time.perf_counter()
        plane.tick()
        out["tick_s"].append(time.perf_counter() - t)
        out["states"].append(mon.state)

    def encode():
        got = eng.encode(fix["data"], timeout=600)
        check(torch.equal(got, fix["enc"]),
              "remediate: a pin drill encode differs")

    def repair():
        got = eng.reconstruct(fix["surv_card"], (1, 2), (0,), timeout=600)
        check(torch.equal(got, fix["enc"][:, :1]),
              "remediate: a pin drill reconstruct differs")

    t0 = time.perf_counter()
    try:
        with flight.armed(rec):
            with faults.armed(plan):
                round_(encode)
                round_(encode)               # window 1 closes: regressed
            out["pinned"] = mon.state
            _sync(dev)
            before = counts()
            try:
                eng.encode(fix["data"], timeout=600)
                out["refused"] = False
            except EngineUnavailable:
                out["refused"] = True
            _sync(dev)
            out["quiet"] = counts() == before
            out["host"] = eng.encode(fix["bulk"], timeout=600)
            round_()
            while not plane.journal()[-1]["event"] == "release":
                check(plane.count < 16, "remediate: the pin never released")
                round_()
            out["released"] = mon.state
            launched = counts()["gf_apply"]
            for _ in range(3):
                round_(encode)
            out["relaunched"] = counts()["gf_apply"] - launched
            for _ in range(2):
                round_()                     # past the cooldown
            with faults.armed(plan):
                round_(repair)
                round_(repair)               # the repair metric regresses
            out["pinned2"] = mon.state
            for _ in range(8):
                round_()
            round_(repair)
            out["tags"] = eng.tag_fragments(fix["ids"], fix["frs"],
                                            timeout=600)
        _sync(dev)
        out["wall_s"] = time.perf_counter() - t0
        out["progs"] = eng.programs.keys()
    finally:
        eng.close()
    edges = {e["id"]: e for e in plane.edge_log()}
    out.update(
        witness=plane.witness(), journal=plane.journal(),
        lag=[e["tick"] - edges[e["edge"]]["tick"] for e in plane.journal()
             if e["event"] == "fire"],
        watchdog=profile.watchdog.transition_log(),
        bundles=[(b["trigger"], b["key"],
                  len(b["snapshots"].get("remediation", {}).get(
                      "journal", ()))) for b in reporter.bundles()],
        degraded=eng.stats_snapshot()["resilience"]["degraded_batches"],
        fired=plan.fired_log())
    return out


def quarantine_drill(cfg, key, dev, fix: dict, seed: bytes) -> dict:
    """Drill (b) of phase remediate: an engine with resilience and a
    tracer over ``DevicePool([card] * 4)``, one request a batch, a
    RemediationPlane with the default policies bound to it, a port
    FleetPlane("card") whose StragglerDetector (window 16, k 4, min_nodes
    4) reads each lane's encode batch wall (its ``device.encode`` span) as
    instance ``card.d<i>``, an IncidentReporter with the plane. Each wave
    submits 4 CUDA encodes of 4 segments while the card's device lock is
    held, so they are placed on the 4 lanes before any runs. A warm wave,
    then ``STRAGGLER_WAVES`` under a seeded ``engine.dispatch.encode.d2``
    delay of ``STRAGGLER_DELAY_S``; the scan then flags ``card.d2`` and
    the next tick quarantines it (every breaker of lane 2 held). One
    round a wave: ``QUARANTINE_WAVES`` waves placed on lanes 0, 1 and 3,
    then plain rounds until the re-probe releases the lane; the plan
    disarmed, a last wave is served by all four lanes and its fragments
    are tagged. Every output byte-equal to the direct path. Returns the
    run's record."""
    import torch
    from cess_tpu_torch.obs import IncidentReporter, flight, trace
    from cess_tpu_torch.obs.fleet import FleetPlane, StragglerDetector
    from cess_tpu_torch.resilience import (FaultPlan, FaultSpec,
                                           ResilienceConfig, faults)
    from cess_tpu_torch.serve import (AdmissionPolicy, DevicePool,
                                      RemediationPlane, make_engine)

    tracer = trace.Tracer()
    eng = make_engine(cfg.k, cfg.m, rs_backend=dev.type, podr2_key=key,
                      audit_backend=dev.type, resilience=ResilienceConfig(),
                      pool=DevicePool([dev] * 4), tracer=tracer,
                      policy=AdmissionPolicy(max_batch_requests=1))
    rec = flight.FlightRecorder(seed)
    plane = RemediationPlane(seed)
    rec.add_listener(plane.on_note)
    plane.bind_engine(eng)
    fleet = FleetPlane("card")
    raw = StragglerDetector()
    reporter = IncidentReporter(rec, engine=eng, remediation=plane)
    plan = FaultPlan.seeded(seed, {"engine.dispatch.encode.d2": (
        1.0, FaultSpec("delay", delay_s=STRAGGLER_DELAY_S))}, horizon=64)
    walls = {i: [] for i in range(4)}
    seen = [0]
    out = {"waves": [], "tick_s": [], "seal_s": []}

    def wave():
        """4 encodes placed before any runs; each lane's batch wall."""
        log0 = len(eng.pool.placement_log())
        # the lanes' batches wait on the device lock while the batcher
        # places all four: placement never races a finishing batch
        with eng._device_locks[dev]:
            futs = [eng.submit_encode(x) for x in fix["wave"]]
            deadline = time.monotonic() + 60
            while len(eng.pool.placement_log()) < log0 + len(futs):
                check(time.monotonic() < deadline,
                      "remediate: a wave was not placed")
                time.sleep(0.0005)
        outs = [f.result(600) for f in futs]
        for got, want in zip(outs, fix["wave_enc"]):
            check(torch.equal(got, want),
                  "remediate: a quarantine drill encode differs")
        lanes = [row[4] for row in eng.pool.placement_log()[log0:]]
        out["waves"].append(lanes)
        got = {}
        for sp in tracer.finished():
            if sp["span_id"] > seen[0] and sp["name"] == "device.encode":
                got[sp["attrs"]["device"]] = sp["dur_s"]
        seen[0] = max([seen[0]] + [sp["span_id"]
                                   for sp in tracer.finished()])
        return outs, got

    def observe(got):
        # the plane's detector reads each wall on a grid of the delay (a
        # clean wall reads 0, a delayed one the delay), so the outlier
        # edge's detail, part of the plane's witness, replays exactly; a
        # second detector reads the raw walls
        for i, wall in sorted(got.items()):
            walls[i].append(wall)
            raw.observe(f"card.d{i}", "encode_wall_s", wall)
            fleet.stragglers.observe(
                f"card.d{i}", "encode_wall_s",
                round(wall / STRAGGLER_DELAY_S) * STRAGGLER_DELAY_S)

    def round_(fn=None):
        if fn is not None:
            fn()
        t = time.perf_counter()
        fleet.seal_round()
        t1 = time.perf_counter()
        plane.tick()
        out["seal_s"].append(t1 - t)
        out["tick_s"].append(time.perf_counter() - t1)

    t0 = time.perf_counter()
    try:
        wave()                                          # the warm wave
        with faults.armed(plan):
            for _ in range(STRAGGLER_WAVES):
                observe(wave()[1])
            out["medians"] = {i: statistics.median(w)
                              for i, w in walls.items()}
            raw.scan()                       # no recorder armed: no edge
            out["raw_outliers"] = raw.snapshot()["outliers"]
        with flight.armed(rec):
            with faults.armed(plan):
                round_()                     # the scan, then the tick
                out["outliers"] = fleet.stragglers.snapshot()["outliers"]
                out["held"] = {
                    f"{b}.d{lane.index}": m.state
                    for lane in eng.pool.lanes
                    for b, m in sorted(lane.monitors.items())}
                quarantined = len(out["waves"])
                for _ in range(QUARANTINE_WAVES):
                    round_(lambda: observe(wave()[1]))
                out["quarantined"] = [
                    lane for w in out["waves"][quarantined:] for lane in w]
                while plane.engagements():
                    check(plane.count < 40,
                          "remediate: the quarantine never released")
                    round_()
            outs, got = wave()
            out["returned"] = out["waves"][-1]
            out["returned_walls"] = got
            frs = torch.cat(outs).reshape(-1, cfg.fragment_size)
            out["tags"] = (eng.tag_fragments(fix["wave_ids"], frs,
                                             timeout=600), frs)
        _sync(dev)
        out["wall_s"] = time.perf_counter() - t0
        out["progs"] = eng.programs.keys()
        out["placements"] = eng.pool.placement_log()
        out["released"] = {f"{b}.d{lane.index}": m.state
                           for lane in eng.pool.lanes
                           for b, m in sorted(lane.monitors.items())}
    finally:
        eng.close()
    edges = {e["id"]: e for e in plane.edge_log()}
    out.update(
        witness=plane.witness(), journal=plane.journal(),
        lag=[e["tick"] - edges[e["edge"]]["tick"] for e in plane.journal()
             if e["event"] == "fire"],
        notes=[e["detail"] for e in rec.journal_tail("fleet")
               if e["kind"] == "outlier"],
        bundles=[(b["trigger"], b["key"]) for b in reporter.bundles()],
        fired=plan.fired_log())
    return out


def remediate_phase(dev, zero_counts, counts, errs: dict, tag: str,
                    cfg=None, nseg: int = 32, wave_segs: int = 4) -> dict:
    """The remediation loop (``serve/remediate.py`` acting on the engine's
    breakers and the pool lanes', fed by ``obs/profile.py``'s watchdog and
    ``obs/fleet.py``'s straggler detector) at the main path's width:
    RS(2,1), 16 MiB segments, the chain's key ``Podr2Key.generate(7)``.

    The engine's encode and repair GiB/s of 32 segments are measured on
    this card (``engine_gibps``) as the watchdog's baseline; then
    ``pin_drill`` twice and ``quarantine_drill`` twice, each run with the
    same seed as its twin: equal plane witnesses, firings and placement
    logs. Counters are zeroed after the inputs are made and read at the
    end; ``gf_apply``, ``prf_blocks`` and ``podr2_tag`` must launch, and
    each is then held against its plain version at every shape in the
    engines' program caches. A smaller ``cfg`` and ``nseg`` rehearse the
    phase on the CPU (the checks that count launches or refuse card
    members need the card). Returns the launches."""
    import types

    import numpy as np
    import torch
    from cess_tpu_torch.models.pipeline import PipelineConfig
    from cess_tpu_torch.ops import podr2
    from cess_tpu_torch.ops.rs import TorchCodec

    cfg = cfg or PipelineConfig()
    cuda = dev.type == "cuda"
    n = cfg.fragment_size
    key = podr2.Podr2Key.generate(7, device=dev)
    codec = TorchCodec(cfg.k, cfg.m, device=dev)

    def id_pairs(lo, hi, tag_):
        return torch.stack([torch.arange(lo, hi, device=dev),
                            torch.full((hi - lo,), tag_, device=dev)], dim=1)

    data = rand_bytes((nseg, cfg.k, n), 170, dev)
    enc = codec.encode(data)
    frs = enc.reshape(-1, n)
    wave = [rand_bytes((wave_segs, cfg.k, n), 180 + i, dev)
            for i in range(4)]
    wave_enc = [codec.encode(x) for x in wave]
    nwave = 4 * wave_segs * (cfg.k + cfg.m)
    fix = {"data": data, "enc": enc, "frs": frs,
           "ids": id_pairs(0, frs.shape[0], 21),
           "bulk": data[:1].cpu().numpy(), "bulk_enc": enc[:1].cpu().numpy(),
           "surv_card": enc[:, 1:].contiguous(), "wave": wave,
           "wave_enc": wave_enc, "wave_ids": id_pairs(0, nwave, 23)}
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_phase = time.perf_counter()
    progs = []
    base_e, keys = engine_gibps(cfg, dev, "encode",
                                lambda e: e.encode(data, timeout=600))
    progs += keys
    base_r, keys = engine_gibps(cfg, dev, "repair", lambda e: e.reconstruct(
        fix["surv_card"], (1, 2), (0,), timeout=600))
    progs += keys
    check(base_e and base_r, f"remediate: baselines {base_e}, {base_r}")
    baseline = {PERF_METRIC: base_e, REPAIR_METRIC: base_r}
    pins = [pin_drill(cfg, key, dev, fix, baseline, counts,
                      b"chip-remediate-pin") for _ in range(2)]
    lanes = [quarantine_drill(cfg, key, dev, fix, b"chip-remediate-lane")
             for _ in range(2)]
    _sync(dev)
    phase_s = time.perf_counter() - t_phase
    launches = counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")) or not cuda,
          f"remediate: a kernel was not launched: {launches}")

    want_tags = podr2.tag_fragments(key, fix["ids"], frs)
    hold = "codec:remediation:perf-pin"
    for run in pins:
        check(run["pinned"] == "held" and run["pinned2"] == "held"
              and run["released"] == "closed"
              and run["states"][-1] == "closed",
              f"remediate: codec breaker {run['states']}")
        check(run["lag"] == [1, 1], f"remediate: pin lag {run['lag']}")
        check((run["refused"] and run["quiet"]) or not cuda,
              "remediate: the CUDA encode under the pin was not refused, or "
              "a kernel launched")
        check(np.array_equal(run["host"], fix["bulk_enc"]),
              "remediate: the numpy encode under the pin differs")
        check(run["relaunched"] > 0 or not cuda,
              "remediate: gf_apply did not launch after the release")
        # on the CPU (a rehearsal) the reference path pinned to is as
        # fast as the primary, so the watchdog's recovery edge releases
        # the first pin before the re-probe does
        check([(e["event"], e["policy"], e["key"], e["reason"])
               for e in run["journal"]] == [
            ("fire", "perf-pin", PERF_METRIC, ""),
            ("release", "perf-pin", PERF_METRIC,
             "re-probe" if cuda else "recovered"),
            ("fire", "perf-pin", REPAIR_METRIC, ""),
            ("release", "perf-pin", REPAIR_METRIC, "re-probe")]
            and all(e["applied"] for e in run["journal"]),
            f"remediate: pin journal {run['journal']}")
        check([t[1:4] for t in run["watchdog"]] == [
            (PERF_METRIC, "ok", "regressed"), (PERF_METRIC, "regressed", "ok"),
            (REPAIR_METRIC, "ok", "regressed")]
            and run["watchdog"][0][4] == 1 and run["watchdog"][2][4] == 1,
            f"remediate: watchdog {run['watchdog']}")
        b = {(t, k_): j for t, k_, j in run["bundles"]}
        check(b.get(("perf-regression", PERF_METRIC)) == 0
              and b.get(("breaker-hold", hold), 0) > 0
              and b.get(("perf-regression", REPAIR_METRIC), 0) > 0,
              f"remediate: bundles {run['bundles']}")
        # on the CPU the "CUDA" encode is a host one, served as well
        check(run["degraded"] == {"encode": 1 if cuda else 2},
              f"remediate: degraded {run['degraded']}")
        check(torch.equal(run["tags"], want_tags),
              "remediate: the pin drill's tags differ")
        progs += run["progs"]
    check(pins[0]["witness"] == pins[1]["witness"]
          and pins[0]["fired"] == pins[1]["fired"],
          "remediate: the pin drill's replay differs")
    for run in lanes:
        clean = [run["medians"][i] for i in (0, 1, 3)]
        check(run["outliers"] == run["raw_outliers"]
              == ["card.d2/encode_wall_s"]
              and [d["instance"] for d in run["notes"]] == ["card.d2"],
              f"remediate: outliers {run['outliers']}, raw walls "
              f"{run['raw_outliers']}, {run['notes']}")
        check(run["medians"][2] >= 20 * max(clean) or not cuda,
              f"remediate: lane 2 {run['medians']}")
        check(run["lag"] == [1], f"remediate: quarantine lag {run['lag']}")
        check(all(s == ("held" if name.endswith(".d2") else "closed")
                  for name, s in run["held"].items()),
              f"remediate: breakers under the quarantine {run['held']}")
        check(len(run["quarantined"]) >= 16
              and set(run["quarantined"]) <= {0, 1, 3},
              f"remediate: placements {run['quarantined']}")
        check(sorted(run["returned"]) == [0, 1, 2, 3]
              and all(s == "closed" for s in run["released"].values()),
              f"remediate: after the release {run['returned']}")
        check([(e["event"], e["policy"], e["key"], e["reason"])
               for e in run["journal"]] == [
            ("fire", "straggler-quarantine", "card.d2", ""),
            ("release", "straggler-quarantine", "card.d2", "re-probe")]
            and all(e["applied"] for e in run["journal"]),
            f"remediate: quarantine journal {run['journal']}")
        check(("fleet-outlier", "card.d2:encode_wall_s") in run["bundles"],
              f"remediate: bundles {run['bundles']}")
        tags, wfrs = run["tags"]
        check(torch.equal(tags, podr2.tag_fragments(key, fix["wave_ids"],
                                                    wfrs)),
              "remediate: the quarantine drill's tags differ")
        progs += run["progs"]
        del run["tags"]
    check(lanes[0]["witness"] == lanes[1]["witness"]
          and lanes[0]["placements"] == lanes[1]["placements"]
          and lanes[0]["fired"] == lanes[1]["fired"],
          "remediate: the quarantine drill's replay differs")
    # a lane's program keys end in ("device", i): the lanes share the
    # card, so each shape is held once
    progs = sorted({k[:-1] if isinstance(k[-1], tuple)
                    and k[-1][:1] == ("device",) else k for k in progs},
                   key=repr)
    held = serve_kernel_checks(
        progs, types.SimpleNamespace(config=cfg, podr2_key=key), dev,
        [data] + wave, [enc] + wave_enc, [fix["ids"], fix["wave_ids"]],
        None, 1, errs, phase="remediate")

    def ms(xs):
        return "/".join(f"{x * 1e3:.3f}" for x in xs)

    def us(xs):
        return (f"median {statistics.median(xs) * 1e6:.1f} us, max "
                f"{max(xs) * 1e6:.1f} us over {len(xs)}")

    first = lanes[0]
    print(f"phase remediate: RS(2,1) engines with resilience, a flight "
          f"recorder, an incident reporter and a RemediationPlane (default "
          f"policies), the chain's key; baselines on this card: "
          f"{PERF_METRIC} = {base_e:.3f}, {REPAIR_METRIC} = {base_r:.3f} "
          f"GiB/s; pin drill twice (a {PERF_DELAY_S * 1e3:.0f} ms "
          f"engine.dispatch delay): encode regressed -> perf-pin held the "
          f"codec breaker {pins[0]['lag'][0]} tick after the edge, a CUDA "
          f"encode refused with no launch, a numpy one served on the CPU "
          f"reference byte-equal, released by "
          f"{pins[0]['journal'][1]['reason']}, gf_apply relaunched "
          f"({pins[0]['relaunched']}), watchdog back to ok, then repair "
          f"regressed -> pinned again {pins[0]['lag'][1]} tick after, its "
          f"bundle with {dict(((t, k_), j) for t, k_, j in pins[0]['bundles'])[('perf-regression', REPAIR_METRIC)]} "
          f"journal entries; witnesses equal; walls {ms([r['wall_s'] for r in pins])} "
          f"ms; quarantine drill twice on DevicePool([card] x 4) (a "
          f"{STRAGGLER_DELAY_S * 1e3:.0f} ms engine.dispatch.encode.d2 "
          f"delay): encode batch wall window medians over "
          f"{STRAGGLER_WAVES} batches, lanes 0/1/3 "
          f"{ms([first['medians'][i] for i in (0, 1, 3)])} ms, lane 2 "
          f"{first['medians'][2] * 1e3:.3f} ms (run 2: "
          f"{ms([lanes[1]['medians'][i] for i in range(4)])}); outlier "
          f"card.d2 alone, quarantined {first['lag'][0]} tick after the "
          f"edge, {len(first['quarantined'])} encodes on lanes "
          f"{sorted(set(first['quarantined']))} byte-equal, re-probe "
          f"release, lane 2 serving again (wall "
          f"{first['returned_walls'].get(2, 0.0) * 1e3:.3f} ms); witnesses "
          f"and placement logs equal; walls {ms([r['wall_s'] for r in lanes])} "
          f"ms; host cost: plane.tick {us([t for r in pins + lanes for t in r['tick_s']])}, "
          f"fleet.seal_round (a scan of 4 lanes) "
          f"{us([t for r in lanes for t in r['seal_s']])}; kernels at the "
          f"engines' shapes byte-exact against their "
          f"plain versions: {held}; phase wall {phase_s * 1e3:.3f} ms; peak "
          f"{peak / MIB:.1f} MiB; launches {launches} {tag}")
    return launches


def chain_phase(dev, zero_counts, counts, errs: dict, tag: str, cfg=None,
                nseg: int = 32) -> dict:
    """One storage-audit round from the card's encode to the port's
    ``Runtime``, at the main path's width: RS(2,1), ``nseg`` segments of
    16 MiB, the chain's key ``Podr2Key.generate(7)``.
    ``tests/torch_chain_wiring.py``'s ``audit_round`` applies the
    extrinsic sequence the JAX agents submit as signed extrinsics through
    ``Runtime.apply_in_block``, block by block (``RuntimeConfig(
    era_blocks=50)``): three miners' ``sminer.regnstk``, a TEE registered
    with an RSA attestation and a BLS key with its proof of possession, 4
    certified fillers of 8 MiB a miner through ``file_bank.upload_filler``;
    ``upload_batch`` on the card, the deal, the validators' signed
    proposals, every miner's ``build_proof`` wire bytes computed on the
    card, the TEE's decode and ``verify_owed`` on the card and its BLS
    seals; then the blocks to the era boundary, where the honest miners'
    first tranche is paid. Miner 2 holds one fragment XORed with 0xA5.
    The native BLS library must have loaded (no fallback to pure Python).
    Counters are zeroed just before the round and read just after; then
    each kernel is held against its plain version at the phase's shapes.
    A smaller ``cfg`` and ``nseg`` rehearse the phase on the CPU. Returns
    the launches of the phase."""
    import os
    import statistics as st

    import numpy as np
    import torch
    from cess_tpu_torch import constants
    from cess_tpu_torch.crypto import bls12381
    from cess_tpu_torch.models.pipeline import PipelineConfig
    from cess_tpu_torch.node import offchain as oc
    from cess_tpu_torch.ops import gf, podr2, podr2_kernel, prf, rs_kernel

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_chain_wiring import VALIDATORS, Lockstep, audit_round

    check(bls12381._native is not None,
          "chain: the native BLS library did not load (the round would "
          "run on the pure-Python pairing)")
    bls_lib = os.path.relpath(bls12381._native._lib._name,
                              os.path.dirname(os.path.abspath(__file__)))
    cfg = cfg or PipelineConfig()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    n, blocks = cfg.fragment_size, cfg.blocks_per_fragment
    key = podr2.Podr2Key.generate(7, device=dev)
    pipe = oc.AgentPipeline(cfg, podr2_key=key, device=dev)
    data = rand_bytes((nseg * cfg.segment_size,), 91, dev).cpu().numpy()
    ls = Lockstep(["cess_tpu_torch"], era_blocks=50)
    chain = ls.first
    sync()
    zero_counts()
    t0 = time.perf_counter()
    r = audit_round(pipe, data, chains=ls, device=dev, tamper_row=1)
    sync()
    round_s = time.perf_counter() - t0
    launches = counts()
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")),
          f"chain: a kernel was not launched by the round: {launches}")
    up, deal = r["upload"], r["deal"]
    want = {w: (True, w != r["tampered"]) for w in deal.assigned}
    check(r["verdicts"] == want,
          f"chain: verdicts {r['verdicts']} != {want}")
    wire = oc.proof_wire_bytes()
    check(all(len(b) == wire <= constants.SIGMA_MAX
              for pair in r["proofs"].values() for b in pair),
          f"chain: a proof's wire bytes are not {wire} <= SIGMA_MAX")
    for w in deal.assigned:
        orders = r["orders"][w]
        if w == r["tampered"]:
            check(orders is None and w not in r["paid"]
                  and r["received"][w] == 0
                  and chain.state.get("audit", "fail_count", w) == 1,
                  f"chain: the tampered miner {w} was not failed once, "
                  f"or was paid")
        else:
            check(bool(orders) and r["received"][w] == r["paid"].get(w)
                  == orders[0].each_share > 0,
                  f"chain: honest miner {w}'s first tranche did not reach "
                  f"its beneficiary at the era boundary")
    check(r["blocks"] == 50 and r["audit_keys"] == VALIDATORS,
          f"chain: the round ended at block {r['blocks']} with audit keys "
          f"{r['audit_keys']}, not at the era boundary with its validators")
    failed = [(dict(e.data)["call"], dict(e.data)["error"])
              for e in chain.state.events_of("system", "ExtrinsicFailed")]
    check(failed == [("audit.save_challenge_info",
                      "audit.ChallengeInProgress"),
                     ("audit.submit_verify_result",
                      "audit.BadVerdictSignature")],
          f"chain: unexpected failed extrinsics {failed}")
    check(r["log_ok"] and len(r["verdict_log"]) == len(deal.assigned),
          "chain: the sealed verdict log does not re-verify")
    check(chain.state.recompute_root() == r["state_root"],
          "chain: the incremental state root differs from a full rescan")

    # BLS on the native library: a seal and its check
    sk, pk = r["bls"]
    msg = b"chip-smoke verdict"
    sig = bls12381.sign(sk, msg)
    def median_ms(fn, runs=5):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return st.median(times)

    sign_ms = median_ms(lambda: bls12381.sign(sk, msg))
    verify_ms = median_ms(lambda: bls12381.verify(pk, msg, sig))
    check(bls12381.verify(pk, msg, sig), "chain: a BLS seal did not verify")

    # each kernel at the phase's shapes, against its plain version
    def held(name, got, plain):
        e = max_err(got, plain)
        errs[name] = max(errs[name], e)
        check(e == 0, f"chain: {name} at {tuple(got.shape)} differs from "
              f"its plain version")

    shapes = []
    seg_t = torch.from_numpy(data).to(dev).view(nseg, cfg.k, n)
    tab = rs_kernel.tables(gf.cauchy_parity_matrix(cfg.k, cfg.m), dev)
    held("gf_apply", rs_kernel.gf_apply(tab, seg_t),
         rs_kernel.gf_apply_plain(tab, seg_t))
    shapes.append(f"gf_apply encode {tuple(seg_t.shape)}")
    del seg_t
    frags_t = torch.from_numpy(np.array(up.fragments)).to(dev).view(-1, n)
    ids_t = torch.from_numpy(up.ids.reshape(-1, 2).astype(np.int64)).to(dev)
    w0 = deal.assigned[0]
    fill = r["filler_store"][w0]
    fill_t = torch.from_numpy(np.stack([np.frombuffer(b, np.uint8)
                                        for b in fill.values()])).to(dev)
    fill_ids = torch.from_numpy(np.stack([
        podr2.fragment_id_from_hash(h) for h in fill]).astype(
            np.int64)).to(dev)
    every = torch.arange(blocks, device=dev)
    for ids, fr in ((ids_t, frags_t), (fill_ids, fill_t)):
        prf_lm = podr2_kernel.prf_blocks(key.prf_key, ids, None, blocks,
                                         key.limbs, limb_major=True)
        held("prf_blocks", prf_lm, prf.prf_plain(key.prf_key, ids, every,
                                                 key.limbs).transpose(1, 2))
        fb = fr.view(-1, blocks, podr2.BLOCK_BYTES)
        held("podr2_tag", podr2_kernel.podr2_tag(key.weights, prf_lm, fb),
             podr2_kernel.podr2_tag_plain(key.weights, prf_lm, fb))
        shapes.append(f"prf_blocks (limb-major) and podr2_tag "
                      f"{ids.shape[0]} x {blocks}")
        del prf_lm, fb
    idx = podr2.gen_challenge(r["seed"], blocks, device=dev)[0]
    snap = next(m.snapshot for m in r["missions"] if m.miner == w0)
    for hashes in (snap.service_frags, snap.fillers):
        ids = torch.from_numpy(np.stack([
            podr2.fragment_id_from_hash(h) for h in hashes]).astype(
                np.int64)).to(dev)
        held("prf_blocks", podr2_kernel.prf_blocks(
            key.prf_key, ids, idx, idx.numel(), key.limbs),
            prf.prf_plain(key.prf_key, ids, idx, key.limbs))
        shapes.append(f"prf_blocks {ids.shape[0]} x {idx.numel()}")
    del frags_t, fill_t
    if cuda:
        torch.cuda.empty_cache()
    t = r["seconds"]
    split = ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in up.seconds.items())
    host = ("snapshot_and_proposals", "proofs", "checks", "seals",
            "pallet_calls", "block_hooks")
    nfrag = up.fragments.shape[0] * up.fragments.shape[1]
    print(f"phase chain: RS(2,1) upload of {nseg} x "
          f"{cfg.segment_size // MIB} MiB segments ({nfrag} fragments of "
          f"{n // MIB} MiB) {t['upload'] * 1e3:.3f} ms ({split}); "
          f"{len(deal.assigned)} miners x {nseg} fragments + 4 fillers each "
          f"(generation, certification and registration "
          f"{t['fillers'] * 1e3:.3f} ms); the round's host wall "
          f"{sum(t[k] for k in host) * 1e3:.3f} ms: "
          f"{', '.join(f'{k} {t[k] * 1e3:.3f} ms' for k in host)} (the "
          f"era block's init_block {t['era_init'] * 1e3:.3f} ms); "
          f"{r['signed']} signed extrinsics through apply_in_block over "
          f"{r['blocks']} blocks, 2 failed as expected (the third proposal, "
          f"the forged seal); phase "
          f"{round_s * 1e3:.3f} ms; {len(r['proofs']) * 2} proofs of {wire} "
          f"wire bytes; verdicts {sorted(r['verdicts'].items())} (tampered "
          f"{r['tampered']}), honest miners' first tranche paid at the era "
          f"boundary {sorted(r['paid'].items())}, the audit keys kept, the "
          f"verdict log re-verified in one "
          f"pairing product; native BLS ({bls_lib}) sign {sign_ms:.3f} ms, "
          f"verify {verify_ms:.3f} ms; state_root {r['state_root'].hex()}; kernels "
          f"byte-exact against their plain versions at the phase's shapes: "
          f"{', '.join(shapes)}; launches {launches} {tag}")
    return launches


FIXTURE_FILLERS = 400    # fillers a miner in the reference's storage_net


def storage_network(dev, cfg, key, data: bytes, fillers: int, engine=None,
                    repair: bool = False, rpc: bool = False) -> dict:
    """One run of phase ``node``'s storage network (``node_phase``): the
    reference's ``storage_net`` shape on the port's node and agents,
    ``engine`` (or None) under the gateway, miners and TEE. Returns what
    the phase compares and reports; no object of the network is kept."""
    import numpy as np
    from cess_tpu_torch import constants
    from cess_tpu_torch.chain.attestation import issue_cert, issue_report
    from cess_tpu_torch.chain.audit import reverify_verdict
    from cess_tpu_torch.crypto.rsa import generate_rsa_keypair
    from cess_tpu_torch.node import offchain as oc
    from cess_tpu_torch.node.chain_spec import ChainSpec, ValidatorGenesis
    from cess_tpu_torch.node.hashing import fragment_hash
    from cess_tpu_torch.node.network import Network, Node

    d = constants.DOLLARS
    names = ("m1", "m2", "m3", "m4")
    spec = ChainSpec(
        name="t", chain_id="test-net",
        endowed=(("alice", 1_000_000_000 * d), ("gw", 1_000_000 * d),
                 ("stash1", 10_000_000 * d), ("tee1", 1_000 * d),
                 *((w, 10_000 * d) for w in names)),
        validators=tuple(ValidatorGenesis(f"v{i}", 4_000_000 * d)
                         for i in range(3)),
        era_blocks=40, epoch_blocks=10,
        audit_challenge_life=6, audit_verify_life=8, sudo="alice")
    nodes = [Node(spec, f"node{i}", {f"v{i}": spec.session_key(f"v{i}")})
             for i in range(3)]
    net = Network(nodes)
    node, rt = nodes[0], nodes[0].runtime
    wall = dict.fromkeys(("proofs", "checks", "pallet_calls",
                          "block_hooks"), 0.0)

    def timed(obj, name, bucket):
        fn = getattr(obj, name)

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                wall[bucket] += time.perf_counter() - t0
        setattr(obj, name, run)

    for n in nodes:
        timed(n.runtime, "apply_in_block", "pallet_calls")
        timed(n.runtime, "init_block", "block_hooks")

    # setup, as the reference's fixture does it
    t_setup = time.perf_counter()
    kp = generate_rsa_keypair(1024, seed=5)
    signer_kp = generate_rsa_keypair(1024, seed=6)
    mr = b"\x02" * 32
    for n in nodes:
        n.runtime.apply_extrinsic("root", "tee_worker.update_whitelist", mr)
        n.runtime.apply_extrinsic("root", "tee_worker.pin_ias_signer",
                                  kp.public)
    cert = issue_cert(kp, "ias-signer", signer_kp.public)
    tee = oc.TeeAgent(node, "tee1", key, cfg.blocks_per_fragment,
                      bls_seed=b"net-tee-master", engine=engine)
    bls_pk, pop = tee.bls_registration()
    report, rsig = issue_report(signer_kp, mr, b"tee-pk", "tee1",
                                bls_pk=bls_pk)
    node.submit_extrinsic("tee1", "tee_worker.register", "stash1", b"tp",
                          b"tee-pk", report, rsig, (cert,), bls_pk, pop)
    for w in names:
        node.submit_extrinsic(w, "sminer.regnstk", w, b"p" + w.encode(),
                              2000 * d)
    net.run_slots(2)
    pipe = oc.AgentPipeline(cfg, podr2_key=key, device=dev, engine=engine)
    gw = oc.OssGateway(node, "gw", pipe)
    miners = [oc.MinerAgent(node, w, [gw], pipe, engine=engine)
              for w in names]
    t0 = time.perf_counter()
    for m in miners:
        m.setup_fillers(tee, fillers)
    filler_s = time.perf_counter() - t0
    # the cut: ``fillers`` certified fillers a miner, and on every replica
    # a genesis grant of the idle space of the fixture's other fillers
    for n in nodes:
        for w in names:
            n.runtime.sminer.add_miner_idle_space(
                w, (FIXTURE_FILLERS - fillers) * constants.FRAGMENT_SIZE)
    net.run_slots(2)
    node.submit_extrinsic("alice", "storage_handler.buy_space", 10)
    node.submit_extrinsic("alice", "oss.authorize", "gw")
    net.run_slots(2)
    node.submit_extrinsic("gw", "file_bank.create_bucket", "alice", "photos")
    net.run_slots(2)
    for n in nodes:
        n.runtime.fund("sminer_reward_pool", 10_000 * d)
    node.offchain_agents.extend([*miners, tee])
    setup_s = time.perf_counter() - t_setup

    # the upload: declared, fetched and reported, then made active
    t0 = time.perf_counter()
    fh = gw.upload("alice", "photos", "node-phase.bin", data)
    upload_s = time.perf_counter() - t0
    up = gw.last_upload
    t0 = time.perf_counter()
    net.run_slots(1)
    check(rt.file_bank.deal(fh) is not None, "node: no deal after the upload")
    net.run_slots(2)
    f = rt.file_bank.file(fh)
    check(f is not None and f.state == "calculate",
          f"node: the file is not in 'calculate' after the transfers "
          f"({None if f is None else f.state})")
    node.submit_extrinsic("root", "file_bank.calculate_end", fh)
    net.run_slots(1)
    transfer_s = time.perf_counter() - t0
    f = rt.file_bank.file(fh)
    check(f.state == "active", f"node: the file is {f.state}, not active")
    by_name = {m.account: m for m in miners}
    check(all(fragment_hash(by_name[f.miners[row]].store[h]) == h
              for seg in f.segments
              for row, h in enumerate(seg.fragment_hashes)),
          "node: a miner's stored bytes do not hash to the on-chain "
          "fragment hashes")

    # the audit round, one fragment of one miner XORed with 0xA5 first
    victim = by_name[f.miners[0]]
    bad = f.segments[-1].fragment_hashes[0]
    victim.store[bad] = np.bitwise_xor(
        np.frombuffer(victim.store[bad], np.uint8), 0xA5).tobytes()
    for m in miners:
        timed(m, "_submit_proof", "proofs")
    timed(tee, "on_block", "checks")
    for k in wall:
        wall[k] = 0.0
    node.offchain_agents.extend([
        oc.ValidatorOcw("v0", spec.session_key("v0")),
        oc.ValidatorOcw("v1", spec.session_key("v1"))])
    challenged, seed, snaps, results, slots = None, None, {}, {}, 0
    t0 = time.perf_counter()
    while slots < 40:
        net.run_slots(1)
        slots += 1
        ch = rt.audit.challenge()
        if challenged is None and ch is not None:
            challenged = sorted(s.miner for s in ch.miners)
            seed = b"".join(ch.net.randoms)
            snaps = {s.miner: s for s in ch.miners}
        results = {dict(e.data)["miner"]: dict(e.data)
                   for e in rt.state.events_of("audit", "VerifyResult")}
        if challenged and sorted(results) == challenged:
            break
    round_s = time.perf_counter() - t0
    round_wall = dict(wall)
    check(challenged == sorted(names) and sorted(results) == challenged,
          f"node: the round did not verify every miner in {slots} slots "
          f"(challenged {challenged}, verified {sorted(results)})")
    verdicts = {w: (r["idle"], r["service"]) for w, r in results.items()}
    want = {w: (True, w != victim.account) for w in names}
    check(verdicts == want, f"node: verdicts {verdicts} != {want}")
    check(bool(rt.state.events_of("sminer", "RewardPaid")),
          "node: no reward was paid for the round")
    other = nodes[1].runtime
    recs = other.audit.verdicts()
    pk = other.tee_worker.worker("tee1").bls_pk
    check(len(recs) == len(names) and all(reverify_verdict(r, pk)
                                          for r in recs),
          "node: a sealed verdict does not re-verify on nodes[1]")
    check(len({n.runtime.state.state_root() for n in nodes}) == 1,
          "node: the replicas' state roots differ after the round")
    xts = [xt for h in node.chain[1:]
           for xt in node.bodies[h.hash()].extrinsics]
    proofs = {xt.signer: tuple(xt.args) for xt in xts
              if xt.call == "audit.submit_proof"}
    check(sorted(proofs) == sorted(names) and all(
        len(b) == oc.proof_wire_bytes() <= constants.SIGMA_MAX
        for pair in proofs.values() for b in pair),
        "node: a miner's proofs are missing or not of the wire size")
    out = {"fragment_hashes": up.fragment_hashes, "file_hash": fh,
           "proofs": proofs, "verdicts": verdicts, "slots": slots,
           "round_root": rt.state.state_root(), "round_block": rt.state.block,
           "round_s": round_s, "round_wall": round_wall,
           "setup_s": setup_s, "filler_s": filler_s, "upload_s": upload_s,
           "transfer_s": transfer_s, "upload_stages": dict(up.seconds),
           "seed": seed, "victim": victim.account, "snaps": snaps,
           "signed": len(xts)}

    if repair:
        out["repairs"] = []
        for row, mode in ((0, "fragments"), (1, "symbols")):
            frag = f.segments[0].fragment_hashes[row]
            lost = next(m for m in miners if frag in m.store)
            del lost.store[frag]
            lost.tags.pop(frag, None)
            node.submit_extrinsic(lost.account,
                                  "file_bank.generate_restoral_order", fh,
                                  frag)
            net.run_slots(1)
            check(rt.file_bank.restoral_order(frag) is not None,
                  f"node: no restoral order for row {row}")
            rescuer = next(m for m in miners if m.account not in f.miners) \
                if mode == "fragments" else lost
            rescuer.set_repair_mode(mode)
            before = (rescuer.repair_symbol_repairs,
                      rescuer.repair_whole_repairs)
            t0 = time.perf_counter()
            ok = rescuer.try_repair(frag, miners, [gw])
            ms = (time.perf_counter() - t0) * 1e3
            rescuer.set_repair_mode("fragments")
            after = (rescuer.repair_symbol_repairs,
                     rescuer.repair_whole_repairs)
            check(ok and fragment_hash(rescuer.store[frag]) == frag,
                  f"node: the {mode} repair of row {row} failed or does not "
                  f"hash to its identity")
            which = int(mode == "fragments")
            check(after[which] - before[which] == 1
                  and rescuer.repair_fallbacks == 0,
                  f"node: the {mode} repair took another path")
            net.run_slots(1)
            ev = rt.state.events_of("file_bank", "RestoralComplete")
            check(rt.file_bank.restoral_order(frag) is None and bool(ev)
                  and dict(ev[-1].data)["miner"] == rescuer.account,
                  f"node: RestoralComplete does not name the rescuer of row "
                  f"{row}")
            present = tuple(j for j in range(cfg.k + cfg.m) if j != row)
            out["repairs"].append((mode, row, present[:cfg.k], ms))
        check(len({n.runtime.state.state_root() for n in nodes}) == 1,
              "node: the replicas' state roots differ after the repairs")
        out["upload"] = up

    if rpc:
        import urllib.request

        from cess_tpu_torch.node.rpc import RpcServer

        node.engine = engine
        srv = RpcServer(node, port=0).start()
        try:
            def call(method, *params):
                req = json.dumps({"jsonrpc": "2.0", "id": 1,
                                  "method": method,
                                  "params": list(params)}).encode()
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{srv.port}", data=req,
                        headers={"Content-Type": "application/json"})) as r:
                    body = json.loads(r.read())
                check("error" not in body, f"node: RPC {method}: {body}")
                return body["result"]

            fin = call("chain_getFinalizedHead")
            check(fin == node.finalized > 0,
                  f"node: chain_getFinalizedHead {fin} != {node.finalized}")
            stats = call("cess_engineStats")
            batches = {c: stats["classes"][c]["batches"]
                       for c in ("encode", "tag", "prove", "verify")}
            check(all(b > 0 for b in batches.values()),
                  f"node: an engine class ran no batch: {batches}")
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics") as r:
                scrape = r.read().decode()
            families = sorted({ln.split()[2] for ln in scrape.splitlines()
                               if ln.startswith("# TYPE cess_engine_")})
            check(len(families) > 0, "node: GET /metrics has no "
                  "cess_engine_* family")
            out["rpc"] = {"finalized": fin, "batches": batches,
                          "codec": stats.get("codec"),
                          "families": len(families)}
        finally:
            srv.stop()
    return out


def node_cli(engine: str, rpc_port: int) -> dict:
    """``python -m cess_tpu_torch.node.cli --dev --blocks 20 --block-time
    0.1 --engine ENGINE --rpc-port P`` from the checkout; its
    ``cess_engineStats`` is polled once while it runs. "cpu" runs with no
    card visible (``CUDA_VISIBLE_DEVICES=""``), so nothing on its path can
    need one."""
    import os
    import urllib.request

    env = dict(os.environ)
    if engine == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    req = json.dumps({"jsonrpc": "2.0", "id": 1, "method": "cess_engineStats",
                      "params": []}).encode()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cess_tpu_torch.node.cli", "--dev",
         "--blocks", "20", "--block-time", "0.1", "--engine", engine,
         "--rpc-port", str(rpc_port)],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    stats = None
    try:
        while stats is None and proc.poll() is None:
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{rpc_port}", data=req,
                        headers={"Content-Type": "application/json"}),
                        timeout=5) as r:
                    stats = json.loads(r.read())["result"]
            except OSError:
                time.sleep(0.05)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return {"rc": proc.returncode, "stats": stats, "err": err,
            "done": "#20 " in err, "wall": time.perf_counter() - t0}


def node_phase(dev, zero_counts, counts, errs: dict, tag: str, cfg=None,
               nseg: int = 32, fillers: int = 4) -> dict:
    """The port's own storage network at the main path's width, with no
    test helper on it: the shape of the reference's ``storage_net``
    fixture (3 validator ``Node``s in one ``Network``; ``OssGateway`` gw,
    ``MinerAgent``s m1 to m4, ``TeeAgent`` tee1 with its BLS seed, two
    ``ValidatorOcw``s; its endowments, era, epoch and audit lives),
    RS(2,1) with 16 MiB segments and the key ``Podr2Key.generate(7)``,
    the agents on an ``AgentPipeline`` on the card. Setup as the fixture
    does it (TEE whitelist and registration with an RSA attestation and a
    BLS key, ``sminer.regnstk``, fillers certified on the card,
    ``buy_space``, ``oss.authorize``, ``create_bucket``, the reward pool
    funded), cut to ``fillers`` fillers of 8 MiB a miner (the fixture has
    400) and, on every replica, a genesis grant of the other 396 fillers'
    idle space (``buy_space`` and the deal need it); then ``gw.upload`` of
    ``nseg`` segments, the miners' fetches and reports, ``calculate_end``
    through a block; one stored fragment of a miner XORed with 0xA5; the
    validators' workers added, slots until every miner's
    ``audit.VerifyResult`` (honest true, the tampered service proof
    false, ``RewardPaid``, the verdicts re-verified on ``nodes[1]``, the
    replicas' state roots equal); a lost fragment repaired by
    "fragments", another by "symbols", each hashing to its identity and
    ``RestoralComplete`` naming the rescuer. Then the same network,
    upload and round with the gateway, miners and TEE on one port engine:
    every fragment hash, proof's wire bytes and verdict and the state root
    at the round's last block equal to the direct run's, and an
    ``RpcServer`` on ``nodes[0]`` answering ``chain_getFinalizedHead``,
    ``cess_engineStats`` and GET /metrics. Counters are zeroed before the
    first run and read after the second; then each kernel is held against
    its plain version at every shape the phase ran, the engine's from its
    program cache. Last, the CLI as a subprocess with ``--engine cuda``
    (its stats name a codec on the card) and ``--engine cpu`` (no card
    visible), each exiting 0 after block #20. A smaller ``cfg`` and
    ``nseg`` rehearse the phase on the CPU (where the "cuda" CLI run must
    fail). Returns the launches of the phase."""
    import numpy as np
    import torch
    from cess_tpu_torch.models.pipeline import PipelineConfig
    from cess_tpu_torch.node import offchain as oc
    from cess_tpu_torch.node.hashing import filler_bytes
    from cess_tpu_torch.ops import gf, podr2, podr2_kernel, prf, regen
    from cess_tpu_torch.ops import rs_kernel
    from cess_tpu_torch.serve import make_engine

    cfg = cfg or PipelineConfig()
    cuda = dev.type == "cuda"
    n, rows, blocks = cfg.fragment_size, cfg.k + cfg.m, cfg.blocks_per_fragment
    key = podr2.Podr2Key.generate(7, device=dev)
    data = rand_bytes((nseg * cfg.segment_size,), 93, dev).cpu().numpy(
        ).tobytes()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_phase = time.perf_counter()
    direct = storage_network(dev, cfg, key, data, fillers, repair=True)
    up = direct.pop("upload")
    backends = {} if cuda else {"rs_backend": "cpu", "audit_backend": "cpu"}
    eng = make_engine(cfg.k, cfg.m, podr2_key=key, **backends)
    try:
        via = storage_network(dev, cfg, key, data, fillers, engine=eng,
                              rpc=True)
        progs = list(eng.programs.keys())
    finally:
        eng.close()
    if cuda:
        torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    check(all(launches[k] > 0 for k in ("gf_apply", "prf_blocks",
                                        "podr2_tag")),
          f"node: a kernel was not launched by the node: {launches}")
    for what in ("fragment_hashes", "file_hash", "proofs", "verdicts",
                 "round_root", "round_block", "slots"):
        check(via[what] == direct[what], f"node: the engine run's {what} "
              f"differs from the direct run's")

    # each kernel at every shape the phase ran, against its plain version
    def held(name, got, plain):
        e = max_err(got, plain)
        errs[name] = max(errs[name], e)
        check(e == 0, f"node: {name} at {tuple(got.shape)} differs from "
              f"its plain version")

    shapes = []
    seg_t = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(
        dev).view(nseg, cfg.k, n)

    def gf_at(mat, x, what):
        tab = rs_kernel.tables(np.asarray(mat, np.uint8), dev)
        held("gf_apply", rs_kernel.gf_apply(tab, x),
             rs_kernel.gf_apply_plain(tab, x))
        shapes.append(f"gf_apply {what} {tuple(x.shape)}")

    gf_at(gf.cauchy_parity_matrix(cfg.k, cfg.m), seg_t, "encode")
    frags_t = torch.from_numpy(np.array(up.fragments)).to(dev)
    for mode, row, present, _ in direct["repairs"]:
        surv = frags_t[:1, list(present)]
        if mode == "fragments":
            gf_at(gf.repair_matrix(cfg.k, cfg.m, present, (row,)), surv,
                  f"repair {present}->{row}")
            continue
        for p, c in enumerate(regen.repair_coeffs(cfg.k, cfg.m, present,
                                                  (row,))):
            pair = torch.stack([frags_t[0, present[0]],
                                frags_t[0, present[p]]])[None]
            gf_at(np.array([[1, c]]), pair, f"fold {c}")
    ids_t = torch.from_numpy(up.ids.reshape(-1, 2).astype(np.int64)).to(dev)
    snap = direct["snaps"][direct["victim"]]
    fill_ids = torch.from_numpy(np.stack([
        podr2.fragment_id_from_hash(h) for h in snap.fillers]).astype(
            np.int64)).to(dev)
    fill_t = torch.from_numpy(np.stack([np.frombuffer(filler_bytes(
        direct["victim"], i, n), np.uint8) for i in range(fillers)])).to(dev)
    every = torch.arange(blocks, device=dev)
    for ids, fr in ((ids_t, frags_t.view(-1, n)), (fill_ids, fill_t)):
        prf_lm = podr2_kernel.prf_blocks(key.prf_key, ids, None, blocks,
                                         key.limbs, limb_major=True)
        held("prf_blocks", prf_lm, prf.prf_plain(key.prf_key, ids, every,
                                                 key.limbs).transpose(1, 2))
        fb = fr.reshape(-1, blocks, podr2.BLOCK_BYTES)
        held("podr2_tag", podr2_kernel.podr2_tag(key.weights, prf_lm, fb),
             podr2_kernel.podr2_tag_plain(key.weights, prf_lm, fb))
        shapes.append(f"prf_blocks (limb-major) and podr2_tag "
                      f"{ids.shape[0]} x {blocks}")
        del prf_lm, fb
    idx = podr2.gen_challenge(direct["seed"], blocks, device=dev)[0]
    owed_ids = torch.from_numpy(np.stack([
        podr2.fragment_id_from_hash(h) for h in snap.service_frags]).astype(
            np.int64)).to(dev)
    for ids in (owed_ids, fill_ids):
        held("prf_blocks", podr2_kernel.prf_blocks(
            key.prf_key, ids, idx, idx.numel(), key.limbs),
            prf.prf_plain(key.prf_key, ids, idx, key.limbs))
        shapes.append(f"prf_blocks {ids.shape[0]} x {idx.numel()}")
    del fill_t
    engine_shapes = serve_kernel_checks(
        progs, oc.AgentPipeline(cfg, podr2_key=key, device=dev).pipeline,
        dev, [seg_t], [frags_t], [owed_ids, fill_ids], idx,
        0, errs, "node")
    del seg_t, frags_t
    if cuda:
        torch.cuda.empty_cache()

    # the CLI as a subprocess
    cli = {}
    for engine in ("cuda", "cpu"):
        r = node_cli(engine, _free_port())
        if engine == "cuda" and not cuda:
            check(r["rc"] != 0, "node: the CLI's --engine cuda ran without "
                  "a card")
            continue
        check(r["rc"] == 0 and r["done"],
              f"node: the CLI with --engine {engine} exited {r['rc']} "
              f"before #20: {r['err'][-2000:]}")
        got = ((r["stats"] or {}).get("codec") or {}).get("device", "")
        check(got.startswith(engine),
              f"node: the CLI's cess_engineStats names codec device "
              f"{got!r}, not {engine}")
        cli[engine] = (r["wall"], got)

    split = ", ".join(f"{k} {v * 1e3:.3f} ms"
                      for k, v in direct["upload_stages"].items())

    def walls(w):
        return ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in w.items())

    reps = ", ".join(f"{mode} (row {row} from {present}) {ms:.3f} ms"
                     for mode, row, present, ms in direct["repairs"])
    clis = ", ".join(f"--engine {e} {w:.3f} s (codec on {c})"
                     for e, (w, c) in cli.items())
    print(f"phase node: 3 validator nodes, gateway, 4 miners, TEE, 2 OCWs; "
          f"RS(2,1) upload of {nseg} x {cfg.segment_size // MIB} MiB "
          f"segments ({nseg * rows} fragments of {n // MIB} MiB) "
          f"{direct['upload_s'] * 1e3:.3f} ms ({split}), fetched, reported "
          f"and made active over 4 slots {direct['transfer_s'] * 1e3:.3f} "
          f"ms; setup {direct['setup_s'] * 1e3:.3f} ms ({fillers} fillers a "
          f"miner certified on the device {direct['filler_s'] * 1e3:.3f} "
          f"ms); the round: {direct['slots']} slots to the verdict, "
          f"{direct['round_s'] * 1e3:.3f} ms, host wall by agent: "
          f"{walls(direct['round_wall'])}; verdicts "
          f"{sorted(direct['verdicts'].items())} (tampered "
          f"{direct['victim']}), re-verified on nodes[1], replicas' roots "
          f"equal; repairs {reps}; through the engine: round "
          f"{via['round_s'] * 1e3:.3f} ms ({walls(via['round_wall'])}), "
          f"fragment hashes, {len(via['proofs']) * 2} proofs' wire bytes, "
          f"verdicts and the round's state root equal to the direct run's; "
          f"RPC finalized #{via['rpc']['finalized']}, engine batches "
          f"{via['rpc']['batches']}, codec {via['rpc']['codec']}, "
          f"{via['rpc']['families']} cess_engine_* families; CLI {clis}, "
          f"exit 0 after #20; {direct['signed']} extrinsics in the direct "
          f"chain; peak {peak / MIB:.1f} MiB; phase wall "
          f"{phase_s * 1e3:.3f} ms; state_root "
          f"{direct['round_root'].hex()} at block {direct['round_block']}; "
          f"kernels byte-exact against their plain versions at the phase's "
          f"shapes: {', '.join(shapes)}; at the engine's: {engine_shapes}; "
          f"launches {launches} {tag}")
    return launches


class _Clocked:
    """Host walls of every call of ``cls.name`` while armed (a context
    manager that patches the class and restores it)."""

    def __init__(self, cls, name: str):
        self.cls, self.name, self.walls = cls, name, []

    def __enter__(self):
        fn = self.fn = getattr(self.cls, self.name)
        walls = self.walls

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                walls.append(time.perf_counter() - t0)
        setattr(self.cls, self.name, run)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.fn)


def _pool_counts(snap):
    """A pool snapshot without its lanes' device type (the counts a run
    on other devices must reproduce)."""
    if snap is None:
        return None
    return {**snap, "lanes": [{k: v for k, v in lane.items()
                               if k != "platform"} for lane in snap["lanes"]]}


def sim_phase(dev, zero_counts, counts, errs: dict, tag: str,
              segment_size: int | None = None) -> dict:
    """The port's simulated network (``cess_tpu_torch.sim``) on the card.

    (a) Full width: ``run_scenario`` of the library's ``adversarial_audit``
    (``dataclasses.replace``: 100 nodes, 5 validators, 4 miners of which
    m1 and m2 store their fragments XORed with 0xA5, 30 rounds,
    ``finalized-prefix`` and ``vote-locks`` every round and
    ``audit-soundness`` at the end, all as the library has them) with
    ``devices=[card]`` and these cuts of the library's test sizes: RS(2,1)
    segments of ``constants.SEGMENT_SIZE`` (16 MiB, fragments and fillers
    of the protocol's 8 MiB) instead of 16 KiB; the round-1 upload 32
    segments (512 MiB, 96 fragments) instead of 20 000 bytes; and 32
    fillers a miner instead of 40 (4 x 32 x 8 MiB is the 1 GiB the
    scenario's ``buy_space`` needs). Counters are zeroed just before the
    run and read just after: ``gf_apply``, ``podr2_tag`` and
    ``prf_blocks`` must launch, ``gf_xor`` must not. The file's deal
    takes 3 of the 4 miners: each assigned adversarial miner's latest
    service verdict must be false, every other miner's (honest, or
    owing no service fragment) true, every idle verdict true. Each launched kernel is then held against its plain
    version at the phase's shapes: the upload's encode, the tags of its
    96 fragments and of one miner's fillers, and the PRF at a challenge's
    blocks for a miner's owed fragments and fillers.
    (b) The kernels against their plain versions at system level:
    ``adversarial_audit``, ``repair_storm`` (its 3-lane pool on the card
    listed 3 times) and ``miner_attrition`` at the library's test width
    (20 nodes, the scenarios' own sizes), on the card and on 8 host
    devices: each pair's ``SimReport.witness()`` equal and its pool's
    counts equal.
    A smaller ``segment_size`` rehearses the phase on the CPU. Returns
    the launches of (a)."""
    import dataclasses

    import numpy as np
    import torch
    from cess_tpu_torch import constants
    from cess_tpu_torch.node import offchain as oc
    from cess_tpu_torch.ops import gf, podr2, podr2_kernel, prf, rs_kernel
    from cess_tpu_torch.sim import SCENARIOS, World, run_scenario
    from cess_tpu_torch.sim import scenarios as sim_scenarios

    n_nodes, nseg, fillers = 100, 32, 32
    cuda = dev.type == "cuda"
    seg = segment_size or constants.SEGMENT_SIZE
    base = SCENARIOS["adversarial_audit"]
    check(base.world == (("n_validators", 5), ("storage", (
        ("n_miners", 4), ("adversarial_miners", (1, 2))))) and
        base.timeline == ((1, "upload", 0, "alice", 20_000),),
        "sim: the library's adversarial_audit changed; revisit the cuts")
    storage = (("n_miners", 4), ("adversarial_miners", (1, 2)),
               ("segment_size", seg), ("fillers_per_miner", fillers))
    sc = dataclasses.replace(
        base, world=(("n_validators", 5), ("storage", storage)),
        timeline=((1, "upload", 0, "alice", nseg * seg),))

    # (a) full width ---------------------------------------------------------
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_phase = time.perf_counter()
    with _Clocked(sim_scenarios, "_build_world") as build_c, \
            _Clocked(oc.MinerAgent, "setup_fillers") as fill_c, \
            _Clocked(sim_scenarios, "_seeded_blob") as blob_c, \
            _Clocked(oc.OssGateway, "upload") as up_c, \
            _Clocked(World, "run_round") as round_c, \
            _Clocked(sim_scenarios, "_drive_uploads") as drive_c, \
            _Clocked(sim_scenarios, "run_checks") as checks_c:
        report = run_scenario(sc, b"chip-sim", n_nodes=n_nodes,
                              devices=[dev])
    if cuda:
        torch.cuda.synchronize()
    full_s = time.perf_counter() - t_phase
    launches = counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    check(all(launches[k] > 0 for k in ("gf_apply", "podr2_tag",
                                        "prf_blocks"))
          and launches["gf_xor"] == 0,
          f"sim: the world's kernels were not launched as expected: "
          f"{launches}")
    world = report.world
    check(report.rounds_run == sc.rounds and report.uploads_active == 1,
          f"sim: {report.rounds_run} rounds, {report.uploads_active} files "
          f"active")
    node = world.nodes[0]
    st = node.runtime.state
    (fh, f), = st.iter_prefix("file_bank", "file")
    check(f.state == "active" and len(f.segments) == nseg,
          f"sim: the upload is {f.state} with {len(f.segments)} segments")
    adversarial = {f"m{j}" for j in world.storage.adversarial_miners}
    hist = [(b, dict(e.data)) for b, e in st.event_history
            if (e.pallet, e.name) == ("audit", "VerifyResult")]
    latest = {d["miner"]: d for _, d in hist}
    want = {m: not (m in adversarial and m in f.miners)
            for m in (f"m{j}" for j in range(world.storage.n_miners))}
    check({m: d["service"] for m, d in latest.items()} == want
          and all(d["idle"] for d in latest.values()),
          f"sim: verdicts {latest} (deal {f.miners}), want service {want}")
    declared = min(b for b, e in st.event_history
                   if (e.pallet, e.name) == ("file_bank",
                                             "UploadDeclaration"))
    failed = min(b for b, d in hist if not d["service"])

    def slot(b):
        return node.chain[b].claim.slot

    slots_to_verdict = slot(failed) - slot(declared)
    rounds = round_c.walls[-sc.rounds:]
    setup_s = sum(round_c.walls[:-sc.rounds])
    # the full-width run's wall, split: the world's build (its set-up
    # rounds and the filler streams inside it), the blob, the upload, the
    # scenario's rounds, the uploads' driving, the invariant checks, and
    # the rest (scrapes, the planes' set-up)
    split = {"build": sum(build_c.walls), "blob": sum(blob_c.walls),
             "upload": sum(up_c.walls), "rounds": sum(rounds),
             "drive": sum(drive_c.walls), "checks": sum(checks_c.walls)}
    split["rest"] = full_s - sum(split.values())

    # each kernel at the phase's shapes, against its plain version
    cfg = world.pipeline.config
    key = world.pipeline.podr2_key
    n, blocks = cfg.fragment_size, cfg.blocks_per_fragment
    shapes = []

    def held(name, got, plain):
        e = max_err(got, plain)
        errs[name] = max(errs[name], e)
        check(e == 0, f"sim: {name} at {tuple(got.shape)} differs from "
              f"its plain version")

    up = world.gateways[0].last_upload
    frags_t = torch.from_numpy(np.array(up.fragments)).to(dev)
    seg_t = frags_t[:, :cfg.k].contiguous()
    tab = rs_kernel.tables(gf.cauchy_parity_matrix(cfg.k, cfg.m), dev)
    held("gf_apply", rs_kernel.gf_apply(tab, seg_t),
         rs_kernel.gf_apply_plain(tab, seg_t))
    shapes.append(f"gf_apply encode {tuple(seg_t.shape)}")
    del seg_t
    miner = next(m for m in world.miners if m.account in f.miners)
    ids_t = torch.from_numpy(up.ids.reshape(-1, 2).astype(np.int64)).to(dev)
    fill_h = sorted(miner.filler_store)
    fill_ids = torch.from_numpy(np.stack([
        podr2.fragment_id_from_hash(h) for h in fill_h]).astype(
            np.int64)).to(dev)
    fill_t = torch.from_numpy(np.stack([np.frombuffer(
        miner.filler_store[h], np.uint8) for h in fill_h])).to(dev)
    every = torch.arange(blocks, device=dev)
    for ids, fr in ((ids_t, frags_t.view(-1, n)), (fill_ids, fill_t)):
        prf_lm = podr2_kernel.prf_blocks(key.prf_key, ids, None, blocks,
                                         key.limbs, limb_major=True)
        held("prf_blocks", prf_lm, prf.prf_plain(key.prf_key, ids, every,
                                                 key.limbs).transpose(1, 2))
        fb = fr.reshape(-1, blocks, podr2.BLOCK_BYTES)
        held("podr2_tag", podr2_kernel.podr2_tag(key.weights, prf_lm, fb),
             podr2_kernel.podr2_tag_plain(key.weights, prf_lm, fb))
        shapes.append(f"prf_blocks (limb-major) and podr2_tag "
                      f"{ids.shape[0]} x {blocks}")
        del prf_lm, fb
    del frags_t, fill_t
    idx = podr2.gen_challenge(b"chip-sim-round", blocks, device=dev)[0]
    owed = torch.from_numpy(np.stack([
        podr2.fragment_id_from_hash(h) for h in sorted(miner.store)]).astype(
            np.int64)).to(dev)
    for ids in (owed, fill_ids):
        held("prf_blocks", podr2_kernel.prf_blocks(
            key.prf_key, ids, idx, idx.numel(), key.limbs),
            prf.prf_plain(key.prf_key, ids, idx, key.limbs))
        shapes.append(f"prf_blocks {ids.shape[0]} x {idx.numel()}")
    del report, world, node, st, up, miner
    if cuda:
        torch.cuda.empty_cache()

    # (b) the card against the host at the library's test width ------------
    pairs = []
    zero_counts()
    for name, lanes in (("adversarial_audit", 1), ("repair_storm", 3),
                        ("miner_attrition", 1)):
        walls = []
        reps = []
        for devices in ([dev] * lanes, ["cpu"] * 8):
            t0 = time.perf_counter()
            reps.append(run_scenario(SCENARIOS[name], b"chip-sim-pair",
                                     n_nodes=20, devices=devices))
            walls.append(time.perf_counter() - t0)
        card_r, host_r = reps
        check(card_r.witness() == host_r.witness(),
              f"sim: {name}'s witness on {dev} differs from the host's")
        check(_pool_counts(card_r.pool) == _pool_counts(host_r.pool),
              f"sim: {name}'s pool counts on {dev} differ from the host's: "
              f"{card_r.pool} != {host_r.pool}")
        pool = "" if card_r.pool is None else (
            f", pool {card_r.pool['n_devices']} lanes "
            f"{[ln['batches'] for ln in card_r.pool['lanes']]} batches")
        pairs.append(f"{name} {walls[0]:.3f} s on {dev} x {lanes}, "
                     f"{walls[1]:.3f} s on the host{pool}")
        del reps, card_r, host_r
    launches_b = counts()
    check(not cuda or all(launches_b[k] > 0 for k in ("gf_apply",
                                                       "podr2_tag",
                                                       "prf_blocks")),
          f"sim: the card's test-width runs launched {launches_b}")
    phase_s = time.perf_counter() - t_phase
    ms = statistics.median(rounds) * 1e3
    print(f"phase sim: adversarial_audit at {n_nodes} nodes (5 validators, "
          f"4 miners, m1 and m2 adversarial) on {dev}, RS(2,1) upload of "
          f"{nseg} x {seg / MIB:g} MiB "
          f"segments ({nseg * (cfg.k + cfg.m)} fragments), {fillers} "
          f"fillers a miner; {sc.rounds} rounds, "
          f"audit-soundness held; deal {list(f.miners)}, latest service "
          f"verdicts {sorted((m, d['service']) for m, d in latest.items())}"
          f", {len(hist)} verdicts; {slots_to_verdict} slots from the "
          f"declaration (block {declared}) to the first failed verdict "
          f"(block {failed}); the full-width wall split (ms): "
          f"{', '.join(f'{k} {v * 1e3:.3f}' for k, v in split.items())}; "
          f"filler streams {sum(fill_c.walls) * 1e3:.3f} ms "
          f"({len(fill_c.walls)} miners, inside build); setup rounds "
          f"{setup_s * 1e3:.3f} ms (inside build); the scenario's "
          f"rounds {sum(rounds) * 1e3:.3f} ms (median {ms:.3f}, max "
          f"{max(rounds) * 1e3:.3f}); peak {peak / MIB:.1f} MiB; full-width "
          f"wall {full_s * 1e3:.3f} ms; kernels byte-exact against their "
          f"plain versions at {', '.join(shapes)}; launches {launches}; "
          f"card against host at 20 nodes, witnesses and pool counts "
          f"equal: {'; '.join(pairs)}; launches there {launches_b}; phase "
          f"wall {phase_s * 1e3:.3f} ms {tag}")
    return launches


def native_phase(dev, data, tab, tag: str) -> str:
    """The C++ host codec (``ops/rs_native.py``) beside the card: RS(4,8)
    parity of ``data`` [B, 4, n] (on the card) on 1 thread and on
    ``os.cpu_count()`` threads, and the decode of the data from four
    parity fragments, byte-equal to ``gf_apply``'s output on the card and
    to ``TorchCodec(4, 8, "cpu")`` on a slice; GiB/s of input on each
    side and their ratio, ``bench.py``'s CPU-speedup measure. A
    measurement, not a gate. Returns the line."""
    import os

    import numpy as np
    import torch
    from cess_tpu_torch.ops import rs_kernel
    from cess_tpu_torch.ops.rs import TorchCodec, make_codec
    from cess_tpu_torch.ops.rs_native import NativeCodec, simd_level

    check(isinstance(make_codec(4, 8, "native"), NativeCodec),
          "native: make_codec(4, 8, 'native') is not NativeCodec")
    host = data.cpu().numpy()
    nbytes = host.nbytes
    threads = os.cpu_count() or 1
    out = torch.empty((data.shape[0], 8, data.shape[2]), dtype=torch.uint8,
                      device=dev)
    card = rs_kernel.gf_apply(tab, data, out=out).cpu().numpy()
    rates, parity = {}, None
    for nt in (1, threads):
        codec = NativeCodec(4, 8, threads=nt)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = codec.encode_parity(host)
            times.append(time.perf_counter() - t0)
        check(np.array_equal(got, card),
              f"native: {nt}-thread parity differs from gf_apply's")
        rates[nt] = nbytes / min(times) / 2 ** 30
        parity = got
    decoded = NativeCodec(4, 8, threads=threads).decode_data(
        parity[:, :4], (4, 5, 6, 7))
    check(np.array_equal(decoded, host),
          "native: the decode from four parity fragments differs")
    piece = host[:2, :, :256 * 1024]
    want = TorchCodec(4, 8, "cpu").encode(torch.from_numpy(piece)).numpy()
    check(np.array_equal(want[:, 4:], card[:2, :, :256 * 1024]),
          "native: TorchCodec on the CPU differs from gf_apply on a slice")
    dev_ms = graph_ms(lambda: rs_kernel.gf_apply(tab, data, out=out))
    dev_gibps = nbytes / (dev_ms / 1e3) / 2 ** 30
    del out
    line = (f"phase native: RS(4,8) parity of {tuple(host.shape)} "
            f"({nbytes // MIB} MiB) by NativeCodec (SIMD level "
            f"{simd_level()}: 2 is the AVX2 build) {rates[1]:.3f} GiB/s on 1 "
            f"thread, {rates[threads]:.3f} GiB/s on {threads} threads (best "
            f"of 3), byte-equal to gf_apply on the card and to "
            f"TorchCodec(4, 8, 'cpu') on a slice, decode from parity rows "
            f"(4, 5, 6, 7) byte-exact; gf_apply {dev_gibps:.3f} GiB/s (device "
            f"{dev_ms:.4f} ms); cpu_speedup_encode_x (bench.py:5, device over "
            f"1-thread native) {dev_gibps / rates[1]:.1f}x, over "
            f"{threads} threads {dev_gibps / rates[threads]:.1f}x {tag}")
    print(line)
    return line


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

    # 7. agents: the off-chain agents' device half at the main path's width
    launches_agents = agents_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 8. mesh: the sharded data plane, the card listed more than once
    launches_mesh = mesh_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 9. pool: the engine over a two-lane device pool on the card
    launches_pool = pool_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 10. slo: the engine's control planes at the main path's width
    launches_slo = slo_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 11. remediate: the remediation loop on the engine's and lanes' breakers
    launches_remediate = remediate_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 12. chain: one audit round from the card's encode to the chain -----
    launches_chain = chain_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 13. node: the port's storage network through its own node ----------
    launches_node = node_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 14. sim: the simulated network on the card at full width -----------
    launches_sim = sim_phase(dev, zero_counts, counts, errs, tag)
    torch.cuda.empty_cache()

    # 15. BASELINE geometry RS(4,8) ---------------------------------------
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

    # 16. the xor path: RS(4,8) under strategy "xor", audited and repaired -
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

    # 17. known answer ------------------------------------------------------
    for strategy in (None, "xor"):
        digest, kat_ok = kat.run_port(dev, strategy)
        check(kat_ok, f"known-answer proof did not verify ({strategy})")
        check(digest == kat.DIGEST,
              f"known-answer digest {digest} != {kat.DIGEST} ({strategy})")
    print(f"phase kat: digest {digest} matches the TPU package's, dense and "
          f"xor")

    # 18. kernel times at the main paths' shapes --------------------------
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
            "launches_agents": launches_agents.get(name, 0),
            "launches_mesh": launches_mesh.get(name, 0),
            "launches_pool": launches_pool.get(name, 0),
            "launches_slo": launches_slo.get(name, 0),
            "launches_remediate": launches_remediate.get(name, 0),
            "launches_chain": launches_chain.get(name, 0),
            "launches_node": launches_node.get(name, 0),
            "launches_sim": launches_sim.get(name, 0),
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
    # 19. native: the C++ host codec beside the card on the same bytes --
    native_phase(dev, datax, tab48, tag)
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
