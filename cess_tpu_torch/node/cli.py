"""Node CLI (reference: node/src/cli.rs + command.rs: run, key tools
(key/sign/verify), build-spec, check/export/import/revert blocks).

  python -m cess_tpu_torch.node.cli --dev --blocks 20 --rpc-port 9944
  python -m cess_tpu_torch.node.cli --chain local --validator val0 \
      --port 30333 --peers 30334,30335 --genesis-time 1700000000
  python -m cess_tpu_torch.node.cli --chain local --validators 4 --blocks 50
  python -m cess_tpu_torch.node.cli build-spec --chain dev
  python -m cess_tpu_torch.node.cli key --suri my-seed
  python -m cess_tpu_torch.node.cli sign --suri my-seed --message 0xdead
  python -m cess_tpu_torch.node.cli verify --public 0x.. --message 0x.. --signature 0x..
  python -m cess_tpu_torch.node.cli export-blocks --dev --base-path data --to chain.blocks
  python -m cess_tpu_torch.node.cli import-blocks --dev --base-path data2 --from chain.blocks
  python -m cess_tpu_torch.node.cli revert --dev --base-path data --blocks 3
  python -m cess_tpu_torch.node.cli check-block --dev --base-path data --number 5
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ..crypto import ed25519
from .chain_spec import dev_spec, local_spec, spec_from_json, spec_to_json
from .network import Network, Node
from .rpc import RpcServer


def _load_spec(chain: str, validators: int):
    """dev | local | path-to-exported-spec.json (reproducible
    genesis, chain_spec.rs:318-434 analog)."""
    if chain == "dev":
        return dev_spec()
    if chain == "local":
        return local_spec(validators)
    with open(chain) as f:
        return spec_from_json(json.load(f))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cess-tpu-torch-node")
    ap.add_argument("subcommand", nargs="?", default="run",
                    choices=["run", "build-spec", "key", "sign",
                             "verify", "export-blocks", "import-blocks",
                             "revert", "check-block", "vanity",
                             "benchmark", "try-runtime"])
    ap.add_argument("--dev", action="store_true",
                    help="single-authority dev chain")
    ap.add_argument("--chain", default="dev",
                    help="dev | local | path to an exported spec JSON")
    ap.add_argument("--validators", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=0,
                    help="produce N blocks then exit (0 = run forever)")
    ap.add_argument("--block-time", type=float, default=0.0,
                    help="seconds between slots (0 = as fast as possible)")
    ap.add_argument("--rpc-port", type=int, default=0,
                    help="serve JSON-RPC on this port (0 = off)")
    ap.add_argument("--base-path", default=None,
                    help="persist chain data here and resume on restart")
    ap.add_argument("--suri", default="dev-seed", help="key seed material")
    ap.add_argument("--message", default="0x", help="hex payload (sign/verify)")
    ap.add_argument("--public", default="", help="hex public key (verify)")
    ap.add_argument("--signature", default="", help="hex signature (verify)")
    ap.add_argument("--to", default="chain.blocks", help="export target file")
    ap.add_argument("--from", dest="from_file", default="chain.blocks",
                    help="import source file")
    ap.add_argument("--number", type=int, default=None,
                    help="block (check-block; default: head)")
    ap.add_argument("--port", type=int, default=0,
                    help="run ONE node over TCP gossip on this port "
                         "(production shape: one process per node)")
    ap.add_argument("--peers", default="",
                    help="comma-separated peer ports (TCP mode)")
    ap.add_argument("--validator", default="",
                    help="which genesis validator key this node holds "
                         "(TCP mode; empty = full node, no authoring)")
    ap.add_argument("--genesis-time", type=float, default=0.0,
                    help="shared slot-numbering wall-clock origin (TCP "
                         "mode). Epoch numbering anchors at the first "
                         "block's slot, so 0 (absolute unix slots) "
                         "works; matching values across nodes keeps "
                         "slot numbers aligned")
    ap.add_argument("--slot-time", type=float, default=6.0,
                    help="seconds per slot (TCP mode; ref block time 6s)")
    ap.add_argument("--pattern", default="",
                    help="hex prefix the public key must start with "
                         "(vanity)")
    ap.add_argument("--reps", type=int, default=20,
                    help="dispatches per benchmark sample")
    ap.add_argument("--telemetry", default="",
                    help="stream per-block telemetry JSON lines to "
                         "this host:port endpoint")
    ap.add_argument("--engine", default="off",
                    choices=["off", "cpu", "auto", "cuda"],
                    help="attach a device submission engine "
                         "(cess_tpu_torch/serve) as node.engine: dynamic "
                         "micro-batching for the RS encode/repair hot "
                         "paths with the chosen ErasureCodec backend, "
                         "used by storage drivers embedding this node. "
                         "The PoDR2 classes (tag/prove/verify) need "
                         "the holder's secret key, so they activate "
                         "only on engines the TEE/miner drivers build "
                         "themselves (serve.make_engine(podr2_key=...))"
                         ". Engine queue/batch/latency counters appear "
                         "under cess_engine_* on GET /metrics and via "
                         "the cess_engineStats RPC. 'cuda' and 'auto' "
                         "build the engine on the card and raise "
                         "without one; 'cpu' is the host reference. "
                         "'off' (default) keeps every caller on the "
                         "direct synchronous path")
    ap.add_argument("--trace", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="arm the request-scoped tracer (cess_tpu_torch/obs) "
                         "for this run: spans from the pipeline / "
                         "engine / stream / resilience / net seams "
                         "are collected in a bounded ring, served "
                         "live via the cess_traceDump RPC, and — "
                         "with --trace=PATH — written on exit as "
                         "Chrome trace-event JSON (open it in "
                         "Perfetto or chrome://tracing). Without the "
                         "flag every trace hook is a no-op")
    ap.add_argument("--flight", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="arm the flight recorder (cess_tpu_torch/obs/"
                         "flight.py) over the --trace tracer: "
                         "tail-sampled trace retention (anomalous "
                         "traces pinned past ring eviction plus a "
                         "seeded baseline), black-box journals, and "
                         "an IncidentReporter whose bundles are "
                         "served live via the cess_incidentDump RPC "
                         "and — with --flight=DIR — written on exit "
                         "as one JSON file per incident (render with "
                         "tools/incident_view.py). Requires --trace; "
                         "absent = zero-cost off")
    ap.add_argument("--fleet", action="store_true",
                    help="arm the fleet observability plane "
                         "(cess_tpu_torch/obs/fleet.py) on this node: the "
                         "gossip layer exchanges scrape contributions "
                         "with peers every few slots and the node "
                         "federates them — instance-labeled metric "
                         "federation with counter-reset clamping, a "
                         "global per-class SLO view (worst-of + "
                         "quorum), cross-node trace stitching and MAD "
                         "straggler detection — served via the "
                         "cess_fleetStatus RPC (render with "
                         "tools/fleet_view.py). With --flight, "
                         "incident bundles gain the stitched "
                         "cross-node trace view. Absent = zero-cost "
                         "off (the --trace contract)")
    ap.add_argument("--chainwatch", action="store_true",
                    help="arm the chain-plane observability watch "
                         "(cess_tpu_torch/obs/chainwatch.py) on this node: "
                         "per-node consensus health (finality lag, "
                         "reorg depth, fork counts, vote-lock ages, "
                         "a block/vote equivocation detector with "
                         "offences-shaped evidence records), the "
                         "storage-market ledger (audit pass/fail "
                         "spikes, declared-vs-audited capacity "
                         "drift, restoral-auction accounting) and "
                         "edge-triggered chain anomalies (finality-"
                         "stall / deep-reorg / equivocation / audit-"
                         "failure-spike incident triggers) — served "
                         "via the cess_chainStatus RPC and as "
                         "cess_chain_* gauges on GET /metrics "
                         "(render with tools/chain_view.py). With "
                         "--fleet, chain health rides the fleet "
                         "gossip and peers fold per-node finality "
                         "lag into their quorum views. Absent = "
                         "zero-cost off (the --trace contract)")
    ap.add_argument("--remediate", nargs="?", const="act",
                    default=None, choices=["act", "dry"],
                    help="arm the remediation plane "
                         "(cess_tpu_torch/serve/remediate.py) on this "
                         "node: a count-sequenced policy engine that "
                         "subscribes to the --flight recorder's "
                         "detector edges (perf regressions, breaker "
                         "trips, fleet stragglers, chain anomalies) "
                         "and maps each through a declarative policy "
                         "table to a journaled recovery action — pin "
                         "a class to the reference backend, "
                         "quarantine a pool lane, file an "
                         "equivocation offence, flip a miner's "
                         "repair mode — with count-based cooldowns, "
                         "rate limits and release conditions. "
                         "'--remediate=dry' journals every decision "
                         "without acting. Served via the "
                         "cess_remediationStatus RPC and "
                         "cess_remediation_* gauges on GET /metrics "
                         "(render with tools/remediation_view.py). "
                         "Requires --flight; absent = zero-cost off "
                         "(the --trace contract)")
    ap.add_argument("--custody", action="store_true",
                    help="arm the durability plane "
                         "(cess_tpu_torch/obs/custody.py) on this node: a "
                         "bounded per-segment custody ledger fed by "
                         "the --flight recorder's lineage notes "
                         "(gateway dispatch, fragment transfer, TEE "
                         "audit verdict, repair completion), folded "
                         "into live erasure margins every few slots "
                         "with edge-triggered custody.at_risk / "
                         "custody.lost announcements. With "
                         "--remediate the at-risk edge drives the "
                         "proactive-repair policy. Served via the "
                         "cess_custodyStatus RPC and cess_custody_* "
                         "gauges on GET /metrics (render with "
                         "tools/custody_view.py). Requires --flight; "
                         "absent = zero-cost off (the --trace "
                         "contract)")
    ap.add_argument("--slo", nargs="?", const="", default=None,
                    metavar="TARGETS",
                    help="attach an SLO board (cess_tpu_torch/obs/slo.py) to "
                         "the --engine: burn-rate monitors over the "
                         "live per-class latency/error signal, "
                         "per-tenant accounting, and weighted-fair "
                         "dequeue. TARGETS is ';'-separated "
                         "<class>:p99=<dur>[,err=<rate>] (e.g. "
                         "'verify:p99=50ms,err=1%%;encode:p99=2s'); "
                         "omitted = the default targets. Gauges "
                         "appear as cess_slo_*/cess_tenant_* on GET "
                         "/metrics and via the cess_sloStatus RPC. "
                         "Requires --engine; absent = zero-cost off "
                         "(the --trace contract)")
    ap.add_argument("--adaptive", action="store_true",
                    help="trace-driven adaptive control "
                         "(cess_tpu_torch/serve/adaptive.py) over the "
                         "--engine: per-class batching knobs tuned "
                         "from the live latency histograms "
                         "(occupancy-targeting replaces the static "
                         "BatchPolicy constants), and — with --slo — "
                         "deadline-aware admission that sheds or "
                         "CPU-degrades encode-class load while a "
                         "verify-class SLO is burning (extends the "
                         "--resilience breaker from 'device broken' "
                         "to 'SLO at risk'). Requires --engine and "
                         "--slo (the board's targets steer the "
                         "tuner)")
    ap.add_argument("--pool", nargs="?", const=0, type=int,
                    default=None, metavar="N",
                    help="shard the --engine across the local device "
                         "mesh (cess_tpu_torch/serve/pool.py): a DevicePool "
                         "routes op-class batches over per-device "
                         "worker lanes — deterministic least-loaded "
                         "placement, per-(backend, device) breakers "
                         "(with --resilience: one sick chip drains to "
                         "its siblings before degrading to CPU), "
                         "per-lane program caches. N limits the lanes "
                         "(bare --pool = all local devices). Per-lane "
                         "gauges appear as cess_engine_device_* on "
                         "GET /metrics and in cess_engineStats. "
                         "Results stay bit-identical to the "
                         "single-device engine. Requires --engine")
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="BASELINE",
                    help="arm the continuous-profiling plane "
                         "(cess_tpu_torch/obs/profile.py) on the --engine: "
                         "per-(class, bucket, device) stage "
                         "breakdowns (queue-wait/h2d/dispatch), the "
                         "unified pad ledger (engine bucket padding + "
                         "stream ragged tails in ONE account), "
                         "program-cache compile events, and a "
                         "bench-anchored PerfWatchdog that "
                         "edge-triggers a perf-regression incident "
                         "when live windowed throughput drops below a "
                         "guard fraction of the baseline's "
                         "record. BASELINE is a bench_diff "
                         "--baseline-out artifact measured on this "
                         "hardware (bare --profile: profiling "
                         "without judging, no watchdog). Served via "
                         "the cess_profileDump "
                         "RPC and cess_profile_* gauges on GET "
                         "/metrics (render with tools/"
                         "profile_view.py). Requires --engine; "
                         "absent = zero-cost off (the --trace "
                         "contract)")
    ap.add_argument("--resilience", default="off",
                    choices=["off", "on"],
                    help="attach the resilience layer "
                         "(cess_tpu_torch/resilience) to the --engine: "
                         "saturated submits retry with deterministic "
                         "backoff inside the request's deadline "
                         "budget, a failed coalesced batch re-runs "
                         "its members individually (one poisoned "
                         "request cannot fail its batch-mates), and a "
                         "per-backend health breaker transparently "
                         "degrades device->CPU reference codec "
                         "(bit-identical results) with recovery "
                         "probes. Counters appear under "
                         "cess_resilience_* beside the cess_engine_* "
                         "family. Requires --engine; 'off' (default) "
                         "keeps the engine fail-fast")
    args = ap.parse_args(argv)

    def unhex(s: str) -> bytes:
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    if args.subcommand == "key":
        key = ed25519.SigningKey.generate(args.suri.encode())
        print(json.dumps({"public": "0x" + key.public.hex(),
                          "seed": "0x" + key.seed.hex()}))
        return 0

    if args.subcommand == "sign":
        key = ed25519.SigningKey.generate(args.suri.encode())
        sig = key.sign(unhex(args.message))
        print(json.dumps({"public": "0x" + key.public.hex(),
                          "signature": "0x" + sig.hex()}))
        return 0

    if args.subcommand == "verify":
        ok = ed25519.verify(unhex(args.public), unhex(args.message),
                            unhex(args.signature))
        print(json.dumps({"valid": bool(ok)}))
        return 0 if ok else 1

    if args.subcommand == "vanity":
        # the reference's `key vanity` (node/src/cli.rs:23-70 via
        # sc-cli): grind seeds until the public key starts with the
        # requested hex prefix
        want = args.pattern.lower().removeprefix("0x")
        if not want or any(c not in "0123456789abcdef" for c in want):
            print("--pattern must be non-empty hex", file=sys.stderr)
            return 1
        if len(want) > 6:
            print("--pattern longer than 6 hex digits would grind for "
                  "hours; refusing", file=sys.stderr)
            return 1
        base = args.suri
        if base == "dev-seed":
            # the shared dev default would hand every operator the SAME
            # deterministic "vanity" key; mix fresh entropy unless the
            # caller pinned a suri deliberately (review-caught)
            import secrets

            base = "vanity-" + secrets.token_hex(16)
        i = 0
        while True:
            seed = f"{base}/{i}".encode()
            key = ed25519.SigningKey.generate(seed)
            if key.public.hex().startswith(want):
                print(json.dumps({"public": "0x" + key.public.hex(),
                                  "seed": seed.decode(),
                                  "tries": i + 1}))
                return 0
            i += 1

    if args.subcommand == "benchmark":
        # the `benchmark` subcommand role (node/src/cli.rs:23-70):
        # measure this host's dispatch + block-execution rates against
        # the weight unit so operators can judge whether their machine
        # keeps up with the 6 s slot budget
        import statistics
        import time as _time

        from ..chain.runtime import Runtime, RuntimeConfig

        rt = Runtime(RuntimeConfig(era_blocks=100_000))
        rt.fund("bench-a", 10 ** 24)
        times = []
        for i in range(max(args.reps, 5)):
            t0 = _time.perf_counter()
            rt.apply_extrinsic("bench-a", "balances.transfer",
                               f"bench-b{i}", 10 ** 12)
            times.append(_time.perf_counter() - t0)
        unit_us = statistics.median(times) * 1e6
        t0 = _time.perf_counter()
        rt.advance_blocks(50)
        empty_block_us = (_time.perf_counter() - t0) / 50 * 1e6
        print(json.dumps({
            "weight_unit_us": round(unit_us, 2),
            "empty_block_us": round(empty_block_us, 2),
            "transfers_per_6s_block": int(6e6 / unit_us),
        }))
        return 0

    spec = dev_spec() if args.dev else _load_spec(args.chain,
                                                  args.validators)
    if args.subcommand == "build-spec":
        print(json.dumps(spec_to_json(spec), indent=2))
        return 0

    import os

    if args.subcommand in ("export-blocks", "import-blocks", "revert",
                           "check-block"):
        if not args.base_path:
            print("--base-path required", file=sys.stderr)
            return 1
        return _block_tool(args, spec)

    if args.subcommand == "try-runtime":
        # the try-runtime role (ref node/src/cli.rs:23-70): dry-run the
        # RUNNING code's pending migrations against a real persisted
        # chain's state — report what would change, commit nothing
        if not args.base_path:
            print("--base-path required", file=sys.stderr)
            return 1
        return _try_runtime(args, spec)

    if args.port:
        return _run_tcp_node(args, spec)

    nodes = [Node(spec, f"node-{v.account}",
                  {v.account: spec.session_key(v.account)},
                  base_path=(os.path.join(args.base_path,
                                          f"node-{v.account}")
                             if args.base_path else None))
             for v in spec.validators]
    net = Network(nodes)
    if args.telemetry:
        from .metrics import TelemetryStream

        nodes[0].offchain_agents.append(TelemetryStream(args.telemetry))
    tracer = _arm_cli_tracer(args)
    if tracer is not None:
        nodes[0].tracer = tracer      # cess_traceDump RPC surface
    engine = _make_cli_engine(args, spec)
    if engine is not None:
        nodes[0].engine = engine
        if engine.profile is not None:
            nodes[0].profile = engine.profile  # cess_profileDump RPC
    recorder, reporter = _arm_cli_flight(args, tracer, engine)
    if reporter is not None:
        nodes[0].flight = recorder
        nodes[0].incidents = reporter  # cess_incidentDump RPC surface
    plane = _arm_cli_fleet(args, nodes[0], reporter)
    watch = _arm_cli_chainwatch(args, nodes[0], reporter, plane)
    custody = _arm_cli_custody(args, nodes[0], recorder, reporter)
    remediation = _arm_cli_remediate(args, nodes[0], recorder,
                                     reporter, engine)
    if remediation is not None and custody is not None:
        remediation.bind_custody(custody)  # proactive-repair targets
    rpc = None
    import threading

    # block production and RPC reads share one lock (RPC iterates
    # live runtime state; unsynchronized scrapes race block execution)
    chain_lock = threading.Lock()
    if args.rpc_port:
        rpc = RpcServer(nodes[0], port=args.rpc_port,
                        lock=chain_lock).start()
        print(f"JSON-RPC on 127.0.0.1:{rpc.port}", file=sys.stderr)
    produced = 0
    slot = max(len(nodes[0].chain), 1)
    try:
        while args.blocks == 0 or produced < args.blocks:
            with chain_lock:
                made = net.run_slot(slot)
            if made is not None:
                produced += 1
                head = nodes[0].chain[-1]
                print(f"#{head.number} author={head.author} "
                      f"state={head.state_root.hex()[:16]} "
                      f"finalized=#{nodes[0].finalized}", file=sys.stderr)
            slot += 1
            # single-process deployment: no gossip to scrape peers
            # over, so the watch/plane tick themselves (self-only
            # rounds; the watch scans first so its lag fold lands in
            # the plane's same-slot seal)
            if watch is not None and slot % 4 == 0:
                with chain_lock:
                    watch.scan_node(nodes[0])
                watch.seal_round()
            if plane is not None and slot % 4 == 0:
                with chain_lock:
                    plane.tick()
            # the custody margin fold seals after the scans above so
            # the MarketWatch cross-check reads this slot's market
            # view; its at-risk/lost edges land in the remediation
            # plane's SAME decision round below
            if custody is not None and slot % 4 == 0:
                with chain_lock:
                    _cli_custody_scrape(nodes[0], watch, custody)
            # the remediation plane decides AFTER the detectors'
            # scan/tick above: edges they announced this slot land as
            # actions in the same decision round. Actions may submit
            # extrinsics, so the tick runs under the chain lock
            if remediation is not None and slot % 4 == 0:
                with chain_lock:
                    remediation.tick()
            if args.block_time:
                time.sleep(args.block_time)
    except KeyboardInterrupt:
        pass
    finally:
        if rpc:
            rpc.stop()
        if engine is not None:
            engine.close()
        _finish_cli_profile(engine)
        _finish_cli_remediate(remediation)
        _finish_cli_custody(custody)
        _finish_cli_chainwatch(watch)
        _finish_cli_fleet(plane, tracer)
        _finish_cli_flight(args, recorder, reporter)
        _finish_cli_tracer(args, tracer)
    return 0


def _arm_cli_tracer(args):
    """--trace: arm a process-wide Tracer (cess_tpu_torch/obs) for the run;
    every instrumented seam (pipeline, engine, stream, resilience,
    net, offchain agents) then records request-scoped spans. Returns
    the tracer (also attached as ``node.tracer`` by the callers so
    cess_traceDump serves it) or None."""
    if args.trace is None:
        return None
    from ..obs import trace as obs_trace

    return obs_trace.arm(obs_trace.Tracer(capacity=65536))


def _finish_cli_tracer(args, tracer) -> None:
    """Disarm and, when --trace carried a PATH, write the Chrome
    trace-event JSON artifact (open it in Perfetto)."""
    if tracer is None:
        return
    from ..obs import trace as obs_trace

    obs_trace.disarm()
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(tracer.export_chrome(), f)
        print(f"trace written to {args.trace} "
              f"({len(tracer.finished())} spans)", file=sys.stderr)


def _arm_cli_flight(args, tracer, engine):
    """--flight: build a FlightRecorder over the --trace tracer
    (tail-sampled retention + black-box journals) and an
    IncidentReporter bundling its triggers; returns ``(recorder,
    reporter)`` (attached by the callers as ``node.flight`` /
    ``node.incidents`` so cess_incidentDump serves them) or
    ``(None, None)``. SLO targets on the engine's board become the
    over-objective pin thresholds."""
    if getattr(args, "flight", None) is None:
        return None, None
    if tracer is None:
        print("--flight requires --trace (retention decisions run on "
              "finished spans)", file=sys.stderr)
        raise SystemExit(2)
    from ..obs import flight as obs_flight
    from ..obs.incident import IncidentReporter

    objectives = {}
    board = None if engine is None else engine.slo
    if board is not None:
        objectives = {t.cls: t.p99_s for t in board.targets}
    recorder = obs_flight.arm(obs_flight.FlightRecorder(
        b"cess-cli", baseline_rate=1 / 64, objectives=objectives))
    tracer.attach_flight(recorder)
    reporter = IncidentReporter(recorder, engine=engine)
    return recorder, reporter


def _finish_cli_flight(args, recorder, reporter) -> None:
    """Disarm and, when --flight carried a DIR, write each incident
    bundle as its own JSON artifact (render a timeline with
    tools/incident_view.py)."""
    if recorder is None:
        return
    import os

    from ..obs import flight as obs_flight

    obs_flight.disarm()
    bundles = reporter.bundles()
    if args.flight:
        os.makedirs(args.flight, exist_ok=True)
        for b in bundles:
            path = os.path.join(
                args.flight, f"incident_{b['seq']:03d}_{b['trigger']}.json")
            with open(path, "w") as f:
                json.dump(b, f, indent=2)
    snap = recorder.snapshot()
    where = f", written to {args.flight}" if args.flight and bundles else ""
    print(f"flight recorder: {snap['pins']} pinned trace(s) "
          f"({snap['pinned_spans']} spans), {len(bundles)} incident "
          f"bundle(s){where}", file=sys.stderr)


def _arm_cli_fleet(args, node, reporter):
    """--fleet: arm a FleetPlane (obs/fleet.py) as ``node.fleet``.
    In TCP mode the net author loop gossips this node's scrape to
    peers every FLEET_EVERY slots and seals rounds over whatever
    peers gossiped in; in-process mode ticks self-only rounds. The
    self scrape source is the node's own /metrics exposition plus the
    engine SLO board snapshot when one exists. With --flight, the
    incident reporter's bundles gain the plane's stitched cross-node
    trace view. Returns the plane or None."""
    if not getattr(args, "fleet", False):
        return None
    from ..obs.fleet import FleetPlane
    from .metrics import render_metrics

    plane = FleetPlane(node.name)

    def _source():
        board = getattr(getattr(node, "engine", None), "slo", None)
        slo = None if board is None else board.snapshot()
        # with --chainwatch, chain health rides the fleet frame: the
        # node's consensus state under "chain" plus a finality_lag
        # SLO class every receiver's FleetBoard folds into its
        # worst/quorum views. Late-bound getattr: the watch arms
        # after the plane.
        watch = getattr(node, "chainwatch", None)
        if watch is not None:
            chain_slo = watch.self_slo(node)
            slo = dict(slo or {})
            targets = dict(slo.get("targets") or {})
            targets.update(chain_slo["targets"])
            slo["targets"] = targets
            slo["chain"] = chain_slo["chain"]
        return (render_metrics(node), slo)

    plane.attach_source(_source)
    if reporter is not None:
        reporter.stitcher = plane.stitcher
    node.fleet = plane
    return plane


def _finish_cli_fleet(plane, tracer) -> None:
    """Feed the run's own trace dump into the stitcher (so the final
    fleet snapshot stitches this node's side of every cross-node hop)
    and print the plane summary."""
    if plane is None:
        return
    if tracer is not None:
        plane.stitcher.add_dump(plane.instance, tracer.finished())
    snap = plane.snapshot()
    print(f"fleet plane: {snap['rounds']} scrape round(s), "
          f"{len(snap['federation']['instances'])} instance(s), "
          f"{snap['stitch']['spans']} stitched span(s)",
          file=sys.stderr)


def _arm_cli_chainwatch(args, node, reporter, plane):
    """--chainwatch: arm a ChainWatch (obs/chainwatch.py) as
    ``node.chainwatch``. The net author loop (TCP mode) or the main
    loop (in-process mode) scans this node's own chain + market state
    every few slots and seals a detector round; with --fleet the
    node's consensus state rides the fleet gossip frames (the plane's
    scrape source folds it into the slo dict) and per-node finality
    lag feeds the plane's straggler windows at every seal. With
    --flight, incident bundles embed the chain-health snapshot.
    Returns the watch or None."""
    if not getattr(args, "chainwatch", False):
        return None
    from ..obs.chainwatch import ChainWatch

    watch = ChainWatch(node.name)
    if plane is not None:
        watch.attach_fleet(plane)
    if reporter is not None:
        reporter.chainwatch = watch
    node.chainwatch = watch
    return watch


def _finish_cli_chainwatch(watch) -> None:
    """Print the chain-watch summary: rounds, anomaly totals and the
    currently-bad anomaly keys (render the full cess_chainStatus
    payload with tools/chain_view.py)."""
    if watch is None:
        return
    snap = watch.snapshot()
    active = {cls: keys
              for cls, keys in snap["anomalies"]["active"].items()
              if keys}
    verdict = "; ".join(f"{cls}: {','.join(keys)}"
                        for cls, keys in sorted(active.items())) \
        or "no active anomalies"
    print(f"chain watch: {snap['rounds']} round(s), "
          f"{len(snap['consensus']['nodes'])} node(s) watched, "
          f"{len(snap['consensus']['equivocations'])} equivocation "
          f"evidence record(s), "
          f"{snap['anomalies']['anomalies']} anomaly edge(s); "
          f"{verdict}", file=sys.stderr)


def _arm_cli_remediate(args, node, recorder, reporter, engine):
    """--remediate: arm a RemediationPlane (serve/remediate.py) as
    ``node.remediation``: it subscribes to the --flight recorder's
    detector edges and acts through the node (extrinsics) and the
    --engine (monitor pins, lane quarantine) when one exists. The
    author/main loop ticks it every few slots — AFTER the detector
    scans, so their edges are decided in the same round. With
    ``--remediate=dry`` every decision is journaled but no seam is
    touched. Returns the plane or None."""
    if getattr(args, "remediate", None) is None:
        return None
    if recorder is None:
        print("--remediate requires --flight (the policy engine "
              "subscribes to the flight recorder's detector edges)",
              file=sys.stderr)
        raise SystemExit(2)
    from ..serve.remediate import RemediationPlane

    plane = RemediationPlane(b"cess-cli",
                             dry_run=args.remediate == "dry")
    if engine is not None:
        plane.bind_engine(engine)
    plane.bind_node(node)
    recorder.add_listener(plane.on_note)
    if reporter is not None:
        reporter.remediation = plane  # bundles embed the journal tail
    node.remediation = plane
    return plane


def _finish_cli_remediate(plane) -> None:
    """Print the remediation summary: decision counts and what is
    still engaged (render the full cess_remediationStatus payload
    with tools/remediation_view.py)."""
    if plane is None:
        return
    snap = plane.snapshot()
    c = snap["counters"]
    engaged = ", ".join(sorted(snap["engaged"])) or "nothing engaged"
    mode = " [dry-run]" if snap["dry_run"] else ""
    print(f"remediation plane{mode}: {snap['edges_total']} edge(s), "
          f"{sum(snap['fires'].values())} fire(s), "
          f"{c['suppressed']} suppressed, {c['releases']} release(s), "
          f"{c['flaps']} flap(s); {engaged}", file=sys.stderr)


def _arm_cli_custody(args, node, recorder, reporter):
    """--custody: arm a CustodyPlane (obs/custody.py) as
    ``node.custody``: its ledger subscribes to the --flight
    recorder's ("custody", ...) lineage notes, and the author/main
    loop seals one margin-fold round every few slots (scraping the
    open restoral-order set from the node's own runtime state, and
    cross-checking the --chainwatch MarketWatch when one rides).
    Returns the plane or None."""
    if not getattr(args, "custody", False):
        return None
    if recorder is None:
        print("--custody requires --flight (the custody ledger "
              "subscribes to the flight recorder's lineage notes)",
              file=sys.stderr)
        raise SystemExit(2)
    from ..obs.custody import CustodyPlane

    plane = CustodyPlane(node.name)
    recorder.add_listener(plane.on_note)
    if reporter is not None:
        reporter.custody = plane  # bundles embed custody timelines
    node.custody = plane
    return plane


def _cli_custody_scrape(node, watch, custody) -> None:
    """One self-only custody round on a live node: the open
    restoral-order set from the (replicated) runtime state, the
    MarketWatch cross-check when a --chainwatch rides, then the seal
    folds margins and runs the at-risk/lost detectors. Holder
    liveness stays at the plane's default (alive) — a single node
    has no fleet view to grade peers by."""
    custody.observe_restorals(tuple(
        frag for (frag,), _o in sorted(
            node.runtime.state.iter_prefix("file_bank", "restoral"))))
    if watch is not None:
        custody.cross_check_market(watch.market.snapshot())
    custody.seal_round()


def _finish_cli_custody(custody) -> None:
    """Print the custody summary: ledger sizes, the margin histogram
    and what is at risk (render the full cess_custodyStatus payload
    with tools/custody_view.py)."""
    if custody is None:
        return
    snap = custody.snapshot()
    sizes = snap["ledger"]
    at_risk = ", ".join(snap["at_risk"]) or "nothing at risk"
    print(f"custody plane: {snap['rounds']} round(s), "
          f"{sizes['segments']} segment(s), "
          f"{sizes['fragments']} fragment(s), "
          f"{sizes['events_total']} ledger event(s), "
          f"margins {snap['histogram']}; {at_risk}", file=sys.stderr)


def _finish_cli_profile(engine) -> None:
    """Print the profile-plane summary: observation/pad/compile
    totals and the watchdog verdict (render the full cess_profileDump
    payload with tools/profile_view.py)."""
    plane = getattr(engine, "profile", None)
    if plane is None:
        return
    pads = plane.pads.total()
    compiles = plane.compiles.snapshot()
    wd = plane.watchdog
    verdict = "watchdog off (no baseline)"
    if wd is not None:
        snap = wd.snapshot()
        regressed = sorted(m for m, s in snap["states"].items()
                           if s == "regressed")
        verdict = (f"REGRESSED: {','.join(regressed)}" if regressed
                   else f"ok ({len(snap['states'])} metric(s) "
                        f"watched)")
    print(f"profile plane: {plane.ops.observations()} observation(s), "
          f"{pads['padded']} padded row(s) vs {pads['served']} served, "
          f"{compiles['builds']} compile(s); {verdict}",
          file=sys.stderr)


def _make_cli_engine(args, spec):
    """--engine: build a submission engine over the chain's RS
    geometry with the requested ErasureCodec backend and attach it as
    ``node.engine`` — the handle embedding code (gateway/miner/TEE
    drivers constructed around this node, tests, notebooks) submits
    through. RS-only: the PoDR2 secret never lives in the node, so the
    audit classes stay inert here (drivers holding a key build their
    own engine via serve.make_engine(podr2_key=...)). The CLI itself
    spawns no storage agents, so with a bare node the flag's visible
    effect is the stats surface: counters on GET /metrics
    (cess_engine_*) and the cess_engineStats RPC.

    --resilience mirrors the shape: opt-in, wraps THIS engine with
    the retry/isolation/degradation layer (cess_tpu_torch/resilience) and
    adds the cess_resilience_* counters to the same surfaces.
    --slo / --adaptive mirror it again (ISSUE 6): an SLO board with
    burn-rate monitors + per-tenant accounting, and the adaptive
    batching/admission layer consuming it — cess_slo_*/cess_tenant_*/
    cess_adaptive_* counters on the same surfaces plus the
    cess_sloStatus RPC. --profile mirrors it once more (ISSUE 13):
    the continuous-profiling plane (obs/profile.py) — cess_profile_*
    gauges plus the cess_profileDump RPC."""
    # getattr defaults: embedders hand-build minimal Namespaces
    slo_spec = getattr(args, "slo", None)
    adaptive = getattr(args, "adaptive", False)
    pool_spec = getattr(args, "pool", None)
    profile_spec = getattr(args, "profile", None)
    if args.engine == "off":
        if args.resilience != "off":
            raise SystemExit("--resilience requires --engine "
                             "(it wraps the submission engine)")
        if slo_spec is not None:
            raise SystemExit("--slo requires --engine (it watches the "
                             "submission engine's latency signal)")
        if adaptive:
            raise SystemExit("--adaptive requires --engine (it tunes "
                             "the submission engine's batching)")
        if pool_spec is not None:
            raise SystemExit("--pool requires --engine (it shards the "
                             "submission engine's dispatch)")
        if profile_spec is not None:
            raise SystemExit("--profile requires --engine (it "
                             "accounts the submission engine's "
                             "dispatches)")
        return None
    if pool_spec is not None and pool_spec < 0:
        raise SystemExit("--pool takes a non-negative lane count")
    if adaptive and slo_spec is None:
        raise SystemExit("--adaptive requires --slo (without a board's "
                         "targets the knob tuner has nothing to steer "
                         "toward and would silently never adjust)")
    from ..serve import make_engine

    resilience = None
    if args.resilience == "on":
        from ..resilience import ResilienceConfig

        resilience = ResilienceConfig()
    slo = None
    if slo_spec is not None:
        from ..obs.slo import SloBoard, parse_targets

        slo = SloBoard(parse_targets(slo_spec))
    profile = None
    if profile_spec is not None:
        from ..obs import profile as obs_profile

        # --profile=PATH: a bench_diff --baseline-out artifact measured
        # on this hardware; bare --profile: an unanchored plane
        # (profiling without judging), since the checked-in
        # BENCH_r*.json rounds are a TPU's numbers — the ledgers fill,
        # the watchdog stays None.
        baseline = (obs_profile.load_baseline(profile_spec)
                    if profile_spec else None)
        profile = obs_profile.ProfilePlane(baseline=baseline)
    k = max(spec.fragment_count - 1, 1)      # reference RS(k, 1) shape
    # --pool = all local devices; --pool=N = the first N lanes
    pool = None if pool_spec is None else (pool_spec or True)
    return make_engine(k, spec.fragment_count - k,
                       rs_backend=args.engine, resilience=resilience,
                       slo=slo, adaptive=True if adaptive else None,
                       pool=pool, profile=profile)


def _data_dir(args, spec) -> "str | None":
    """Locate the persisted node data dir under --base-path: an
    existing node-* dir WITH a block log, or the base path itself if
    it is one — never a directory that would make Node() silently
    fabricate a fresh chain (shared by _block_tool and _try_runtime;
    review-caught: try-runtime's own weaker scan could pick an
    unrelated subdir and report against a fabricated genesis)."""
    import os

    from . import store as _store

    candidates = sorted(
        d for d in (os.listdir(args.base_path)
                    if os.path.isdir(args.base_path) else [])
        if d.startswith("node-")
        and os.path.exists(os.path.join(args.base_path, d,
                                        _store.BLOCKS_FILE)))
    if candidates:
        preferred = f"node-{spec.validators[0].account}"
        base = os.path.join(args.base_path,
                            preferred if preferred in candidates
                            else candidates[0])
        if len(candidates) > 1:
            print(f"note: multiple node dirs {candidates}, using "
                  f"{os.path.basename(base)}", file=sys.stderr)
        return base
    if os.path.exists(os.path.join(args.base_path, _store.BLOCKS_FILE)):
        return args.base_path
    return None


def _try_runtime(args, spec) -> int:
    from ..chain import migrations

    base = _data_dir(args, spec)
    if base is None:
        print(f"no node data under {args.base_path}", file=sys.stderr)
        return 1
    node = Node(spec, "try-runtime", {}, base_path=base)
    state = node.runtime.state
    root_before = state.state_root()
    before = migrations.spec_version(state)
    versions_before = {pallet: migrations.storage_version(state, pallet)
                       for pallet in migrations.current_versions()}
    state.begin_tx()
    try:
        applied = migrations.run_pending(state)
        after = migrations.spec_version(state)
    finally:
        state.rollback_tx()          # dry run: NOTHING commits
    ok = state.state_root() == root_before
    print(json.dumps({
        "base_path": base,
        "head": node.head().number,
        "spec_version": {"on_chain": before, "code": after},
        "storage_versions": versions_before,
        "pending_migrations": applied,
        "would_change_state": bool(applied),
        "rollback_clean": ok,
    }, indent=2))
    return 0 if ok else 1


def _run_tcp_node(args, spec) -> int:
    """Production-shaped deployment: ONE node per OS process, gossiping
    over TCP (the reference's model; node/src/service.rs). Peers are
    seeded via --peers and extended by the peer exchange."""
    import os

    from .net import NodeService

    keystore = {}
    if args.validator:
        if args.validator not in {v.account for v in spec.validators}:
            print(f"unknown validator {args.validator!r}", file=sys.stderr)
            return 1
        keystore[args.validator] = spec.session_key(args.validator)
    name = args.validator or f"full-{args.port}"
    base = os.path.join(args.base_path, f"node-{name}")         if args.base_path else None
    node = Node(spec, name, keystore, base_path=base)
    if args.telemetry:
        from .metrics import TelemetryStream

        node.offchain_agents.append(TelemetryStream(args.telemetry))
    peers = [int(p) for p in args.peers.split(",") if p.strip()]
    tracer = _arm_cli_tracer(args)
    if tracer is not None:
        node.tracer = tracer          # cess_traceDump RPC surface
    engine = _make_cli_engine(args, spec)
    if engine is not None:
        node.engine = engine
        if engine.profile is not None:
            node.profile = engine.profile  # cess_profileDump RPC
    recorder, reporter = _arm_cli_flight(args, tracer, engine)
    if reporter is not None:
        node.flight = recorder
        node.incidents = reporter     # cess_incidentDump RPC surface
    plane = _arm_cli_fleet(args, node, reporter)
    watch = _arm_cli_chainwatch(args, node, reporter, plane)
    custody = _arm_cli_custody(args, node, recorder, reporter)
    remediation = _arm_cli_remediate(args, node, recorder, reporter,
                                     engine)
    if remediation is not None and custody is not None:
        remediation.bind_custody(custody)  # proactive-repair targets
    svc = NodeService(node, args.port, peers, slot_time=args.slot_time,
                      genesis_time=args.genesis_time)
    rpc = None
    if args.rpc_port:
        rpc = RpcServer(node, port=args.rpc_port, lock=svc.lock,
                        service=svc).start()
        print(f"JSON-RPC on 127.0.0.1:{rpc.port}", file=sys.stderr)
    svc.start()
    print(f"node {name} on :{args.port}, peers {peers}", file=sys.stderr)
    try:
        last = -1
        while True:
            time.sleep(max(args.slot_time, 0.2))
            with svc.lock:
                head = node.head()
                fin = node.finalized
            if head.number != last:
                last = head.number
                print(f"#{head.number} author={head.author} "
                      f"finalized=#{fin} peers={len(svc._known_peers)}",
                      file=sys.stderr)
            # the custody margin fold seals once per monitor
            # iteration, BEFORE the remediation decision below, so
            # an at-risk edge is acted on in the same pass
            if custody is not None:
                with svc.lock:
                    _cli_custody_scrape(node, watch, custody)
            # one remediation decision round per monitor iteration:
            # edges the service's detector scans announced since the
            # last pass become actions here. Extrinsic-filing actions
            # share the service lock with block import
            if remediation is not None:
                with svc.lock:
                    remediation.tick()
            if args.blocks and head.number >= args.blocks:
                break
    except KeyboardInterrupt:
        pass
    finally:
        svc.stop()
        if rpc:
            rpc.stop()
        if engine is not None:
            engine.close()
        _finish_cli_profile(engine)
        _finish_cli_remediate(remediation)
        _finish_cli_custody(custody)
        _finish_cli_chainwatch(watch)
        _finish_cli_fleet(plane, tracer)
        _finish_cli_flight(args, recorder, reporter)
        _finish_cli_tracer(args, tracer)
    return 0


def _block_tool(args, spec) -> int:
    """check/export/import/revert blocks (command.rs analogs). Each
    loads the node from --base-path (which replays + verifies the
    whole log through normal import) and operates on the canonical
    chain."""
    import os

    from . import store as _store

    # locate the node data dir (shared helper; import-blocks alone may
    # create the canonical layout — it writes data by design)
    base = _data_dir(args, spec)
    if base is None and args.subcommand == "import-blocks":
        base = os.path.join(args.base_path,
                            f"node-{spec.validators[0].account}")
        os.makedirs(base, exist_ok=True)
    elif base is None:
        print(f"no node data under {args.base_path}", file=sys.stderr)
        return 1
    node = Node(spec, "tool", {}, base_path=base)
    head = node.head().number

    if args.subcommand == "check-block":
        n = head if args.number is None else args.number
        if not 0 <= n <= head:
            print(f"block {n} out of range (head #{head})",
                  file=sys.stderr)
            return 1
        h = node.chain[n]
        # the load above already re-executed and root-checked the chain
        print(json.dumps({"number": n, "hash": "0x" + h.hash().hex(),
                          "state_root": "0x" + h.state_root.hex(),
                          "author": h.author, "verified": True}))
        return 0

    if args.subcommand == "export-blocks":
        if os.path.exists(args.to):
            os.remove(args.to)   # truncate: re-exports must not append
        exp = _store.BlockStore(args.to)
        for n in range(1, head + 1):
            exp.append(node.block_bodies[n])
        exp.close()
        print(f"exported #{1}..#{head} to {args.to}", file=sys.stderr)
        return 0

    if args.subcommand == "import-blocks":
        src_store = _store.BlockStore(args.from_file)
        imported = 0
        for block in src_store:
            try:
                node.import_block(block)
                imported += 1
            except ValueError:
                continue   # duplicates / stale forks
        print(f"imported {imported} blocks, head #{node.head().number}",
              file=sys.stderr)
        return 0

    if args.subcommand == "revert":
        target = max(0, head - args.blocks)
        if target < node.finalized:
            print(f"refusing to revert below finalized "
                  f"#{node.finalized}", file=sys.stderr)
            return 1
        # rewrite the block log up to the target and drop the snapshot
        # (the next start replays the truncated log)
        blocks_file = os.path.join(base, _store.BLOCKS_FILE)
        tmp = blocks_file + ".tmp"
        out = _store.BlockStore(tmp)
        for n in range(1, target + 1):
            out.append(node.block_bodies[n])
        out.close()
        node.store.close()
        os.replace(tmp, blocks_file)
        snap = os.path.join(base, _store.SNAPSHOT_FILE)
        if os.path.exists(snap):
            os.remove(snap)
        print(f"reverted to #{target}", file=sys.stderr)
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
