"""The reference's node tests on the port's node (``cess_tpu_torch.node``):
the header MMR, the DHT, the RPC, CLI and telemetry tests of
``tests/test_node.py``, the websocket pubsub and persistence, each as
written (``torch_node_port``), and each one that runs a node also on
both packages step by step, with equal head hashes on every replica,
equal state roots and equal new events after every slot, import and sync
(tolerance 0).

The storage network's tests are in ``test_torch_node_storage*.py``, the
fork and network tests in ``test_torch_node_fork.py``, the TCP tests in
``test_torch_net*.py``; the cross-package checks (spec JSON, exported
blocks, a data directory and RPC results) are at the end of this file.
"""
import json
import os
import urllib.request

import pytest

import torch_node_port as tp

NODE_TESTS = ("test_rpc_server_roundtrip", "test_cli_smoke",
              "test_local_spec_multinode_eras_rotate",
              "test_rpc_error_codes", "test_cli_key_tools_and_block_tools",
              "test_rpc_consensus_and_payment_namespaces",
              "test_cli_vanity_and_benchmark",
              "test_cli_try_runtime_dry_runs_migrations",
              "test_telemetry_stream_endpoint")

CASES = ([("test_mmr", n) for n in tp.reference_tests("test_mmr")]
         + [("test_dht", n) for n in tp.reference_tests("test_dht")]
         + [("test_node", n) for n in tp.reference_tests(
             "test_node", only=NODE_TESTS)]
         + [("test_ws", n) for n in tp.reference_tests("test_ws")]
         + [("test_persistence", n)
            for n in tp.reference_tests("test_persistence")]
         # the runtime files' tests that drive a node, which
         # tests/torch_runtime_twin.py leaves out
         + [("test_evm", n) for n in tp.reference_tests("test_evm", only=(
             "test_eth_rpc_surface", "test_eth_filter_hardening",
             "test_eth_filter_criteria_semantics",
             "test_eth_tx_lifecycle_rpc", "test_eth_misc_tooling_probes",
             "test_eth_block_receipts_and_tx_by_index"))]
         + [("test_staking", "test_network_driver_heartbeats_and_dead_node_reported"),
            ("test_election", "test_node_rotation_consumes_election")]
         + [("test_upgrade", n) for n in tp.reference_tests(
             "test_upgrade", only=(
                 "test_old_chain_restarts_and_upgrades_in_band",
                 "test_metrics_endpoint_and_block_logs",
                 "test_eth_namespace_rpc"))])

# the tests that run a node's slots: each also runs on both packages
SLOTTED = [(m, n) for m, n in CASES
           if m not in ("test_dht",) and n not in (
               "test_proofs_verify_at_every_size_and_index",
               "test_root_changes_on_append_and_binds_count",
               "test_tampered_proofs_rejected",
               "test_header_mmr_extends_and_rebuilds_on_reorg",
               "test_blockstore_truncates_torn_tail",
               "test_chain_spec_export_roundtrip",
               "test_cli_vanity_and_benchmark")]


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}::{n}" for m, n in CASES])
def test_reference_node_test_on_the_port(module, name, request):
    tp.run(module, name, request)


@pytest.mark.parametrize("module,name", SLOTTED,
                         ids=[f"{m}::{n}" for m, n in SLOTTED])
def test_reference_node_test_slot_by_slot(module, name, request):
    tp.run_lockstep(module, name, request, min_slots=1)


# -- across the packages -------------------------------------------------------
def _pkgs():
    import importlib

    return [(p, importlib.import_module(f"{p}.node.chain_spec"),
             importlib.import_module(f"{p}.node.network"))
            for p in (tp.REF, tp.PORT)]


@pytest.mark.parametrize("chain", ["dev", "local"])
def test_spec_json_and_genesis_hash_cross(chain):
    """A spec exported by either package loads in the other with the same
    JSON and the same genesis hash."""
    (_, rspec, _), (_, pspec, _) = _pkgs()
    ref = rspec.dev_spec() if chain == "dev" else rspec.local_spec(3)
    port = pspec.dev_spec() if chain == "dev" else pspec.local_spec(3)
    assert pspec.spec_to_json(port) == rspec.spec_to_json(ref)
    assert port.genesis_hash() == ref.genesis_hash()
    there = pspec.spec_from_json(json.loads(json.dumps(
        rspec.spec_to_json(ref))))
    back = rspec.spec_from_json(json.loads(json.dumps(
        pspec.spec_to_json(port))))
    assert there.genesis_hash() == back.genesis_hash() == ref.genesis_hash()
    assert there.build_runtime().state.state_root() \
        == ref.build_runtime().state.state_root()


def _cli(pkg):
    import importlib

    return importlib.import_module(f"{pkg}.node.cli").main


def _head(pkg, base, capsys):
    assert _cli(pkg)(["check-block", "--dev", "--base-path", base]) == 0
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("src,dst", [(tp.REF, tp.PORT), (tp.PORT, tp.REF)])
def test_exported_blocks_import_across(src, dst, tmp_path, capsys):
    """``export-blocks`` of one package's CLI, ``import-blocks`` into the
    other's: the same head hash, verified."""
    base, base2 = str(tmp_path / "a"), str(tmp_path / "b")
    exp = str(tmp_path / "chain.blocks")
    assert _cli(src)(["run", "--dev", "--blocks", "6",
                      "--base-path", base]) == 0
    assert _cli(src)(["export-blocks", "--dev", "--base-path", base,
                      "--to", exp]) == 0
    capsys.readouterr()
    want = _head(src, base, capsys)
    os.makedirs(os.path.join(base2, "node-alice"))
    assert _cli(dst)(["import-blocks", "--dev", "--base-path", base2,
                      "--from", exp]) == 0
    capsys.readouterr()
    got = _head(dst, base2, capsys)
    assert got == want and got["number"] == 6 and got["verified"] is True


def test_reference_base_path_resumes_in_a_port_node(tmp_path):
    """A data directory written by a JAX-package node opens in a port
    node as it opens in a JAX-package node: the same chain, state root and
    finality, and both continue to the same blocks."""
    import shutil

    (_, rspec, rnet), (_, pspec, pnet) = _pkgs()
    spec = rspec.dev_spec()
    writer = rnet.Node(spec, "a", {"alice": spec.session_key("alice")},
                       base_path=str(tmp_path / "ref"))
    rnet.Network([writer]).run_slots(7)
    writer.store.close()
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    ref = rnet.Node(spec, "a", {"alice": spec.session_key("alice")},
                    base_path=str(tmp_path / "ref"))
    pspec_ = pspec.dev_spec()
    port = pnet.Node(pspec_, "a", {"alice": pspec_.session_key("alice")},
                     base_path=str(tmp_path / "port"))
    assert len(port.chain) == 8
    assert [h.hash() for h in port.chain] == [h.hash() for h in ref.chain]
    assert port.runtime.state.state_root() \
        == ref.runtime.state.state_root()
    assert port.finalized == ref.finalized
    pnet.Network([port]).run_slots(2)
    rnet.Network([ref]).run_slots(2)
    assert port.chain[-1].hash() == ref.chain[-1].hash()
    assert port.finalized == ref.finalized == 9
    port.store.close()
    ref.store.close()
    with open(tmp_path / "ref" / "blocks.bin", "rb") as a, \
            open(tmp_path / "port" / "blocks.bin", "rb") as b:
        assert a.read() == b.read()


RPC_CALLS = [
    ("system_chain",), ("system_name",), ("system_properties",),
    ("system_health",), ("chain_getBlockNumber",), ("chain_getHeader",),
    ("chain_getHeader", 2), ("chain_getBlock", 3), ("chain_getBlockHash", 2),
    ("chain_getFinalizedHead",), ("state_getStorage", "balances", "free",
                                  "bob"),
    ("state_getRuntimeVersion",), ("system_accountNextIndex", "alice"),
    ("rrsc_epoch",), ("grandpa_roundState",), ("grandpa_proveFinality", 2),
    ("mmr_root",), ("mmr_generateProof", 2), ("sync_state_genSyncSpec",),
    ("eth_chainId",), ("eth_blockNumber",), ("eth_getBalance", "alice"),
    ("cess_challenge",), ("cess_minerInfo", "m1"), ("cess_chainStatus",),
    ("cess_teeVerdicts",), ("cess_engineStats",), ("no_such_method",),
    ("chain_getHeader", 999),
]


def test_rpc_results_equal_across_packages():
    """The same RPC requests against a JAX-package node and a port node on
    the same chain return equal JSON (results and error codes)."""
    nodes = []
    for _, spec_mod, net_mod in _pkgs():
        spec = spec_mod.dev_spec()
        node = net_mod.Node(spec, "n0", {"alice": spec.session_key("alice")})
        net = net_mod.Network([node])
        net.run_slots(3)
        node.submit_extrinsic("alice", "balances.transfer", "bob", 7)
        net.run_slots(2)
        nodes.append(node)
    import importlib

    servers = [importlib.import_module(f"{p}.node.rpc").RpcServer(
        n, port=0).start() for p, n in zip((tp.REF, tp.PORT), nodes)]
    try:
        for i, call in enumerate(RPC_CALLS):
            req = json.dumps({"jsonrpc": "2.0", "id": i, "method": call[0],
                              "params": list(call[1:])}).encode()
            outs = []
            for srv in servers:
                with urllib.request.urlopen(urllib.request.Request(
                        f"http://127.0.0.1:{srv.port}", data=req,
                        headers={"Content-Type": "application/json"})) as r:
                    outs.append(json.loads(r.read()))
            assert outs[0] == outs[1], call
        # GET /metrics: the same families and values
        scrapes = []
        for srv in servers:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics") as r:
                scrapes.append(r.read().decode())
        assert scrapes[0] == scrapes[1]
    finally:
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("engine", ["cuda", "auto"])
def test_cli_engine_on_the_card_raises_without_one(engine):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _cli(tp.PORT)(["--dev", "--blocks", "1", "--engine", engine])


def test_cli_engine_cpu_serves_its_stats():
    """``--engine cpu``: the host reference engine on the node; the
    ``cess_engineStats`` RPC names its codec and device, and GET /metrics
    carries the ``cess_engine_*`` families."""
    import importlib
    import types

    cli = importlib.import_module(f"{tp.PORT}.node.cli")
    cs = importlib.import_module(f"{tp.PORT}.node.chain_spec")
    net_mod = importlib.import_module(f"{tp.PORT}.node.network")
    rpc_mod = importlib.import_module(f"{tp.PORT}.node.rpc")
    spec = cs.dev_spec()
    args = types.SimpleNamespace(engine="cpu", resilience="off")
    eng = cli._make_cli_engine(args, spec)
    try:
        node = net_mod.Node(spec, "n0", {"alice": spec.session_key("alice")})
        net_mod.Network([node]).run_slots(2)
        node.engine = eng
        rpc = rpc_mod.RpcServer(node, port=0)
        stats = rpc.handle("cess_engineStats", [])
        rpc.httpd.server_close()
        assert stats["codec"] == {"k": eng.codec.k, "m": eng.codec.m,
                                  "device": "cpu"}
        assert "encode" in stats["classes"]
        metrics = importlib.import_module(f"{tp.PORT}.node.metrics")
        assert "cess_engine_" in metrics.render_metrics(node)
    finally:
        eng.close()


@pytest.mark.parametrize("spec", ["", "fixture"])
def test_cli_bare_profile_leaves_the_watchdog_unanchored(tmp_path,
                                                         monkeypatch, spec):
    """A bare ``--profile`` builds an unanchored plane even beside a
    ``BENCH_r*.json`` (a TPU's numbers): the watchdog stays None.
    ``--profile=PATH`` still anchors it on that baseline."""
    import importlib
    import json
    import types

    cli = importlib.import_module(f"{tp.PORT}.node.cli")
    cs = importlib.import_module(f"{tp.PORT}.node.chain_spec")
    (tmp_path / "BENCH_r05.json").write_text(json.dumps(
        {"tail": '{"metric": "rs_4p8_encode_GiBps_per_chip", '
                 '"value": 9.5}\n'}))
    fixture = tmp_path / "baseline.json"
    fixture.write_text(json.dumps(
        {"metrics": {"stream_encode_tag_GiBps": {"value": 1.5}}}))
    monkeypatch.chdir(tmp_path)
    prof = importlib.import_module(f"{tp.PORT}.obs.profile")
    assert prof.latest_bench_baseline() == {
        "rs_4p8_encode_GiBps_per_chip": 9.5}
    args = types.SimpleNamespace(engine="cpu", resilience="off",
                                 profile=str(fixture) if spec else "")
    eng = cli._make_cli_engine(args, cs.dev_spec())
    try:
        assert eng.profile is not None
        if spec:
            assert eng.profile.watchdog.snapshot()["baseline"] == {
                "stream_encode_tag_GiBps": 1.5}
        else:
            assert eng.profile.watchdog is None
    finally:
        eng.close()


def test_cli_help_lists_the_reference_surface(capsys):
    """The port's ``--help`` lists every subcommand and flag of the
    reference's parser (its usage, prog name aside), with ``--engine``
    taking "cuda" in place of the reference's "tpu". The reference's own
    ``--help`` raises: its ``--slo`` help holds a bare ``%`` (a fault
    of the reference, pinned here; the port escapes it)."""
    usage = {}
    for pkg in (tp.REF, tp.PORT):
        with pytest.raises(SystemExit):
            _cli(pkg)(["--no-such-flag"])
        err = capsys.readouterr().err
        usage[pkg] = " ".join(err.split("error:")[0].split()[2:-1])
    assert usage[tp.PORT] == usage[tp.REF].replace(
        "{off,cpu,auto,tpu}", "{off,cpu,auto,cuda}")
    with pytest.raises(SystemExit) as done:
        _cli(tp.PORT)(["--help"])
    assert done.value.code == 0
    assert "try-runtime" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unsupported format character"):
        _cli(tp.REF)(["--help"])
