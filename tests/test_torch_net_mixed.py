"""One TCP network of both packages' nodes: two JAX-package processes
(``cess_tpu.node.net``) and one port process (``cess_tpu_torch.node.net``)
on one chain spec gossip blocks, votes and transactions over the same wire
bytes. A transfer submitted on a JAX-package node and one submitted on the
port node must execute on every node, and all three must finalize and
agree on the finalized prefix. Each worker waits on those conditions, not
on a fixed time (the deadline only bounds a hang), and keeps serving
until every worker has met them. The JAX-package workers load no jax, the
port worker no torch and nothing of the JAX package.
"""
import multiprocessing as mp
import sys
import time

N = 3
SLOT = 0.25
PKGS = ("cess_tpu", "cess_tpu", "cess_tpu_torch")
DEADLINE = 90.0


def _free_ports(n):
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _worker(idx, pkg, ports, q, genesis_time, ready, stop):
    import importlib

    constants = importlib.import_module(f"{pkg}.constants")
    cs = importlib.import_module(f"{pkg}.node.chain_spec")
    net = importlib.import_module(f"{pkg}.node.net")
    network = importlib.import_module(f"{pkg}.node.network")
    extrinsic = importlib.import_module(f"{pkg}.chain.extrinsic")
    d = constants.DOLLARS
    spec = cs.ChainSpec(
        name="t", chain_id="tcp-mixed",
        endowed=(("alice", 1_000_000_000 * d), ("carol", 1_000_000 * d)),
        validators=tuple(cs.ValidatorGenesis(f"v{i}", 4_000_000 * d)
                         for i in range(N)),
        era_blocks=1000, epoch_blocks=1000, sudo="alice")
    node = network.Node(spec, f"n{idx}",
                        {f"v{idx}": spec.session_key(f"v{idx}")})
    svc = net.NodeService(node, ports[idx],
                          [p for j, p in enumerate(ports) if j != idx],
                          slot_time=SLOT, genesis_time=genesis_time)
    svc.start()
    # one transfer from a JAX-package node, one from the port node
    sends = {0: ("alice", "bob", 7 * d), 2: ("carol", "dave", 5 * d)}
    sent = False
    deadline = time.time() + DEADLINE
    while time.time() < deadline and not stop.is_set():
        with svc.lock:
            fin = node.finalized
            bal = node.runtime.balances
            done = bal.free("bob") == 7 * d and bal.free("dave") == 5 * d
            if idx in sends and not sent and node.head().number >= 2:
                who, to, amount = sends[idx]
                xt = extrinsic.sign_extrinsic(
                    spec.account_key(who), node.runtime.genesis_hash(),
                    who, 0, "balances.transfer", (to, amount), ())
        if idx in sends and not sent and node.head().number >= 2:
            svc.submit(xt)
            sent = True
        if not ready[idx].is_set() and fin >= 3 and done:
            ready[idx].set()
        time.sleep(SLOT / 2)
    svc.stop()
    with svc.lock:
        q.put((idx, node.finalized, [h.hash().hex() for h in node.chain],
               node.runtime.balances.free("bob") // d,
               node.runtime.balances.free("dave") // d,
               sorted(m for m in ("jax", "torch", "cess_tpu",
                                  "cess_tpu_torch") if m in sys.modules)))


def test_mixed_tcp_cluster_converges():
    ctx = mp.get_context("spawn")
    ports = _free_ports(N)
    q = ctx.Queue()
    ready = [ctx.Event() for _ in range(N)]
    stop = ctx.Event()
    genesis_time = time.time()
    procs = [ctx.Process(target=_worker,
                         args=(i, pkg, ports, q, genesis_time, ready, stop))
             for i, pkg in enumerate(PKGS)]
    for p in procs:
        p.start()
    try:
        for i, ev in enumerate(ready):
            assert ev.wait(timeout=DEADLINE + 30), \
                f"node {i} ({PKGS[i]}) never converged"
    finally:
        stop.set()
    results = sorted(q.get(timeout=60) for _ in range(N))
    for p in procs:
        p.join(timeout=30)
        assert p.exitcode == 0
    fins = [r[1] for r in results]
    assert min(fins) >= 3, f"finality stalled: {fins}"
    upto = min(fins)
    assert len({tuple(r[2][:upto + 1]) for r in results}) == 1, \
        "finalized prefixes diverged"
    assert all(r[3] == 7 and r[4] == 5 for r in results), results
    loaded = {r[0]: r[5] for r in results}
    assert loaded == {0: ["cess_tpu"], 1: ["cess_tpu"],
                      2: ["cess_tpu_torch"]}, loaded


def test_a_full_node_hands_a_refused_dialer_its_peers():
    """A node at its inbound cap refuses a dialer after a peer exchange:
    a late joiner that knows only that node learns another peer and joins
    through it, and the full node learns the joiner's port (the reference
    closes without a word, and such a joiner stays cut off while the node
    is full: ROADMAP queue 3). The nodes run in this process; the wait is
    on the condition, with a deadline."""
    import socket

    from cess_tpu_torch.node.chain_spec import dev_spec
    from cess_tpu_torch.node.net import NodeService
    from cess_tpu_torch.node.network import Node

    spec = dev_spec()
    ports = _free_ports(3)
    now = time.time()
    b = NodeService(Node(spec, "b", {}), ports[1], [], degree=2,
                    genesis_time=now)
    a = NodeService(Node(spec, "a", {}), ports[0], [ports[1]], degree=2,
                    genesis_time=now)
    services = [b, a]
    holders = []
    try:
        b.start()
        a.start()
        # fill a's inbound slots (degree 2: at most 2 inbound) with idle
        # sockets that a keeps as live connections
        deadline = time.time() + 20
        while time.time() < deadline:
            with a.lock:
                inbound = sum(1 for c in a.conns if c.alive and c.inbound)
            if inbound >= 2:
                break
            holders.append(socket.create_connection(("127.0.0.1",
                                                     ports[0])))
            time.sleep(0.1)
        d = NodeService(Node(spec, "d", {}), ports[2], [ports[0]],
                        degree=2, genesis_time=now)
        services.append(d)
        d.start()
        deadline = time.time() + 30
        joined = False
        while time.time() < deadline and not joined:
            with d.lock:
                joined = ports[1] in d._known_peers and any(
                    c.alive for c in d.conns)
            with a.lock:
                joined = joined and ports[2] in a._known_peers
            time.sleep(0.1)
        assert joined, "the refused dialer never learned another peer"
        with a.lock:
            assert sum(1 for c in a.conns if c.alive and c.inbound) <= 2
    finally:
        for s in holders:
            s.close()
        for svc in services:
            svc.stop()
