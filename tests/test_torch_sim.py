"""The JAX package's simulated network with the port as its device plane.

The one place where both packages meet at system level: a scenario of
``cess_tpu.sim`` runs once with the JAX package alone, and once with the
port installed under the JAX agents (``cess_tpu.node.offchain``):

- ``offchain.podr2`` becomes a ``HostPodr2`` on the CPU whose
  ``key_adapter`` converts the chain's JAX key through
  ``convert.podr2_key_from_arrays``;
- ``cess_tpu.ops.rs.make_codec`` becomes ``host_codec`` on the CPU;
- ``cess_tpu.models.pipeline.StoragePipeline`` becomes a factory that
  converts the JAX config and key into an ``AgentPipeline`` on the CPU.

The two runs must give the same ``SimReport.witness()``: it holds the
finalized chain, and so every declared fragment hash, every proof's
verdict and the custody ledger. Both runs are strict (a failed invariant
raises). The JAX package's tag, prove and verify and its ``make_codec``
must see no call in the port's run. No scenario here arms a fault site.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from cess_tpu.models import pipeline as jpipeline
from cess_tpu.node import offchain as joff
from cess_tpu.ops import podr2 as jpodr2
from cess_tpu.ops import rs as jrs
from cess_tpu.sim.scenarios import SCENARIOS, run_scenario
from cess_tpu_torch import convert
from cess_tpu_torch.models.pipeline import PipelineConfig
from cess_tpu_torch.node import offchain

SEED = b"port-join"
N_NODES = 20


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def adapt(jkey):
    return convert.podr2_key_from_arrays(
        np.asarray(jkey.alpha), np.asarray(jax.random.key_data(jkey.prf_key)),
        "cpu")


def cached_adapter():
    """``adapt`` converting each JAX key once (the chain holds one key
    for the whole run and the agents pass it on every call)."""
    seen = {}

    def adapter(jkey):
        hit = seen.get(id(jkey))
        if hit is None or hit[0] is not jkey:
            hit = seen[id(jkey)] = (jkey, adapt(jkey))  # holds jkey: id kept
        return hit[1]
    return adapter


def spy(counts: dict, name: str, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kwargs)
    return wrapper


def install_port(monkeypatch) -> tuple[offchain.HostPodr2, dict, dict]:
    """Put the port under the JAX agents; returns the HostPodr2, the
    port's call counts and the JAX package's."""
    ops = offchain.HostPodr2("cpu", key_adapter=cached_adapter())
    port, jax_calls = {}, {}
    for name in ("tag_fragments", "gen_challenge", "aggregate_coeffs",
                 "prove_aggregate", "verify_aggregate"):
        setattr(ops, name, spy(port, name, getattr(ops, name)))

    def pipeline(config, podr2_key=None, engine=None):
        if engine is not None:
            raise ValueError("the port's pipeline takes a port engine")
        port["pipelines"] = port.get("pipelines", 0) + 1
        return offchain.AgentPipeline(
            PipelineConfig(k=config.k, m=config.m,
                           segment_size=config.segment_size,
                           strategy=config.strategy, sectors=config.sectors),
            podr2_key=None if podr2_key is None else adapt(podr2_key),
            device="cpu")

    def make_codec(k, m, backend=None, strategy=None):
        port["codecs"] = port.get("codecs", 0) + 1
        return offchain.host_codec(k, m, "regen" if backend == "regen"
                                   else None, strategy, device="cpu")

    for name in ("tag_fragments", "prove_aggregate", "verify_aggregate"):
        monkeypatch.setattr(jpodr2, name, spy(jax_calls, name,
                                              getattr(jpodr2, name)))
    monkeypatch.setattr(jpodr2.Podr2Key, "generate", staticmethod(spy(
        jax_calls, "generate", jpodr2.Podr2Key.generate)))
    monkeypatch.setattr(joff, "podr2", ops)
    monkeypatch.setattr(jrs, "make_codec", make_codec)
    monkeypatch.setattr(jpipeline, "StoragePipeline", pipeline)
    for name in ("encode_step", "tag_step"):
        monkeypatch.setattr(offchain.AgentPipeline, name, spy(
            port, name, getattr(offchain.AgentPipeline, name)))
    return ops, port, jax_calls


@pytest.mark.parametrize("name", ["adversarial_audit", "miner_attrition"])
def test_scenario_witness_equal_with_the_port_installed(name, monkeypatch):
    scenario = SCENARIOS[name]
    want = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    jax_make_codec = jrs.make_codec
    codec_calls = jax_make_codec.cache_info()
    _, port, jax_calls = install_port(monkeypatch)
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    assert got.witness() == want.witness()
    assert got.rounds_run == want.rounds_run == scenario.rounds
    # the port did the device work, the JAX package none of it
    assert isinstance(got.world.pipeline, offchain.AgentPipeline)
    assert port["pipelines"] == 1 and port["encode_step"] > 0 \
        and port["tag_step"] > 0
    assert got.world.pipeline.fragment_uploads == 0
    for fn in ("tag_fragments", "gen_challenge", "aggregate_coeffs",
               "prove_aggregate", "verify_aggregate"):
        assert port.get(fn, 0) > 0, fn
    assert not any(jax_calls.get(fn) for fn in (
        "tag_fragments", "prove_aggregate", "verify_aggregate"))
    assert jax_calls["generate"] >= 1          # the key the adapter converts
    assert jax_make_codec.cache_info() == codec_calls


def test_repair_storm_witness_equal_with_the_port_pool(monkeypatch):
    """``repair_storm`` (RS(2,2), 6 miners, 2 killed at once, repairs by
    regen symbols fanned over a 3-lane pool engine while a seeded fault
    trips every repair dispatch on lane 0): its engine becomes a port
    engine, a ``RegenCodec`` and a CPU ``AuditBackend`` with the JAX
    key adapted, over ``DevicePool(["cpu"] * 3)``. The port engine's
    fault sites and flight notes go through the JAX plan and recorder
    the scenario arms. The same witness as the JAX-only run."""
    from cess_tpu.obs import flight as jflight
    from cess_tpu.resilience import faults as jfaults
    from cess_tpu.sim import scenarios
    from cess_tpu_torch.obs import flight as tflight
    from cess_tpu_torch.ops import regen
    from cess_tpu_torch.ops.audit_backend import make_audit_backend
    from cess_tpu_torch.resilience import ResilienceConfig
    from cess_tpu_torch.resilience import faults as tfaults
    from cess_tpu_torch.serve import DevicePool, SubmissionEngine

    scenario = SCENARIOS["repair_storm"]
    want = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    install_port(monkeypatch)
    monkeypatch.setattr(tfaults, "inject", jfaults.inject)
    monkeypatch.setattr(tflight, "note", jflight.note)
    built = []

    def pool_engine(world, profile=False, regen_codec=False, lanes=True):
        assert not profile and regen_codec and lanes == 3
        cfg = world.pipeline.config
        eng = SubmissionEngine(
            regen.RegenCodec(cfg.k, cfg.m, device="cpu"),
            make_audit_backend(world.pipeline.podr2_key, "cpu"),
            resilience=ResilienceConfig(), pool=DevicePool(["cpu"] * lanes))
        built.append(eng)
        return eng

    monkeypatch.setattr(scenarios, "_pool_engine",
                        lambda world, profile=False, regen=False, lanes=True:
                        pool_engine(world, profile, regen, lanes))
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    assert got.witness() == want.witness()
    assert got.rounds_run == want.rounds_run == scenario.rounds
    (eng,) = built
    snap = eng.pool.snapshot()
    assert got.pool == want.pool == snap
    lanes = snap["lanes"]
    assert lanes[0]["breakers"]["codec"] == "open"
    assert sum(ln["batches"] for ln in lanes[1:]) > 0
    trips = [e for e in got.recorder.journal_tail("breaker")
             if e["kind"] == "trip"]
    assert any(e["detail"]["name"] == "codec.d0" for e in trips)


def _timing_free(snap: dict) -> dict:
    """A ProfilePlane snapshot without its host timings: the counts a
    replay must reproduce."""
    snap = json.loads(json.dumps(snap))
    for acct in snap["ops"]["accounts"]:
        for k in ("queue_s", "h2d_s", "dispatch_s", "sync_s"):
            del acct[k]
    del snap["ops"]["windowed_GiBps"]
    for prog in snap["compiles"]["programs"].values():
        del prog["wall_s"]
    del snap["compiles"]["events"]
    return snap


def test_gateway_hotspot_pool_replays_on_the_port_with_its_profile(
        monkeypatch):
    """``gateway_hotspot_pool`` (a pool engine over every device, lane 0
    raising on every dispatch, ``profile=True``): its engine becomes a
    port engine over as many ``"cpu"`` lanes as the JAX run has devices,
    carrying the port's ``ProfilePlane``. The same witness as the
    JAX-only run, the same pool snapshot, and the same profile: every
    account, pad and compile count equal (host timings aside)."""
    from cess_tpu.obs import flight as jflight
    from cess_tpu.resilience import faults as jfaults
    from cess_tpu.sim import scenarios
    from cess_tpu_torch.obs import flight as tflight
    from cess_tpu_torch.obs.profile import ProfilePlane
    from cess_tpu_torch.ops import rs
    from cess_tpu_torch.ops.audit_backend import make_audit_backend
    from cess_tpu_torch.resilience import ResilienceConfig
    from cess_tpu_torch.resilience import faults as tfaults
    from cess_tpu_torch.serve import DevicePool, SubmissionEngine

    scenario = SCENARIOS["gateway_hotspot_pool"]
    want = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    assert want.profile is not None
    install_port(monkeypatch)
    monkeypatch.setattr(tfaults, "inject", jfaults.inject)
    monkeypatch.setattr(tflight, "note", jflight.note)
    built = []

    def pool_engine(world, profile=False, regen=False, lanes=True):
        assert profile and not regen and lanes is True
        cfg = world.pipeline.config
        eng = SubmissionEngine(
            rs.make_codec(cfg.k, cfg.m, "cpu"),
            make_audit_backend(world.pipeline.podr2_key, "cpu"),
            resilience=ResilienceConfig(),
            pool=DevicePool(["cpu"] * len(jax.devices())),
            profile=ProfilePlane())
        built.append(eng)
        return eng

    monkeypatch.setattr(scenarios, "_pool_engine", pool_engine)
    got = run_scenario(scenario, SEED, n_nodes=N_NODES, strict=True)
    assert got.witness() == want.witness()
    assert got.rounds_run == want.rounds_run == scenario.rounds
    (eng,) = built
    plane = eng.profile
    assert got.pool == want.pool
    assert got.pool["lanes"][0]["breakers"]["codec"] == "open"
    assert _timing_free(got.profile) == _timing_free(want.profile)
    assert got.profile["watchdog"] is None
    pads = plane.pads.total()
    assert pads["served"] > 0 and set(pads["sources"]) == {"engine"}
    assert plane.ops.canon()["observations"] > 0
    assert plane.compiles.canon()["builds"] > 0
    assert got.reporter.witness() == want.reporter.witness()
