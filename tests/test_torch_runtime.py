"""The port's ``Runtime`` (cess_tpu_torch.chain.runtime) against the
reference's (cess_tpu.chain.runtime), step by step: the scenarios of
tests/test_chain.py, the runtime's migrations of tests/test_upgrade.py
and tests/test_state.py's runtime flow, plus the dispatch tables.

Each reference test runs as written with every ``Runtime`` it builds
replaced by a twin of both packages' runtimes
(tests/torch_runtime_twin.py): after every call on the twin both
runtimes hold the same state root and the same new events, and a refused
call fails on both with the same ``DispatchError`` name. Tolerance 0:
state roots are protocol facts. A reference test that imports the
runtime inside its body, or would run too long twice over, has a
counterpart here that takes its steps on the twin.
"""
import dataclasses
import importlib

import pytest

from cess_tpu import constants
from cess_tpu.chain import runtime as jrt
from cess_tpu_torch.chain import runtime as prt

from torch_chain_wiring import ROOT, Lockstep
from torch_runtime_twin import (Session, fixtures, reference_tests,
                                run_on_both)

D = constants.DOLLARS

CHAIN_TESTS = reference_tests("test_chain", {
    # 40 days of blocks, 50 s on one runtime: stepped over below
    "test_lease_freeze_and_death_gc": "long",
    # import the runtime or staking inside their bodies: below
    "test_reward_decay_schedule": "local import",
    "test_weight_based_fees": "local import",
})
UPGRADE_TESTS = ["test_fresh_chain_is_current_version",
                 "test_upgrade_extrinsic_migrates_old_state",
                 "test_evm_boundary", "test_evm_ledger_migration_v2"]


@pytest.mark.parametrize("name", CHAIN_TESTS)
def test_chain_scenario_on_both_runtimes(name, monkeypatch, tmp_path):
    run_on_both("test_chain", name, monkeypatch, tmp_path)


@pytest.mark.parametrize("name", UPGRADE_TESTS)
def test_upgrade_scenario_on_both_runtimes(name, monkeypatch, tmp_path):
    run_on_both("test_upgrade", name, monkeypatch, tmp_path)


def test_state_root_through_runtime_flows_on_both(monkeypatch, tmp_path):
    run_on_both("test_state", "test_root_through_runtime_flows",
                monkeypatch, tmp_path)


def test_lease_freeze_and_death_gc_on_both(monkeypatch, tmp_path):
    """tests/test_chain.py's lease test, with the empty stretches of its
    40 days skipped on both runtimes alike (the sweep compares the
    block with the deadline, so a jump over blocks with no lease event
    leaves the same steps)."""
    from cess_tpu.chain.storage_handler import FROZEN_GRACE_BLOCKS

    _, value_of = fixtures("test_chain", monkeypatch, tmp_path)
    ref = importlib.import_module("test_chain")
    rt = value_of("rt")
    ref.declare(rt)
    ref.complete_deal(rt)
    own = rt.storage_handler.owned_space(ref.ALICE)
    rt.state.block = own.deadline - 3
    rt.run_to_block(own.deadline + 1)
    assert rt.storage_handler.owned_space(ref.ALICE).state == "frozen"
    end = own.deadline + 1 + 10 * constants.ONE_DAY_BLOCKS + 2
    rt.state.block = own.deadline + FROZEN_GRACE_BLOCKS - 3
    rt.run_to_block(end)
    assert rt.file_bank.file(ref.FILE) is None
    assert rt.storage_handler.owned_space(ref.ALICE) is None
    assert rt.state.events_of("storage_handler", "LeaseDead")


def test_reward_decay_schedule_equal():
    from cess_tpu.chain.staking import Staking
    from cess_tpu_torch.chain.staking import Staking as PStaking

    for year in range(constants.REWARD_YEARS + 2):
        assert PStaking.rewards_in_year(year) == Staking.rewards_in_year(year)
    v0, s0 = PStaking.rewards_in_year(0)
    assert (v0, s0) == (constants.VALIDATOR_REWARD_YEAR1,
                        constants.SMINER_REWARD_YEAR1)
    assert PStaking.rewards_in_year(1)[0] == v0 * 841 // 1000
    assert PStaking.rewards_in_year(30) == (0, 0)


def test_weight_based_fees_signed_on_both():
    """tests/test_chain.py's signed-fee test on the twin, then the fees
    charged: the signed extrinsics applied in a block, 80% of each fee to
    the treasury and 20% to the block's author, nonces bumped, the key
    bound at first use; a feeless call charges nothing."""
    s = Session()
    rt = s.runtime()
    ed, ext = s.module("crypto.ed25519"), s.module("chain.extrinsic")
    key = ed.SigningKey.generate(b"w")
    g = rt.genesis_hash()
    light = ext.sign_extrinsic(key, g, "w", 0, "balances.transfer", ("x", 1))
    heavy = ext.sign_extrinsic(key, g, "w", 0, "sminer.regnstk",
                               ("w", b"p", 1))
    extra = rt.tx_fee(heavy) - rt.tx_fee(light)
    assert extra >= jrt.WEIGHT_FEE * jrt.CALL_WEIGHTS["sminer.regnstk"] \
        - jrt.WEIGHT_FEE * 16
    feeless = ext.sign_extrinsic(key, g, "w", 0, "im_online.heartbeat", ())
    assert rt.tx_fee(feeless) == 0

    rt.fund("w", 10 * D)
    rt.init_block(author="val")
    fee = rt.tx_fee(light)
    rt.apply_in_block(light)
    assert rt.system.nonce("w") == 1
    assert rt.system.account_key("w") == key.public
    assert rt.balances.free(jrt.TREASURY) == fee * 8 // 10
    assert rt.balances.free("val") == fee - fee * 8 // 10
    assert rt.balances.free("w") == 10 * D - fee - 1
    # a replay: BadNonce, no fee, an ExtrinsicFailed event
    rt.apply_in_block(light)
    assert rt.balances.free("w") == 10 * D - fee - 1
    assert [dict(e.data)["error"] for e in rt.state.events_of(
        "system", "ExtrinsicFailed")] == ["system.BadNonce"]


def test_dispatch_tables_equal():
    assert prt.CALL_WEIGHTS == jrt.CALL_WEIGHTS
    assert prt.DISPATCHABLE == jrt.DISPATCHABLE
    assert prt.SIGNED_CALLS == jrt.SIGNED_CALLS
    assert prt.FEELESS == jrt.FEELESS
    assert prt.ROOT_ONLY == jrt.ROOT_ONLY
    assert prt.HAND_WEIGHTS == jrt.HAND_WEIGHTS
    assert (prt.WEIGHT_FEE, prt.ROOT, prt.TREASURY) \
        == (jrt.WEIGHT_FEE, jrt.ROOT, jrt.TREASURY)
    from cess_tpu.chain import extrinsic, migrations, offences
    from cess_tpu_torch.chain import extrinsic as pext
    from cess_tpu_torch.chain import migrations as pmig
    from cess_tpu_torch.chain import offences as poff

    assert pext.SIGNING_CONTEXT == extrinsic.SIGNING_CONTEXT
    assert poff.VOTE_SIGNING_CONTEXT == offences.VOTE_SIGNING_CONTEXT
    assert pmig.SPEC_VERSION == migrations.SPEC_VERSION
    assert dataclasses.asdict(prt.RuntimeConfig()) \
        == dataclasses.asdict(jrt.RuntimeConfig())


def test_apply_runtime_upgrade_on_an_older_spec():
    """The port's ``System.apply_runtime_upgrade`` (missing before the
    port had ``chain/migrations``): on a state stamped with spec 109 it
    runs the same migrations as the reference's, in band, with equal
    events and state roots; a second activation migrates nothing; and
    on a bare ``System(State())`` both packages end alike."""
    p = Lockstep(genesis_spec_version=109, era_blocks=1000)
    assert p.q(lambda c: p.mod("chain.migrations", p.chains.index(c))
               .spec_version(c.state)) == 109
    p.fund("v9", 2_000_000 * D)
    p.x("v9", "staking.bond", 1_500_000 * D)
    p.each("old format", lambda c: (
        c.state.put("staking", "validators", ("v9",)),
        c.state.put("tee_worker", "ias_pins", (b"\xab" * 32,))))
    p.blocks(1)
    p.x(ROOT, "system.apply_runtime_upgrade")
    names = p.q(lambda c: sorted(dict(e.data)["migration"] for e in
                                 c.state.events_of("system",
                                                   "MigrationApplied")))
    assert names == sorted({"staking-v2(1)", "staking-v3(1)",
                            "tee_worker-v2(1)", "tee_worker-v3(0)",
                            "evm-v2(0)", "contracts-v2(0)"})
    p.x(ROOT, "system.apply_runtime_upgrade")
    assert len(p.q(lambda c: c.state.events_of(
        "system", "MigrationApplied"))) == len(names)

    from cess_tpu.chain import state as jstate
    from cess_tpu.chain import system as jsystem
    from cess_tpu_torch.chain import state as pstate
    from cess_tpu_torch.chain import system as psystem

    a, b = jstate.State(), pstate.State()
    jsystem.System(a).apply_runtime_upgrade()
    psystem.System(b).apply_runtime_upgrade()
    assert a.state_root() == b.state_root()
    assert [(e.pallet, e.name, e.data) for e in a.events] \
        == [(e.pallet, e.name, e.data) for e in b.events]


def test_retired_bls_format_migration_on_both():
    """tests/test_upgrade.py's migration run (its test at :218, the
    runtime at :223), on the twin: tee_worker v3 wraps a bytes-format
    retired key into the append-only tuple format, in band."""
    s = Session()
    migrations = s.module("chain.migrations")
    rt = s.runtime(jrt.RuntimeConfig(era_blocks=1000,
                                     genesis_spec_version=109))
    st = rt.state
    st.put("tee_worker", "retired_bls", "old-tee", b"\x01" * 96)
    st.put("system", "storage_version", "tee_worker", 2)
    rt.system.set_sudo("alice")
    rt.fund("alice", 10**12)
    rt.init_block()
    rt.apply_extrinsic("root", "system.apply_runtime_upgrade")
    assert migrations.storage_version(st, "tee_worker") == 3
    assert st.get("tee_worker", "retired_bls", "old-tee") == (b"\x01" * 96,)
    assert rt.tee_worker.bls_key_of("old-tee") == b"\x01" * 96
