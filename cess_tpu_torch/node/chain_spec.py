"""Chain specifications: genesis config for dev/local/test networks.

Reference: node/src/chain_spec.rs (dev/local/testnet/mainnet builders
plus baked raw specs, :84,210,318-434). A spec fully determines
genesis state, so every node starting from the same spec reaches the
same state root — the reproducible-genesis property the reference gets
from baked JSON specs.
"""
from __future__ import annotations

import dataclasses
import hashlib

from .. import constants
from ..chain.runtime import Runtime, RuntimeConfig
from ..crypto import ed25519

D = constants.DOLLARS


def eth_chain_id(chain_id: str) -> int:
    """One derivation for eth_chainId, net_version, AND the CHAINID
    opcode (stamped into genesis state below) — Eth tooling
    cross-checks all three."""
    return int.from_bytes(
        hashlib.sha256(chain_id.encode()).digest()[:4], "big")


@dataclasses.dataclass(frozen=True)
class ValidatorGenesis:
    account: str
    bond: int


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    name: str
    chain_id: str
    endowed: tuple[tuple[str, int], ...]
    validators: tuple[ValidatorGenesis, ...]
    era_blocks: int = constants.EPOCH_DURATION_BLOCKS * constants.SESSIONS_PER_ERA
    epoch_blocks: int = constants.EPOCH_DURATION_BLOCKS
    fragment_count: int = constants.FRAGMENT_COUNT
    max_validators: int = 100
    audit_challenge_life: int | None = None   # None -> audit defaults
    audit_verify_life: int | None = None
    sudo: str | None = None                    # dev root origin account
    # the spec version the chain was BORN at (part of the genesis
    # hash): any code version reproduces the genesis byte-exactly;
    # upgrades activate via system.apply_runtime_upgrade in a block.
    # 0 = resolved to the current code's version AT CONSTRUCTION, so
    # the stored field is always concrete and exports/imports
    # round-trip exactly.
    genesis_spec_version: int = 0

    def __post_init__(self):
        if self.genesis_spec_version == 0:
            from ..chain import migrations

            object.__setattr__(self, "genesis_spec_version",
                               migrations.SPEC_VERSION)

    def session_key(self, account: str) -> ed25519.SigningKey:
        """Deterministic dev session keys derived from the spec id —
        the analog of //Alice-style dev seeds. Production nodes load
        keys from their keystore instead."""
        return ed25519.SigningKey.generate(
            f"{self.chain_id}:{account}".encode())

    def account_key(self, account: str) -> ed25519.SigningKey:
        """Deterministic dev ACCOUNT keys (domain-separated from
        session keys): what extrinsics are signed with. Production
        accounts bring their own keys; dev chains derive them like
        //Alice seeds."""
        return ed25519.SigningKey.generate(
            f"{self.chain_id}/account:{account}".encode())

    def genesis_hash(self) -> bytes:
        """Chain identity bound into every signature (replay domain).
        Covers the FULL genesis configuration — two chains differing
        in any endowment, validator, or parameter have different
        signing domains."""
        from .. import codec

        return hashlib.sha256(b"cess-tpu-genesis:" + codec.encode((
            self.name, self.chain_id, self.endowed,
            tuple((v.account, v.bond) for v in self.validators),
            self.era_blocks, self.epoch_blocks, self.fragment_count,
            self.max_validators, self.audit_challenge_life,
            self.audit_verify_life, self.sudo,
            self.genesis_spec_version))).digest()

    def build_runtime(self) -> Runtime:
        rt = Runtime(RuntimeConfig(
            fragment_count=self.fragment_count, era_blocks=self.era_blocks,
            max_validators=self.max_validators,
            audit_challenge_life=self.audit_challenge_life,
            audit_verify_life=self.audit_verify_life,
            genesis_spec_version=self.genesis_spec_version))
        rt.set_genesis_hash(self.genesis_hash())
        rt.state.put("system", "chain_id", eth_chain_id(self.chain_id))
        if self.sudo:
            rt.system.set_sudo(self.sudo)
        for who, amount in self.endowed:
            rt.fund(who, amount)
            rt.system.bind_account_key(who, self.account_key(who).public)
        for v in self.validators:
            rt.fund(v.account, v.bond + 100 * D)
            rt.system.bind_account_key(v.account,
                                       self.account_key(v.account).public)
            rt.system.set_session_key(v.account,
                                      self.session_key(v.account).public)
            rt.apply_extrinsic(v.account, "staking.bond", v.bond)
            rt.apply_extrinsic(v.account, "staking.validate")
        rt.audit.set_keys(tuple(v.account for v in self.validators))
        rt.state.archive_events()
        return rt


def spec_to_json(spec: ChainSpec) -> dict:
    """Reproducible-genesis export (the reference's raw chain specs,
    node/src/chain_spec.rs:318-434): every field that determines
    genesis state, plus the derived genesis hash for integrity."""
    return {
        "name": spec.name, "chain_id": spec.chain_id,
        "endowed": [[w, a] for w, a in spec.endowed],
        "validators": [[v.account, v.bond] for v in spec.validators],
        "era_blocks": spec.era_blocks, "epoch_blocks": spec.epoch_blocks,
        "fragment_count": spec.fragment_count,
        "max_validators": spec.max_validators,
        "audit_challenge_life": spec.audit_challenge_life,
        "audit_verify_life": spec.audit_verify_life,
        "sudo": spec.sudo,
        "genesis_spec_version": spec.genesis_spec_version,
        "genesis_hash": "0x" + spec.genesis_hash().hex(),
    }


def spec_from_json(data: dict) -> ChainSpec:
    spec = ChainSpec(
        name=data["name"], chain_id=data["chain_id"],
        endowed=tuple((w, a) for w, a in data["endowed"]),
        validators=tuple(ValidatorGenesis(a, b)
                         for a, b in data["validators"]),
        era_blocks=data["era_blocks"], epoch_blocks=data["epoch_blocks"],
        fragment_count=data["fragment_count"],
        max_validators=data["max_validators"],
        audit_challenge_life=data["audit_challenge_life"],
        audit_verify_life=data["audit_verify_life"],
        sudo=data.get("sudo"),
        genesis_spec_version=data.get("genesis_spec_version", 0))
    want = data.get("genesis_hash")
    if want and "0x" + spec.genesis_hash().hex() != want:
        raise ValueError("chain spec genesis hash mismatch")
    return spec


def dev_spec(era_blocks: int = 60, epoch_blocks: int = 20) -> ChainSpec:
    """Single-authority dev chain (the reference's --dev)."""
    return ChainSpec(
        name="cess-tpu dev", chain_id="dev",
        endowed=(("alice", 1_000_000_000 * D), ("bob", 1_000_000_000 * D)),
        validators=(ValidatorGenesis("alice", 4_000_000 * D),),
        era_blocks=era_blocks, epoch_blocks=epoch_blocks, sudo="alice")


def local_spec(n_validators: int = 4, era_blocks: int = 120,
               epoch_blocks: int = 30) -> ChainSpec:
    """Multi-authority local testnet (the reference's local_testnet)."""
    vals = tuple(ValidatorGenesis(f"val{i}", 4_000_000 * D)
                 for i in range(n_validators))
    endowed = tuple((f"user{i}", 100_000_000 * D) for i in range(4)) \
        + (("faucet", 10_000_000_000 * D),)
    return ChainSpec(name="cess-tpu local", chain_id="local",
                     endowed=endowed, validators=vals,
                     era_blocks=era_blocks, epoch_blocks=epoch_blocks,
                     sudo="val0")
