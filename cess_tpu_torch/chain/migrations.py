"""Runtime versioning + StorageVersion-gated migrations.

The reference stamps the runtime with ``spec_version: 109``
(runtime/src/lib.rs:173) and migrates pallet storage
through ``StorageVersion`` gates in on_runtime_upgrade
(c-pallets/audit/src/migrations.rs:29-40: run only when the on-chain
version is behind, transform entries, bump the version). Same design
here: each pallet has an on-chain storage version; registered
migrations run INSIDE block execution at the first block authored by
upgraded code (deterministic across replicas, part of the state root
like the reference's runtime-upgrade block), then bump versions.

Real migrations in the registry (round-2 -> round-3 format changes):
- staking v1 -> v2: validators gained ValidatorPrefs (commission);
  pre-existing validators get the default 0 entry.
- tee_worker v1 -> v2: pinned attestation signers changed from
  32-byte key FINGERPRINTS to full RsaPublicKey roots (fingerprints
  cannot verify cert chains and cannot be inverted) — stale-format
  pins are dropped and must be re-pinned by governance.
"""
from __future__ import annotations

from .state import State

SPEC_VERSION = 112   # reference snapshot is 109 (runtime/src/lib.rs:173)

SYSTEM = "system"


def spec_version(state: State) -> int:
    return state.get(SYSTEM, "spec_version", default=0)


def storage_version(state: State, pallet: str) -> int:
    return state.get(SYSTEM, "storage_version", pallet, default=1)


def _migrate_staking_v2(state: State) -> int:
    """Backfill ValidatorPrefs (commission=0) for existing validators."""
    n = 0
    for v in state.get("staking", "validators", default=()):
        if not state.contains("staking", "prefs", v):
            state.put("staking", "prefs", v, 0)
            n += 1
    return n


def _migrate_tee_worker_v2(state: State) -> int:
    """Drop fingerprint-format (bytes) attestation pins; structured
    chain verification needs full root keys, re-pinned by governance."""
    from ..crypto.rsa import RsaPublicKey

    pins = state.get("tee_worker", "ias_pins", default=())
    kept = tuple(p for p in pins if isinstance(p, RsaPublicKey))
    if kept != pins:
        state.put("tee_worker", "ias_pins", kept)
    return len(pins) - len(kept)


def _migrate_tee_worker_v3(state: State) -> int:
    """retired_bls changed from a single bytes key to an append-only
    tuple of era keys (exit/re-register must not lose old eras): wrap
    old-format entries."""
    n = 0
    for key, v in list(state.iter_prefix("tee_worker", "retired_bls")):
        if isinstance(v, bytes):
            state.put("tee_worker", "retired_bls", *key, (v,))
            n += 1
    return n


def _migrate_evm_v2(state: State) -> int:
    """EVM ledger re-key (round-5): balances/nonces moved from
    native-account-string keys to 20-byte EVM addresses, and the
    backing model changed from per-depositor reserves to the EVM_POT
    pot account (value-carrying calls need any address's balance to be
    pot-covered). Old entries are re-keyed and their reserve backing
    is released into the pot, so pre-upgrade deposits stay withdrawable."""
    from .evm import EVM_POT, eth_address

    n = 0
    for (who,), bal in list(state.iter_prefix("evm", "balance")):
        if not isinstance(who, str):
            continue
        state.delete("evm", "balance", who)
        addr = eth_address(who)
        state.put("evm", "balance", addr,
                  state.get("evm", "balance", addr, default=0) + bal)
        reserved = state.get("balances", "reserved", who, default=0)
        moved = min(reserved, bal)
        state.put("balances", "reserved", who, reserved - moved)
        state.put("balances", "free", EVM_POT,
                  state.get("balances", "free", EVM_POT, default=0)
                  + moved)
        n += 1
    for (who,), nonce in list(state.iter_prefix("evm", "nonce")):
        if isinstance(who, str):
            state.delete("evm", "nonce", who)
            state.put("evm", "nonce", eth_address(who), nonce)
            n += 1
    return n


def _migrate_staking_v3(state: State) -> int:
    """Build the VoterList bags index (round-5) for validators that
    predate it; top_stakers falls back to the flat set until this
    runs, so an un-upgraded restart keeps electing correctly."""
    from .staking import PALLET as STAKING, Staking

    n = 0
    for who in state.get(STAKING, "validators", default=()):
        if state.get(STAKING, "bag_of", who) is not None:
            continue
        b = Staking.bag_index(state.get(STAKING, "bond", who, default=0))
        state.put(STAKING, "bag", b,
                  state.get(STAKING, "bag", b, default=()) + (who,))
        state.put(STAKING, "bag_of", who, b)
        state.put(STAKING, "bag_count",
                  state.get(STAKING, "bag_count", default=0) + 1)
        n += 1
    return n


def _migrate_contracts_v2(state: State) -> int:
    """Contracts code moved behind the canonical code-hash store
    (round-5): inline per-address bodies become hash references with
    the body stored once per hash (pallet-contracts CodeStorage)."""
    from .contracts import code_hash

    n = 0
    for (addr,), code in list(state.iter_prefix("contracts", "code")):
        if isinstance(code, tuple):
            h = code_hash(code)
            if not state.contains("contracts", "code_store", h):
                state.put("contracts", "code_store", h, code)
            state.put("contracts", "code", addr, h)
            n += 1
    return n


# (pallet, target_version, fn) — fn returns #entries transformed
MIGRATIONS = [
    ("staking", 2, _migrate_staking_v2),
    ("staking", 3, _migrate_staking_v3),
    ("tee_worker", 2, _migrate_tee_worker_v2),
    ("tee_worker", 3, _migrate_tee_worker_v3),
    ("evm", 2, _migrate_evm_v2),
    ("contracts", 2, _migrate_contracts_v2),
]


def current_versions() -> dict[str, int]:
    out: dict[str, int] = {}
    for pallet, target, _ in MIGRATIONS:
        out[pallet] = max(out.get(pallet, 1), target)
    return out


def stamp_genesis(state: State, version: int = SPEC_VERSION) -> None:
    """Stamp genesis at the CHAIN's genesis spec version (a ChainSpec
    field, part of the genesis hash) — NOT the running code's version.
    Any code version therefore reproduces a historical chain's genesis
    byte-exactly; upgrades activate only via the in-band
    system.apply_runtime_upgrade extrinsic, so full replay from
    genesis stays deterministic across code versions."""
    state.put(SYSTEM, "spec_version", version)
    versions = current_versions() if version >= SPEC_VERSION \
        else {pallet: 1 for pallet in current_versions()}
    for pallet, v in sorted(versions.items()):
        state.put(SYSTEM, "storage_version", pallet, v)


def run_pending(state: State) -> list[str]:
    """on_runtime_upgrade: run every migration whose pallet storage
    version is behind; bump versions + spec_version. Invoked by the
    system.apply_runtime_upgrade extrinsic (root/council), so the
    migration block is part of consensus — every replica and every
    future replayer on upgraded code executes it at the same height
    (the reference records upgrades the same way: set_code in a
    block, migrations at that block's on_runtime_upgrade). Returns
    the applied migration names (events are the caller's job)."""
    applied = []
    for pallet, target, fn in MIGRATIONS:
        if storage_version(state, pallet) < target:
            n = fn(state)
            state.put(SYSTEM, "storage_version", pallet, target)
            applied.append(f"{pallet}-v{target}({n})")
    if spec_version(state) < SPEC_VERSION:
        state.put(SYSTEM, "spec_version", SPEC_VERSION)
    return applied
