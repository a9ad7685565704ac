"""Deterministic protocol state machine (the chain-equivalent layer).

Re-implements the reference's domain pallets (SURVEY.md §2.1) as a
transaction-apply library over a journaled KV store: balances, space
market (storage-handler), miner registry/economics (sminer), file
lifecycle (file-bank), PoDR2 audit rounds (audit), TEE registry
(tee-worker), gateway/cacher registries (oss, cacher), scheduler
credit, staking economics, and the named-task scheduler — composed by
``runtime.Runtime`` in the reference's on_initialize order.

Not a FRAME translation: pallets are plain Python classes over a
shared ``State``; extrinsics are methods dispatched transactionally
(journal rollback on error), events are appended per block. All heavy
data-plane compute stays in cess_tpu_torch.ops / .models — the chain
stores hashes and metadata only, mirroring the reference
(c-pallets/file-bank/src/lib.rs:423-428 trusts precomputed hashes).
"""
from .state import State, Event, DispatchError  # noqa: F401
