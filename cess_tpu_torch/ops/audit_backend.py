"""The ``AuditBackend`` gate: the PoDR2 surface bound to one device.

The counterpart of ``cess_tpu/ops/audit_backend.py``.
``make_audit_backend(key, backend)`` mirrors ``rs.make_codec``: "cuda",
None or "auto" run on the card and raise when none is present; "cpu"
is the explicit host choice. The math is the same on every device, so the gate
chooses where a batch runs, never what it computes. Inputs (numpy or
tensors) are moved to the backend's device.

Fault seams (``resilience/faults.py``): ``podr2.<op>.<device type>``
with the TPU package's grouping of ops: ``tag``; ``prove``, which covers
``aggregate_coeffs``; ``verify``; ``gen_challenge`` has none. The
suffix is ``cuda`` on the card (where the TPU package says ``tpu``) and
``cpu`` on the host, so a chaos plan can fail the card's gate while the
CPU instance, the engine's degradation target, stays clean.
"""
from __future__ import annotations

import torch

from .._device import resolve_device
from ..resilience import faults
from . import podr2


class AuditBackend:
    """Tag generation (TEE), challenge derivation, proving (miner,
    aggregated constant-size proofs) and verification (TEE)."""

    def __init__(self, key: podr2.Podr2Key, device):
        self.device = resolve_device(device)
        self.key = key.to(self.device)
        self._site = f"podr2.{{}}.{self.device.type}"

    def _t(self, x) -> torch.Tensor | None:
        return None if x is None else torch.as_tensor(x).to(self.device)

    def _inject(self, op: str) -> None:
        faults.inject(self._site.format(op))

    def tag_fragments(self, fragment_ids, fragments):
        self._inject("tag")
        return podr2.tag_fragments(self.key, fragment_ids, self._t(fragments))

    def gen_challenge(self, seed: bytes, num_blocks: int,
                      count: int | None = None):
        return podr2.gen_challenge(seed, num_blocks, count, self.device)

    def prove_batch(self, fragments, tags, idx, nu):
        self._inject("prove")
        return podr2.prove_batch(self._t(fragments), self._t(tags),
                                 self._t(idx), self._t(nu))

    def prove_aggregate(self, fragments, tags, idx, nu, r,
                        sectors: int = podr2.SECTORS):
        self._inject("prove")
        return podr2.prove_aggregate(self._t(fragments), self._t(tags),
                                     self._t(idx), self._t(nu), self._t(r),
                                     sectors)

    def aggregate_coeffs(self, seed: bytes, fragment_ids):
        self._inject("prove")
        return podr2.aggregate_coeffs(seed, fragment_ids, self.device)

    def verify_batch(self, fragment_ids, num_blocks, idx, nu, mu, sigma):
        self._inject("verify")
        return podr2.verify_batch(self.key, fragment_ids, num_blocks,
                                  self._t(idx), self._t(nu), self._t(mu),
                                  self._t(sigma))

    def verify_aggregate(self, fragment_ids, num_blocks, idx, nu, r, mu,
                         sigma):
        self._inject("verify")
        return podr2.verify_aggregate(self.key, fragment_ids, num_blocks,
                                      self._t(idx), self._t(nu), self._t(r),
                                      self._t(mu), self._t(sigma))


def make_audit_backend(key: podr2.Podr2Key,
                       backend: str | None = None) -> AuditBackend:
    """backend: "cuda", or None and "auto" (the default: the card,
    raising when none is present), or "cpu" (the explicit host choice)."""
    if backend not in (None, "auto", "cpu", "cuda"):
        raise ValueError(f"unknown AuditBackend {backend!r}")
    return AuditBackend(key, None if backend == "auto" else backend)
