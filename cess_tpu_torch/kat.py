"""Known answer: one small pipeline run and audit round, as a digest.

A fixed configuration (key seed, RS(4,8), 64 KiB segments, two segments
from a numpy seed, one audit round of 8 challenged blocks) whose
fragments, tags, challenge, coefficients and aggregated proof hash to
``DIGEST``. The test suite computes the same digest with the TPU package
and holds it to ``DIGEST``; ``chip_smoke.py`` runs the port on the card
and holds it to the same constant, so the card's output is checked
against the TPU package without running JAX there.
"""
from __future__ import annotations

import hashlib

import numpy as np

KEY_SEED = 7
DATA_SEED = 7
K, M = 4, 8
SEGMENT_SIZE = 64 * 1024
BATCH = 2
ROUND_SEED = b"cess-kat-round"
CHALLENGE_COUNT = 8
DIGEST = "0ebe528526198dcf0c9e77a8747f3befec1310169c549a56b63c080064f19bc8"


def segments() -> np.ndarray:
    return np.random.default_rng(DATA_SEED).integers(
        0, 256, (BATCH, SEGMENT_SIZE), dtype=np.uint8)


def id_pairs() -> np.ndarray:
    """(lo, hi) ids of the default arange fragment ids."""
    n = BATCH * (K + M)
    return np.stack([np.arange(n), np.zeros(n, np.int64)], axis=1).astype(np.uint32)


def digest(fragments, tags, idx, nu, r, mu, sigma) -> str:
    """sha256 over the fragment bytes and every audit value as
    little-endian 32-bit words (all arguments numpy arrays)."""
    h = hashlib.sha256(np.ascontiguousarray(fragments, dtype=np.uint8).tobytes())
    for a in (tags, idx, nu, r, mu, sigma):
        h.update(np.ascontiguousarray(
            np.asarray(a).astype(np.int64).astype("<u4")).tobytes())
    return h.hexdigest()


def run_port(device, strategy: str | None = None) -> tuple[str, bool]:
    """The port at the known-answer configuration on ``device`` under the
    codec ``strategy`` (the fragments are the same bytes under every
    strategy, so so is the digest): (digest, whether the aggregated proof
    verified)."""
    import torch

    from .models.pipeline import PipelineConfig, StoragePipeline
    from .ops import podr2

    dev = torch.device(device)
    cfg = PipelineConfig(k=K, m=M, segment_size=SEGMENT_SIZE,
                         strategy=strategy)
    key = podr2.Podr2Key.generate(KEY_SEED, device=dev)
    pipe = StoragePipeline(cfg, podr2_key=key, device=dev)
    out = pipe(torch.from_numpy(segments()).to(dev))
    n = BATCH * (K + M)
    frags = out["fragments"].reshape(n, -1)
    tags = out["tags"].reshape(n, *out["tags"].shape[2:])
    ids = id_pairs()
    idx, nu = podr2.gen_challenge(ROUND_SEED, cfg.blocks_per_fragment,
                                  CHALLENGE_COUNT, device=dev)
    r = podr2.aggregate_coeffs(ROUND_SEED, ids, device=dev)
    mu, sigma = podr2.prove_aggregate(frags, tags, idx, nu, r)
    ok = bool(podr2.verify_aggregate(key, ids, cfg.blocks_per_fragment,
                                     idx, nu, r, mu, sigma))
    host = [t.cpu().numpy() for t in (out["fragments"], out["tags"], idx, nu,
                                      r, mu, sigma)]
    return digest(*host), ok
