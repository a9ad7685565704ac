"""Inputs made from the seed: random streams, bytes, key material.

Every stream is ``numpy``'s generator under ``SeedSequence([seed,
stream])``, so the same seed gives the same inputs and the streams of one
run are independent. Bulk bytes are drawn on the device by a
``torch.Generator`` seeded the same way and fetched once.
"""
from __future__ import annotations

import hashlib

import numpy as np

from portbench.reference.m31 import P

WORKERS = 8        # threads of the reference's checks: the machine's cores
# stream numbers
KEY, BYTES, ORDER, OFFSETS, SAMPLE = range(5)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream (one or more numbers) of the seed."""
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed), *map(int, stream)]))


def key_material(seed: int, sectors: int, limbs: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(alpha [sectors, limbs] int64 in [0, p), PRF key words [2] uint32)."""
    g = rng(seed, KEY)
    alpha = g.integers(0, P, (sectors, limbs), dtype=np.int64)
    return alpha, g.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)


def device_bytes(seed: int, part: int, shape, device):
    """Uniform bytes of ``shape`` drawn on ``device`` (a torch uint8
    tensor), from the seed's byte stream number ``part``."""
    import torch

    ss = np.random.SeedSequence([int(seed), BYTES, part])
    g = torch.Generator(device=device).manual_seed(
        int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                         device=device, generator=g)


def host_bytes(seed: int, part: int, nbytes: int, device,
               chunk: int = 256 << 20) -> np.ndarray:
    """``nbytes`` bytes made on ``device`` in chunks and fetched into one
    host array."""
    out = np.empty(nbytes, dtype=np.uint8)
    for i, lo in enumerate(range(0, nbytes, chunk)):
        n = min(chunk, nbytes - lo)
        out[lo:lo + n] = device_bytes(seed, part * 4096 + i, (n,),
                                      device).cpu().numpy()
    return out


def digest(buf) -> bytes:
    return hashlib.sha256(buf).digest()
