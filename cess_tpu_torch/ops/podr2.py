"""PoDR2 proof of storage on torch tensors: tag, challenge, prove, verify.

The counterpart of ``cess_tpu/ops/podr2.py``, with the same scheme (a
Shacham-Waters private-verification MAC over F_p^limbs, p = 2^31 - 1)
and bit-identical protocol values: a tag, challenge, aggregation
coefficient, proof or verdict computed here equals the TPU package's on
the same inputs and key.

- A fragment is split into blocks of ``sectors`` field elements (two
  little-endian bytes each): 16384 blocks of 512 bytes per 8 MiB.
- Tag: ``tag[b] = f_k(id, b) + sum_j alpha[j] * m[b, j]`` per limb,
  on the card through kernels ``prf_blocks`` and ``podr2_tag``.
- Challenge: block indices and coefficients nu from the round seed.
- Prove: ``mu[j] = sum_i nu_i m[I_i, j]``, ``sigma = sum_i nu_i
  tag[I_i]``, optionally folded across fragments with coefficients r.
- Verify: ``sigma == sum_i nu_i f_k(id, I_i) + sum_j alpha[j] mu[j]``
  in every limb, with the PRF evaluated only at the challenged blocks.

Prove and verify are plain tensor code on the device of their inputs.
Field elements are int32 tensors, block indices int64, ids int64 [F, 2]
(lo, hi) word pairs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import constants
from .._device import resolve_device
from . import pfield as pf
from . import prf
from .podr2_kernel import podr2_tag, prf_blocks, weight_table

SECTORS = 256                                 # field elements per block
BLOCK_BYTES = SECTORS * pf.BYTES_PER_ELEM     # 512
LIMBS = 2                                     # MAC limbs: soundness ~p^-2
PROOF_BYTES = (SECTORS + LIMBS) * 4           # raw mu + sigma payload
assert (SECTORS + 3) * 4 <= constants.SIGMA_MAX  # limbs=3 fits too


@dataclasses.dataclass(frozen=True)
class Podr2Params:
    sectors: int = SECTORS
    limbs: int = LIMBS

    def blocks_for(self, fragment_bytes: int) -> int:
        block_bytes = self.sectors * pf.BYTES_PER_ELEM
        if fragment_bytes % block_bytes:
            raise ValueError(f"fragment {fragment_bytes} B not divisible by "
                             f"block {block_bytes} B")
        return fragment_bytes // block_bytes


@dataclasses.dataclass(frozen=True, eq=False)
class Podr2Key:
    """The TEE-held secret key: alpha [sectors, limbs] int32 in [0, p)
    and the raw threefry key words prf_key [2] int64, on one device,
    with the tag kernel's interleaved weights [limbs, 2*sectors] derived
    from alpha once, at construction (``podr2_kernel.weight_table``)."""

    alpha: torch.Tensor
    prf_key: torch.Tensor
    weights: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "weights", weight_table(self.alpha))

    @property
    def limbs(self) -> int:
        return self.alpha.shape[1]

    @staticmethod
    def generate(seed: int, params: Podr2Params = Podr2Params(),
                 device=None) -> "Podr2Key":
        alpha, prf_key = prf.podr2_key_material(seed, params.sectors,
                                                params.limbs)
        return Podr2Key(alpha, prf_key).to(resolve_device(device))

    def to(self, device) -> "Podr2Key":
        device = torch.device(device)
        if self.alpha.device == device and self.prf_key.device == device:
            return self
        return Podr2Key(self.alpha.to(device), self.prf_key.to(device))


def keys_equal(a: Podr2Key, b: Podr2Key) -> bool:
    """Value equality of two keys (alpha and PRF key words)."""
    if a is b:
        return True
    return (torch.equal(a.alpha.cpu(), b.alpha.cpu())
            and torch.equal(a.prf_key.cpu(), b.prf_key.cpu()))


def fragment_id_from_hash(fragment_hash: bytes) -> np.ndarray:
    """Protocol fragment id: the low 8 bytes of the fragment hash as a
    (lo, hi) uint32 pair. Ids must be unique per key."""
    v = int.from_bytes(fragment_hash[:8], "little")
    return np.array([v & 0xFFFFFFFF, v >> 32], dtype=np.uint32)


def fragment_id_pairs(ids, device) -> torch.Tensor:
    """Ids as int64 [F, 2] (lo, hi) words on ``device``: [F, 2] pairs are
    taken as they are, scalar ids [F] (or a single int) fold in as
    ``(id & 0xFFFFFFFF, id >> 32)``."""
    if isinstance(ids, np.ndarray):
        ids = ids.astype(np.int64) if ids.dtype.kind == "u" else ids
    t = torch.as_tensor(ids, device=device).to(torch.int64)
    if t.dim() == 2 and t.shape[1] == 2:
        return t & pf.MASK32
    t = t.reshape(-1)
    return torch.stack([t & pf.MASK32, (t >> 32) & pf.MASK32], dim=1)


def fragment_to_elems(fragment: torch.Tensor,
                      sectors: int = SECTORS) -> torch.Tensor:
    """uint8 [..., fragment_bytes] -> int64 [..., blocks, sectors]."""
    *lead, nbytes = fragment.shape
    elems = pf.pack_bytes(fragment)
    return elems.reshape(*lead, nbytes // (sectors * pf.BYTES_PER_ELEM),
                         sectors)


def _id_pairs(ids, device) -> torch.Tensor:
    """Ids read as the aggregation protocol reads them: ``reshape(-1, 2)``
    into (lo, hi) pairs, as the TPU package's ``aggregate_coeffs`` and
    ``verify_aggregate`` do (a flat id list pairs up consecutive ids)."""
    if not isinstance(ids, (torch.Tensor, np.ndarray)):
        ids = np.asarray(ids)
    return fragment_id_pairs(ids.reshape(-1, 2), device)


def _one_id(fragment_id, device) -> torch.Tensor:
    """One fragment's id as [1, 2]: an int, a scalar, or a (lo, hi) pair."""
    if not isinstance(fragment_id, (torch.Tensor, np.ndarray)):
        fragment_id = np.asarray(fragment_id)
    if tuple(fragment_id.shape) == (2,):
        fragment_id = fragment_id.reshape(1, 2)
    ids = fragment_id_pairs(fragment_id, device)
    if ids.shape[0] != 1:
        raise ValueError(f"expected one fragment id, got {ids.shape[0]}")
    return ids


def prf_elems_at(prf_key: torch.Tensor, fragment_id, block_idx,
                 limbs: int = LIMBS) -> torch.Tensor:
    """f_k(fragment_id, b) at the given block indices -> [len, limbs]."""
    dev = prf_key.device
    idx = torch.as_tensor(block_idx, device=dev).to(torch.int64).reshape(-1)
    return prf_blocks(prf_key, _one_id(fragment_id, dev), idx, idx.shape[0],
                      limbs)[0]


def prf_elems(prf_key: torch.Tensor, fragment_id, n: int,
              limbs: int = LIMBS) -> torch.Tensor:
    """f_k(fragment_id, 0..n-1) -> [n, limbs]."""
    return prf_blocks(prf_key, _one_id(fragment_id, prf_key.device), None, n,
                      limbs)[0]


def tag_from_elems(alpha: torch.Tensor, f: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    """Tags [B, limbs] int32 from the PRF slice f [B, limbs] and packed
    data m [B, s]: ``f + m @ alpha`` in each limb (plain tensor code)."""
    mac = pf.dotmod(m[..., None], alpha[None, :, :], dim=-2)
    return pf.addmod(f, mac).to(torch.int32)


def tag_fragment(key: Podr2Key, fragment_id, fragment) -> torch.Tensor:
    """Tags of one fragment: uint8 [fragment_bytes] -> int32 [blocks,
    limbs], on the fragment's device (the PRF through ``prf_blocks``)."""
    fragment = torch.as_tensor(fragment)
    key = key.to(fragment.device)
    m = fragment_to_elems(fragment, key.alpha.shape[0])          # [B, s]
    return tag_from_elems(key.alpha, prf_elems(key.prf_key, fragment_id,
                                               m.shape[0], key.limbs), m)


def tag_fragments(key: Podr2Key, fragment_ids, fragments: torch.Tensor,
                  first_block: int | None = None) -> torch.Tensor:
    """Tags [F, blocks, limbs] int32 of fragments [F, bytes] uint8 with
    ids [F] or [F, 2], on the fragments' device.

    ``first_block``: the fragments are a byte shard of longer fragments
    whose first block has this index; the PRF is evaluated at the
    shard's own block indices, passed to ``prf_blocks`` explicitly. The
    PRF is pointwise in the block index, so the tags equal the matching
    slice of the whole fragments' tags."""
    dev = fragments.device
    key = key.to(dev)
    f, nbytes = fragments.shape
    lanes = key.alpha.shape[0] * pf.BYTES_PER_ELEM
    blocks = Podr2Params(key.alpha.shape[0]).blocks_for(nbytes)
    ids = fragment_id_pairs(fragment_ids, dev)
    if ids.shape[0] != f:
        raise ValueError(f"{ids.shape[0]} ids for {f} fragments")
    at = None if first_block is None else torch.arange(
        first_block, first_block + blocks, dtype=torch.int64, device=dev)
    prf_lm = prf_blocks(key.prf_key, ids, at, blocks, key.limbs,
                        limb_major=True)
    return podr2_tag(key.weights, prf_lm,
                     fragments.reshape(f, blocks, lanes))


def gen_challenge(seed_bytes: bytes | int, num_blocks: int,
                  count: int | None = None, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Round randomness -> (indices [c] int64, nu [c] int32) on
    ``device``; derived on the host (a few thousand words)."""
    idx, nu = prf.challenge(seed_bytes, num_blocks, count)
    dev = resolve_device(device)
    return idx.to(dev), nu.to(dev)


def aggregate_coeffs(seed_bytes: bytes, fragment_ids,
                     device=None) -> torch.Tensor:
    """Per-fragment aggregation coefficients r [F] int32, computed on
    ``device``; only the round seed's sha256 runs on the host."""
    return prf.aggregate_coeffs(seed_bytes, _id_pairs(
        fragment_ids, resolve_device(device)))


def prove(fragment: torch.Tensor, tags: torch.Tensor, idx, nu,
          sectors: int = SECTORS) -> tuple[torch.Tensor, torch.Tensor]:
    """A miner's proof for one fragment [bytes] with tags [blocks, limbs]
    -> (mu [sectors], sigma [limbs]) int32."""
    mu, sigma = prove_batch(fragment[None], tags[None], idx, nu, sectors)
    return mu[0], sigma[0]


def prove_batch(fragments: torch.Tensor, tags: torch.Tensor,
                idx: torch.Tensor | None, nu: torch.Tensor,
                sectors: int = SECTORS) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., F, bytes], [..., F, blocks, limbs] -> (mu [..., F, sectors],
    sigma [..., F, limbs]) int32. Only the challenged blocks are read.
    ``idx`` None: the inputs already hold just the challenged blocks, in
    challenge order (a caller that gathered them first)."""
    *lead, nbytes = fragments.shape
    lanes = sectors * pf.BYTES_PER_ELEM
    sel = fragments.reshape(*lead, nbytes // lanes, lanes)
    if idx is not None:
        idx = idx.to(torch.int64)
        sel, tags = sel[..., idx, :], tags[..., idx, :]          # [..., c, *]
    m = pf.pack_bytes(sel)                                       # [..., c, s]
    nu = nu.to(torch.int64)[:, None]
    mu = pf.dotmod(m, nu, dim=-2)
    sigma = pf.dotmod(tags, nu, dim=-2)
    return mu.to(torch.int32), sigma.to(torch.int32)


def prove_aggregate(fragments, tags, idx, nu, r,
                    sectors: int = SECTORS) -> tuple[torch.Tensor, torch.Tensor]:
    """One constant-size proof (mu [sectors], sigma [limbs]) over all
    fragments, folded with coefficients r [F]. Leading axes are
    independent proofs (missions): r [..., F] -> mu [..., sectors],
    sigma [..., limbs]."""
    mu_f, sigma_f = prove_batch(fragments, tags, idx, nu, sectors)
    r = r.to(torch.int64)[..., None]
    return (pf.dotmod(r, mu_f, dim=-2).to(torch.int32),
            pf.dotmod(r, sigma_f, dim=-2).to(torch.int32))


def verify_aggregate(key: Podr2Key, fragment_ids, num_blocks: int, idx, nu,
                     r, mu, sigma) -> torch.Tensor:
    """The TEE's check of an aggregated proof against the owed fragment
    set: a bool scalar, true only when every limb equation holds.
    Leading axes are independent checks (missions): ids [..., F, 2], r
    [..., F], mu [..., sectors], sigma [..., limbs] -> bool [...], the
    PRF of every mission's ids from one launch."""
    dev = mu.device
    key = key.to(dev)
    r = r.to(dev, torch.int64)
    ids = _id_pairs(fragment_ids, dev)                           # [N*F, 2]
    idx = idx.to(dev, torch.int64)
    f = prf_blocks(key.prf_key, ids, idx, idx.shape[0], key.limbs)
    lhs_f = pf.dotmod(nu.to(dev)[None, :, None], f, dim=1)       # [N*F, limbs]
    lhs_f = lhs_f.reshape(*r.shape, -1)                          # [..., F, limbs]
    lhs = pf.addmod(pf.dotmod(r[..., None], lhs_f, dim=-2),
                    pf.dotmod(key.alpha, mu[..., :, None], dim=-2))
    return torch.all(lhs == sigma.to(torch.int64), dim=-1)


def verify_from_f(alpha, f, idx, nu, mu, sigma) -> torch.Tensor:
    """The verification equation given PRF values f [blocks, limbs]."""
    lhs = pf.dotmod(nu[:, None], f[idx.to(torch.int64)], dim=0)
    rhs = pf.dotmod(alpha, mu[:, None], dim=0)
    return torch.all(pf.addmod(lhs, rhs) == sigma.to(torch.int64))


def verify(key: Podr2Key, fragment_id, num_blocks: int, idx, nu, mu,
           sigma) -> torch.Tensor:
    """The TEE's check of one fragment's proof: a bool scalar, true only
    when every limb equation holds; the PRF is evaluated at the
    challenged blocks only, on mu's device."""
    dev = mu.device
    key = key.to(dev)
    f_i = prf_elems_at(key.prf_key, fragment_id, idx, key.limbs)
    lhs = pf.dotmod(nu.to(dev)[:, None], f_i, dim=0)
    rhs = pf.dotmod(key.alpha, mu[:, None], dim=0)
    return torch.all(pf.addmod(lhs, rhs) == sigma.to(dev, torch.int64))


def verify_batch(key: Podr2Key, fragment_ids, num_blocks: int, idx, nu, mu,
                 sigma) -> torch.Tensor:
    """Per-fragment proofs mu [F, sectors], sigma [F, limbs] -> bool [F]."""
    dev = mu.device
    key = key.to(dev)
    ids = fragment_id_pairs(fragment_ids, dev)
    idx = idx.to(dev, torch.int64)
    f = prf_blocks(key.prf_key, ids, idx, idx.shape[0], key.limbs)
    lhs = pf.dotmod(nu.to(dev)[None, :, None], f, dim=1)           # [F, limbs]
    rhs = pf.dotmod(key.alpha[None], mu[:, :, None], dim=1)        # [F, limbs]
    return torch.all(pf.addmod(lhs, rhs) == sigma.to(torch.int64), dim=-1)
