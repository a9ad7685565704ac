"""PoDR2 tags, proofs and checks, in plain NumPy.

A frozen statement of the private-verification MAC the audit protocol
fixes, over F_p (p = 2^31 - 1) in ``limbs`` independent limbs. A
fragment is cut into blocks of ``sectors`` little-endian 16-bit elements
m[b, j].

- tag[b, l] = f(id, b)[l] + sum_j alpha[j, l] m[b, j]
- a miner's proof over fragments F with aggregation coefficients r_F and
  a challenge (I_i, nu_i): mu[j] = sum_F r_F sum_i nu_i m_F[I_i, j],
  sigma[l] = sum_F r_F sum_i nu_i tag_F[I_i, l]
- the check: sigma[l] == sum_F r_F sum_i nu_i f(id_F, I_i)[l]
  + sum_j alpha[j, l] mu[j], in every limb
"""
from __future__ import annotations

import numpy as np

from . import m31, threefry


def tags(alpha: np.ndarray, prf_key: np.ndarray, fragment_id: np.ndarray,
         fragment: np.ndarray, blocks=None) -> np.ndarray:
    """Tags [C, limbs] of one fragment (uint8 [bytes]) at block indices
    ``blocks`` (all blocks when None)."""
    sectors, limbs = alpha.shape
    m = m31.elems(fragment).reshape(-1, sectors)
    if blocks is None:
        blocks = np.arange(m.shape[0])
    else:
        m = m[blocks]
    f = threefry.prf(prf_key, fragment_id[None], blocks, limbs)[0]
    return (f + m31.dot_u16(m, alpha)) % m31.P


def prove(alpha, prf_key, seed: bytes, ids: np.ndarray, fragments,
          sectors: int, pmap=map, chunk: int = 32
          ) -> tuple[np.ndarray, np.ndarray]:
    """The aggregated proof (mu [sectors], sigma [limbs]) int64 of the
    fragments a miner holds (uint8 [bytes] buffers, ids [F, 2]), every
    tag at the challenged blocks worked out anew from the key and the
    bytes. ``pmap``: the map that runs the chunks of ``chunk`` fragments
    (a thread pool's, say)."""
    limbs = alpha.shape[1]
    if not len(fragments):
        return np.zeros(sectors, np.int64), np.zeros(limbs, np.int64)
    blocks = len(fragments[0]) // (2 * sectors)
    idx, nu = threefry.challenge(seed, blocks)
    r = threefry.aggregate_coeffs(seed, ids)

    def part(lo):
        hi = lo + chunk
        m = m31.elems(np.stack([np.frombuffer(f, np.uint8).reshape(
            blocks, -1)[idx] for f in fragments[lo:hi]]))       # [F, c, s]
        f = threefry.prf(prf_key, ids[lo:hi], idx, limbs)       # [F, c, L]
        t = (f + m31.dot_u16(m, alpha)) % m31.P
        mu_f = m31.dot(nu[None, :, None], m, 1)                 # [F, s]
        sigma_f = m31.dot(nu[None, :, None], t, 1)              # [F, L]
        return (m31.dot(r[lo:hi, None], mu_f, 0),
                m31.dot(r[lo:hi, None], sigma_f, 0))

    parts = list(pmap(part, range(0, len(fragments), chunk)))
    return (sum(p[0] for p in parts) % m31.P,
            sum(p[1] for p in parts) % m31.P)


def verify(alpha, prf_key, seed: bytes, ids: np.ndarray, blocks: int,
           mu: np.ndarray, sigma: np.ndarray) -> bool:
    """The TEE's check of (mu, sigma) against the owed ids [F, 2]."""
    mu = np.asarray(mu).astype(np.int64)
    sigma = np.asarray(sigma).astype(np.int64)
    if len(ids) == 0:
        return not mu.any() and not sigma.any()
    if (sigma >= m31.P).any():
        return False
    idx, nu = threefry.challenge(seed, blocks)
    r = threefry.aggregate_coeffs(seed, ids)
    lhs = np.zeros(alpha.shape[1], np.int64)
    for lo in range(0, len(ids), 256):
        f = threefry.prf(prf_key, ids[lo:lo + 256], idx, alpha.shape[1])
        per = m31.dot(nu[None, :, None], f, 1)                  # [F, limbs]
        lhs = (lhs + m31.dot(r[lo:lo + 256, None], per, 0)) % m31.P
    lhs = (lhs + m31.dot(alpha, mu[:, None], 0)) % m31.P
    return bool((lhs == sigma).all())
