"""BLS12-381 min-sig signatures: the publicly verifiable seal on TEE
verdicts.

Role parity: the reference vendors an Internet-Computer-compatible BLS
verifier (utils/verify-bls-signatures/src/lib.rs:1-247)
and exposes it as ``enclave_verify::verify_bls``
(primitives/enclave-verify/src/lib.rs:230-235) so that
PoDR2 verdicts signed by a TEE master key can be re-verified by
*anyone* holding the 96-byte public key — not just the secret-holding
enclave. This module supplies that capability natively:

- min-sig variety (matching the reference's crate): signatures are
  G1 points (48-byte compressed), public keys are G2 points (96-byte
  compressed), ZCash serialization flags.
- verify:  e(sig, -G2gen) * e(H(msg), pk) == 1, one shared final
  exponentiation (the crate's multi_miller_loop shape, lib.rs:214-247).
- aggregation over distinct messages + proof-of-possession, so one
  pairing product covers a whole batch of TEE verdicts.

Redesign notes (capability-equivalent, not byte-compatible):
- hash-to-G1 uses expand_message_xmd(SHA-256) per RFC 9380 §5.3.1 but
  a try-and-increment curve map with explicit domain separation
  instead of the SSWU+11-isogeny ciphersuite — deterministic and
  uniform for signature security, chosen to avoid a page of opaque
  isogeny constants. Signing here happens in the in-repo TEE agent,
  so constant-time mapping is not load-bearing.
- Tower arithmetic is plain-Python bignum (Fp2 -> Fp6 -> Fp12); the
  pairing is the optimal ate loop over |u|, u = -0xd201_0000_0001_0000,
  with the final conjugation for u < 0. Cofactors and the cyclotomic
  exponent are DERIVED from u at import and asserted, never quoted.

This layer signs/verifies ~one verdict batch per block (6 s); the
per-fragment proof throughput path stays on the card's F_p^2 MAC
(ops/podr2.py) — pairings seal the verdict, not the data plane.
"""
from __future__ import annotations

import hashlib
import hmac

# --- base field / curve parameters (standard BLS12-381) --------------
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
U = -0xD201000000010000            # curve parameter (negative)

_G1X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
_G1Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
_G2X = (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
_G2Y = (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)

# Derived group orders/cofactors: #E(Fp) = p + 1 - t with t = u + 1
# for BLS12 curves, so #E(Fp) = p - u; the correct sextic twist order
# over Fp2 is whichever of p^2 + 1 -+ (t^2 - 2p) the subgroup order
# divides.  Both divisibility facts are asserted, so a misquoted
# constant above dies at import, not at verify time.
_N1 = P - U
assert _N1 % R == 0
H1 = _N1 // R                      # G1 cofactor
_T = U + 1
_T2 = _T * _T - 2 * P
if (P * P + 1 - _T2) % R == 0:
    _N2 = P * P + 1 - _T2
else:
    _N2 = P * P + 1 + _T2
assert _N2 % R == 0
H2 = _N2 // R                      # G2 cofactor
assert (P ** 4 - P ** 2 + 1) % R == 0   # r | Phi_12(p): final exp is sound

DST_G1 = b"CESS_TPU_BLS_SIG_BLS12381G1_TAI:SHA-256_RO_NUL_"
DST_POP = b"CESS_TPU_BLS_POP_BLS12381G1_TAI:SHA-256_RO_POP_"

SK_BYTES = 32
PK_BYTES = 96
SIG_BYTES = 48


# --- Fp ---------------------------------------------------------------
def _finv(a: int) -> int:
    return pow(a, P - 2, P)


def _fsqrt(a: int) -> int | None:
    """p == 3 (mod 4): candidate root a^((p+1)/4); None if non-residue."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a else None


# --- Fp2 = Fp[u]/(u^2 + 1) -------------------------------------------
def _f2add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2neg(a):
    return (-a[0] % P, -a[1] % P)


def _f2mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def _f2sqr(a):
    t = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]) % P, (t + t) % P)


def _f2inv(a):
    d = _finv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, -a[1] * d % P)


def _f2conj(a):
    return (a[0], -a[1] % P)


_F2ZERO = (0, 0)
_F2ONE = (1, 0)
_XI = (1, 1)                       # Fp6 nonresidue xi = 1 + u


def _f2muls(a, s: int):
    return (a[0] * s % P, a[1] * s % P)


def _f2pow(a, e: int):
    out = _F2ONE
    while e:
        if e & 1:
            out = _f2mul(out, a)
        a = _f2sqr(a)
        e >>= 1
    return out


def _f2sqrt(a):
    """sqrt in Fp2 via the complex method; None if non-residue."""
    if a == _F2ZERO:
        return _F2ZERO
    # norm = a0^2 + a1^2 must be a QR in Fp
    n = (a[0] * a[0] + a[1] * a[1]) % P
    d = _fsqrt(n)
    if d is None:
        return None
    inv2 = _finv(2)
    x0 = (a[0] + d) * inv2 % P
    r0 = _fsqrt(x0)
    if r0 is None:
        x0 = (a[0] - d) * inv2 % P
        r0 = _fsqrt(x0)
        if r0 is None:
            return None
    if r0 == 0:
        r1 = _fsqrt(a[1] * _finv(2) % P)  # pure-imaginary edge case
        if r1 is None:
            return None
        return (0, r1) if _f2sqr((0, r1)) == a else None
    r1 = a[1] * _finv(2 * r0 % P) % P
    cand = (r0, r1)
    return cand if _f2sqr(cand) == a else None


# --- Fp6 = Fp2[v]/(v^3 - xi) -----------------------------------------
def _f6add(a, b):
    return (_f2add(a[0], b[0]), _f2add(a[1], b[1]), _f2add(a[2], b[2]))


def _f6sub(a, b):
    return (_f2sub(a[0], b[0]), _f2sub(a[1], b[1]), _f2sub(a[2], b[2]))


def _f6neg(a):
    return (_f2neg(a[0]), _f2neg(a[1]), _f2neg(a[2]))


def _f6mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = _f2mul(a0, b0)
    t1 = _f2mul(a1, b1)
    t2 = _f2mul(a2, b2)
    c0 = _f2add(t0, _f2mul(_XI, _f2sub(_f2mul(_f2add(a1, a2), _f2add(b1, b2)), _f2add(t1, t2))))
    c1 = _f2add(_f2sub(_f2mul(_f2add(a0, a1), _f2add(b0, b1)), _f2add(t0, t1)), _f2mul(_XI, t2))
    c2 = _f2add(_f2sub(_f2mul(_f2add(a0, a2), _f2add(b0, b2)), _f2add(t0, t2)), t1)
    return (c0, c1, c2)


def _f6sqr(a):
    return _f6mul(a, a)


def _f6mulv(a):
    """multiply by v: (c0, c1, c2) -> (xi*c2, c0, c1)."""
    return (_f2mul(_XI, a[2]), a[0], a[1])


def _f6inv(a):
    a0, a1, a2 = a
    t0 = _f2sub(_f2sqr(a0), _f2mul(_XI, _f2mul(a1, a2)))
    t1 = _f2sub(_f2mul(_XI, _f2sqr(a2)), _f2mul(a0, a1))
    t2 = _f2sub(_f2sqr(a1), _f2mul(a0, a2))
    den = _f2add(_f2mul(a0, t0), _f2mul(_XI, _f2add(_f2mul(a2, t1), _f2mul(a1, t2))))
    di = _f2inv(den)
    return (_f2mul(t0, di), _f2mul(t1, di), _f2mul(t2, di))


_F6ZERO = (_F2ZERO, _F2ZERO, _F2ZERO)
_F6ONE = (_F2ONE, _F2ZERO, _F2ZERO)


# --- Fp12 = Fp6[w]/(w^2 - v) -----------------------------------------
def _f12add(a, b):
    return (_f6add(a[0], b[0]), _f6add(a[1], b[1]))


def _f12sub(a, b):
    return (_f6sub(a[0], b[0]), _f6sub(a[1], b[1]))


def _f12mul(a, b):
    t0 = _f6mul(a[0], b[0])
    t1 = _f6mul(a[1], b[1])
    c1 = _f6sub(_f6mul(_f6add(a[0], a[1]), _f6add(b[0], b[1])), _f6add(t0, t1))
    return (_f6add(t0, _f6mulv(t1)), c1)


def _f12sqr(a):
    return _f12mul(a, a)


def _f12inv(a):
    den = _f6sub(_f6sqr(a[0]), _f6mulv(_f6sqr(a[1])))
    di = _f6inv(den)
    return (_f6mul(a[0], di), _f6neg(_f6mul(a[1], di)))


def _f12conj(a):
    """Frobenius^6: w -> -w (Galois conjugation over Fp6)."""
    return (a[0], _f6neg(a[1]))


_F12ONE = (_F6ONE, _F6ZERO)


def _f12pow(a, e: int):
    out = _F12ONE
    while e:
        if e & 1:
            out = _f12mul(out, a)
        a = _f12sqr(a)
        e >>= 1
    return out


# Frobenius gammas: v^p = v * xi^((p-1)/3), v^2p = v^2 * xi^(2(p-1)/3),
# w^p = w * xi^((p-1)/6).  All exist because p == 1 (mod 6).
assert (P - 1) % 6 == 0
_GAMMA_V = _f2pow(_XI, (P - 1) // 3)
_GAMMA_V2 = _f2pow(_XI, 2 * (P - 1) // 3)
_GAMMA_W = _f2pow(_XI, (P - 1) // 6)


def _f6frob(a):
    return (_f2conj(a[0]), _f2mul(_f2conj(a[1]), _GAMMA_V),
            _f2mul(_f2conj(a[2]), _GAMMA_V2))


def _f12frob(a):
    c0 = _f6frob(a[0])
    c1 = _f6frob(a[1])
    return (c0, (_f2mul(c1[0], _GAMMA_W), _f2mul(c1[1], _GAMMA_W),
                 _f2mul(c1[2], _GAMMA_W)))


def _final_exp(f):
    """f^((p^12-1)/r): easy part by conj/frobenius, hard part by a
    generic square-and-multiply over the ~1.3kbit cyclotomic exponent
    (clarity over the x-addition-chain; this runs once per verify)."""
    g = _f12mul(_f12conj(f), _f12inv(f))          # f^(p^6 - 1)
    g = _f12mul(_f12frob(_f12frob(g)), g)          # ^(p^2 + 1)
    return _f12pow(g, (P ** 4 - P ** 2 + 1) // R)  # ^(Phi12(p)/r)


# --- curve points -----------------------------------------------------
# G1 points are (x, y) ints or None (infinity); G2 points are
# (x, y) Fp2 pairs or None.  Affine + per-op inversion is fine at
# verdict rate; scalar muls use Jacobian to skip inversions.
_B1 = 4
_B2 = _f2muls(_XI, 4)              # twist: y^2 = x^3 + 4(1+u)


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - (x * x * x + _B1)) % P == 0


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return _f2sub(_f2sqr(y), _f2add(_f2mul(x, _f2sqr(x)), _B2)) == _F2ZERO


def _g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _finv(2 * y1 % P) % P
    else:
        lam = (y2 - y1) * _finv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def _g1_mul(pt, k: int):
    """Jacobian double-and-add over Fp."""
    k %= _N1
    if pt is None or k == 0:
        return None
    X, Y, Z = pt[0], pt[1], 1
    out = None                     # (X, Y, Z) or None
    for bit in bin(k)[2:]:
        if out is not None:
            out = _jac_dbl(out)
        if bit == "1":
            out = _jac_add(out, (X, Y, Z))
    return _jac_to_affine(out)


def _jac_dbl(pt):
    X, Y, Z = pt
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def _jac_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if S1 != S2:
            return None
        return _jac_dbl(p1)
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = 2 * H * Z1 * Z2 % P
    return (X3, Y3, Z3)


def _jac_to_affine(pt):
    if pt is None or pt[2] == 0:
        return None
    X, Y, Z = pt
    zi = _finv(Z)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def _g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if _f2add(y1, y2) == _F2ZERO:
            return None
        lam = _f2mul(_f2muls(_f2sqr(x1), 3), _f2inv(_f2muls(y1, 2)))
    else:
        lam = _f2mul(_f2sub(y2, y1), _f2inv(_f2sub(x2, x1)))
    x3 = _f2sub(_f2sub(_f2sqr(lam), x1), x2)
    return (x3, _f2sub(_f2mul(lam, _f2sub(x1, x3)), y1))


def _g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], _f2neg(pt[1]))


def _g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1] % P)


def _g2_mul(pt, k: int):
    k %= _N2
    if pt is None or k == 0:
        return None
    out = None
    for bit in bin(k)[2:]:
        if out is not None:
            out = _g2_dblstep(out)
        if bit == "1":
            out = _g2_addj(out, pt)
    return out if out is None else _g2j_to_affine(out)


# G2 Jacobian over Fp2 (same shapes as Fp Jacobian).
def _g2_dblstep(pt):
    X, Y, Z = pt
    A = _f2sqr(X)
    B = _f2sqr(Y)
    C = _f2sqr(B)
    D = _f2muls(_f2sub(_f2sub(_f2sqr(_f2add(X, B)), A), C), 2)
    E = _f2muls(A, 3)
    F = _f2sqr(E)
    X3 = _f2sub(F, _f2muls(D, 2))
    Y3 = _f2sub(_f2mul(E, _f2sub(D, X3)), _f2muls(C, 8))
    Z3 = _f2muls(_f2mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _g2_addj(p1, p2aff):
    if p1 is None:
        return (p2aff[0], p2aff[1], _F2ONE)
    X1, Y1, Z1 = p1
    x2, y2 = p2aff
    Z1Z1 = _f2sqr(Z1)
    U2 = _f2mul(x2, Z1Z1)
    S2 = _f2mul(_f2mul(y2, Z1), Z1Z1)
    if U2 == X1:
        if S2 != Y1:
            return None
        return _g2_dblstep(p1)
    H = _f2sub(U2, X1)
    HH = _f2sqr(H)
    I = _f2muls(HH, 4)
    J = _f2mul(H, I)
    rr = _f2muls(_f2sub(S2, Y1), 2)
    V = _f2mul(X1, I)
    X3 = _f2sub(_f2sub(_f2sqr(rr), J), _f2muls(V, 2))
    Y3 = _f2sub(_f2mul(rr, _f2sub(V, X3)), _f2muls(_f2mul(Y1, J), 2))
    Z3 = _f2mul(_f2muls(H, 2), Z1)
    return (X3, Y3, Z3)


def _g2j_to_affine(pt):
    if pt is None or pt[2] == _F2ZERO:
        return None
    X, Y, Z = pt
    zi = _f2inv(Z)
    zi2 = _f2sqr(zi)
    return (_f2mul(X, zi2), _f2mul(Y, _f2mul(zi2, zi)))


G1_GEN = (_G1X, _G1Y)
G2_GEN = (_G2X, _G2Y)


def g1_in_subgroup(pt) -> bool:
    return g1_is_on_curve(pt) and _g1_mul(pt, R) is None


def g2_in_subgroup(pt) -> bool:
    return g2_is_on_curve(pt) and _g2_mul(pt, R) is None


# --- pairing ----------------------------------------------------------
def _untwist(q):
    """E'(Fp2) -> E(Fp12) for the M-twist: (x, y) -> (x/w^2, y/w^3)
    with w^6 = xi, i.e. x * v^2/xi embedded in Fp6, y * (v/xi) * w."""
    x, y = q
    xi_inv = _f2inv(_XI)
    xf6 = (_F2ZERO, _F2ZERO, _f2mul(x, xi_inv))      # x * v^2 / xi
    yf6 = (_F2ZERO, _f2mul(y, xi_inv), _F2ZERO)      # y * v / xi
    return ((xf6, _F6ZERO), (_F6ZERO, yf6))


def _f12_from_fp(a: int):
    return (((a % P, 0), _F2ZERO, _F2ZERO), _F6ZERO)


def _miller_loop(p1, q2):
    """Optimal ate f_{|u|, Q'}(P) with the trailing conjugation for
    u < 0; returns an UNexponentiated Fp12 value (combine products,
    then _final_exp once)."""
    if p1 is None or q2 is None:
        return _F12ONE
    xq, yq = _untwist(q2)
    xp = _f12_from_fp(p1[0])
    yp = _f12_from_fp(p1[1])
    xt, yt = xq, yq
    f = _F12ONE
    n = -U
    for bit in bin(n)[3:]:                 # from second-highest bit
        lam = _f12mul(_f12mul(_f12sqr(xt), _f12_from_fp(3)),
                      _f12inv(_f12mul(yt, _f12_from_fp(2))))
        line = _f12sub(_f12sub(yp, yt), _f12mul(lam, _f12sub(xp, xt)))
        f = _f12mul(_f12sqr(f), line)
        x3 = _f12sub(_f12sub(_f12mul(lam, lam), xt), xt)
        yt = _f12sub(_f12mul(lam, _f12sub(xt, x3)), yt)
        xt = x3
        if bit == "1":
            lam = _f12mul(_f12sub(yq, yt), _f12inv(_f12sub(xq, xt)))
            line = _f12sub(_f12sub(yp, yt), _f12mul(lam, _f12sub(xp, xt)))
            f = _f12mul(f, line)
            x3 = _f12sub(_f12sub(_f12mul(lam, lam), xt), xq)
            yt = _f12sub(_f12mul(lam, _f12sub(xt, x3)), yt)
            xt = x3
    return _f12conj(f)                     # u < 0


def pairing(p1, q2):
    """e(P, Q) for P in G1, Q in G2 (affine or None)."""
    return _final_exp(_miller_loop(p1, q2))


def multi_pairing(pairs) -> bool:
    """True iff prod e(Pi, Qi) == 1: one final exponentiation over the
    product of Miller loops (verify-bls-signatures lib.rs:214-247)."""
    f = _F12ONE
    for p1, q2 in pairs:
        f = _f12mul(f, _miller_loop(p1, q2))
    return _final_exp(f) == _F12ONE


# --- hash to G1 -------------------------------------------------------
def _expand_message_xmd(msg: bytes, dst: bytes, length: int) -> bytes:
    """RFC 9380 §5.3.1 with SHA-256."""
    h = hashlib.sha256
    b_in_bytes, r_in_bytes = 32, 64
    ell = -(-length // b_in_bytes)
    if ell > 255 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds")
    dst_prime = dst + bytes([len(dst)])
    z_pad = b"\x00" * r_in_bytes
    l_i_b = length.to_bytes(2, "big")
    b0 = h(z_pad + msg + l_i_b + b"\x00" + dst_prime).digest()
    bi = h(b0 + b"\x01" + dst_prime).digest()
    out = bi
    for i in range(2, ell + 1):
        bi = h(bytes(x ^ y for x, y in zip(b0, bi)) + bytes([i]) + dst_prime).digest()
        out += bi
    return out[:length]


def hash_to_g1(msg: bytes, dst: bytes = DST_G1):
    """Deterministic try-and-increment map (see module docstring),
    cofactor-cleared into the r-order subgroup."""
    for ctr in range(256):
        seed = _expand_message_xmd(msg, dst + b"|ctr=" + bytes([ctr]), 64)
        x = int.from_bytes(seed[:48], "big") % P
        y = _fsqrt((x * x * x + _B1) % P)
        if y is None:
            continue
        if (y & 1) != (seed[63] & 1):
            y = P - y
        pt = _g1_mul((x, y), H1)
        if pt is not None:
            return pt
    raise ValueError("hash_to_g1 failed to find a point")   # pragma: no cover


# --- serialization (ZCash flags) -------------------------------------
_C_FLAG, _I_FLAG, _S_FLAG = 0x80, 0x40, 0x20


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 47
    x, y = pt
    flags = _C_FLAG | (_S_FLAG if y > (P - 1) // 2 else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_decompress(data: bytes, subgroup_check: bool = True):
    if len(data) != 48:
        raise ValueError("G1 point must be 48 bytes")
    flags = data[0]
    if not flags & _C_FLAG:
        raise ValueError("uncompressed G1 encoding unsupported")
    if flags & _I_FLAG:
        if any(data[1:]) or data[0] & 0x3F:
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y = _fsqrt((x * x * x + _B1) % P)
    if y is None:
        raise ValueError("G1 x not on curve")
    if (y > (P - 1) // 2) != bool(flags & _S_FLAG):
        y = P - y
    pt = (x, y)
    if subgroup_check and not g1_in_subgroup(pt):
        raise ValueError("G1 point not in subgroup")
    return pt


def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([_C_FLAG | _I_FLAG]) + b"\x00" * 95
    (x0, x1), (y0, y1) = pt
    bigy = y1 > (P - 1) // 2 or (y1 == 0 and y0 > (P - 1) // 2)
    flags = _C_FLAG | (_S_FLAG if bigy else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_decompress(data: bytes, subgroup_check: bool = True):
    if len(data) != 96:
        raise ValueError("G2 point must be 96 bytes")
    flags = data[0]
    if not flags & _C_FLAG:
        raise ValueError("uncompressed G2 encoding unsupported")
    if flags & _I_FLAG:
        if any(data[1:]) or data[0] & 0x3F:
            raise ValueError("malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    y = _f2sqrt(_f2add(_f2mul(x, _f2sqr(x)), _B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    bigy = y[1] > (P - 1) // 2 or (y[1] == 0 and y[0] > (P - 1) // 2)
    if bigy != bool(flags & _S_FLAG):
        y = _f2neg(y)
    pt = (x, y)
    if subgroup_check and not g2_in_subgroup(pt):
        raise ValueError("G2 point not in subgroup")
    return pt


# --- native dispatch --------------------------------------------------
# The C++ backend (native/bls381.cpp via bls_native.py) mirrors this
# module construction-for-construction: byte-identical signatures,
# agreeing verifies (differentially tested). Absent toolchain or
# CESS_TPU_NO_NATIVE_BLS=1 falls back to the pure-Python path here.
try:
    from . import bls_native as _native
except ImportError:
    _native = None


# --- signatures (min-sig: sig in G1, pk in G2) -----------------------
def keygen(seed: bytes) -> tuple[int, bytes]:
    """Derive (sk, pk_bytes) from a seed; sk in [1, r)."""
    sk = 0
    salt = b"CESS_TPU_BLS_KEYGEN"
    while sk == 0:
        sk = int.from_bytes(hmac.new(salt, seed, hashlib.sha512).digest(), "big") % R
        salt = hashlib.sha256(salt).digest()
    if _native is not None:
        return sk, _native.pk_from_sk(sk.to_bytes(32, "big"))
    return sk, g2_compress(_g2_mul(G2_GEN, sk))


def sign(sk: int, msg: bytes, dst: bytes = DST_G1) -> bytes:
    if _native is not None:
        return _native.sign(sk.to_bytes(32, "big"), msg, dst)
    return g1_compress(_g1_mul(hash_to_g1(msg, dst), sk))


_NEG_G2_GEN = _g2_neg(G2_GEN)


def verify(pk_bytes: bytes, msg: bytes, sig_bytes: bytes,
           dst: bytes = DST_G1) -> bool:
    """e(sig, -G2) * e(H(msg), pk) == 1."""
    if not isinstance(pk_bytes, bytes) or not isinstance(sig_bytes, bytes):
        return False
    if _native is not None:
        return _native.verify(pk_bytes, msg, sig_bytes, dst)
    try:
        pk = g2_decompress(pk_bytes)
        sig = g1_decompress(sig_bytes)
    except ValueError:
        return False
    if pk is None or sig is None:
        return False
    return multi_pairing([(sig, _NEG_G2_GEN), (hash_to_g1(msg, dst), pk)])


def aggregate(sig_list: list[bytes]) -> bytes:
    """Sum of G1 signatures."""
    if _native is not None:
        return _native.aggregate(list(sig_list))
    acc = None
    for s in sig_list:
        acc = _g1_add(acc, g1_decompress(s))
    return g1_compress(acc)


def aggregate_verify(pk_msg_pairs: list[tuple[bytes, bytes]],
                     agg_sig: bytes, dst: bytes = DST_G1) -> bool:
    """prod e(H(mi), pki) == e(asig, G2); messages MUST be distinct
    (enforced) unless callers prove possession — the standard
    rogue-key discipline."""
    msgs = [m for _, m in pk_msg_pairs]
    if len(set(msgs)) != len(msgs):
        return False
    if _native is not None and isinstance(agg_sig, bytes) \
            and all(isinstance(pk, bytes) for pk, _ in pk_msg_pairs):
        return _native.aggregate_verify(list(pk_msg_pairs), agg_sig, dst)
    try:
        sig = g1_decompress(agg_sig)
        pairs = [(sig, _NEG_G2_GEN)]
        for pk_bytes, msg in pk_msg_pairs:
            pk = g2_decompress(pk_bytes)
            if pk is None:
                return False
            pairs.append((hash_to_g1(msg, dst), pk))
    except ValueError:
        return False
    if sig is None:
        return False
    return multi_pairing(pairs)


def prove_possession(sk: int, pk_bytes: bytes) -> bytes:
    """PoP: sign your own pk under the PoP domain."""
    return sign(sk, pk_bytes, dst=DST_POP)


def verify_possession(pk_bytes: bytes, pop: bytes) -> bool:
    return verify(pk_bytes, pk_bytes, pop, dst=DST_POP)
