"""Finite-field arithmetic for secure aggregation, port of
fedml_tpu/collectives/finite_field.py.

The field is GF(p) with p = 2**31 - 1 (a Mersenne prime: a product of two
reduced elements fits int64). Two kinds of work live here:

- the Shamir layer (``mod_pow``, ``mod_inv``, ``lagrange_coeffs``,
  ``shamir_encode``, ``shamir_decode``) works on at most a cohort's
  scalars, so it runs on the host in Python ints and numpy int64, bit for
  bit the reference's int64 math (every intermediate is reduced mod p);
- the quantizer (``field_encode`` / ``field_decode``) runs over a whole
  model vector, so it is torch int64 / float64 on whatever device the
  caller's tensor lives on.

``shamir_encode`` draws its coefficients with ``utils.prng.randint``,
``jax.random.randint``'s int64 draw bit for bit, so shares are the JAX
package's for the same key.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.utils import prng

P_DEFAULT = 2**31 - 1


def mod_pow(base, exp: int, p: int = P_DEFAULT) -> np.ndarray:
    """base**exp mod p, elementwise (``exp`` a Python int); int64."""
    base = np.asarray(base, np.int64)
    flat = [pow(int(b) % p, int(exp), p) for b in base.reshape(-1)]
    return np.asarray(flat, np.int64).reshape(base.shape)


def mod_inv(a, p: int = P_DEFAULT) -> np.ndarray:
    """Modular inverse by Fermat's little theorem: a^(p-2) mod p."""
    return mod_pow(a, p - 2, p)


def lagrange_coeffs(alpha_s, beta_s, p: int = P_DEFAULT) -> np.ndarray:
    """L[i, j] = prod_{k != j} (alpha_i - beta_k) / (beta_j - beta_k) mod p
    (gen_Lagrange_coeffs, mpc_function.py:38-59). alpha_s: [A] evaluation
    points, beta_s: [B] interpolation points; returns int64 [A, B]."""
    alphas = [int(a) % p for a in np.asarray(alpha_s, np.int64).reshape(-1)]
    betas = [int(b) % p for b in np.asarray(beta_s, np.int64).reshape(-1)]
    den = []
    for j, bj in enumerate(betas):
        d = 1
        for k, bk in enumerate(betas):
            if k != j:
                d = d * ((bj - bk) % p) % p
        den.append(pow(d, p - 2, p))
    out = np.zeros((len(alphas), len(betas)), np.int64)
    for i, ai in enumerate(alphas):
        for j in range(len(betas)):
            n = 1
            for k, bk in enumerate(betas):
                if k != j:
                    n = n * ((ai - bk) % p) % p
            out[i, j] = n * den[j] % p
    return out


def shamir_encode(x, key, n_shares: int, t: int,
                  p: int = P_DEFAULT) -> np.ndarray:
    """Shamir/BGW share encoding (BGW_encoding, mpc_function.py:62-76):
    ``s_i = x + sum_m r_m * alpha_i^m`` at alpha_i = i + 1, with random
    coefficients r_1..r_t from ``randint(key, (t,) + x.shape, 0, p - 1)``.
    ``key`` is a key's uint32 words (utils.prng). Returns int64
    [n_shares, ...]."""
    x = np.asarray(x, np.int64) % p
    coeffs = prng.randint(key, (t,) + x.shape, 0, p - 1)
    shares = []
    for alpha in range(1, n_shares + 1):
        acc, apow = x.copy(), 1
        for m in range(t):
            apow = apow * alpha % p
            acc = (acc + coeffs[m] * np.int64(apow)) % p
        shares.append(acc)
    return np.stack(shares)


def shamir_decode(shares, alphas, t: int, p: int = P_DEFAULT) -> np.ndarray:
    """Reconstruct the secret from >= t+1 shares by Lagrange interpolation
    at 0 (the first t+1 rows are used)."""
    shares = np.asarray(shares, np.int64) % p
    k = t + 1
    L = lagrange_coeffs([0], np.asarray(alphas, np.int64)[:k], p)[0]
    acc = np.zeros(shares.shape[1:], np.int64)
    for j in range(k):
        acc = (acc + L[j] * shares[j]) % p
    return acc


def assert_field_capacity(n_terms: int, quant_scale: float,
                          max_abs: float = 1.0, p: int = P_DEFAULT) -> float:
    """Loud guard against silent mod-p wraparound in aggregation sums.

    Summing ``n_terms`` field-encoded values whose pre-quantization
    magnitudes are bounded by ``max_abs`` produces signed magnitudes up to
    ``n_terms * quant_scale * max_abs``; the signed decode range is
    (-p/2, p/2), so the sum stays decodable iff

        n_terms * 2 * quant_scale * max_abs < p.

    Large cohorts or a generous ``quant_scale`` can cross this silently —
    the decoded aggregate would wrap to garbage with no error anywhere —
    so aggregators must call this at CONSTRUCTION, not discover it at
    round N. Returns the fraction of the field the worst-case sum uses
    (the headroom diagnostic); raises ValueError at or past capacity.
    """
    if n_terms < 1:
        raise ValueError(f"n_terms={n_terms} must be >= 1")
    if quant_scale <= 0 or max_abs <= 0:
        raise ValueError(
            f"quant_scale={quant_scale} and max_abs={max_abs} must be > 0")
    need = 2.0 * float(n_terms) * float(quant_scale) * float(max_abs)
    if need >= p:
        raise ValueError(
            f"field capacity exceeded: {n_terms} terms * 2 * quant_scale="
            f"{quant_scale:g} * max_abs={max_abs:g} = {need:.4g} >= p={p} "
            "— the aggregated sum would wrap mod p and decode to garbage; "
            "lower quant_scale (costs precision), shrink the cohort, or "
            "tighten the clip bound feeding max_abs")
    return need / p


def field_encode(x, scale: float = 2**16, p: int = P_DEFAULT) -> torch.Tensor:
    """Quantize into GF(p): round(x * scale) mod p, in float64 with ties to
    even (``jnp.round``'s rule), negatives wrapping; int64 on ``x``'s
    device."""
    x = torch.as_tensor(x).to(torch.float64)
    return torch.remainder(torch.round(x * scale).to(torch.int64), p)


def field_decode(z, scale: float = 2**16, p: int = P_DEFAULT) -> torch.Tensor:
    """Inverse of field_encode: values above p/2 decode as negative;
    float64 on ``z``'s device."""
    z = torch.as_tensor(z).to(torch.int64)
    signed = torch.where(z > p // 2, z - p, z)
    return signed.to(torch.float64) / scale
