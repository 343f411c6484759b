"""JAX's default random-number generator, for the port: key arithmetic and
draws bit for bit ``jax.random``'s under its partitionable Threefry-2x32
(the default since jax 0.5), so the port's keys and noise follow the JAX
package's own streams.

A key is a pair of uint32 words (``jax.random.PRNGKey``'s raw layout):

- ``key(seed)``: ``(hi32(seed), lo32(seed))``;
- ``split(k, n)[i]``: both output words of ``threefry(k, (hi32(i), lo32(i)))``;
- ``fold_in(k, d)``: ``threefry(k, (0, d))``;
- ``random_bits(k, shape)``: element ``j`` (row-major) is ``a ^ b`` of
  ``threefry(k, (hi32(j), lo32(j)))``; ``random_bits64`` is ``a << 32 | b``
  (the 64-bit draw);
- ``randint(k, shape, lo, hi)``: ``jax.random.randint``'s int64 draw (under
  x64): a high and a low 64-bit word from the two halves of ``split(k)``,
  folded into the span with the multiplier ``(2^32 mod span)^2 mod span``;
- ``normal(k, shape)``: the uniform ``u`` in (nextafter(-1, 0), 1) from the
  bits' top 23 as a mantissa, then ``sqrt(2) * erfinv(u)``, the erfinv
  being XLA's own float32 polynomial (Giles 2010, ``ErfInv32``) written
  out in plain torch ops.

The key chain (``key``, ``split``, ``fold_in``) is host numpy: a handful of
words a round. The bulk draws have two forms held bitwise to each other:
numpy (the oracle) and torch on any device (``normal_torch``,
``random_bits_torch``), where the words live in int64 with 32-bit masks,
so the bits of a full model's noise are drawn on the card. The uniforms are
bitwise JAX's; the erfinv is XLA's polynomial, so the normals sit within a
few float32 ulps of JAX's (log1p and the FMA-free sums round apart from
XLA's in the last bit). ``torch.special.erfinv`` is not used: its float32
path once drifted by 6.6e-5 relative inside a test process (ROADMAP.md,
queue C, C3), and its gap to XLA's polynomial is 20 times this one's.

The local fit's key chain (the JAX package's core/local.py and its
engine): client ``i`` of round ``r`` trains on ``fold_in(fold_in(key(seed),
r), i)`` (``client_keys``); its fit splits that key once per epoch and the
epoch's key once per batch (``fit_keys``, host words for the whole round).
A flax module draws ``make_rng('dropout')`` from the batch key folded with
the SHA-1 of its scope path and call count (``flax_rng_data``, flax's
``LazyRng`` with its default ``flax_fix_rng_separator=False``). The device
side takes a key as a tensor (two int64 words, batched under
``torch.func.vmap`` like any tensor): ``fold_in_torch``, ``bits_torch`` and
``bernoulli_torch``, the last ``jax.random.bernoulli``'s ``uniform < p``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
# jax.random.normal's uniform lower bound, np.nextafter(-1, 0) in float32
_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def _threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds, Salmon et al.) of the counter words
    ``(x0, x1)`` under ``key``, on uint32 arrays: the block function
    behind ``jax.random``'s default generator."""
    u32 = lambda v: np.asarray(v, dtype=np.uint32)  # noqa: E731
    ks = (u32(key[0]), u32(key[1]),
          u32(key[0]) ^ u32(key[1]) ^ u32(_PARITY))
    x0, x1 = u32(x0) + ks[0], u32(x1) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << u32(r)) | (x1 >> u32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + u32(i + 1)
    return x0, x1


def _counters(n: int):
    """The (hi32, lo32) words of the uint64 iota 0..n-1."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(_MASK)).astype(np.uint32))


# ---------------------------------------------------------------- key chain
def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s words (uint32[2])."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _MASK], dtype=np.uint32)


def split(k, n: int = 2) -> np.ndarray:
    """``jax.random.split(k, n)``: uint32[n, 2]."""
    hi, lo = _counters(int(n))
    a, b = _threefry2x32(tuple(np.asarray(k, np.uint32)), hi, lo)
    return np.stack([a, b], axis=1)


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: uint32[2]."""
    a, b = _threefry2x32(tuple(np.asarray(k, np.uint32)),
                         np.zeros(1, np.uint32),
                         np.array([int(data) & _MASK], np.uint32))
    return np.array([a[0], b[0]], dtype=np.uint32)


# ------------------------------------------------------------ numpy draws
def random_bits(k, shape) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)``."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    a, b = _threefry2x32(tuple(np.asarray(k, np.uint32)), hi, lo)
    return (a ^ b).reshape(shape)


def random_bits64(k, shape) -> np.ndarray:
    """``jax.random.bits(k, shape, uint64)`` (partitionable Threefry: the
    block's first word is the high half)."""
    shape = tuple(shape)
    hi, lo = _counters(int(np.prod(shape, dtype=np.int64)))
    a, b = _threefry2x32(tuple(np.asarray(k, np.uint32)), hi, lo)
    return ((a.astype(np.uint64) << np.uint64(32))
            | b.astype(np.uint64)).reshape(shape)


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval, int64)`` under x64
    (jax/_src/random.py ``_randint``): uint64 arithmetic that wraps as
    XLA's does. int64 [shape]."""
    k1, k2 = split(k)
    higher, lower = random_bits64(k1, shape), random_bits64(k2, shape)
    span = np.uint64(1 if maxval <= minval else
                     (int(maxval) - int(minval)) % 2**64)
    with np.errstate(over="ignore"):
        mult = np.uint64(2**32) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
        return np.int64(minval) + off.astype(np.int64)


def _uniform_np(bits: np.ndarray) -> np.ndarray:
    one = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    floats = one - np.float32(1.0)
    return np.maximum(np.float32(_LO),
                      floats * np.float32(2.0) + np.float32(_LO))


# XLA's ErfInv32 (Giles, "Approximating the erfinv function", 2010):
# w = -log1p(-u^2); w < 5: p(w - 2.5), else p(sqrt(w) - 3); erfinv = p * u
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function on ``u``'s device, in plain
    elementwise ops (Horner's rule, no fused multiply-adds), for
    |u| < 1 (the uniform's range)."""
    w = -torch.log1p(-u * u)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    lt_c = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=u.device)
    ge_c = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=u.device)
    p = torch.where(lt, lt_c[0], ge_c[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = torch.where(lt, lt_c[i], ge_c[i]) + p * w
    return p * u


def normal(k, shape) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)`` on the CPU."""
    u = torch.from_numpy(_uniform_np(random_bits(k, shape)))
    return (erfinv32(u) * _SQRT2).numpy()


# ------------------------------------------------------------ torch draws
def _threefry_torch(k0, k1, x0, x1):
    """:func:`_threefry2x32` on int64 tensors holding uint32 words (every
    add masked back to 32 bits); ``k0``/``k1`` broadcast against the
    counters, so one call can hash several keys' blocks at once."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _MASK
    x1 = (x1 + k1) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) & _MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def random_bits_multi(keys, sizes, device) -> torch.Tensor:
    """The ``random_bits`` of several keys, concatenated: key ``i`` (a row
    of ``keys``, uint32[n, 2]) draws ``sizes[i]`` words. One hash over the
    whole length on ``device``; int64 holding the uint32 words."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    sizes = torch.as_tensor(np.asarray(sizes, np.int64), device=device)
    total = int(sizes.sum())
    kt = torch.as_tensor(keys.astype(np.int64), device=device)
    seg = torch.repeat_interleave(torch.arange(len(keys), device=device),
                                  sizes, output_size=total)
    starts = torch.cumsum(sizes, 0) - sizes
    j = torch.arange(total, dtype=torch.int64, device=device) - starts[seg]
    a, b = _threefry_torch(kt[seg, 0], kt[seg, 1], j >> 32, j & _MASK)
    return a ^ b


def random_bits_torch(k, shape, device) -> torch.Tensor:
    """``random_bits`` on ``device``: int64 holding the uint32 words."""
    n = int(np.prod(tuple(shape), dtype=np.int64))
    return random_bits_multi(np.asarray(k)[None], [n], device).reshape(
        tuple(shape))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal``'s transform of uint32 words (in int64) into
    float32 normals, on the words' device."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = one - 1.0
    u = torch.clamp_min(floats * 2.0 + _LO, _LO)
    return erfinv32(u) * _SQRT2


def normal_torch(k, shape, device) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` drawn on ``device``."""
    return normal_from_bits(random_bits_torch(k, shape, device))


# ------------------------------------------------------- the fit's key chain
def _split2_many(keys: np.ndarray):
    """``split(k)`` of every row of ``keys`` (uint32[n, 2]): the two halves,
    each uint32[n, 2]."""
    k0, k1 = keys[:, 0], keys[:, 1]
    z = np.zeros(len(keys), np.uint32)
    a0, b0 = _threefry2x32((k0, k1), z, z)
    a1, b1 = _threefry2x32((k0, k1), z, z + np.uint32(1))
    return np.stack([a0, b0], 1), np.stack([a1, b1], 1)


def client_keys(seed: int, round_idx: int, ids) -> np.ndarray:
    """The cohort's training keys, ``fold_in(fold_in(key(seed), round),
    client)`` per sampled client id: uint32[K, 2]."""
    base = fold_in(key(seed), round_idx)
    return np.stack([fold_in(base, int(i)) for i in np.asarray(ids)]) \
        if len(ids) else np.zeros((0, 2), np.uint32)


def fit_keys(keys, epochs: int, num_batches: int) -> np.ndarray:
    """The per-batch keys of the clients' fits (``keys``: uint32[K, 2]):
    each epoch splits the running key into (carry, epoch key), each batch
    splits the epoch's running key into (carry, batch key), as the JAX
    package's two nested ``lax.scan`` do. uint32[epochs, B, K, 2]."""
    rng = np.asarray(keys, np.uint32).reshape(-1, 2)
    out = np.zeros((epochs, num_batches) + rng.shape, np.uint32)
    for e in range(epochs):
        rng, carry = _split2_many(rng)
        for b in range(num_batches):
            carry, out[e, b] = _split2_many(carry)
    return out


def flax_rng_data(*path) -> int:
    """The word flax folds into a collection's key for ``make_rng`` at
    ``path`` (scope names then the call count): the first four bytes of
    the SHA-1 of the path's parts, big-endian."""
    m = hashlib.sha1()
    for part in path:
        if isinstance(part, str):
            m.update(part.encode("utf-8"))
        else:
            m.update(int(part).to_bytes((int(part).bit_length() + 7) // 8,
                                        byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def fold_in_torch(k: torch.Tensor, data: int) -> torch.Tensor:
    """``fold_in`` of a key tensor (int64[2] holding the uint32 words)."""
    a, b = _threefry_torch(k[0], k[1], 0, int(data) & _MASK)
    return torch.stack([a, b])


def bits_torch(k: torch.Tensor, shape) -> torch.Tensor:
    """``random_bits`` of a key tensor: int64 holding the uint32 words, on
    the key's device."""
    n = int(np.prod(tuple(shape), dtype=np.int64))
    j = torch.arange(n, dtype=torch.int64, device=k.device)
    a, b = _threefry_torch(k[0], k[1], j >> 32, j & _MASK)
    return (a ^ b).reshape(tuple(shape))


def bernoulli_torch(k: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli(k, p, shape)``: the float32 uniform from the
    top 23 bits, ``m * 2^-23`` (exactly ``bitcast(m | 1.0) - 1``), below
    ``float32(p)``. A bool tensor."""
    u = (bits_torch(k, shape) >> 9).to(torch.float32) * (2.0 ** -23)
    return u < float(np.float32(p))
