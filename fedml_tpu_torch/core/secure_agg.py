"""Pairwise-masked secure aggregation over GF(2^31 - 1), port of
fedml_tpu/core/secure_agg.py (the SecAgg mold, Bonawitz et al., CCS'17):

- every client quantizes its weighted update into GF(p)
  (``collectives.finite_field.field_encode``) and adds (1) cancelling
  pairwise masks — for each cohort pair (i, j) a mask vector expanded by a
  counter-mode PRG from a seed only i and j share (a Diffie-Hellman
  exchange in GF(p): ``s_ij = pk_j^sk_i = pk_i^sk_j``), added by the lower
  slot and subtracted by the higher so the masks vanish from the cohort
  SUM — and (2) a self-mask ``PRG(b_i)`` whose seed is Shamir-shared
  across the cohort, which the server strips only with shares from >= t+1
  cohort members;
- the server's per-upload cost is one streaming add mod p on its device
  (``fold_masked_device``; ``fold_masked`` is its numpy oracle);
- when clients die mid-round, survivors reveal their pairwise seeds for
  exactly the dead slots and the server strips the orphaned masks and the
  survivors' self-masks (``unmask_partial``); below ``threshold_t + 1``
  survivors the round must shed.

Every secret derives from the session seed via sha256 (``derive_secret``),
so a chaos run replays bit for bit, and every party — either package —
expands the same mask bits: a masked upload of the port is the JAX
package's upload for the same update.

The PRG (counter-mode splitmix64: ``mask[k] = mix(seed + (k+1) * gamma)
mod p``) is uint64 arithmetic, which torch does not offer; it runs in
int64, which wraps the same way mod 2^64 on the CPU and the card, with
each logical right shift written ``(z >> r) & (2^(64-r) - 1)`` and the
unsigned ``z mod p`` as ``(hi * (2^32 mod p) + lo) mod p`` over z's 32-bit
halves (exact for p < 2^31). ``prg_expand_np`` is the numpy uint64 oracle
the tests hold it to. Masking, folding and unmasking run where the
caller's tensors live; a host (numpy) accumulator is unmasked on
``device``, the CUDA device unless the caller names another
(fedml_tpu_torch.device). The secret and share arithmetic of a cohort's
scalars stays on the host. ``torch.uint64`` appears nowhere: every
intermediate lies in int64 (a fold's ``acc + sign * mask`` in (-p, 2p)
before ``torch.remainder``, floor-mod like jnp's ``%``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from fedml_tpu_torch.collectives import finite_field as ff
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.utils import prng

P_DEFAULT = ff.P_DEFAULT

# primitive root of GF(2^31 - 1) (the Lehmer/MINSTD generator base): its
# powers cover the whole multiplicative group, so pk = g^sk loses no key
# bits and the DH pair seeds s_ij range over the full field
GENERATOR = 7


# ------------------------------------------------------------------ secrets
def derive_secret(seed: int, round_idx: int, tag: str, slot: int,
                  p: int = P_DEFAULT) -> int:
    """One per-(round, slot) secret in [1, p-1), sha256 counter-mode from
    the session seed — the replayable stand-in for client entropy."""
    key = f"secagg|{seed}|{round_idx}|{tag}|{slot}".encode()
    h = hashlib.sha256(key).digest()
    return int.from_bytes(h[:8], "little") % (p - 2) + 1


def secret_key(seed: int, round_idx: int, slot: int,
               p: int = P_DEFAULT) -> int:
    """The slot's DH secret exponent for this round."""
    return derive_secret(seed, round_idx, "sk", slot, p)


def self_mask_seed(seed: int, round_idx: int, slot: int,
                   p: int = P_DEFAULT) -> int:
    """The slot's self-mask PRG seed b_i (Shamir-shared via
    :func:`self_mask_shares`)."""
    return derive_secret(seed, round_idx, "self", slot, p)


def public_key(sk: int, p: int = P_DEFAULT) -> int:
    """pk = g^sk mod p (advertised in a deployment; derived here)."""
    return pow(GENERATOR, sk, p)


def public_keys(seed: int, round_idx: int, cohort: int,
                p: int = P_DEFAULT) -> list[int]:
    """Every slot's public key for the round (the simulated advertise
    phase — each party computes the same list from the session seed)."""
    return [public_key(secret_key(seed, round_idx, s, p), p)
            for s in range(cohort)]


def pair_seed(sk_own: int, pk_peer: int, p: int = P_DEFAULT) -> int:
    """The shared pairwise mask seed: pk_peer^sk_own = g^(sk_i * sk_j),
    symmetric in (i, j) — only the two endpoints can compute it."""
    return pow(pk_peer, sk_own, p)


# ---------------------------------------------------------------------- PRG
_GAMMA = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_M32 = 0xFFFFFFFF


def _i64(u: int) -> int:
    """The int64 with ``u``'s low 64 bits (two's complement)."""
    u &= 0xFFFFFFFFFFFFFFFF
    return u - (1 << 64) if u >= (1 << 63) else u


def _srl(z: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 words holding uint64 values."""
    return (z >> r) & ((1 << (64 - r)) - 1)


def _prg(seed: int, n: int, p: int, device) -> torch.Tensor:
    if not 2 <= p < 2**31:
        raise ValueError(f"p={p}: the int64 PRG reduction needs p < 2^31")
    k = torch.arange(1, n + 1, dtype=torch.int64, device=device)
    z = k * _i64(_GAMMA) + _i64(seed)
    z = (z ^ _srl(z, 30)) * _i64(_MIX1)
    z = (z ^ _srl(z, 27)) * _i64(_MIX2)
    z = z ^ _srl(z, 31)
    return torch.remainder(_srl(z, 32) * ((1 << 32) % p) + (z & _M32), p)


def prg_expand(seed: int, n: int, p: int = P_DEFAULT,
               device=None) -> torch.Tensor:
    """Expand one seed (any uint64) into n field elements: int64 on
    ``device`` (the CUDA device when None), bitwise :func:`prg_expand_np`."""
    return _prg(int(seed), int(n), p, resolve_device(device))


def prg_expand_np(seed: int, n: int, p: int = P_DEFAULT) -> np.ndarray:
    """Numpy uint64 twin of :func:`prg_expand` — the replay oracle (the
    JAX package's, verbatim)."""
    k = np.arange(1, n + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = np.uint64(seed) + k * np.uint64(_GAMMA)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_MIX2)
        z = z ^ (z >> np.uint64(31))
    return (z % np.uint64(p)).astype(np.int64)


def apply_masks(vec: torch.Tensor, seeds, signs,
                p: int = P_DEFAULT) -> torch.Tensor:
    """``vec + sum_m signs[m] * PRG(seeds[m]) mod p`` on ``vec``'s device
    (an int64 field vector): the one routine masking (the client) and
    unmasking (the server's recovery pass) run."""
    acc = torch.remainder(vec.to(torch.int64), p)
    n = acc.shape[0]
    for sd, sg in zip(seeds, signs):
        acc = torch.remainder(acc + int(sg) * _prg(int(sd), n, p, acc.device),
                              p)
    return acc


# ------------------------------------------------------------------- config
def default_threshold_t(cohort: int) -> int:
    """The adaptive Shamir-threshold default both runtimes share: t = 2
    where the cohort can carry it, degrading to t = 1 for 2-slot cohorts
    (t must stay <= cohort - 1 or nothing could ever reconstruct)."""
    return max(1, min(2, int(cohort) - 1))


@dataclass(frozen=True)
class SecAggConfig:
    """One cohort's masking parameters.

    ``cohort``       K slots (== client_num_per_round);
    ``threshold_t``  Shamir degree t — stripping any self-mask (and hence
                     decoding any round, full or partial) needs shares
                     from >= t+1 cohort slots, so t+1 is also the
                     dropout-recovery threshold: fewer survivors => the
                     round sheds;
    ``quant_scale``  fixed-point scale for field_encode;
    ``max_abs``      loud capacity bound — every masked coordinate is
                     promised <= max_abs before quantization, and
                     construction verifies cohort * 2 * quant_scale *
                     max_abs < p (finite_field.assert_field_capacity) so
                     the summed field values cannot silently wrap.
    """

    cohort: int
    threshold_t: int = 2
    quant_scale: float = 2**16
    max_abs: float = 4.0
    p: int = P_DEFAULT

    def __post_init__(self):
        if not 1 <= self.threshold_t <= self.cohort - 1:
            # t=0 would put the secret verbatim in every share; t+1 >
            # cohort could never reconstruct even from a full round
            raise ValueError(
                f"threshold_t={self.threshold_t} needs t in [1, cohort-1="
                f"{self.cohort - 1}]: recovery reconstructs from t+1 "
                "survivor shares")
        ff.assert_field_capacity(self.cohort, self.quant_scale,
                                 self.max_abs, self.p)

    @property
    def recovery_min(self) -> int:
        """Minimum survivors for a decodable round."""
        return self.threshold_t + 1


# ------------------------------------------------------------- client side
def pair_masks_for(seed: int, round_idx: int, slot: int, cfg: SecAggConfig,
                   peers=None) -> tuple[np.ndarray, np.ndarray]:
    """(seeds, signs) of slot's pairwise masks against every other cohort
    slot: + for the lower slot of each pair, - for the higher, so the
    cohort sum cancels exactly. ``peers`` restricts the partners to the
    listed GLOBAL slot ids (an edge block: masks cancel within the block);
    keys and seeds stay cohort-global."""
    sk = secret_key(seed, round_idx, slot, cfg.p)
    pks = public_keys(seed, round_idx, cfg.cohort, cfg.p)
    partners = range(cfg.cohort) if peers is None \
        else sorted(int(j) for j in peers)
    seeds, signs = [], []
    for j in partners:
        if j == slot:
            continue
        seeds.append(pair_seed(sk, pks[j], cfg.p))
        signs.append(1 if slot < j else -1)
    return (np.asarray(seeds, np.uint64), np.asarray(signs, np.int64))


def mask_update_tensor(vec, weight: float, slot: int, seed: int,
                       round_idx: int, cfg: SecAggConfig, peers=None,
                       device=None) -> torch.Tensor:
    """:func:`mask_update` kept on the device: the masked int64 field
    vector where ``vec`` lives (a non-tensor ``vec`` goes to ``device``,
    the CUDA device when None)."""
    if not isinstance(vec, torch.Tensor):
        vec = torch.as_tensor(np.asarray(vec), device=resolve_device(device))
    scaled = vec.to(torch.float64) * float(weight)
    # the capacity promise, enforced in the one function every engine
    # masks through (one host read of the peak): a coordinate past
    # max_abs would wrap the cohort sum mod p with no error downstream
    peak = float(scaled.abs().max()) if scaled.numel() else 0.0
    if peak > cfg.max_abs:
        raise ValueError(
            f"masked update coordinate {peak:.4g} exceeds the capacity "
            f"promise max_abs={cfg.max_abs:g} — the cohort sum would "
            "wrap GF(p) silently (raise the max_abs promise / lower "
            "quant_scale, or clip the update)")
    q = ff.field_encode(scaled, cfg.quant_scale, cfg.p)
    seeds, signs = pair_masks_for(seed, round_idx, slot, cfg, peers=peers)
    seeds = [self_mask_seed(seed, round_idx, slot, cfg.p)] + seeds.tolist()
    signs = [1] + signs.tolist()
    return apply_masks(q, seeds, signs, cfg.p)


def mask_update(vec, weight: float, slot: int, seed: int, round_idx: int,
                cfg: SecAggConfig, peers=None, device=None) -> np.ndarray:
    """Quantize ``vec * weight`` into GF(p) and add this slot's self and
    pairwise masks, on ``vec``'s device; returns the int64 wire payload —
    the only thing a client ever uploads about its update. Raises when a
    coordinate exceeds ``cfg.max_abs`` (never clips)."""
    return mask_update_tensor(vec, weight, slot, seed, round_idx, cfg,
                              peers=peers, device=device).cpu().numpy()


def self_mask_shares(seed: int, round_idx: int, slot: int,
                     cfg: SecAggConfig) -> np.ndarray:
    """Shamir shares of this slot's self-mask seed, one per cohort slot
    (share k is addressed to slot k). The key is
    ``PRNGKey(derive_secret(..., "shamir", ...))``, so the shares are the
    JAX package's."""
    b = self_mask_seed(seed, round_idx, slot, cfg.p)
    key = prng.key(derive_secret(seed, round_idx, "shamir", slot, cfg.p))
    shares = ff.shamir_encode(np.asarray([b], np.int64), key, cfg.cohort,
                              cfg.threshold_t, cfg.p)
    return np.asarray(shares[:, 0], np.int64)


# ------------------------------------------------------------- server side
def fold_masked(acc, masked, p: int = P_DEFAULT) -> np.ndarray:
    """One streaming add mod p on the host: the oracle of
    :func:`fold_masked_device`."""
    masked = np.asarray(masked, np.int64)
    if acc is None:
        return masked % p
    return (acc + masked) % p


def fold_masked_device(acc, masked, p: int = P_DEFAULT,
                       device=None) -> torch.Tensor:
    """The server's and the edge's whole per-upload cost: the accumulator
    stays an int64 tensor on ``device`` (the accumulator's, or the CUDA
    device when None) and each arrival (a wire array, or a tensor masked
    on the device) is one add mod p there.
    Integer addition mod p is exact and associative, so the result is
    bitwise the host fold."""
    dev = acc.device if acc is not None else resolve_device(device)
    m = (masked.to(dev, torch.int64) if isinstance(masked, torch.Tensor)
         else torch.from_numpy(np.array(masked, np.int64)).to(dev))
    if acc is None:
        return torch.remainder(m, p)
    return torch.remainder(acc + m, p)


def recover_self_seed(holder_slots, shares, t: int,
                      p: int = P_DEFAULT) -> int:
    """Reconstruct one self-mask seed from the shares the listed holder
    slots revealed (>= t+1 required; Lagrange at 0 over alphas slot+1)."""
    holder_slots = [int(s) for s in holder_slots]
    if len(holder_slots) < t + 1:
        raise ValueError(
            f"self-mask recovery needs >= {t + 1} shares, got "
            f"{len(holder_slots)}")
    alphas = np.asarray([s + 1 for s in holder_slots], np.int64)
    sh = np.asarray(shares, np.int64).reshape(len(holder_slots), 1)
    return int(ff.shamir_decode(sh, alphas, t, p)[0])


def unmask_partial(acc, survivors, dead, self_seeds: dict[int, int],
                   pair_seeds_by_survivor: dict[int, dict[int, int]],
                   cfg: SecAggConfig, device=None):
    """Strip the masks a partial (or full) sum still carries, staying in
    GF(p): every SURVIVOR's self-mask (seeds reconstructed from the
    revealed Shamir shares) and, for every (survivor i, dead j) pair, the
    orphaned pairwise mask with i's sign. A full round passes ``dead=[]``
    and ``{}``. Returns the int64 FIELD vector — still additive, so edge
    partials unmasked here fold mod p at the root before one decode. A
    tensor ``acc`` is unmasked on its device, a wire array on ``device``
    (the CUDA device when None); a tensor comes back."""
    survivors = sorted(int(s) for s in survivors)
    dead = sorted(int(d) for d in dead)
    seeds, signs = [], []
    for i in survivors:
        seeds.append(self_seeds[i])
        signs.append(-1)
    for i in survivors:
        for j in dead:
            seeds.append(pair_seeds_by_survivor[i][j])
            signs.append(-1 if i < j else 1)  # undo i's + / - side
    if not isinstance(acc, torch.Tensor):
        acc = torch.from_numpy(np.array(acc, np.int64)).to(
            resolve_device(device))
    return apply_masks(acc, seeds, signs, cfg.p)


def field_decode_sum(acc: torch.Tensor, cfg: SecAggConfig) -> torch.Tensor:
    """Decode an unmasked GF(p) sum to float64 on its device (the one
    decode a round performs, flat or tree)."""
    return ff.field_decode(acc, cfg.quant_scale, cfg.p)


def unmask_sum(acc, survivors, dead, self_seeds: dict[int, int],
               pair_seeds_by_survivor: dict[int, dict[int, int]],
               cfg: SecAggConfig, device=None):
    """:func:`unmask_partial` + :func:`field_decode_sum`: the flat-cohort
    path — strip every mask, decode once, return the float64 weighted SUM
    over the survivors."""
    return field_decode_sum(
        unmask_partial(acc, survivors, dead, self_seeds,
                       pair_seeds_by_survivor, cfg, device=device), cfg)
