"""Round-delta + quantized update codecs — uplink bytes as a perf budget.

The reference framework ships the full dense f32 model on every upload;
at fleet fan-in the uplink — not FLOPs — is the binding constraint on
rounds/second (FedJAX arXiv:2108.02117 treats client payload size as the
population-scaling lever; the smart-NIC FL-server study arXiv:2307.06561
shows server ingest bandwidth bounding the round). This module owns the
wire form of the *update* tiers (docs/PERFORMANCE.md §Wire efficiency):

- ``delta``       — ``local - global@version`` as raw f32. Lossless; wins
                    only through frame-level deflate (near-converged
                    deltas are small and low-entropy) but establishes the
                    versioned-base protocol the lossy tiers ride.
- ``delta-int8``  — symmetric per-tensor int8 (scale = max|d|/127) with a
                    DGC-style deadzone: entries below
                    ``deadzone * rms(d)`` are withheld to the
                    error-feedback residual (comm/ef.py) and shipped as
                    zeros, which is what makes the int8 stream deflate —
                    the tier deflates its own payload, so the ~4x from
                    quantization compounds with the zero-run entropy win
                    (>= 8x uplink vs dense f32, bench-asserted).
- ``delta-sign1`` — 1-bit scaled sign (scale = mean|d|, signs packed 8/
                    byte): ~32x before headers. The server decodes every
                    client's signs to ±scale f32 and hands them to the
                    SAME weighted ``gated_aggregate`` path as dense
                    uploads, which IS scaled-sign aggregation — no new
                    server math, and the PR-4 sanitation gate still fronts
                    it.

Versioned bases: a delta is meaningless without the exact base it was
computed against. Every encoded update travels with the round/version tag
of the broadcast the dispatch carried, and the server densifies against
its per-version broadcast stash — which is what lets sparsified/quantized
uplinks compose with buffered-async dispatch waves (the PR-8 refusal is
lifted; only a genuinely unversioned base stays a loud error).

Poison policy (PR-4): quantization cannot represent a NaN, but it must
not LAUNDER one either — a non-finite input leaf encodes with a NaN
scale, so the server-side decode is non-finite everywhere and dies at the
sanitation gate exactly like a dense NaN upload would. Corrupt scales and
chaos bit-flips that survive CRC land in the same place: garbage decodes
to garbage values, and the gate — not the codec — quarantines them.

Leaf convention (shared with comm/sparse.py and comm/ef.py): floating
leaves participate; integer leaves ship dense (payload = the leaf
verbatim, scale slot 0) and ``apply_delta`` REPLACES the base with them.
"""

from __future__ import annotations

import zlib

import numpy as np

UPDATE_CODECS = ("delta", "delta-int8", "delta-sign1")

# Deadzone (delta-int8 only), in units of the compensated delta's RMS:
# entries below it are withheld to the EF residual and shipped as zero.
# 1.5 RMS keeps ~10-15% of a Gaussian-shaped delta per round (EF ships the
# rest later, same convergence contract as top-k) and turns the int8
# stream into mostly zero runs — the deflate win the >= 8x budget needs.
DEADZONE_DEFAULT = 1.5


class CorruptPayload(ValueError):
    """A structurally-undecodable update payload (truncated deflate
    stream, size mismatch vs the model template). ValueError so the
    server's decode guard can catch it alongside numpy's own."""


def _is_float(arr) -> bool:
    return np.issubdtype(np.asarray(arr).dtype, np.floating)


def round_delta(local_leaves, base_leaves) -> list:
    """``local - base`` per float leaf (f32); non-float leaves pass
    through VERBATIM (they ship dense — ``apply_delta`` replaces)."""
    out = []
    for w, g in zip(local_leaves, base_leaves):
        w = np.asarray(w)
        if not _is_float(w):
            out.append(w)
            continue
        out.append(np.asarray(w, np.float32) - np.asarray(g, np.float32))
    return out


def apply_delta(base_leaves, delta_leaves) -> list:
    """Server side: ``base + delta`` per float leaf (the client's
    effective model, ready for the unchanged weighted aggregator);
    non-float delta entries REPLACE the base (dense convention)."""
    out = []
    for g, d in zip(base_leaves, delta_leaves):
        g = np.asarray(g)
        d = np.asarray(d)
        if not _is_float(g):
            out.append(d.reshape(g.shape))
            continue
        out.append((np.asarray(g, np.float32)
                    + np.asarray(d, np.float32)).astype(g.dtype))
    return out


# ------------------------------------------------------------- leaf codecs
def _q8_leaf(d: np.ndarray, deadzone: float) -> tuple[np.ndarray, float]:
    """One float leaf -> (deflated int8 bytes as uint8, f32 scale)."""
    d = np.asarray(d, np.float32).ravel()
    if d.size and not np.isfinite(d).all():
        # poison, not launder: a NaN scale makes the DECODE non-finite
        # everywhere, so the sanitation gate sees it (module docstring)
        q = np.zeros(d.size, np.int8)
        scale = float("nan")
    else:
        if deadzone > 0.0 and d.size:
            rms = float(np.sqrt(np.mean(d * d)))
            amax0 = float(np.max(np.abs(d)))
            if rms > 0.0:
                # cap the threshold at the leaf's own max magnitude: for a
                # single-element or uniform-|d| leaf, |d| == rms <
                # deadzone*rms would otherwise hold FOREVER (EF rescales
                # the compensated delta and the ratio with it), silently
                # freezing that parameter while the residual grows without
                # bound — the top entries must always be transmittable
                tau = min(deadzone * rms, amax0)
                d = np.where(np.abs(d) >= tau, d, 0.0).astype(np.float32)
        amax = float(np.max(np.abs(d))) if d.size else 0.0
        scale = amax / 127.0
        q = (np.zeros(d.size, np.int8) if scale == 0.0 else
             np.clip(np.rint(d / scale), -127, 127).astype(np.int8))
    payload = np.frombuffer(zlib.compress(q.tobytes(), 6), np.uint8)
    return payload, scale


def _q8_leaf_decode(payload, scale, template: np.ndarray) -> np.ndarray:
    try:
        raw = zlib.decompress(np.asarray(payload, np.uint8).tobytes())
    except zlib.error as e:
        raise CorruptPayload(f"int8 payload failed to inflate: {e}")
    q = np.frombuffer(raw, np.int8)
    if q.size != template.size:
        raise CorruptPayload(
            f"int8 payload has {q.size} entries, model leaf has "
            f"{template.size}")
    return (q.astype(np.float32) * np.float32(scale)) \
        .reshape(template.shape)


def _sign_leaf(d: np.ndarray) -> tuple[np.ndarray, float]:
    """One float leaf -> (packed sign bits, f32 scale = mean|d|)."""
    d = np.asarray(d, np.float32).ravel()
    if d.size and not np.isfinite(d).all():
        return np.packbits(np.zeros(d.size, bool)), float("nan")
    scale = float(np.mean(np.abs(d))) if d.size else 0.0
    return np.packbits(d >= 0.0), scale


def _sign_leaf_decode(payload, scale, template: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(np.asarray(payload, np.uint8))
    if bits.size < template.size:
        raise CorruptPayload(
            f"sign payload has {bits.size} bits, model leaf has "
            f"{template.size}")
    s = np.float32(scale)
    return np.where(bits[: template.size].astype(bool), s, -s) \
        .astype(np.float32).reshape(template.shape)


# ----------------------------------------------------------- tier encoders
def encode_update(delta_leaves, codec: str,
                  deadzone: float = DEADZONE_DEFAULT
                  ) -> tuple[list, np.ndarray]:
    """Encode (already EF-compensated) delta leaves under ``codec``.

    Returns ``(payload, scales)``: one payload array per leaf (deflated
    int8 bytes / packed sign bits / raw f32 delta / dense non-float leaf)
    and a per-leaf f32 scale vector (0 for lossless and dense leaves; NaN
    marks a non-finite input — see the poison policy in the module doc).
    Both ride the frame LOSSLESS (comm/message.py exempts the update keys
    from the lossy f16/q8 frame tiers — a quantized scale would corrupt
    every entry it scales)."""
    if codec not in UPDATE_CODECS:
        raise ValueError(
            f"unknown update codec {codec!r} (one of {UPDATE_CODECS})")
    payload: list = []
    scales = np.zeros(len(delta_leaves), np.float32)
    for i, d in enumerate(delta_leaves):
        d = np.asarray(d)
        if not _is_float(d):
            payload.append(d)  # dense passthrough, scale slot stays 0
            continue
        if codec == "delta":
            payload.append(np.asarray(d, np.float32))
        elif codec == "delta-int8":
            p, s = _q8_leaf(d, deadzone)
            payload.append(p)
            scales[i] = s
        else:  # delta-sign1
            p, s = _sign_leaf(d)
            payload.append(p)
            scales[i] = s
    return payload, scales


def decode_update(payload, scales, codec: str, template_leaves) -> list:
    """Server side: payload + scales -> delta leaves (f32 for float
    leaves; dense non-float leaves verbatim), shaped by the receiver's
    own model template — no shapes cross the wire. Raises
    :class:`CorruptPayload` on structural garbage (the server maps it to
    an ``undecodable`` quarantine, never a crashed receive loop); VALUE
    garbage (corrupt scale, bit-flipped payload) decodes to values the
    sanitation gate judges."""
    if codec not in UPDATE_CODECS:
        raise ValueError(
            f"unknown update codec {codec!r} (one of {UPDATE_CODECS})")
    if len(payload) != len(template_leaves) or \
            len(np.atleast_1d(scales)) != len(template_leaves):
        raise CorruptPayload(
            f"update payload has {len(payload)} leaves / "
            f"{len(np.atleast_1d(scales))} scales, model has "
            f"{len(template_leaves)}")
    scales = np.atleast_1d(np.asarray(scales, np.float32))
    out = []
    for p, s, t in zip(payload, scales, template_leaves):
        t = np.asarray(t)
        if not _is_float(t):
            out.append(np.asarray(p).reshape(t.shape))
            continue
        if codec == "delta":
            p = np.asarray(p, np.float32)
            if p.size != t.size:
                raise CorruptPayload(
                    f"delta leaf has {p.size} entries, model leaf has "
                    f"{t.size}")
            out.append(p.reshape(t.shape))
        elif codec == "delta-int8":
            out.append(_q8_leaf_decode(p, s, t))
        else:
            out.append(_sign_leaf_decode(p, s, t))
    return out


def inflate_update(payload, scales, codec: str,
                   template_leaves) -> tuple[list, np.ndarray]:
    """Structural half of :func:`decode_update` for the fused on-device
    server path (docs/PERFORMANCE.md §Fused aggregation): validate the
    payload's structure and return the RAW quantized per-leaf arrays —
    inflated flat int8 for ``delta-int8`` (zlib cannot run in a jit, and
    int8 is 4x smaller than the f32 tree the stacked path materializes),
    packed sign BYTES for ``delta-sign1``, flat f32 deltas for ``delta``,
    dense non-float leaves verbatim — ready for the on-device densify in
    ``core/fused_agg.py``. VALUE garbage still flows through (a NaN scale
    decodes non-finite on device and dies at the in-graph gate);
    structural garbage raises :class:`CorruptPayload` exactly like
    :func:`decode_update`."""
    if codec not in UPDATE_CODECS:
        raise ValueError(
            f"unknown update codec {codec!r} (one of {UPDATE_CODECS})")
    if len(payload) != len(template_leaves) or \
            len(np.atleast_1d(scales)) != len(template_leaves):
        raise CorruptPayload(
            f"update payload has {len(payload)} leaves / "
            f"{len(np.atleast_1d(scales))} scales, model has "
            f"{len(template_leaves)}")
    scales = np.atleast_1d(np.asarray(scales, np.float32))
    out = []
    for p, t in zip(payload, template_leaves):
        t = np.asarray(t)
        if not _is_float(t):
            p = np.asarray(p)
            if p.size != t.size:
                # the fused densify reshapes on device — a wrong-sized
                # dense leaf must die HERE as structural garbage, not as
                # a trace error inside the server's receive loop
                raise CorruptPayload(
                    f"dense leaf has {p.size} entries, model leaf has "
                    f"{t.size}")
            out.append(p)
            continue
        if codec == "delta":
            p = np.asarray(p, np.float32)
            if p.size != t.size:
                raise CorruptPayload(
                    f"delta leaf has {p.size} entries, model leaf has "
                    f"{t.size}")
            out.append(p.reshape(-1))
        elif codec == "delta-int8":
            try:
                raw = zlib.decompress(np.asarray(p, np.uint8).tobytes())
            except zlib.error as e:
                raise CorruptPayload(f"int8 payload failed to inflate: {e}")
            q = np.frombuffer(raw, np.int8)
            if q.size != t.size:
                raise CorruptPayload(
                    f"int8 payload has {q.size} entries, model leaf has "
                    f"{t.size}")
            out.append(q)
        else:  # delta-sign1
            p = np.asarray(p, np.uint8)
            if p.size * 8 < t.size:
                raise CorruptPayload(
                    f"sign payload has {p.size * 8} bits, model leaf has "
                    f"{t.size}")
            out.append(p)
    return out, scales


def payload_nbytes(payload, scales) -> int:
    """Wire-payload bytes of one encoded update (tests/bench evidence)."""
    return int(sum(np.asarray(p).nbytes for p in payload)
               + np.asarray(scales).nbytes)
