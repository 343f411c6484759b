"""Error feedback — the shared residual state every lossy uplink tier owns.

A lossy update codec (top-k sparsification, int8/1-bit quantization of
round deltas) throws information away on every upload. What preserves
convergence is *error feedback* (EF): the untransmitted mass

    residual_{t+1} = compensated_t - shipped_t,
    compensated_t  = delta_t + residual_t

stays client-side and rides in later rounds, so every coordinate's error
is bounded by one round's compression error instead of accumulating — the
Deep-Gradient-Compression / EF-SGD recipe. PR-8's top-k path carried its
own residual bookkeeping inside the client manager; this module is that
logic extracted into ONE object all lossy tiers share (topk, delta-int8,
delta-sign1 — comm/delta.py), so the conservation invariant

    shipped + residual == compensated        (float leaves, exactly)

is defined — and tested — in a single place.

Residuals are per-RANK, not per-client (the parameter-server convention,
inherited from the top-k path): under cross-device client reassignment a
rank's residual mixes the clients it hosted. That is acceptable in
practice (the residual is a correction term, not model state) and costs
zero extra protocol state; fixed-assignment cross-silo is the setting the
lossy tiers target. Documented in docs/PERFORMANCE.md §Wire efficiency.

Leaf convention (same as comm/sparse.py and comm/delta.py): only floating
leaves participate — integer leaves (step counters, embedding vocab ids)
ship dense and carry no residual.
"""

from __future__ import annotations

import numpy as np


def _is_float(arr) -> bool:
    return np.issubdtype(np.asarray(arr).dtype, np.floating)


class ErrorFeedback:
    """Per-rank residual accumulator for lossy update codecs.

    Usage (one instance per uploading rank, living across rounds):

        comp = ef.compensate(raw_delta)          # delta + residual
        payload = encode(comp)                   # any lossy tier
        ef.update(comp, decode(payload))         # residual = comp - shipped

    ``update_residual`` is the top-k shortcut: ``topk_residual`` already
    computes ``comp - shipped`` (the delta with transmitted entries
    zeroed), so the client hands it over instead of re-deriving it.
    """

    def __init__(self):
        self._residual: list[np.ndarray] | None = None

    def compensate(self, delta_leaves) -> list:
        """delta + residual per float leaf (non-float leaves pass through
        untouched — they ship dense and carry no residual)."""
        if self._residual is None:
            return [np.asarray(d) for d in delta_leaves]
        out = []
        for d, r in zip(delta_leaves, self._residual):
            d = np.asarray(d)
            out.append(d + r if _is_float(d) else d)
        return out

    def update(self, compensated_leaves, shipped_leaves) -> None:
        """Fold one round's compression error back in: residual =
        compensated - shipped (zeros for non-float leaves). ``shipped``
        must be the DECODED form of what went on the wire — the value the
        server will actually apply — so the residual tracks the server's
        view, not the client's intent.

        Poison containment: a non-finite round (diverged local fit, an
        adversary window) encodes with a NaN scale so the SERVER
        quarantines it — but folding that NaN into the residual would
        poison every later upload from this rank permanently. A
        non-finite residual update is therefore SKIPPED: the poison still
        ships (and dies at the gate), and the next honest round resumes
        from the pre-poison residual."""
        res = []
        for c, s in zip(compensated_leaves, shipped_leaves):
            c = np.asarray(c)
            if _is_float(c):
                res.append(np.asarray(c, np.float32) - np.asarray(s, np.float32))
            else:
                res.append(np.zeros_like(c))
        self._install(res)

    def update_residual(self, residual_leaves) -> None:
        """Install a residual computed elsewhere (the top-k path's
        ``topk_residual`` output is already ``compensated - shipped``).
        Same poison containment as :meth:`update`."""
        self._install([np.asarray(r) for r in residual_leaves])

    def _install(self, res: list) -> None:
        if any(_is_float(r) and not np.isfinite(r).all() for r in res):
            return  # keep the pre-poison residual (see update docstring)
        self._residual = res

    def reset(self) -> None:
        self._residual = None

    @property
    def residual(self) -> list | None:
        return self._residual
