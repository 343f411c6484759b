"""Differential-privacy accounting for DP-FedAvg (Rényi DP).

The reference ships "weak DP" — uncalibrated Gaussian noise with no
privacy accounting (fedml_core/robustness/robust_aggregation.py:51-55,
``--stddev`` chosen by hand). This module adds the real recipe
(DP-FedAvg, McMahan et al. 2018): per-client update clipping to an L2
ball C, server noise calibrated as ``z * C / m`` on the m-client average,
and an RDP accountant that converts the per-round subsampled-Gaussian
mechanism into a cumulative (ε, δ) statement.

Accounting math (standard results, implemented from the formulas):
  * Gaussian mechanism RDP at order α: ``α / (2 z²)``.
  * Poisson-subsampled Gaussian at sampling rate q, integer α ≥ 2
    (Mironov-Talwar-Zhang '19 / the Opacus-style binomial bound):
        RDP(α) = 1/(α-1) · log Σ_{k=0..α} C(α,k) (1-q)^(α-k) q^k
                                     · exp(k(k-1) / (2 z²))
    computed in log-space so large α / tiny q don't underflow.
  * Composition: RDP adds across rounds; conversion
    ε = min_α [ RDP(α) + log(1/δ)/(α-1) ].
Client sampling here is uniform-without-replacement per round; the
Poisson-subsampling bound is the standard (slightly optimistic for
q ≪ 1, widely used) surrogate — stated rather than hidden.
"""

from __future__ import annotations

import math

import numpy as np

# integer orders + a few fractional-free extras; the classic default grid
DEFAULT_ALPHAS = tuple(range(2, 64)) + (128, 256, 512)


def gaussian_rdp(noise_multiplier: float, alpha: int) -> float:
    """RDP of the (unsubsampled) Gaussian mechanism at order alpha."""
    return alpha / (2.0 * noise_multiplier ** 2)


def subsampled_gaussian_rdp(q: float, noise_multiplier: float,
                            alpha: int) -> float:
    """RDP at integer order alpha of the Poisson-subsampled Gaussian
    (log-space binomial sum; exact for integer alpha)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate q={q} outside [0, 1]")
    if noise_multiplier <= 0.0:
        # z=0 means NO privacy (eps would be infinite); fail fast instead
        # of dividing by zero after a training round was already spent
        raise ValueError(f"noise_multiplier must be > 0, got {noise_multiplier}")
    if alpha < 2 or int(alpha) != alpha:
        raise ValueError(f"integer alpha >= 2 required, got {alpha}")
    if q == 0.0:
        return 0.0
    if q == 1.0:
        return gaussian_rdp(noise_multiplier, alpha)
    z2 = noise_multiplier ** 2
    k = np.arange(alpha + 1, dtype=np.float64)
    # log C(alpha, k) from cumulative log-factorials; terms summed in log
    # space with logaddexp so large alpha / tiny q never underflow
    log_fact = np.concatenate(
        [[0.0], np.cumsum(np.log(np.arange(1, alpha + 1)))])
    log_binom = log_fact[alpha] - log_fact - log_fact[::-1]
    log_terms = (log_binom + k * math.log(q) + (alpha - k) * math.log1p(-q)
                 + k * (k - 1) / (2.0 * z2))
    return max(0.0, float(np.logaddexp.reduce(log_terms)) / (alpha - 1))


def rdp_to_epsilon(rdp_by_alpha, alphas, delta: float) -> float:
    """Best (ε, δ) over the order grid."""
    if not 0.0 < delta < 1.0:
        raise ValueError(f"delta={delta} outside (0, 1)")
    log_inv_delta = math.log(1.0 / delta)
    return float(min(r + log_inv_delta / (a - 1)
                     for r, a in zip(rdp_by_alpha, alphas)))


class DPAccountant:
    """Cumulative RDP over FedAvg rounds.

    One ``step(q, z)`` per round (q = clients sampled / clients total,
    z = noise multiplier); ``epsilon(delta)`` any time for the cumulative
    guarantee."""

    def __init__(self, alphas=DEFAULT_ALPHAS):
        self.alphas = tuple(alphas)
        self._rdp = np.zeros(len(self.alphas))

    def step(self, q: float, noise_multiplier: float, rounds: int = 1):
        self._rdp = self._rdp + rounds * np.array(
            [subsampled_gaussian_rdp(q, noise_multiplier, a)
             for a in self.alphas])
        return self

    def epsilon(self, delta: float) -> float:
        return rdp_to_epsilon(self._rdp, self.alphas, delta)

    def best_order(self, delta: float) -> tuple[int, float]:
        """(alpha*, cumulative RDP at alpha*) — the order the ε conversion
        settled on, the 'cumulative RDP' half of the privacy ledger."""
        log_inv_delta = math.log(1.0 / delta)
        i = int(np.argmin([r + log_inv_delta / (a - 1)
                           for r, a in zip(self._rdp, self.alphas)]))
        return self.alphas[i], float(self._rdp[i])


# the privacy ledger's default reporting delta; every surface that renders
# ε (round records, /healthz, the bench artifact) states it alongside
DEFAULT_DELTA = 1e-5


class ClientPrivacyLedger:
    """Per-client RDP ledgers — ε budgets at client granularity.

    The cohort-level :class:`DPAccountant` answers "how much privacy has
    this RUN spent"; multi-tenant deployments need "how much has THIS
    user spent", which only grows on the rounds the client actually
    participated in. Each participation is charged at the UNsubsampled
    Gaussian bound ``α / (2 z²)`` — conditioning on "client i was
    sampled" forfeits the amplification-by-subsampling discount, so the
    per-client figure is the conservative (never-under-reporting) side
    of the cohort bound.

    Durability contract: the charge sites journal the participating
    client ids on the WAL ``precharge`` record BEFORE the noise key is
    drawn (core/wal.py module docstring), so a server SIGKILL between
    charge and noise replays the per-client charges too — ε may
    over-count by one round per crash, never under-count. Keys are
    client ids (namespace-ready for multi-tenancy: a tenant prefix on
    the id is all a shared fleet needs)."""

    def __init__(self, alphas=DEFAULT_ALPHAS):
        self.alphas = tuple(alphas)
        self._rdp: dict[int, np.ndarray] = {}

    def charge(self, client_ids, noise_multiplier: float,
               rounds: int = 1) -> None:
        """Charge one participation (``rounds`` of them) to each listed
        client at the unamplified Gaussian bound."""
        if noise_multiplier <= 0.0:
            raise ValueError(
                f"noise_multiplier must be > 0, got {noise_multiplier}")
        step = rounds * np.array(
            [gaussian_rdp(noise_multiplier, a) for a in self.alphas])
        for cid in client_ids:
            cid = int(cid)
            prev = self._rdp.get(cid)
            self._rdp[cid] = step if prev is None else prev + step

    def epsilon(self, client_id: int, delta: float = DEFAULT_DELTA) -> float:
        rdp = self._rdp.get(int(client_id))
        if rdp is None:
            return 0.0
        return rdp_to_epsilon(rdp, self.alphas, delta)

    def eps_max(self, delta: float = DEFAULT_DELTA) -> float:
        """The worst per-client ε — the budget figure /healthz and the
        ``fed_privacy_client_epsilon`` gauge family surface."""
        if not self._rdp:
            return 0.0
        return max(self.epsilon(cid, delta) for cid in self._rdp)

    def summary(self, delta: float = DEFAULT_DELTA) -> dict:
        """{eps_client_max, eps_client_mean, clients_charged} — the
        rollup the round record's privacy block carries."""
        if not self._rdp:
            return {"eps_client_max": 0.0, "eps_client_mean": 0.0,
                    "clients_charged": 0}
        eps = [self.epsilon(cid, delta) for cid in self._rdp]
        return {"eps_client_max": round(max(eps), 6),
                "eps_client_mean": round(float(np.mean(eps)), 6),
                "clients_charged": len(eps)}


def privacy_block(accountant: DPAccountant, q: float, noise_multiplier: float,
                  clip: float, delta: float = DEFAULT_DELTA,
                  realized_m: int | None = None) -> dict:
    """The ``privacy`` block a DP round record carries (docs/ROBUSTNESS.md
    §Privacy ledger): cumulative ε@δ plus the round's mechanism parameters
    — sampling rate q, noise multiplier z, clip bound C, the REALIZED
    survivor count m the noise was calibrated over (elastic/secure rounds
    shrink it), and the RDP order the conversion settled on. ε is computed
    from the accountant's cumulative RDP totals, which ride checkpoints —
    resume neither under-reports ε nor replays noise keys."""
    alpha, rdp = accountant.best_order(delta)
    block = {
        "eps": round(accountant.epsilon(delta), 6),
        "delta": delta,
        "q": round(float(q), 8),
        "z": float(noise_multiplier),
        "clip": float(clip),
        "rdp_alpha": int(alpha),
        "rdp": round(rdp, 6),
    }
    if realized_m is not None:
        block["m"] = int(realized_m)
    return block


def charge_and_record(accountant: DPAccountant, q: float,
                      noise_multiplier: float, clip: float,
                      realized_m: int | None = None,
                      rounds: int = 1,
                      client_ledger: ClientPrivacyLedger | None = None,
                      client_ids=None) -> dict:
    """The one step-then-surface sequence every DP aggregator runs:
    charge the accountant, build the round record's ``privacy`` block,
    refresh the live ``fed_privacy_epsilon`` gauge (the privacy_budget
    health rule's input). Three engines ride this — the masked secure
    tier, the cross-process dp defense, the standalone engine — and the
    ledger fields must not drift between them.

    With a ``client_ledger`` + the round's participating ``client_ids``,
    the per-client ledgers are charged too and the block gains the
    ``eps_client_max`` / ``eps_client_mean`` / ``clients_charged``
    rollup, mirrored onto the ``fed_privacy_client_epsilon`` gauges."""
    from fedml_tpu_torch.obs import perf_instrument as _perf

    accountant.step(q, noise_multiplier, rounds=rounds)
    block = privacy_block(accountant, q, noise_multiplier, clip,
                          realized_m=realized_m)
    _perf.set_privacy_epsilon(block["eps"])
    if client_ledger is not None and client_ids is not None:
        client_ledger.charge(client_ids, noise_multiplier, rounds=rounds)
        block.update(client_ledger.summary())
        _perf.set_client_epsilon(block["eps_client_max"],
                                 block["eps_client_mean"],
                                 block["clients_charged"])
    return block
