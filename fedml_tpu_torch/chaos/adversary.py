"""Model-space adversaries — the chaos layer's Byzantine-client sibling.

PR 2 made *wire-level* faults (drops, corruption, crashes) deterministic
and replayable; this module does the same for *model-level* hostility: a
seeded, declarative :class:`AdversaryPlan` turns chosen worker ranks into
Byzantine clients for chosen round windows, so "f Byzantine of n clients
vs. defense D" is a replayable experiment instead of an anecdote. The
same plan drives both runtimes:

- **standalone / scan** — :func:`make_in_graph_injector` compiles the plan
  into a pure function applied to the stacked client nets INSIDE the
  jitted round program (slot ``i`` plays worker rank ``i+1``, the same
  client the loopback runtime's rank ``i+1`` trains, so quarantine
  ledgers agree across runtimes);
- **cross-process** — :func:`perturb_leaves` runs host-side in the client
  manager right before the upload is packed (the Byzantine client lies on
  the wire; every server defense sees exactly what a real attacker would
  send).

Attacks (``u = w_k - g`` is the client's honest update):

- ``sign_flip``   ``w' = g - factor * u`` — the scaled sign-flip /
                  ascent attack (factor 1 is a pure flip; the classic
                  attack scales, factor >= 5, to overpower the mean);
- ``scale``       ``w' = g + factor * u`` — model replacement /
                  boosting (Bagdasaryan et al.);
- ``gaussian``    ``w' = w + sigma * N(0, I)`` — noise injection;
- ``nan``         ``w' = NaN`` everywhere — the availability attack the
                  sanitation gate must catch before ``tree_weighted_mean``;
- ``shift``       ``w' = w - z * std(u)`` per leaf — a little-is-enough
                  style perturbation: small (z ~ 1) aligned bias that
                  hides inside benign variance instead of overpowering it.

Determinism: WHETHER a rule fires is a pure function of (rule's static
rank set, round window) — no probability draws, so both runtimes agree by
construction. The only randomness (``gaussian``) is seeded per
``(plan.seed, rule index, rank, round)``: sha256-derived on the host path,
``jax.random.fold_in`` chains in-graph — each path replays bit-for-bit
(the two paths draw different bits from the same logical seed; the
*schedule* and hence the quarantine ledger is what must agree).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

import numpy as np

ATTACKS = ("sign_flip", "scale", "gaussian", "nan", "shift")


def _attack_seed(seed: int, rule_idx: int, rank: int, round_idx: int) -> int:
    """Pure sha256 seed for a rule's noise draw on one (rank, round) —
    the same counter-mode construction as chaos/plan._decide."""
    key = f"adv|{seed}|{rule_idx}|{rank}|{round_idx}".encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:4], "little")


@dataclass
class AdversaryRule:
    """One (attack, round-window, rank set) schedule entry. ``ranks`` are
    1-based COHORT ranks (standalone slot = rank - 1, which in the flat
    cross-process topology is also the transport rank; in a 2-tier
    ``--edges`` topology each worker matches by its cohort slot + 1 — the
    client manager's ``adversary_rank`` — so ONE plan drives flat and
    tree runs identically, quarantine-ledger parity included); ``rounds``
    is a half-open ``[lo, hi)`` window (None = every round). ``factor``
    parameterizes sign_flip/scale, ``sigma`` gaussian, ``z`` shift."""

    attack: str
    ranks: list[int] = field(default_factory=list)
    rounds: list[int] | None = None
    factor: float = 10.0
    sigma: float = 1.0
    z: float = 1.5

    def __post_init__(self):
        if self.attack not in ATTACKS:
            raise ValueError(
                f"unknown attack {self.attack!r} (one of {ATTACKS})")
        if not self.ranks:
            raise ValueError("adversary rule needs 'ranks': [...] "
                             "(1-based worker ranks)")
        if any(r < 1 for r in self.ranks):
            raise ValueError(f"ranks are 1-based worker ranks, got "
                             f"{self.ranks}")
        if self.rounds is not None and len(self.rounds) != 2:
            raise ValueError(f"rounds must be [lo, hi), got {self.rounds}")

    def in_window(self, round_idx: int) -> bool:
        if self.rounds is None:
            return True
        return self.rounds[0] <= round_idx < self.rounds[1]


@dataclass
class AdversaryPlan:
    """A seed plus an ordered rule list — JSON round-trippable so an
    attack/defense experiment replays from its file alone (the
    ``--adversary-plan`` launcher/soak flag)."""

    seed: int = 0
    rules: list[AdversaryRule] = field(default_factory=list)

    @classmethod
    def from_json(cls, spec: str | dict) -> "AdversaryPlan":
        doc = json.loads(spec) if isinstance(spec, str) else spec
        rules = [AdversaryRule(**r) for r in doc.get("rules", [])]
        return cls(seed=int(doc.get("seed", 0)), rules=rules)

    @classmethod
    def from_file(cls, path: str) -> "AdversaryPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))

    @classmethod
    def from_spec(cls, spec: str) -> "AdversaryPlan":
        """The CLI dual form — a JSON file path or inline JSON (the one
        dispatch rule every --*-plan flag shares)."""
        import os

        return cls.from_file(spec) if os.path.exists(spec) \
            else cls.from_json(spec)

    def to_json(self) -> str:
        def rule_doc(r: AdversaryRule) -> dict:
            doc = {"attack": r.attack, "ranks": r.ranks}
            if r.rounds is not None:
                doc["rounds"] = r.rounds
            if r.attack in ("sign_flip", "scale"):
                doc["factor"] = r.factor
            if r.attack == "gaussian":
                doc["sigma"] = r.sigma
            if r.attack == "shift":
                doc["z"] = r.z
            return doc

        return json.dumps({"seed": self.seed,
                           "rules": [rule_doc(r) for r in self.rules]})

    def byzantine_ranks(self) -> set[int]:
        return {r for rule in self.rules for r in rule.ranks}


# ------------------------------------------------------------------ host
def perturb_leaves(plan: AdversaryPlan, leaves, global_leaves, rank: int,
                   round_idx: int):
    """Apply every rule matching ``(rank, round_idx)`` to the wire leaves
    (numpy arrays), in rule order — the cross-process client's attack
    path. Returns new arrays; the honest leaves are never mutated. Only
    FLOATING leaves are attacked (both paths agree): integer leaves (step
    counters and the like) carry no gradient signal, and perturbing them
    would silently promote their wire dtype."""
    out = [np.array(v, copy=True) for v in leaves]
    g = [np.asarray(v) for v in global_leaves]

    def each(fn):
        return [fn(v, gv).astype(v.dtype)
                if np.issubdtype(v.dtype, np.floating) else v
                for v, gv in zip(out, g)]

    for rule_idx, rule in enumerate(plan.rules):
        if rank not in rule.ranks or not rule.in_window(round_idx):
            continue
        if rule.attack == "sign_flip":
            out = each(lambda v, gv: gv - rule.factor * (v - gv))
        elif rule.attack == "scale":
            out = each(lambda v, gv: gv + rule.factor * (v - gv))
        elif rule.attack == "gaussian":
            rs = np.random.RandomState(
                _attack_seed(plan.seed, rule_idx, rank, round_idx))
            out = each(lambda v, gv: v + rule.sigma
                       * rs.standard_normal(v.shape))
        elif rule.attack == "nan":
            out = each(lambda v, gv: np.full_like(v, np.nan))
        else:  # shift
            out = each(lambda v, gv: v - rule.z * np.std(v - gv))
    return out


# --------------------------------------------------------------- in-graph
def make_in_graph_injector(plan: AdversaryPlan, num_slots: int):
    """Compile ``plan`` into ``fn(stacked, global_state, round_idx) ->
    stacked`` for the engine's round, over stacked state dicts (slot ``i``
    plays worker rank ``i + 1``). The rules are static; ``round_idx`` is a
    plain int, so a rule outside its window adds no work. Perturbed values
    replace honest ones via ``torch.where`` (never arithmetic blending:
    ``s + m*(nan - s)`` would leak NaN through a zero mask); only floating
    entries are attacked, as ``perturb_leaves`` does; the slot mask is
    sliced to the stack's leading dim (a smaller cohort keeps slot i
    meaning cohort position i).

    ``gaussian`` draws ``N(0, 1)`` from an explicit ``torch.Generator`` on
    the stack's device, seeded per (plan seed, rule index, round) by
    ``_attack_seed``'s sha256 construction, entries in dict order: a
    seeded run replays bitwise. The JAX package draws from
    ``jax.random.fold_in`` chains instead, which torch cannot reproduce;
    the schedule (which slots, which rounds) is what the two agree on."""
    import torch

    rules = list(plan.rules)
    slot_masks = []
    for rule in rules:
        m = np.zeros((num_slots,), bool)
        for r in rule.ranks:
            if 1 <= r <= num_slots:
                m[r - 1] = True
        slot_masks.append(m)

    def injector(stacked, global_state, round_idx: int):
        out = dict(stacked)
        for rule_idx, (rule, slots) in enumerate(zip(rules, slot_masks)):
            if not rule.in_window(int(round_idx)) or not slots.any():
                continue
            gen = None
            if rule.attack == "gaussian":
                # one draw for the whole stack a round (rank field 0); a
                # slot the rule does not name discards its share
                dev = next(iter(out.values())).device
                gen = torch.Generator(device=dev).manual_seed(_attack_seed(
                    plan.seed, rule_idx, 0, int(round_idx)))

            def attack(s, g):
                if rule.attack == "sign_flip":
                    return g[None] - rule.factor * (s - g[None])
                if rule.attack == "scale":
                    return g[None] + rule.factor * (s - g[None])
                if rule.attack == "gaussian":
                    return s + rule.sigma * torch.randn(
                        s.shape, generator=gen, dtype=s.dtype,
                        device=s.device)
                if rule.attack == "nan":
                    return torch.full_like(s, float("nan"))
                # shift: per-client, per-entry std (ddof 0) of its update
                u = s - g[None]
                return s - rule.z * torch.std(
                    u.reshape(u.shape[0], -1), dim=1, correction=0).reshape(
                        (-1,) + (1,) * (s.ndim - 1)).to(s.dtype)

            for key, s in out.items():
                if not s.is_floating_point():
                    continue
                mask = torch.as_tensor(slots[:s.shape[0]], device=s.device)
                out[key] = torch.where(
                    mask.reshape((s.shape[0],) + (1,) * (s.ndim - 1)),
                    attack(s, global_state[key]).to(s.dtype), s)
        return out

    return injector
