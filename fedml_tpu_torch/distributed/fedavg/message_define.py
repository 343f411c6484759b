"""FedAvg message vocabulary.

Mirror of fedml_api/distributed/fedavg/message_define.py:6-11.
"""


class MyMessage:
    # server -> client
    MSG_TYPE_S2C_INIT_CONFIG = "s2c_init"
    MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT = "s2c_sync"
    MSG_TYPE_S2C_FINISH = "s2c_finish"
    # client -> server
    MSG_TYPE_C2S_SEND_MODEL_TO_SERVER = "c2s_send_model"

    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_ROUND = "round_idx"
    # buffered-async dispatch (docs/ROBUSTNESS.md §Asynchronous buffered
    # rounds): the rank's dispatch-wave counter rides the downlink and is
    # echoed verbatim on the upload — the server must not reconstruct it
    # from its own counter (a reprobe can put two dispatches in flight),
    # and the client folds its local-fit rng/batch order by the WAVE, so
    # a requeued dispatch draws fresh batches instead of replaying the
    # version-keyed ones. Absent on synchronous rounds (wire unchanged).
    MSG_ARG_KEY_DISPATCH_WAVE = "dispatch_wave"
    # sparse uplink (comm/sparse.py): flat top-k indices + values per leaf,
    # replacing MODEL_PARAMS; the server densifies against the stashed
    # broadcast of the version the upload's ROUND tag names
    MSG_ARG_KEY_SPARSE_IDX = "sparse_idx"
    MSG_ARG_KEY_SPARSE_VAL = "sparse_val"
    # quantized/delta uplink (comm/delta.py, docs/PERFORMANCE.md §Wire
    # efficiency): UPDATE_CODEC names the tier ('delta' | 'delta-int8' |
    # 'delta-sign1'), UPDATE_PAYLOAD carries one encoded array per model
    # leaf, UPDATE_SCALE the per-leaf f32 scales. All replace MODEL_PARAMS;
    # the base version is the echoed ROUND tag (same stash lookup as the
    # sparse tier). Payload/scale keys are in Message.LOSSY_EXEMPT — the
    # lossy frame tiers must never re-encode them.
    MSG_ARG_KEY_UPDATE_CODEC = "upd_codec"
    MSG_ARG_KEY_UPDATE_PAYLOAD = "upd_q"
    MSG_ARG_KEY_UPDATE_SCALE = "upd_scale"
    # hierarchical 2-tier topology (docs/ROBUSTNESS.md §Hierarchical
    # tiers; distributed/fedavg/hierarchy.py): the root sends ONE s2c
    # frame per EDGE carrying CHILD_CLIENTS (the cohort slots' client
    # assignments for that edge's block); the edge fans it out to its
    # workers as ordinary s2c frames, tree-reduces their sanitized
    # uplinks, and answers with ONE e2s_agg frame — a pre-aggregated
    # update (EDGE_WSUM, canonical pairwise weighted SUM, never a mean:
    # the division happens once, at the root) + its weight total
    # (EDGE_WEIGHT) + per-child quarantine verdicts (EDGE_REASONS, slot
    # ids in EDGE_SLOTS, trained client ids in EDGE_CLIENTS). Root
    # fan-in is O(edges), and tree ≡ flat stays bitwise under
    # sum_assoc='pairwise' (test-enforced).
    MSG_TYPE_E2S_SEND_AGG_TO_SERVER = "e2s_agg"
    MSG_ARG_KEY_CHILD_CLIENTS = "child_clients"
    MSG_ARG_KEY_EDGE_WSUM = "edge_wsum"
    MSG_ARG_KEY_EDGE_WEIGHT = "edge_weight"
    MSG_ARG_KEY_EDGE_REASONS = "edge_reasons"
    MSG_ARG_KEY_EDGE_SLOTS = "edge_slots"
    MSG_ARG_KEY_EDGE_CLIENTS = "edge_clients"
    # raw client-reported sample mass of the uploads that ARRIVED at the
    # edge (pre-gate, pre-verdict) — telemetry only, never the division:
    # under two-phase robust gating EDGE_WEIGHT is the fold total of the
    # VERDICT weights (krum's winner folds at weight exactly 1.0), so the
    # round record's num_samples would otherwise read verdict mass, not
    # sample mass, and diverge from the flat twin's
    MSG_ARG_KEY_EDGE_SAMPLES = "edge_samples"
    # two-phase cross-tier robust gating (docs/ROBUSTNESS.md §Cross-tier
    # robust gating): with a robust aggregator / sanitation gate armed in
    # tree mode, the edge HOLDS its block's staged uploads and first
    # forwards ONE e2s_evidence frame — per-slot sanitation evidence
    # (EVIDENCE_NORM update norms, EVIDENCE_FINITE flags, the [C, S]
    # EVIDENCE_SKETCH count-sketch of the flattened updates, and the raw
    # EVIDENCE_WEIGHT sample counts), sketch_dim + 3 scalars per client.
    # The root runs the cohort-global gate + estimator selection over the
    # gathered evidence and answers each edge with ONE s2e_verdict frame
    # (VERDICT_WEIGHTS: per-slot survivor weights, zero = rejected or
    # unselected; VERDICT_REASONS: the ledger's reason codes). The edge
    # then folds ONLY the survivors (zero-weight slots replaced by the
    # held global — exact zero terms) and forwards the ordinary e2s_agg
    # partial, so steady root ingress stays O(edges) update frames and
    # only O(cohort) scalar evidence ever reaches the root. Both frame
    # types are round-tagged and deduped like any FMT2 frame.
    MSG_TYPE_E2S_SEND_EVIDENCE_TO_SERVER = "e2s_evidence"
    MSG_TYPE_S2E_SEND_VERDICT_TO_EDGE = "s2e_verdict"
    MSG_ARG_KEY_EVIDENCE_NORM = "ev_norm"
    MSG_ARG_KEY_EVIDENCE_FINITE = "ev_finite"
    MSG_ARG_KEY_EVIDENCE_SKETCH = "ev_sketch"
    MSG_ARG_KEY_EVIDENCE_WEIGHT = "ev_weight"
    MSG_ARG_KEY_VERDICT_WEIGHTS = "verdict_w"
    MSG_ARG_KEY_VERDICT_REASONS = "verdict_reasons"
    # masked secure aggregation (docs/ROBUSTNESS.md §Secure aggregation;
    # distributed/turboaggregate.py): uploads carry the MASKED field
    # vector + the Shamir share vector of the client's self-mask seed
    # (share k addressed to cohort slot k) inside MODEL_PARAMS' leaf
    # list. When clients drop inside round_timeout_s the server sends
    # each SURVIVOR one s2c_reveal frame naming the dead slots
    # (SECAGG_DEAD, round-tagged); the survivor answers one c2s_reveal
    # frame with its pairwise seeds for exactly those slots
    # (SECAGG_PAIR_SEEDS, same order as the echoed SECAGG_DEAD) — the
    # shares/seeds that let the server strip the dead clients' orphaned
    # pairwise masks and the live clients' self-masks. Below t+1
    # survivors (or a reveal lost past the deadline) the round sheds and
    # re-broadcasts instead of wedging.
    MSG_TYPE_S2C_REVEAL_REQUEST = "s2c_reveal"
    MSG_TYPE_C2S_REVEAL_SHARES = "c2s_reveal"
    MSG_ARG_KEY_SECAGG_DEAD = "secagg_dead"
    MSG_ARG_KEY_SECAGG_PAIR_SEEDS = "secagg_pair_seeds"
    # hierarchical masked secure aggregation (docs/ROBUSTNESS.md
    # §Hierarchical secure aggregation): with --edges each worker's
    # pairwise masks are drawn WITHIN its edge block (seeds/keys stay
    # cohort-global, partners restricted), so the masks cancel at the
    # edge. The edge folds its block's masked uploads mod p, runs the
    # tiered reveal locally for in-block dead slots (s2c_reveal /
    # c2s_reveal between edge and its workers, same frames as the flat
    # tier), strips the masks, and forwards ONE e2s_masked_agg frame per
    # round: the UNMASKED int64 field partial (EDGE_FIELD_SUM — still
    # additive mod p; the root folds E partials and decodes ONCE), the
    # block's survivor/dead GLOBAL slot ids (EDGE_SURVIVORS / EDGE_DEAD),
    # per-surviving-slot sample counts keyed by global slot
    # (EDGE_SLOT_SAMPLES), the block's plaintext extra-state pytrees
    # (EDGE_EXTRAS, one per survivor, slot order), and how the block
    # decoded (SECAGG_OUTCOME full|recovered|shed + SECAGG_RECOVERY_S).
    # A whole edge lost inside round_timeout_s is the only case the root
    # handles: it sheds exactly that block's slots — no cross-block mask
    # ever needs repair. Root ingress stays O(edges) frames.
    MSG_TYPE_E2S_SEND_MASKED_AGG_TO_SERVER = "e2s_masked_agg"
    MSG_ARG_KEY_EDGE_FIELD_SUM = "edge_field_sum"
    MSG_ARG_KEY_EDGE_SURVIVORS = "edge_survivors"
    MSG_ARG_KEY_EDGE_DEAD = "edge_dead"
    MSG_ARG_KEY_EDGE_SLOT_SAMPLES = "edge_slot_samples"
    MSG_ARG_KEY_EDGE_EXTRAS = "edge_extras"
    MSG_ARG_KEY_SECAGG_OUTCOME = "secagg_outcome"
    MSG_ARG_KEY_SECAGG_RECOVERY_S = "secagg_recovery_s"
    # server crash recovery (docs/ROBUSTNESS.md §Server crash recovery):
    # after a restart every s2c frame carries the server's RESTART_EPOCH
    # (absent on epoch-0 runs — the wire is unchanged until a crash
    # actually happens; stock peers ignore it) and clients echo it on
    # every upload, so the epoch gate sheds pre-crash in-flight work
    # exactly once (counted ``server_restart``) instead of double-folding
    # it into the re-dispatched round. A server that recovers a WAL with
    # an OPEN (uncommitted) round first sends each rank one s2c_resume
    # probe; the client answers c2s_resume with the LAST round (and async
    # dispatch wave) it saw, letting the server deterministically decide
    # per rank between re-dispatch and shed before re-broadcasting the
    # open round under the new epoch.
    MSG_TYPE_S2C_RESUME_PROBE = "s2c_resume"
    MSG_TYPE_C2S_RESUME_ACK = "c2s_resume"
    MSG_ARG_KEY_RESTART_EPOCH = "restart_epoch"
    MSG_ARG_KEY_LAST_SEEN_ROUND = "last_seen_round"
    MSG_ARG_KEY_LAST_SEEN_WAVE = "last_seen_wave"
    # fleet observability plane (docs/OBSERVABILITY.md §Fleet rollup;
    # obs/fleet.py owns the semantics — this constant mirrors
    # fleet.TELEMETRY_KEY, test-pinned equal): with Telemetry(fleet=True)
    # on rank 0 every s2c frame carries a small enablement marker under
    # this key and every uplink piggybacks the rank's compact digest
    # (round/wave, counter deltas, phase-timing sketch, ε, memory); an
    # edge folds its block's digests into ONE blob on its e2s_agg frame
    # so root ingress stays O(edges). Stock peers ignore the key; with
    # the plane off (the default) no frame carries it — the wire is
    # byte-identical, test-enforced.
    MSG_ARG_KEY_TELEMETRY = "__telemetry"
    # round-delta broadcast (server -> warm client): DELTA_PARAMS replaces
    # MODEL_PARAMS and BASE_VERSION names the global version the delta was
    # computed against — the client must hold exactly that version (the
    # server only sends deltas to ranks whose last upload PROVED it); cold
    # ranks (joiners, reprobes, elastic re-sends) get the dense fallback
    MSG_ARG_KEY_DELTA_PARAMS = "delta_params"
    MSG_ARG_KEY_BASE_VERSION = "base_version"
