"""FedAvg with sequence-parallel clients, port of
fedml_tpu/algorithms/fedavg_seq.py: long-context federated training over
a 2-axis ``('clients', 'seq')`` mesh (fedml_tpu_torch.mesh.make_2d_mesh).

- The 'clients' axis is FL client parallelism: each rank of a 'seq' row
  holds a block of ``K / clients`` clients of the sampled cohort, and the
  aggregate is a weighted all-reduce over the axis.
- The 'seq' axis shards every client's ACTIVATIONS over the sequence: each
  rank holds ``T / seq`` positions and the TransformerLM runs ring (or
  Ulysses) attention over the axis (parallel/ring_attention.py). The
  task's loss is psum-ed over 'seq' and the params enter the model
  through ``seq_invariant`` (core/tasks.sequence_task), so the gradient on
  every rank is the full-sequence gradient.

The JAX package drives the mesh from one controller (``shard_map``); the
port is multi-controller: every rank of an initialized
``torch.distributed`` world (``torchrun``, or
fedml_tpu_torch.mesh.world.spawn) builds the same ``FedAvgSeqAPI``, samples
and packs the same cohort on the host, keeps its client block and its
sequence slice, and ends each round holding the same global model. With
T divisible by the 'seq' axis and the cohort by 'clients', a round equals
the single-device engine's on the same config (tests/test_torch_fedavg_seq.py).

Labels arrive pre-shifted per position (y[t] = x[t+1],
data/synthetic.py:synthetic_sequences), so sharding T splits x and y
consistently and no cross-shard label exchange is needed.

The key chain is FedAvgAPI's: ``PRNGKey(seed)`` split once for the init;
the fit draws no randomness, so a round takes no key (the reference's
round program folds round and client ids into per-client keys the fit
never reads). ``run_rounds`` is a loop of ``run_round`` (the scanned
block program is ROADMAP.md queue A, item 5); the server optimizer hooks
and ``donate`` are items 5 and 9 and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import (
    FedAvgConfig,
    agg_weights,
    eval_subset,
    float32_compute,
    make_client_optimizer,
)
from fedml_tpu_torch.collectives.ops import psum
from fedml_tpu_torch.core.client_data import (
    FederatedData,
    batch_global,
    pack_clients,
    pad_batches,
)
from fedml_tpu_torch.core.local import (
    METRICS,
    LocalSpec,
    make_eval_fn,
    make_local_update,
    refuse_extras,
)
from fedml_tpu_torch.core.sampling import prepare_sampling, sample_for
from fedml_tpu_torch.core.tasks import sequence_task
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.utils import prng


@torch.no_grad()
def _shard_aggregate(nets: dict, metrics: dict, weights, axis):
    """Weighted aggregation of this rank's client block, reduced over the
    clients ``axis``: the weighted sums of the nets, their weight and the
    metric sums in ONE all-reduce, then avg = sum(w * net) / max(sum(w),
    1e-12), as fedml_tpu/algorithms/fedavg.py:167-179."""
    keys = list(nets)
    w = weights.to(torch.float32)
    parts = [torch.tensordot(w, nets[k], dims=([0], [0])) for k in keys]
    parts += [w.sum()] + [metrics[k].sum() for k in METRICS]
    flat = psum(torch.cat([p.reshape(-1) for p in parts]), axis)
    out = flat.split([p.numel() for p in parts])
    den = out[len(keys)].clamp_min(1e-12)
    avg = {k: o.view_as(p) / den for k, o, p in zip(keys, out, parts)}
    msum = {k: out[len(keys) + 1 + i][0] for i, k in enumerate(METRICS)}
    return avg, msum


class FedAvgSeqAPI:
    """FedAvg over a ('clients', 'seq') ``ProcessMesh``, one instance per
    rank (see the module docstring).

    ``model_ctor(seq_axis)`` builds the language model; it is called twice:
    with this rank's 'seq' axis handle for the sharded fit, and with
    ``None`` for init and eval (the same parameter names; only the
    attention differs). The engine moves both to ``device``: the rank's
    current CUDA device when None (``torch.cuda.set_device`` from
    ``LOCAL_RANK`` under torchrun), or ``"cpu"`` with a gloo world."""

    def __init__(
        self,
        dataset: FederatedData,
        model_ctor,
        config: FedAvgConfig,
        mesh,
        pad_id: int = 0,
        server_update=None,
        server_opt_init=None,
        local_spec: LocalSpec | None = None,
        donate: bool = False,
        device=None,
    ):
        refused = [n for n, v in (("server_update", server_update),
                                  ("server_opt_init", server_opt_init),
                                  ("donate", donate)) if v]
        if refused:
            raise NotImplementedError(
                f"FedAvgSeqAPI options {refused} are not ported yet: "
                "ROADMAP.md queue A, items 5 and 9")
        if "clients" not in mesh.axis_names or "seq" not in mesh.axis_names:
            raise ValueError(
                f"FedAvgSeqAPI needs axes ('clients','seq'), got {mesh.axis_names}")
        self.data, self.cfg, self.mesh = dataset, config, mesh
        self.device = resolve_device(device)
        # size_weighted sampling pairs with the uniform aggregate, as on
        # FedAvgAPI (core/sampling sample_for)
        self.uniform_avg = config.sampling == "size_weighted"
        self._client_sizes = prepare_sampling(config, dataset)
        cd, sd = mesh.shape["clients"], mesh.shape["seq"]
        T = int(dataset.train_x.shape[1])
        if T % sd != 0:
            raise ValueError(f"sequence length {T} not divisible by seq axis {sd}")
        if config.client_num_per_round % cd != 0:
            raise ValueError(
                f"client_num_per_round={config.client_num_per_round} must be "
                f"a multiple of the clients axis {cd}")

        self._clients, self._seq = mesh["clients"], mesh["seq"]
        self.task_plain = sequence_task(model_ctor(None).to(self.device),
                                        pad_id=pad_id)
        # its rounds fold params only and key no fit
        refuse_extras(self.task_plain, "FedAvgSeqAPI", key=True)
        sharded_model = model_ctor(self._seq).to(self.device)
        if (getattr(sharded_model, "seq_impl", "ring") == "ulysses"
                and getattr(sharded_model, "num_heads", None) is not None
                and sharded_model.num_heads % mesh.shape["seq"] != 0):
            # fail at construction with the real reason, not a low-level
            # all_to_all split error in the first round
            raise ValueError(
                f"ulysses needs num_heads ({sharded_model.num_heads}) "
                f"divisible by the seq axis ({mesh.shape['seq']})")
        self.task_sharded = sequence_task(sharded_model, pad_id=pad_id,
                                          seq_axis=self._seq)
        self.eval_fn = make_eval_fn(self.task_plain)

        counts = [len(v) for v in dataset.train_idx_map.values()]
        b_needed = int(np.ceil(max(counts) / config.batch_size))
        self.num_batches = min(config.max_batches or b_needed, b_needed)

        # the reference's spec (fedml_tpu/algorithms/fedavg_seq.py:116-118):
        # with none passed, (optimizer, epochs, remat) from the config, which
        # leaves config.precision unread (f32); a passed spec as it is, so
        # bf16 on the seq path is LocalSpec(..., compute_dtype='bf16'), and
        # a prox_mu > 0 spec gives FedProx on long context (the proximal
        # term is over the raw, seq-invariant params: the same on every
        # rank, no exchange)
        self.local_spec = local_spec or LocalSpec(
            optimizer=make_client_optimizer(config), epochs=config.epochs,
            remat=config.remat)
        self.local_update = make_local_update(self.task_sharded,
                                              self.local_spec)

        # FedAvgAPI's key chain: PRNGKey(seed), one split for the init
        self.rng = prng.split(prng.key(config.seed))[0]
        init = self.task_plain.init(torch.Generator().manual_seed(config.seed),
                                    dataset.train_x[: config.batch_size])
        self.net = {k: v.to(self.device) for k, v in init.items()}
        self.server_opt_state = ()  # FedOpt's state: item 9
        self._test_cache = None
        self._eval_calls = 0
        self.history: list[dict] = []

    # ---------------------------------------------------------------- round
    def _sampled_ids(self, round_idx: int):
        return sample_for(self.cfg, round_idx, self._client_sizes)

    def _block(self, cb):
        """This rank's block of a packed round: clients [K/cd] x the
        sequence slice [T/sd] of x and y, on the device."""
        c, s = self._clients, self._seq
        kb, tb = cb.x.shape[0] // c.size, cb.x.shape[-1] // s.size
        rows = slice(c.index * kb, (c.index + 1) * kb)
        cols = slice(s.index * tb, (s.index + 1) * tb)
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a)).to(self.device)
        return (put(cb.x[rows, ..., cols]), put(cb.y[rows, ..., cols]),
                put(cb.mask[rows]), put(cb.num_samples[rows]))

    def _per_round(self, net, opt, x, y, mask, nsamp):
        """One round on this rank's block: the block's batched fit (its
        attention and its gradient exchanging over 'seq'), then the
        weighted all-reduce over 'clients'. The server update is the
        identity on the mean until FedOpt (item 9)."""
        nets, metrics = self.local_update(net, x, y, mask)
        avg, msum = _shard_aggregate(
            nets, metrics, agg_weights(nsamp, self.uniform_avg),
            self._clients)
        return avg, opt, msum

    def run_round(self, round_idx: int) -> dict:
        """One round; returns the summed training metrics (device scalars,
        the same on every rank)."""
        cfg = self.cfg
        ids = self._sampled_ids(round_idx)
        cb = pack_clients(self.data, ids, cfg.batch_size,
                          max_batches=self.num_batches, seed=cfg.seed,
                          round_idx=round_idx)
        # a fixed B every round (padded batches are exact no-ops of the fit)
        cb = pad_batches(cb, self.num_batches)
        with float32_compute():
            self.net, self.server_opt_state, metrics = self._per_round(
                self.net, self.server_opt_state, *self._block(cb))
        return metrics

    def run_rounds(self, start_round: int, num_rounds: int) -> dict:
        """Rounds ``start_round`` .. ``start_round + num_rounds - 1``, the
        metrics stacked along axis 0: a loop of ``run_round`` (the
        reference's one scanned program is item 5)."""
        ms = [self.run_round(r)
              for r in range(start_round, start_round + num_rounds)]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def train(self, num_rounds: int | None = None):
        rounds = num_rounds or self.cfg.comm_round
        for r in range(rounds):
            metrics = self.run_round(r)
            if r % self.cfg.frequency_of_the_test == 0 or r == rounds - 1:
                ev = self.evaluate()
                n = float(max(float(metrics["count"]), 1.0))
                self.history.append({
                    "round": r,
                    "train_loss": float(metrics["loss_sum"]) / n,
                    "train_acc": float(metrics["correct"]) / n,
                    "test_loss": float(ev["loss"]),
                    "test_acc": float(ev["acc"]),
                })
        return self.net

    # ---------------------------------------------------------------- state
    def load_state(self, net: dict, server_opt_state=(), rng=None):
        """Install restored state on this rank's device (every rank loads
        the same state), as FedAvgAPI.load_state."""
        if set(net) != set(self.net):
            raise ValueError(f"state keys {sorted(net)} do not match the "
                             f"model's {sorted(self.net)}")
        self.net = {k: torch.as_tensor(v).to(self.device, self.net[k].dtype)
                    for k, v in net.items()}
        self.server_opt_state = server_opt_state
        if rng is not None:
            self.rng = np.asarray(rng, np.uint32).reshape(2).copy()

    # ----------------------------------------------------------------- eval
    def evaluate(self) -> dict:
        """Global test eval on the axis-free twin (every rank holds the
        global model; for eval-sized batches the plain path is fine)."""
        fresh = (self.cfg.eval_subset_mode == "fresh"
                 and self.cfg.eval_max_samples is not None
                 and len(self.data.test_x) > self.cfg.eval_max_samples)
        self._eval_calls += 1
        if self._test_cache is None or fresh:
            # the same validation-subset policy as FedAvgAPI.evaluate
            tx, ty = eval_subset(self.data.test_x, self.data.test_y,
                                 self.cfg, self._eval_calls)
            n = len(tx)
            if self.cfg.ci:
                n = min(n, 512)
            self._test_cache = tuple(
                torch.from_numpy(a).to(self.device) for a in batch_global(
                    tx[:n], ty[:n], self.cfg.eval_batch_size))
        with float32_compute():
            return self.eval_fn(self.net, *self._test_cache)
