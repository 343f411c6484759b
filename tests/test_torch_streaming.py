"""The port's streamed client sources (core/client_source.py, a copy of the
JAX package's) and the engine's bucketed batch depth, against the JAX
package on the CPU.

- The sources read, write and pack bitwise as the reference's do:
  ``client_rows``, ``write_packed_npy``'s files byte for byte, and
  ``pack_clients_source``'s batches (the reference's, and the port's own
  ``pack_clients`` on the materialized data).
- An engine over a streamed source is bitwise the in-memory engine, per
  round, pipelined and through the cross-process runtime.
- ``bucket_batches``: the ladder and each round's rung are the JAX
  engine's; the IndexBatch and ClientBatch packs at a bucket depth are
  bitwise the reference's; bucket on ≡ off bitwise, per round, pipelined
  and on the device-resident plane; the ``pack`` block's accounting.
"""

import json
import os

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.core import client_source as jax_cs
from fedml_tpu.core.tasks import classification_task as jax_classification_task
from fedml_tpu.data.synthetic import synthetic_lr as jax_synthetic_lr
from fedml_tpu.models.linear import LogisticRegression as JaxLR
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI, FedAvgConfig
from fedml_tpu_torch.core.client_data import pack_clients
from fedml_tpu_torch.core.client_source import (
    InMemorySource,
    LeafJsonSource,
    PackedNpySource,
    as_source,
    open_source,
    pack_clients_source,
    write_packed_npy,
)
from fedml_tpu_torch.core.tasks import classification_task
from fedml_tpu_torch.data.synthetic import synthetic_lr
from fedml_tpu_torch.models import create_model

_DATA = dict(num_clients=16, dim=12, num_classes=4, seed=3)


@pytest.fixture(scope="module")
def fd():
    # ragged (lognormal) client sizes: the skew bucketing exists for
    return synthetic_lr(**_DATA)


@pytest.fixture(scope="module")
def jfd():
    return jax_synthetic_lr(**_DATA)


def _task():
    return classification_task(create_model("lr", output_dim=4,
                                            device="cpu"))


def _cfg(**kw):
    base = dict(comm_round=3, client_num_in_total=16,
                client_num_per_round=4, batch_size=16, lr=0.1,
                frequency_of_the_test=100)
    base.update(kw)
    return base


def _api(data, cfg=None, **kw):
    return FedAvgAPI(data, _task(), FedAvgConfig(**(cfg or _cfg())),
                     device="cpu", **kw)


def _same_net(a, b, what=""):
    for k in a.net:
        assert torch.equal(a.net[k], b.net[k]), f"{what}: {k}"


def _same_batch(a, b, fields=("x", "y", "mask", "num_samples")):
    for name in fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# ------------------------------------------------------------ the sources
def test_packed_npy_files_are_the_reference_bytes(fd, jfd, tmp_path):
    """write_packed_npy of the same data writes the same files, byte for
    byte, and each package reads the other's."""
    p = write_packed_npy(fd, str(tmp_path / "p"), chunk_clients=5)
    j = jax_cs.write_packed_npy(jfd, str(tmp_path / "j"), chunk_clients=5)
    assert sorted(os.listdir(p)) == sorted(os.listdir(j))
    for name in os.listdir(p):
        with open(os.path.join(p, name), "rb") as a, \
                open(os.path.join(j, name), "rb") as b:
            assert a.read() == b.read(), name
    mine, theirs = PackedNpySource(j), jax_cs.PackedNpySource(p)
    try:
        np.testing.assert_array_equal(mine.client_sizes,
                                      theirs.client_sizes)
        for cid in (0, 7, 15):
            for a, b in zip(mine.client_rows(cid), theirs.client_rows(cid)):
                np.testing.assert_array_equal(a, b)
        assert mine.row_meta() == theirs.row_meta()
    finally:
        mine.close()
        theirs.close()


@pytest.mark.parametrize("ids,bs,mb,seed,rnd", [
    ([5, 2, 11, 7], 8, 6, 4, 9), ([1, 14, 3], 8, 4, 0, 2),
    ([0, 15], 16, None, 1, 0)])
def test_source_packs_are_the_reference_and_pack_clients(fd, jfd, tmp_path,
                                                         ids, bs, mb, seed,
                                                         rnd):
    """pack_clients_source over the in-memory and packed-npy sources:
    bitwise the reference's over its own sources and the port's
    pack_clients over the materialized data."""
    ids = np.asarray(ids)
    kw = dict(max_batches=mb, seed=seed, round_idx=rnd)
    want = pack_clients(fd, ids, bs, **kw)
    d = write_packed_npy(fd, str(tmp_path / "q"))
    for src, jsrc in ((InMemorySource(fd), jax_cs.InMemorySource(jfd)),
                      (PackedNpySource(d), jax_cs.PackedNpySource(d))):
        got = pack_clients_source(src, ids, bs, **kw)
        _same_batch(got, want)
        _same_batch(got, jax_cs.pack_clients_source(jsrc, ids, bs, **kw))


def test_leaf_json_source_reads_as_the_reference(tmp_path):
    rs = np.random.RandomState(0)
    os.makedirs(tmp_path / "train")
    os.makedirs(tmp_path / "test")
    users, sizes = ["u0", "u1", "u2"], [7, 3, 5]
    for fname, sel in (("a.json", [0, 1]), ("b.json", [2])):
        blob = {"users": [users[i] for i in sel], "user_data": {}}
        for i in sel:
            blob["user_data"][users[i]] = {
                "x": rs.randn(sizes[i], 6).round(3).tolist(),
                "y": rs.randint(0, 3, sizes[i]).tolist()}
        with open(tmp_path / "train" / fname, "w") as f:
            json.dump(blob, f)
    with open(tmp_path / "test" / "t.json", "w") as f:
        json.dump({"users": ["u0"], "user_data": {
            "u0": {"x": rs.randn(4, 6).round(3).tolist(),
                   "y": rs.randint(0, 3, 4).tolist()}}}, f)
    src = LeafJsonSource(str(tmp_path), (6,), 3)
    ref = jax_cs.LeafJsonSource(str(tmp_path), (6,), 3)
    np.testing.assert_array_equal(src.client_sizes, sizes)
    for cid in range(3):
        for a, b in zip(src.client_rows(cid), ref.client_rows(cid)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(src.test_x, ref.test_x)
    assert isinstance(open_source(str(tmp_path), input_shape=(6,),
                                  class_num=3), LeafJsonSource)
    with pytest.raises(TypeError):
        as_source([1, 2, 3])


def test_tff_h5_source_needs_h5py_on_use(tmp_path):
    """TffH5Source imports h5py when it is built, as the reference does:
    where h5py is missing the constructor raises, nothing earlier."""
    from fedml_tpu_torch.core.client_source import TffH5Source

    try:
        import h5py  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            TffH5Source(str(tmp_path / "train.h5"), 10)
    else:
        with pytest.raises(OSError):
            TffH5Source(str(tmp_path / "missing.h5"), 10)


# -------------------------------------------------------- engine identity
@pytest.mark.parametrize("prefetch", [0, 2])
def test_streamed_engine_is_the_in_memory_engine(fd, tmp_path, prefetch):
    a = _api(fd)
    for r in range(3):
        a.run_round(r)
    src = PackedNpySource(write_packed_npy(fd, str(tmp_path / "s")))
    try:
        b = _api(src, prefetch=prefetch, bucket_batches=True)
        if prefetch:
            b.run_pipelined(0, 3)
        else:
            for r in range(3):
                b.run_round(r)
        _same_net(a, b, "streamed")
        if not prefetch:  # the async runner packs through the same plane
            c, d = _api(fd), _api(src)
            c.run_async(4, buffer_k=4, staleness_bound=0)
            d.run_async(4, buffer_k=4, staleness_bound=0)
            _same_net(c, d, "streamed async")
    finally:
        src.close()


def test_streamed_refusals(fd, tmp_path):
    src = PackedNpySource(write_packed_npy(fd, str(tmp_path / "r")))
    try:
        with pytest.raises(ValueError, match="streamed"):
            _api(src, device_data=True)
        with pytest.raises(ValueError, match="streamed"):
            _api(src, _cfg(local_test_on_all_clients="on"))
    finally:
        src.close()


def test_size_weighted_sampling_reads_source_sizes(fd, tmp_path):
    c = _cfg(sampling="size_weighted")
    a = _api(fd, c)
    src = PackedNpySource(write_packed_npy(fd, str(tmp_path / "w")))
    try:
        b = _api(src, c)
        np.testing.assert_array_equal(a._client_sizes, b._client_sizes)
        for r in range(2):
            a.run_round(r)
            b.run_round(r)
        _same_net(a, b, "size_weighted streamed")
    finally:
        src.close()


def test_streamed_source_over_the_wire(fd, tmp_path):
    """Every rank of run_simulated over a packed-npy source: bitwise the
    in-memory run (the trainers read only their client's rows)."""
    from fedml_tpu_torch.distributed.fedavg import run_simulated

    cfg = FedAvgConfig(**_cfg(comm_round=2, max_batches=3))
    want = run_simulated(fd, _task(), cfg, device="cpu", job_id="t-mem")
    src = PackedNpySource(write_packed_npy(fd, str(tmp_path / "x")))
    try:
        got = run_simulated(src, _task(), cfg, device="cpu", job_id="t-src")
    finally:
        src.close()
    _same_net(want, got, "streamed wire")
    assert got.history == want.history


# -------------------------------------------------------------- bucketing
def test_bucket_ladder_and_rungs_are_the_jax_engine(fd, jfd):
    """The ladder, every need's rung and each round's picked bucket depth
    (the pack block's ``bucket_B`` / ``b_needed``) are the JAX engine's."""
    from fedml_tpu.obs import Telemetry as JaxTelemetry
    from fedml_tpu_torch.obs import Telemetry

    cfg = _cfg(max_batches=28)
    tel, jtel = Telemetry(), JaxTelemetry()
    try:
        api = _api(fd, cfg, bucket_batches=True, telemetry=tel)
        japi = JaxFedAvgAPI(jfd, jax_classification_task(JaxLR(
            num_classes=4)), JaxConfig(**cfg), bucket_batches=True,
            telemetry=jtel)
        assert api._b_ladder == japi._b_ladder and len(api._b_ladder) > 1
        for need in range(api.num_batches + 2):
            assert api._bucketed_B(need) == japi._bucketed_B(need)
        for r in range(4):
            api.run_round(r)
            japi.run_round(r)
        pick = lambda t: [(rec["round"], rec["pack"]) for rec in
                          t.events.sink.records if rec.get("kind") == "round"]
        assert pick(tel) == pick(jtel)
    finally:
        tel.close()
        jtel.close()


@pytest.mark.parametrize("device_data", [False, True])
def test_bucket_depth_packs_are_the_reference(fd, jfd, device_data):
    """The round's host pack at its bucket depth (an IndexBatch on the
    device-resident plane, else a ClientBatch) is the reference's."""
    api = _api(fd, bucket_batches=True, device_data=device_data)
    japi = JaxFedAvgAPI(jfd, jax_classification_task(JaxLR(num_classes=4)),
                        JaxConfig(**_cfg()), bucket_batches=True,
                        device_data=device_data)
    for r in range(3):
        got = api._pack_round(r, api._sampled_ids(r))
        want = japi._pack_round(r)
        fields = (("idx", "mask", "num_samples") if device_data
                  else ("x", "y", "mask", "num_samples"))
        _same_batch(got, want, fields)


@pytest.mark.parametrize("device_data", [False, True])
def test_bucket_on_equals_off(fd, device_data):
    a = _api(fd, device_data=device_data)
    for r in range(3):
        a.run_round(r)
    b = _api(fd, bucket_batches=True, device_data=device_data)
    for r in range(3):
        b.run_round(r)
    _same_net(a, b, "bucketed per round")
    p = _api(fd, bucket_batches=True, prefetch=2, device_data=device_data)
    p.run_pipelined(0, 3)
    _same_net(a, p, "bucketed pipelined")


def test_bucketed_local_fit_is_bitwise_per_client(fd):
    """Each real client's fit is bitwise the same padded to the bucket or
    to the budget (trailing all-masked batches are exact no-ops)."""
    from fedml_tpu_torch.core.client_data import pad_batches

    api = _api(fd, _cfg(max_batches=28))
    for r in range(10):  # the first round whose rung is below the budget
        ids = api._sampled_ids(r)
        cb = pack_clients(fd, ids, 16, max_batches=api.num_batches, seed=0,
                          round_idx=r)
        if api._bucketed_B(cb.num_batches) < api.num_batches:
            break
    full = pad_batches(cb, api.num_batches)
    bucket = pad_batches(cb, api._bucketed_B(cb.num_batches))
    assert bucket.num_batches < full.num_batches
    t = lambda b: [torch.from_numpy(a) for a in (b.x, b.y, b.mask)]
    na, ma = api.local_update(api.net, *t(full))
    nb, mb = api.local_update(api.net, *t(bucket))
    for k in na:
        assert torch.equal(na[k], nb[k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_pack_block_accounting_and_dataset_source(fd, tmp_path):
    from fedml_tpu_torch.obs import Telemetry

    tel = Telemetry()
    src = PackedNpySource(write_packed_npy(fd, str(tmp_path / "t")))
    try:
        api = _api(src, bucket_batches=True, telemetry=tel)
        api.train(2)
        recs = tel.events.sink.records
    finally:
        src.close()
        tel.close()
    hdr = [r for r in recs if r.get("kind") == "run"][0]
    assert hdr["dataset_source"] == "synthetic"
    rounds = [r for r in recs if r.get("kind") == "round"]
    assert len(rounds) == 2
    for r in rounds:
        pk = r["pack"]
        assert pk["b_needed"] <= pk["bucket_B"] <= pk["budget_B"]
        assert pk["bucket_B"] in api._b_ladder
        # the numpy oracle of the padding share: real batches over slots
        sizes = [min(len(fd.train_idx_map[c]), 16 * pk["budget_B"])
                 for c in r["clients"]]
        used = float(np.sum(np.ceil(np.asarray(sizes) / 16)))
        assert pk["pad_frac"] == round(1.0 - used / (4 * pk["bucket_B"]), 4)
        assert pk["bytes"] > 0
        assert r["goodput"]["variant"] == f"round_b{pk['bucket_B']}"
