"""The port's host data plane is bitwise the JAX package's: synthetic
sequences, per-round sampling, packing, batch padding and eval batching
compute in numpy on both sides, so every array must be byte-equal."""

import numpy as np
import pytest

from fedml_tpu.algorithms.fedavg import FedAvgConfig as JaxConfig
from fedml_tpu.algorithms.fedavg import eval_subset as jax_eval_subset
from fedml_tpu.core import client_data as jcd
from fedml_tpu.core import sampling as jsamp
from fedml_tpu.data import registry as jreg
from fedml_tpu.data.synthetic import synthetic_sequences as jax_sequences
from fedml_tpu_torch.algorithms.fedavg import FedAvgConfig, eval_subset
from fedml_tpu_torch.core import client_data as tcd
from fedml_tpu_torch.core import sampling as tsamp
from fedml_tpu_torch.data import registry as treg
from fedml_tpu_torch.data.synthetic import synthetic_sequences


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_data(a, b):
    for f in ("train_x", "train_y", "test_x", "test_y"):
        _equal(getattr(a, f), getattr(b, f))
    assert a.train_idx_map.keys() == b.train_idx_map.keys()
    for c in a.train_idx_map:
        _equal(a.train_idx_map[c], b.train_idx_map[c])
    assert a.test_idx_map == b.test_idx_map and a.class_num == b.class_num


def _ragged(data_cls, seed=0):
    """A ragged population: client sizes 1..13, shuffled row ownership."""
    rs = np.random.RandomState(seed)
    sizes = rs.randint(1, 14, size=6)
    rows = rs.permutation(int(sizes.sum()))
    x = rs.randint(1, 50, size=(len(rows), 12)).astype(np.int64)
    idx, off = {}, 0
    for c, n in enumerate(sizes):
        idx[c] = rows[off:off + n]
        off += n
    return data_cls(x, (x + 1) % 50, x[:5], x[:5], idx, None, 50)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_sequences_bitwise(seed):
    kw = dict(num_clients=3, seq_len=16, vocab_size=20,
              samples_per_client=3, test_samples=4, seed=seed)
    _same_data(synthetic_sequences(**kw), jax_sequences(**kw))


def test_registry_sequence_dataset_bitwise():
    kw = dict(client_num=2, samples_per_client=2, test_samples=3, seed=1)
    _same_data(treg.load_dataset("shakespeare", **kw),
               jreg.load_dataset("shakespeare", **kw))
    for name, spec in treg.DATASETS.items():
        assert vars(spec) == vars(jreg.DATASETS[name])


@pytest.mark.parametrize("sampling", ["uniform", "size_weighted"])
def test_sample_for_bitwise(sampling):
    data = _ragged(tcd.FederatedData)
    kw = dict(client_num_in_total=6, client_num_per_round=3, seed=7,
              sampling=sampling)
    cfg, jcfg = FedAvgConfig(**kw), JaxConfig(**kw)
    sizes = tsamp.prepare_sampling(cfg, data)
    jsizes = jsamp.prepare_sampling(jcfg, data)
    assert (sizes is None) == (jsizes is None) == (sampling == "uniform")
    if sizes is not None:
        _equal(sizes, jsizes)
    for r in range(6):
        _equal(tsamp.sample_for(cfg, r, sizes), jsamp.sample_for(jcfg, r, jsizes))


def test_splitmix_shuffle_and_client_seeds_bitwise():
    ids = np.array([0, 5, 17, 123456])
    _equal(tcd.client_shuffle_seeds(ids, 3, 9), jcd.client_shuffle_seeds(ids, 3, 9))
    for seed in (0, 1, 2**63 + 5):
        a, b = np.arange(37), np.arange(37)
        tcd._splitmix_shuffle(a, seed)
        jcd._splitmix_shuffle(b, seed)
        _equal(a, b)


@pytest.mark.parametrize("max_batches", [None, 2])
def test_pack_clients_bitwise(max_batches):
    tdata, jdata = _ragged(tcd.FederatedData), _ragged(jcd.FederatedData)
    ids = np.array([0, 2, 3, 5])
    for r in (0, 4):
        a = tcd.pack_clients(tdata, ids, 4, max_batches=max_batches, seed=2,
                             round_idx=r)
        b = jcd.pack_clients(jdata, ids, 4, max_batches=max_batches, seed=2,
                             round_idx=r, use_native=False)
        for f in ("x", "y", "mask", "num_samples"):
            _equal(getattr(a, f), getattr(b, f))


def test_pad_batches_bitwise():
    tdata, jdata = _ragged(tcd.FederatedData), _ragged(jcd.FederatedData)
    ids = np.array([1, 4])
    a = tcd.pad_batches(tcd.pack_clients(tdata, ids, 3, seed=1), 7)
    b = jcd.pad_batches(jcd.pack_clients(jdata, ids, 3, seed=1,
                                         use_native=False), 7)
    assert a.num_batches == 7
    for f in ("x", "y", "mask", "num_samples"):
        _equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("batch_size", [4, 5])
def test_batch_global_bitwise(batch_size):
    data = _ragged(tcd.FederatedData)
    for a, b in zip(tcd.batch_global(data.train_x, data.train_y, batch_size),
                    jcd.batch_global(data.train_x, data.train_y, batch_size)):
        _equal(a, b)


@pytest.mark.parametrize("mode", ["fixed", "fresh"])
def test_eval_subset_bitwise(mode):
    data = _ragged(tcd.FederatedData)
    kw = dict(eval_max_samples=17, eval_subset_mode=mode, seed=4)
    for call in (1, 2):
        for a, b in zip(eval_subset(data.train_x, data.train_y,
                                    FedAvgConfig(**kw), call),
                        jax_eval_subset(data.train_x, data.train_y,
                                        JaxConfig(**kw), call)):
            _equal(a, b)
