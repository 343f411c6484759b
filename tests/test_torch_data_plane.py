"""The port's host data plane for the main path is bitwise the JAX
package's: partitions, the synthetic image and LEAF-LR generators, the
registry's classification datasets, the C++ and numpy packers, the index
plane and the client subset views all compute in numpy (or C++) on both
sides, so every array must be byte-equal."""

import numpy as np
import pytest

from fedml_tpu.core import client_data as jcd
from fedml_tpu.core import partition as jpart
from fedml_tpu.data import registry as jreg
from fedml_tpu.data import synthetic as jsyn
from fedml_tpu_torch import native
from fedml_tpu_torch.core import client_data as tcd
from fedml_tpu_torch.core import partition as tpart
from fedml_tpu_torch.data import registry as treg
from fedml_tpu_torch.data import synthetic as tsyn


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def _same_map(a, b):
    assert a.keys() == b.keys()
    for c in a:
        _equal(a[c], b[c])


def _same_data(a, b):
    for f in ("train_x", "train_y", "test_x", "test_y"):
        _equal(getattr(a, f), getattr(b, f))
    _same_map(a.train_idx_map, b.train_idx_map)
    if a.test_idx_map is None or b.test_idx_map is None:
        assert a.test_idx_map is b.test_idx_map is None
    else:
        _same_map(a.test_idx_map, b.test_idx_map)
    assert a.class_num == b.class_num


def _labels(n=300, classes=7, seed=0):
    return np.random.RandomState(seed).randint(0, classes, size=n)


def _write_fix_map(path, labels, n_clients):
    """A frozen map in the reference's net_dataidx_map.txt format."""
    m = jpart.partition_data(labels, n_clients, "hetero", seed=9)
    with open(path, "w") as f:
        f.write("{\n")
        for c, idx in m.items():
            f.write(f"{c}: [\n" + ", ".join(str(int(i)) for i in idx)
                    + "]\n")
        f.write("}\n")
    return m


@pytest.mark.parametrize("method", ["homo", "hetero", "hetero-bal",
                                    "hetero-fix"])
def test_partition_data_bitwise(method, tmp_path):
    labels = _labels()
    kw = dict(method=method, alpha=0.5, seed=3)
    _same_map(tpart.partition_data(labels, 5, **kw),
              jpart.partition_data(labels, 5, **kw))
    if method == "hetero-fix":
        path = str(tmp_path / "map.txt")
        m = _write_fix_map(path, labels, 5)
        got = tpart.partition_data(labels, 5, fix_path=path, **kw)
        _same_map(got, jpart.partition_data(labels, 5, fix_path=path, **kw))
        _same_map(got, m)
        _same_map(tpart.read_net_dataidx_map(path),
                  jpart.read_net_dataidx_map(path))
    assert tpart.record_data_stats(labels, tpart.partition_data(
        labels, 5, **kw)) == jpart.record_data_stats(
        labels, jpart.partition_data(labels, 5, **kw))


@pytest.mark.parametrize("method", ["natural", "hetero"])
@pytest.mark.parametrize("as_uint8", [False, True])
def test_synthetic_images_bitwise(method, as_uint8):
    kw = dict(num_clients=5, image_shape=(6, 6, 1), num_classes=4,
              samples_per_client=12, test_samples=9, partition_method=method,
              seed=2, as_uint8=as_uint8)
    got = tsyn.synthetic_images(**kw)
    _same_data(got, jsyn.synthetic_images(**kw))
    assert got.train_x.dtype == (np.uint8 if as_uint8 else np.float32)


def test_synthetic_lr_bitwise():
    kw = dict(num_clients=4, dim=10, num_classes=3, seed=1)
    _same_data(tsyn.synthetic_lr(**kw), jsyn.synthetic_lr(**kw))


@pytest.mark.parametrize("name,kw", [
    ("femnist", dict(uint8_pixels=True)),
    ("mnist", {}),
    ("cifar10", dict(partition_method="hetero-bal", partition_alpha=0.3)),
    ("synthetic", {}),
])
def test_registry_classification_datasets_bitwise(name, kw):
    kw = dict(client_num=3, samples_per_client=12, test_samples=10, seed=4,
              **kw)
    _same_data(treg.load_dataset(name, **kw), jreg.load_dataset(name, **kw))


def test_registry_fix_path_bitwise(tmp_path):
    """The frozen-map route of an LDA image dataset and the post-condition
    that every route honors the map or refuses, against the reference's."""
    kw = dict(client_num=4, samples_per_client=12, test_samples=5, seed=6)
    path = str(tmp_path / "map.txt")
    _write_fix_map(path, treg.load_dataset("cifar10", **kw).train_y, 4)
    got = treg.load_dataset("cifar10", partition_fix_path=path, **kw)
    _same_data(got, jreg.load_dataset("cifar10", partition_fix_path=path,
                                      **kw))
    _same_map(got.train_idx_map, jpart.read_net_dataidx_map(path))
    # a natural partition cannot honor a frozen map: both refuse
    for reg in (treg, jreg):
        with pytest.raises(ValueError, match="did not honor"):
            reg.load_dataset("mnist", client_num=4, samples_per_client=12,
                             partition_method="natural",
                             partition_fix_path=path)


@pytest.mark.parametrize("name,kw,item", [
    ("synthetic_1_1", {}, "item 2"), ("stackoverflow_lr", {}, "item 2"),
    ("pascal_voc", {}, "item 9"), ("mnist", dict(data_dir="."), "item 2"),
    ("femnist", dict(image_size=32), "item 2"),
])
def test_unported_routes_name_their_roadmap_item(name, kw, item):
    with pytest.raises(NotImplementedError, match=item):
        treg.load_dataset(name, client_num=2, **kw)


@pytest.fixture(scope="module")
def images():
    kw = dict(num_clients=12, image_shape=(8, 8, 1), num_classes=5,
              samples_per_client=15, seed=0, as_uint8=True)
    return tsyn.synthetic_images(**kw), jsyn.synthetic_images(**kw)


@pytest.mark.parametrize("max_batches", [None, 2])
def test_native_and_numpy_packers_match_jax(images, max_batches):
    """Port of test_native_packer.py::test_native_matches_numpy_exactly:
    the port's C++ packer, its numpy loop and the JAX package's packer give
    the same bytes."""
    assert native.native_available()
    tdata, jdata = images
    ids = np.array([0, 3, 4, 9, 11])
    for r in (0, 5):
        kw = dict(max_batches=max_batches, seed=1, round_idx=r)
        before = native.CALLS["pack_clients"]
        a = tcd.pack_clients(tdata, ids, 4, use_native=True, **kw)
        assert native.CALLS["pack_clients"] == before + 1
        b = tcd.pack_clients(tdata, ids, 4, use_native=False, **kw)
        c = jcd.pack_clients(jdata, ids, 4, use_native=False, **kw)
        for f in ("x", "y", "mask", "num_samples"):
            _equal(getattr(a, f), getattr(c, f))
            _equal(getattr(b, f), getattr(c, f))


def test_native_library_is_built_in_the_port_build_dir():
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "fedml_tpu_torch"


@pytest.mark.parametrize("pad_to", [None, 6])
def test_pack_client_indices_bitwise(images, pad_to):
    tdata, jdata = images
    ids = np.array([1, 2, 7])
    a = tcd.pack_client_indices(tdata, ids, 4, max_batches=3, seed=2,
                                round_idx=3)
    b = jcd.pack_client_indices(jdata, ids, 4, max_batches=3, seed=2,
                                round_idx=3)
    if pad_to is not None:
        a, b = tcd.pad_index_batches(a, pad_to), jcd.pad_index_batches(b, pad_to)
        assert a.idx.shape[1] == pad_to
    for f in ("idx", "mask", "num_samples"):
        _equal(getattr(a, f), getattr(b, f))
    # the index plane names the rows the host packer copies
    cb = tcd.pack_clients(tdata, ids, 4, max_batches=3, seed=2, round_idx=3)
    rows = tdata.train_x[a.idx[:, :3]] * (a.mask[:, :3, :, None, None, None] > 0)
    _equal(rows, cb.x)


def test_subset_clients_bitwise(images):
    tdata, jdata = images
    a = tcd.subset_clients(tdata, [5, 2, 8])
    b = jcd.subset_clients(jdata, [5, 2, 8])
    _same_data(a, b)
    assert a.num_clients == 3 and a.train_data_local_num_dict == {
        c: len(v) for c, v in b.train_idx_map.items()}
    with pytest.raises(KeyError):
        tcd.pack_clients(a, np.array([0]), 4)
