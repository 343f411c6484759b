"""Dataset registry, port of fedml_tpu/data/registry.py — the load_data
dispatch over the reference's dataset families, with the same canonical
client counts, input shapes and class counts.

Ported routes (each bitwise equal to the reference's synthetic stand-in,
held by tests/test_torch_data_plane.py): image classification
(``synthetic_images``, with ``partition_method`` / ``partition_alpha`` and
``uint8_pixels``), ``"synthetic"`` (``synthetic_lr``) and the sequence
datasets. Still to port, each raising with its ROADMAP.md item: reading the
real files (``data_dir``, ``image_size``, fedml_tpu/data/files.py, with the
reference's float-to-uint8 requantization of what they read), the
draw-order-exact ``synthetic_<a>_<b>`` variants, tags and segmentation.
The reference's tabular fallback is not carried: no dataset name reaches it.
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

from fedml_tpu_torch.core.client_data import FederatedData
from fedml_tpu_torch.core.partition import read_net_dataidx_map
from fedml_tpu_torch.data import synthetic as syn

log = logging.getLogger("fedml_tpu_torch.data")


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_clients: int          # canonical client count in the reference
    input_shape: tuple        # per-sample shape (images HWC; sequences (T,))
    num_classes: int
    task: str                 # 'classification' | 'sequence' | 'tags' | 'segmentation'
    partition: str            # 'natural' | 'lda'
    samples_per_client: int   # used by the synthetic fallback


# canonical client counts: MNIST 1000 (benchmark/README.md:12), FEMNIST 3400
# (:54), fed_cifar100 500 (:55), fed_shakespeare 715 (:56), stackoverflow
# 342477 (:57); cross-silo datasets use --client_num_in_total (default 10).
DATASETS: dict[str, DatasetSpec] = {
    "mnist": DatasetSpec("mnist", 1000, (28, 28, 1), 10, "classification", "natural", 60),
    "femnist": DatasetSpec("femnist", 3400, (28, 28, 1), 62, "classification", "natural", 110),
    "fed_cifar100": DatasetSpec("fed_cifar100", 500, (32, 32, 3), 100, "classification", "natural", 100),
    "shakespeare": DatasetSpec("shakespeare", 715, (80,), 90, "sequence", "natural", 50),
    "fed_shakespeare": DatasetSpec("fed_shakespeare", 715, (80,), 90, "sequence", "natural", 50),
    "stackoverflow_nwp": DatasetSpec("stackoverflow_nwp", 342477, (20,), 10004, "sequence", "natural", 30),
    "stackoverflow_lr": DatasetSpec("stackoverflow_lr", 342477, (10004,), 500, "tags", "natural", 30),
    "cifar10": DatasetSpec("cifar10", 10, (32, 32, 3), 10, "classification", "lda", 5000),
    "cifar100": DatasetSpec("cifar100", 10, (32, 32, 3), 100, "classification", "lda", 5000),
    "cinic10": DatasetSpec("cinic10", 10, (32, 32, 3), 10, "classification", "lda", 9000),
    "svhn": DatasetSpec("svhn", 10, (32, 32, 3), 10, "classification", "lda", 7000),
    "imagenet": DatasetSpec("imagenet", 100, (224, 224, 3), 1000, "classification", "natural", 100),
    "gld23k": DatasetSpec("gld23k", 233, (224, 224, 3), 203, "classification", "natural", 100),
    "gld160k": DatasetSpec("gld160k", 1262, (224, 224, 3), 2028, "classification", "natural", 130),
    "synthetic": DatasetSpec("synthetic", 30, (60,), 10, "classification", "natural", 200),
    "synthetic_0_0": DatasetSpec("synthetic_0_0", 30, (60,), 10, "classification", "natural", 200),
    "synthetic_0.5_0.5": DatasetSpec("synthetic_0.5_0.5", 30, (60,), 10, "classification", "natural", 200),
    "synthetic_1_1": DatasetSpec("synthetic_1_1", 30, (60,), 10, "classification", "natural", 200),
    "pascal_voc": DatasetSpec("pascal_voc", 4, (513, 513, 3), 21, "segmentation", "lda", 200),
    "coco": DatasetSpec("coco", 8, (513, 513, 3), 21, "segmentation", "lda", 300),
}


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md queue A, item {item}")


def load_dataset(
    name: str,
    data_dir: str | None = None,
    client_num: int | None = None,
    partition_method: str | None = None,
    partition_alpha: float = 0.5,
    seed: int = 0,
    samples_per_client: int | None = None,
    test_samples: int | None = None,
    uint8_pixels: bool = False,
    partition_fix_path: str | None = None,
    image_size: int | None = None,
) -> FederatedData:
    """Synthesize a federated dataset by reference name (the reference's
    stand-in when no files are given): ``client_num`` overrides the
    canonical client count; ``uint8_pixels`` ships image pixels as uint8,
    normalized to f32/255 on the device by the image tasks (4x fewer
    host->device bytes)."""
    spec = DATASETS.get(name)
    if spec is None:
        raise ValueError(f"unknown dataset {name}; known: {sorted(DATASETS)}")
    if data_dir is not None or image_size is not None:
        raise _unported("reading real dataset files (data_dir, image_size)",
                        "2")
    if name.startswith("synthetic_"):
        raise _unported(f"the draw-order-exact LEAF dataset {name!r}", "2")
    if spec.task in ("tags", "segmentation"):
        raise _unported(f"{spec.task} datasets ({name!r})",
                        "2" if spec.task == "tags" else "9")
    if not name.startswith("synthetic"):
        # no files for a real dataset: the stand-in is by design, but it
        # must never be mistaken for the real thing
        log.warning("dataset %r: no data_dir given — generating the "
                    "synthetic shape-identical stand-in", name)
    n_clients = client_num or spec.num_clients
    if partition_fix_path is not None and partition_method is None:
        partition_method = "hetero-fix"  # a frozen map implies the method
    fd = _synthesize(spec, n_clients, partition_method, partition_alpha,
                     seed, samples_per_client, test_samples, uint8_pixels,
                     partition_fix_path)
    if partition_fix_path is not None:
        # the returned partition IS the frozen map, or this fails loudly
        m = read_net_dataidx_map(partition_fix_path)
        ok = set(fd.train_idx_map) == set(m) and all(
            np.array_equal(np.asarray(fd.train_idx_map[k]), m[k]) for k in m)
        if not ok:
            raise ValueError(
                f"dataset {name!r} (partition_method={partition_method!r}) "
                f"did not honor partition_fix_path={partition_fix_path!r}; "
                "frozen maps apply to LDA-partitioned classification "
                "datasets with method 'hetero-fix'")
    return fd


def _synthesize(spec, n_clients, partition_method, partition_alpha, seed,
                samples_per_client, test_samples, uint8_pixels,
                partition_fix_path) -> FederatedData:
    """The reference's ``_load_dataset_impl`` synthetic routes."""
    if spec.name == "synthetic":
        return syn.synthetic_lr(num_clients=n_clients, seed=seed)
    spc = samples_per_client or spec.samples_per_client
    ts = test_samples or min(2000, spc * n_clients // 10 + 100)
    if spec.task == "classification" and len(spec.input_shape) >= 2:
        pm = partition_method or ("hetero" if spec.partition == "lda"
                                  else "natural")
        return syn.synthetic_images(
            num_clients=n_clients, image_shape=spec.input_shape,
            num_classes=spec.num_classes, samples_per_client=spc,
            test_samples=ts, partition_method=pm,
            partition_alpha=partition_alpha, seed=seed, as_uint8=uint8_pixels,
            partition_fix_path=partition_fix_path)
    if spec.task == "sequence":
        return syn.synthetic_sequences(
            num_clients=n_clients, seq_len=spec.input_shape[0],
            vocab_size=spec.num_classes, samples_per_client=spc,
            test_samples=ts, seed=seed)
    raise AssertionError(f"no synthetic route for {spec}")
