"""Dataset registry, port of fedml_tpu/data/registry.py — the sequence
datasets and their synthetic stand-ins.

Reading the real files (fedml_tpu/data/files.py) and the image, tag and
tabular families are queued in ROADMAP.md (queue A, item 2).
"""

from __future__ import annotations

import dataclasses

from fedml_tpu_torch.core.client_data import FederatedData
from fedml_tpu_torch.data import synthetic as syn


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_clients: int          # canonical client count in the reference
    input_shape: tuple        # per-sample shape (images HWC; sequences (T,))
    num_classes: int
    task: str                 # 'classification' | 'sequence' | 'tags' | 'segmentation'
    partition: str            # 'natural' | 'lda'
    samples_per_client: int   # used by the synthetic fallback


# the reference's sequence datasets: fed_shakespeare 715 clients
# (benchmark/README.md:56), stackoverflow 342477 (:57)
DATASETS: dict[str, DatasetSpec] = {
    "shakespeare": DatasetSpec("shakespeare", 715, (80,), 90, "sequence", "natural", 50),
    "fed_shakespeare": DatasetSpec("fed_shakespeare", 715, (80,), 90, "sequence", "natural", 50),
    "stackoverflow_nwp": DatasetSpec("stackoverflow_nwp", 342477, (20,), 10004, "sequence", "natural", 30),
}


def load_dataset(
    name: str,
    data_dir: str | None = None,
    client_num: int | None = None,
    seed: int = 0,
    samples_per_client: int | None = None,
    test_samples: int | None = None,
) -> FederatedData:
    """The deterministic synthetic stand-in of a sequence dataset, with the
    reference's shapes, vocabulary and client count (``client_num``
    subsets it)."""
    spec = DATASETS.get(name)
    if spec is None:
        raise NotImplementedError(
            f"dataset {name!r} is not ported yet (ported: {sorted(DATASETS)})"
            ": ROADMAP.md queue A, item 2")
    if data_dir is not None:
        raise NotImplementedError("reading real dataset files is not ported "
                                  "yet: ROADMAP.md queue A, item 2")
    n_clients = client_num or spec.num_clients
    spc = samples_per_client or spec.samples_per_client
    ts = test_samples or min(2000, spc * n_clients // 10 + 100)
    return syn.synthetic_sequences(
        num_clients=n_clients,
        seq_len=spec.input_shape[0],
        vocab_size=spec.num_classes,
        samples_per_client=spc,
        test_samples=ts,
        seed=seed,
    )
