"""Synthetic federated data, port of fedml_tpu/data/synthetic.py:

- ``synthetic_lr``: the LEAF synthetic(alpha, beta) logistic-regression
  benchmark (per-client softmax-linear models around a client-specific mean);
- ``synthetic_images``: class-conditional Gaussian images, the
  shape-identical stand-in for MNIST / FEMNIST / CIFAR;
- ``synthetic_sequences``: Markov-chain token sequences.

Each generator is bitwise equal to the reference (the same numpy
RandomState stream), held by tests/test_torch_host_plane.py and
tests/test_torch_data_plane.py. The draw-order-exact LEAF variants
(``synthetic_leaf_exact``) and ``synthetic_segmentation`` are queued in
ROADMAP.md (queue A, items 2 and 9).
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core.client_data import FederatedData
from fedml_tpu_torch.core.partition import partition_data


def synthetic_lr(
    num_clients: int = 30,
    alpha: float = 0.5,
    beta: float = 0.5,
    dim: int = 60,
    num_classes: int = 10,
    seed: int = 0,
) -> FederatedData:
    """LEAF synthetic(alpha,beta): y = argmax(softmax(W_k x + b_k))."""
    rng = np.random.RandomState(seed)
    sizes = np.clip(rng.lognormal(4, 2, num_clients).astype(int) + 50, 50, 10_000)
    B = rng.normal(0, beta, num_clients)
    xs, ys, idx_map, test_xs, test_ys, test_map = [], [], {}, [], [], {}
    tr_off = te_off = 0
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)])
    for k in range(num_clients):
        u = rng.normal(0, alpha)
        W = rng.normal(u, 1, (dim, num_classes))
        b = rng.normal(u, 1, num_classes)
        v = rng.normal(B[k], 1, dim)
        n = int(sizes[k])
        x = rng.multivariate_normal(v, np.diag(diag), n).astype(np.float32)
        logits = x @ W + b
        y = np.argmax(logits, axis=1).astype(np.int64)
        n_tr = max(1, int(0.9 * n))
        xs.append(x[:n_tr]); ys.append(y[:n_tr])
        test_xs.append(x[n_tr:]); test_ys.append(y[n_tr:])
        idx_map[k] = np.arange(tr_off, tr_off + n_tr)
        test_map[k] = np.arange(te_off, te_off + (n - n_tr))
        tr_off += n_tr; te_off += n - n_tr
    fd = FederatedData(
        train_x=np.concatenate(xs), train_y=np.concatenate(ys),
        test_x=np.concatenate(test_xs), test_y=np.concatenate(test_ys),
        train_idx_map=idx_map, test_idx_map=test_map, class_num=num_classes,
    )
    fd.synthetic_fallback = True  # dataset_source: generated, not read
    return fd


def synthetic_images(
    num_clients: int,
    image_shape: tuple[int, ...],
    num_classes: int,
    samples_per_client: int = 100,
    test_samples: int = 1000,
    partition_method: str = "natural",
    partition_alpha: float = 0.5,
    seed: int = 0,
    size_lognormal: bool = True,
    as_uint8: bool = False,
    partition_fix_path: str | None = None,
) -> FederatedData:
    """Class-conditional Gaussian images, shape-compatible stand-in for
    MNIST/FEMNIST/CIFAR when real files are absent. Each class c has a fixed
    random mean image m_c; samples are m_c + noise. 'natural' partitioning
    gives each client a skewed label distribution + lognormal size (LEAF-like);
    'homo'/'hetero' delegate to the standard partitioners."""
    rng = np.random.RandomState(seed)
    means = rng.normal(0, 1, (num_classes,) + image_shape).astype(np.float32)

    if size_lognormal:
        sizes = np.clip(
            rng.lognormal(np.log(samples_per_client), 0.5, num_clients).astype(int),
            max(10, samples_per_client // 5),
            samples_per_client * 5,
        )
    else:
        sizes = np.full(num_clients, samples_per_client)
    total = int(sizes.sum())

    if partition_method == "natural":
        # each client draws labels from its own dirichlet class mix
        ys = []
        for k in range(num_clients):
            mix = rng.dirichlet(np.repeat(partition_alpha, num_classes))
            ys.append(rng.choice(num_classes, sizes[k], p=mix))
        y = np.concatenate(ys).astype(np.int64)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        idx_map = {k: np.arange(offs[k], offs[k + 1]) for k in range(num_clients)}
    else:
        y = rng.choice(num_classes, total).astype(np.int64)
        idx_map = partition_data(y, num_clients, partition_method, partition_alpha,
                                 seed, fix_path=partition_fix_path)

    # noise from a shared pool: generating total*prod(shape) fresh gaussians
    # dominates wall-clock at 3400-client scale and adds nothing for learning
    pool = rng.normal(0, 1, (4096,) + image_shape).astype(np.float32)
    x = means[y] + 0.5 * pool[rng.randint(0, 4096, total)]
    ty = rng.choice(num_classes, test_samples).astype(np.int64)
    tx = means[ty] + 0.5 * pool[rng.randint(0, 4096, test_samples)]
    if as_uint8:
        # map the ~N(0,1.1) pixel field onto the uint8 grid; after the image
        # tasks' on-device /255 the model sees ~N(0.5, 0.125^2) — an affine
        # rescale of the float variant (standard [0,1] image normalization),
        # NOT the same raw scale, at 1/4 the host->device bytes. Real image
        # datasets are natively uint8, so this only affects the synthetic
        # stand-in; learning-rate-sensitive comparisons between the float
        # and uint8 synthetic variants are not scale-equivalent.
        q = lambda a: np.clip(a * 32.0 + 128.0, 0, 255).astype(np.uint8)
        x, tx = q(x), q(tx)
    fd = FederatedData(
        train_x=x if as_uint8 else x.astype(np.float32), train_y=y,
        test_x=tx if as_uint8 else tx.astype(np.float32), test_y=ty,
        train_idx_map=idx_map, test_idx_map=None, class_num=num_classes,
    )
    fd.synthetic_fallback = True
    return fd


def synthetic_sequences(
    num_clients: int,
    seq_len: int,
    vocab_size: int,
    samples_per_client: int = 50,
    test_samples: int = 500,
    seed: int = 0,
    pad_id: int = 0,
) -> FederatedData:
    """Markov-chain token sequences, stand-in for Shakespeare/StackOverflow.

    x[t] is the context token, y[t] = x[t+1] (next-token target). Each client
    has its own transition sharpness -> non-IID. Tokens are drawn from
    1..vocab_size-1, so no token is the pad id 0.
    """
    rng = np.random.RandomState(seed)
    base = rng.dirichlet(np.ones(vocab_size - 1) * 0.3, vocab_size)  # rows: next-token dist

    def gen(n, sharp):
        seqs = np.zeros((n, seq_len + 1), dtype=np.int64)
        for i in range(n):
            t = rng.randint(1, vocab_size)
            for j in range(seq_len + 1):
                seqs[i, j] = t
                p = base[t] ** sharp
                p = p / p.sum()
                t = 1 + rng.choice(vocab_size - 1, p=p)
        return seqs

    xs, idx_map = [], {}
    off = 0
    for k in range(num_clients):
        sharp = 0.5 + rng.rand() * 1.5
        s = gen(samples_per_client, sharp)
        xs.append(s)
        idx_map[k] = np.arange(off, off + samples_per_client)
        off += samples_per_client
    seqs = np.concatenate(xs)
    test = gen(test_samples, 1.0)
    fd = FederatedData(
        train_x=seqs[:, :-1], train_y=seqs[:, 1:],
        test_x=test[:, :-1], test_y=test[:, 1:],
        train_idx_map=idx_map, test_idx_map=None, class_num=vocab_size,
    )
    fd.synthetic_fallback = True
    return fd
