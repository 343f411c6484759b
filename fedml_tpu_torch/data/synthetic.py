"""Synthetic federated data, port of fedml_tpu/data/synthetic.py — the
Markov-chain token sequences of the long-context slice. The other
generators are queued in ROADMAP.md (queue A, item 2).

The generator is bitwise equal to the reference (same numpy RandomState
stream, same per-token loop), held by tests/test_torch_host_plane.py.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core.client_data import FederatedData


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
