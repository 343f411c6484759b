"""fedml_tpu_torch TransformerLM against the JAX package's on converted
weights: same logits (flash on and off), same parameter count, and a
bitwise weight round trip through fedml_tpu_torch.convert; and its
sequence-parallel forward (ring, flash ring, Ulysses) on a 1 x 4 mesh of
a gloo world (tests/test_torch_seq_ranks.transformer) against the unsharded
one, mirroring tests/test_transformer.py:20-43."""

import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_torch_seq_ranks as ranks
from fedml_tpu.models.transformer import TransformerLM as JaxTransformerLM
from fedml_tpu_torch import convert
from fedml_tpu_torch.mesh.world import spawn
from fedml_tpu_torch.models import TransformerLM, create_model

WIDTHS = dict(vocab_size=32, dim=32, depth=1, num_heads=2, max_len=64)
TOKENS = np.random.RandomState(0).randint(0, 32, size=(2, 48))


@functools.lru_cache(maxsize=None)
def _flax_params():
    # jitted and computed once: one compile instead of flax's op-by-op init
    model = JaxTransformerLM(**WIDTHS)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), TOKENS)["params"]
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("use_flash", [False, True])
def test_converted_weights_give_jax_logits(use_flash):
    """flash on: JAX's Pallas kernel (interpret mode) vs the port's
    autograd.Function on the CPU; off: both dense. f32 throughout; the
    tolerance covers LayerNorm/matmul summation order."""
    params = _flax_params()
    ref = jax.jit(JaxTransformerLM(**WIDTHS, use_flash=use_flash).apply)(
        {"params": params}, TOKENS)
    model = create_model("transformer_flash" if use_flash else "transformer",
                         device="cpu", **WIDTHS)
    model.load_state_dict(convert.from_flax(params))
    with torch.no_grad():
        out = model(torch.from_numpy(TOKENS))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_param_count_and_names_match_flax():
    params = _flax_params()
    n_flax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    model = TransformerLM(**WIDTHS)
    assert sum(p.numel() for p in model.parameters()) == n_flax
    sd = convert.from_flax(params)
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())


def test_convert_round_trip_is_bitwise():
    params = _flax_params()
    back = convert.to_flax(convert.from_flax(params), WIDTHS["num_heads"])
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_seeded_init_is_device_independent_and_flax_shaped():
    """reset_parameters draws on the CPU from the generator: one seed,
    one set of weights; the draws follow flax's initializer scales."""
    a, b = TransformerLM(**WIDTHS), TransformerLM(**WIDTHS)
    a.reset_parameters(torch.Generator().manual_seed(3))
    b.reset_parameters(torch.Generator().manual_seed(3))
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), name
    w = a.blocks[0].mlp_in.weight.detach()  # lecun-normal, truncated at 2 std
    std = WIDTHS["dim"] ** -0.5 / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert not a.blocks[0].mlp_in.bias.any()


# sequence-parallel attention (seq_axis, item 11) runs since it was
# ported: test_seq_parallel_forward_matches_the_unsharded_one below
@pytest.mark.parametrize("kwargs,item", [
    (dict(dtype=torch.bfloat16), "item 7"),
    (dict(moe_experts=2), "item 12"),
])
def test_unported_options_name_their_roadmap_item(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        dtype = kwargs.pop("dtype", None)
        model = TransformerLM(**WIDTHS, **kwargs)
        model.to(dtype)(torch.zeros(1, 4, dtype=torch.long))


@pytest.mark.parametrize("name", ["cnn_dropout", "resnet56", "darts"])
def test_create_model_names_the_queue_of_unported_models(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue"):
        create_model(name, device="cpu")


@pytest.fixture(scope="module")
def seq_blocks(tmp_path_factory):
    """(tokens, each rank's logits block by seq_impl) from one 4-rank
    world."""
    work = tmp_path_factory.mktemp("tf_world")
    toks = np.random.RandomState(1).randint(0, 50, size=(2, 32))
    np.save(work / "tokens.npy", toks)
    with ranks.one_world_at_a_time():
        out = spawn("test_torch_seq_ranks:transformer", 4, (str(work),),
                    deadline_s=120.0, sys_path=(str(Path(__file__).parent),),
                    workdir=str(work / "world"))
    return toks, out


@pytest.mark.parametrize("impl", list(ranks.TF_IMPLS))
def test_seq_parallel_forward_matches_the_unsharded_one(seq_blocks, impl):
    """The same weights (one seed) and tokens: the ranks' logits blocks
    concatenated along T equal the unsharded forward (pos_emb offset by
    each block's place; ring, flash ring and Ulysses)."""
    toks, out = seq_blocks
    ref = TransformerLM(**ranks.TF_WIDTHS,
                        use_flash=ranks.TF_IMPLS[impl].get("use_flash", False))
    ref.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = ref(torch.from_numpy(toks)).numpy()
    got = np.concatenate([o[impl] for o in out], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
