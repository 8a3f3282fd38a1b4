"""Port parity: ps_pytorch_tpu_torch.models (transformer, decode, convert)
and the flat weight geometry of parallel/buckets, against the JAX package.

JAX weights are made once with ``jax.random`` and carried across as numpy
arrays through ``params_from_jax`` (a copy: the port keeps the JAX tree's
names and ``[in, out]`` layouts). Depth 2, dim 32, vocab 29, f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_pytorch_tpu.models import decode as jdec
from ps_pytorch_tpu.models import transformer as jtr
from ps_pytorch_tpu.parallel import buckets as jb
from ps_pytorch_tpu_torch.models import convert
from ps_pytorch_tpu_torch.models import decode as tdec
from ps_pytorch_tpu_torch.models import transformer as ttr
from ps_pytorch_tpu_torch.parallel import buckets as tb

SHAPE = dict(vocab_size=29, dim=32, depth=2, heads=4, max_seq_len=64)
JCFG = jtr.TransformerConfig(**SHAPE)
TCFG = ttr.TransformerConfig(**SHAPE)


@pytest.fixture(scope="module")
def weights():
    jparams = jtr.init_transformer(JCFG, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jparams, np_params, convert.params_from_jax(np_params, device="cpu")


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(0, SHAPE["vocab_size"], shape).astype(np.int32)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_torch_apply_transformer_logits_match_jax(monkeypatch, weights, impl):
    monkeypatch.setenv("PS_TPU_PALLAS_INTERPRET", "1")  # JAX flash: its kernel
    jparams, _, tparams = weights
    jcfg = jtr.TransformerConfig(**SHAPE, attention_impl=impl)
    tcfg = ttr.TransformerConfig(**SHAPE, attention_impl=impl)
    tok = _tokens((2, 12), 1)
    want = np.asarray(jtr.apply_transformer(jcfg, jparams, jnp.asarray(tok)))
    got = ttr.apply_transformer(tcfg, tparams, torch.from_numpy(tok).long())
    assert got.shape == (2, 12, SHAPE["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_torch_transformer_lm_module_is_apply_transformer(weights):
    _, _, tparams = weights
    lm = ttr.TransformerLM(TCFG, params=tparams, device="cpu")
    tok = torch.from_numpy(_tokens((1, 9), 2)).long()
    assert torch.equal(lm(tok), ttr.apply_transformer(TCFG, tparams, tok))
    assert not any(p.requires_grad for p in lm.parameters())
    assert sum(p.numel() for p in lm.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(weights[1]))


def test_torch_prefill_and_decode_one_match_jax(weights):
    jparams, _, tparams = weights
    prompt = _tokens((2, 5), 3)
    jcache = jdec.prefill(JCFG, jparams, jnp.asarray(prompt),
                          jdec.init_kv_cache(JCFG, 2, 16))
    tcache = tdec.prefill(TCFG, tparams, torch.from_numpy(prompt).long(),
                          tdec.init_kv_cache(TCFG, 2, 16, device="cpu"))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   atol=1e-5, rtol=0)
    tok = _tokens((2,), 4)
    jlog, jcache = jdec._decode_one(JCFG, jparams, jcache, jnp.asarray(tok), 5)
    tlog, tcache = tdec._decode_one(TCFG, tparams, tcache,
                                    torch.from_numpy(tok).long(), 5)
    assert tlog.dtype == torch.float32 and tlog.shape == (2, SHAPE["vocab_size"])
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl,t_prompt", [("naive", 5), ("flash", 9), ("naive", 1)])
def test_torch_generate_tokens_identical_to_jax(weights, impl, t_prompt):
    jparams, _, tparams = weights
    tcfg = ttr.TransformerConfig(**SHAPE, attention_impl=impl)
    prompt = _tokens((2, t_prompt), 5)
    want = np.asarray(jdec.generate(JCFG, jparams, jnp.asarray(prompt),
                                    max_new_tokens=8, max_len=32))
    got = tdec.generate(tcfg, tparams, torch.from_numpy(prompt), 8,
                        max_len=32, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_generate_temperature_is_seeded(weights):
    _, _, tparams = weights
    prompt = torch.from_numpy(_tokens((3, 4), 6))
    runs = [
        tdec.generate(TCFG, tparams, prompt, 6, temperature=0.8,
                      generator=torch.Generator().manual_seed(s), device="cpu")
        for s in (2, 2)
    ]
    assert runs[0].shape == (3, 10)
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0][:, :4], prompt)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < SHAPE["vocab_size"]
    with pytest.raises(ValueError, match="Generator"):
        tdec.generate(TCFG, tparams, prompt, 2, temperature=0.5, device="cpu")
    with pytest.raises(ValueError, match=">"):
        tdec.generate(TCFG, tparams, torch.zeros((1, 30)), 8, max_len=32,
                      device="cpu")


def test_torch_flat_weight_vector_bit_exact_vs_jax(weights):
    jparams, np_params, tparams = weights
    jlayout = jb.tree_layout(jparams)
    jplan = jb.plan_buckets(jlayout.total, 0, align=1)
    want = jb._np_tree_to_flat(jlayout, jplan, np_params)
    tlayout = tb.tree_layout(tparams)
    tplan = tb.plan_buckets(tlayout.total, 0, align=1)
    got = tb._np_tree_to_flat(tlayout, tplan, tparams)
    assert tlayout.shapes == jlayout.shapes and tlayout.offsets == jlayout.offsets
    np.testing.assert_array_equal(got, want)
    # the tree view is views into the one flat tensor, value-identical
    fv = tb.FlatVector(flat=torch.from_numpy(got), layout=tlayout, plan=tplan)
    view = fv.tree()
    base = fv.flat.data_ptr()
    for leaf, ref in zip(tb.tree_leaves(view), tb.tree_leaves(tparams)):
        assert torch.equal(leaf, ref)
        assert base <= leaf.data_ptr() < base + fv.flat.numel() * 4


@pytest.mark.parametrize("bucket_bytes,align", [(0, 1), (64, 16), (1000, 7)])
def test_torch_plan_buckets_matches_jax(bucket_bytes, align):
    assert tb.plan_buckets(1234, bucket_bytes, align) == tb.BucketPlan(
        **jb.plan_buckets(1234, bucket_bytes, align).__dict__)


def test_torch_params_round_trip(weights):
    _, np_params, tparams = weights
    back = convert.params_to_numpy(tparams)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(np_params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)


def test_torch_init_transformer_shapes_and_scales():
    cfg = ttr.TransformerConfig(vocab_size=50, dim=64, depth=3, heads=4,
                                max_seq_len=40)
    p = ttr.init_transformer(cfg, torch.Generator().manual_seed(0), device="cpu")
    j = jax.eval_shape(lambda: jtr.init_transformer(
        jtr.TransformerConfig(vocab_size=50, dim=64, depth=3, heads=4,
                              max_seq_len=40), jax.random.key(0)))
    assert [tuple(x.shape) for x in tb.tree_leaves(p)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(j)]
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert abs(float(p["blocks"][0]["w_up"].std()) - 64 ** -0.5) < 0.01
    assert torch.equal(p["blocks"][2]["ln2"], torch.ones(64))
