"""The port's GPT (horovod_tpu_torch.models) held against the flax model
of horovod_tpu on the same weights.

The flax parameters go through ``params_from_jax`` into the port; tokens
come from numpy.  fp32 compute on both sides; tolerances as the JAX
package's own model tests: logits and loss 2e-4, parameter gradients
5e-4.  The port's flash path runs its plain versions on the CPU, the JAX
flash path its Pallas kernels in the interpreter.  RoPE and remat are held
to the same bounds against flax's ``pos_embedding="rope"`` and
``nn.remat`` (dots-saveable policy); the port's remat gradients equal its
own non-remat ones bit for bit (the recompute runs the same ops on the same
inputs).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.ops import rope as jax_rope
from horovod_tpu_torch.models import GPT_CONFIGS, gpt, params_from_jax
from horovod_tpu_torch.ops import rope
from horovod_tpu_torch.train import lm_loss

LOGITS_TOL = 2e-4
GRAD_TOL = 5e-4


def _pair(impl, seq=32, **overrides):
    """(flax model, its params as numpy, port model on those params)."""
    kw = dict(attention_impl=impl, flash_block_q=16, flash_block_k=16,
              **overrides)
    jm = jax_gpt("nano", dtype=jnp.float32, **kw)
    toks = jnp.zeros((2, seq), jnp.int32)
    jparams = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), toks))
    tm = gpt("nano", device="cpu", dtype=torch.float32, **kw)
    tm.load_state_dict(params_from_jax(jparams), strict=True)
    return jm, jparams, tm


def _tokens(seq=32, seed=1):
    return np.random.RandomState(seed).randint(0, 1024, (2, seq + 1))


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_logits_loss_and_grads_match_flax(impl):
    _check_against_flax(impl)


@pytest.mark.parametrize("impl,overrides", [
    ("flash", {"pos_embedding": "rope"}),
    ("reference", {"pos_embedding": "rope"}),
    ("flash", {"remat": True}),
    ("reference", {"remat": True}),
    ("flash", {"pos_embedding": "rope", "remat": True,
               "num_kv_heads": 2}),
])
def test_rope_and_remat_match_flax(impl, overrides):
    _check_against_flax(impl, **overrides)


def _check_against_flax(impl, **overrides):
    """Logits, loss and every parameter gradient of the port against flax
    on the same weights and tokens."""
    jm, jparams, tm = _pair(impl, **overrides)
    toks = _tokens()

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(toks[:, :-1]))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(toks[:, 1:])).mean(), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    ttoks = torch.from_numpy(toks)
    tlogits = tm(ttoks[:, :-1])
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)
    tl = lm_loss(tm, ttoks)
    np.testing.assert_allclose(tl.item(), float(jl), atol=LOGITS_TOL,
                               rtol=LOGITS_TOL)
    tl.backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("overrides", [
    {"num_kv_heads": 2},
    {"num_kv_heads": 1, "attention_window": 8},
])
def test_gqa_and_window_logits_match_flax(overrides):
    jm, jparams, tm = _pair("flash", **overrides)
    toks = _tokens(seed=2)[:, :-1]
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, jparams),
                    jnp.asarray(toks))
    got = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_state_dict_names_mirror_the_flax_tree():
    _, jparams, tm = _pair("reference")
    names = set(tm.state_dict())
    assert names == set(params_from_jax(jparams))
    assert {"wte.weight", "wpe", "lnf.weight", "head.weight",
            "block0.qkv.weight", "block2.fc2.bias"} <= names
    # Dense kernels [in, out] land transposed as Linear weights [out, in]
    k = jparams["params"]["block0"]["fc1"]["kernel"]
    np.testing.assert_array_equal(
        tm.state_dict()["block0.fc1.weight"].numpy(), k.T)


def test_named_sizes_match_the_reference():
    from horovod_tpu.models.transformer import GPT_CONFIGS as JAX_CONFIGS

    for name, cfg in GPT_CONFIGS.items():
        ref = JAX_CONFIGS[name]
        for field in ("vocab_size", "num_layers", "num_heads", "emb_dim",
                      "mlp_ratio", "max_len", "flash_block_q",
                      "flash_block_k"):
            assert getattr(cfg, field) == getattr(ref, field), (name, field)
        assert cfg.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16


@pytest.mark.parametrize("overrides,item", [
    ({"attention_impl": "ring"}, "requires sp_axis"),
    ({"moe_experts": 4}, "dense blocks only"),
])
def test_unported_options_raise(overrides, item):
    """The A11 options build (sequence parallelism and MoE are ported;
    ``test_torch_ring_attention.py`` and ``test_torch_moe.py`` hold them
    against the reference); what they still refuse raises: a sequence
    schedule without its axis, and an MoE model's KV-cache decode (dense
    blocks only, as in the reference)."""
    from horovod_tpu_torch.models import decode

    tm = gpt("nano", device="cpu", dtype=torch.float32, **overrides)
    with pytest.raises(ValueError, match=item):
        if tm.cfg.moe_experts:
            decode.init_cache(tm, 1, 16)
        else:
            tm(torch.zeros((1, 16), dtype=torch.long))


def test_reference_impl_rejects_window():
    tm = gpt("nano", device="cpu", dtype=torch.float32,
             attention_impl="reference", attention_window=8)
    with pytest.raises(ValueError, match="flash-only"):
        tm(torch.zeros((1, 16), dtype=torch.long))


def test_init_is_seeded():
    a = gpt("nano", device="cpu", generator=torch.Generator().manual_seed(3))
    b = gpt("nano", device="cpu", generator=torch.Generator().manual_seed(3))
    for (n, x), (_, y) in zip(a.state_dict().items(),
                              b.state_dict().items()):
        assert torch.equal(x, y), n
    assert abs(a.wte.weight.std().item() - 128 ** -0.5) < 0.01


@pytest.mark.parametrize("impl", ["flash", "reference"])
def test_remat_grads_equal_the_plain_backward(impl):
    """The same weights with and without remat: logits and gradients bit
    for bit (CPU), so the checkpointed blocks recompute what they drop."""
    kw = dict(device="cpu", dtype=torch.float32, attention_impl=impl,
              flash_block_q=16, flash_block_k=16, pos_embedding="rope")
    plain = gpt("nano", **kw)
    remat = gpt("nano", remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    toks = torch.from_numpy(_tokens(seed=3))
    grads = []
    for m in (plain, remat):
        lm_loss(m, toks).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name, g in grads[0].items():
        assert torch.equal(g, grads[1][name]), name


def test_rope_state_dict_has_no_wpe():
    """flax creates no ``wpe`` under RoPE; the port's names follow, and the
    converter takes that tree."""
    _, jparams, tm = _pair("reference", pos_embedding="rope")
    assert "wpe" not in jparams["params"]
    assert set(tm.state_dict()) == set(params_from_jax(jparams))
    assert not any(n.startswith("wpe") for n in tm.state_dict())


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rope_matches_jax(dtype):
    """Tables and rotation against ``horovod_tpu.ops.rope`` (fp32 angles;
    bf16 inputs come back in bf16, within one bf16 rounding)."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 12, 3, 8).astype(np.float32)
    pos = np.arange(5, 17)
    want_cos, want_sin = jax_rope.rope_tables(jnp.asarray(pos), 8)
    cos, sin = rope.rope_tables(torch.from_numpy(pos), 8)
    np.testing.assert_allclose(cos.numpy(), np.asarray(want_cos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(want_sin), atol=1e-6)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = jax_rope.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos))
    got = rope.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=1e-5 if tdt == torch.float32 else 2e-2)
    with pytest.raises(ValueError, match="even head_dim"):
        rope.rope_tables(torch.from_numpy(pos), 7)
