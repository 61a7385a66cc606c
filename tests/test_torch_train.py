"""The port's training module against the JAX package's (CPU).

The same split tree (numpy weights from a seed) and the same batches go
through `llama3np_tpu.train` and `llama3np_tpu_torch.train`: the
cacheless forward in float32 and bf16, the next-token loss and the
gradient of every leaf, three AdamW steps against optax.adamw, and
rematerialization (`torch.utils.checkpoint`) against the stored-activation
backward, for the full model and for LoRA.  float32: rtol 2e-4 / atol
1e-4; bf16: tests/test_dtype.py's envelope, 0.15 x max(1, max |logits|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights
from llama3np_tpu import train as jtrain
from llama3np_tpu.checkpoint import build_param_tree as jbuild
from llama3np_tpu.models.llama import StaticConfig as JConfig
from llama3np_tpu.ops.core import rope_tables as jrope
from llama3np_tpu_torch import lora as tlora
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch import train as ttrain
from llama3np_tpu_torch.checkpoint import params_to_device
from llama3np_tpu_torch.models.llama import StaticConfig as TConfig
from llama3np_tpu_torch.ops.core import rope_tables as trope

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4


def setup_for(name, dtype="float32", seed=0):
    args = jpreset(name, dtype=dtype)
    jp = jbuild(synthetic_weights(args, seed=seed), args)
    jcfg = JConfig.from_args(args)
    tcfg = TConfig.from_args(tpreset(name, dtype=dtype), "cpu")._replace(
        rope_split=False, fused=False)
    jc, js = jrope(args.head_dim, args.max_seq_len, args.rope_theta)
    tc, ts = trope(args.head_dim, args.max_seq_len, args.rope_theta, device="cpu")
    batch = np.random.default_rng(11).integers(3, args.vocab_size,
                                               size=(2, 21)).astype(np.int32)
    return args, jp, jcfg, jc, js, tcfg, tc, ts, batch


@pytest.fixture(scope="module", params=["test-tiny", "test-tiny-mha"])
def f32(request):
    return setup_for(request.param)


def fresh(jp):
    """The port's copy of a JAX tree, on the CPU: new tensors each call (on
    the CPU `params_to_device` shares the numpy arrays, and a train step
    updates its tree in place)."""
    tree = params_to_device(jp, "cpu")
    return {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v.clone())
            for k, v in tree.items()}


def test_forward_train_fp32_matches_jax(f32):
    args, jp, jcfg, jc, js, tcfg, tc, ts, batch = f32
    want = np.asarray(jtrain.forward_train(jp, jnp.asarray(batch), jc, js, jcfg))
    got = ttrain.forward_train(fresh(jp), torch.from_numpy(batch), tc, ts, tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["test-tiny", "test-tiny-mha"])
def test_forward_train_bf16_matches_jax(name):
    args, jp, jcfg, jc, js, tcfg, tc, ts, batch = setup_for(name, "bfloat16")
    tp = fresh(jp)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    want = np.asarray(jtrain.forward_train(jp, jnp.asarray(batch), jc, js, jcfg), np.float32)
    got = ttrain.forward_train(tp, torch.from_numpy(batch), tc, ts, tcfg).float().numpy()
    assert np.abs(got - want).max() < 0.15 * max(1.0, np.abs(want).max())


def test_loss_and_every_gradient_match_jax(f32):
    args, jp, jcfg, jc, js, tcfg, tc, ts, batch = f32
    loss, grads = jax.value_and_grad(jtrain.next_token_loss)(jp, jnp.asarray(batch),
                                                             jc, js, jcfg)
    tp = fresh(jp)
    ttrain.init_optimizer(tp)  # every leaf requires grad
    got = ttrain.next_token_loss(tp, torch.from_numpy(batch), tc, ts, tcfg)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=RTOL, atol=ATOL)
    flat = {**{k: v for k, v in grads.items() if k != "layers"}, **grads["layers"]}
    tflat = {**{k: v for k, v in tp.items() if k != "layers"}, **tp["layers"]}
    assert sorted(flat) == sorted(tflat)
    for k, g in flat.items():
        np.testing.assert_allclose(tflat[k].grad.numpy(), np.asarray(g), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("remat", [False, True])
def test_three_steps_match_optax_adamw(f32, remat):
    args, jp, jcfg, jc, js, tcfg, tc, ts, batch = f32
    jparams = jax.tree.map(jnp.array, jp)
    opt, st = jtrain.init_optimizer(jparams, learning_rate=1e-3)
    step = jtrain.make_train_step(opt, jcfg, remat=remat)
    tp = fresh(jp)
    topt, tst = ttrain.init_optimizer(tp, learning_rate=1e-3)
    tstep = ttrain.make_train_step(topt, tcfg, remat=remat)
    rng = np.random.default_rng(4)
    for _ in range(3):
        b = rng.integers(3, args.vocab_size, size=(2, 13)).astype(np.int32)
        jparams, st, loss = step(jparams, st, jnp.asarray(b), jc, js)
        tp, tst, tloss = tstep(tp, tst, torch.from_numpy(b), tc, ts)
        np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL, atol=ATOL)
    for k, v in jparams["layers"].items():
        np.testing.assert_allclose(tp["layers"][k].detach().numpy(), np.asarray(v),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("tok_embedding", "norm", "lm_head"):
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_optimizer_has_optax_defaults():
    t = torch.zeros(3)
    opt, st = ttrain.init_optimizer({"w": t}, learning_rate=5e-4)
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (5e-4, (0.9, 0.999),
                                                                 1e-8, 1e-4)
    assert t.requires_grad and st is opt.state


def test_remat_matches_stored_activations(f32):
    """Rematerialization changes memory only: the loss and every gradient
    equal the stored-activation backward's (tests/test_train.py's rule)."""
    args, jp, jcfg, jc, js, tcfg, tc, ts, batch = f32
    out = []
    for remat in (False, True):
        tp = fresh(jp)
        ttrain.init_optimizer(tp)
        loss = ttrain.next_token_loss(tp, torch.from_numpy(batch), tc, ts, tcfg, remat)
        loss.backward()
        out.append((float(loss.detach()), ttrain.tree_leaves(tp)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(b.grad, a.grad, rtol=1e-5, atol=1e-6)


def test_lora_remat_matches(f32):
    args, jp, jcfg, jc, js, tcfg, tc, ts, batch = f32
    tp = fresh(jp)
    grads, losses = [], []
    for remat in (False, True):
        lora = tlora.init_lora(args, rank=4, seed=2, device="cpu")
        ly = {k: (v + 0.03).requires_grad_(True) for k, v in lora["layers"].items()}
        loss = tlora.lora_loss(ly, tp, torch.from_numpy(batch), tc, ts, tcfg, 2.0, remat)
        loss.backward()
        losses.append(float(loss.detach()))
        grads.append(ttrain.tree_leaves({k: v.grad for k, v in ly.items()}))
    assert losses[0] == pytest.approx(losses[1], rel=1e-6)
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_frozen_16bit_base_keeps_no_f32_copy():
    """A LoRA step over a bf16 base: the base products go through the
    frozen-weight product, whose backward widens the weight again, and
    their numbers are `_dot`'s: the gradient of x equals the one through
    an f32 copy of the weight."""
    from llama3np_tpu_torch.ops.core import _dot
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(32, 24, generator=g) * 0.1).to(torch.bfloat16)
    x1 = torch.randn(3, 5, 32, generator=g).to(torch.bfloat16).requires_grad_(True)
    x2 = x1.detach().clone().requires_grad_(True)
    y1 = _dot(x1, w)                                  # frozen-base path
    y2 = torch.matmul(x2.float(), w.float().requires_grad_(False))
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    gy = torch.randn(3, 5, 24, generator=g)
    y1.backward(gy)
    y2.backward(gy)
    torch.testing.assert_close(x1.grad, x2.grad, rtol=0, atol=0)
    assert y1.grad_fn.__class__.__name__ == "_FrozenDotBackward"
