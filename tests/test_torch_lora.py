"""The port's LoRA module against the JAX package's (CPU).

The same weights (numpy, from a seed) and the same adapter trees (JAX's,
carried across with `lora_from_jax`) go through `llama3np_tpu.lora` and
`llama3np_tpu_torch.lora`: the adapted training forward, the loss and its
gradients, three AdamW steps against optax's adamw, merging, the adapter
files of both packages, the serving bank with the split-halves RoPE
layout, and the refusals.  float32 throughout: rtol 2e-4 / atol 1e-4
unless a test states another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama3np_tpu import lora as jlora
from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights
from llama3np_tpu import train as jtrain
from llama3np_tpu.checkpoint import build_param_tree as jbuild
from llama3np_tpu.models.llama import StaticConfig as JConfig
from llama3np_tpu.ops.core import rope_tables as jrope
from llama3np_tpu_torch import lora as tlora
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch import prng
from llama3np_tpu_torch import train as ttrain
from llama3np_tpu_torch.checkpoint import params_to_device
from llama3np_tpu_torch.models.llama import StaticConfig as TConfig
from llama3np_tpu_torch.ops.core import rope_tables as trope

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-4
TARGET_SETS = [jlora.DEFAULT_TARGETS, ("w_gate", "w_up", "w_down"), ("wq", "w_down")]


class Side:
    """One preset on both sides: the JAX split tree, config and RoPE
    tables, and the port's copies of them on the CPU (the training layout:
    interleaved RoPE, split weights, as `StaticConfig.from_args` gives the
    JAX training tests)."""

    def __init__(self, name, seed=0):
        self.args = jpreset(name)
        self.jp = jbuild(synthetic_weights(self.args, seed=seed), self.args)
        self.jcfg = JConfig.from_args(self.args)
        self.jcos, self.jsin = jrope(self.args.head_dim, self.args.max_seq_len,
                                     self.args.rope_theta)
        self.tp = params_to_device(self.jp, "cpu")
        self.tcfg = TConfig.from_args(tpreset(name), "cpu")._replace(
            rope_split=False, fused=False)
        self.tcos, self.tsin = trope(self.args.head_dim, self.args.max_seq_len,
                                     self.args.rope_theta, device="cpu")
        rng = np.random.default_rng(3)
        self.batch = rng.integers(3, self.args.vocab_size, size=(2, 17)).astype(np.int32)


@pytest.fixture(scope="module", params=["test-tiny", "test-tiny-mha"])
def side(request):
    return Side(request.param)


@pytest.fixture(scope="module")
def tiny():
    return Side("test-tiny")


def randomize_b(lora, seed=7, scale=0.05):
    """JAX adapters with every factor redrawn non-zero (tests/test_lora.py's
    `_randomize_b`): a fresh B = 0 would hide the low-rank path."""
    key = jax.random.PRNGKey(seed)
    ly = dict(lora["layers"])
    for name, leaf in ly.items():
        key, sub = jax.random.split(key)
        ly[name] = jax.random.normal(sub, leaf.shape, leaf.dtype) * scale
    return {**lora, "layers": ly}


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("shape", [(1000,), (7, 33, 5)])
def test_normal_replays_jax(seed, shape):
    """`prng.normal` is jax.random.normal within a few ulps: XLA's erf_inv
    polynomial is replayed, its log1p input comes from torch."""
    got = prng.normal(prng.prng_key(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isfinite(got).all()


def test_erfinv_edges():
    x = torch.tensor([-1.0, -0.5, 0.0, 0.5, 1.0])
    got = prng.erfinv(x).numpy()
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[1:-1], want[1:-1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("targets", TARGET_SETS + [("wk", "wo", "w_up")])
@pytest.mark.parametrize("seed", [0, 3])
def test_init_lora_matches_jax(side, targets, seed):
    j = jlora.init_lora(side.args, rank=4, alpha=8.0, targets=targets, seed=seed)
    t = tlora.init_lora(side.args, rank=4, alpha=8.0, targets=targets, seed=seed,
                        device="cpu")
    assert (t["rank"], t["alpha"], t["targets"]) == (j["rank"], j["alpha"], j["targets"])
    assert sorted(t["layers"]) == sorted(j["layers"])
    for k, v in j["layers"].items():
        assert t["layers"][k].dtype == torch.float32
        np.testing.assert_allclose(t["layers"][k].numpy(), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_init_is_identity(tiny):
    t = tlora.init_lora(tiny.args, rank=4, device="cpu")
    batch = torch.from_numpy(tiny.batch)
    base = ttrain.forward_train(tiny.tp, batch, tiny.tcos, tiny.tsin, tiny.tcfg)
    adapted = tlora.forward_train_lora(tiny.tp, t["layers"], batch, tiny.tcos,
                                       tiny.tsin, tiny.tcfg, t["alpha"] / t["rank"])
    torch.testing.assert_close(adapted, base, rtol=0, atol=0)


@pytest.mark.parametrize("targets", TARGET_SETS)
def test_forward_train_lora_matches_jax(side, targets):
    j = randomize_b(jlora.init_lora(side.args, rank=4, alpha=8.0, targets=targets))
    t = tlora.lora_from_jax(j, "cpu")
    scale = j["alpha"] / j["rank"]
    want = np.asarray(jlora.forward_train_lora(side.jp, j["layers"], jnp.asarray(side.batch),
                                               side.jcos, side.jsin, side.jcfg, scale))
    got = tlora.forward_train_lora(side.tp, t["layers"], torch.from_numpy(side.batch),
                                   side.tcos, side.tsin, side.tcfg, scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("targets", TARGET_SETS)
def test_lora_loss_and_grads_match_jax(side, targets):
    j = randomize_b(jlora.init_lora(side.args, rank=4, alpha=8.0, targets=targets))
    scale = j["alpha"] / j["rank"]
    loss, grads = jax.value_and_grad(jlora.lora_loss)(
        j["layers"], side.jp, jnp.asarray(side.batch), side.jcos, side.jsin,
        side.jcfg, scale)
    t = tlora.lora_from_jax(j, "cpu")
    for v in t["layers"].values():
        v.requires_grad_(True)
    got = tlora.lora_loss(t["layers"], side.tp, torch.from_numpy(side.batch),
                          side.tcos, side.tsin, side.tcfg, scale)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=RTOL, atol=ATOL)
    for k, g in grads.items():
        np.testing.assert_allclose(t["layers"][k].grad.numpy(), np.asarray(g),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    # The base takes no gradient.
    assert all(not v.requires_grad for v in side.tp["layers"].values())


def test_train_steps_match_optax_and_freeze_base(tiny):
    """Three AdamW steps (lr 1e-2) of the port against optax.adamw: the
    losses and the trained adapters; the base is bit-unchanged."""
    j = jlora.init_lora(tiny.args, rank=4, seed=1)
    scale = j["alpha"] / j["rank"]
    opt, st = jtrain.init_optimizer(j["layers"], learning_rate=1e-2)
    step = jlora.make_lora_train_step(opt, tiny.jcfg, scale)
    t = tlora.lora_from_jax(j, "cpu")
    topt, tst = ttrain.init_optimizer(t["layers"], learning_rate=1e-2)
    tstep = tlora.make_lora_train_step(topt, tiny.tcfg, scale)
    before = {k: v.clone() for k, v in tiny.tp["layers"].items()}
    ly, tly = j["layers"], t["layers"]
    jb, tb = jnp.asarray(tiny.batch), torch.from_numpy(tiny.batch)
    for _ in range(3):
        ly, st, loss = step(ly, st, tiny.jp, jb, tiny.jcos, tiny.jsin)
        tly, tst, tloss = tstep(tly, tst, tiny.tp, tb, tiny.tcos, tiny.tsin)
        np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL, atol=ATOL)
    for k, v in ly.items():
        np.testing.assert_allclose(tly[k].detach().numpy(), np.asarray(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert float(tly["wq_b"].detach().abs().max()) > 0  # B moved off zero
    for k, v in tiny.tp["layers"].items():
        assert torch.equal(v, before[k]), k
    assert len(tst) == len(tly)  # moments for the adapters only


def test_train_step_refuses_a_tree_it_does_not_hold(tiny):
    t = tlora.init_lora(tiny.args, rank=4, device="cpu")
    opt, st = ttrain.init_optimizer(t["layers"])
    other = tlora.init_lora(tiny.args, rank=4, device="cpu")["layers"]
    step = tlora.make_lora_train_step(opt, tiny.tcfg, 2.0)
    with pytest.raises(ValueError, match="optimizer holds"):
        step(other, st, tiny.tp, torch.from_numpy(tiny.batch), tiny.tcos, tiny.tsin)


@pytest.mark.parametrize("targets", TARGET_SETS)
def test_merge_lora_matches_jax(tiny, targets):
    j = randomize_b(jlora.init_lora(tiny.args, rank=4, alpha=8.0, targets=targets))
    t = tlora.lora_from_jax(j, "cpu")
    want = jlora.merge_lora(tiny.jp, j)
    before = {k: v.clone() for k, v in tiny.tp["layers"].items()}
    got = tlora.merge_lora(tiny.tp, t)
    for k, v in want["layers"].items():
        np.testing.assert_allclose(np.asarray(got["layers"][k]), np.asarray(v),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    # merge_lora leaves its input alone, and numpy leaves merge too.
    for k, v in tiny.tp["layers"].items():
        assert torch.equal(v, before[k]), k
    from_np = tlora.merge_lora(tiny.jp, t)
    for k in targets:
        torch.testing.assert_close(from_np["layers"][k], got["layers"][k])
    # The merged tree computes the adapted forward.
    scale = j["alpha"] / j["rank"]
    batch = torch.from_numpy(tiny.batch)
    merged = ttrain.forward_train(got, batch, tiny.tcos, tiny.tsin, tiny.tcfg)
    adapted = tlora.forward_train_lora(tiny.tp, t["layers"], batch, tiny.tcos,
                                       tiny.tsin, tiny.tcfg, scale)
    torch.testing.assert_close(merged, adapted, rtol=RTOL, atol=ATOL)


def test_merge_refuses_fused_layout(tiny):
    fused = {**tiny.tp, "layers": {**tiny.tp["layers"], "wqkv": torch.zeros(1)}}
    with pytest.raises(ValueError, match="split weight layout"):
        tlora.merge_lora(fused, tlora.init_lora(tiny.args, device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adapter_files_cross_packages(tmp_path, tiny, dtype):
    """save_lora/load_lora of either package read the other's file: the
    same keys, the same factors (bf16 as its 2-byte payload)."""
    j = randomize_b(jlora.init_lora(tiny.args, rank=4, alpha=8.0, targets=("wq", "w_down")))
    t = tlora.lora_from_jax(j, "cpu")
    if dtype == "bfloat16":
        t = {**t, "layers": {k: v.to(torch.bfloat16) for k, v in t["layers"].items()}}
    tpath, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tlora.save_lora(t, tpath)
    jlora.save_lora(j, jpath)
    assert sorted(np.load(tpath).files) == sorted(np.load(jpath).files)
    back = tlora.load_lora(jpath, device="cpu")
    assert (back["rank"], back["alpha"], back["targets"]) == (4, 8.0, ("wq", "w_down"))
    for k, v in j["layers"].items():
        np.testing.assert_array_equal(back["layers"][k].numpy(), np.asarray(v))
    mine = tlora.load_lora(tpath, device="cpu")
    for k, v in t["layers"].items():
        assert mine["layers"][k].dtype == v.dtype and torch.equal(mine["layers"][k], v)
    if dtype == "float32":
        jback = jlora.load_lora(tpath)
        assert jback["targets"] == j["targets"] and jback["rank"] == 4
        for k, v in j["layers"].items():
            np.testing.assert_array_equal(np.asarray(jback["layers"][k]), np.asarray(v))


@pytest.mark.parametrize("rope_split", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_adapters_and_bank_slice_match_jax(side, rope_split, dtype):
    """The bank of two adapters that adapt wq and wk (the factors the
    split-halves permutation moves): bank slot 0 zero, each slot the
    adapter, wq_b/wk_b permuted as JAX permutes them."""
    js = [randomize_b(jlora.init_lora(side.args, rank=4, alpha=8.0, seed=s,
                                      targets=("wq", "wk", "w_up")), seed=s + 9)
          for s in (1, 2)]
    jbank = jlora.stack_adapters(js, side.args, rope_split=rope_split, dtype=dtype)
    tbank = tlora.stack_adapters([tlora.lora_from_jax(a, "cpu") for a in js], side.args,
                                 rope_split=rope_split, dtype=dtype)
    assert tbank["scale"] == jbank["scale"] == 2.0
    for k, v in jbank["layers"].items():
        got = tbank["layers"][k]
        assert got.shape == v.shape and str(got.dtype).endswith(dtype)
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(v).astype(np.float32))
        assert not got[:, 0].any()
    for i in range(3):
        jsl, tsl = jlora.bank_adapter_slice(jbank, i), tlora.bank_adapter_slice(tbank, i)
        assert tsl["scale"] == jsl["scale"]
        for k, v in jsl["layers"].items():
            np.testing.assert_array_equal(tsl["layers"][k].float().numpy(),
                                          np.asarray(v).astype(np.float32))


def test_stack_adapters_refusals(tiny):
    a = tlora.init_lora(tiny.args, rank=4, device="cpu")
    b = tlora.init_lora(tiny.args, rank=2, alpha=4.0, device="cpu")
    with pytest.raises(ValueError, match="at least one adapter"):
        tlora.stack_adapters([], tiny.args)
    with pytest.raises(ValueError, match=r"adapter 1 has \(rank, alpha, targets\)"):
        tlora.stack_adapters([a, b], tiny.args)


def test_bad_targets_rejected(tiny):
    with pytest.raises(ValueError, match="unknown LoRA targets") as e:
        tlora.init_lora(tiny.args, targets=("wq", "nope"), device="cpu")
    with pytest.raises(ValueError) as je:
        jlora.init_lora(tiny.args, targets=("wq", "nope"))
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("targets", TARGET_SETS)
def test_lora_pspecs_match_jax(tiny, targets):
    j = jlora.init_lora(tiny.args, rank=4, targets=targets)
    t = tlora.init_lora(tiny.args, rank=4, targets=targets, device="cpu")
    assert tlora.lora_pspecs(t) == {k: tuple(v) for k, v in jlora.lora_pspecs(j).items()}


def test_sharded_lora_train_matches_single_device(tiny):
    """tests/test_lora.py's dp x tp = 2 x 2 LoRA train step: four ranks
    under gloo (`torch_parallel_workers.lora_train_ranks`), each with its
    shards of the base and of the adapters (`shard_lora`) and its dp row
    of the batch, reproduce the JAX single-device loss trajectory, and
    their trained shards are the single device's adapters' slices."""
    import torch_parallel_workers as W
    from llama3np_tpu_torch.parallel.launch import launch

    lora = jlora.init_lora(tiny.args, rank=4, seed=1)
    opt, st = jtrain.init_optimizer(lora["layers"], learning_rate=1e-2)
    step = jlora.make_lora_train_step(opt, tiny.jcfg, lora["alpha"] / lora["rank"])
    ly, ref_losses = lora["layers"], []
    for _ in range(3):
        ly, st, loss = step(ly, st, tiny.jp, jnp.asarray(tiny.batch), tiny.jcos, tiny.jsin)
        ref_losses.append(float(loss))
    ranks = launch(W.lora_train_ranks, 4,
                   (synthetic_weights(tiny.args, seed=0), tpreset("test-tiny"),
                    tiny.batch, 3, 1e-2),
                   backend="gloo", devices=["cpu"] * 4, timeout_s=300)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], ref_losses, rtol=2e-4, atol=2e-4)
        j = r["coords"]["tp"]
        wq_b, wo_a = np.asarray(ly["wq_b"]), np.asarray(ly["wo_a"])
        n, m = wq_b.shape[-1] // 2, wo_a.shape[1] // 2
        np.testing.assert_allclose(r["wq_b"], wq_b[..., j * n:(j + 1) * n],
                                   rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(r["wo_a"], wo_a[:, j * m:(j + 1) * m],
                                   rtol=2e-3, atol=2e-4)
        assert r["specs"] == {k: tuple(v) for k, v in jlora.lora_pspecs(lora).items()}


def test_init_lora_defaults_to_the_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlora.init_lora(tiny.args)
