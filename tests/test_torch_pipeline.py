"""The port's pipeline parallelism (`llama3np_tpu_torch.parallel.pipeline`)
against the JAX package's: every tests/test_pipeline.py scenario (pp=4
greedy, a batch and a restart, the stage's weight bytes, int8 stage
shards, the divisibility refusal, the microbatched schedule at pp=4 and
pp=2 with its refusal and a single token, and the ("pp", "tp") mesh in
both schedules).

The port's stages are spawned ranks under gloo on the CPU, one world a
mesh shape, once for the module (`torch_parallel_workers.pipeline_ranks`).
Greedy streams equal the single-chip engine's and the JAX
`PipelinedLlama`'s, on every rank.
"""

import dataclasses

import numpy as np
import pytest

import jax

from llama3np_tpu import preset as jpreset
from llama3np_tpu import synthetic_weights
from llama3np_tpu.models.llama import Llama as JLlama
from llama3np_tpu.parallel.pipeline import (PipelinedLlama as JPipelined,
                                            make_pp_mesh as jpp_mesh,
                                            make_pp_tp_mesh as jpp_tp_mesh)
from llama3np_tpu_torch import preset as tpreset
from llama3np_tpu_torch.parallel.launch import launch

import torch_parallel_workers as W

PP = dict(n_layers=4, attn_impl="xla", fuse_matmuls=False)


@pytest.fixture(scope="module")
def setup():
    args = jpreset("test-tiny", **PP)
    w = synthetic_weights(args, seed=31)
    rng = np.random.default_rng(42)
    ids = {"b1": rng.integers(3, args.vocab_size, size=(1, 5)).astype(np.int32),
           "b2": rng.integers(3, args.vocab_size, size=(2, 4)).astype(np.int32),
           "b4": rng.integers(3, args.vocab_size, size=(4, 5)).astype(np.int32),
           "b4_short": rng.integers(3, args.vocab_size, size=(4, 4)).astype(np.int32),
           "b2_5": rng.integers(3, args.vocab_size, size=(2, 5)).astype(np.int32)}
    return args, w, ids


def _runs(ids):
    return {4: [("b1", ids["b1"], 8, False), ("b2*2", ids["b2"], 6, False),
                ("mb*2", ids["b4"], 7, True), ("mb_one", ids["b4_short"], 1, True)],
            2: [("mb_two", ids["b2"], 6, True)],
            (2, 2): [("pptp*2", ids["b2_5"], 6, False),
                     ("pptp_mb", ids["b2_5"], 6, True)]}


@pytest.fixture(scope="module")
def ranks(setup):
    args, w, ids = setup
    targs = tpreset("test-tiny", **PP, max_batch_size=4)
    runs = _runs(ids)
    a3 = tpreset("test-tiny", **{**PP, "n_layers": 3})
    w3 = synthetic_weights(jpreset("test-tiny", **{**PP, "n_layers": 3}), seed=31)
    refusals = [("layers", a3, w3), ("micro", targs, ids["b1"][:, :4])]
    out = {"pp4": launch(W.pipeline_ranks, 4,
                         (4, 1, w, targs, runs[4], targs.replace(quant="int8"), refusals),
                         backend="gloo", devices=["cpu"] * 4, timeout_s=300),
           "pp2": launch(W.pipeline_ranks, 2, (2, 1, w, targs, runs[2]),
                         backend="gloo", devices=["cpu"] * 2, timeout_s=300),
           "pptp": launch(W.pipeline_ranks, 4, (2, 2, w, targs, runs[(2, 2)]),
                          backend="gloo", devices=["cpu"] * 4, timeout_s=300)}
    return out


def _every_rank(results, key):
    first = results[0][key]
    for r in results[1:]:
        assert r[key] == first
    return first


def _solo(args, w, ids, n):
    a = dataclasses.replace(args, max_batch_size=ids.shape[0])
    return np.asarray(JLlama(w, a).generate_tokens(ids, n)).tolist()


def test_pp_matches_single_chip(setup, ranks):
    """4-stage greedy decode reproduces the single-chip stream and the JAX
    pipeline's."""
    args, w, ids = setup
    want = _solo(args, w, ids["b1"], 8)
    jpp = JPipelined(w, args, jpp_mesh(4))
    assert np.asarray(jpp.generate_tokens(ids["b1"], 8)).tolist() == want
    assert _every_rank(ranks["pp4"], "b1") == [want]


def test_pp_batch_and_restart(setup, ranks):
    """Batched rows decode independently, and a second call starts from a
    fresh cache with the same tokens."""
    args, w, ids = setup
    want = _solo(args, w, ids["b2"], 6)
    assert _every_rank(ranks["pp4"], "b2*2") == [want, want]


def test_pp_stage_memory(setup, ranks):
    """Each stage holds 1/S of the layer weights, plus the replicated
    embedding, norm and head."""
    args, w, _ = setup
    per_layer = sum(np.asarray(w[k]).nbytes for k in w if k.startswith("model.layers.0."))
    for r in ranks["pp4"]:
        assert r["layer_bytes"] * 4 == per_layer * args.n_layers
        head = sum(np.asarray(w[k]).nbytes for k in w if not k.startswith("model.layers."))
        assert r["bytes"] == r["layer_bytes"] + head
    jpp = JPipelined(w, args, jpp_mesh(4))
    jlayer = sum(leaf.addressable_shards[0].data.nbytes
                 for leaf in jax.tree.leaves(jpp.params["layers"]))
    assert ranks["pp4"][0]["layer_bytes"] == jlayer


def test_pp_int8_composes(setup, ranks):
    args, w, ids = setup
    args_q = dataclasses.replace(args, quant="int8")
    want = _solo(args_q, w, ids["b1"], 8)
    assert _every_rank(ranks["pp4"], "int8") == [want]
    assert _every_rank(ranks["pp4"], "int8_dtype") == "torch.int8"
    for r in ranks["pp4"]:
        assert r["int8_shapes"]["layers.wq_scale"][0][0] == 1  # one layer a stage


def test_pp_validates_divisibility(setup, ranks):
    args, _, _ = setup
    args3 = dataclasses.replace(args, n_layers=3)
    with pytest.raises(ValueError) as want:
        JPipelined(synthetic_weights(args3, seed=31), args3, jpp_mesh(4))
    assert "divide n_layers" in str(want.value)
    for r in ranks["pp4"]:
        assert r["refusals"][0] == str(want.value)


def test_pp_microbatched_matches_single_chip(setup, ranks):
    args, w, ids = setup
    want = _solo(args, w, ids["b4"], 7)
    jpp = JPipelined(w, dataclasses.replace(args, max_batch_size=4), jpp_mesh(4))
    assert np.asarray(jpp.generate_tokens(ids["b4"], 7, microbatched=True)).tolist() == want
    assert _every_rank(ranks["pp4"], "mb*2") == [want, want]


def test_pp_microbatched_two_stages(setup, ranks):
    args, w, ids = setup
    want = _solo(args, w, ids["b2"], 6)
    assert _every_rank(ranks["pp2"], "mb_two") == [want]


def test_pp_microbatched_single_token_and_validation(setup, ranks):
    args, w, ids = setup
    jpp = JPipelined(w, args, jpp_mesh(4))
    with pytest.raises(ValueError, match="divisible") as want:
        jpp.generate_tokens(ids["b1"][:, :4], 4, microbatched=True)  # B=1, S=4
    for r in ranks["pp4"]:
        assert r["refusals"][1] == str(want.value)
    assert _every_rank(ranks["pp4"], "mb_one") == [_solo(args, w, ids["b4_short"], 1)]


def test_pp_tp_composition_matches_single_chip(setup, ranks):
    """("pp", "tp") = (2, 2): stage shards carry 1/pp of the layers and
    1/tp of the weight columns; greedy identity, both schedules."""
    args, w, ids = setup
    want = _solo(args, w, ids["b2_5"], 6)
    jpp = JPipelined(w, dataclasses.replace(args, max_batch_size=2), jpp_tp_mesh(2, 2))
    assert np.asarray(jpp.generate_tokens(ids["b2_5"], 6)).tolist() == want
    full = np.asarray(jpp.params["layers"]["wq"]).shape
    for r in ranks["pptp"]:
        assert r["shapes"]["layers.wq"][0] == (full[0] // 2, full[1], full[2] // 2)
    assert _every_rank(ranks["pptp"], "pptp*2") == [want, want]
    assert _every_rank(ranks["pptp"], "pptp_mb") == [want]
