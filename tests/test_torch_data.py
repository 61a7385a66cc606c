"""The port's data pipeline against the JAX package's (CPU).

Shards written by both `pack_documents` are byte for byte equal and read
by either `TokenDataset`; `batches()` yields the same windows in the same
order for a (seed, epoch), with and without shuffle, `drop_last`, across
epochs, with the same errors; `prefetch_to_device` hands out the same
batches; and an end-to-end LoRA fine-tune from a packed shard takes the
JAX package's losses (rtol 2e-4 / atol 1e-4).
"""

import numpy as np
import pytest
import torch

from llama3np_tpu import data as jdata
from llama3np_tpu.parallel.sharding import make_mesh as jmesh
from llama3np_tpu_torch import data as tdata

torch.set_num_threads(1)


class IdTok:
    """Tokenizer stand-in: one token per character code, offset by `base`
    (base 70,000 forces the 4-byte shard)."""

    def __init__(self, base=3, mod=500):
        self.base, self.mod = base, mod

    def encode(self, text, add_bos=True):
        ids = [ord(c) % self.mod + self.base for c in text]
        return ([1] + ids) if add_bos else ids


DOCS = ["hello world", "the quick brown fox", "abc", "", "jumps over the lazy dog " * 3]


@pytest.mark.parametrize("tok,itemsize", [(IdTok(), 2), (IdTok(base=70_000), 4)])
def test_pack_documents_bytes_equal_jax(tmp_path, tok, itemsize):
    t, j = str(tmp_path / "t.bin"), str(tmp_path / "j.bin")
    n = tdata.pack_documents(DOCS, tok, t)
    assert n == jdata.pack_documents(DOCS, tok, j)
    assert open(t, "rb").read() == open(j, "rb").read()
    for Dataset in (tdata.TokenDataset, jdata.TokenDataset):  # either reads either
        for path in (t, j):
            ds = Dataset(path)
            assert len(ds) == n and ds.tokens.dtype.itemsize == itemsize
            assert int((np.asarray(ds.tokens) == 1).sum()) == len(DOCS)


@pytest.fixture()
def shard(tmp_path):
    p = str(tmp_path / "toks.bin")
    n = tdata.pack_documents(DOCS, IdTok(), p)
    return p, n


def windows(it):
    return [b.tolist() for b in it]


@pytest.mark.parametrize("kw", [
    dict(shuffle=False, epochs=1), dict(seed=7, epochs=1), dict(seed=8, epochs=2),
    dict(seed=7, epochs=1, drop_last=False), dict(shuffle=False, epochs=2, drop_last=False)])
@pytest.mark.parametrize("B,L", [(1, 5), (2, 5), (3, 7)])
def test_batches_equal_jax(shard, kw, B, L):
    p, _ = shard
    t, j = tdata.TokenDataset(p), jdata.TokenDataset(p)
    assert t.num_windows(L) == j.num_windows(L)
    got = list(t.batches(B, L, **kw))
    assert windows(got) == windows(j.batches(B, L, **kw))
    assert all(b.dtype == np.int32 and b.shape[1] == L + 1 for b in got)


def test_windows_tile_the_shard(shard):
    p, n = shard
    ds = tdata.TokenDataset(p)
    L = 5
    nw = ds.num_windows(L)
    assert nw == (n - 1) // L
    flat = np.concatenate([b[0, :-1] for b in ds.batches(1, L, shuffle=False, epochs=1)])
    np.testing.assert_array_equal(flat, np.asarray(ds.tokens[: nw * L]))
    s1 = windows(ds.batches(1, L, seed=7, epochs=1))
    assert s1 == windows(ds.batches(1, L, seed=7, epochs=1))
    assert sorted(s1) == sorted(windows(ds.batches(1, L, shuffle=False, epochs=1)))
    it = ds.batches(1, L, epochs=None)  # streams past any epoch boundary
    for _ in range(3 * nw):
        next(it)


def test_errors_equal_jax(tmp_path, shard):
    p, _ = shard
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"not a shard at all")
    msgs = []
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="bad magic") as e1:
            mod.TokenDataset(str(junk))
        ds = mod.TokenDataset(p)
        nw = ds.num_windows(5)
        for drop_last in (True, False):
            with pytest.raises(ValueError, match="exceeds") as e2:
                next(ds.batches(nw + 1, 5, drop_last=drop_last))
        with pytest.raises(ValueError, match="too small") as e3:
            next(ds.batches(1, len(ds) + 5))
        msgs.append([str(e.value) for e in (e1, e2, e3)])
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_to_device_cpu(shard, size):
    p, _ = shard
    ds = tdata.TokenDataset(p)
    host = list(ds.batches(2, 5, seed=3, epochs=1))
    dev = list(tdata.prefetch_to_device(ds.batches(2, 5, seed=3, epochs=1), size=size,
                                        device="cpu"))
    assert len(dev) == len(host)
    for h, d in zip(host, dev):
        assert isinstance(d, torch.Tensor) and d.dtype == torch.int32
        np.testing.assert_array_equal(d.numpy(), h)
    jdev = list(jdata.prefetch_to_device(ds.batches(2, 5, seed=3, epochs=1)))
    assert [d.tolist() for d in dev] == [np.asarray(d).tolist() for d in jdev]


def test_prefetch_refusals(shard, monkeypatch):
    from llama3np_tpu_torch.parallel.sharding import Mesh

    class TwoWayDp:  # the mesh's dp rows, without a process group
        device = torch.device("cpu")
        dp_rows = Mesh.dp_rows

        def size(self, axis):
            return 2 if axis == "dp" else 1

        def index(self, axis):
            return 0

    p, _ = shard
    ds = tdata.TokenDataset(p)
    with pytest.raises(ValueError, match="must divide over dp=2"):
        next(tdata.prefetch_to_device(ds.batches(1, 5), mesh=TwoWayDp()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(tdata.prefetch_to_device(ds.batches(1, 5)))


def test_prefetch_sharded_over_mesh(shard):
    """tests/test_data.py's mesh scenario: over a dp=2 mesh (two ranks
    under gloo) each rank gets its row of every batch, on its device, and
    the rows in dp order are the host batch."""
    import torch_parallel_workers as W
    from llama3np_tpu_torch.parallel.launch import launch

    p, _ = shard
    ds = tdata.TokenDataset(p)
    host = list(ds.batches(2, 5, shuffle=False, epochs=1))
    ranks = launch(W.prefetch_ranks, 2, (p,), backend="gloo", devices=["cpu"] * 2,
                   timeout_s=120)
    assert len(ranks[0]) == len(ranks[1]) == len(host)
    for h, r0, r1 in zip(host, *ranks):
        assert r0.shape == r1.shape == (1, 6) and r0.dtype == np.int32
        np.testing.assert_array_equal(np.concatenate([r0, r1]), h)
    (jb,) = list(jdata.prefetch_to_device(ds.batches(2, 5, shuffle=False, epochs=1),
                                          mesh=jmesh(dp=2, tp=1)))[:1]
    np.testing.assert_array_equal(np.asarray(jb), np.concatenate([ranks[0][0], ranks[1][0]]))


def test_end_to_end_lora_finetune_from_shard(tmp_path):
    """pack -> dataset -> prefetch -> LoRA steps: the port's losses are the
    JAX package's over the same shard, and they fall."""
    from llama3np_tpu import lora as jlora
    from llama3np_tpu import preset, synthetic_weights
    from llama3np_tpu import train as jtrain
    from llama3np_tpu.checkpoint import build_param_tree
    from llama3np_tpu.models.llama import StaticConfig
    from llama3np_tpu.ops.core import rope_tables
    from llama3np_tpu_torch import lora as tlora
    from llama3np_tpu_torch import train as ttrain
    from llama3np_tpu_torch.checkpoint import params_to_device
    from llama3np_tpu_torch.models.llama import StaticConfig as TConfig
    from llama3np_tpu_torch.ops.core import rope_tables as trope

    args = preset("test-tiny")
    params = build_param_tree(synthetic_weights(args, seed=0), args)
    p = str(tmp_path / "corpus.bin")
    tdata.pack_documents(["a tale of tiny models " * 8], IdTok(), p)
    ds = tdata.TokenDataset(p)
    lora = jlora.init_lora(args, rank=4, seed=3)
    scale = lora["alpha"] / lora["rank"]
    tl = tlora.lora_from_jax(lora, "cpu")  # before the JAX step donates the arrays

    cos, sin = rope_tables(args.head_dim, args.max_seq_len, args.rope_theta)
    opt, st = jtrain.init_optimizer(lora["layers"], learning_rate=1e-2)
    step = jlora.make_lora_train_step(opt, StaticConfig.from_args(args), scale)
    ly, want = lora["layers"], []
    for batch in jdata.prefetch_to_device(ds.batches(2, 16, seed=0, epochs=None)):
        ly, st, loss = step(ly, st, params, batch, cos, sin)
        want.append(float(loss))
        if len(want) == 6:
            break

    tp = params_to_device(params, "cpu")
    cfg = TConfig.from_args(args, "cpu")._replace(rope_split=False, fused=False)
    tc, ts = trope(args.head_dim, args.max_seq_len, args.rope_theta, device="cpu")
    topt, tst = ttrain.init_optimizer(tl["layers"], learning_rate=1e-2)
    tstep = tlora.make_lora_train_step(topt, cfg, scale)
    tly, got = tl["layers"], []
    for batch in tdata.prefetch_to_device(ds.batches(2, 16, seed=0, epochs=None),
                                          device="cpu"):
        tly, tst, loss = tstep(tly, tst, tp, batch, tc, ts)
        got.append(float(loss))
        if len(got) == 6:
            break
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)
    assert got[-1] < got[0] - 0.1, got
