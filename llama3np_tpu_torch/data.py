"""Training data: token shards and a batch iterator that prefetches onto
the device.

Counterpart of `llama3np_tpu.data`, in its file format: a corpus is
tokenized once into a flat binary shard of token ids, and training reads
fixed-length windows out of it (the llama2.c / nanoGPT convention: no
tokenization per step, O(1) random access for shuffling, batches that are
numpy slices of a memory map).

  * `pack_documents` writes a shard: an 8-byte magic, a uint32 token
    width (2 or 4 bytes), the little-endian token stream (uint16 when the
    vocab fits, else uint32), each document BOS-prefixed.  Either package
    reads the other's shard.
  * `TokenDataset` memory-maps a shard; `batches()` yields [B, L+1] int32
    windows in the JAX package's order for a (seed, epoch)
    (`np.random.default_rng((seed, epoch))`); inputs and labels come from
    the same window (batch[:, :-1] / batch[:, 1:], `train.next_token_loss`).
  * `prefetch_to_device` keeps N batches in flight: each is copied from a
    pinned host buffer on a side stream, and the consumer's stream waits
    on the copy's event before it reads the batch, so the host's slicing
    and the copy overlap the device's step on the batch before.
"""

from __future__ import annotations

import collections
import os
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from .models.llama import resolve_device

_MAGIC = b"L3TKNS1\x00"  # 8-byte shard header magic + version


def pack_documents(texts: Iterable[str], tokenizer, path: str) -> int:
    """Tokenize documents into a flat .bin token shard; returns the token
    count.  Layout: 8-byte magic, uint32 dtype code (2 or 4 bytes/token),
    then the raw token stream in native byte order, as the JAX package
    writes it."""
    ids = []
    for t in texts:
        ids.extend(tokenizer.encode(t, add_bos=True))
    vocab = max(ids, default=0) + 1
    dt = np.uint16 if vocab <= 0x10000 else np.uint32
    arr = np.asarray(ids, dt)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(np.uint32(arr.dtype.itemsize).tobytes())
        f.write(arr.tobytes())
    return arr.size


class TokenDataset:
    """Memory-mapped token shard with windowed batch iteration."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            magic = f.read(8)
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a token shard (bad magic)")
            itemsize = int(np.frombuffer(f.read(4), np.uint32)[0])
        dt = {2: np.uint16, 4: np.uint32}[itemsize]
        offset = 12
        n = (os.path.getsize(path) - offset) // itemsize
        self.tokens = np.memmap(path, dt, mode="r", offset=offset, shape=(n,))

    def __len__(self) -> int:
        return self.tokens.shape[0]

    def num_windows(self, seq_len: int) -> int:
        # Each window is seq_len+1 tokens (inputs + shifted labels).
        return max((len(self) - 1) // seq_len, 0)

    def batches(self, batch_size: int, seq_len: int, *, shuffle: bool = True,
                seed: int = 0, epochs: Optional[int] = None,
                drop_last: bool = True) -> Iterator[np.ndarray]:
        """Yield [B, seq_len + 1] int32 windows.  Windows tile the shard at
        stride seq_len (every token is a label once an epoch); shuffle
        permutes the window order per epoch with the generator of (seed,
        epoch).  epochs=None streams forever."""
        nw = self.num_windows(seq_len)
        if nw == 0:
            raise ValueError(f"shard too small: {len(self)} tokens < seq_len+1")
        if nw < batch_size:
            # With drop_last an epoch would yield nothing, and epochs=None
            # would spin forever.
            raise ValueError(f"batch_size {batch_size} exceeds {nw} windows per epoch")
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(nw)
            if shuffle:
                np.random.default_rng((seed, epoch)).shuffle(order)
            spans = [(s - batch_size, s) for s in range(batch_size, nw + 1, batch_size)]
            if not drop_last and nw % batch_size:
                spans.append((nw - nw % batch_size, nw))
            for start, stop in spans:
                idx = order[start:stop]
                batch = np.empty((len(idx), seq_len + 1), np.int32)
                for j, w in enumerate(idx):
                    batch[j] = self.tokens[w * seq_len : w * seq_len + seq_len + 1]
                yield batch
            epoch += 1


def prefetch_to_device(it: Iterator[np.ndarray], size: int = 2, mesh=None,
                       device="cuda") -> Iterator[torch.Tensor]:
    """Wrap a host batch iterator with a `size`-deep queue of batches on
    `device` (the card by default), as int32 tensors.

    On the card each batch is copied from a pinned host buffer with a
    non-blocking copy on a side stream as soon as a slot frees, and the
    consumer's stream waits on that copy's event before the batch is
    handed out: the copy of batch k+1 overlaps the step on batch k, and no
    kernel reads a batch before its copy ends.  On the CPU the batches are
    plain tensors.

    With a `mesh` (`parallel.sharding.make_mesh`) each batch is this rank's
    dp rows (a batch splits evenly over "dp"), on mesh.device (`device` is
    not read): the rows the data-parallel train step of this rank takes,
    as the JAX package commits a batch to the ("dp", None) sharding."""
    if mesh is not None:
        device, it = mesh.device, (mesh.dp_rows(b) for b in it)
    device = resolve_device(device)
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put(batch):
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if side is None:
            return host.to(device, copy=True), None
        host = host.pin_memory()
        with torch.cuda.stream(side):
            dev = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return dev, done

    def take(entry):
        dev, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            dev.record_stream(consumer)  # allocated on the side stream
        return dev

    buf = collections.deque()
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            yield take(buf.popleft())
    while buf:
        yield take(buf.popleft())
