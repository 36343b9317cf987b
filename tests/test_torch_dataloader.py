"""The port's dataloader against the JAX package's.

``DeepSpeedDataLoader`` must yield the JAX loader's batches bit for bit
(the same shuffle, ``np.random.default_rng(seed + epoch)``, the same
collation) for a dict of columns, a list of examples and a
``__getitem__`` dataset; ``PrefetchingLoader`` forwards worker errors and
releases its thread; ``initialize(training_data=...)`` returns the
prefetching loader over global batches of ``train_batch_size`` rows.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import dataloader as jax_dl
import deepspeed_tpu_torch as ds
from deepspeed_tpu_torch.models import GPT, GPTConfig
from deepspeed_tpu_torch.runtime import dataloader as port_dl

from tests.test_torch_model import TINY
from tests.torch_threads import share_cores

share_cores()

N, SEQ = 22, 8


def _columns():
    rs = np.random.RandomState(0)
    return {"input_ids": rs.randint(0, 97, size=(N, SEQ)).astype(np.int32),
            "labels": rs.randint(0, 5, size=(N,)).astype(np.int64)}


class _Indexed:
    """A torch-style map dataset: (ids, label) tuples by __getitem__."""

    def __init__(self):
        self.cols = _columns()

    def __len__(self):
        return N

    def __getitem__(self, i):
        return self.cols["input_ids"][i], self.cols["labels"][i]


def _dataset(kind):
    cols = _columns()
    if kind == "columns":
        return cols
    if kind == "examples":
        return [{k: v[i] for k, v in cols.items()} for i in range(N)]
    return _Indexed()


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("kind", ["columns", "examples", "indexed"])
def test_batches_equal_jax_over_two_epochs(kind, shuffle):
    kw = dict(batch_size=4, shuffle=shuffle, seed=3)
    ref = jax_dl.DeepSpeedDataLoader(_dataset(kind), **kw)
    port = port_dl.DeepSpeedDataLoader(_dataset(kind), **kw)
    assert len(port) == len(ref) == N // 4
    for epoch in range(2):
        got, want = list(port), list(ref)
        assert len(got) == len(want) == N // 4, epoch
        for a, b in zip(got, want):
            _same(a, b)


def test_epochs_reshuffle_and_drop_last_false_keeps_the_tail():
    port = port_dl.DeepSpeedDataLoader(_columns(), batch_size=4, seed=0,
                                       drop_last=False)
    ref = jax_dl.DeepSpeedDataLoader(_columns(), batch_size=4, seed=0,
                                     drop_last=False)
    first, second = list(port), list(port)
    assert len(port) == len(first) == 6 and first[-1]["labels"].shape == (2,)
    assert not np.array_equal(first[0]["input_ids"], second[0]["input_ids"])
    for a, b in zip(first + second, list(ref) + list(ref)):
        _same(a, b)


def test_default_collate_matches_jax():
    for examples in ([np.arange(3), np.arange(3) + 1],
                     [(np.zeros(2), np.ones(1)), (np.ones(2), np.zeros(1))],
                     [{"a": np.arange(2)}, {"a": np.arange(2) * 2}]):
        _same(port_dl._default_collate(examples),
              jax_dl._default_collate(examples))


def test_repeating_loader_restarts():
    loader = port_dl.RepeatingLoader([1, 2, 3])
    assert [next(loader) for _ in range(7)] == [1, 2, 3, 1, 2, 3, 1]


def test_prefetching_loader_yields_in_order_and_keeps_the_surface():
    inner = port_dl.DeepSpeedDataLoader(_columns(), batch_size=4, seed=5)
    ref = port_dl.DeepSpeedDataLoader(_columns(), batch_size=4, seed=5)
    loader = port_dl.PrefetchingLoader(inner, prefetch=2)
    assert len(loader) == 5 and loader.batch_size == 4
    assert loader.num_batches == 5 and loader.dataset is inner.dataset
    for a, b in zip(list(loader), list(ref)):
        _same(a, b)


def test_prefetching_loader_reraises_worker_errors():
    def broken():
        yield {"x": np.zeros(1)}
        raise KeyError("bad example")

    class Loader:
        def __iter__(self):
            return broken()

    it = iter(port_dl.PrefetchingLoader(Loader()))
    assert next(it)["x"].shape == (1,)
    with pytest.raises(KeyError, match="bad example"):
        next(it)


def test_prefetching_loader_releases_its_worker_on_break():
    before = set(threading.enumerate())

    def endless():
        i = 0
        while True:
            yield i
            i += 1

    class Loader:
        def __iter__(self):
            return endless()

    gen = iter(port_dl.PrefetchingLoader(Loader(), prefetch=1))
    assert [next(gen) for _ in range(3)] == [0, 1, 2]
    workers = set(threading.enumerate()) - before
    assert len(workers) == 1 and all(t.daemon for t in workers)
    gen.close()
    for t in workers:
        t.join(timeout=5.0)
        assert not t.is_alive()


def test_prefetching_loader_ends_behind_a_slow_consumer():
    """The end of the data waits for the consumer like every batch: a
    consumer that spends over a second on each batch with a full queue
    still sees the iteration end. (JAX's loader gives the end one 1 s put;
    after that its consumer waits forever.)"""
    out = []

    def consume():
        for item in port_dl.PrefetchingLoader([0, 1], prefetch=1):
            time.sleep(1.3)
            out.append(item)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=20.0)
    assert not t.is_alive() and out == [0, 1]


def test_initialize_returns_the_prefetching_loader_of_global_batches():
    """training_data goes through DeepSpeedDataLoader(batch_size =
    train_batch_size) under a PrefetchingLoader, as JAX's initialize
    builds it (__init__.py:89-95); collate_fn reaches the loader."""
    model = GPT(GPTConfig(**TINY, dtype=torch.float32))
    cols = _columns()
    examples = [{"input_ids": cols["input_ids"][i]} for i in range(N)]
    seen = []

    def collate(batch):
        seen.append(len(batch))
        return {"input_ids": np.stack([e["input_ids"] for e in batch])}

    engine, _, loader, _ = ds.initialize(
        model=model, config={"train_batch_size": 8,
                             "train_micro_batch_size_per_gpu": 4},
        loss_fn=lambda *a: None, training_data=examples, collate_fn=collate,
        device="cpu")
    assert isinstance(loader, port_dl.PrefetchingLoader)
    assert isinstance(loader.loader, port_dl.DeepSpeedDataLoader)
    assert loader.batch_size == engine.config.train_batch_size == 8
    ref = jax_dl.DeepSpeedDataLoader(examples, batch_size=8)
    for a, b in zip(list(loader), list(ref)):
        _same(a, b)
    assert seen == [8, 8]
