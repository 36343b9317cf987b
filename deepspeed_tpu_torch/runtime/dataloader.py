"""Data loading (counterpart of ``deepspeed_tpu/runtime/dataloader.py``).

``DeepSpeedDataLoader`` batches a map-style dataset into global-batch
dicts of numpy arrays in the JAX package's order (an epoch's order is
``np.random.default_rng(seed + epoch)``'s shuffle), ``RepeatingLoader``
restarts an exhausted iterator, and ``PrefetchingLoader`` prepares the
next batches on a daemon thread while the card computes. One process
feeds one card, so every batch is the whole global batch (the JAX
package's ``jax.process_count()`` is 1 here). The engine moves the
arrays to the card.
"""

import queue
import threading

import numpy as np


class RepeatingLoader:
    """Wrap an iterator to restart when exhausted (JAX :19)."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(self.loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)


class PrefetchingLoader:
    """Run the wrapped iterator on a daemon thread that keeps up to
    ``prefetch`` ready batches in a queue, so indexing and collation of
    batch k+1 overlap the step on batch k (JAX :37). Exceptions in the
    worker re-raise at the consuming site. The end of the data and a
    worker's exception wait for the consumer as every batch does (the
    JAX loader gives them one 1 s put, and a consumer slower than that
    with a full queue then waits forever for the end)."""

    _DONE = object()

    def __init__(self, loader, prefetch: int = 2):
        self.loader = loader
        self.prefetch = max(1, int(prefetch))

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        # the wrapped loader's surface (batch_size, dataset, num_batches):
        # initialize() returns this wrapper in its place
        return getattr(self.loader, name)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            """Hand ``item`` over, waiting in bounded puts until the
            consumer takes it or abandons the iteration."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for item in self.loader:
                    if not put(item):
                        return
            except BaseException as e:  # forwarded to the consumer
                put(e)
                return
            put(self._DONE)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is self._DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # an abandoned iteration (break, generator close) releases the
            # worker, which checks the event between bounded puts
            stop.set()


class DeepSpeedDataLoader:
    """Batch a map-style dataset into global-batch dicts of numpy arrays
    (JAX :106).

    ``dataset`` may be a dict of arrays (column store), a sequence of
    per-example dicts, or a torch-style Dataset with __len__/__getitem__.
    """

    def __init__(self, dataset, batch_size, collate_fn=None, shuffle=True,
                 seed=0, drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn or _default_collate
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0
        if isinstance(dataset, dict):
            self._len = len(next(iter(dataset.values())))
        else:
            self._len = len(dataset)
        self.num_batches = (self._len // batch_size if drop_last
                            else -(-self._len // batch_size))

    def __len__(self):
        return self.num_batches

    def __iter__(self):
        order = np.arange(self._len)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        for b in range(self.num_batches):
            idx = order[b * self.batch_size:(b + 1) * self.batch_size]
            if isinstance(self.dataset, dict):
                yield {k: np.asarray(v)[idx] for k, v in self.dataset.items()}
            else:
                yield self.collate_fn([self.dataset[int(i)] for i in idx])


def _default_collate(examples):
    """Stack a list of examples (dicts, tuples or arrays) (JAX :153)."""
    if isinstance(examples[0], dict):
        return {k: np.stack([e[k] for e in examples]) for k in examples[0]}
    if isinstance(examples[0], (tuple, list)):
        return tuple(np.stack([e[i] for e in examples])
                     for i in range(len(examples[0])))
    return np.stack(examples)
