"""FlowDataLoader, the step-driven batch iterator (counterpart of
``nf_tpu/data/loader.py``), which yields numpy batches bit for bit
nf_tpu's for the same arguments on the same tier.

- Toy densities: a pool of ``POOL_SIZE // num_shards`` samples drawn anew
  from a fresh stream when a batch would run past its end.  Images: the
  shard's rows, reshuffled each epoch.  ``.dims`` and ``.dtype`` in
  {'2d', '3d', 'image'}; iteration yields ``total_steps`` batches.
- Shards, the data half of data parallelism: each ``(shard_id,
  num_shards)`` draws a disjoint toy stream (``_stream_seed``) or the rows
  ``shard_id::num_shards`` of the images.
- Tiers: the native library (``data/native.py``: pool sampling, the epoch
  shuffle, row gathers) when ``g++`` builds it, numpy otherwise, as
  nf_tpu chooses.  The two tiers draw different streams; ``tier`` says
  which one serves.
- ``dequantize``: y = (255 x + u) / 256 with u ~ U[0, 1) on image data,
  from a numpy stream of its own per (seed, shard).
"""
from __future__ import annotations

import numpy as np

from . import native
from .images import IMAGE_DATASETS, load_images
from .toy import TOY_SAMPLERS

POOL_SIZE = 65536


class FlowDataLoader:
    def __init__(self, name: str, batch_size: int = 1024,
                 total_steps: int = 100_000, shuffle: bool = True,
                 seed: int = 0, data_root: str = "data",
                 shard_id: int = 0, num_shards: int = 1,
                 dequantize: bool = False):
        if name not in TOY_SAMPLERS and name not in IMAGE_DATASETS:
            raise KeyError(
                f"unknown dataset {name!r}; choose from "
                f"{sorted(TOY_SAMPLERS) + sorted(IMAGE_DATASETS)}")
        self.name = name
        self.batch_size = int(batch_size)
        self.total_steps = int(total_steps)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.shard_id = int(shard_id)
        self.num_shards = max(1, int(num_shards))
        self.dequantize = bool(dequantize)
        self._deq_rng = np.random.default_rng(self._mix(seed, shard_id))

        self._native = native.load() if native.available() else None
        self._epoch = 0

        if name in TOY_SAMPLERS:
            _, self.dims, self.dtype = TOY_SAMPLERS[name]
            self._images = None
            self._pool_n = POOL_SIZE // self.num_shards
        else:
            self.dims = IMAGE_DATASETS[name]
            self.dtype = "image"
            imgs, self.is_real_data = load_images(
                name, data_root, seed=self._stream_seed(0))
            self._images = imgs[self.shard_id::self.num_shards]
            self._pool_n = self._images.shape[0]

        self._pool = None
        self._order = None
        self._cursor = 0

    @property
    def tier(self) -> str:
        """The tier that draws: "native" or "numpy"."""
        return "numpy" if self._native is None else "native"

    # -- PRNG streams -------------------------------------------------------
    @staticmethod
    def _mix(a: int, b: int) -> int:
        return ((a * 0x9E3779B97F4A7C15 + b * 0xBF58476D1CE4E5B9 + 0x2545F491)
                & (2**63 - 1))

    def _stream_seed(self, epoch: int) -> int:
        # a disjoint stream per (seed, shard, epoch): golden-ratio mixing
        # keeps nearby tuples far apart in seed space
        return ((self.seed * 0x9E3779B97F4A7C15
                 + self.shard_id * 0xBF58476D1CE4E5B9
                 + epoch * 0x94D049BB133111EB) & (2**63 - 1))

    # -- the pool -----------------------------------------------------------
    def _fill_pool(self) -> None:
        s = self._stream_seed(self._epoch)
        if self._images is not None:
            self._pool = self._images
        elif self._native is not None:
            self._pool = native.NATIVE_SAMPLERS[self.name](self._pool_n, s)
        else:
            fn, _, _ = TOY_SAMPLERS[self.name]
            self._pool = fn(self._pool_n, np.random.default_rng(s))
        if self.shuffle:
            if self._native is not None:
                self._order = native.shuffled_indices(self._pool_n, s ^ 0x5F)
            else:
                self._order = np.random.default_rng(s ^ 0x5F).permutation(
                    self._pool_n).astype(np.int64)
        else:
            self._order = np.arange(self._pool_n, dtype=np.int64)
        self._cursor = 0
        self._epoch += 1

    def next_batch(self) -> np.ndarray:
        """The next batch; the pool is drawn anew (or reshuffled) when it
        would run out, which does not count against ``total_steps``."""
        if self._pool is None or self._cursor + self.batch_size > self._pool_n:
            self._fill_pool()
        idx = self._order[self._cursor:self._cursor + self.batch_size]
        self._cursor += self.batch_size
        if self._native is not None and self._pool.ndim == 2:
            return native.gather_rows(self._pool, idx)
        batch = self._pool[idx]
        if self.dequantize and self.dtype == "image":
            u = self._deq_rng.random(batch.shape, dtype=np.float32)
            batch = (batch * 255.0 + u) / 256.0
        return batch

    # -- iteration ----------------------------------------------------------
    def __iter__(self):
        for _ in range(self.total_steps):
            yield self.next_batch()

    def __len__(self) -> int:
        return self.total_steps
