"""Host-side input pipeline, the counterpart of `xclip_tpu/data/pipeline.py`:
decode → tokenize → batch → prefetch to the card.

A worker pool decodes images and a producer thread tokenizes captions
(the C++ BPE merge loop) and collates each batch straight into a pinned
staging buffer, then copies it to the card with a `non_blocking` copy on
a stream of its own, `prefetch` batches ahead of the training step, so
host work and the copy overlap device compute. Every stage is per rank:
under `torch.distributed` each rank reads only its shard of the example
stream (disjoint `shard_index::shard_count` slices of equal length), and
`batch_size` is the rank's.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, List, Optional

import numpy as np
import torch

from .tokenizer import SimpleTokenizer


def _is_indexable(source) -> bool:
    return hasattr(source, "__getitem__") and hasattr(source, "__len__")


# process-pool worker state: the dataset is shipped ONCE per worker at pool
# startup (initializer) instead of pickled with every submitted index
_WORKER_DATASET = None


def _process_worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _process_worker_get(i):
    return _WORKER_DATASET[i]


def _rank_shards():
    """(world size, rank) of the default `torch.distributed` group, or
    (1, 0) when none is initialized."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _staging_batch(rows, context_length, image_shape, image_dtype, pinned):
    """Host buffers of one batch: int32 tokens, images, the `valid` mask."""
    return {"text": torch.empty((rows, context_length), dtype=torch.int32,
                                pin_memory=pinned),
            "image": torch.empty((rows, *image_shape), dtype=image_dtype,
                                 pin_memory=pinned),
            "valid": torch.empty((rows,), dtype=torch.bool,
                                 pin_memory=pinned)}


class _StagingRing:
    """`slots` pinned batches used in turn. A slot is handed out again only
    after the copy that last read it has completed on the card (its event),
    so a batch never changes under an unfinished copy."""

    def __init__(self, slots: int):
        self._slots: List[Optional[list]] = [None] * slots
        self._next = 0

    def take(self, rows, context_length, image_shape, image_dtype):
        i = self._next
        self._next = (i + 1) % len(self._slots)
        slot = self._slots[i]
        if slot is not None:
            slot[1].synchronize()
        if slot is None or slot[0]["image"].shape[1:] != image_shape \
                or slot[0]["image"].shape[0] < rows:
            slot = [_staging_batch(rows, context_length, image_shape,
                                   image_dtype, True), None]
            self._slots[i] = slot
        return i, {k: v[:rows] for k, v in slot[0].items()}

    def copied(self, i, event):
        self._slots[i][1] = event


class TextImageLoader:
    """Batches (text, image) examples and prefetches them to the card.

    Args (those of `xclip_tpu.data.TextImageLoader`, with `device=` in
    place of `mesh=`):
      examples: either an INDEXABLE dataset (`__len__` + `__getitem__`
        returning a (text, image) pair, e.g. `ImageFolderDataset`), which
        enables the worker pool, per-epoch shuffling and sharding across
        ranks; or any iterable / factory returning an iterable of pairs
        (read in the producer thread, optionally through a shuffle
        buffer). Text is a string (tokenized here) or a pre-tokenized int
        sequence; image is a (C, H, W) float array.
      batch_size: per-rank batch size.
      context_length: token width; sequences are padded/truncated to it.
      tokenizer: a `SimpleTokenizer` (default: a new one, native merges).
      device: where batches go (default the card, `'cuda'`: the current
        device, or `'cuda:<rank>'`); `'cpu'` yields host tensors.
      prefetch: number of batches staged ahead on the device.
      drop_remainder: drop the final short batch (keeps shapes static).
      pad_remainder: with drop_remainder=False, pad the final short batch
        up to `batch_size` (repeating the last example) and add a
        `'valid'` bool tensor to EVERY batch (all-True except on the
        padded tail); pass it to the step as `valid=`.
      num_workers: decode workers (indexable sources). 0 = inline in the
        producer thread.
      worker_backend: 'thread' (PIL and numpy release the GIL) or
        'process', a spawn pool for datasets whose `__getitem__` holds the
        GIL (spawn: a forked child of a CUDA process is broken).
      shuffle_seed: a fresh permutation per epoch from `shuffle_seed +
        epoch` (indexable), a `shuffle_buffer`-sized streaming shuffle
        otherwise.
      shuffle_buffer: buffer size for the streaming shuffle.
      num_epochs: passes over the source (None = repeat forever).
      shard_count/shard_index: partition the example stream across ranks;
        default to the `torch.distributed` world size and rank when a
        group is initialized, else 1 and 0. Every shard has the same
        length, so that every rank takes the same number of steps.
      image_dtype: dtype of the collated images ('float32' or
        'bfloat16'; rounded once from fp32, to nearest even).
      device_put: False yields the host batches (CPU tensors) unplaced.
      resume_from: a `loader_state` dict (`{'epoch': E, 'batch_index':
        B}`) of a yielded batch; iteration resumes with the batch that
        followed it. Indexable sources only.

    Every yielded dict has `'text'` (int32), `'image'`, `'loader_state'`
    (None for streamed sources) and, with `pad_remainder`, `'valid'`.
    On the card the tensors are ready on the consumer's current stream:
    it waits for their copy, and each is recorded on it.
    """

    def __init__(self, examples, batch_size: int, *,
                 context_length: int = 256,
                 tokenizer: Optional[SimpleTokenizer] = None,
                 device="cuda", prefetch: int = 2,
                 drop_remainder: bool = True,
                 pad_remainder: bool = False,
                 num_workers: int = 0,
                 worker_backend: str = "thread",
                 shuffle_seed: Optional[int] = None,
                 shuffle_buffer: int = 4096,
                 num_epochs: Optional[int] = 1,
                 shard_count: Optional[int] = None,
                 shard_index: Optional[int] = None,
                 image_dtype: str = "float32",
                 device_put: bool = True,
                 resume_from: Optional[dict] = None):
        self._examples = examples
        self.batch_size = batch_size
        self.context_length = context_length
        self.tokenizer = tokenizer or SimpleTokenizer()
        self.device = torch.device(device)
        self.device_put = device_put
        if (device_put and self.device.type == "cuda"
                and not torch.cuda.is_available()):
            raise RuntimeError(
                "TextImageLoader(device='cuda') needs a CUDA device; pass "
                "device='cpu' for host batches")
        self.prefetch = max(1, prefetch)
        self.drop_remainder = drop_remainder
        if pad_remainder and drop_remainder:
            raise ValueError("pad_remainder=True requires "
                             "drop_remainder=False (nothing to pad when "
                             "short batches are dropped)")
        self.pad_remainder = pad_remainder
        self.num_workers = num_workers
        if worker_backend not in ("thread", "process"):
            raise ValueError(f"unknown worker_backend: {worker_backend!r} "
                             "(expected 'thread' or 'process')")
        self.worker_backend = worker_backend
        self.shuffle_seed = shuffle_seed
        self.shuffle_buffer = shuffle_buffer
        self.num_epochs = num_epochs
        world, rank = _rank_shards()
        self.shard_count = shard_count if shard_count is not None else world
        self.shard_index = shard_index if shard_index is not None else rank
        if not 0 <= self.shard_index < self.shard_count:
            raise ValueError(f"shard_index {self.shard_index} is not in "
                             f"[0, {self.shard_count})")
        dtype = getattr(torch, image_dtype, None) \
            if isinstance(image_dtype, str) else image_dtype
        if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
            raise ValueError(f"image_dtype must name a floating dtype, got "
                             f"{image_dtype!r}")
        self._image_dtype = dtype

        if resume_from is not None:
            if not _is_indexable(examples):
                raise ValueError(
                    "resume_from requires an indexable dataset: a bare "
                    "stream cannot seek to a (epoch, batch_index) position")
            self._start_epoch = int(resume_from["epoch"])
            self._start_batch = int(resume_from["batch_index"])
        else:
            self._start_epoch = 0
            self._start_batch = 0

        # fail at construction, not an epoch into training: a shard that
        # cannot fill one batch would yield ZERO batches per epoch, and
        # with num_epochs=None the producer would spin through empty epochs
        if _is_indexable(examples):
            per_shard = len(examples) // self.shard_count
            if per_shard == 0:
                raise ValueError(
                    f"dataset of {len(examples)} examples across "
                    f"{self.shard_count} shards leaves this shard empty — "
                    "every epoch would yield zero batches. Use a dataset "
                    "with at least one example per shard.")
            if self.drop_remainder and per_shard < batch_size:
                raise ValueError(
                    f"dataset of {len(examples)} examples gives "
                    f"{per_shard} per shard ({self.shard_count} shards) — "
                    f"fewer than batch_size={batch_size} with "
                    "drop_remainder=True, so every epoch would be empty. "
                    "Lower batch_size or pass drop_remainder=False.")

        # the streamed path can neither shard the example stream across
        # processes nor replay a bare iterator for further epochs
        if not _is_indexable(examples):
            if self.shard_count > 1:
                raise ValueError(
                    "shard_count > 1 requires an indexable dataset "
                    "(__len__ + __getitem__, e.g. ImageFolderDataset): a "
                    "bare iterable cannot be partitioned across processes, "
                    "and silently duplicating the stream on every host is "
                    "exactly the multihost bug this parameter prevents")
            if num_epochs != 1 and not callable(examples):
                raise ValueError(
                    "multi-epoch iteration needs an indexable dataset or a "
                    "factory callable returning a fresh iterator; a bare "
                    "iterator cannot be replayed")

    # ------------------------------------------------------------- collate
    def _collate(self, texts, images, out=None) -> dict:
        """The batch of these examples as CPU tensors (`'text'` int32
        (rows, context_length), `'image'` in `image_dtype`, `'valid'`),
        written into `out` (`_staging_batch` buffers) when given. With
        `pad_remainder` a short batch is padded to `batch_size` by
        repeating its last example."""
        real = len(texts)
        rows = self.batch_size if self.pad_remainder else real
        first = np.asarray(images[0], dtype=np.float32)
        if out is None:
            out = _staging_batch(rows, self.context_length, first.shape,
                                 self._image_dtype, False)
        if isinstance(texts[0], str):
            tokens = self.tokenizer.tokenize(
                list(texts), context_length=self.context_length,
                truncate_text=True, pad_to_context_length=True)
        else:
            tokens = np.zeros((real, self.context_length), dtype=np.int32)
            for i, t in enumerate(texts):
                t = np.asarray(t, dtype=np.int32)[: self.context_length]
                tokens[i, : len(t)] = t
        out["text"][:real] = torch.from_numpy(tokens)
        # each image read as fp32, broadcast to the first's shape as JAX's
        # assignment into its batch buffer broadcasts, and rounded once
        # into the buffer by one copy
        image = out["image"]
        torch.stack([torch.from_numpy(np.require(
            np.asarray(im, dtype=np.float32), requirements="W"))
            .broadcast_to(first.shape) for im in images], out=image[:real])
        out["text"][real:] = out["text"][real - 1]
        image[real:] = image[real - 1]
        out["valid"][:] = torch.arange(rows) < real
        return out

    # ------------------------------------------- indexable (pooled) source
    def _epoch_indices(self, n: int, epoch: int) -> np.ndarray:
        order = np.arange(n)
        if self.shuffle_seed is not None:
            # the same permutation on every rank (seed + epoch), then a
            # disjoint strided slice per rank
            np.random.RandomState(self.shuffle_seed + epoch).shuffle(order)
        shard = order[self.shard_index::self.shard_count]
        # every shard the SAME length (a rank with one extra batch would
        # wait forever in the others' collectives)
        return shard[: n // self.shard_count]

    def _indexed_examples(self, pool) -> Iterator[tuple]:
        """Yields (texts, images, loader_state) a batch: the state names
        the NEXT position, so resuming from it replays nothing and skips
        nothing (each epoch's order is a function of `shuffle_seed +
        epoch`)."""
        src = self._examples
        n = len(src)
        epoch = self._start_epoch
        while self.num_epochs is None or epoch < self.num_epochs:
            order = self._epoch_indices(n, epoch)
            usable = len(order)
            if self.drop_remainder:
                usable -= usable % self.batch_size
            skip = self._start_batch if epoch == self._start_epoch else 0
            for bi, start in enumerate(
                    range(skip * self.batch_size, usable, self.batch_size),
                    start=skip):
                idx = order[start:start + self.batch_size]
                if len(idx) < self.batch_size and self.drop_remainder:
                    break
                if isinstance(pool, ProcessPoolExecutor):
                    pairs = list(pool.map(_process_worker_get, idx))
                elif pool is not None:
                    pairs = list(pool.map(src.__getitem__, idx))
                else:
                    pairs = [src[i] for i in idx]
                texts, images = zip(*pairs)
                yield texts, images, {"epoch": epoch, "batch_index": bi + 1}
            epoch += 1

    # --------------------------------------------- iterable (fallback) path
    def _iter_examples(self) -> Iterator:
        epoch = 0
        while self.num_epochs is None or epoch < self.num_epochs:
            ex = self._examples
            it = iter(ex() if callable(ex) else ex)
            if self.shuffle_seed is not None:
                it = self._buffered_shuffle(it, epoch)
            yield from it
            epoch += 1

    def _buffered_shuffle(self, it, epoch: int):
        rs = np.random.RandomState(self.shuffle_seed + epoch)
        buf = []
        for item in it:
            if len(buf) < self.shuffle_buffer:
                buf.append(item)
                continue
            j = rs.randint(len(buf))
            out, buf[j] = buf[j], item
            yield out
        rs.shuffle(buf)
        yield from buf

    def _streamed_examples(self) -> Iterator[tuple]:
        texts, images = [], []
        for text, image in self._iter_examples():
            texts.append(text)
            images.append(image)
            if len(texts) == self.batch_size:
                yield texts, images, None
                texts, images = [], []
        if texts and not self.drop_remainder:
            yield texts, images, None

    def _batch_examples(self, pool) -> Iterator[tuple]:
        if _is_indexable(self._examples):
            return self._indexed_examples(pool)
        return self._streamed_examples()

    # ---------------------------------------------------------------- iter
    def __iter__(self) -> Iterator[dict]:
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()
        err: list = []
        keys = ("text", "image") + (("valid",) if self.pad_remainder else ())

        on_card = self.device_put and self.device.type == "cuda"
        if on_card:
            device = self.device if self.device.index is not None else \
                torch.device("cuda", torch.cuda.current_device())
            copy_stream = torch.cuda.Stream(device=device)
            ring = _StagingRing(self.prefetch + 2)

        pool = None
        if self.num_workers > 0 and _is_indexable(self._examples):
            if self.worker_backend == "process":
                import multiprocessing
                pool = ProcessPoolExecutor(
                    self.num_workers, initializer=_process_worker_init,
                    initargs=(self._examples,),
                    mp_context=multiprocessing.get_context("spawn"))
            else:
                pool = ThreadPoolExecutor(self.num_workers)

        # consumer-gone signal: when the caller abandons the iterator, the
        # producer must not stay blocked on q.put holding `prefetch`
        # batches; it checks this event between put attempts and exits
        done = threading.Event()

        def put_until_done(item) -> bool:
            while not done.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def place(texts, images):
            """The collated batch and, on the card, its copy's event."""
            if not on_card:
                return self._collate(texts, images), None
            rows = self.batch_size if self.pad_remainder else len(texts)
            shape = np.shape(images[0])
            slot, host = ring.take(rows, self.context_length, shape,
                                   self._image_dtype)
            self._collate(texts, images, host)
            with torch.cuda.stream(copy_stream):
                batch = {k: host[k].to(device, non_blocking=True)
                         for k in keys}
                event = torch.cuda.Event()
                event.record(copy_stream)
            ring.copied(slot, event)
            return batch, event

        def worker():
            try:
                if on_card:
                    torch.cuda.set_device(device)
                for texts, images, state in self._batch_examples(pool):
                    batch, event = place(texts, images)
                    batch = {k: batch[k] for k in keys}
                    batch["loader_state"] = state
                    if not put_until_done((batch, event)):
                        return
            except Exception as e:  # surface worker errors to the consumer
                err.append(e)
            finally:
                put_until_done(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    if err:
                        raise err[0]
                    return
                batch, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(device)
                    consumer.wait_event(event)
                    for k in keys:
                        batch[k].record_stream(consumer)
                yield batch
        finally:
            done.set()
            if pool is not None:
                pool.shutdown(wait=False)
