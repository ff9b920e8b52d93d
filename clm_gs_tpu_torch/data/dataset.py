"""Dataset pipeline: pre-decoded raw image cache and a prefetching batch
loader (clm_gs_tpu/data/dataset.py; the port's own copy).

  - every image is decoded once up front (a thread pool), top-left-cropped
    to the dataset-wide minimum size, and written as raw uint8 HWC bytes to
    `<cache_dir>/dataset_raw/<image_name>.raw`,
  - the training loader reads raw files and assembles (bsz, 3, H, W) float32
    numpy batches in background threads, so disk IO overlaps the step; the
    trainer moves them to the card in its own thread,
  - epochs reshuffle with a seeded numpy RNG.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import List, Optional, Sequence

import numpy as np

from clm_gs_tpu_torch.data.cameras import Camera


def dataset_min_size(cams: Sequence[Camera]):
    """(width, height) minimum over the dataset (predecode crop target)."""
    return min(c.width for c in cams), min(c.height for c in cams)


def _predecode_one(args):
    image_path, image_name, cache_dir, w, h, white_background = args
    from PIL import Image

    out_path = os.path.join(cache_dir, "dataset_raw", image_name.lstrip("/") + ".raw")
    if os.path.exists(out_path):
        return True
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with Image.open(image_path) as img:
        if "A" in img.getbands():
            # composite RGBA onto the training background (the Blender-scene
            # white_background handling, dataset_readers.py readNerfSynthetic)
            bg = (255, 255, 255) if white_background else (0, 0, 0)
            base = Image.new("RGB", img.size, bg)
            base.paste(img.convert("RGBA"), mask=img.convert("RGBA").split()[-1])
            img = base
        img = img.convert("RGB").crop((0, 0, w, h))
        raw = img.tobytes()
    with open(out_path, "wb") as f:
        f.write(raw)
    return True


def predecode_dataset_to_disk(
    cams: Sequence[Camera], cache_dir: str, num_workers: Optional[int] = None,
    white_background: bool = False,
):
    """Decode and crop all images once; returns the (width, height) they
    were cropped to. Image decoding runs in threads."""
    w, h = dataset_min_size(cams)
    tasks = [
        (c.image_path, c.image_name, cache_dir, w, h, white_background)
        for c in cams
    ]
    if num_workers is None:
        num_workers = min(os.cpu_count() or 1, 16)
    if num_workers <= 1 or len(tasks) < 4:
        for t in tasks:
            _predecode_one(t)
    else:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(_predecode_one, tasks))
    return w, h


def load_raw_image(cache_dir: str, image_name: str, width: int, height: int):
    """uint8 (3, H, W) from the raw cache."""
    path = os.path.join(cache_dir, "dataset_raw", image_name.lstrip("/") + ".raw")
    raw = np.fromfile(path, dtype=np.uint8)
    img = raw.reshape(height, width, -1)[:, :, :3]
    return np.ascontiguousarray(img.transpose(2, 0, 1))


class SceneDataset:
    """Shuffled epoch sampler over pre-decoded cameras with prefetch
    threads. `next_batch` returns (cameras, gt, indices): gt is the (bsz, 3,
    H, W) float32 numpy batch, or None when `skip_load` is set, and the
    trainer then gathers the batch by `indices` from its uint8 ground-truth
    cache on the card."""

    def __init__(
        self,
        cams: List[Camera],
        cache_dir: str,
        width: int,
        height: int,
        bsz: int,
        seed: int = 0,
        prefetch: int = 2,
        workers: int = 1,
        skip_load: bool = False,
    ):
        if not cams:
            raise ValueError("SceneDataset needs at least one camera")
        self.cams = cams
        self.cache_dir = cache_dir
        self.width = width
        self.height = height
        self.bsz = bsz
        self.skip_load = skip_load
        self.rng = np.random.RandomState(seed)
        self.epoch = 0
        self._order: List[int] = []
        self._order_lock = threading.Lock()
        self._queue: "queue.Queue" = queue.Queue(maxsize=max(prefetch, workers))
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._producer, daemon=True)
            for _ in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    def _next_indices(self):
        out = []
        with self._order_lock:
            while len(out) < self.bsz:
                if not self._order:
                    self._order = list(self.rng.permutation(len(self.cams)))
                    self.epoch += 1
                out.append(self._order.pop())
        return out

    def _producer(self):
        while not self._stop.is_set():
            try:
                idxs = self._next_indices()
                cams = [self.cams[i] for i in idxs]
                gt = None
                if not self.skip_load:
                    gt = np.stack([
                        load_raw_image(self.cache_dir, c.image_name, self.width,
                                       self.height)
                        for c in cams
                    ]).astype(np.float32) / 255.0
                item = (cams, gt, idxs)
            except Exception as e:  # handed to the consumer, which raises it
                item = e
            while not self._stop.is_set():
                try:
                    self._queue.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def next_batch(self):
        item = self._queue.get()
        if isinstance(item, Exception):
            raise RuntimeError("loading a training batch failed") from item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=2.0)


def iterate_eval(cams: List[Camera], cache_dir: str, width: int, height: int):
    """Sequential (camera, gt) pairs for the eval loop; gt is float32 numpy."""
    for c in cams:
        gt = (
            load_raw_image(cache_dir, c.image_name, width, height).astype(np.float32)
            / 255.0
        )
        yield c, gt
