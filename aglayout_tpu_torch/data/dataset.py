"""Runtime Visual Genome dataset: h5 -> dense padded batches.

The port's copy of `aglayout_tpu/data/dataset.py` (the reference's
data/vg_custom_mask.py: VgSceneGraphDataset, vg_collate_fn, get_dataloader),
with the same batch contract, so one seed gives both packages the same
batches:

  * dense (B, O_max, ...) numpy arrays in JAX's layout (NHWC images, masks
    (B, O, H, W, 1)) plus a validity mask; the train loop moves them to the
    device (`train/loop.py`);
  * relationship-aware object selection, orphan top-up, shuffle, shift
    augmentation and multi-hot attribute encoding as the reference's
    (:91-173); `max_objects - 1` real slots a sample (:45);
  * image size is a real parameter (the reference hardcoded (64, 64) at
    :229);
  * the train loader shuffles with a seeded RNG, each epoch by
    RandomState(seed + epoch), and each batch draws from
    RandomState((seed + epoch) * 100003 + batch index), so the threads'
    order does not change a batch;
  * decode and assembly run in a thread pool with prefetch and in-order
    delivery, natively (`data/native.py`: libjpeg decode, C++ assembly)
    where native/libdatapath.so loads, else with PIL and NumPy
    (`Loader.batch_path` says which).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Iterator

import numpy as np

from aglayout_tpu_torch.data import native
from aglayout_tpu_torch.data.synthetic import IMAGENET_MEAN, IMAGENET_STD


def _load_image(path: str, image_size: int):
    """Returns (normalized HWC float image, original W, original H).

    The original dims are needed to normalize pixel-space boxes — the
    reference reads them from the PIL image before resizing (:85)."""
    from PIL import Image

    with open(path, "rb") as f:
        with Image.open(f) as img:
            ww, hh = img.size
            img = img.convert("RGB").resize((image_size, image_size), Image.BILINEAR)
    x = np.asarray(img, np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD, ww, hh


def _shift_box(x0, y0, x1, y1):
    """Horizontal shift augmentation (reference :139-158)."""
    width = x1 - x0
    if width < 0.5:
        left, right = x0, 1.0 - x1
        if left > right:
            s = left * 0.8
            return x0 - s, y0, x1 - s, y1
        if right > left:
            s = right * 0.8
            return x0 + s, y0, x1 + s, y1
    return x0, y0, x1, y1


def _rasterize(x0, y0, x1, y1, size):
    m = np.zeros((size, size, 1), np.float32)
    m[
        int(round(y0 * size)) : int(round(y1 * size)),
        int(round(x0 * size)) : int(round(x1 * size)),
    ] = 1
    return m


class VgDataset:
    """In-memory h5-backed dataset producing dense padded samples."""

    def __init__(
        self,
        h5_path: str,
        image_dir: str,
        vocab: dict,
        image_size: int = 64,
        max_objects: int = 10,
        attribute_dim: int = 106,
        use_orphaned_objects: bool = True,
        max_samples: int | None = None,
    ):
        import h5py

        self.image_dir = image_dir
        self.image_size = image_size
        self.vocab = vocab
        self.num_objects = len(vocab["object_idx_to_name"])
        # reference keeps one slot for a potential dummy node: max_objects-1
        # real objects per image (:45)
        self.max_objects = max_objects - 1
        self.o_max = max_objects
        self.attribute_dim = attribute_dim
        self.use_orphaned_objects = use_orphaned_objects
        self.max_samples = max_samples

        self.data = {}
        with h5py.File(h5_path, "r") as f:
            for k, v in f.items():
                if k == "image_paths":
                    self.image_paths = [
                        p.decode() if isinstance(p, bytes) else str(p) for p in v[()]
                    ]
                else:
                    self.data[k] = np.asarray(v)

    def __len__(self):
        n = self.data["object_names"].shape[0]
        return min(n, self.max_samples) if self.max_samples else n

    def select_objects(self, index: int, rng: np.random.RandomState):
        """Relationship-aware object selection + shuffle (:91-113)."""
        n_obj = int(self.data["objects_per_image"][index])
        with_rels: set = set()
        without_rels = set(range(n_obj))
        for r in range(int(self.data["relationships_per_image"][index])):
            s = int(self.data["relationship_subjects"][index, r])
            o = int(self.data["relationship_objects"][index, r])
            with_rels.update((s, o))
            without_rels.discard(s)
            without_rels.discard(o)
        obj_idxs = list(with_rels)
        orphans = list(without_rels)
        if len(obj_idxs) > self.max_objects:
            obj_idxs = list(rng.choice(obj_idxs, self.max_objects, replace=False))
        elif len(obj_idxs) < self.max_objects and self.use_orphaned_objects:
            add = min(self.max_objects - len(obj_idxs), len(orphans))
            if add:
                obj_idxs += list(rng.choice(orphans, add, replace=False))
        rng.shuffle(obj_idxs)
        return obj_idxs

    def sample_meta(
        self, index: int, rng: np.random.RandomState, image=None, W=None, H=None
    ) -> dict:
        """Decode + select only; per-object assembly is done per batch
        (natively when native/libdatapath.so is built). Pass `image`/`W`/`H`
        to reuse a pre-decoded image (the native JPEG decode pool)."""
        size = self.image_size
        if image is None:
            img, W, H = _load_image(
                os.path.join(self.image_dir, self.image_paths[index]), size
            )
        else:
            img = image
        obj_idxs = self.select_objects(index, rng)
        o_max = self.o_max
        objs = np.zeros(o_max, np.int32)
        boxes_px = np.zeros((o_max, 4), np.float64)
        att_ids = np.full((o_max, self.data["object_attributes"].shape[2]), -1, np.int32)
        valid = np.zeros(o_max, np.float32)
        for i, oi in enumerate(obj_idxs):
            objs[i] = self.data["object_names"][index, oi]
            boxes_px[i] = self.data["object_boxes"][index, oi]
            att_ids[i] = self.data["object_attributes"][index, oi]
            valid[i] = 1.0
        return {
            "imgs": img,
            "objs": objs,
            "boxes_px": boxes_px,
            "att_ids": att_ids,
            "valid": valid,
            "img_w": float(W),
            "img_h": float(H),
        }

    def sample(self, index: int, rng: np.random.RandomState) -> dict:
        size = self.image_size
        img, W, H = _load_image(os.path.join(self.image_dir, self.image_paths[index]), size)
        obj_idxs = self.select_objects(index, rng)

        o_max = self.o_max
        objs = np.zeros(o_max, np.int32)
        boxes = np.tile(np.array([0, 0, 1, 1], np.float32), (o_max, 1))
        boxes_shift = boxes.copy()
        masks = np.zeros((o_max, size, size, 1), np.float32)
        masks_shift = np.zeros_like(masks)
        attribute = np.zeros((o_max, self.attribute_dim), np.float32)
        valid = np.zeros(o_max, np.float32)

        for i, oi in enumerate(obj_idxs):
            objs[i] = self.data["object_names"][index, oi]
            x, y, w, h = self.data["object_boxes"][index, oi].astype(np.float64)
            x0, y0, x1, y1 = x / W, y / H, (x + w) / W, (y + h) / H
            boxes[i] = [x0, y0, x1, y1]
            masks[i] = _rasterize(x0, y0, x1, y1, size)
            sx0, sy0, sx1, sy1 = _shift_box(x0, y0, x1, y1)
            boxes_shift[i] = [sx0, sy0, sx1, sy1]
            masks_shift[i] = _rasterize(sx0, sy0, sx1, sy1, size)
            valid[i] = 1.0
            att_ids = self.data["object_attributes"][index, oi]
            att_ids = att_ids[att_ids >= 0]
            if len(att_ids):
                attribute[i, att_ids] = 1.0

        return {
            "imgs": img,
            "objs": objs,
            "boxes": boxes,
            "masks": masks,
            "valid": valid,
            "attribute": attribute,
            "masks_shift": masks_shift,
            "boxes_shift": boxes_shift,
        }


class Loader:
    """Threaded, prefetching batch iterator with seeded epoch shuffling."""

    def __init__(
        self,
        dataset: VgDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_threads: int = 4,
        prefetch: int = 4,
        drop_last: bool = True,
        fast_decode: bool = True,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_threads = num_threads
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.fast_decode = fast_decode

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    @property
    def batch_path(self) -> str:
        """The batch path: "native" where native/libdatapath.so loads, else "numpy"."""
        return "native" if native.load_lib() is not None else "numpy"

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        n = len(self.ds)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        nb = len(self)

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        use_native = self.batch_path == "native"

        def make_batch(bi):
            rng = np.random.RandomState((self.seed + epoch) * 100003 + bi)
            idxs = order[bi * self.batch_size : (bi + 1) * self.batch_size]
            if not use_native:
                samples = [self.ds.sample(int(i), rng) for i in idxs]
                return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            # native JPEG decode + resize + normalize for the whole batch;
            # per-file PIL fallback for anything libjpeg can't read
            paths = [
                os.path.join(self.ds.image_dir, self.ds.image_paths[int(i)])
                for i in idxs
            ]
            dec, dims, n_failed = native.decode_batch(
                paths, self.ds.image_size, fast_scale=self.fast_decode
            )
            metas = [
                self.ds.sample_meta(
                    int(i), rng, image=dec[j], W=int(dims[j, 0]), H=int(dims[j, 1])
                )
                if dims[j, 0] > 0
                else self.ds.sample_meta(int(i), rng)
                for j, i in enumerate(idxs)
            ]
            b = len(metas)
            o = self.ds.o_max
            size = self.ds.image_size
            boxes_px = np.stack([m["boxes_px"] for m in metas]).reshape(b * o, 4)
            att_ids = np.stack([m["att_ids"] for m in metas]).reshape(b * o, -1)
            valid = np.stack([m["valid"] for m in metas]).reshape(b * o)
            img_w = np.repeat([m["img_w"] for m in metas], o)
            img_h = np.repeat([m["img_h"] for m in metas], o)
            boxes, boxes_s, masks, masks_s, attribute = native.assemble_objects(
                boxes_px, img_w, img_h, att_ids, valid, self.ds.attribute_dim, size
            )
            return {
                "imgs": np.stack([m["imgs"] for m in metas]),
                "objs": np.stack([m["objs"] for m in metas]),
                "boxes": boxes.reshape(b, o, 4),
                "masks": masks.reshape(b, o, size, size, 1),
                "valid": valid.reshape(b, o),
                "attribute": attribute.reshape(b, o, self.ds.attribute_dim),
                "masks_shift": masks_s.reshape(b, o, size, size, 1),
                "boxes_shift": boxes_s.reshape(b, o, 4),
            }

        def worker(tid):
            for bi in range(tid, nb, self.num_threads):
                if stop.is_set():
                    return
                try:
                    batch = make_batch(bi)
                except Exception as e:  # handed to the consumer, which raises it
                    q.put((bi, e))
                    return
                q.put((bi, batch))

        threads = [
            threading.Thread(target=worker, args=(t,), daemon=True)
            for t in range(self.num_threads)
        ]
        for t in threads:
            t.start()
        try:
            pending = {}
            want = 0
            for _ in range(nb):
                while want not in pending:
                    bi, batch = q.get()
                    if isinstance(batch, Exception):
                        raise batch
                    pending[bi] = batch
                yield pending.pop(want)
                want += 1
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def __iter__(self):
        epoch = 0
        while True:
            yield from self.epoch(epoch)
            epoch += 1


def get_dataloaders(cfg, vocab_path: str | None = None):
    """train64.py-equivalent loader construction (reference
    get_dataloader, :224-272), with image size a real parameter."""
    vg_dir = cfg.vg_dir
    image_dir = cfg.image_dir or os.path.join(vg_dir, "images")
    with open(vocab_path or os.path.join(vg_dir, "vocab.json")) as f:
        vocab = json.load(f)
    train = VgDataset(
        os.path.join(vg_dir, "train.h5"),
        image_dir,
        vocab,
        image_size=cfg.image_size,
        max_objects=cfg.max_objects,
        attribute_dim=cfg.attribute_dim,
    )
    # reference points its "val" loader at test.h5 (:227)
    val = VgDataset(
        os.path.join(vg_dir, "test.h5"),
        image_dir,
        vocab,
        image_size=cfg.image_size,
        max_objects=cfg.max_objects,
        attribute_dim=cfg.attribute_dim,
    )
    fast = cfg.fast_decode
    return (
        Loader(train, cfg.batch_size, shuffle=True, seed=cfg.seed, fast_decode=fast),
        Loader(
            val, cfg.batch_size, shuffle=False, seed=cfg.seed, num_threads=1,
            fast_decode=fast,
        ),
        vocab,
    )
