"""Input-pipeline benchmark: batches/s of the Visual Genome `Loader`.

    python -m aglayout_tpu_torch.data.bench_loader [--n_images 200] [--batch_size 8]
        [--image_size 128] [--workers 4] [--batches 40]

Builds a synthetic Visual Genome corpus under build/ (JPEGs at VG's usual
500 x 375, six objects and three relationships an image), runs the port's
ETL (`data/preprocess_vg.py`) over it, and times the runtime `Loader`
(threaded decode and dense batch assembly) on the native batch path
(native/libdatapath.so, fast_decode on) and on the NumPy one, on the host
clock after 4 warm-up batches. Prints one JSON line: batches/s and
images/s of each path, the host's CPU count, and the synthetic stream's ms
a batch (`synthetic_batch`, what `--synthetic` trains on). The corpus is
deleted after. A host measurement: no device runs here. Needs h5py and PIL.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import time
from unittest import mock

import numpy as np

BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "build")


def build_corpus(root: str, n_images: int, seed: int = 0):
    """The raw corpus (JSON and JPEGs) of `n_images` images in `root`."""
    from PIL import Image

    from aglayout_tpu_torch.data.split_vg import make_splits

    img_dir = os.path.join(root, "images", "VG_100K")
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    names = [f"cls{i}" for i in range(40)]
    atts = [f"att{i}" for i in range(20)]
    images, objects, attributes, relationships = [], [], [], []
    oid = 1000
    for i in range(n_images):
        image_id = i + 1
        w, h = 500, 375
        # a structured image: a JPEG of pure noise decodes unrealistically slowly
        base = np.zeros((h, w, 3), np.uint8)
        base[:] = rng.randint(0, 255, 3, dtype=np.uint8)
        for _ in range(6):
            x0, y0 = rng.randint(0, w - 60), rng.randint(0, h - 60)
            base[y0:y0 + 60, x0:x0 + 60] = rng.randint(0, 255, 3, dtype=np.uint8)
        Image.fromarray(base).save(os.path.join(img_dir, f"{image_id}.jpg"), quality=85)
        images.append({"image_id": image_id, "width": w, "height": h,
                       "url": f"https://x/VG_100K/{image_id}.jpg"})
        objs, rels, att_recs = [], [], []
        for j in range(6):
            objs.append({"object_id": oid, "names": [names[(i + j) % len(names)]],
                         "x": 10 + 40 * j, "y": 15 + 30 * j, "w": 100, "h": 110})
            att_recs.append({"object_id": oid, "attributes": [atts[(i + j) % len(atts)]]})
            oid += 1
        for j in range(3):
            rels.append({"relationship_id": oid * 10 + j, "predicate": "on",
                         "subject": {"object_id": objs[j]["object_id"]},
                         "object": {"object_id": objs[j + 1]["object_id"]}})
        objects.append({"image_id": image_id, "objects": objs})
        attributes.append({"image_id": image_id, "attributes": att_recs})
        relationships.append({"image_id": image_id, "relationships": rels})
    for name, data in [("image_data.json", images), ("objects.json", objects),
                       ("attributes.json", attributes), ("relationships.json", relationships)]:
        with open(os.path.join(root, name), "w") as f:
            json.dump(data, f)
    with open(os.path.join(root, "vg_splits.json"), "w") as f:
        json.dump(make_splits([im["image_id"] for im in images], seed=0, train_frac=0.9), f)


def run_etl(root: str):
    """The port's ETL over the corpus in `root`: train/test/val h5 and vocab.json."""
    from aglayout_tpu_torch.data import preprocess_vg

    j = lambda name: os.path.join(root, name)  # noqa: E731
    preprocess_vg.main(preprocess_vg.build_parser().parse_args([
        "--splits_json", j("vg_splits.json"), "--images_json", j("image_data.json"),
        "--objects_json", j("objects.json"), "--attributes_json", j("attributes.json"),
        "--relationships_json", j("relationships.json"),
        "--object_aliases", "", "--relationship_aliases", "",
        "--min_image_size", "100", "--min_object_instances", "5",
        "--min_attribute_instances", "1", "--min_object_size", "16",
        "--min_objects_per_image", "2", "--min_relationship_instances", "1",
        "--use_counted_attributes",
        "--output_vocab_json", j("vocab.json"), "--output_h5_dir", root,
    ]))


def batches_per_sec(loader, batches: int, warmup: int = 4) -> float:
    it = iter(loader)
    for _ in range(warmup):
        next(it)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(it)
    return batches / (time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_images", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batches", type=int, default=40)
    args = p.parse_args(argv)

    from aglayout_tpu_torch.data import native
    from aglayout_tpu_torch.data.dataset import Loader, VgDataset
    from aglayout_tpu_torch.data.synthetic import synthetic_batch

    root = os.path.abspath(os.path.join(BUILD, "bench_loader_corpus"))
    shutil.rmtree(root, ignore_errors=True)
    try:
        build_corpus(root, args.n_images)
        run_etl(root)
        with open(os.path.join(root, "vocab.json")) as f:
            vocab = json.load(f)
        ds = VgDataset(os.path.join(root, "train.h5"), os.path.join(root, "images"), vocab,
                       image_size=args.image_size)
        result = {"image_size": args.image_size, "batch_size": args.batch_size,
                  "workers": args.workers, "train_images": len(ds), "host_cpus": os.cpu_count(),
                  "clock": "host (no device in this measurement)"}
        paths = ["native", "numpy"] if native.load_lib() is not None else ["numpy"]
        for path in paths:
            # the NumPy path: the loader as it runs where the library does not load
            with mock.patch.object(native, "load_lib", lambda: None) if path == "numpy" \
                    else contextlib.nullcontext():
                loader = Loader(ds, args.batch_size, shuffle=True, seed=0,
                                num_threads=args.workers)
                if loader.batch_path != path:
                    raise RuntimeError(f"the loader took the {loader.batch_path} path")
                rate = batches_per_sec(loader, min(args.batches, len(loader) - 4))
            result[f"{path}_batches_per_sec"] = round(rate, 2)
            result[f"{path}_images_per_sec"] = round(rate * args.batch_size, 1)
        if "native" not in paths:
            result["native"] = native.load_error()
        rng = np.random.RandomState(0)
        synthetic_batch(rng, args.batch_size, 10, args.image_size)
        t0 = time.perf_counter()
        for _ in range(10):
            synthetic_batch(rng, args.batch_size, 10, args.image_size)
        result["synthetic_ms_per_batch"] = round((time.perf_counter() - t0) * 100, 2)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
