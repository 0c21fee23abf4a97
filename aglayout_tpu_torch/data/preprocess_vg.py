"""Visual Genome ETL: raw VG JSON -> per-split h5 + vocab.json.

The port's own copy of `aglayout_tpu/data/preprocess_vg.py` (numpy and h5py only).

Capability parity with the reference's data/preprocess_vg.py (547 LoC):
same filter thresholds, same output schema (datasets: image_ids, object_ids,
object_names, object_boxes, objects_per_image, relationship_{ids, subjects,
predicates, objects}, relationships_per_image, attributes_per_object,
object_attributes, image_paths; reference :525-543), same vocab.json keys.

Notable reference behaviors preserved:
  * object vocab: names with >= min_object_instances training instances,
    '__image__' at index 0 (:223-251)
  * attribute vocab: the counted vocabulary is overridden by the fixed
    106-attribute list (:280-293) — we keep that list (it is the labels the
    released metadata and pos-weights correspond to) unless
    --use_counted_attributes is passed
  * per-object attributes: up to 30 ids padded with -1 (:470-488)
  * per-image filters: 3..30 objects, 1..30 relationships, min image side
    200, min object size 32 (:54-69)
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter, defaultdict

import numpy as np

from aglayout_tpu_torch.data.vocab import load_attribute_meta


def load_aliases(path):
    aliases = {}
    if not path or not os.path.exists(path):
        return aliases
    with open(path) as f:
        for line in f:
            parts = [s.strip() for s in line.split(",")]
            for s in parts:
                aliases[s] = parts[0]
    return aliases


def build_object_vocab(train_ids, objects, aliases, min_instances):
    train_ids = set(train_ids)
    counter = Counter()
    for image in objects:
        if image["image_id"] not in train_ids:
            continue
        for obj in image["objects"]:
            counter.update({aliases.get(n, n) for n in obj["names"]})
    names = ["__image__"] + [n for n, c in counter.most_common() if c >= min_instances]
    return {
        "object_name_to_idx": {n: i for i, n in enumerate(names)},
        "object_idx_to_name": names,
    }


def build_attribute_vocab(train_ids, attributes, min_instances, use_counted=False):
    if not use_counted:
        # the reference hardcodes this 106-entry list (:280-293); it ships in
        # our attributes_vg.json metadata
        names_map = load_attribute_meta()["attribute_names"]
        names = [None] * len(names_map)
        for n, i in names_map.items():
            names[i] = n
    else:
        train_ids = set(train_ids)
        counter = Counter()
        for image in attributes:
            if image["image_id"] not in train_ids:
                continue
            for att in image["attributes"]:
                if "attributes" in att:
                    counter.update({a.strip(" .").lower() for a in att["attributes"]})
        names = [n for n, c in counter.most_common() if c >= min_instances]
    return {
        "attribute_name_to_idx": {n: i for i, n in enumerate(names)},
        "attribute_idx_to_name": names,
    }


def build_pred_vocab(train_ids, relationships, object_id_to_obj, aliases, min_instances):
    train_ids = set(train_ids)
    counter = defaultdict(int)
    for image in relationships:
        if image["image_id"] not in train_ids:
            continue
        for rel in image["relationships"]:
            if rel["subject"]["object_id"] not in object_id_to_obj:
                continue
            if rel["object"]["object_id"] not in object_id_to_obj:
                continue
            pred = aliases.get(rel["predicate"].lower().strip(), rel["predicate"].lower().strip())
            counter[pred] += 1
    names = ["__in_image__"] + [p for p, c in counter.items() if c >= min_instances]
    return {
        "pred_name_to_idx": {n: i for i, n in enumerate(names)},
        "pred_idx_to_name": names,
    }


def filter_objects(objects, aliases, object_name_to_idx, valid_image_ids, min_object_size):
    valid_image_ids = set(valid_image_ids)
    out = {}
    for image in objects:
        if image["image_id"] not in valid_image_ids:
            continue
        for obj in image["objects"]:
            name_idx = None
            for name in obj["names"]:
                name = aliases.get(name, name)
                if name in object_name_to_idx:
                    name_idx = object_name_to_idx[name]
                    break
            if name_idx is None:
                continue
            if obj["w"] < min_object_size or obj["h"] < min_object_size:
                continue
            out[obj["object_id"]] = {
                "name_idx": name_idx,
                "box": [obj["x"], obj["y"], obj["w"], obj["h"]],
            }
    return out


def encode_split(
    image_ids,
    image_id_to_objects,
    image_id_to_relationships,
    image_id_to_attributes,
    object_id_to_obj,
    vocab,
    *,
    min_objects=3,
    max_objects=30,
    min_rels=1,
    max_rels=30,
    max_attributes=30,
):
    cols = defaultdict(list)
    att_name_to_idx = vocab["attribute_name_to_idx"]
    pred_name_to_idx = vocab["pred_name_to_idx"]
    for image_id in image_ids:
        obj_ids, names, boxes = [], [], []
        obj_id_to_idx = {}
        for obj in image_id_to_objects.get(image_id, []):
            oid = obj["object_id"]
            if oid not in object_id_to_obj:
                continue
            rec = object_id_to_obj[oid]
            obj_id_to_idx[oid] = len(obj_ids)
            obj_ids.append(oid)
            names.append(rec["name_idx"])
            boxes.append(rec["box"])
        if not (min_objects <= len(obj_ids) <= max_objects):
            continue

        rel_ids, rel_s, rel_p, rel_o = [], [], [], []
        for rel in image_id_to_relationships.get(image_id, []):
            pred_idx = pred_name_to_idx.get(rel["predicate"])
            sidx = obj_id_to_idx.get(rel["subject"]["object_id"])
            oidx = obj_id_to_idx.get(rel["object"]["object_id"])
            if pred_idx is None or sidx is None or oidx is None:
                continue
            rel_ids.append(rel["relationship_id"])
            rel_s.append(sidx)
            rel_p.append(pred_idx)
            rel_o.append(oidx)
        if not (min_rels <= len(rel_ids) <= max_rels):
            continue

        oid_to_atts = {
            a["object_id"]: a.get("attributes") for a in image_id_to_attributes.get(image_id, [])
        }
        obj_atts, n_atts = [], []
        for oid in obj_ids:
            atts = oid_to_atts.get(oid)
            ids = []
            if atts:
                for att in atts:
                    idx = att_name_to_idx.get(att.strip(" .").lower())
                    if idx is not None:
                        ids.append(idx)
                    if len(ids) >= max_attributes:
                        break
            n_atts.append(len(ids) if atts else 0)
            obj_atts.append(ids + [-1] * (max_attributes - len(ids)))

        def pad(lst, value, n):
            return lst + [value] * (n - len(lst))

        cols["image_ids"].append(image_id)
        cols["object_ids"].append(pad(obj_ids, -1, max_objects))
        cols["object_names"].append(pad(names, -1, max_objects))
        cols["object_boxes"].append(pad(boxes, [-1, -1, -1, -1], max_objects))
        cols["objects_per_image"].append(len(obj_ids))
        cols["relationship_ids"].append(pad(rel_ids, -1, max_rels))
        cols["relationship_subjects"].append(pad(rel_s, -1, max_rels))
        cols["relationship_predicates"].append(pad(rel_p, -1, max_rels))
        cols["relationship_objects"].append(pad(rel_o, -1, max_rels))
        cols["relationships_per_image"].append(len(rel_ids))
        cols["attributes_per_object"].append(pad(n_atts, -1, max_objects))
        cols["object_attributes"].append(
            pad(obj_atts, [-1] * max_attributes, max_objects)
        )
    return {k: np.asarray(v, dtype=np.int32) for k, v in cols.items()}


def main(args):
    with open(args.images_json) as f:
        images = json.load(f)
    image_id_to_image = {i["image_id"]: i for i in images}
    with open(args.splits_json) as f:
        splits = json.load(f)

    # drop images with min side < min_image_size
    for split, ids in splits.items():
        splits[split] = [
            i
            for i in ids
            if min(image_id_to_image[i]["height"], image_id_to_image[i]["width"])
            >= args.min_image_size
        ]

    obj_aliases = load_aliases(args.object_aliases)
    rel_aliases = load_aliases(args.relationship_aliases)
    with open(args.objects_json) as f:
        objects = json.load(f)
    with open(args.attributes_json) as f:
        attributes = json.load(f)
    with open(args.relationships_json) as f:
        relationships = json.load(f)
    # normalize predicates in place (aliasing) so vocab + encode agree
    for image in relationships:
        for rel in image["relationships"]:
            pred = rel["predicate"].lower().strip()
            rel["predicate"] = rel_aliases.get(pred, pred)

    train_ids = splits[args.train_split]
    vocab = {}
    vocab.update(build_object_vocab(train_ids, objects, obj_aliases, args.min_object_instances))
    vocab.update(
        build_attribute_vocab(
            train_ids, attributes, args.min_attribute_instances, args.use_counted_attributes
        )
    )
    all_ids = set()
    for ids in splits.values():
        all_ids |= set(ids)
    object_id_to_obj = filter_objects(
        objects, obj_aliases, vocab["object_name_to_idx"], all_ids, args.min_object_size
    )
    vocab.update(
        build_pred_vocab(
            train_ids, relationships, object_id_to_obj, rel_aliases, args.min_relationship_instances
        )
    )

    image_id_to_objects = {i["image_id"]: i["objects"] for i in objects}
    image_id_to_relationships = {i["image_id"]: i["relationships"] for i in relationships}
    image_id_to_attributes = {i["image_id"]: i["attributes"] for i in attributes}

    import h5py

    os.makedirs(args.output_h5_dir, exist_ok=True)
    for split, ids in splits.items():
        arrays = encode_split(
            ids,
            image_id_to_objects,
            image_id_to_relationships,
            image_id_to_attributes,
            object_id_to_obj,
            vocab,
            min_objects=args.min_objects_per_image,
            max_objects=args.max_objects_per_image,
            min_rels=args.min_relationships_per_image,
            max_rels=args.max_relationships_per_image,
            max_attributes=args.max_attributes_per_image,
        )
        path = os.path.join(args.output_h5_dir, f"{split}.h5")
        with h5py.File(path, "w") as h5:
            for name, arr in arrays.items():
                h5.create_dataset(name, data=arr)
            paths = []
            for image_id in arrays["image_ids"]:
                url = image_id_to_image[int(image_id)]["url"]
                base, filename = os.path.split(url)
                paths.append(os.path.join(os.path.basename(base), filename))
            dt = h5py.special_dtype(vlen=str)
            dset = h5.create_dataset("image_paths", (len(paths),), dtype=dt)
            for i, p in enumerate(paths):
                dset[i] = p
        print(f"{split}: {len(arrays['image_ids'])} images -> {path}")

    with open(args.output_vocab_json, "w") as f:
        json.dump(vocab, f)
    print(
        f"vocab: {len(vocab['object_idx_to_name'])} objects, "
        f"{len(vocab['attribute_idx_to_name'])} attributes, "
        f"{len(vocab['pred_idx_to_name'])} predicates"
    )


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    vg = "data/vg"
    p.add_argument("--splits_json", default=os.path.join(vg, "vg_splits.json"))
    p.add_argument("--images_json", default=os.path.join(vg, "image_data.json"))
    p.add_argument("--objects_json", default=os.path.join(vg, "objects.json"))
    p.add_argument("--attributes_json", default=os.path.join(vg, "attributes.json"))
    p.add_argument("--object_aliases", default=os.path.join(vg, "object_alias.txt"))
    p.add_argument("--relationship_aliases", default=os.path.join(vg, "relationship_alias.txt"))
    p.add_argument("--relationships_json", default=os.path.join(vg, "relationships.json"))
    p.add_argument("--min_image_size", default=200, type=int)
    p.add_argument("--train_split", default="train")
    p.add_argument("--min_object_instances", default=2000, type=int)
    p.add_argument("--min_attribute_instances", default=200, type=int)
    p.add_argument("--min_object_size", default=32, type=int)
    p.add_argument("--min_objects_per_image", default=3, type=int)
    p.add_argument("--max_objects_per_image", default=30, type=int)
    p.add_argument("--max_attributes_per_image", default=30, type=int)
    p.add_argument("--min_relationship_instances", default=500, type=int)
    p.add_argument("--min_relationships_per_image", default=1, type=int)
    p.add_argument("--max_relationships_per_image", default=30, type=int)
    p.add_argument("--use_counted_attributes", action="store_true")
    p.add_argument("--output_vocab_json", default=os.path.join(vg, "vocab.json"))
    p.add_argument("--output_h5_dir", default=vg)
    return p


if __name__ == "__main__":
    main(build_parser().parse_args())
