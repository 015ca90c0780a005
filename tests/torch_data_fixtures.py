"""On-disk dataset trees for the port's data tests, laid out as the JAX
package's tests lay theirs out (tests/test_data.py, tests/test_e2e_train.py):
Ref-YouTube-VOS (JPEG frames, palette-PNG masks, h5 heatmaps), A2D
(an mp4 written by cv2.VideoWriter, h5 instance masks, the annotation csv),
JHMDB (PNG frames, a .mat puppet mask), RefCOCO (COCO-format referring
JSONs) and REFER (refs(unc).p and instances.json).  Each writer is seeded,
so the JAX package and the port read the same files.
"""
import json
import pickle

import numpy as np


def write_ytvos_tree(root, n_frames=10, h=64, w=80, seed=3, second_object=False):
    """A Ref-YTVOS train tree with one video.  ``second_object`` adds object
    2, present in the first half of the frames only, with an expression of
    its own (so some of its clips have frames without the object)."""
    import h5py
    from PIL import Image

    rng = np.random.default_rng(seed)
    video = "vid0"
    frames = [f"{i:05d}" for i in range(n_frames)]
    for sub in ("JPEGImages", "Annotations", "AnnotationsWeakly"):
        (root / "train" / sub / video).mkdir(parents=True)
    for k, name in enumerate(frames):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "train" / "JPEGImages" / video / f"{name}.jpg")
        pal = np.zeros((h, w), np.uint8)
        pal[20:40, 25:55] = 1
        heat = np.zeros((1, h, w), np.float32)
        heat[0, 18:42, 22:58] = 0.9
        obj_ids = [1]
        if second_object and k < n_frames // 2:
            pal[44:60, 5 + k:20 + k] = 2
            h2 = np.zeros((1, h, w), np.float32)
            h2[0, 42:62, 3 + k:24 + k] = rng.uniform(0.6, 1.0)
            heat = np.concatenate([heat, h2])
            obj_ids.append(2)
        Image.fromarray(pal, mode="P").save(
            root / "train" / "Annotations" / video / f"{name}.png")
        with h5py.File(root / "train" / "AnnotationsWeakly" / video / f"{name}.h5", "w") as f:
            f.create_dataset("obj_ids", data=np.asarray(obj_ids))
            f.create_dataset("heatPoint", data=heat)
            f.create_dataset("heatBBox", data=heat)
    expressions = {"0": {"exp": "a red square on the left", "obj_id": "1"}}
    if second_object:
        expressions["1"] = {"exp": "the  Small thing at the right", "obj_id": "2"}
    meta = {"videos": {video: {"frames": frames, "expressions": expressions}}}
    (root / "meta_expressions" / "train").mkdir(parents=True)
    with open(root / "meta_expressions" / "train" / "meta_expressions.json", "w") as f:
        json.dump(meta, f)
    return root


def write_a2d_tree(root, h=64, w=80, n_frames=8, split="train", point_heat=0.4):
    """An A2D-Sentences tree: one mp4 clip of the ``split`` videos,
    annotated frame 4 (1-indexed) with instance 2, reMask stored
    transposed; ``heatPoint`` is ``point_heat`` over the box (below the
    readers' 0.5 threshold by default, so point supervision finds no weak
    mask there)."""
    import cv2
    import h5py

    vid = "vidA"
    (root / "Release" / "clips320H").mkdir(parents=True)
    (root / "text_annotations" / "a2d_annotation_with_instances" / vid).mkdir(parents=True)
    rng = np.random.default_rng(1)
    writer = cv2.VideoWriter(str(root / "Release" / "clips320H" / f"{vid}.mp4"),
                             cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for _ in range(n_frames):
        writer.write((rng.random((h, w, 3)) * 255).astype(np.uint8))
    writer.release()
    mask = np.zeros((h, w), np.uint8)
    mask[20:40, 30:60] = 1
    heat = np.zeros((1, h, w), np.float32)
    heat[0, 18:42, 28:62] = 0.8
    with h5py.File(root / "text_annotations" / "a2d_annotation_with_instances"
                   / vid / "00004.h5", "w") as f:
        f.create_dataset("instance", data=np.asarray([2]))
        f.create_dataset("reMask", data=mask.T)
        f.create_dataset("heatBBox", data=heat)
        f.create_dataset("heatPoint", data=np.where(heat > 0, point_heat, 0.0).astype(np.float32))
    with open(root / "text_annotations" / "a2d_annotation.txt", "w") as f:
        f.write("video_id,instance_id,query\n")
        f.write(f"{vid},2,a person running left\n")
    with open(root / "Release" / "videoset.csv", "w") as f:
        f.write(f"{vid},x,x,x,x,x,x,x,{0 if split == 'train' else 1}\n")
    return root


def write_jhmdb_tree(root, h=48, w=64, n_frames=6):
    """A JHMDB-Sentences tree: PNG frames and a 4-frame puppet mask."""
    import scipy.io as sio
    from PIL import Image

    vid = "vidJ"
    rng = np.random.default_rng(2)
    (root / "Rename_Images" / "catch" / vid).mkdir(parents=True)
    (root / "puppet_mask" / "catch" / vid).mkdir(parents=True)
    for i in range(n_frames):
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "Rename_Images" / "catch" / vid / f"{i + 1:05d}.png")
    puppet = np.zeros((h, w, 4), np.uint8)
    puppet[10:30, 20:50, :] = 1
    sio.savemat(root / "puppet_mask" / "catch" / vid / "puppet_mask.mat", {"part_mask": puppet})
    with open(root / "jhmdb_annotation.txt", "w") as f:
        f.write("video_id,query\n")
        f.write(f"{vid},someone catching a ball\n")
    return root


def write_coco_tree(root):
    """A COCO root with train2014/ images and refcoco/+/g JSONs: one
    polygon annotation and one compressed-RLE one (encoded by the JAX
    package's codec)."""
    from PIL import Image

    from ocpg_tpu.evaluation.rle import rle_encode

    (root / "train2014").mkdir()
    rng = np.random.default_rng(1)
    for name in ("a.jpg", "b.jpg"):
        img = (rng.random((32, 40, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "train2014" / name)
    rle_mask = np.zeros((32, 40), np.uint8)
    rle_mask[6:20, 10:30] = 1
    ann = {
        "images": [{"id": 1, "file_name": "a.jpg", "height": 32, "width": 40,
                    "caption": "the red thing"},
                   {"id": 2, "file_name": "b.jpg", "height": 32, "width": 40,
                    "caption": "the Blue  one on the left"}],
        "annotations": [{"id": 1, "image_id": 1, "bbox": [4, 4, 12, 10],
                         "segmentation": [[4, 4, 16, 4, 16, 14, 4, 14]],
                         "category_id": 1},
                        {"id": 2, "image_id": 2, "bbox": [10, 6, 20, 14],
                         "segmentation": rle_encode(rle_mask),
                         "category_id": 1}],
        "categories": [{"id": 1, "name": "thing"}],
    }
    for n in ("refcoco", "refcoco+", "refcocog"):
        with open(root / f"instances_{n}_train.json", "w") as f:
            json.dump(ann, f)
    return root


def write_refer_tree(root):
    """refs(unc).p and instances.json of a refcoco dataset under ``root``."""
    refs = [
        {"ref_id": 1, "ann_id": 10, "image_id": 100, "category_id": 1, "split": "train",
         "sentences": [{"sent_id": 0, "sent": "the red dog", "tokens": ["the", "red", "dog"]},
                       {"sent_id": 1, "sent": "left animal", "tokens": ["left", "animal"]}]},
        {"ref_id": 2, "ann_id": 11, "image_id": 100, "category_id": 2, "split": "val",
         "sentences": [{"sent_id": 2, "sent": "blue box", "tokens": ["blue", "box"]}]},
        {"ref_id": 3, "ann_id": 12, "image_id": 101, "category_id": 1, "split": "testA",
         "sentences": [{"sent_id": 3, "sent": "a thing", "tokens": ["a", "thing"]}]},
    ]
    instances = {
        "images": [{"id": 100, "file_name": "a.jpg", "height": 20, "width": 30},
                   {"id": 101, "file_name": "b.jpg", "height": 16, "width": 16}],
        "annotations": [
            {"id": 10, "image_id": 100, "bbox": [2, 2, 8, 6],
             "segmentation": [[2, 2, 10, 2, 10, 8, 2, 8]], "category_id": 1},
            {"id": 11, "image_id": 100, "bbox": [12, 3, 5, 5],
             "segmentation": [[12, 3, 17, 3, 17, 8, 12, 8]], "category_id": 2},
            {"id": 12, "image_id": 101, "bbox": [1, 1, 4, 4],
             "segmentation": [[1, 1, 5, 1, 5, 5, 1, 5]], "category_id": 1}],
        "categories": [{"id": 1, "name": "dog"}, {"id": 2, "name": "box"}],
    }
    d = root / "refcoco"
    d.mkdir(parents=True)
    with open(d / "refs(unc).p", "wb") as f:
        pickle.dump(refs, f)
    with open(d / "instances.json", "w") as f:
        json.dump(instances, f)
    return root
