"""The port's inference CLIs on the CPU (``--device cpu``) against the JAX
CLIs on the same trees with the same initial weights, at the TINY widths of
tests/test_e2e_davis.py (48 x 64 frames, resize 48, max size 64).  The JAX
CLIs run through ``sys.argv`` on one CPU device
(tests/test_torch_eval_cli.jax_cli); the weights their engine holds are
carried into a port checkpoint for ``--checkpoint``.

* infer_davis (two videos of 4 frames, clip_len 3: two chunks, 2 objects x
  4 annotators, ``--visualize``) then eval_davis: every palette PNG and
  overlay written at the original size, the label maps agreeing with the
  JAX CLI's on at least 99% of pixels, the J&F of each annotator within
  0.01 of the JAX CLI's results scored the same way.
* infer_ytvos chunked (clip_len 3, ``--query_select global``) and
  whole-video (``--clip_len 0``): every ``Annotations/<video>/<exp>/<frame>.png``
  written, binary, agreeing with the JAX CLI's on at least 99% of pixels,
  and the two modes agreeing with each other on at least 99.5% (the JAX
  package's own bound, tests/test_e2e_ytvos.py).
* The helpers: ``merge_annotator_masks``, ``parse_buckets`` and
  ``load_frames`` equal to the JAX CLI's; the global query selection
  re-runs exactly the chunks whose own best query differs.
* Without ``--visualize`` the CLIs load no cv2.  A reference ``.pth``
  ``--checkpoint`` and ``--tokenizer_path`` give the JAX CLIs' masks with
  the same flags; without a GPU the default device raises.

The JAX runs are cached at module scope.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from ocpg_tpu.cli import infer_davis as jax_infer_davis
from ocpg_tpu.cli import infer_ytvos as jax_infer_ytvos

from ocpg_tpu_torch.cli import eval_davis as eval_davis_cli
from ocpg_tpu_torch.cli import infer_davis, infer_ytvos
from ocpg_tpu_torch.config import OCPGConfig, apply_config_overrides
from ocpg_tpu_torch.evaluation.davis_eval import evaluate_davis, global_summary

from tests.test_e2e_davis import TINY_CFG
from tests.test_torch_eval_cli import jax_cli, port_checkpoint
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 48, 64
FRAMES = ["00000", "00005", "00010", "00015"]
VIDEOS = ["video_a", "video_b"]
SIZE = ["--resize", "48", "--max_size", "64", "--backbone", "resnet50",
        "--config_overrides", json.dumps(TINY_CFG)]
AGREE = 0.99
JF_ATOL = 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_davis_valid(root):
    """A Ref-DAVIS valid split (tests/test_e2e_davis.py's tree): two videos of
    two moving boxes, palette PNG annotations, 2 objects x 4 annotators."""
    palette = [0, 0, 0, 236, 95, 103, 249, 145, 87] + [0] * (256 * 3 - 9)
    meta = {"videos": {}}
    for v, video in enumerate(VIDEOS):
        for d in ("valid/JPEGImages", "valid/Annotations", "Annotations"):
            (root / d / video).mkdir(parents=True)
        for t, name in enumerate(FRAMES):
            gt = np.zeros((H, W), np.uint8)
            x0 = 4 + 2 * t + 3 * v
            gt[8:28, x0:x0 + 18] = 1
            gt[24:44, 40 - t:58 - t] = 2
            rgb = np.full((H, W, 3), 40, np.uint8)
            rgb[gt == 1] = (236, 95, 103)
            rgb[gt == 2] = (87, 145, 249)
            Image.fromarray(rgb).save(root / "valid/JPEGImages" / video / f"{name}.jpg")
            img = Image.fromarray(gt, mode="P")
            img.putpalette(palette)
            img.save(root / "valid/Annotations" / video / f"{name}.png")
            img.save(root / "Annotations" / video / f"{name}.png")
        meta["videos"][video] = {"frames": FRAMES, "expressions": {
            str(i): {"exp": f"the {'red left' if i < 4 else 'blue right'} box number {i}"}
            for i in range(8)}}
    (root / "meta_expressions/valid").mkdir(parents=True)
    (root / "meta_expressions/valid/meta_expressions.json").write_text(json.dumps(meta))
    (root / "ImageSets/2017").mkdir(parents=True)
    (root / "ImageSets/2017/val.txt").write_text("\n".join(VIDEOS) + "\n")
    return root


def write_ytvos_valid(root):
    """A Ref-YTVOS valid split: two videos of 4 frames, two expressions each."""
    rng = np.random.default_rng(11)
    meta = {"videos": {}}
    for video in VIDEOS:
        (root / "valid/JPEGImages" / video).mkdir(parents=True)
        for name in FRAMES:
            Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8)).save(
                root / "valid/JPEGImages" / video / f"{name}.jpg")
        meta["videos"][video] = {"frames": FRAMES, "expressions": {
            "0": {"exp": "the red thing"}, "1": {"exp": "a person on the right"}}}
    (root / "meta_expressions/valid").mkdir(parents=True)
    (root / "meta_expressions/valid/meta_expressions.json").write_text(json.dumps(meta))
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_cli")
    return {"davis": write_davis_valid(root / "davis"),
            "ytvos": write_ytvos_valid(root / "ytvos")}


def _jax_run(module, argv, dataset_file, ckpt_dir):
    """Run a JAX inference CLI; returns a port checkpoint of its weights."""
    engines = []
    with jax_cli(argv) as (mp, _):
        init = jax_infer_davis.init_engine

        def keep(*args, **kwargs):
            model, engine = init(*args, **kwargs)
            engines.append(engine)
            return model, engine
        mp.setattr(jax_infer_davis, "init_engine", keep)
        module.main()
    cfg = apply_config_overrides(OCPGConfig(backbone="resnet50", dataset_file=dataset_file),
                                 json.dumps(TINY_CFG))
    return port_checkpoint(engines[0].params, cfg, ckpt_dir)


def _davis_argv(trees, out):
    return ["--davis_path", str(trees["davis"]), "--output_dir", str(out),
            "--clip_len", "3", "--visualize", *SIZE]


def _ytvos_argv(trees, out, clip_len):
    return ["--ytvos_path", str(trees["ytvos"]), "--output_dir", str(out),
            "--clip_len", str(clip_len), *SIZE]


@pytest.fixture(scope="module")
def jax_runs(trees, tmp_path_factory):
    """{name: (output dir, port checkpoint)} of the JAX CLIs."""
    runs = {}
    out = tmp_path_factory.mktemp("jax_davis")
    runs["davis"] = (out, _jax_run(jax_infer_davis, _davis_argv(trees, out), "davis",
                                   tmp_path_factory.mktemp("ckpt_davis")))
    for name, clip_len in (("chunked", 3), ("whole", 0)):
        out = tmp_path_factory.mktemp(f"jax_ytvos_{name}")
        runs[name] = (out, _jax_run(jax_infer_ytvos, _ytvos_argv(trees, out, clip_len),
                                    "ytvos", tmp_path_factory.mktemp(f"ckpt_{name}")))
    return runs


def _agreement(pngs_a, pngs_b):
    same = total = 0
    for a, b in zip(pngs_a, pngs_b):
        x, y = np.asarray(Image.open(a)), np.asarray(Image.open(b))
        assert x.shape == y.shape == (H, W)
        same += int((x == y).sum())
        total += x.size
    return same / total


def _davis_pngs(out):
    return [out / "valid" / f"anno_{a}" / v / f"{f}.png"
            for a in range(4) for v in VIDEOS for f in FRAMES]


def test_infer_davis_then_eval_davis_match_jax(trees, jax_runs, tmp_path):
    jax_out, ckpt = jax_runs["davis"]
    out = tmp_path / "port"
    infer_davis.main(_davis_argv(trees, out) + ["--checkpoint", ckpt, "--device", "cpu"])
    for p in _davis_pngs(out):
        img = Image.open(p)
        assert img.mode == "P" and img.size == (W, H) and np.asarray(img).max() <= 2
    for a in range(4):
        for v in VIDEOS:
            for f in FRAMES:
                vis = Image.open(out / "valid_images" / f"anno_{a}" / v / f"{f}.png")
                assert vis.mode == "RGB" and vis.size == (W, H)
    assert _agreement(_davis_pngs(out), _davis_pngs(jax_out)) >= AGREE
    for a in range(4):
        results = out / "valid" / f"anno_{a}"
        got = eval_davis_cli.main(["--davis_path", str(trees["davis"]),
                                   "--results_path", str(results)])
        want = global_summary(evaluate_davis(str(trees["davis"]),
                                             str(jax_out / "valid" / f"anno_{a}"), "val"))
        assert np.isfinite(got["J&F-Mean"])
        assert abs(got["J&F-Mean"] - want["J&F-Mean"]) <= JF_ATOL, (a, got, want)
        assert (results / "global_results-val.csv").exists()
        rows = (results / "per-sequence_results-val.csv").read_text().splitlines()
        assert len(rows) == 1 + 4                       # 2 videos x 2 objects


def _ytvos_pngs(out):
    return [out / "Annotations" / v / e / f"{f}.png"
            for v in VIDEOS for e in ("0", "1") for f in FRAMES]


@pytest.mark.parametrize("name,clip_len", [("chunked", 3), ("whole", 0)])
def test_infer_ytvos_matches_jax(name, clip_len, trees, jax_runs, tmp_path):
    jax_out, ckpt = jax_runs[name]
    out = tmp_path / "port"
    counts = infer_ytvos.main(_ytvos_argv(trees, out, clip_len)
                              + ["--checkpoint", ckpt, "--device", "cpu"])
    assert counts["requests"] == 2 * 2 * (2 if clip_len else 1)
    for p in _ytvos_pngs(out):
        assert set(np.unique(np.asarray(Image.open(p)))) <= {0, 255}
    assert _agreement(_ytvos_pngs(out), _ytvos_pngs(jax_out)) >= AGREE
    if name == "whole":
        other = tmp_path / "chunked"
        infer_ytvos.main(_ytvos_argv(trees, other, 3) + ["--checkpoint", ckpt,
                                                          "--device", "cpu"])
        assert _agreement(_ytvos_pngs(out), _ytvos_pngs(other)) > 0.995


def test_global_query_selection_reruns_the_differing_chunks():
    from ocpg_tpu_torch.engine.infer import InferRequest

    class Engine:
        # per request (Q=3, K=1) scores: expression a's chunks disagree
        last_query_scores = [np.asarray(s, np.float32)[:, None] for s in
                             ([0.9, 0.1, 0.2], [0.1, 0.8, 0.2], [0.3, 0.2, 0.4],
                              [0.1, 0.2, 0.9], [0.2, 0.1, 0.8])]

    frames = [np.zeros((t, 4, 4, 3), np.uint8) for t in (3, 1, 3, 3, 1)]
    reqs = [InferRequest(f, np.zeros(4, np.int32), np.ones(4, np.int32)) for f in frames]
    meta = [("a", 0), ("a", 1), ("b", 0), ("b", 1), ("c", 0)]
    redo = infer_ytvos.select_global_queries(Engine(), reqs, meta)
    # a: (0.9*3 + 0.1) / 4 = 0.7 for query 0 wins; its chunk 1 (argmax 1) re-runs
    # b: query 2 wins both chunks; c has one chunk
    assert redo == [1]
    assert [r.query_override for r in reqs] == [-1, 0, -1, -1, -1]


def test_helpers_match_the_jax_cli(trees):
    rng = np.random.default_rng(0)
    anno = rng.random((3, 2, 5, 7)).astype(np.float32)
    anno[1, 0, 0, 0] = anno[0, 0, 0, 0]                 # a tie: the first object
    np.testing.assert_array_equal(infer_davis.merge_annotator_masks(anno),
                                  jax_infer_davis.merge_annotator_masks(anno))
    for spec in ("exact", "serving", "default", "384x640,512x640"):
        assert infer_davis.parse_buckets(spec) == jax_infer_davis.parse_buckets(spec)
    for spec in ("384x600", "384", "axb"):
        with pytest.raises(SystemExit):
            infer_davis.parse_buckets(spec)
    img_dir = trees["davis"] / "valid" / "JPEGImages"
    for resize, max_size in ((48, 64), (360, 640), (30, 37)):
        got = infer_davis.load_frames(img_dir, VIDEOS[0], FRAMES, resize, max_size)
        want = jax_infer_davis.load_frames(img_dir, VIDEOS[0], FRAMES, resize, max_size)
        np.testing.assert_array_equal(got[0], want[0])
        assert tuple(got[1]) == tuple(want[1])


def test_inference_without_visualize_loads_no_cv2(trees, tmp_path):
    davis = ["--davis_path", str(trees["davis"]), "--output_dir", str(tmp_path / "d"),
             "--clip_len", "4", *SIZE, "--device", "cpu"]
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from ocpg_tpu_torch.cli import infer_davis, infer_ytvos\n"
        f"infer_davis.main({davis!r})\n"
        f"infer_ytvos.main({_ytvos_argv(trees, tmp_path / 'y', 4) + ['--device', 'cpu']!r})\n"
        "assert 'cv2' not in sys.modules\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stdout + res.stderr


SCORE_ATOL = 1e-4


@pytest.mark.parametrize("module", [infer_davis, infer_ytvos])
def test_unported_flags_and_the_gpu_default(module, trees, tmp_path, monkeypatch):
    """The flags that were refused before: a reference .pth ``--checkpoint``
    and ``--tokenizer_path`` (the toy vocabulary of chip_smoke.py) against
    the JAX CLI with the same flags.  infer_ytvos: the PNGs agree on at
    least 99% of pixels.  infer_davis: the per-object sigmoid scores each
    CLI merges agree within 1e-4, and the merged labels wherever no other
    candidate (background 0.1, the 0.3 floor, another object) is within
    1e-4 of the winner: the replica's seeded weights give the objects'
    scores within 1e-7 of each other almost everywhere, so their argmax is
    a tie that float32 rounding decides.  Without a GPU the default device
    raises."""
    import chip_smoke
    from tests.test_torch_pretrained import save_replica_pth

    jax_module = jax_infer_davis if module is infer_davis else jax_infer_ytvos
    vocab = tmp_path / "vocab"
    vocab.mkdir()
    chip_smoke.write_toy_vocab(str(vocab))
    save_replica_pth(tmp_path / "ref.pth")
    flags = ["--checkpoint", str(tmp_path / "ref.pth"), "--tokenizer_path", str(vocab)]
    outs, merged = {}, {"port": [], "jax": []}
    for name, mod in (("port", infer_davis), ("jax", jax_infer_davis)):
        merge = mod.merge_annotator_masks
        monkeypatch.setattr(mod, "merge_annotator_masks",
                            lambda anno, name=name, merge=merge:
                            merged[name].append(anno.copy()) or merge(anno))
    for name in ("port", "jax"):
        outs[name] = tmp_path / name
        argv = (_davis_argv(trees, outs[name]) if module is infer_davis
                else _ytvos_argv(trees, outs[name], 3)) + flags
        if name == "port":
            module.main(argv + ["--device", "cpu"])
        else:
            with jax_cli(argv):
                jax_module.main()
    if module is infer_ytvos:
        assert _agreement(_ytvos_pngs(outs["port"]), _ytvos_pngs(outs["jax"])) >= AGREE
    else:
        assert len(merged["port"]) == len(merged["jax"]) == 4 * len(VIDEOS)
        for got, want in zip(merged["port"], merged["jax"]):
            np.testing.assert_allclose(got, want, atol=SCORE_ATOL)
            floored = np.where(got < 0.3, 0.0, got)
            cand = np.sort(np.concatenate([np.full((1,) + got.shape[1:], 0.1), floored]), 0)
            decided = ((cand[-1] - cand[-2] > SCORE_ATOL)
                       & (np.abs(got - 0.3).min(0) > SCORE_ATOL))
            labels = [infer_davis.merge_annotator_masks(a) for a in (got, want)]
            np.testing.assert_array_equal(labels[0][decided], labels[1][decided])
        for png in _davis_pngs(outs["port"]):
            assert np.asarray(Image.open(png)).shape == (H, W)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            module.main(argv)
