"""Reference checkpoints in the port: ``utils/torch_weights.py``,
``engine/checkpoint.load_pretrained_torch``, the RoBERTa tokenizer of
``models/text_encoder.py`` and ``utils/hw.py``, against the JAX package.

* Each converter gives JAX's tree key for key, array-equal, type-equal: a
  ResNet-50 body, a 2-layer RoBERTa, a Video Swin from a 2D checkpoint
  (its bias tables tiled, and bicubic-resized from another window), and
  ``convert_ocpg`` on the ResNet-50 and Video Swin ``OCPGReplica``s of
  tests/test_golden_parity_more.py; ``swin_convert_spec`` on every
  registered Swin; ``drop_class_head``; ``load_torch_file`` on its three
  layouts.
* The golden forward: a replica's ``.pth`` through
  ``load_pretrained_torch`` sets every tensor of the port's model to JAX's
  converted value, and the port's eval forward matches the replica and
  JAX's forward from JAX's ``convert_ocpg`` within the bounds of
  tests/test_golden_parity.py (logits, boxes and reference points 2e-3,
  masks 5e-3 of their scale).  Converted trees (bare, or with the FrozenBN
  stats) load as JAX loads them, and ``drop_class_heads`` keeps the heads'
  init.
* The tokenizer on the toy vocabulary of chip_smoke.py: ids and masks
  equal JAX's and chip_smoke's constants (which the card's transformers
  is held to); a bad path and out-of-range ids raise.
* ``gpu_spec`` on the H100's name and on an unknown one.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from ocpg_tpu.models import build_model as jax_build_model
from ocpg_tpu.models.text_encoder import SimpleTokenizer as JaxTokenizer
from ocpg_tpu.utils import torch_weights as jax_tw

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.engine.checkpoint import load_pretrained_torch
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
from ocpg_tpu_torch.utils import torch_weights as tw
from ocpg_tpu_torch.utils.hw import gpu_spec
from ocpg_tpu_torch.utils.weights import jax_to_state_dict

from tests.test_golden_parity import _randomize
from tests.test_golden_parity_more import SWIN_CFG, _inputs, _tiny_jax_cfg, _tiny_text_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401

LOGIT_ATOL = 2e-3
MASK_ATOL = 5e-3


def make_replica(backbone="resnet50", seed=2, text_cfg=None, **kw):
    """A seeded OCPGReplica (its state dict has the reference checkpoint's
    layout) at the widths of tests/test_golden_parity_more.py, or of ``text_cfg``
    and ``kw``."""
    from tests.torch_replica import OCPGReplica

    args = dict(enc=1, dec=2, ffn=64, queries=5)
    args.update(kw)
    if backbone == "video_swin_test":
        args["swin_cfg"] = SWIN_CFG
    replica = OCPGReplica(text_cfg or _tiny_text_cfg(), **args).eval()
    _randomize(replica, seed=seed)
    return replica


def tiny_text_config(vocab=2048):
    """The HF config of the tests' TINY_CFG text encoder (2 layers, 128 wide)."""
    from transformers import RobertaConfig as HFConfig

    return HFConfig(vocab_size=vocab, hidden_size=128, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=256,
                    max_position_embeddings=514, type_vocab_size=1, pad_token_id=1,
                    layer_norm_eps=1e-5)


def save_replica_pth(path, backbone="resnet50", seed=2):
    """A reference checkpoint (``{"model": state_dict}``) of a replica at the
    TINY_CFG widths of tests/test_e2e_*.py; returns its state dict."""
    sd = make_replica(backbone, seed, tiny_text_config()).state_dict()
    torch.save({"model": sd}, path)
    return sd


def converted_state_dict(sd, backbone):
    """JAX's ``convert_ocpg`` of a replica state dict, in the port's keys."""
    params, frozen = jax_tw.convert_ocpg(sd, enc_layers=1, dec_layers=2, backbone=backbone,
                                         text_layers=2)
    return jax_to_state_dict({"params": params, "frozen": frozen})


def assert_trees_equal(got, want, path="root"):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _swin_2d_state_dict(depths, embed, table_rows, seed):
    """A seeded 2D (ImageNet-style) Swin checkpoint, tables of table_rows rows."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    heads = [max(embed // 32, 1) * 2 ** i for i in range(len(depths))]
    sd = {"patch_embed.proj.weight": r(embed, 3, 4, 4), "patch_embed.proj.bias": r(embed),
          "patch_embed.norm.weight": r(embed), "patch_embed.norm.bias": r(embed)}
    for s, depth in enumerate(depths):
        dim = embed * 2 ** s
        for i in range(depth):
            lp = f"layers.{s}.blocks.{i}"
            for name, shape in (("norm1", (dim,)), ("norm2", (dim,)), ("attn.qkv", (3 * dim, dim)),
                                ("attn.proj", (dim, dim)), ("mlp.fc1", (4 * dim, dim)),
                                ("mlp.fc2", (dim, 4 * dim))):
                sd[f"{lp}.{name}.weight"] = r(*shape)
                sd[f"{lp}.{name}.bias"] = r(shape[0])
            sd[f"{lp}.attn.relative_position_bias_table"] = r(table_rows, heads[s])
        if s < len(depths) - 1:
            sd[f"layers.{s}.downsample.norm.weight"] = r(4 * dim)
            sd[f"layers.{s}.downsample.norm.bias"] = r(4 * dim)
            sd[f"layers.{s}.downsample.reduction.weight"] = r(2 * dim, 4 * dim)
    return sd


@pytest.fixture(scope="module")
def replicas():
    return {"resnet50": make_replica("resnet50", seed=2),
            "video_swin_test": make_replica("video_swin_test", seed=3)}


def _conversions(name, replicas):
    """(port result, JAX result) of one converter on one input."""
    if name == "resnet50_body":
        body = replicas["resnet50"].backbone[0].body.state_dict()
        return tw.convert_resnet(body, (3, 4, 6, 3)), jax_tw.convert_resnet(body, (3, 4, 6, 3))
    if name == "roberta":
        sd = replicas["resnet50"].text_encoder.text_backbone.state_dict()
        return tw.convert_roberta(sd, 2), jax_tw.convert_roberta(sd, 2)
    if name.startswith("swin_2d"):
        rows = 169 if name == "swin_2d" else 23 * 23     # 7x7 window, or bicubic from 12x12
        sd = _swin_2d_state_dict((2, 2, 6, 2), 32, rows, seed=4)
        return (tw.convert_video_swin(sd, (2, 2, 6, 2), (8, 7, 7)),
                jax_tw.convert_video_swin(sd, (2, 2, 6, 2), (8, 7, 7)))
    backbone = name.split("ocpg_")[1]
    sd = replicas[backbone].state_dict()
    kw = dict(enc_layers=1, dec_layers=2, backbone=backbone, text_layers=2)
    return tw.convert_ocpg(sd, **kw), jax_tw.convert_ocpg(sd, **kw)


@pytest.mark.parametrize("name", ["resnet50_body", "roberta", "swin_2d", "swin_2d_resized",
                                  "ocpg_resnet50", "ocpg_video_swin_test"])
def test_converter_matches_jax(name, replicas):
    got, want = _conversions(name, replicas)
    assert_trees_equal(got, want)
    if name == "swin_2d":
        table = got["stage0_block0"]["attn"]["relative_position_bias_table"]
        assert table.shape == (15 * 169, 1)


def test_swin_convert_spec_and_class_head_surgery():
    from ocpg_tpu.models.backbone_swin2d import _CONFIGS as JAX_2D
    from ocpg_tpu.models.backbone_video_swin import _CONFIGS as JAX_3D

    for name in {**JAX_3D, **JAX_2D}:
        assert tw.swin_convert_spec(name) == jax_tw.swin_convert_spec(name), name
    tree = {"class_embed_0": {"kernel": np.ones(2)}, "class_embedding": 1, "query_embed": 2}
    assert tw.drop_class_head(tree) == jax_tw.drop_class_head(tree) == {"query_embed": 2}


@pytest.mark.parametrize("layout", ["bare", "model", "state_dict"])
def test_load_torch_file_layouts(layout, tmp_path):
    sd = {"a.weight": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    obj = {"bare": sd, "model": {"model": sd, "epoch": 3},
           "state_dict": {"state_dict": sd, "optimizer": {}}}[layout]
    torch.save(obj, tmp_path / "ckpt.pth")
    for load in (tw.load_torch_file, jax_tw.load_torch_file):
        got = load(str(tmp_path / "ckpt.pth"))
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], sd[k]) for k in sd)


def _port_config(jcfg) -> OCPGConfig:
    import dataclasses

    names = {f.name for f in dataclasses.fields(OCPGConfig)}
    return OCPGConfig(**{k: getattr(jcfg, k) for k in names})


@pytest.mark.parametrize("backbone", ["resnet50", "video_swin_test"])
def test_golden_forward_through_load_pretrained_torch(backbone, replicas, tmp_path, rng):
    replica = replicas[backbone]
    sd = replica.state_dict()
    torch.save({"model": sd}, tmp_path / "ref.pth")
    jcfg = _tiny_jax_cfg(backbone=backbone)
    cfg = _port_config(jcfg)
    model = build_model(cfg, device="cpu")
    loaded = load_pretrained_torch(model, str(tmp_path / "ref.pth"), cfg,
                                   drop_class_heads=False)
    # every tensor of the model, the class heads too, holds JAX's converted value
    want = converted_state_dict(sd, backbone)
    state = model.state_dict()
    assert loaded == sorted(state) and set(want) == set(state)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)

    samples, smask, ids, mask, sizes = _inputs(rng)
    t_out = replica(*(torch.from_numpy(a) for a in (samples, smask, ids, mask, sizes)))
    port_in = (samples.transpose(0, 1, 3, 4, 2), smask, ids.astype(np.int32),
               mask.astype(np.int32), sizes)
    with torch.no_grad():
        p_out = model(*(torch.from_numpy(np.ascontiguousarray(a)) for a in port_in))
    jmodel, *_ = jax_build_model(jcfg)
    params, frozen = jax_tw.convert_ocpg(sd, enc_layers=1, dec_layers=2, backbone=backbone,
                                         text_layers=2)
    variables = {"params": params, **({"frozen": frozen} if frozen else {})}
    j_out = jax.jit(lambda v, a: jmodel.apply(v, *a, train=False))(
        variables, tuple(map(jnp.asarray, port_in)))
    keys = ["pred_logits", "pred_boxes"] + (["reference_points"] if backbone == "resnet50"
                                            else [])
    for ref_name, ref in (("replica", {k: v.numpy() for k, v in t_out.items()}),
                          ("jax", {k: np.asarray(v) for k, v in j_out.items()})):
        for k in keys:
            np.testing.assert_allclose(p_out[k].numpy(), ref[k], atol=LOGIT_ATOL,
                                       err_msg=f"{k} vs {ref_name}")
        got, m = p_out["pred_masks"].numpy(), ref["pred_masks"]
        assert got.shape == m.shape
        scale = max(np.abs(m).max(), 1e-3)
        np.testing.assert_allclose(got / scale, m / scale, atol=MASK_ATOL,
                                   err_msg=f"pred_masks vs {ref_name}")


@pytest.mark.parametrize("layout", ["raw_finetune", "tree", "bare_tree"])
def test_load_pretrained_torch_layouts_as_jax(layout, replicas, tmp_path):
    """A raw checkpoint with the class heads dropped, a converted tree with
    its FrozenBN stats, and a bare params tree (whose FrozenBN stats keep
    the init, as in JAX) load what JAX's loader loads."""
    sd = replicas["resnet50"].state_dict()
    params, frozen = jax_tw.convert_ocpg(sd, enc_layers=1, dec_layers=2, backbone="resnet50",
                                         text_layers=2)
    obj = {"raw_finetune": {"model": sd}, "tree": {"params": params, "frozen": frozen},
           "bare_tree": params}[layout]
    torch.save(obj, tmp_path / "ckpt.pth")
    cfg = _port_config(_tiny_jax_cfg())
    model = build_model(cfg, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = load_pretrained_torch(model, str(tmp_path / "ckpt.pth"), cfg,
                                   drop_class_heads=layout == "raw_finetune")
    want = converted_state_dict(sd, "resnet50")
    kept = ({k for k in init if k.startswith("class_embed_")} if layout == "raw_finetune"
            else set(jax_to_state_dict({"frozen": frozen})) if layout == "bare_tree"
            else set())
    assert (len(kept) > 0) == (layout != "tree") and loaded == sorted(set(init) - kept)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), init[k].numpy() if k in kept else want[k],
                                      err_msg=k)


# ----------------------------------------------------------------- tokenizer --
def test_tokenizer_on_the_toy_vocabulary(tmp_path):
    chip_smoke.write_toy_vocab(str(tmp_path))
    caps = list(chip_smoke.TOY_CAPTIONS)
    for vocab in (50265, chip_smoke.TOY_VOCAB_SIZE):
        got = SimpleTokenizer(str(tmp_path), max_len=chip_smoke.TOY_MAX_LEN, vocab_size=vocab)(caps)
        want = JaxTokenizer(str(tmp_path), max_len=chip_smoke.TOY_MAX_LEN, vocab_size=vocab)(caps)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], np.asarray(chip_smoke.TOY_IDS, np.int32))
    np.testing.assert_array_equal(got[1], np.asarray(chip_smoke.TOY_MASK, np.int32))
    assert (got[1] == 0).any() and (got[1].sum(1) == chip_smoke.TOY_MAX_LEN).any()


def test_tokenizer_refusals_and_hash_path(tmp_path):
    with pytest.raises(ValueError, match="definitely_missing_tokenizer"):
        SimpleTokenizer(str(tmp_path / "definitely_missing_tokenizer"))
    (tmp_path / "empty").mkdir()     # a directory without a tokenizer
    with pytest.raises(ValueError, match="empty"):
        SimpleTokenizer(str(tmp_path / "empty"))
    chip_smoke.write_toy_vocab(str(tmp_path))
    # ids of the toy vocabulary reach 271: past a 100-token table they raise
    with pytest.raises(ValueError, match="vocab_size"):
        SimpleTokenizer(str(tmp_path), vocab_size=100)(["the red blob"])
    caps = ["a red bird flying over water", "the dog on the left"]
    for g, w in zip(SimpleTokenizer(max_len=16)(caps), JaxTokenizer(max_len=16)(caps)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------------ hw --
@pytest.mark.parametrize("name,assumed", [("NVIDIA H100 80GB HBM3", False),
                                          ("NVIDIA H100 PCIe", True), ("", True)])
def test_gpu_spec(name, assumed):
    spec = gpu_spec(name)
    assert spec.assumed is assumed
    assert (spec.peak_flops_bf16, spec.peak_flops_f32, spec.hbm_bytes_per_s,
            spec.hbm_bytes) == (989e12, 67e12, 3.35e12, 80 * 1024**3)
    assert spec.kind == (name.lower() if name else "h100 80gb hbm3 (assumed)")
    if not torch.cuda.is_available():
        assert gpu_spec().assumed and gpu_spec() == chip_smoke.SPEC
    assert (chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_FLOPS_PER_S,
            chip_smoke.BF16_FLOPS_PER_S) == (3.35e12, 67e12, 989e12)
