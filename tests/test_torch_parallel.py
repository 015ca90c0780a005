"""The port's data parallelism (``ocpg_tpu_torch/parallel``) on the CPU, in
gloo process groups of spawned ranks (``parallel.distributed.launch``,
each rank on one intra-op thread, each spawned run with its own timeout):

* the ``OCPG_*`` environment contract over two ranks, as
  tests/test_distributed_smoke.py holds the JAX package's, and no process
  group without it;
* a 2-rank ``TrainStep(mesh)`` against JAX's ``make_train_step`` jitted over
  a 2-device CPU mesh (``shard_batch`` and ``replicate``, as
  ``__graft_entry__.dryrun_multichip``): the small ResNet model of
  tests/test_torch_train_model.py on a B = 2, T = 3 batch whose rows have 3
  and 1 valid frames, with the pairwise loss, carried weights and dropout
  off, at that file's bounds (losses 1e-5 relative, grad_norm 3e-5, every
  clipped gradient and Adam first moment 1e-4 of its leaf's scale);
* ``evaluate_a2d`` (host and device postprocess, a global loader and a
  sharded ``ClipLoader``) and ``evaluate_refexp_loop`` on 2 ranks against
  1 rank, metric dicts within 1e-6, and the engine's answers to 5 requests
  of two sizes over 2 ranks against 1 rank;
* ``ClipLoader(shard=...)``: the ranks' rows together are the JAX loader's
  global batches, train and eval;
* ``dryrun_multigpu(2, "cpu")``, the mesh helpers, and the gradient
  average's bookkeeping of missing gradients.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from ocpg_tpu.config import OCPGConfig as JaxConfig
from ocpg_tpu.data import datasets as jds
from ocpg_tpu.data.loader import ClipLoader as JaxClipLoader
from ocpg_tpu.engine.optim import build_optimizer as jax_build_optimizer
from ocpg_tpu.engine.train import create_train_state
from ocpg_tpu.engine.train import make_train_step as jax_make_train_step
from ocpg_tpu.models import build_model as jax_build_model
# imported here, not first inside a jitted trace, whose tracers its module
# constants would then hold
from ocpg_tpu.models import pairwise as _jax_pairwise  # noqa: F401
from ocpg_tpu.models.criterion import compute_criterion as jax_compute_criterion

from ocpg_tpu_torch.data import datasets as pds
from ocpg_tpu_torch.data.loader import ClipLoader
from ocpg_tpu_torch.data.synthetic import synthetic_batch
from ocpg_tpu_torch.engine import evaluate
from ocpg_tpu_torch.engine.infer import ClipInferenceEngine, InferRequest
from ocpg_tpu_torch.engine.optim import build_optimizer
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.parallel import distributed, mesh as pmesh
from ocpg_tpu_torch.parallel.dryrun import dryrun_multigpu
from ocpg_tpu_torch.utils.weights import jax_to_state_dict, load_jax_params

from tests import torch_data_fixtures as fx
from tests import torch_parallel_ranks as ranks
from tests.test_torch_data import assert_batches_equal
from tests.test_torch_eval_engine import jax_config as eval_jax_config
from tests.test_torch_model import port_config, random_variables
from tests.test_torch_pairwise import smooth_frames
from tests.test_torch_train_model import (GRAD_ATOL, LOSS_RTOL, NORM_RTOL, _adam_first_moment,
                                          _jax, _jax_args, _scaled_close, _train_variables)
from tests.torch_threads import one_torch_thread  # noqa: F401

TIMEOUT = 300          # seconds for one spawned run
METRIC_ATOL = 1e-6
B, T, H, W, LT = 2, 3, 64, 96, 8


# ------------------------------------------------------------ env contract --
@pytest.mark.parametrize("contract", ["OCPG", "auto"])
def test_env_contract_over_two_processes(contract):
    """The OCPG_* contract, and OCPG_AUTO_DISTRIBUTED with torchrun's env://."""
    if contract == "OCPG":
        got = distributed.launch(ranks.env_contract, 2, timeout=TIMEOUT)
    else:
        got = distributed.launch(ranks.env_auto, 2, distributed.free_port(), timeout=TIMEOUT)
    for rank, r in enumerate(got):
        assert r["index"] == rank and r["env"] == str(rank)
        assert r["main"] == (rank == 0) and r["count"] == 2
        assert r["sum"] == 1.0 and r["mesh"] == (rank, 2)
        assert r["backend"] == "gloo" and r["device"] == "cpu"


def test_no_group_without_the_env(monkeypatch):
    for k in ("OCPG_COORDINATOR", "OCPG_NUM_PROCESSES", "OCPG_PROCESS_ID",
              "OCPG_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0 and distributed.is_main_process()
    mesh = pmesh.create_mesh(device="cpu")
    assert (mesh.group, mesh.size, mesh.rank, mesh.device.type) == (None, 1, 0, "cpu")
    with pytest.raises(ValueError):
        pmesh.create_mesh(2, device="cpu")
    monkeypatch.setenv("OCPG_NUM_PROCESSES", "2")       # half a contract
    with pytest.raises(ValueError):
        distributed.initialize_distributed(device="cpu")


def test_backend_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed.choose_backend("cuda", 4) == "nccl"
    assert distributed.choose_backend("cuda", 8) == "gloo"     # ranks share cards
    assert distributed.choose_backend("cpu", 1) == "gloo"


def test_launch_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1"):
        distributed.launch(_fail_on_rank_1, 2, timeout=TIMEOUT)


def _fail_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


# ---------------------------------------------------------- mesh helpers --
def test_mesh_helpers_slice_rows():
    mesh = pmesh.Mesh(None, 2, 1, torch.device("cpu"))
    batch = {"samples": np.arange(8).reshape(4, 2), "real_count": 3,
             "targets": {"size": np.arange(8).reshape(4, 2)}, "orig_masks": [0, 1, 2, 3]}
    local = pmesh.shard_batch(mesh, batch)
    np.testing.assert_array_equal(local["samples"].numpy(), [[4, 5], [6, 7]])
    np.testing.assert_array_equal(local["targets"]["size"].numpy(), [[4, 5], [6, 7]])
    assert local["real_count"] == 3 and local["orig_masks"] == [2, 3]
    spec = pmesh.batch_pspec(mesh, batch)
    assert spec["samples"] == slice(2, 4) and spec["real_count"] is None
    with pytest.raises(ValueError):
        mesh.rows(3)
    (host, dev), = list(pmesh.prefetch_to_mesh(iter([batch]), mesh))
    assert host is batch and dev["samples"].tolist() == [[4, 5], [6, 7]]
    one = pmesh.Mesh(None, 1, 0, torch.device("cpu"))
    t = torch.arange(4.0)
    assert pmesh.gather_rows(one, t) is t and pmesh.gather_objects(one, 5) == [5]


def test_average_grads_keeps_missing_gradients_missing():
    cfg = port_config(_train_jax_cfg())
    model = build_model(cfg, device="cpu")
    opt = build_optimizer(model, cfg, lr_scale=2.0)
    assert {g["lr"] for g in opt.adamw.param_groups} >= {2 * cfg.lr}
    params = opt.params
    for i, p in enumerate(params):
        p.grad = None if i % 3 == 0 else torch.full_like(p, float(i))
    opt.average_grads_(pmesh.Mesh(None, 1, 0, torch.device("cpu")))
    for i, p in enumerate(params):
        if i % 3 == 0:
            assert p.grad is None
        else:
            assert torch.equal(p.grad, torch.full_like(p, float(i)))


def test_average_grads_leaves_each_gradient_in_its_own_tensor():
    """The means land in the tensors the backward made, so the clip and
    AdamW read the same layout as without a mesh (a view into the flat
    buffer can start off a 16-byte boundary, where a foreach norm sums in
    another order)."""
    cfg = port_config(_train_jax_cfg())
    model = build_model(cfg, device="cpu")
    opt = build_optimizer(model, cfg)
    for i, p in enumerate(opt.params):
        p.grad = torch.full_like(p, float(i) - 0.5)
    before = [(p.grad, p.grad.data_ptr()) for p in opt.params]
    opt.average_grads_(pmesh.Mesh(None, 1, 0, torch.device("cpu")))
    for i, (p, (g, ptr)) in enumerate(zip(opt.params, before)):
        assert p.grad is g and p.grad.data_ptr() == ptr
        assert torch.equal(p.grad, torch.full_like(p, float(i) - 0.5))


# ------------------------------------------------------------ train step --
def _train_jax_cfg():
    return JaxConfig(backbone="resnet50", enc_layers=1, dec_layers=2, dim_feedforward=64,
                     num_queries=5, num_frames=T, compute_dtype="float32",
                     dataset_file="ytvos", text_layers=2, text_hidden=128, text_heads=4,
                     text_ffn=256, text_vocab=1000, text_max_pos=40, msda_impl="xla",
                     pairwise_loss=True)


def _train_batch():
    batch = synthetic_batch(np.random.default_rng(11), batch=B, frames=T, height=H, width=W,
                            text_len=LT, vocab_size=1000)
    batch["samples_mask"][..., -16:] = True
    batch["targets"]["size"][:] = (H, W - 16)
    batch["text_mask"][:, -2:] = 0
    batch["text_ids"][:, -2:] = 1
    # rows with 3 and 1 valid frames: the global box count is 4, a rank's 3 or 1
    batch["targets"]["valid"][:] = np.asarray([[1, 1, 1], [1, 0, 0]], np.int32)
    # smooth frames and one box over row 0's clip, so the temporal pairwise
    # terms have weight
    batch["samples"] = smooth_frames(np.random.default_rng(12), B, T, H, W)
    batch["targets"]["boxes"][0] = batch["targets"]["boxes"][0, :1]
    return batch


@pytest.fixture(scope="module")
def jax_mesh_step():
    """JAX's train step and gradients jitted over a 2-device CPU mesh."""
    jcfg = _train_jax_cfg()
    jmodel, _, crit_cfg, weight_dict = jax_build_model(jcfg)
    batch = _train_batch()
    variables = _train_variables(jmodel, batch, seed=2)
    mesh = JaxMesh(np.asarray(jax.devices("cpu")[:2]), ("data",))
    repl = NamedSharding(mesh, P())

    def shard(x):
        x = jnp.asarray(x)
        return jax.device_put(x, NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))))

    sharded = jax.tree_util.tree_map(shard, batch)
    optimizer = jax_build_optimizer(jcfg, lr_drop_steps=[1000])
    state = jax.device_put(create_train_state(_jax(variables), optimizer), repl)
    step = jax_make_train_step(jmodel, crit_cfg, weight_dict, optimizer, deterministic=True)
    with mesh:
        new_state, metrics = jax.jit(step)(state, sharded)

    def loss_fn(params, frozen):
        out = jmodel.apply({"params": params, "frozen": frozen}, *_jax_args(sharded),
                           targets=sharded["targets"], train=True, deterministic=True)
        return jax_compute_criterion(crit_cfg, weight_dict, out, sharded["targets"],
                                     jnp.asarray(0))[0]

    with mesh:
        grads = jax.jit(jax.grad(loss_fn))(state.params["params"], state.params["frozen"])
    return dict(cfg=port_config(jcfg), variables=variables, batch=batch,
                metrics={k: float(v) for k, v in metrics.items()},
                mu=_adam_first_moment(new_state.opt_state),
                grads=jax.tree_util.tree_map(np.asarray, grads))


def test_two_rank_train_step_matches_jax_mesh_step(jax_mesh_step):
    ref = jax_mesh_step
    got = distributed.launch(ranks.train_step, 2, ref["cfg"], ref["variables"], ref["batch"],
                             timeout=TIMEOUT)
    for r in got:
        assert r["step"] == 1 and r["metrics"]["finite"] == 1.0
    # the ranks hold the same metrics and, after the all-reduce, the same gradients
    assert got[0]["metrics"] == got[1]["metrics"]
    for name, g in got[0]["grads"].items():
        np.testing.assert_array_equal(g, got[1]["grads"][name], err_msg=name)
    metrics = got[0]["metrics"]
    for k, v in ref["metrics"].items():
        if k in ("grad_norm", "finite"):
            continue
        np.testing.assert_allclose(metrics[k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert "loss_pairwise" in metrics and metrics["loss_pairwise_neighbor"] > 0

    leaves = jax.tree_util.tree_leaves(ref["grads"])
    jax_norm = float(optax.global_norm(leaves))
    np.testing.assert_allclose(metrics["grad_norm"], jax_norm, rtol=NORM_RTOL)
    np.testing.assert_allclose(metrics["grad_norm"], ref["metrics"]["grad_norm"],
                               rtol=NORM_RTOL)
    clip = min(1.0, ref["cfg"].clip_max_norm / jax_norm)
    want = jax_to_state_dict({"params": ref["grads"]})
    assert set(want) == set(got[0]["grads"])
    for name, g in want.items():
        _scaled_close(got[0]["grads"][name], g * clip, GRAD_ATOL, name)
    assert got[0]["mu"] and set(got[0]["mu"]) <= set(ref["mu"])
    for name, m in got[0]["mu"].items():
        _scaled_close(m, ref["mu"][name], GRAD_ATOL, f"exp_avg {name}")


# ------------------------------------------------------- eval and engine --
@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_eval")
    from ocpg_tpu_torch.models.text_encoder import SimpleTokenizer
    from ocpg_tpu_torch.data.refexp import RefExpDataset
    from tests.test_e2e_evaluate import TINY_CFG

    tok = SimpleTokenizer(vocab_size=TINY_CFG["text_vocab"])
    trees = {"a2d": str(fx.write_a2d_tree(root / "a2d", split="val")),
             "jhmdb": str(fx.write_jhmdb_tree(root / "jhmdb"))}
    (root / "coco").mkdir()
    coco = fx.write_coco_tree(root / "coco")
    sets = {"a2d": build_dataset_("a2d", trees["a2d"]),
            "jhmdb": build_dataset_("jhmdb", trees["jhmdb"]),
            "refcoco": RefExpDataset(str(coco / "train2014"),
                                     str(coco / "instances_refcoco_train.json"))}
    batches = {}
    for name, ds in sets.items():
        # 3 samples in batches of 2: on 2 ranks the tail's second row is all padding
        loader = ClipLoader(ranks.Repeat(ds, 3), 2, tokenizer=tok, train=False,
                            canvas=(64, 80), compact=True, num_workers=1)
        batches[name] = list(loader.epoch(0))
    models = {}
    for name, file in (("a2d", "a2d"), ("refcoco", "refcoco"), ("ytvos", "ytvos")):
        jcfg = eval_jax_config(file)
        jmodel, *_ = jax_build_model(jcfg)
        models[name] = (port_config(jcfg), random_variables(jmodel, seed=3))
    rng = np.random.default_rng(7)
    requests = [InferRequest(frames=rng.integers(0, 255, (2, 40 + 24 * (i % 2), 64 * (1 + i % 2),
                                                          3), dtype=np.uint8),
                             text_ids=np.asarray(batches["a2d"][0]["text_ids"][0]),
                             text_mask=np.asarray(batches["a2d"][0]["text_mask"][0]))
                for i in range(5)]
    return dict(trees=trees, batches=batches, models=models, requests=requests, tok=tok)


def build_dataset_(name, root):
    return pds.build_dataset(name, root, "val", 3)


def _model(spec):
    cfg, weights = spec
    model = build_model(cfg, device="cpu")
    load_jax_params(model, weights)
    return model


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=METRIC_ATOL, rtol=0, err_msg=k)


def test_eval_and_engine_on_two_ranks_match_one(eval_setup):
    s = eval_setup
    got = distributed.launch(ranks.eval_and_engine, 2, s["models"], s["batches"], s["trees"],
                             s["requests"], timeout=TIMEOUT)
    a2d, refcoco = _model(s["models"]["a2d"]), _model(s["models"]["refcoco"])
    for tree in ("a2d", "jhmdb"):
        for post in ("host", "device"):
            want = evaluate.evaluate_a2d(a2d, ranks.Batches(s["batches"][tree]),
                                         postprocess=post, device="cpu")
            for r in got:
                _assert_metrics(r[(tree, post)], want)
    want = evaluate.evaluate_refexp_loop(refcoco, ranks.Batches(s["batches"]["refcoco"]),
                                         device="cpu")
    for r in got:
        _assert_metrics(r["refcoco"], want)
    ds = ranks.Repeat(build_dataset_("jhmdb", s["trees"]["jhmdb"]), 3)
    loader = ClipLoader(ds, 2, tokenizer=s["tok"], train=False, canvas=(64, 80),
                        compact=True, num_workers=1)
    want = evaluate.evaluate_a2d(a2d, loader, device="cpu")
    for r in got:
        _assert_metrics(r["sharded_loader"], want)

    engine = ClipInferenceEngine(_model(s["models"]["ytvos"]), clip_len=2,
                                 buckets=((64, 64), (64, 128)), slots=1, device="cpu")
    want = engine.run(s["requests"])
    for r in got:
        # 5 requests, 3 and 2 per bucket: 2 + 1 dispatches of 2 slots, one padded
        assert r["engine_dispatches"] == 3
        assert len(r["engine"]) == len(want)
        for g, w, req in zip(r["engine"], want, s["requests"]):
            assert g.shape == req.frames.shape[:3]
            np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------------- loader --
@pytest.fixture(scope="module")
def ytvos_root(tmp_path_factory):
    return fx.write_ytvos_tree(tmp_path_factory.mktemp("ytvos_shard"), n_frames=6,
                               second_object=True)


@pytest.fixture(scope="module")
def jhmdb_root(tmp_path_factory):
    return str(fx.write_jhmdb_tree(tmp_path_factory.mktemp("jhmdb_shard")))


def _assert_shards_make(shards, want, global_batch):
    b = global_batch // len(shards)
    assert all(len(s) == len(want) for s in shards)
    for k, w in enumerate(want):
        parts = [s[k] for s in shards]
        real = int(w.get("real_count", global_batch))
        assert [int(p.get("real_count", b)) for p in parts] == [
            min(max(real - b * r, 0), b) for r in range(len(shards))]
        union = _concat_rows(parts)
        union.pop("real_count", None)
        w = dict(w)
        w.pop("real_count", None)
        assert_batches_equal(union, w)


def test_sharded_train_loader_rows_make_the_jax_global_batch(ytvos_root):
    """Train: 12 clips in global batches of 4 over 2 ranks, 2 workers; each
    row's random draws follow the rows before it in the worker's stream."""
    kw = dict(batch_size=4, canvas=(256, 320), train=True, seed=5, num_workers=2,
              text_vocab=2048, compact=True)
    want = list(JaxClipLoader(jds.YTVOSDataset(str(ytvos_root), num_frames=2), **kw).epoch(1))
    shards = [list(ClipLoader(pds.YTVOSDataset(str(ytvos_root), num_frames=2), shard=(r, 2),
                              **kw).epoch(1)) for r in range(2)]
    assert len(want) == 3
    _assert_shards_make(shards, want, 4)


def _annotated_frame_targets(batch):
    """A JAX batch of one-frame clips (JHMDB, A2D) as the port's loader
    carries it: JAX repeats the annotated frame's maps over the clip's
    frames, the port keeps them once."""
    tg = dict(batch["targets"])
    for k in ("masks", "weak_masks", "weights"):
        assert (tg[k] == tg[k][:, :1]).all(), k
        tg[k] = tg[k][:, :1]
    return {**batch, "targets": tg}


def test_sharded_eval_loader_rows_make_the_jax_global_batch(jhmdb_root):
    """Eval: 6 JHMDB clips in global batches of 4 over 2 ranks; the tail
    holds 2 real rows, so rank 1's rows are all padding (real_count 0)."""
    kw = dict(batch_size=4, canvas=(64, 80), train=False, num_workers=1, text_vocab=2048,
              compact=True)
    want = list(JaxClipLoader(ranks.Repeat(jds.build_dataset("jhmdb", jhmdb_root, "val", 3), 6),
                              **kw).epoch(0))
    want = [_annotated_frame_targets(w) for w in want]
    shards = [list(ClipLoader(ranks.Repeat(build_dataset_("jhmdb", jhmdb_root), 6),
                              shard=(r, 2), **kw).epoch(0)) for r in range(2)]
    assert len(want) == 2 and want[-1]["real_count"] == 2
    assert shards[1][-1]["real_count"] == 0
    _assert_shards_make(shards, want, 4)


def _concat_rows(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _concat_rows([p[k] for p in parts]) for k in first}
    if isinstance(first, list):
        return [x for p in parts for x in p]
    if isinstance(first, np.ndarray):
        return np.concatenate(parts)
    return first


def test_sharded_loader_refuses_an_uneven_split(ytvos_root):
    with pytest.raises(ValueError):
        ClipLoader(pds.YTVOSDataset(str(ytvos_root)), batch_size=3, shard=(0, 2),
                   text_vocab=2048)


# ----------------------------------------------------------------- dry run --
def test_dryrun_multigpu_on_two_cpu_ranks():
    results = dryrun_multigpu(2, "cpu", timeout=TIMEOUT)
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["world"] == 2 and np.isfinite(r["loss"]) and r["eval_masks"][0] == 2
        assert r["requests"] == 5 and r["dispatches"] == 3
        # the plain versions run on the CPU: no kernel launches
        assert r["launches"] == {"K1": 0, "K2": 0, "K7": 0}
    assert results[0]["loss"] == results[1]["loss"]
    assert os.environ.get("OCPG_PROCESS_ID") is None       # the parent joined no group
