"""The port's eval forward against JAX's at ``__graft_entry__.entry()``'s
shapes: ``a2d_r101_boxsup`` with 4+4 layers at full width (ResNet-101,
RoBERTa-base), one 5 x 256 x 448 synthetic clip (``data/synthetic.py``,
seed 0), ``valid_indices`` 0, the weights of the JAX model's own init
(``PRNGKey(0)``) carried by ``load_jax_params``.  Both run in float32 (the
preset's bf16 would bound the comparison by bf16 rounding), the JAX side
through the XLA gather MSDA, the port's through the plain version.  The
bounds are tests/test_torch_model.py's: logits and boxes 2e-3, masks 5e-3
of their largest magnitude.

Marked slow: a full-width JAX compile and two full-width forwards on the
CPU take minutes, and tier-1 keeps its time for the small-width parity
tests (tests/test_torch_model.py holds the same forward at small widths).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ocpg_tpu.config import a2d_r101_boxsup
from ocpg_tpu.data.synthetic import synthetic_batch
from ocpg_tpu.models import build_model as jax_build_model

from ocpg_tpu_torch.config import OCPGConfig
from ocpg_tpu_torch.models.build import build_model
from ocpg_tpu_torch.utils.weights import load_jax_params

LOGIT_ATOL = 2e-3
MASK_ATOL = 5e-3


def eval_forward_parity(jcfg, frames, height, width):
    """Runs both eval forwards on one synthetic clip; returns the JAX and
    the port outputs as numpy dicts."""
    jmodel, *_ = jax_build_model(jcfg)
    batch = synthetic_batch(np.random.default_rng(0), batch=1, frames=frames, height=height,
                            width=width, vocab_size=jcfg.text_vocab)
    names = ("samples", "samples_mask", "text_ids", "text_mask")
    args = tuple(jnp.asarray(batch[k]) for k in names) + (
        jnp.asarray(batch["targets"]["size"]),)
    vidx = jnp.zeros((1,), jnp.int32)
    variables = jax.jit(lambda: jmodel.init(jax.random.PRNGKey(0), *args, valid_indices=vidx,
                                            train=False))()
    want = jax.jit(lambda v: jmodel.apply(v, *args, valid_indices=vidx, train=False))(variables)

    fields = {f.name for f in dataclasses.fields(OCPGConfig)}
    model = build_model(OCPGConfig(**{k: getattr(jcfg, k) for k in fields}), device="cpu")
    load_jax_params(model, jax.tree_util.tree_map(np.array, variables))
    with torch.no_grad():
        got = model(*(torch.from_numpy(np.asarray(batch[k])) for k in names),
                    torch.from_numpy(batch["targets"]["size"]),
                    valid_indices=torch.zeros((1,), dtype=torch.int32))
    keys = ("pred_logits", "pred_boxes", "pred_masks")
    return ({k: np.asarray(want[k], np.float32) for k in keys},
            {k: got[k].float().numpy() for k in keys})


def assert_outputs_close(got, want):
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(got[k], want[k], atol=LOGIT_ATOL, err_msg=k)
    assert got["pred_masks"].shape == want["pred_masks"].shape
    scale = max(float(np.abs(want["pred_masks"]).max()), 1e-3)
    np.testing.assert_allclose(got["pred_masks"] / scale, want["pred_masks"] / scale,
                               atol=MASK_ATOL)


@pytest.mark.slow
def test_eval_forward_matches_jax_at_graft_entry_shapes():
    jcfg = a2d_r101_boxsup().replace(enc_layers=4, dec_layers=4, compute_dtype="float32",
                                     msda_impl="xla")
    want, got = eval_forward_parity(jcfg, frames=5, height=256, width=448)
    assert want["pred_masks"].shape == (1, 1, jcfg.num_queries, 256, 448)
    assert_outputs_close(got, want)
