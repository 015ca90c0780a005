"""The port's Swin train step with per-block recompute (``use_checkpoint``:
the port's ``torch.utils.checkpoint``, JAX's ``nn.remat``) against the JAX
step on the CPU, at the bounds of tests/test_torch_swin_train.py (which
holds the step without recompute; this file is apart to keep each file's
time short)."""
import pytest

from ocpg_tpu.models import build_model as jax_build_model

from tests.test_torch_swin_train import _swin_cfg, check_swin_train_step
from tests.test_torch_train_model import _batch, _train_variables
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    jmodel, *_ = jax_build_model(_swin_cfg(use_checkpoint=True))
    batch = _batch(seed=6)
    return dict(batch=batch, variables=_train_variables(jmodel, batch, seed=8))


def test_swin_train_step_with_recompute_matches_jax(weights):
    check_swin_train_step(weights, use_checkpoint=True)
