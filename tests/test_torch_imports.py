"""The PyTorch port and chip_smoke.py import nothing of JAX: the GPU machine
has no JAX, and the port keeps its own copies of what it needs from
ocpg_tpu.  Each import runs in a fresh interpreter, so this process's own
JAX imports cannot hide one."""
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    import ocpg_tpu_torch

    names = ["ocpg_tpu_torch"]
    for info in pkgutil.walk_packages(ocpg_tpu_torch.__path__, "ocpg_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_port_has_the_slice_modules():
    mods = set(_port_modules())
    for name in ("config", "ops.ms_deform_attn", "ops._build", "ops.image",
                 "models.layers", "models.position_encoding", "models.backbone_resnet",
                 "models.text_encoder", "models.cross_modal", "models.backbone_video_swin",
                 "models.backbone_swin2d", "ops.window_attention",
                 "models.deformable_transformer", "models.mask_head", "models.ocpg",
                 "models.build", "models.matcher", "models.criterion", "data.synthetic",
                 "data.transforms", "engine.infer", "engine.optim", "engine.train",
                 "utils.weights", "utils.box_ops"):
        assert f"ocpg_tpu_torch.{name}" in mods, name


@pytest.mark.parametrize("group", ["port", "chip_smoke"])
def test_imports_load_no_jax(group):
    mods = _port_modules() if group == "port" else ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                    'transformers', 'ocpg_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")
