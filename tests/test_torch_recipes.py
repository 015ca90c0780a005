"""The port's run recipes (``ocpg_tpu_torch/scripts/recipes/*.sh``) against
the JAX package's (``scripts/*.sh``).

Every JAX recipe has a twin of the same name.  Each pair runs under bash
with fake ``python``, ``torchrun`` and ``nvidia-smi`` first on ``PATH``; the
fakes record their argv and ``OCPG_AUTO_DISTRIBUTED``.  With ``NGPUS=1``
the twin's calls are the JAX recipe's with ``ocpg_tpu.`` renamed
``ocpg_tpu_torch.``; with ``NGPUS=2`` the calls of the CLIs that run over
ranks become ``OCPG_AUTO_DISTRIBUTED=1 torchrun --standalone
--nproc_per_node 2 -m <module> ...`` and the single-process ones
(``cli.eval_davis``, ``preprocess.generate_anno``) stay ``python -m``.
``NGPUS`` left unset counts the GPUs ``nvidia-smi -L`` lists.  Every call's
arguments parse under the port module's own ``get_args``, and every twin
passes ``bash -n`` and ships as package data.
"""
import importlib
import os
import subprocess
import tomllib

import pytest

from tests.test_torch_packaging import _shipped

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DIR = os.path.join(REPO, "scripts")
PORT_DIR = os.path.join(REPO, "ocpg_tpu_torch", "scripts", "recipes")
RECIPES = sorted(f for f in os.listdir(JAX_DIR) if f.endswith(".sh"))
SINGLE_PROCESS = ("ocpg_tpu_torch.cli.eval_davis", "ocpg_tpu_torch.preprocess.generate_anno")
SEP = "\x1f"

RECORDER = f"""#!/bin/bash
{{ printf '%s' "$(basename "$0")"; printf '{SEP}%s' "$@"
   printf '{SEP}OCPG_AUTO_DISTRIBUTED=%s\\n' "${{OCPG_AUTO_DISTRIBUTED:-}}"; }} >> "$ARGV_LOG"
"""
FAKE_SMI = """#!/bin/bash
for i in $(seq 1 "${FAKE_GPUS:-0}"); do echo "GPU $((i - 1)): NVIDIA H100 80GB HBM3"; done
[ "${FAKE_GPUS:-0}" -gt 0 ]
"""


@pytest.fixture
def fakes(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, text in (("python", RECORDER), ("torchrun", RECORDER), ("nvidia-smi", FAKE_SMI)):
        (bin_dir / name).write_text(text)
        (bin_dir / name).chmod(0o755)
    return tmp_path


def run_recipe(path, fakes, **env):
    """The calls ``bash path`` makes: (program, args, OCPG_AUTO_DISTRIBUTED)."""
    log = fakes / "argv.log"
    if log.exists():
        log.unlink()
    base = {k: v for k, v in os.environ.items()
            if k not in ("NGPUS", "OCPG_BS", "OCPG_AUTO_DISTRIBUTED")}
    res = subprocess.run(["bash", path], cwd=fakes, capture_output=True, text=True, timeout=60,
                         env={**base, "PATH": f"{fakes / 'bin'}:{os.environ['PATH']}",
                              "ARGV_LOG": str(log), **env})
    assert res.returncode == 0, res.stdout + res.stderr
    calls = []
    for line in log.read_text().splitlines():
        prog, *args, dist = line.split(SEP)
        calls.append((prog, args, dist.split("=", 1)[1]))
    return calls


def expected_twin_calls(jax_calls, ngpus):
    want = []
    for prog, args, dist in jax_calls:
        assert prog == "python" and args[0] == "-m" and dist == "", (prog, args)
        module = args[1].replace("ocpg_tpu.", "ocpg_tpu_torch.", 1)
        if ngpus > 1 and module not in SINGLE_PROCESS:
            want.append(("torchrun", ["--standalone", "--nproc_per_node", str(ngpus), "-m",
                                      module, *args[2:]], "1"))
        else:
            want.append(("python", ["-m", module, *args[2:]], ""))
    return want


def parse_with_port(module, args):
    get_args = importlib.import_module(module).get_args
    return get_args(args)


def test_every_jax_recipe_has_a_twin():
    port = sorted(f for f in os.listdir(PORT_DIR) if f.endswith(".sh"))
    assert len(RECIPES) == 29
    assert port == sorted(RECIPES + ["_launch.sh"])


@pytest.mark.parametrize("ngpus", [1, 2])
@pytest.mark.parametrize("name", RECIPES)
def test_twin_runs_the_jax_recipe_on_the_port(name, ngpus, fakes):
    jax_calls = run_recipe(os.path.join(JAX_DIR, name), fakes)
    got = run_recipe(os.path.join(PORT_DIR, name), fakes, NGPUS=str(ngpus))
    assert jax_calls and got == expected_twin_calls(jax_calls, ngpus)
    for _, args, _ in got:
        at = args.index("-m")
        parse_with_port(args[at + 1], args[at + 2:])


@pytest.mark.parametrize("gpus", [0, 2])
def test_ngpus_defaults_to_the_gpus_nvidia_smi_lists(gpus, fakes):
    name = "train_ytvos_resnet101_boxsup.sh"
    jax_calls = run_recipe(os.path.join(JAX_DIR, name), fakes)
    got = run_recipe(os.path.join(PORT_DIR, name), fakes, FAKE_GPUS=str(gpus))
    assert got == expected_twin_calls(jax_calls, max(gpus, 1))


def test_batch_override_reaches_the_cli(fakes):
    name = "train_a2d_resnet101_boxsup.sh"
    [(_, args, _)] = run_recipe(os.path.join(PORT_DIR, name), fakes, NGPUS="1", OCPG_BS="1")
    assert parse_with_port(args[1], args[2:]).batch_size == 1


@pytest.mark.parametrize("name", RECIPES + ["_launch.sh"])
def test_twin_passes_bash_n(name):
    res = subprocess.run(["bash", "-n", os.path.join(PORT_DIR, name)], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 0, res.stderr


def test_twins_are_package_data():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        package_data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    for name in RECIPES + ["_launch.sh"]:
        assert _shipped(os.path.join(PORT_DIR, name), package_data), name
