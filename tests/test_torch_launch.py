"""The port's launcher against the JAX package's on one store file.

``python -m repro.launch.serve --store PATH`` serves the production
version of a ``WeightStore`` file; ``python -m repro_torch.launch.serve
--store PATH`` must serve the same weights: the same ``loaded production
version`` line and the same greedy tokens in every tier, on the CPU at
smoke size.
"""
import re

import jax
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core.weightstore import WeightStore as JaxWeightStore
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init_params

from repro_torch.launch import serve
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARGS = ["--arch", "qwen2.5-3b", "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"]


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    """A smoke qwen2.5-3b store whose production version (2) is not the
    weights either launcher would draw from its seed."""
    cfg = jax_smoke_variant(jax_get_config("qwen2.5-3b"))
    path = str(tmp_path_factory.mktemp("launch") / "qwen.db")
    store = JaxWeightStore(path)
    for seed in (0, 1):
        store.commit(cfg.name, jax_init_params(jax.random.PRNGKey(seed), cfg))
    store.close()
    return path


def _served(out):
    loaded = re.findall(r"^loaded production version \d+$", out, re.M)
    tiers = re.findall(r"^tier=\w+: .*$", out, re.M)
    return loaded, tiers


def test_store_flag_serves_the_production_version(store_path, capsys):
    jax_serve.main([*ARGS, "--store", store_path])
    want = _served(capsys.readouterr().out)
    serve.main([*ARGS, "--store", store_path, "--device", "cpu"])
    got = _served(capsys.readouterr().out)
    assert want[0] == ["loaded production version 2"]
    assert [t.split(":")[0] for t in want[1]] == ["tier=full", "tier=free"]
    assert got == want


def test_store_flag_on_a_squared_relu_config(tmp_path, capsys):
    """``--arch nemotron-4-15b`` (squared ReLU, registered through
    ``list_configs()``) at smoke size: the JAX launcher's version line and
    greedy tokens in every tier."""
    cfg = jax_smoke_variant(jax_get_config("nemotron-4-15b"))
    path = str(tmp_path / "nemotron.db")
    store = JaxWeightStore(path)
    for seed in (0, 1):
        store.commit(cfg.name, jax_init_params(jax.random.PRNGKey(seed), cfg))
    store.close()
    args = ["--arch", "nemotron-4-15b", *ARGS[2:], "--store", path]
    jax_serve.main(args)
    want = _served(capsys.readouterr().out)
    serve.main([*args, "--device", "cpu"])
    got = _served(capsys.readouterr().out)
    assert want[0] == ["loaded production version 2"] and len(want[1]) == 2
    assert got == want


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-lite-16b"])
def test_store_flag_on_a_deepseek_config(arch, tmp_path, capsys):
    """``--arch`` takes both DeepSeek configs (MoE; MoE with MLA) at smoke
    size: the JAX launcher's version line and greedy tokens in every
    tier."""
    cfg = jax_smoke_variant(jax_get_config(arch))
    path = str(tmp_path / "deepseek.db")
    store = JaxWeightStore(path)
    for seed in (0, 1):
        store.commit(cfg.name, jax_init_params(jax.random.PRNGKey(seed), cfg))
    store.close()
    args = ["--arch", arch, *ARGS[2:], "--store", path]
    jax_serve.main(args)
    want = _served(capsys.readouterr().out)
    serve.main([*args, "--device", "cpu"])
    got = _served(capsys.readouterr().out)
    assert want[0] == ["loaded production version 2"] and len(want[1]) == 2
    assert got == want


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_store_flag_on_a_recurrent_config(arch, tmp_path, capsys):
    """``--arch`` takes the recurrent family at smoke size (mamba2-130m on
    the contiguous pool, recurrentgemma-2b with its lane state and
    window): the JAX launcher's version line and greedy tokens in every
    tier."""
    cfg = jax_smoke_variant(jax_get_config(arch))
    path = str(tmp_path / "recurrent.db")
    store = JaxWeightStore(path)
    for seed in (0, 1):
        store.commit(cfg.name, jax_init_params(jax.random.PRNGKey(seed), cfg))
    store.close()
    args = ["--arch", arch, *ARGS[2:], "--store", path]
    jax_serve.main(args)
    want = _served(capsys.readouterr().out)
    serve.main([*args, "--device", "cpu"])
    got = _served(capsys.readouterr().out)
    assert want[0] == ["loaded production version 2"] and len(want[1]) == 2
    assert got == want


def test_without_store_the_port_serves_its_own_random_weights(store_path, capsys):
    """The store's weights reach the tokens: the seed's random weights
    give others, and no version line."""
    serve.main([*ARGS, "--store", store_path, "--device", "cpu"])
    stored = _served(capsys.readouterr().out)
    serve.main([*ARGS, "--device", "cpu"])
    loaded, tiers = _served(capsys.readouterr().out)
    assert loaded == [] and tiers != stored[1]


# the JAX training launcher's lines (``repro/launch/train.py`` and the log
# line of ``repro.training.train_loop``), as patterns
TRAIN_LINES = [
    r"training qwen2\.5-3b-smoke: 2L d256 vocab 512 on cpu",
    r"step +0  loss \d+\.\d{4}  gnorm \d+\.\d{3}  lr \d\.\d\de[-+]\d\d  \(\d+\.\ds\)",
    r"step +2  loss \d+\.\d{4}  gnorm \d+\.\d{3}  lr \d\.\d\de[-+]\d\d  \(\d+\.\ds\)",
    r"done: loss \d+\.\d{4} -> \d+\.\d{4} \((improved|NOT improved)\)",
    r"checkpoints: \[1, 2, 3\]",
]


def test_train_launcher_checkpoints_every_step(tmp_path, capsys):
    """``--steps 3 --store PATH --checkpoint-every 1`` on the CPU prints
    the JAX launcher's lines and leaves three checkpoints in the file."""
    from repro_torch.core.weightstore import WeightStore
    from repro_torch.launch import train

    path = str(tmp_path / "ckpt.db")
    train.main(["--arch", "qwen2.5-3b", "--steps", "3", "--batch", "2", "--seq", "8",
                "--store", path, "--checkpoint-every", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(TRAIN_LINES)
    for line, pattern in zip(lines, TRAIN_LINES):
        assert re.fullmatch(pattern, line), (line, pattern)
    store = WeightStore(path)
    assert [h["message"] for h in store.history("qwen2.5-3b-smoke")] == \
        ["step 1", "step 2", "step 3"]
    assert store.production_version("qwen2.5-3b-smoke") == 3
    store.close()
