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


def test_without_store_the_port_serves_its_own_random_weights(store_path, capsys):
    """The store's weights reach the tokens: the seed's random weights
    give others, and no version line."""
    serve.main([*ARGS, "--store", store_path, "--device", "cpu"])
    stored = _served(capsys.readouterr().out)
    serve.main([*ARGS, "--device", "cpu"])
    loaded, tiers = _served(capsys.readouterr().out)
    assert loaded == [] and tiers != stored[1]
