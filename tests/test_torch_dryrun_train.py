"""The dry run's train rows run the JAX jit site's step, on the CPU:
``make_train_step`` with AdamW over params placed by
``params_shardings``, moments by ``opt_state_shardings`` (ZeRO-1) and a
data-sharded batch, all ``meta`` DTensors on torch's fake world (made
in a fixture, destroyed at teardown).

On a (2, 2) world, qwen2.5-3b's smoke variant at 8 rows x 16 tokens and
``grad_accum`` 4: the row's collectives, kind by kind, are those of an
``OpCostMode`` run around ``make_train_step`` on the same placed trees,
and more than ``lm_loss`` forward and backward alone issue; its flops
are the unsharded row's and ``lm_loss`` forward and backward's at any
``grad_accum``; its resident bytes grow by the f32 accumulators' local
shards.  musicgen-large's 16-token train row runs on (2, 2) (LayerNorm's
backward under DTensor).  At 64 rows on a (16, 16) world the 4
micro-batches cannot keep the batch's 16-way shard, and the row still
runs, and so does nemotron-4-15b's attention at 64 rows on (16, 16),
whose q, k and v arrive as pending sums.  ``run_combo`` runs train
shapes at ``GRAD_ACCUM`` (4), as the JAX dry run compiles them.
"""
import pytest
import torch
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core.pytree_io import flatten_params
from repro_torch.distribution import sharding as shd
from repro_torch.launch import dryrun, mesh as mesh_lib, op_cost, shapes
from repro_torch.models import model as model_lib
from repro_torch.training import OptimizerConfig, init_state, make_train_step
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPE = shapes.InputShape("s_train", "train", 16, 8)
ACCUM = 4


@pytest.fixture
def mesh22():
    from torch.distributed.device_mesh import init_device_mesh

    mesh_lib.fake_world(4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


def _placed(cfg, mesh):
    """The row's params, AdamW state and batch as ``meta`` DTensors."""
    _, spec = shapes.input_specs(cfg, SHAPE)
    params = model_lib.init_params(cfg, device="meta")
    state = init_state(params)
    batch = spec["batch"]
    return (shd.distribute_tree(params, shd.params_shardings(params, mesh, cfg), mesh),
            shd.distribute_tree(state, shd.opt_state_shardings(state, params, mesh), mesh),
            shd.distribute_tree(batch, shd.data_shardings(batch, mesh), mesh))


def test_train_row_counts_the_train_steps_collectives(mesh22):
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    rep = dryrun.dry_run(cfg, SHAPE, mesh=mesh22, grad_accum=ACCUM)
    assert rep["grad_accum"] == ACCUM and rep["step_kind"] == "train"

    params, state, batch = _placed(cfg, mesh22)
    step = make_train_step(cfg, OptimizerConfig(grad_accum=ACCUM))
    with implicit_replication(), op_cost.OpCostMode() as cost:
        step(params, state, batch)
    coll = cost.collectives
    assert rep["collectives"] == {**{f"{k}_bytes": v for k, v in coll.bytes_by_kind.items()},
                                  **{f"{k}_count": v for k, v in coll.count_by_kind.items()}}
    assert rep["collective_count"] == coll.total_count

    # lm_loss forward and backward alone, on the same placed params
    params, _, batch = _placed(cfg, mesh22)
    for t in flatten_params(params).values():
        t.requires_grad_(True)
    with implicit_replication(), op_cost.OpCostMode() as loss_only:
        model_lib.lm_loss(params, cfg, batch["tokens"], batch["labels"])[0].backward()
    assert rep["collective_count"] > loss_only.collectives.total_count
    assert coll.count_by_kind["all_reduce"] > loss_only.collectives.count_by_kind["all_reduce"]


def test_train_row_flops_are_the_loss_forward_and_backward(mesh22):
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    params = model_lib.init_params(cfg, device="meta")
    for t in flatten_params(params).values():
        t.requires_grad_(True)
    batch = shapes.input_specs(cfg, SHAPE)[1]["batch"]
    with FlopCounterMode(display=False) as counter:
        model_lib.lm_loss(params, cfg, batch["tokens"], batch["labels"])[0].backward()
    want = counter.get_total_flops()
    plain = dryrun.dry_run(cfg, SHAPE, grad_accum=ACCUM)
    one = dryrun.dry_run(cfg, SHAPE, mesh=mesh22)
    rep = dryrun.dry_run(cfg, SHAPE, mesh=mesh22, grad_accum=ACCUM)
    assert rep["flops"] == plain["flops"] == one["flops"] == want
    # the f32 accumulators, sharded like the params, join the resident bytes
    placed = _placed(cfg, mesh22)[0]
    acc = sum(4 * t.to_local().numel() for t in flatten_params(placed).values())
    assert rep["resident_bytes"] == one["resident_bytes"] + acc
    assert plain["resident_bytes"] == dryrun.dry_run(cfg, SHAPE)["resident_bytes"] + sum(
        4 * t.numel() for t in flatten_params(params).values())


@pytest.mark.parametrize("grad_accum", [1, ACCUM])
def test_layer_norm_train_row_runs_sharded(mesh22, grad_accum):
    """musicgen-large's LayerNorm at 16-token rows: its sharded backward
    once mixed DTensor's P(sum) and P(avg) partials, which DTensor
    refuses to redistribute."""
    cfg = smoke_variant(get_config("musicgen-large"))
    rep = dryrun.dry_run(cfg, SHAPE, mesh=mesh22, grad_accum=grad_accum)
    assert rep["flops"] == dryrun.dry_run(cfg, SHAPE, grad_accum=grad_accum)["flops"] > 0
    assert rep["collective_count"] > 0


def test_micro_batches_split_a_batch_sharded_past_their_count():
    """64 rows in 4 micro-batches on 16 data ranks: DTensor cannot
    unflatten the rows' shard into (4, 16), so ``layers.split_rows``
    makes them whole first; the row counts the unsharded run's flops."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = smoke_variant(get_config("qwen2.5-3b"))
    shape = shapes.InputShape("s_train", "train", 16, 64)
    mesh_lib.fake_world(256)
    try:
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        rep = dryrun.dry_run(cfg, shape, mesh=mesh, grad_accum=ACCUM)
    finally:
        torch.distributed.destroy_process_group()
    assert rep["flops"] == dryrun.dry_run(cfg, shape, grad_accum=ACCUM)["flops"]
    assert rep["collective_count"] > 0


def test_attention_reduces_pending_sums_at_16x16():
    """nemotron-4-15b at full width (one layer) on a (16, 16) world, 64
    rows: the vocab-sharded embedding leaves q, k and v pending sums over
    "model" and its 8 kv heads stay whole; DTensor's einsum kept the
    product's sum pending and its backward failed to view the gradient.
    ``attention_core`` reduces the sums first."""
    from torch.distributed.device_mesh import init_device_mesh

    cfg = get_config("nemotron-4-15b").replace(num_layers=1)
    shape = shapes.InputShape("s_train", "train", 32, 64)
    mesh_lib.fake_world(256)
    try:
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        rep = dryrun.dry_run(cfg, shape, mesh=mesh)
    finally:
        torch.distributed.destroy_process_group()
    assert rep["flops"] == dryrun.dry_run(cfg, shape)["flops"]


def test_run_combo_runs_train_shapes_at_grad_accum_4(monkeypatch):
    seen = {}
    monkeypatch.setattr(dryrun, "dry_run", lambda cfg, shape, **kw: seen.setdefault(
        shape.name, kw["grad_accum"]))
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        dryrun.run_combo("qwen2.5-3b", name)
    assert dryrun.GRAD_ACCUM == ACCUM
    assert seen == {"train_4k": ACCUM, "prefill_32k": 1, "decode_32k": 1}
