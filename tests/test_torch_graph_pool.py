"""The graph backend's memory pool outlives its graphs (on the card).

``serving.compiled.CudaGraphBackend`` holds its pool with a
``torch.cuda.MemPool``: a version's views, and with them every graph of
the slot, are dropped at a staged sync's flip while tensors the pool
allocated may live on, and the next capture (a request on the new
version) must still succeed.  With a bare ``graph_pool_handle()`` that
capture fails the caching allocator's ``use_count > 0`` assertion.
"""
import pytest
import torch

from repro_torch.serving.compiled import CudaGraphBackend


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs")
    return torch.device("cuda")


@pytest.mark.gpu
def test_capture_after_every_graph_was_dropped(cuda):
    backend = CudaGraphBackend(cuda)
    x = torch.ones(1024, device=cuda)
    kept = []

    def step():
        kept.append(x * 2)            # allocated in the pool, outlives its graph

    backend.warmup(step)
    graph = backend.capture(step)
    backend.replay(graph)
    del graph                          # every graph of the pool gone
    again = backend.capture(step)
    backend.replay(again)
    torch.cuda.synchronize()
    assert torch.equal(kept[-1], x * 2) and backend.pool_bytes() > 0
