"""The eager CUDA path's gate, ``ops/kernels.py::eager_cuda`` (CUDA tensors
outside a trace skip the custom ops' dispatch), and the tool that measures
what the dispatch costs: ``tools/dispatch_cost.py``'s ``through_ops`` sends
CUDA tensors through the ops only inside its block, and restores the gate
also when the block raises. What the tool measures runs on the card only
(``tests/test_torch_port_cuda.py`` holds the eager path to the ops there)."""

import pytest
import torch

from bridgerl_tpu_torch.ops import kernels
from bridgerl_tpu_torch.tools import dispatch_cost


def _tensor(kind: str) -> torch.Tensor:
    if kind == "fake":
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            return torch.empty(2)
    return torch.nn.Parameter(torch.zeros(2)) if kind == "parameter" else torch.zeros(2)


@pytest.mark.parametrize("kind,compiling,want", [("plain", False, True), ("plain", True, False),
                                                 ("fake", False, False),
                                                 ("parameter", False, False)])
def test_eager_cuda_is_a_plain_cuda_tensor_outside_a_trace(monkeypatch, kind, compiling, want):
    t = _tensor(kind)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: compiling)
    assert kernels.eager_cuda(t) is want


def test_eager_cuda_is_false_for_cpu_tensors():
    assert not kernels.eager_cuda(torch.zeros(2))


@pytest.mark.parametrize("raises", [False, True], ids=["returns", "raises"])
def test_through_ops_swaps_the_gate_inside_its_block_only(raises):
    shipped = kernels.eager_cuda
    with pytest.raises(RuntimeError) if raises else dispatch_cost.contextlib.nullcontext():
        with dispatch_cost.through_ops():
            assert not kernels.eager_cuda(torch.zeros(2))
            if raises:
                raise RuntimeError("inside")
    assert kernels.eager_cuda is shipped
