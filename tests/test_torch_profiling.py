"""`utils/profiling.py` on the CPU: FlopCounterMode's count of a linear, a
trace written to its directory, and no card memory where there is no card."""

import torch

from dualhyp_tpu_torch.utils import profiling


def test_compiled_flops_of_a_linear_is_2mnk():
    m, n, k = 12, 40, 24
    x, w = torch.randn(m, k), torch.randn(n, k)
    assert profiling.compiled_flops(lambda a, b: a @ b.t(), x, w) == 2 * m * n * k


def test_compiled_flops_counts_the_backward_too():
    """A training step's count: the forward product and the two of its
    backward (dx, dw)."""
    m, n, k = 8, 16, 32
    x, w = torch.randn(m, k, requires_grad=True), torch.randn(n, k, requires_grad=True)
    assert profiling.compiled_flops(lambda a, b: (a @ b.t()).sum().backward(), x, w) == (
        3 * 2 * m * n * k)


def test_trace_writes_a_file(tmp_path):
    with profiling.trace(tmp_path / "trace") as log_dir:
        torch.randn(64, 64) @ torch.randn(64, 64)
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0


def test_live_device_memory_is_empty_without_a_card():
    assert not torch.cuda.is_available()
    assert profiling.live_device_memory() == {}
