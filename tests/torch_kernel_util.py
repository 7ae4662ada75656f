"""Helpers of the port's kernel tests that need neither JAX nor a card."""
import torch


def misaligned(a: torch.Tensor) -> torch.Tensor:
    """A copy of ``a`` whose storage starts 4 bytes past a 16-byte boundary:
    what a view into a larger buffer may hand a kernel that loads 16-byte
    vectors."""
    buf = torch.empty(a.numel() + 4, dtype=a.dtype)
    off = (-(buf.data_ptr() // 4) + 1) % 4
    out = buf[off:off + a.numel()].view(a.shape)
    out.copy_(a)
    assert out.data_ptr() % 16 == 4
    return out
