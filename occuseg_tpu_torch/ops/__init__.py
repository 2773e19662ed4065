"""Operations of the port. `acc` is the dtype they accumulate in, as the
JAX package's `_acc_dtype`: f32 for f32 and bf16 data, f64 for f64 data
(a float64 reference run of a step on the CPU; the kernels take f32 and
bf16 only)."""

import torch


def acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def acc(t: torch.Tensor) -> torch.Tensor:
    """t in its accumulation dtype (`acc_dtype`)."""
    return t.to(acc_dtype(t))
