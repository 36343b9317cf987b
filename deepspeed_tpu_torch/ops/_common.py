"""Shared kernel-dispatch helpers (counterpart of
``deepspeed_tpu/ops/pallas/_common.py``).

The dispatch rule of every kernel wrapper in this package: a tensor on a
CUDA device goes to the hand-written kernel (or the wrapper raises when
the kernel does not take its shape or dtype); a tensor on the CPU goes
to the kernel's plain PyTorch version. Nothing falls back from one to
the other.
"""

import torch

# The additive masked-out encoding shared by the attention kernels and the
# mask->bias folding in ops.transformer.attention: kernels classify a row
# as fully masked via thresholds on NEG_INF/2, so every producer of masked
# logits must use THIS constant (fp32- and bf16-representable).
NEG_INF = -1e30


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means CUDA. Raises when
    CUDA is asked for (explicitly or by default) and no card is present,
    so nothing silently runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "deepspeed_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain PyTorch "
            "versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def use_kernel(t: torch.Tensor) -> bool:
    """True when ``t`` lies on a CUDA device (launch the kernel), False on
    the CPU (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_dtype_code(dtype: torch.dtype, fp16: bool = False) -> int:
    """The element-type code the C entry points take (0 fp32, 1 bf16, 2
    fp16). ``fp16``: the caller's kernel has an fp16 instance (the flash
    forward and backward); every other kernel refuses fp16 by name."""
    code = _KERNEL_DTYPES.get(dtype)
    if code is None:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{dtype}")
    if code == 2 and not fp16:
        raise TypeError(
            "float16: only the flash attention kernels have fp16 instances "
            "(fp16 training); this kernel's fp16 instance comes with the "
            "fp16-serving slice of the port")
    return code


def check_launch(status: int, name: str):
    """Raise when a C entry point reports a CUDA error (the value of
    ``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {status}")
