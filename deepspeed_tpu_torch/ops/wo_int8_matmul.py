"""Weight-only int8 matmul: the CUDA kernels and their plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/wo_int8_matmul.py``
``wo_int8_matmul`` (:208): ``y = (x @ q) * scale`` with int8 ``q [k, n]``
converted to x's dtype, fp32 accumulation and the per-output-channel
``scale [1, n]`` applied once at the end, cast to ``out_dtype``. The
kernels are ``csrc/wo_int8_matmul.cu``; its header says what bounds them
and the one summation order both follow, so a row's result does not
depend on m: k in segments of ``SEG`` rows, each segment's partial a
chain from zero (bf16 or fp16 x: ``mma.sync`` products in x's type on
the tensor cores over 16-row steps; fp32 x: fp32 FMAs row by row), the
partials added in segment order, then the scale.

Routing is by m alone (the JAX package's env-var and calibration-file
routing of its GEMV is TPU tuning and is not ported): m <= ``SMALL_M``
(decode, m = the slot batch) runs the small-m kernel, which streams the
weights once; larger m (prefill chunks) runs the tiled kernel, whose
k segments ``tiled_splits`` spreads over several CTAs when the output
tiles alone would not fill the card (16-bit x; the same bits either way).
A CUDA tensor launches a kernel, a CPU tensor runs
``wo_int8_matmul_reference``.
"""

import torch

from ._common import check_launch, kernel_dtype_code, use_kernel

SMALL_M = 16     # the largest m routed to the small-m (decode) kernel
SEG = 128        # k rows of one segment of the kernels' summation order
TILE_M, TILE_N = 32, 64  # the 16-bit tiled kernel's output tile
SPLIT_TILES = 66  # no split at or above this many tiles (half the 132 SMs)


def tiled_splits(m, k, n):
    """The 16-bit tiled kernel's CTAs along k for an [m, k] x [k, n] call:
    1 (one CTA walks every segment of its tile) when there are at least
    ``SPLIT_TILES`` output tiles, else one CTA a segment
    (``csrc/wo_int8_matmul.cu`` header)."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    return 1 if tiles >= SPLIT_TILES else -(-k // SEG)


def wo_int8_matmul_reference(x, q, scale, out_dtype=None):
    """The kernels' function in plain PyTorch: ``(x.float() @ q.float())
    * scale`` cast to ``out_dtype`` (default x's dtype). A bf16 or fp16 x
    times an int8 weight is exact in fp32, so this is the TPU kernel's
    ``preferred_element_type=f32`` dot up to the order of the sums."""
    out_dtype = out_dtype or x.dtype
    n = q.shape[1]
    y = x.float() @ q.float()
    return (y * scale.reshape(1, n).float()).to(out_dtype)


def _launch(x2, q, scale, out_dtype, splits=None):
    """Launch on x2 [m, k]; returns [m, n]. ``splits`` overrides
    ``tiled_splits`` for the 16-bit tiled kernel (the checks run one shape
    both ways)."""
    from . import op_builder
    m, k = x2.shape
    n = q.shape[1]
    code = kernel_dtype_code(x2.dtype, fp16=True)
    out_code = kernel_dtype_code(out_dtype, fp16=True)
    dev = x2.device
    if (q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != k
            or q.device != dev or not q.is_contiguous()
            or q.data_ptr() % 16 or n % 16):
        raise ValueError(f"wo_int8_matmul: the CUDA kernels take a "
                         f"contiguous, 16-byte aligned int8 q [k={k}, n] "
                         f"on {dev} with n % 16 == 0, got {q.dtype} "
                         f"{tuple(q.shape)}")
    scale = scale.reshape(-1)
    if scale.numel() != n or scale.dtype != torch.float32 \
            or scale.device != dev:
        raise ValueError(f"wo_int8_matmul: scale must be {n} fp32 values "
                         f"on {dev}")
    scale = scale.contiguous()
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    if code != 0 and (x2.data_ptr() % 16 or x2.stride(0) % 8):
        # the 16-bit kernels copy x rows in 16-byte chunks: rows padded to
        # a multiple of 8 elements
        xp = x2.new_zeros((m, -(-k // 8) * 8))
        xp[:, :k] = x2
        x2 = xp
    y = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return y
    small = m <= SMALL_M
    segs = -(-k // SEG)
    if splits is None:
        splits = tiled_splits(m, k, n)
    partials = segs > 1 and (small or code == 0 or splits > 1)
    part = (torch.empty((segs, m, n), dtype=torch.float32, device=dev)
            if partials else None)
    lib = op_builder.load()
    status = lib.wo_int8_matmul(
        x2.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        part.data_ptr() if part is not None else None, code, out_code, m, k,
        n, x2.stride(0), int(small), int(splits),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "wo_int8_matmul")
    if small:
        wo_int8_matmul.small_m_launches += 1
    else:
        wo_int8_matmul.tiled_launches += 1
    return y


def wo_int8_matmul(x, q, scale, *, out_dtype=None):
    """``x @ (q * scale)`` with int8 ``q`` converted inside the kernel.

    x: [..., k] fp32/bf16/fp16; q: [k, n] int8; scale: per output channel,
    [1, n] or [n] fp32. Returns [..., n] in ``out_dtype`` (default x's
    dtype). ``small_m_launches`` counts launches of the small-m kernel,
    ``tiled_launches`` those of the tiled kernel (each with the
    segment-partial reduction it needs)."""
    out_dtype = out_dtype or x.dtype
    k, n = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if use_kernel(x2):
        y = _launch(x2, q, scale, out_dtype)
    else:
        y = wo_int8_matmul_reference(x2, q, scale, out_dtype)
    return y.reshape(*lead, n)


wo_int8_matmul.small_m_launches = 0
wo_int8_matmul.tiled_launches = 0
