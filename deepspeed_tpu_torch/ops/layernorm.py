"""Fused LayerNorm, forward and backward: the CUDA kernels and their plain
versions.

Counterpart of ``deepspeed_tpu/ops/pallas/layernorm.py``: the forward
``_ln_fwd`` (:34, the Pallas kernel ``_ln_fwd_kernel`` :23) saves fp32
mean and rstd; the backward is the math of ``_fused_ln_bwd`` (:70),
which the JAX package leaves to XLA and the port writes as a kernel too:

    dx = (g gamma - mean(g gamma) - xhat mean(g gamma xhat)) rstd
    dgamma = sum over rows of g xhat;   dbeta = sum over rows of g

The kernels are ``csrc/layernorm.cu`` (one forward launch; a backward of
two launches, dx with per-CTA partials of dgamma and dbeta, then a fixed-
order sum of the partials, so the result is bit-reproducible). Rows of at
most 1024 elements that are whole 16-byte vectors go to the warp-per-row
kernels, which hold a row in registers; other rows to the CTA-per-row
kernels (the C entry points pick by width). A CUDA tensor launches
them, a CPU tensor runs ``layer_norm_fwd_reference`` and
``layer_norm_bwd_reference``. x is fp32 or bf16 with fp32 gamma and beta;
y and dx come out in x's dtype, dgamma and dbeta in gamma's.

rstd is ``1 / sqrt(var + eps)`` with IEEE square root and division in
both versions (``jax.lax.rsqrt`` on the TPU; the two agree to an ulp).
"""

import torch

from ._common import check_launch, kernel_dtype_code, use_kernel

MAX_D = 16384          # the widest row the kernels take (shared memory)
# csrc/layernorm.cu's constants: the warps of a backward CTA, and the
# backward's CTAs (two a card's 132 SMs)
BWD_WARPS = 4
BWD_CTAS = 264
VEC_BYTES = 16         # the warp-per-row kernels' loads and stores


def layer_norm_fwd_reference(x2d, gamma, beta, eps):
    """Plain forward on [n, d]: (y in x's dtype, mean fp32 [n], rstd fp32
    [n]); the variance in the two-pass form mean((x - mean)^2)."""
    x = x2d.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = (x - mean) * rstd * gamma.float() + beta.float()
    return y.to(x2d.dtype), mean[:, 0], rstd[:, 0]


def layer_norm_bwd_reference(dy2d, x2d, gamma, mean, rstd):
    """Plain backward on [n, d]: (dx in x's dtype, dgamma, dbeta in
    gamma's dtype)."""
    g = dy2d.float()
    xhat = (x2d.float() - mean[:, None]) * rstd[:, None]
    gg = g * gamma.float()[None, :]
    mean_gg = gg.mean(dim=-1, keepdim=True)
    mean_gg_xhat = (gg * xhat).mean(dim=-1, keepdim=True)
    dx = (gg - mean_gg - xhat * mean_gg_xhat) * rstd[:, None]
    return (dx.to(x2d.dtype), (g * xhat).sum(dim=0).to(gamma.dtype),
            g.sum(dim=0).to(gamma.dtype))


def _check(x2d, gamma, beta=None):
    n, d = x2d.shape
    kernel_dtype_code(x2d.dtype)
    if not 0 < d <= MAX_D:
        raise ValueError(f"fused_layer_norm: the CUDA kernels take rows of "
                         f"1..{MAX_D} elements, got {d}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (d,) \
                or t.device != x2d.device:
            raise ValueError(f"fused_layer_norm: {name} must be fp32 [{d}] on "
                             f"{x2d.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def bwd_ctas(n: int) -> int:
    """CTAs of the backward's first launch, each owning the contiguous
    rows [c n / ctas, (c + 1) n / ctas) and one partial row of dgamma and
    dbeta: ``BWD_CTAS``, or fewer so that each of a CTA's ``BWD_WARPS``
    warps has a row on average; the second launch sums the partials."""
    return min(BWD_CTAS, -(-n // BWD_WARPS))


def _aligned(t):
    """``t`` itself when its data is 16-byte aligned (the vector loads),
    else an aligned copy."""
    return t if t.data_ptr() % VEC_BYTES == 0 else t.clone()


def launch_fwd(x2d, gamma, beta, eps):
    """The forward kernel on contiguous [n, d]; returns (y, mean, rstd)."""
    from . import op_builder
    _check(x2d, gamma, beta)
    x2d, gamma, beta = (_aligned(t) for t in (x2d, gamma, beta))
    n, d = x2d.shape
    dev = x2d.device
    y = torch.empty_like(x2d)
    mean = torch.empty(n, dtype=torch.float32, device=dev)
    rstd = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return y, mean, rstd
    status = op_builder.load().layernorm_fwd(
        x2d.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        mean.data_ptr(), rstd.data_ptr(), kernel_dtype_code(x2d.dtype), n, d,
        float(eps), torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "layernorm_fwd")
    fused_layer_norm.fwd_launches += 1
    return y, mean, rstd


def launch_bwd(dy2d, x2d, gamma, mean, rstd):
    """The two backward kernels on contiguous [n, d]; returns (dx, dgamma,
    dbeta)."""
    from . import op_builder
    _check(x2d, gamma)
    n, d = x2d.shape
    dev = x2d.device
    if dy2d.shape != x2d.shape or dy2d.dtype != x2d.dtype:
        raise ValueError("fused_layer_norm: the incoming gradient must match "
                         "x in shape and dtype")
    dy2d, x2d, gamma = (_aligned(t) for t in (dy2d, x2d, gamma))
    dx = torch.empty_like(x2d)
    dgamma = torch.empty(d, dtype=torch.float32, device=dev)
    dbeta = torch.empty(d, dtype=torch.float32, device=dev)
    if n == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    ctas = bwd_ctas(n)
    partials = torch.empty((2, ctas, d), dtype=torch.float32, device=dev)
    status = op_builder.load().layernorm_bwd(
        dy2d.data_ptr(), x2d.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), partials.data_ptr(),
        dgamma.data_ptr(), dbeta.data_ptr(), kernel_dtype_code(x2d.dtype), n,
        d, ctas, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "layernorm_bwd")
    fused_layer_norm.bwd_launches += 1
    return dx, dgamma, dbeta


def layer_norm_fwd(x2d, gamma, beta, eps):
    if use_kernel(x2d):
        return launch_fwd(x2d, gamma, beta, eps)
    return layer_norm_fwd_reference(x2d, gamma, beta, eps)


def layer_norm_bwd(dy2d, x2d, gamma, mean, rstd):
    if use_kernel(x2d):
        return launch_bwd(dy2d, x2d, gamma, mean, rstd)
    return layer_norm_bwd_reference(dy2d, x2d, gamma, mean, rstd)


class _FusedLayerNorm(torch.autograd.Function):
    """The JAX ``custom_vjp`` (:55-88): the forward saves x, gamma, mean
    and rstd; the backward runs the backward kernels."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1]).contiguous()
        y, mean, rstd = layer_norm_fwd(x2d, gamma, beta, eps)
        ctx.save_for_backward(x2d, gamma, mean, rstd)
        ctx.shape = shape
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, gamma, mean, rstd = ctx.saved_tensors
        dy2d = dy.reshape(x2d.shape).to(x2d.dtype).contiguous()
        dx, dgamma, dbeta = layer_norm_bwd(dy2d, x2d, gamma, mean, rstd)
        return dx.reshape(ctx.shape), dgamma, dbeta, None


def fused_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim of x [..., d] (fp32 or bf16) with fp32
    gamma and beta [d]; returns y like x. Differentiable in all three. A
    CUDA tensor launches the kernels (rows of at most ``MAX_D``), a CPU
    tensor runs the plain versions."""
    return _FusedLayerNorm.apply(x, gamma, beta, eps)


fused_layer_norm.fwd_launches = 0
fused_layer_norm.bwd_launches = 0
