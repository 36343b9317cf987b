"""Group-wise quantize / dequantize: the CUDA kernels and their plain
versions.

Counterpart of ``deepspeed_tpu/ops/pallas/quantizer.py`` ``quantize``
(:67, the Pallas kernels ``_quant_sym_kernel`` :24, ``_quant_asym_kernel``
:33 and ``_quant_sr_kernel`` :47) and ``dequantize`` (:141). x is viewed
as [groups, group_size]; each group gets an fp32 scale (and, asymmetric,
an fp32 zero point, its minimum):

- symmetric: scale = max(absmax * (1 / qmax), floor), code = clip(rint(x
  / scale), -qmax, qmax) with qmax = 2^(bits-1) - 1 (int8 [-127, 127] at
  8 bits, as :24);
- asymmetric: scale = max((max - min) * (1 / qmax), floor), code =
  clip(rint((x - min) / scale), 0, qmax) with qmax = 2^bits - 1 (uint8 at
  8 bits: the JAX codes after their -128 bias is undone, :33 and :107);
- stochastic (symmetric): code = clip(floor(x / scale) + (u < frac), ...)
  with u from the port's counter hash of (seed words, flat element index),
  24 bits as :58-60. JAX draws u from the TPU PRNG (or ``jax.random`` in
  interpret mode, :112), so stochastic codes match JAX in distribution
  only; the kernel and the plain version draw the same u.

The scale is the range times the fp32 reciprocal of qmax: XLA folds the
JAX package's division by the constant qmax into that multiplication in
every compiled path (the Pallas kernels in interpret mode, the jitted
Compressor and MoQ projections), so the port does the same; the port is
held to the JAX functions as compiled (``jax.jit``). x / scale is
an IEEE division and rounding is half-to-even in both versions, so codes,
scales and zero points are bit-equal between them and, deterministic, to
JAX (the asymmetric dequantize is one fused multiply-add, as XLA
contracts ``q * scale + zp``). ``floor`` is the scale floor: the Pallas kernels floor the range
before the scaling (max(absmax, 1e-8) / 127), which for a correctly
rounded, monotone product equals max(absmax * (1/127), fl(1e-8 *
(1/127))); ``compression.compress.fake_quantize`` floors the scale at
1e-8. The kernels take the floor as an argument and serve both.

``bits`` runs from 2 to 15: codes are int8 (uint8 asymmetric) up to 8
bits and int16 above, so ``fake_quantize`` reaches every width that
compression and MoQ snap to. The kernels are ``csrc/quantizer.cu``; a
CUDA tensor launches them, a CPU tensor runs the plain versions.
"""

from typing import Optional

import numpy as np
import torch

from ._common import check_launch, kernel_dtype_code, use_kernel
from .dropout import M32, _mix32, _mul32, seed_words

MIN_BITS, MAX_BITS = 2, 15
_CODE_DTYPES = {torch.int8: 0, torch.uint8: 1, torch.int16: 2}
_MODES = {"symmetric": 0, "asymmetric": 1, "stochastic": 2}


def code_dtype(bits: int, asymmetric: bool) -> torch.dtype:
    if bits > 8:
        return torch.int16
    return torch.uint8 if asymmetric else torch.int8


def qmax(bits: int, asymmetric: bool) -> int:
    """The largest code: 2^bits - 1 asymmetric, 2^(bits-1) - 1 else."""
    return 2 ** bits - 1 if asymmetric else 2 ** (bits - 1) - 1


def inv_qmax(bits: int, asymmetric: bool) -> float:
    """1 / qmax rounded to fp32: the factor the scale is taken with."""
    return float(np.float32(1.0) / np.float32(qmax(bits, asymmetric)))


def pallas_floor(bits: int, asymmetric: bool) -> float:
    """The Pallas kernels' floor max(range, 1e-8) / qmax as a floor on the
    scale: fl32(fl32(1e-8) * inv_qmax)."""
    return float(np.float32(1e-8) * np.float32(inv_qmax(bits, asymmetric)))


def uniform24(words, idx):
    """The stochastic-rounding uniforms of flat element indices ``idx``
    (an int64 tensor): the keep hash of ``ops.dropout`` over (low word,
    high word) of the index, its top 24 bits over 2^24."""
    lo, hi = idx & M32, (idx >> 32) & M32
    x = _mul32(lo, 0x27D4EB2F) ^ _mul32(hi, 0x165667B1) ^ (int(words[0])
                                                           & M32)
    x = _mix32(x ^ (int(words[1]) & M32))
    x = _mix32((x + 0x9E3779B9) & M32)
    return (x >> 8).to(torch.float32) / float(1 << 24)


def _check_bits(bits):
    if not MIN_BITS <= int(bits) <= MAX_BITS:
        raise ValueError(f"quantize takes {MIN_BITS}..{MAX_BITS} bits (int8 "
                         f"codes up to 8, int16 above), got {bits}")


def quantize_reference(x2d, *, mode: int, bits: int, scale_floor: float,
                       seed: int = 0):
    """Plain quantize of [groups, gs]: (codes [groups, gs], scales
    [groups], zero points [groups] or None)."""
    x = x2d.float()
    asym = mode == _MODES["asymmetric"]
    top, inv = float(qmax(bits, asym)), inv_qmax(bits, asym)
    zp = None
    if asym:
        zp = x.amin(dim=1, keepdim=True)
        scale = torch.clamp_min((x.amax(dim=1, keepdim=True) - zp) * inv,
                                scale_floor)
        codes = torch.clamp(torch.round((x - zp) / scale), 0.0, top)
    else:
        scale = torch.clamp_min(x.abs().amax(dim=1, keepdim=True) * inv,
                                scale_floor)
        scaled = x / scale
        if mode == _MODES["stochastic"]:
            idx = torch.arange(x.numel(), dtype=torch.int64,
                               device=x.device).reshape(x.shape)
            low = torch.floor(scaled)
            u = uniform24(seed_words(seed), idx)
            codes = low + (u < scaled - low).to(torch.float32)
        else:
            codes = torch.round(scaled)
        codes = torch.clamp(codes, -top, top)
    return (codes.to(code_dtype(bits, asym)), scale[:, 0],
            None if zp is None else zp[:, 0])


def dequantize_reference(q2d, scales, zero_points, dtype):
    """Plain dequantize of [groups, gs]. Asymmetric, code x scale + zero
    point is one fused multiply-add, as XLA compiles the JAX expression:
    taken in fp64, where the product of a code (at most 16 bits) and an
    fp32 scale is exact, and so is its sum with the zero point unless the
    two lie more than 2^13 fp32 ulps apart."""
    if zero_points is None:
        out = q2d.to(torch.float32) * scales[:, None]
    else:
        out = (q2d.to(torch.float64) * scales[:, None].double()
               + zero_points[:, None].double()).to(torch.float32)
    return out.to(dtype)


def launch_quantize(x2d, *, mode, bits, scale_floor, seed=0):
    """The quantize kernel on contiguous [groups, gs] (fp32 or bf16)."""
    from . import op_builder
    groups, gs = x2d.shape
    asym = mode == _MODES["asymmetric"]
    dev = x2d.device
    q = torch.empty((groups, gs), dtype=code_dtype(bits, asym), device=dev)
    scales = torch.empty(groups, dtype=torch.float32, device=dev)
    zps = torch.empty(groups, dtype=torch.float32, device=dev) if asym \
        else None
    if q.numel() == 0:
        return q, scales, zps
    s0, s1 = seed_words(seed)
    status = op_builder.load().quantize_groups(
        x2d.data_ptr(), q.data_ptr(), scales.data_ptr(),
        zps.data_ptr() if zps is not None else None,
        kernel_dtype_code(x2d.dtype), _CODE_DTYPES[q.dtype], mode, groups,
        gs, float(qmax(bits, asym)), inv_qmax(bits, asym),
        float(scale_floor), s0, s1,
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "quantize_groups")
    quantize.launches += 1
    return q, scales, zps


def launch_dequantize(q2d, scales, zero_points, dtype):
    """The dequantize kernel on contiguous [groups, gs] codes."""
    from . import op_builder
    groups, gs = q2d.shape
    dev = q2d.device
    out = torch.empty((groups, gs), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    status = op_builder.load().dequantize_groups(
        q2d.data_ptr(), scales.data_ptr(),
        zero_points.data_ptr() if zero_points is not None else None,
        out.data_ptr(), _CODE_DTYPES[q2d.dtype], kernel_dtype_code(dtype),
        groups, gs, torch.cuda.current_stream(dev).cuda_stream)
    check_launch(status, "dequantize_groups")
    dequantize.launches += 1
    return out


def quantize(x, groups: int = 1, *, asymmetric: bool = False,
             stochastic: bool = False, seed: int = 0, bits: int = 8,
             scale_floor: Optional[float] = None):
    """Quantize x (fp32 or bf16, any shape) in ``groups`` equal groups of
    consecutive elements. Returns (codes shaped like x, scales [groups]
    fp32) and, asymmetric, zero points [groups] fp32 as a third element.
    ``scale_floor``: the floor on the scale; None takes the Pallas
    kernels' (``pallas_floor``). Asymmetric wins over stochastic, as in
    JAX. A CUDA tensor launches the kernel, a CPU tensor runs the plain
    version."""
    _check_bits(bits)
    kernel_dtype_code(x.dtype)
    n = x.numel()
    if groups <= 0 or n % groups:
        raise ValueError(f"{n} elements not divisible into {groups} groups")
    mode = _MODES["asymmetric" if asymmetric else
                  "stochastic" if stochastic else "symmetric"]
    if scale_floor is None:
        scale_floor = pallas_floor(bits, asymmetric)
    x2d = x.reshape(groups, n // groups).contiguous()
    run = launch_quantize if use_kernel(x2d) else quantize_reference
    q, scales, zps = run(x2d, mode=mode, bits=bits, scale_floor=scale_floor,
                         seed=seed)
    q = q.reshape(x.shape)
    return (q, scales) if zps is None else (q, scales, zps)


def dequantize(q, scales, zero_points=None, dtype=torch.float32):
    """Inverse of ``quantize``: code x scale (+ zero point) per group, in
    fp32, cast to ``dtype`` (fp32 or bf16)."""
    if q.dtype not in _CODE_DTYPES:
        raise TypeError(f"dequantize takes int8, uint8 or int16 codes, got "
                        f"{q.dtype}")
    kernel_dtype_code(dtype)
    groups = scales.shape[0]
    for name, t in (("scales", scales), ("zero_points", zero_points)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (groups,)
                              or t.device != q.device):
            raise ValueError(f"dequantize: {name} must be fp32 [{groups}] on "
                             f"{q.device}")
    if q.numel() % max(groups, 1):
        raise ValueError(f"{q.numel()} codes not divisible into {groups} "
                         "groups")
    q2d = q.reshape(groups, -1).contiguous()
    scales = scales.contiguous()
    zps = zero_points.contiguous() if zero_points is not None else None
    if use_kernel(q2d):
        out = launch_dequantize(q2d, scales, zps, dtype)
    else:
        out = dequantize_reference(q2d, scales, zps, dtype)
    return out.reshape(q.shape)


quantize.launches = 0
dequantize.launches = 0
