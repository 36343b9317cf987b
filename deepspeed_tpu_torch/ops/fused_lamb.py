"""Multi-tensor fused LAMB: the CUDA kernels and their plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_lamb.py``
``_lamb_phase1_kernel`` (:31), ``_lamb_phase1_flat`` (:49) and the
trust-ratio step of ``fused_lamb`` (:118-127). The kernels are
``csrc/fused_lamb.cu``: per optimizer step one phase-1 launch (clip, the
Adam moments in place, per-CTA partial sums of p² and u²) and one apply
launch (each tensor's norms from its partials, the trust ratio, the
update), reading a device table of (p, g, m, v, numel) entries built once
by ``FusedLambState``, as ``ops/fused_adam.py`` does. The step's scalars
are host floats; the global grad norm for clipping and the norms stay on
the device, so a step never waits on the card. A CUDA state launches the
kernels, a CPU state runs ``fused_lamb_reference`` tensor by tensor.
With bf16 gradient buffers (``data_types.grad_accum_dtype = bf16``) phase
1 is the kernel's bf16 instance (``fused_lamb_phase1_bf16``), which widens
g in registers as JAX casts it before its kernel (fused_lamb.py:119).
"""

from typing import NamedTuple, Optional

import torch

from ._common import check_launch, use_kernel
from .fused_adam import check_buffers

CHUNK = 16384         # elements per CTA (csrc/fused_lamb.cu)


class LambScalars(NamedTuple):
    """The per-step scalars of the update (host floats)."""
    lr: float
    b1: float
    b2: float
    c1: float
    c2: float
    eps: float
    wd: float = 0.0


@torch.no_grad()
def fused_lamb_reference(p, g, m, v, sc: LambScalars, grad_norm=None,
                         max_norm: float = 0.0):
    """The kernels' function on one fp32 tensor, in place on p, m, v:
    optax's global-norm clip, the Adam moments, u = m c1 / (sqrt(v c2) +
    eps) + wd p, trust = |p| / |u| (1 when either is 0) and
    p + (-lr trust) u. Nothing is read back to the host. A bf16 ``g`` is
    widened to fp32 first (exact)."""
    g = g.float()
    if grad_norm is not None:
        g = torch.where(grad_norm < max_norm, g, g / grad_norm * max_norm)
    m.mul_(sc.b1).add_((1.0 - sc.b1) * g)
    v.mul_(sc.b2).add_((1.0 - sc.b2) * g * g)
    u = m * sc.c1 / (torch.sqrt(v * sc.c2) + sc.eps) + sc.wd * p
    p_norm = p.square().sum().sqrt()
    u_norm = u.square().sum().sqrt()
    trust = torch.where((p_norm > 0.0) & (u_norm > 0.0),
                        p_norm / u_norm.clamp_min(1e-30), 1.0)
    p.add_((-sc.lr * trust) * u)


class FusedLambState:
    """LAMB moments of a parameter list, and (on a card) the device table
    and partial-sum scratch the kernels use. ``grads`` are the fp32 or
    bf16 buffers the gradients are accumulated into; they, like the
    parameters, must keep their storage for the life of the state
    (checked at every step)."""

    SLOTS = ("exp_avg", "exp_avg_sq")     # the moments a checkpoint holds

    def __init__(self, params, grads):
        self.params, self.grads = list(params), list(grads)
        self.grad_dtype = check_buffers("fused_lamb", self.params,
                                        self.grads)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = 0          # optimizer steps taken
        self.device = self.params[0].device if self.params else None
        self._ptrs = None
        if self.params and use_kernel(self.params[0]):
            self._build_table()

    def _pointers(self):
        return tuple(t.data_ptr() for group in (
            self.params, self.grads, self.exp_avg, self.exp_avg_sq)
            for t in group)

    def _build_table(self):
        """The (p, g, m, v, n) table, block offsets and partials, on the
        card once."""
        rows, starts, blocks = [], [], 0
        for p, g, m, v in zip(self.params, self.grads, self.exp_avg,
                              self.exp_avg_sq):
            rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), p.numel()])
            starts.append(blocks)
            blocks += max(1, -(-p.numel() // CHUNK))
        if blocks >= 2 ** 31:
            raise ValueError(f"fused_lamb: {blocks} blocks exceed the grid")
        self._table = torch.tensor(rows, dtype=torch.int64).to(self.device)
        self._block_start = torch.tensor(starts, dtype=torch.int32).to(
            self.device)
        self._n_blocks = blocks
        self._partials = torch.empty(2 * blocks, dtype=torch.float32,
                                     device=self.device)
        self._ptrs = self._pointers()


def fused_lamb(state: FusedLambState, sc: LambScalars,
               grad_norm: Optional[torch.Tensor] = None,
               max_norm: float = 0.0):
    """One LAMB step over every tensor of ``state``, in place. grad_norm:
    the global pre-clip grad norm (a 0-dim fp32 tensor on the state's
    device) to clip against ``max_norm``, or None for no clipping."""
    if not state.params:
        return
    if use_kernel(state.params[0]):
        _launch(state, sc, grad_norm, max_norm)
        return
    for p, g, m, v in zip(state.params, state.grads, state.exp_avg,
                          state.exp_avg_sq):
        fused_lamb_reference(p, g, m, v, sc, grad_norm, max_norm)


def _launch(state, sc, grad_norm, max_norm):
    from . import op_builder
    if state._pointers() != state._ptrs:
        raise RuntimeError("fused_lamb: a parameter, gradient or moment "
                           "moved since its state was built; the device "
                           "table would point at stale storage")
    if grad_norm is not None:
        if (grad_norm.device != state.device
                or grad_norm.dtype != torch.float32 or grad_norm.numel() != 1):
            raise ValueError("fused_lamb: grad_norm must be one fp32 value "
                             f"on {state.device}")
        grad_norm = grad_norm.contiguous()
    lib = op_builder.load()
    args = (state._table.data_ptr(), state._block_start.data_ptr(),
            len(state.params), state._n_blocks,
            grad_norm.data_ptr() if grad_norm is not None else None,
            state._partials.data_ptr(), sc.b1, 1.0 - sc.b1, sc.b2,
            1.0 - sc.b2, sc.c1, sc.c2, sc.eps, sc.wd, float(max_norm),
            -sc.lr, torch.cuda.current_stream(state.device).cuda_stream)
    if state.grad_dtype == torch.bfloat16:
        check_launch(lib.fused_lamb_phase1_bf16(*args),
                     "fused_lamb_phase1_bf16")
        fused_lamb.bf16_phase1_launches += 1
    else:
        check_launch(lib.fused_lamb_phase1(*args), "fused_lamb_phase1")
        fused_lamb.phase1_launches += 1
    check_launch(lib.fused_lamb_apply(*args), "fused_lamb_apply")
    fused_lamb.apply_launches += 1


fused_lamb.phase1_launches = 0          # phase 1, fp32 gradients
fused_lamb.bf16_phase1_launches = 0     # phase 1, bf16 gradients
fused_lamb.apply_launches = 0           # the apply (both)
