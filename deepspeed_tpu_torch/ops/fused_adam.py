"""Multi-tensor fused Adam/AdamW: the CUDA kernel and its plain version.

Counterpart of ``deepspeed_tpu/ops/pallas/fused_adam.py`` ``_adam_kernel``
(:28) and ``fused_adamw`` (:74). The kernel is ``csrc/fused_adam.cu``:
one launch per optimizer step updates every parameter in place, reading a
device table of (p, g, m, v, numel) entries built once by
``FusedAdamState`` (the parameters and their gradient buffers never
move). The step's scalars (lr, the bias corrections c1/c2, betas, eps,
weight decay) are computed on the host and passed by value; the global
grad norm for clipping stays on the device. A CUDA state launches the
kernel, a CPU state runs ``fused_adam_reference`` tensor by tensor.
"""

from typing import NamedTuple, Optional

import torch

from ._common import check_launch, use_kernel

CHUNK = 4096          # elements per CTA (csrc/fused_adam.cu)


class AdamScalars(NamedTuple):
    """The per-step scalars of the update (host floats)."""
    lr: float
    b1: float
    b2: float
    c1: float
    c2: float
    eps: float
    wd: float = 0.0        # decoupled weight decay (AdamW)
    l2: float = 0.0        # L2 added to the grad (plain Adam with decay)


@torch.no_grad()
def fused_adam_reference(p, g, m, v, sc: AdamScalars, grad_norm=None,
                         max_norm: float = 0.0):
    """The kernel's function on one fp32 tensor, in place on p, m, v:
    optax's global-norm clip (``norm < max_norm`` keeps g, else
    g / norm * max_norm), L2, then the Adam moments and the update
    ``m c1 / (sqrt(v c2) + eps) + wd p`` scaled by -lr."""
    if grad_norm is not None:
        g = torch.where(grad_norm < max_norm, g, g / grad_norm * max_norm)
    if sc.l2:
        g = g + sc.l2 * p
    m.mul_(sc.b1).add_((1.0 - sc.b1) * g)
    v.mul_(sc.b2).add_((1.0 - sc.b2) * g * g)
    u = m * sc.c1 / (torch.sqrt(v * sc.c2) + sc.eps) + sc.wd * p
    p.sub_(sc.lr * u)


class FusedAdamState:
    """Adam moments of a parameter list, and (on a card) the device table
    the kernel reads. ``grads`` are the fp32 buffers the gradients are
    accumulated into; they, like the parameters, must keep their storage
    for the life of the state (checked at every step)."""

    def __init__(self, params, grads):
        self.params, self.grads = list(params), list(grads)
        for p, g in zip(self.params, self.grads, strict=True):
            if (p.dtype != torch.float32 or g.dtype != torch.float32
                    or p.shape != g.shape or p.device != g.device
                    or not (p.is_contiguous() and g.is_contiguous())):
                raise ValueError(
                    "fused_adam takes contiguous fp32 parameters and "
                    f"gradients of one shape and device; got {p.dtype} "
                    f"{tuple(p.shape)} and {g.dtype} {tuple(g.shape)}")
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
        """The (p, g, m, v, n) table and block offsets, copied to the card
        once."""
        rows, starts, blocks = [], [], 0
        for p, g, m, v in zip(self.params, self.grads, self.exp_avg,
                              self.exp_avg_sq):
            rows.append([p.data_ptr(), g.data_ptr(), m.data_ptr(),
                         v.data_ptr(), p.numel()])
            starts.append(blocks)
            blocks += -(-p.numel() // CHUNK)
        if blocks >= 2 ** 31:
            raise ValueError(f"fused_adam: {blocks} blocks exceed the grid")
        self._table = torch.tensor(rows, dtype=torch.int64).to(self.device)
        self._block_start = torch.tensor(starts, dtype=torch.int32).to(
            self.device)
        self._n_blocks = blocks
        self._ptrs = self._pointers()


def fused_adam(state: FusedAdamState, sc: AdamScalars,
               grad_norm: Optional[torch.Tensor] = None,
               max_norm: float = 0.0):
    """One Adam step over every tensor of ``state``, in place. grad_norm:
    the global pre-clip grad norm (a 0-dim fp32 tensor on the state's
    device) to clip against ``max_norm``, or None for no clipping."""
    if not state.params:
        return
    if use_kernel(state.params[0]):
        _launch(state, sc, grad_norm, max_norm)
        return
    for p, g, m, v in zip(state.params, state.grads, state.exp_avg,
                          state.exp_avg_sq):
        fused_adam_reference(p, g, m, v, sc, grad_norm, max_norm)


def _launch(state, sc, grad_norm, max_norm):
    from . import op_builder
    if state._pointers() != state._ptrs:
        raise RuntimeError("fused_adam: a parameter, gradient or moment "
                           "moved since its state was built; the device "
                           "table would point at stale storage")
    if grad_norm is not None:
        if (grad_norm.device != state.device
                or grad_norm.dtype != torch.float32 or grad_norm.numel() != 1):
            raise ValueError("fused_adam: grad_norm must be one fp32 value "
                             f"on {state.device}")
        grad_norm = grad_norm.contiguous()
    lib = op_builder.load()
    status = lib.fused_adam(
        state._table.data_ptr(), state._block_start.data_ptr(),
        len(state.params), state._n_blocks,
        grad_norm.data_ptr() if grad_norm is not None else None,
        sc.lr, sc.b1, 1.0 - sc.b1, sc.b2, 1.0 - sc.b2, sc.c1, sc.c2, sc.eps,
        sc.wd, sc.l2, float(max_norm),
        torch.cuda.current_stream(state.device).cuda_stream)
    check_launch(status, "fused_adam")
    fused_adam.launches += 1


fused_adam.launches = 0
