"""Training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``
``DeepSpeedEngine``).

Ported parts: config, precision and optimizer setup (``__init__`` :68,
``_configure_optimizer`` :583), gradient accumulation
(``_make_accumulate_fn`` :852), the train step (``_make_train_step``
:945), ``train_batch`` (:1058), ``eval_batch`` (:1532) and the accessors
(:1550-1576). One card: the parameters are the module's fp32 master
weights, the model computes in its config's dtype (bf16 by default).

A train step runs ``gradient_accumulation_steps`` microbatches; each adds
the gradient of ``loss / gas`` into fp32 buffers that live as the
parameters' ``.grad`` for the engine's life (the optimizer kernel's
pointer table is built over them once). Then the global pre-clip grad
norm, and one fused Adam launch that clips as optax's
``clip_by_global_norm`` does (``norm < max`` keeps g, else g / norm *
max; torch's ``clip_grad_norm_`` is a different function). The loss, the
norm and the clip decision stay on the device: ``train_batch`` never
waits on the card and returns the mean loss as a 0-dim device tensor.

Attention dropout takes seed words derived from (seed, step,
microbatch) with ``ops.dropout.fold_seed``, so a run is reproducible and
the CPU and the card drop the same elements.
"""

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops._common import resolve_device
from ..ops.dropout import fold_seed, seed_words
from .config import DeepSpeedConfig
from .config_utils import logger
from .lr_schedules import get_lr_schedule
from .optimizers import Adam, build_optimizer


class DeepSpeedEngine:
    """Train-loop owner. Construct via ``deepspeed_tpu_torch.initialize``.

    loss_fn(model, batch, rng, train) -> scalar loss: the JAX package's
    order without ``params`` (they live in the module); ``rng`` is the
    microbatch's dropout seed words (s0, s1), for
    ``model(..., dropout_seed=rng)``.
    """

    def __init__(self, model: torch.nn.Module, config, *,
                 loss_fn: Callable, optimizer: Optional[Adam] = None,
                 lr_scheduler: Optional[Callable] = None, seed: int = 42,
                 device=None):
        if isinstance(config, dict):
            config = DeepSpeedConfig.from_dict(config)
        if not isinstance(config, DeepSpeedConfig):
            raise TypeError(f"config must be a dict or DeepSpeedConfig, got "
                            f"{type(config).__name__}")
        if loss_fn is None:
            raise ValueError("the engine needs loss_fn(model, batch, rng, "
                             "train) -> loss")
        self.config = config
        self.device = resolve_device(device)
        self.module = model.to(self.device)
        self._loss_fn = loss_fn
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.zero_stage = config.zero_optimization.stage
        self.fp16_enabled = False
        self.bf16_enabled = config.bf16.enabled
        self._seed = seed_words(seed)

        # ---- fp32 master weights and their gradient buffers ---------------
        self._params = [p for p in self.module.parameters()
                        if p.requires_grad]
        for p in self._params:
            if p.dtype != torch.float32:
                raise TypeError(f"the engine trains fp32 master weights; a "
                                f"parameter is {p.dtype}")
            p.grad = torch.zeros_like(p)
        self._grads = [p.grad for p in self._params]

        self._configure_optimizer(optimizer, lr_scheduler)
        self._last_loss = None
        self._last_grad_norm = None
        logger.info(
            f"DeepSpeedEngine ready on {self.device}: micro_batch="
            f"{config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} precision="
            f"{'bf16' if self.bf16_enabled else 'fp32'}")

    def _configure_optimizer(self, client_optimizer, client_scheduler):
        """JAX :583-607: LR schedule (client > config scheduler > constant
        optimizer lr), the optimizer (client > config block), clipping."""
        cfg = self.config
        base_lr = (cfg.optimizer.params.get("lr", 1e-3) if cfg.optimizer
                   else 1e-3)
        if client_scheduler is not None:
            self.lr_schedule = client_scheduler
        elif cfg.scheduler and cfg.scheduler.type:
            self.lr_schedule = get_lr_schedule(cfg.scheduler.type,
                                               cfg.scheduler.params)
        else:
            self.lr_schedule = lambda step: base_lr
        if client_optimizer is not None:
            if not isinstance(client_optimizer, Adam):
                raise TypeError(
                    "optimizer must be a deepspeed_tpu_torch.runtime."
                    "optimizers.Adam (other client optimizers come with a "
                    "later slice of the port)")
            self.optimizer = client_optimizer
        else:
            opt_type = cfg.optimizer.type if cfg.optimizer else "Adam"
            opt_params = dict(cfg.optimizer.params) if cfg.optimizer else {}
            self.optimizer = build_optimizer(opt_type, opt_params,
                                             lr_schedule=self.lr_schedule)
        self.optimizer_state = self.optimizer.init(self._params, self._grads)

    def _to_micro(self, x):
        """[train_batch_size, ...] -> [gas, micro, ...] on the device,
        copied from pinned memory without blocking the host."""
        cfg = self.config
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if t.shape[0] != cfg.train_batch_size:
            raise ValueError(f"batch leading dim {t.shape[0]} != "
                             f"train_batch_size {cfg.train_batch_size}")
        t = t.reshape(cfg.gradient_accumulation_steps,
                      cfg.train_micro_batch_size_per_gpu, *t.shape[1:])
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def global_grad_norm(self):
        """sqrt of the sum of squares of every gradient, fp32, on the
        device (JAX :936)."""
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(self._grads)))

    def train_batch(self, batch: Dict[str, Any]):
        """One optimizer step over a global batch [train_batch_size, ...]
        (a dict of arrays or tensors). Returns the mean microbatch loss, a
        0-dim fp32 tensor on the engine's device."""
        cfg = self.config
        gas = cfg.gradient_accumulation_steps
        batch = {k: self._to_micro(v) for k, v in batch.items()}
        self.module.train()
        torch._foreach_zero_(self._grads)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        step_words = fold_seed(self._seed, self.global_steps + 1)
        for i in range(gas):
            mb = {k: v[i] for k, v in batch.items()}
            loss = self._loss_fn(self.module, mb, fold_seed(step_words, i),
                                 True)
            (loss / gas).backward()
            loss_sum += loss.detach().float()
        mean_loss = loss_sum / gas
        gnorm = self.global_grad_norm()
        clip = cfg.gradient_clipping
        self.optimizer.step(self.optimizer_state,
                            grad_norm=gnorm if clip > 0 else None,
                            max_norm=clip)
        self.global_steps += 1
        self.micro_steps += gas
        self.global_samples += cfg.train_batch_size
        self._last_loss = mean_loss
        self._last_grad_norm = gnorm
        return mean_loss

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any]):
        """The loss of ``batch`` (any leading dim) in eval mode, without
        dropout and without gradients (JAX :1532)."""
        self.module.eval()
        batch = {k: (v if isinstance(v, torch.Tensor)
                     else torch.from_numpy(np.ascontiguousarray(v))
                     ).to(self.device) for k, v in batch.items()}
        return self._loss_fn(self.module, batch, seed_words(0), False)

    # ------------------------------------------------------------------
    # accessors (JAX :1550-1576)
    # ------------------------------------------------------------------

    def get_lr(self):
        return float(self.lr_schedule(self.global_steps))

    def get_loss_scale(self):
        return 1.0

    def zero_optimization_stage(self):
        return self.zero_stage

    def train_micro_batch_size_per_gpu(self):
        return self.config.train_micro_batch_size_per_gpu

    def train_batch_size(self):
        return self.config.train_batch_size

    def gradient_accumulation_steps(self):
        return self.config.gradient_accumulation_steps

    def get_global_grad_norm(self):
        """Global pre-clip grad norm of the most recent step (a host read:
        it waits for the step)."""
        if self._last_grad_norm is None:
            return None
        return float(self._last_grad_norm)

    def wall_clock_breakdown(self):
        """Always False: ``wall_clock_breakdown: true`` raises at config
        read until the observability slice."""
        return False
