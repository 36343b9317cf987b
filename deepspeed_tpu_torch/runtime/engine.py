"""Training engine (counterpart of ``deepspeed_tpu/runtime/engine.py``
``DeepSpeedEngine``).

Ported parts: config, precision and optimizer setup (``__init__`` :68,
``_configure_optimizer`` :583), gradient accumulation
(``_make_accumulate_fn`` :852), the train step (``_make_train_step``
:945), ``train_batch`` (:1058), the reference's own loop ``forward``
(:1273, ``engine(batch)``), ``backward`` (:1354) and ``step`` (:1388),
the weight projections (:243-253, :1208), ``eval_batch`` (:1532), the
accessors (:1550-1576), checkpoints (``save_checkpoint`` :1584,
``wait_checkpoint``, ``destroy``, ``load_checkpoint`` :1640; the format
in ``runtime/checkpointing.py``) and the 16-bit export
(``save_16bit_model`` :1683). One card: the parameters are the module's
fp32 master weights, the model computes in its config's dtype (bf16 by
default).

A train step runs ``gradient_accumulation_steps`` microbatches; each adds
the gradient of ``loss / gas`` into fp32 buffers that live as the
parameters' ``.grad`` for the engine's life (the optimizer kernel's
pointer table is built over them once). Then the global pre-clip grad
norm, and the fused optimizer's launches (one for Adam, two for LAMB)
that clip as optax's ``clip_by_global_norm`` does (``norm < max`` keeps
g, else g / norm * max; torch's ``clip_grad_norm_`` is a different
function). The loss, the norm and the clip decision stay on the device:
``train_batch`` never waits on the card and returns the mean loss as a
0-dim device tensor. ``forward``/``backward``/``step`` run the same
microbatch and optimizer code one call at a time: ``backward`` adds the
gradient of ``loss / gas`` into the same buffers (the first one after a
step zeroes them), ``step`` runs the optimizer at the boundary.

After each optimizer step the compression and MoQ projections
(``compression_training``, ``quantize_training``) snap the fp32 masters
in place (``_apply_weight_projections`` :1208), on the quantize and
dequantize kernels.

Attention dropout takes seed words derived with ``ops.dropout.fold_seed``
from (seed, step, microbatch) in ``train_batch`` and from (seed,
micro_steps + 1) in ``forward``, as the JAX engine folds its key (:1337),
so a run is reproducible and the CPU and the card drop the same
elements. With dropout on, the two conventions draw different bits by
design (in JAX too); with it off they agree bit for bit.
"""

import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops._common import resolve_device
from ..ops.dropout import fold_seed, seed_words
from .config import DeepSpeedConfig
from .config_utils import logger
from .lr_schedules import get_lr_schedule
from .optimizers import Optimizer, build_optimizer


class DeepSpeedEngine:
    """Train-loop owner. Construct via ``deepspeed_tpu_torch.initialize``.

    loss_fn(model, batch, rng, train, **loss_kwargs) -> scalar loss: the
    JAX package's order without ``params`` (they live in the module);
    ``rng`` is the microbatch's dropout seed words (s0, s1), for
    ``model(..., dropout_seed=rng)``; ``loss_kwargs`` are the keyword
    operands given to ``train_batch``, ``forward`` or ``eval_batch``,
    passed through unchanged.
    """

    def __init__(self, model: torch.nn.Module, config, *,
                 loss_fn: Callable,
                 optimizer: Optional[Optimizer] = None,
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
        self.skipped_steps = 0      # no fp16 overflow skips: bf16 or fp32
        self.dp_world_size = 1
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
        self._configure_weight_projections()
        self._last_loss = None
        self._last_grad_norm = None
        self._pending_loss = None   # forward's loss, for backward
        self._accum_count = 0       # backward calls since the last step
        self._pending_ckpt = None   # an async save not yet published
        self._async_writer = None
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
            if not isinstance(client_optimizer, Optimizer):
                raise TypeError(
                    "optimizer must be a deepspeed_tpu_torch.runtime."
                    "optimizers.Adam, Lamb, Adagrad or SGD (other client "
                    "optimizers come with a later slice of the port)")
            self.optimizer = client_optimizer
        else:
            opt_type = cfg.optimizer.type if cfg.optimizer else "Adam"
            opt_params = dict(cfg.optimizer.params) if cfg.optimizer else {}
            self.optimizer = build_optimizer(opt_type, opt_params,
                                             lr_schedule=self.lr_schedule)
        self.optimizer_state = self.optimizer.init(self._params, self._grads)

    def _configure_weight_projections(self):
        """Compression-aware training and MoQ (JAX :243-253): the
        projections that ``train_batch`` applies after each optimizer
        step, on the parameters named by their flax ``keystr`` paths."""
        from ..compression.compress import init_compression, param_paths
        from .config_utils import dict_to_dataclass
        from .quantize import MoQConfig, MoQQuantizer
        self.compression_scheduler = init_compression(
            self.config.compression_training)
        self.moq_quantizer = None
        qt = dict(self.config.quantize_training or {})
        if qt.get("enabled", False):
            self.moq_quantizer = MoQQuantizer(
                dict_to_dataclass(MoQConfig, qt, "quantize_training"))
        self._named_params = param_paths(self.module)

    @torch.no_grad()
    def _apply_weight_projections(self):
        """Gas-boundary weight projections (JAX :1208), in JAX's order:
        compression (fake-quant and pruning masks), then MoQ's snap, on the
        fp32 masters in place at the step count after the increment. The
        bits and the schedule are host integers: nothing is read back."""
        step = self.global_steps
        comp = self.compression_scheduler
        if comp is not None and comp.active(step):
            comp.apply(self._named_params, step)
        if self.moq_quantizer is not None:
            self.moq_quantizer.quantize(self._named_params, step)

    def _to_device(self, x):
        """An array or tensor on the engine's device, copied from pinned
        memory without blocking the host."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _to_micro(self, x):
        """[train_batch_size, ...] -> [gas, micro, ...] on the device."""
        cfg = self.config
        if x.shape[0] != cfg.train_batch_size:
            raise ValueError(f"batch leading dim {x.shape[0]} != "
                             f"train_batch_size {cfg.train_batch_size}")
        return self._to_device(x).reshape(
            cfg.gradient_accumulation_steps,
            cfg.train_micro_batch_size_per_gpu, *x.shape[1:])

    def global_grad_norm(self):
        """sqrt of the sum of squares of every gradient, fp32, on the
        device (JAX :936)."""
        return torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(self._grads)))

    def _optimizer_step(self):
        """The boundary of a gradient-accumulation window, shared by
        ``train_batch`` and ``step`` (JAX :1434 and :1413-1419, in its
        order): the global grad norm, the optimizer launch with the clip,
        the step and sample counts, then the weight projections."""
        cfg = self.config
        gnorm = self.global_grad_norm()
        clip = cfg.gradient_clipping
        self.optimizer.step(self.optimizer_state,
                            grad_norm=gnorm if clip > 0 else None,
                            max_norm=clip)
        self.global_steps += 1
        self.global_samples += cfg.train_batch_size
        self._last_grad_norm = gnorm
        self._apply_weight_projections()

    def train_batch(self, batch: Dict[str, Any], **loss_kwargs):
        """One optimizer step over a global batch [train_batch_size, ...]
        (a dict of arrays or tensors). Returns the mean microbatch loss, a
        0-dim fp32 tensor on the engine's device. ``loss_kwargs`` go to
        every microbatch's ``loss_fn`` call."""
        if self._accum_count:
            raise RuntimeError(
                "train_batch() inside an open forward()/backward() window: "
                "finish it with step() first (both conventions accumulate "
                "into the same gradient buffers)")
        gas = self.config.gradient_accumulation_steps
        batch = {k: self._to_micro(v) for k, v in batch.items()}
        self.module.train()
        torch._foreach_zero_(self._grads)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        step_words = fold_seed(self._seed, self.global_steps + 1)
        for i in range(gas):
            mb = {k: v[i] for k, v in batch.items()}
            loss = self._loss_fn(self.module, mb, fold_seed(step_words, i),
                                 True, **loss_kwargs)
            (loss / gas).backward()
            loss_sum += loss.detach().float()
        mean_loss = loss_sum / gas
        self.micro_steps += gas
        self._optimizer_step()
        self._last_loss = mean_loss
        return mean_loss

    # ------------------------------------------------------------------
    # the reference's forward / backward / step calling convention
    # ------------------------------------------------------------------

    def forward(self, batch: Dict[str, Any], **loss_kwargs):
        """The loss of one microbatch (a dict of arrays or tensors) in
        training mode, its graph kept for ``backward``. The dropout seed
        words are ``fold_seed(seed, micro_steps + 1)``, as the JAX engine
        folds ``micro_steps + 1`` (:1337). Returns the loss tensor."""
        batch = {k: self._to_device(v) for k, v in batch.items()}
        self.module.train()
        loss = self._loss_fn(self.module, batch,
                             fold_seed(self._seed, self.micro_steps + 1),
                             True, **loss_kwargs)
        self._pending_loss = loss
        self._last_loss = loss.detach()
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Add the gradient of the last ``forward``'s loss / gas into the
        fp32 gradient buffers (the first call after a step zeroes them
        first). As in the JAX engine, ``loss`` is taken for the
        reference's signature: the gradient is that of the loss the last
        ``forward`` returned."""
        if self._pending_loss is None:
            raise RuntimeError(
                "backward() called without a preceding forward()")
        if self._accum_count == 0:
            torch._foreach_zero_(self._grads)
        gas = self.config.gradient_accumulation_steps
        (self._pending_loss / gas).backward()
        self._pending_loss = None
        self._accum_count += 1
        self.micro_steps += 1

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._accum_count >= self.config.gradient_accumulation_steps

    def step(self):
        """The optimizer step at the gradient-accumulation boundary; before
        it, nothing."""
        if not self.is_gradient_accumulation_boundary():
            return
        self._optimizer_step()
        self._accum_count = 0

    @torch.no_grad()
    def eval_batch(self, batch: Dict[str, Any], **loss_kwargs):
        """The loss of ``batch`` (any leading dim) in eval mode, without
        dropout and without gradients (JAX :1532)."""
        self.module.eval()
        batch = {k: self._to_device(v) for k, v in batch.items()}
        return self._loss_fn(self.module, batch, seed_words(0), False,
                             **loss_kwargs)

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

    # ------------------------------------------------------------------
    # checkpoints (JAX :1584-1690; the format in runtime/checkpointing.py)
    # ------------------------------------------------------------------

    def save_checkpoint(self, save_dir, tag=None, client_state=None,
                        save_latest=True, async_save=False):
        """Write the parameters, the optimizer state and the counters under
        ``save_dir/tag`` (default ``global_step{n}``). ``async_save``:
        the state is copied to host memory before this returns and written
        on a background thread; ``latest`` is published once the write is
        durable (``wait_checkpoint()``, the next save, ``destroy()``).
        Returns the tag's path."""
        from .checkpointing import save_engine_checkpoint
        return save_engine_checkpoint(self, save_dir, tag=tag,
                                      client_state=client_state,
                                      save_latest=save_latest,
                                      async_save=async_save)

    def wait_checkpoint(self):
        """Join the in-flight async save and publish its ``latest``;
        returns its path, or None when none is in flight."""
        from .checkpointing import finalize_pending_checkpoint
        return finalize_pending_checkpoint(self)

    def destroy(self):
        """Join and publish a pending async save, and release the writer
        thread. Idempotent."""
        from .checkpointing import close_async_checkpointer
        close_async_checkpointer(self)

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True,
                        load_lr_scheduler_states=True,
                        load_module_only=False):
        """Restore a tag (``latest``'s when None) into the engine's tensors
        in place, verified against its manifest (a torn ``latest`` tag
        falls back to the newest verified one). Returns (path,
        client_state), or (None, {}) when there is nothing to load. The LR
        schedule is a function of the step: ``load_lr_scheduler_states``
        changes nothing, as in the JAX engine. An open forward/backward
        window is dropped."""
        self.wait_checkpoint()   # an in-flight async save must land first
        from .checkpointing import load_engine_checkpoint
        out = load_engine_checkpoint(
            self, load_dir, tag=tag,
            load_optimizer_states=load_optimizer_states,
            load_module_only=load_module_only)
        if out[0] is not None:
            self._pending_loss = None
            self._accum_count = 0
        return out

    def _zero3_consolidated_16bit_state_dict(self, dtype=torch.bfloat16):
        """The flax tree ``{"params": {"h_0": {...}, ...}}`` of the
        module's parameters as CPU tensors, floating ones cast to ``dtype``
        (JAX :1659; one card holds every parameter whole)."""
        from ..compression.compress import keystr
        from .checkpointing import path_keys
        tree = {}
        for name, p in self.module.named_parameters():
            t = p.detach()
            if t.is_floating_point():
                t = t.to(dtype)
            *parents, leaf = path_keys(keystr(name))
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = t.cpu()
        return tree

    def save_16bit_model(self, save_dir, save_filename="model_states.msgpack",
                         dtype=torch.bfloat16):
        """Write the half-precision parameters as one file in flax's
        msgpack layout (JAX :1683): the JAX package reads it with
        ``flax.serialization.from_bytes``/``msgpack_restore``, and
        ``models.convert.params_from_jax`` turns it back into the port's
        state dict. Returns the path."""
        from .serialization import to_bytes
        data = to_bytes(self._zero3_consolidated_16bit_state_dict(dtype))
        os.makedirs(save_dir, exist_ok=True)
        path = os.path.join(save_dir, save_filename)
        with open(path, "wb") as f:
            f.write(data)
        logger.info(f"16-bit model saved to {path}")
        return path
