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
outside fp16 ``train_batch`` never waits on the card and returns the mean
loss as a 0-dim device tensor. ``forward``/``backward``/``step`` run the
same microbatch and optimizer code one call at a time: ``backward`` adds
the gradient of ``loss / gas`` into the same buffers (the first one after
a step zeroes them), ``step`` runs the optimizer at the boundary.

fp16 (JAX :118-123, :862-994): each microbatch differentiates
``loss * scale / gas`` (the forward/backward convention: ``loss * scale``,
its gradient then divided by gas), the step unscales the buffers, takes
the norm of the unscaled gradients, checks every element for
finiteness, and updates the loss scale (``runtime/fp16/loss_scaler.py``).
An overflowed step skips the optimizer, whose count, bias corrections
and learning rate stay where they were, while ``global_steps`` and
``skipped_steps`` advance. The optimizer's count and learning rate live
on the host, so fp16 reads the finite flag back once a step.

``data_types.grad_accum_dtype = bf16`` (JAX :862-912, :1362-1370): the
buffers are bf16 tensors beside the parameters (``.grad`` stays None);
each microbatch's fp32 gradient, of ``loss / gas`` in ``train_batch`` or
of ``loss`` divided by gas afterwards in ``backward``, is cast to bf16 and
added. The fused optimizers read them through their bf16-gradient kernels.

``activation_checkpointing`` sets the model's remat policy
(``_apply_activation_checkpointing_config``, JAX :306-392) and
``progressive_layer_drop`` hands ``layer_keep_prob`` (theta of the step,
a 0-dim fp32 tensor) to a ``loss_fn`` that takes it (JAX :214-237).

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

import dataclasses
import inspect
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..ops._common import resolve_device
from ..ops.dropout import fold_seed, seed_words
from .config import DeepSpeedConfig
from .config_utils import logger
from .fp16.loss_scaler import grads_finite, init_loss_scale, update_scale
from .lr_schedules import get_lr_schedule
from .optimizers import Optimizer, build_optimizer
from .progressive_layer_drop import ProgressiveLayerDrop


def _cast_add_hook(buf, divisor):
    """A parameter's post-accumulate-grad hook for a bf16 buffer ``buf``:
    during the engine's backward (``divisor[0]`` set) the fp32 gradient
    autograd just finished is divided, cast to the buffer's dtype and
    added (JAX's round-then-add, :906), and ``.grad`` is dropped. The
    hook holds the buffer and the divisor cell, not the engine."""
    def hook(p):
        if divisor[0] is None:
            return
        g, p.grad = p.grad, None
        if divisor[0] != 1:
            g = g.div_(divisor[0])
        buf.add_(g.to(buf.dtype))
    return hook


class DeepSpeedEngine:
    """Train-loop owner. Construct via ``deepspeed_tpu_torch.initialize``.

    loss_fn(model, batch, rng, train, **loss_kwargs) -> scalar loss: the
    JAX package's order without ``params`` (they live in the module);
    ``rng`` is the microbatch's dropout seed words (s0, s1), for
    ``model(..., dropout_seed=rng)``; ``loss_kwargs`` are the keyword
    operands given to ``train_batch``, ``forward`` or ``eval_batch``,
    passed through unchanged (with progressive layer drop, training calls
    also get ``layer_keep_prob`` when the ``loss_fn`` takes it).
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
        self.skipped_steps = 0      # fp16 steps skipped on an overflow
        self.dp_world_size = 1
        self.zero_stage = config.zero_optimization.stage
        self._apply_activation_checkpointing_config()

        # ---- precision -----------------------------------------------------
        self.fp16_enabled = config.fp16.enabled
        self.bf16_enabled = config.bf16.enabled
        fp16 = config.fp16
        self.loss_scale_state = init_loss_scale(
            0.0 if fp16.dynamic_loss_scale else fp16.loss_scale,
            fp16.initial_scale_power, hysteresis=fp16.hysteresis,
            device=self.device) if self.fp16_enabled else None
        self._accum_dtype = getattr(torch, config.data_types.resolve())
        self._seed = seed_words(seed)

        # ---- fp32 master weights and their gradient buffers ---------------
        # fp32 buffers are the parameters' .grad (autograd adds into them);
        # bf16 ones sit beside the parameters and take each microbatch's
        # gradient cast to bf16 as it arrives (_cast_add_hook)
        self._params = [p for p in self.module.parameters()
                        if p.requires_grad]
        for p in self._params:
            if p.dtype != torch.float32:
                raise TypeError(f"the engine trains fp32 master weights; a "
                                f"parameter is {p.dtype}")
            if self._accum_dtype == torch.float32:
                p.grad = torch.zeros_like(p)
        self._grads = [p.grad if self._accum_dtype == torch.float32 else
                       torch.zeros_like(p, dtype=self._accum_dtype)
                       for p in self._params]
        # the divisor of a backward that feeds the bf16 buffers; None
        # outside the engine's own backward (the hooks then do nothing)
        self._grad_divisor = [None]
        if self._accum_dtype != torch.float32:
            for p, buf in zip(self._params, self._grads):
                p.register_post_accumulate_grad_hook(
                    _cast_add_hook(buf, self._grad_divisor))

        self._configure_optimizer(optimizer, lr_scheduler)
        self._configure_progressive_layer_drop(loss_fn)
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
            f"{self._precision()} grad_accum={str(self._accum_dtype)[6:]}")

    def _precision(self):
        return ("fp16" if self.fp16_enabled else
                "bf16" if self.bf16_enabled else "fp32")

    def _apply_activation_checkpointing_config(self):
        """The ``activation_checkpointing`` block (JAX :306-392): present,
        it sets the model's remat policy (``remat_policy``, else the
        model's own, else ``full``) on models that carry a config with a
        ``remat`` field (``models.GPT``, ``BertForPreTraining``). Knobs
        with no counterpart on one card warn; ``cpu_checkpointing`` and
        the ``offload`` policy raise at config read."""
        raw = self.config._raw.get("activation_checkpointing")
        if raw is None:
            return
        acfg = self.config.activation_checkpointing
        for knob in ("contiguous_memory_optimization",
                     "synchronize_checkpoint_boundary"):
            if raw.get(knob):
                logger.warning(
                    f"activation_checkpointing.{knob} has no counterpart "
                    "here (the caching allocator owns buffer layout; one "
                    "stream needs no explicit synchronization) — ignored")
        if raw.get("number_checkpoints"):
            logger.warning(
                "activation_checkpointing.number_checkpoints is ignored: "
                "remat granularity is per transformer block")
        if acfg.partition_activations:
            logger.warning(
                "activation_checkpointing.partition_activations needs a "
                "model-parallel mesh axis (mp=1 here) — no-op")
        mcfg = getattr(self.module, "config", None)
        if mcfg is None or not hasattr(mcfg, "remat"):
            logger.warning(
                "activation_checkpointing block set but the model does not "
                "expose a rematerialization config (models from "
                "deepspeed_tpu_torch.models do) — apply "
                "torch.utils.checkpoint in your own model code to honor it")
            return
        from ..models.layers import remat_policy
        remat = mcfg.remat if mcfg.remat != "none" else "full"
        if acfg.remat_policy is not None:
            remat_policy(acfg.remat_policy)
            remat = acfg.remat_policy
        if remat != mcfg.remat:
            new = dataclasses.replace(mcfg, remat=remat)
            for m in self.module.modules():     # BERT's encoder shares it
                if getattr(m, "config", None) is mcfg:
                    m.config = new
            logger.info(f"activation_checkpointing: model remat policy set "
                        f"to '{remat}'")

    def _configure_progressive_layer_drop(self, loss_fn):
        """PLD (JAX :214-237): theta reaches the model through the
        ``loss_fn`` as ``layer_keep_prob`` when it declares that keyword
        (or takes ``**kwargs``)."""
        pld = self.config.progressive_layer_drop
        self.progressive_layer_drop = (
            ProgressiveLayerDrop(theta=pld.theta, gamma=pld.gamma)
            if pld.enabled else None)
        try:
            sig = inspect.signature(loss_fn).parameters
            self._loss_fn_kwargs = {
                name for name, p in sig.items()
                if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)
            } | ({"*"} if any(p.kind == p.VAR_KEYWORD
                              for p in sig.values()) else set())
        except (TypeError, ValueError):  # builtins without signatures
            self._loss_fn_kwargs = {"*"}
        if (self.progressive_layer_drop is not None
                and not self._loss_accepts("layer_keep_prob")):
            logger.warning(
                "progressive_layer_drop is enabled but loss_fn does not "
                "accept a 'layer_keep_prob' kwarg — theta cannot reach the "
                "model and PLD is a no-op")

    def _loss_accepts(self, kwarg: str) -> bool:
        return "*" in self._loss_fn_kwargs or kwarg in self._loss_fn_kwargs

    def _train_kwargs(self, loss_kwargs):
        """The loss_fn's keyword operands of a training call: the caller's,
        and PLD's theta of this step (JAX :1113-1117)."""
        extra = dict(loss_kwargs)
        if (self.progressive_layer_drop is not None
                and self._loss_accepts("layer_keep_prob")):
            theta = self.progressive_layer_drop.update_state(
                self.global_steps)
            extra["layer_keep_prob"] = torch.tensor(
                theta, dtype=torch.float32, device=self.device)
        return extra

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
        device (JAX :936; bf16 buffers are widened, as JAX casts them)."""
        if self._accum_dtype == torch.float32:
            norms = torch._foreach_norm(self._grads)
        else:
            norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
                     for g in self._grads]
        return torch.linalg.vector_norm(torch.stack(norms))

    def _add_microbatch_grads(self, loss, divide_by_gas: bool):
        """Add the gradient of ``loss`` (divided by gas afterwards with
        ``divide_by_gas``, the forward/backward convention's g / gas) into
        the buffers: autograd's own add into the fp32 ``.grad`` where it
        can; bf16 buffers take each parameter's fp32 gradient (divided,
        then cast) as autograd finishes it, so one gradient at a time
        lives in fp32; else the fp32 gradients, divided, added in place."""
        gas = self.config.gradient_accumulation_steps
        if self._accum_dtype != torch.float32:
            self._grad_divisor[0] = gas if divide_by_gas else 1
            try:
                loss.backward()
            finally:
                self._grad_divisor[0] = None
            return
        if not divide_by_gas:
            loss.backward()
            return
        grads = torch.autograd.grad(loss, self._params, allow_unused=True)
        bufs = [b for b, g in zip(self._grads, grads) if g is not None]
        grads = [g for g in grads if g is not None]
        torch._foreach_div_(grads, gas)
        torch._foreach_add_(bufs, grads)

    def _optimizer_step(self):
        """The boundary of a gradient-accumulation window, shared by
        ``train_batch`` and ``step`` (JAX :1434 and :1413-1419, in its
        order): the fp16 unscale, the global grad norm, the optimizer
        launch with the clip (skipped on an fp16 overflow, JAX :975-994),
        the loss-scale update, the step and sample counts, then the weight
        projections."""
        cfg = self.config
        scaler = self.loss_scale_state
        if self.fp16_enabled:
            torch._foreach_mul_(self._grads, 1.0 / scaler.scale)
        gnorm = self.global_grad_norm()
        clip = cfg.gradient_clipping
        finite = grads_finite(self._grads) if self.fp16_enabled else None
        # fp16: the one host read of a step, the finite flag (the
        # optimizer's count and learning rate live on the host)
        if finite is None or bool(finite):
            self.optimizer.step(self.optimizer_state,
                                grad_norm=gnorm if clip > 0 else None,
                                max_norm=clip)
        else:
            self.skipped_steps += 1
        if self.fp16_enabled:
            f16 = cfg.fp16
            self.loss_scale_state = update_scale(
                scaler, finite, dynamic=f16.dynamic_loss_scale,
                scale_window=f16.loss_scale_window,
                hysteresis=f16.hysteresis, min_scale=f16.min_loss_scale)
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
        extra = self._train_kwargs(loss_kwargs)
        for i in range(gas):
            mb = {k: v[i] for k, v in batch.items()}
            loss = self._loss_fn(self.module, mb, fold_seed(step_words, i),
                                 True, **extra)
            self._add_microbatch_grads(
                loss * self.loss_scale_state.scale / gas
                if self.fp16_enabled else loss / gas, divide_by_gas=False)
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
                             True, **self._train_kwargs(loss_kwargs))
        self._pending_loss = loss
        self._last_loss = loss.detach()
        return loss

    __call__ = forward

    def backward(self, loss=None):
        """Add the gradient of the last ``forward``'s loss / gas into the
        gradient buffers (the first call after a step zeroes them first);
        in fp16 and with bf16 buffers, the gradient of ``loss * scale``
        (resp. ``loss``) divided by gas, as JAX orders it (:1362-1370). As
        in the JAX engine, ``loss`` is taken for the reference's
        signature: the gradient is that of the loss the last ``forward``
        returned."""
        if self._pending_loss is None:
            raise RuntimeError(
                "backward() called without a preceding forward()")
        if self._accum_count == 0:
            torch._foreach_zero_(self._grads)
        gas = self.config.gradient_accumulation_steps
        if self.fp16_enabled:
            self._add_microbatch_grads(
                self._pending_loss * self.loss_scale_state.scale,
                divide_by_gas=True)
        elif self._accum_dtype != torch.float32:
            self._add_microbatch_grads(self._pending_loss,
                                       divide_by_gas=True)
        else:
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
        """The live loss scale (a host read in fp16), else 1.0."""
        if not self.fp16_enabled:
            return 1.0
        return float(self.loss_scale_state.scale)

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
