"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu`` for an
NVIDIA H100 (Hopper).

The port mirrors the JAX package's layout module for module; each TPU
(Pallas) kernel on a ported path is a hand-written CUDA kernel here,
built with ``nvcc`` at first use (``ops/op_builder.py``), with its plain
PyTorch version beside it. Entry points run on the card unless the
caller passes ``device="cpu"``. This package never imports JAX or
``deepspeed_tpu``.
"""

__version__ = "0.1.0"


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mpu=None,
               dist_init_required=None, collate_fn=None, config=None,
               config_params=None, *, loss_fn=None, seed: int = 42,
               device=None):
    """Create a training engine (counterpart of
    ``deepspeed_tpu.initialize``). Returns (engine, optimizer, None,
    lr_schedule) like the JAX package; the dataloader slot is None until
    the dataloader slice lands.

    model: a ``torch.nn.Module`` with fp32 parameters (``models.GPT``);
    model_parameters: optional state dict loaded into it first (e.g.
    ``models.convert.params_from_jax``); config: a dict, a JSON path or a
    ``runtime.config.DeepSpeedConfig`` (or ``config_params``, or
    ``args.deepspeed_config``); loss_fn(model, batch, rng, train) -> loss;
    seed: the dropout seed (``PRNGKey(seed)``'s words); device: None
    means CUDA (raises without a card), "cpu" runs the plain versions.
    """
    from .runtime.engine import DeepSpeedEngine
    if training_data is not None or collate_fn is not None:
        raise NotImplementedError(
            "initialize(training_data=...) comes with the dataloader slice "
            "of the port; pass batches to engine.train_batch")
    if mpu is not None:
        raise NotImplementedError(
            "initialize(mpu=...) comes with the multi-GPU slice of the port")
    cfg = config if config is not None else config_params
    if cfg is None and getattr(args, "deepspeed_config", None):
        cfg = args.deepspeed_config
    if isinstance(cfg, str):
        import json
        with open(cfg) as f:
            cfg = json.load(f)
    if model_parameters is not None:
        model.load_state_dict(model_parameters)
    engine = DeepSpeedEngine(model, cfg if cfg is not None else {},
                             loss_fn=loss_fn, optimizer=optimizer,
                             lr_scheduler=lr_scheduler, seed=seed,
                             device=device)
    return engine, engine.optimizer, None, engine.lr_schedule


def init_inference(model=None, **kwargs):
    """Create an inference engine (counterpart of
    ``deepspeed_tpu.init_inference``)."""
    from .inference.engine import InferenceEngine
    return InferenceEngine(model, **kwargs)
