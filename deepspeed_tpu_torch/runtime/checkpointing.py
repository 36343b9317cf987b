"""Engine checkpoint save and load (counterpart of
``deepspeed_tpu/runtime/checkpointing.py``).

A tag directory holds the port's own format, written with ``torch.save``
of CPU tensors and keyed by the flax ``keystr`` paths the port already
uses (``['params']['h_0']['attn']['qkv']['kernel']``)::

    save_dir/latest                  <- the tag, written atomically
    save_dir/<tag>/state.pt          <- {"params": {path: tensor},
                                         "optimizer_state": {"count": n,
                                           slot: {path: tensor}},
                                         fp16: "loss_scale": {field: 0-dim
                                           tensor}}
    save_dir/<tag>/engine_meta.json  <- the JAX package's keys, and
                                        micro_steps
    save_dir/<tag>/manifest.json     <- sizes and digests of the above

in the JAX package's order: state, meta, then (once the state is
durable) the manifest, then ``latest``. The manifest and ``latest`` are
``resilience/manifest.py``'s, in the JAX package's format.

A load copies into the engine's tensors in place: the fused optimizers'
device tables point at the parameters, gradients and moments, which must
never move. Unlike the JAX package, the meta file keeps ``micro_steps``,
so a run resumed under ``forward``/``backward``/``step`` folds the same
dropout seed words as the run it continues.

An async save snapshots the engine's tensors to host memory before it
returns, writes ``state.pt`` on a background thread and publishes the
manifest and ``latest`` only once the write is durable: at
``wait_checkpoint()``, at the next save, at ``destroy()`` or, for an
engine nobody waited on, at interpreter exit.
"""

import atexit
import json
import os
import re
import weakref
from concurrent.futures import ThreadPoolExecutor

import torch

from ..models.convert import _UNROLLED
from .config_utils import logger
from .resilience.config import IntegrityConfig
from .resilience.manifest import (LATEST_FILE, CheckpointCorruptionError,
                                  gc_checkpoints, resolve_verified_tag,
                                  write_latest, write_manifest)

STATE_FILE = "state.pt"
META_FILE = "engine_meta.json"
_KEY = re.compile(r"\['([^']*)'\]")

# engines with an async save in flight: a clean interpreter exit must not
# drop a save nobody waited on (weak refs: registration must never extend
# an engine's life)
_PENDING_ENGINES = weakref.WeakSet()


def _finalize_all_pending():
    """atexit hook: join and publish every in-flight async save."""
    for engine in list(_PENDING_ENGINES):
        try:
            finalize_pending_checkpoint(engine)
        except Exception as e:
            # atexit must not raise; the tag stays unpublished, which is
            # the protection this protocol gives a failed write
            logger.warning(f"atexit checkpoint finalize failed: {e}")


atexit.register(_finalize_all_pending)


def _integrity_config(engine):
    """The integrity policy: the defaults, as the JAX package takes them
    when the config has no ``resilience`` block (an enabled block raises
    at config read until the resilience slice)."""
    return IntegrityConfig()


def path_keys(path: str):
    """The keys of a ``keystr`` path, ``['params']`` first."""
    return _KEY.findall(path)


def port_name(path: str) -> str:
    """The port's parameter name of a ``keystr`` path (``h_0`` -> ``h.0``,
    the unrolled-layer rule of ``models/convert.py``)."""
    parts = []
    for key in path_keys(path)[1:]:
        m = _UNROLLED.fullmatch(key)
        parts.append(f"{m[1]}.{int(m[2])}" if m else key)
    return ".".join(parts)


def _host_copy(named):
    """{path: a CPU copy of the tensor}, detached from the engine's
    storage (a later step cannot leak into the copy)."""
    return {path: t.detach().to("cpu", copy=True) for path, t in named}


def snapshot_state(engine):
    """The engine's state as CPU tensors: parameters, the optimizer's
    slots and step count, and in fp16 the loss-scale state (JAX
    checkpointing.py:184-185)."""
    opt = engine.optimizer_state
    paths = [path for path, _ in engine._named_params]
    state = {"params": _host_copy(engine._named_params),
             "optimizer_state": {"count": int(opt.count), **{
                 slot: _host_copy(zip(paths, getattr(opt, slot)))
                 for slot in opt.SLOTS}}}
    if engine.fp16_enabled and engine.loss_scale_state is not None:
        state["loss_scale"] = _host_copy(
            engine.loss_scale_state._asdict().items())
    return state


def _write_state(path, state):
    with open(path, "wb") as f:
        torch.save(state, f)
        f.flush()
        os.fsync(f.fileno())


def _async_writer(engine):
    """One single-thread writer per engine."""
    if engine._async_writer is None:
        engine._async_writer = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
    return engine._async_writer


def finalize_pending_checkpoint(engine):
    """Block until the in-flight async save (if any) lands, then publish
    its manifest and ``latest``. Returns its path, or None."""
    pending = engine._pending_ckpt
    if pending is None:
        return None
    # consumed whatever happens: a failed write must neither wedge later
    # saves nor get its latest tag published on a retry
    engine._pending_ckpt = None
    _PENDING_ENGINES.discard(engine)
    save_dir, tag, save_latest, step, future = pending
    future.result()              # re-raises a failed write
    _publish_checkpoint(engine, save_dir, tag, save_latest, step)
    logger.info(f"async checkpoint {tag} finalized")
    return os.path.join(save_dir, tag)


def _publish_checkpoint(engine, save_dir, tag, save_latest, step):
    """After durability, for the sync save and the async finalize alike:
    the manifest, the atomic ``latest`` and retention GC. ``step`` is the
    step the save was taken at (the engine may have moved on since)."""
    path = os.path.join(save_dir, tag)
    icfg = _integrity_config(engine)
    if icfg.enabled:
        write_manifest(path, step=step, tag=tag, algorithm=icfg.algorithm)
    if save_latest:
        write_latest(save_dir, tag)
    if icfg.keep_last_n > 0:
        gc_checkpoints(save_dir, icfg.keep_last_n, protect=(tag,))


def close_async_checkpointer(engine):
    """Join and publish a pending save, then release the writer thread."""
    try:
        finalize_pending_checkpoint(engine)
    finally:
        writer = engine._async_writer
        if writer is not None:
            engine._async_writer = None
            writer.shutdown(wait=True)


def save_engine_checkpoint(engine, save_dir, tag=None, client_state=None,
                           save_latest=True, async_save=False):
    # at most one async save in flight: joining the previous one also
    # publishes its latest tag
    finalize_pending_checkpoint(engine)
    tag = str(tag or f"global_step{engine.global_steps}")
    save_dir = os.path.abspath(save_dir)
    path = os.path.join(save_dir, tag)
    os.makedirs(path, exist_ok=True)
    state = snapshot_state(engine)
    state_path = os.path.join(path, STATE_FILE)
    if async_save:
        future = _async_writer(engine).submit(_write_state, state_path,
                                              state)
        engine._pending_ckpt = (save_dir, tag, save_latest,
                                engine.global_steps, future)
        _PENDING_ENGINES.add(engine)
    else:
        _write_state(state_path, state)
    meta = {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "skipped_steps": engine.skipped_steps,
        "zero_stage": engine.zero_stage,
        "dp_world_size": engine.dp_world_size,
        "client_state": client_state or {},
        "micro_steps": engine.micro_steps,
    }
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f)
    if not async_save:
        _publish_checkpoint(engine, save_dir, tag, save_latest,
                            engine.global_steps)
    logger.info(f"saved checkpoint {path}")
    return path


def _corruption_detail(errors):
    return " | ".join(f"{t}: {'; '.join(e)}" for t, e in errors.items()) \
        or "no checkpoint tags found"


def _read_state(path):
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def load_module_params(load_dir, tag=None):
    """The port's state dict (parameter name -> CPU tensor) of a verified
    tag, with no engine (JAX :234). ``latest``-driven loads fall back to
    the newest verified tag; an explicitly named tag that fails raises."""
    explicit_tag = tag is not None
    if explicit_tag and not os.path.isdir(os.path.join(load_dir, str(tag))):
        raise FileNotFoundError(
            f"checkpoint tag directory {os.path.join(load_dir, str(tag))} "
            "does not exist")
    if tag is None:
        with open(os.path.join(load_dir, LATEST_FILE)) as f:
            tag = f.read().strip()
    chosen, errors = resolve_verified_tag(load_dir, prefer_tag=str(tag))
    if chosen != str(tag) and explicit_tag:
        raise CheckpointCorruptionError(
            f"explicitly requested checkpoint {tag!r} under {load_dir} "
            f"failed integrity verification: {_corruption_detail(errors)}")
    if chosen is None:
        raise CheckpointCorruptionError(
            f"no verified-good checkpoint under {load_dir} (latest pointed "
            f"at {tag!r}): {_corruption_detail(errors)}")
    if chosen != str(tag):
        logger.warning(
            f"checkpoint {tag!r} under {load_dir} failed integrity "
            f"verification ({_corruption_detail(errors)}); loading newest "
            f"verified-good tag {chosen!r}")
    state = _read_state(os.path.join(os.path.abspath(load_dir), chosen))
    return {port_name(path): t for path, t in state["params"].items()}


def _resolve_load_tag(engine, load_dir, tag):
    """The tag to restore (JAX :318-367), or None for a missing
    ``latest`` or a missing explicitly named tag."""
    icfg = _integrity_config(engine)
    explicit_tag = tag is not None
    if tag is None:
        latest = os.path.join(load_dir, LATEST_FILE)
        if not os.path.exists(latest):
            logger.warning(f"no '{LATEST_FILE}' file at {load_dir}")
            return None
        with open(latest) as f:
            tag = f.read().strip()
    tag = str(tag)
    if not (icfg.enabled and icfg.verify_on_load):
        return tag
    chosen, errors = resolve_verified_tag(load_dir, prefer_tag=tag)
    if chosen == tag:
        return tag
    detail = _corruption_detail(errors)
    if explicit_tag and not os.path.isdir(os.path.join(load_dir, tag)):
        # a named tag that is not there is a caller mistake, not corruption
        logger.warning(f"checkpoint path {os.path.join(load_dir, tag)} "
                       "does not exist")
        return None
    if explicit_tag:
        # restoring another step than the one named would corrupt the
        # caller's resume: fallback is a latest-driven policy only
        raise CheckpointCorruptionError(
            f"explicitly requested checkpoint {tag!r} under {load_dir} "
            f"failed integrity verification: {detail}")
    if chosen is None:
        raise CheckpointCorruptionError(
            f"no verified-good checkpoint under {load_dir} (latest pointed "
            f"at {tag!r}): {detail}")
    if not icfg.fallback_on_corruption:
        raise CheckpointCorruptionError(
            f"checkpoint {tag!r} under {load_dir} failed integrity "
            f"verification ({detail}) and resilience.integrity."
            "fallback_on_corruption is false")
    logger.warning(f"checkpoint {tag!r} under {load_dir} failed integrity "
                   f"verification ({detail}); falling back to newest "
                   f"verified-good tag {chosen!r}")
    # repair the torn or stale latest so later loads go straight there
    write_latest(load_dir, chosen)
    return chosen


@torch.no_grad()
def _copy_into(named, saved, what):
    """Copy ``saved`` {path: tensor} into the engine's tensors in place."""
    paths = [path for path, _ in named]
    if set(paths) != set(saved):
        missing = sorted(set(paths) - set(saved))[:3]
        extra = sorted(set(saved) - set(paths))[:3]
        raise ValueError(f"checkpoint {what} do not match the engine's: "
                         f"missing {missing}, unexpected {extra}")
    for path, t in named:
        t.copy_(saved[path])


def load_engine_checkpoint(engine, load_dir, tag=None,
                           load_optimizer_states=True,
                           load_module_only=False):
    tag = _resolve_load_tag(engine, load_dir, tag)
    if tag is None:
        return None, {}
    path = os.path.abspath(os.path.join(load_dir, tag))
    if not os.path.isdir(path):
        logger.warning(f"checkpoint path {path} does not exist")
        return None, {}
    state = _read_state(path)
    _copy_into(engine._named_params, state["params"], "parameters")
    if load_optimizer_states and not load_module_only:
        opt, saved = engine.optimizer_state, state["optimizer_state"]
        paths = [p for p, _ in engine._named_params]
        for slot in opt.SLOTS:
            if slot not in saved:
                raise ValueError(
                    f"checkpoint at {path} holds optimizer slots "
                    f"{sorted(k for k in saved if k != 'count')}, the "
                    f"engine's optimizer needs {list(opt.SLOTS)}")
            _copy_into(list(zip(paths, getattr(opt, slot))), saved[slot],
                       f"optimizer {slot}")
        opt.count = int(saved["count"])
    if engine.fp16_enabled:
        # JAX :387-390, :432-435: restored when the tag holds it (an fp32
        # or bf16 tag leaves the live scale as it is)
        if "loss_scale" in state:
            from .fp16.loss_scaler import LossScaleState
            engine.loss_scale_state = LossScaleState(**{
                k: v.to(engine.device)
                for k, v in state["loss_scale"].items()})
        else:
            logger.warning(f"checkpoint at {path} holds no loss-scale "
                           "state; the engine keeps its current one")
    client_state = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        engine.global_steps = meta.get("global_steps", 0)
        engine.global_samples = meta.get("global_samples", 0)
        engine.skipped_steps = meta.get("skipped_steps", 0)
        engine.micro_steps = meta.get(
            "micro_steps",
            engine.global_steps * engine.gradient_accumulation_steps())
        client_state = meta.get("client_state", {})
    logger.info(f"loaded checkpoint {path} (step {engine.global_steps})")
    return path, client_state
