"""Autoregressive generation with a preallocated KV cache (counterpart of
``deepspeed_tpu/inference/generation.py``).

Prefill runs the whole prompt through the model once; decode is a Python
loop of single-token forwards (the JAX package's ``lax.scan``). Tokens
stay on the device until the loop ends, so the loop never waits on the
host. Sampling takes an explicit ``torch.Generator``; greedy decoding is
the mode that is token-exact against the JAX package.
"""

from typing import Optional

import numpy as np
import torch

from .cache import KVCache, set_cache_index


def init_cache(model, batch_size: int, max_len: int) -> KVCache:
    """A zeroed cache for ``model`` on its device, in its compute dtype."""
    cfg = model.config
    dev = model.wte.device
    shape = (cfg.n_layers, batch_size, cfg.n_heads, max_len, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev), 0)


def _prefill_impl(model, cache, input_ids, positions):
    """Run ``input_ids`` [b, s] at ``cache.index``; returns the logits."""
    return model(input_ids, positions=positions, cache=cache)


def _sampling_mode(temperature, top_k, top_p):
    """(greedy, has_k, has_p, t, k, p): which sampling features are on,
    and their values."""
    greedy = temperature is None or temperature <= 0.0
    has_k = top_k is not None and top_k > 0
    has_p = top_p is not None and top_p < 1.0
    return (greedy, has_k, has_p, float(temperature or 0.0),
            int(top_k or 0), float(1.0 if top_p is None else top_p))


def _sample_impl(logits, generator, mode):
    """logits [batch, vocab] -> [batch] token ids under ``mode`` (from
    ``_sampling_mode``). Greedy takes the first maximum (as
    ``jnp.argmax``)."""
    greedy, has_k, has_p, t, k, p = mode
    if greedy:
        return logits.argmax(dim=-1)
    logits = logits.float() / t
    if has_k:
        kth = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values
        logits = torch.where(logits < kth[:, -1:], -torch.inf, logits)
    if has_p:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = probs.cumsum(dim=-1) - probs < p
        cutoff = torch.where(keep, sorted_logits, torch.inf).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, -torch.inf, logits)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=generator)[:, 0]


def _decode_loop_impl(model, cache, last_token, start_pos, num_steps,
                      generator, mode):
    """``num_steps`` single-token forwards from ``last_token`` [b];
    ``start_pos`` is the shared int position or a per-row [b] tensor
    (ragged). Returns [b, num_steps] tokens."""
    token, pos, out = last_token, start_pos, []
    dev = last_token.device
    for _ in range(num_steps):
        positions = (pos[:, None] if torch.is_tensor(pos)
                     else torch.arange(pos, pos + 1, device=dev))
        logits = model(token[:, None], positions=positions, cache=cache)
        token = _sample_impl(logits[:, -1, :], generator, mode)
        out.append(token)
        pos = pos + 1
    return torch.stack(out, dim=1)


def _normalize_ragged_prompts(ids_np, prompt_lengths, pad_token_id):
    """Host-side padding normalization for the ragged path: returns
    (right-padded [b, Lmax] int array, lengths [b]). Accepts left- or
    right-padded rows when ``pad_token_id`` is given (one contiguous pad
    run at an end; a trailing run is trimmed first); explicit
    ``prompt_lengths`` rows are taken as right-aligned at 0."""
    b, lmax = ids_np.shape
    if prompt_lengths is None:
        lengths = np.empty(b, np.int32)
        out = np.empty_like(ids_np)
        for i in range(b):
            row = ids_np[i]
            if row[-1] == pad_token_id:
                n = lmax
                while n > 1 and row[n - 1] == pad_token_id:
                    n -= 1
                seg = row[:n]
            else:
                start = 0
                while start < lmax - 1 and row[start] == pad_token_id:
                    start += 1
                n = lmax - start
                seg = row[start:]
            lengths[i] = n
            out[i, :n] = seg
            out[i, n:] = pad_token_id
        return out, lengths
    lengths = np.asarray(prompt_lengths, np.int32)
    if lengths.shape != (b,):
        raise ValueError(f"prompt_lengths must be [batch]={b}, "
                         f"got shape {lengths.shape}")
    if (lengths < 1).any() or (lengths > lmax).any():
        raise ValueError("prompt_lengths must lie in [1, prompt width "
                         f"{lmax}], got {lengths.tolist()}")
    return ids_np, lengths


def _check_ids(ids_np, vocab_size):
    """Token ids must index the embedding (torch's lookup raises where the
    reference's gather clips)."""
    if ids_np.size and (ids_np.min() < 0 or ids_np.max() >= vocab_size):
        raise ValueError(f"token ids must lie in [0, {vocab_size}), got "
                         f"[{ids_np.min()}, {ids_np.max()}]")


@torch.no_grad()
def generate(model, input_ids, *, max_new_tokens: int = 32,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             eos_token_id: Optional[int] = None,
             max_len: Optional[int] = None, prompt_lengths=None,
             pad_token_id: Optional[int] = None):
    """Generate continuations for a batch of prompts on the model's device.

    Equal-length batches return [batch, prompt_len + max_new_tokens] int64
    token ids; with ``eos_token_id`` every token after the first EOS is
    EOS. Ragged batches — ``prompt_lengths`` (true lengths of right-padded
    rows) and/or ``pad_token_id`` (lengths inferred) — decode every row
    from its own length and return each row as
    ``prompt ++ generated ++ fill``.
    """
    ids_np = np.asarray(input_ids.cpu() if torch.is_tensor(input_ids)
                        else input_ids).astype(np.int64)
    if ids_np.ndim == 1:
        ids_np = ids_np[None]
    _check_ids(ids_np, model.config.vocab_size)
    if prompt_lengths is not None or pad_token_id is not None:
        ids_np, lengths = _normalize_ragged_prompts(ids_np, prompt_lengths,
                                                    pad_token_id)
        return _generate_ragged(
            model, ids_np, lengths, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator, eos_token_id=eos_token_id, max_len=max_len,
            pad_token_id=pad_token_id)
    b, prompt_len = ids_np.shape
    total = max_len or (prompt_len + max_new_tokens)
    if total < prompt_len + max_new_tokens:
        raise ValueError("max_len too small for prompt + max_new_tokens")
    if total > model.config.max_seq_len:
        raise ValueError(
            f"prompt_len + max_new_tokens = {total} exceeds the model's "
            f"max_seq_len {model.config.max_seq_len}")
    dev = model.wte.device
    mode = _sampling_mode(temperature, top_k, top_p)
    if generator is None and not mode[0]:
        generator = torch.Generator(device=dev).manual_seed(0)
    ids = torch.as_tensor(ids_np, device=dev)

    cache = init_cache(model, b, total)
    logits = _prefill_impl(model, cache, ids,
                           torch.arange(prompt_len, device=dev))
    first = _sample_impl(logits[:, -1, :], generator, mode)
    parts = [ids, first[:, None]]
    if max_new_tokens > 1:
        parts.append(_decode_loop_impl(model, cache, first, prompt_len,
                                       max_new_tokens - 1, generator, mode))
    out = torch.cat(parts, dim=1)
    if eos_token_id is not None:
        out = torch.cat([out[:, :prompt_len],
                         _eos_fill(out[:, prompt_len:], eos_token_id)], 1)
    return out


def _eos_fill(gen, eos_token_id):
    """Replace everything after the first EOS with EOS ([b, n] -> [b, n])."""
    hit = (gen == eos_token_id).long()
    seen = hit.cumsum(dim=1) - hit
    return torch.where(seen > 0, eos_token_id, gen)


def _generate_ragged(model, ids_np, lengths, *, max_new_tokens, temperature,
                     top_k, top_p, generator, eos_token_id, max_len,
                     pad_token_id):
    """Unequal-length batch generation: one prefill over the right-padded
    batch (pad rows sit causally after every valid token, so they cannot
    leak into valid logits), each row's first token sampled from its own
    last prompt position, then a per-row decode loop."""
    b, width = ids_np.shape
    total = max_len or (int(lengths.max()) + max_new_tokens)
    if total < int(lengths.max()) + max_new_tokens:
        raise ValueError("max_len too small for longest prompt + "
                         "max_new_tokens")
    if max(total, width) > model.config.max_seq_len:
        raise ValueError(
            f"longest prompt + max_new_tokens = {total} (prompt width "
            f"{width}) exceeds the model's max_seq_len "
            f"{model.config.max_seq_len}")
    dev = model.wte.device
    mode = _sampling_mode(temperature, top_k, top_p)
    if generator is None and not mode[0]:
        generator = torch.Generator(device=dev).manual_seed(0)
    ids = torch.as_tensor(ids_np, device=dev)
    lens = torch.as_tensor(lengths, dtype=torch.int64, device=dev)

    # the cache holds the full padded width: prefill writes every column
    cache = init_cache(model, b, max(total, width))
    logits = _prefill_impl(model, cache, ids, torch.arange(width, device=dev))
    last = logits[torch.arange(b, device=dev), lens - 1]        # [b, vocab]
    first = _sample_impl(last, generator, mode)
    gen = first[:, None]
    if max_new_tokens > 1:
        set_cache_index(cache, lens)
        rest = _decode_loop_impl(model, cache, first, lens,
                                 max_new_tokens - 1, generator, mode)
        gen = torch.cat([gen, rest], dim=1)
    if eos_token_id is not None:
        gen = _eos_fill(gen, eos_token_id)

    fill = (pad_token_id if pad_token_id is not None
            else (eos_token_id if eos_token_id is not None else 0))
    out = torch.cat([ids, torch.full((b, max_new_tokens), fill,
                                     dtype=ids.dtype, device=dev)], dim=1)
    # place each row's generated run at ITS prompt length, then normalize
    # everything past [0, len + max_new) to the fill value
    cols = torch.arange(width + max_new_tokens, device=dev)[None, :]
    rel = cols - lens[:, None]
    in_gen = (rel >= 0) & (rel < max_new_tokens)
    out = torch.where(in_gen, gen.gather(1, rel.clamp(0, max_new_tokens - 1)),
                      out)
    return torch.where(cols >= (lens + max_new_tokens)[:, None], fill, out)
