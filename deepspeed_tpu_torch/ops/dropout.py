"""Counter-based dropout: the keep hash, its seed words, and the
activation dropout of the residual, MLP and embedding sites.

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py`` ``_mix32``
(:80), ``_keep_from_coords`` (:89), ``_seed_words`` (:102) and
``attention_dropout_keep`` (:135). The keep bit of a probability is a pure
function of two uint32 seed words and its absolute coordinates
(flat batch*head, q row, k column), so the CUDA kernels, their plain
versions and the JAX package draw the same bits from the same words.

torch has no wrapping uint32 multiply, so the plain version computes in
int64 and masks to 32 bits after every ``*`` and ``+`` (a multiply goes
in 16-bit halves, so no product leaves int64's range). The kernels
(``csrc/common.cuh`` ``dropout_keep``) compute the same in uint32. The
threshold is computed once on the host, in Python, exactly as the JAX
package does.

``seed_words`` and ``fold_seed`` are the port's own derivation of
per-step, per-microbatch and per-layer words (flax's ``make_rng`` folding
needs JAX and is not reproduced): ``seed_words(n)`` is the word pair of
``jax.random.PRNGKey(n)`` for ``0 <= n < 2**32``, and ``fold_seed`` mixes
one integer into a pair with the same murmur3 finalizer the hash uses.

Activation dropout (``dropout_apply``; JAX: flax ``nn.Dropout`` at
``models/layers.py:618-619`` (the MLP output), ``models/gpt.py:151-152``
and ``models/bert.py:83-84`` (the embeddings), and
``ops/transformer/transformer.py`` ``_dropout`` :233 (the fused layer's
hidden1 and hidden2)) draws the same hash: element (b, s, j) of a
[b, s, d] activation is kept when ``keep_from_coords(s0, s1, b, s, j,
rate)`` says so. A site's words are ``fold_seed(words, site)`` of the
layer's (or the forward's) words and the site's index, never the layer's
own words, which its attention dropout takes. A kept element becomes
``x / dtype(1 - rate)``: JAX divides by ``1.0 - rate``, a weakly typed
Python float that takes the activation's dtype, so a bf16 activation is
divided by bf16(0.9) = 0.8984375, not by 0.9. The quotient is taken in
fp32 and rounded once to the dtype, which for fp32, bf16 and fp16 is
JAX's division bit for bit. Dropped elements are 0, and the backward is
the same map of the gradient, redrawn from the words: no mask is saved,
so a recompute (remat) or a resumed run drops the same elements. A CUDA
tensor launches ``csrc/dropout.cu`` (one fused pass; the plain version
is ~20 int64 elementwise passes a site), a CPU tensor runs the plain
version.
"""

import torch

from ._common import check_launch, kernel_dtype_code, use_kernel

M32 = 0xFFFFFFFF


def seed_words(seed: int):
    """(s0, s1) of an integer seed: the words of ``PRNGKey(seed)``."""
    return (int(seed) >> 32) & M32, int(seed) & M32


def fold_seed(words, data: int):
    """A new word pair from ``words`` and the integer ``data`` (a step, a
    microbatch or a layer index); distinct ``data`` give unrelated
    pairs."""
    s0, s1 = (int(w) & M32 for w in words)
    d = _mix32((int(data) * 0x9E3779B1 + 0x7F4A7C15) & M32)
    a = _mix32(s0 ^ d)
    b = _mix32((s1 + a + 0x85EBCA6B) & M32)
    return a, b


def keep_threshold(rate: float) -> int:
    """The uint32 threshold a hash must reach to keep (JAX :99)."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _mul32(x, c: int):
    """x * c mod 2**32 for uint32 values (Python ints or int64 tensors),
    in 16-bit halves so no intermediate leaves int64's range."""
    return (((((x >> 16) * c) & 0xFFFF) << 16) + (x & 0xFFFF) * c) & M32


def _mix32(x):
    """murmur3 finalizer on uint32 values (Python ints or int64 tensors)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_from_coords(s0, s1, bh, i, j, rate):
    """Bernoulli(1 - rate) keep decision per (flat batch*head, row, col);
    ``bh``/``i``/``j`` are broadcastable int64 tensors of uint32 values."""
    x = (_mul32(i, 0x27D4EB2F) ^ _mul32(j, 0x165667B1)
         ^ _mul32(bh, 0x9E3779B1) ^ (int(s0) & M32))
    x = _mix32(x ^ (int(s1) & M32))
    x = _mix32((x + 0x9E3779B9) & M32)
    return x >= keep_threshold(rate)


def attention_dropout_keep(words, rate, shape, total_heads=None,
                           head_offset=0, batch_offset=0, q_offset=0,
                           k_offset=0, device=None):
    """Full-shape boolean keep mask [b, h, sq, sk], bit-identical to what
    the flash kernels sample per element. ``words``: the (s0, s1) pair;
    ``total_heads`` and the offsets place this block in a larger
    [batch, heads, rows, cols] lattice."""
    b, h, sq, sk = shape
    ar = lambda n, off: (torch.arange(n, dtype=torch.int64, device=device)
                         + int(off)) & M32
    bi = ar(b, batch_offset)[:, None, None, None]
    hi = ar(h, head_offset)[None, :, None, None]
    i = ar(sq, q_offset)[None, None, :, None]
    j = ar(sk, k_offset)[None, None, None, :]
    bh = (_mul32(bi, int(total_heads if total_heads else h)) + hi) & M32
    return keep_from_coords(words[0], words[1], bh, i, j, rate)


# --------------------------------------------------------------------------
# activation dropout
# --------------------------------------------------------------------------

# The site indices: a site's words are fold_seed(words, site). MLP_SITE is
# the MLP output of models.layers.Block (fold over the layer's words);
# HIDDEN1_SITE and HIDDEN2_SITE the attention-output and FFN-output
# dropout of the fused DeepSpeedTransformerLayer (over its words);
# EMBED_SITE the embeddings (over the forward's words, which fold_seed
# gives layer i as fold_seed(words, i): no layer index reaches 2**32 - 1).
MLP_SITE, HIDDEN1_SITE, HIDDEN2_SITE = 1, 2, 3
EMBED_SITE = M32


def site_words(words, site: int):
    """The word pair of one dropout site of a layer (or of the forward)."""
    return fold_seed(words, site)


def keep_divisor(rate: float, dtype: torch.dtype) -> float:
    """``dtype(1 - rate)``: what JAX divides a kept element by (the weakly
    typed ``1.0 - rate`` takes the activation's dtype), through fp32 as
    the kernel rounds it."""
    return float(torch.tensor(1.0 - rate, dtype=torch.float32).to(dtype))


def activation_keep(words, rate, shape, device=None):
    """Boolean keep mask [b, s, d] of one site: element (b, s, j) is
    ``keep_from_coords(s0, s1, b, s, j, rate)``."""
    b, s, d = shape
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    return keep_from_coords(words[0], words[1], ar(b)[:, None, None],
                            ar(s)[None, :, None], ar(d)[None, None, :], rate)


def dropout_reference(x, words, rate):
    """The dropout kernel's function in plain PyTorch: kept elements
    ``x / dtype(1 - rate)`` (the quotient in fp32, a full tensor so no
    division by a scalar becomes a product with its reciprocal, rounded
    once to x's dtype), dropped ones 0. x [b, s, d]."""
    keep = activation_keep(words, rate, x.shape, x.device)
    xf = x.float()
    q = (xf / torch.full_like(xf, keep_divisor(rate, x.dtype))).to(x.dtype)
    return torch.where(keep, q, torch.zeros_like(q))


def _launch(x, words, rate, backward):
    """Launch the dropout kernel on a [b, s, d] CUDA tensor."""
    from . import op_builder
    code = kernel_dtype_code(x.dtype, fp16=True)
    x = x.contiguous()
    b, s, d = x.shape
    y = torch.empty_like(x)
    check_launch(op_builder.load().dropout_apply(
        x.data_ptr(), y.data_ptr(), code, x.numel(), s, d, 1.0 - rate,
        int(words[0]) & M32, int(words[1]) & M32, keep_threshold(rate),
        torch.cuda.current_stream(x.device).cuda_stream), "dropout_apply")
    if backward:
        dropout_apply.bwd_launches += 1
    else:
        dropout_apply.fwd_launches += 1
    return y


def dropout_map(x, words, rate, backward=False):
    """One site's dropout map of ``x`` (an activation, or its gradient
    with ``backward``): the kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    if x.dim() != 3:
        raise ValueError(f"dropout: a [batch, seq, features] activation, "
                         f"got shape {tuple(x.shape)}")
    if use_kernel(x):
        return _launch(x, words, rate, backward)
    return dropout_reference(x, words, rate)


class _ActivationDropout(torch.autograd.Function):
    """y = map(x), dx = map(dy): the backward redraws the keep bits from
    the words and saves nothing."""

    @staticmethod
    def forward(ctx, x, words, rate):
        ctx.words, ctx.rate = words, rate
        return dropout_map(x, words, rate)

    @staticmethod
    def backward(ctx, g):
        return dropout_map(g, ctx.words, ctx.rate, backward=True), None, None


def dropout_apply(x, words, rate: float, site: int):
    """Dropout of the [b, s, d] activation ``x`` at ``site`` (``MLP_SITE``,
    ``HIDDEN1_SITE``, ``HIDDEN2_SITE`` or ``EMBED_SITE``) with the words of
    its layer (or forward): the bits of ``site_words(words, site)``.
    Differentiable; the caller applies it only in training mode with a
    rate above 0. A CUDA tensor launches the kernel (fp32, bf16 or fp16,
    else it raises), a CPU tensor runs the plain version."""
    if not 0.0 < rate < 1.0:
        raise ValueError(f"dropout rate must be in (0, 1), got {rate}")
    if words is None:
        raise ValueError("dropout in training mode needs its seed words "
                         "(dropout_seed=(s0, s1))")
    return _ActivationDropout.apply(x, site_words(words, site), float(rate))


dropout_apply.fwd_launches = 0
dropout_apply.bwd_launches = 0
