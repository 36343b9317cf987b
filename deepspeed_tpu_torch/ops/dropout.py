"""Counter-based attention dropout: the keep hash and its seed words.

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
"""

import torch

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
