"""fp16 loss scaling: the port's ``runtime/fp16/loss_scaler.py`` against
the JAX package's, bit for bit.

``update_scale`` is driven over seeded sequences of finite flags (runs of
clean steps and of overflows) under dynamic scaling with the default
hysteresis, with hysteresis 1 and 3, with ``consecutive_hysteresis``, at a
``min_scale`` the sequence reaches, and under a static scale; every field
of the state must equal JAX's after every step (exact: the scale only
ever doubles or halves, the counters are integers). ``grads_finite``
tests each element with ``isfinite``, as JAX does: an inf or a NaN
anywhere is an overflow, a finite gradient whose square overflows is not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.fp16 import loss_scaler as jls
from deepspeed_tpu_torch.runtime.fp16 import loss_scaler as pls


def _flags(seed, n=64):
    """Runs of clean steps and overflows (overflow runs of 1-3 steps)."""
    rs = np.random.RandomState(seed)
    out = []
    while len(out) < n:
        out += [True] * int(rs.randint(0, 6)) + [False] * int(rs.randint(1, 4))
    return out[:n]


def _fields(state):
    return [np.asarray(x).item() for x in state]


CASES = {
    "dynamic": dict(kw=dict(scale_window=4, hysteresis=2), power=8),
    "hysteresis_1": dict(kw=dict(scale_window=3, hysteresis=1), power=8),
    "hysteresis_3": dict(kw=dict(scale_window=5, hysteresis=3), power=12),
    "consecutive": dict(kw=dict(scale_window=4, hysteresis=2,
                                consecutive_hysteresis=True), power=8),
    "min_scale": dict(kw=dict(scale_window=50, hysteresis=1,
                              min_scale=16.0), power=5),
    "static": dict(kw=dict(dynamic=False), power=0, static=128.0),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_update_scale_is_bit_equal_to_jax(case, seed):
    c = CASES[case]
    hyst = c["kw"].get("hysteresis", 2)
    static = c.get("static", 0.0)
    js = jls.init_loss_scale(static, c["power"], hysteresis=hyst)
    ps = pls.init_loss_scale(static, c["power"], hysteresis=hyst)
    assert _fields(ps) == _fields(js)
    scales = set()
    jax_update = jax.jit(functools.partial(jls.update_scale, **c["kw"]))
    for i, f in enumerate(_flags(seed)):
        js = jax_update(js, jnp.asarray(f))
        ps = pls.update_scale(ps, torch.tensor(f), **c["kw"])
        assert _fields(ps) == _fields(js), (i, f)
        assert ps.scale.dtype == torch.float32
        assert ps.overflows.dtype == torch.int32
        scales.add(_fields(ps)[0])
    if case == "min_scale":
        assert min(scales) == 16.0         # the floor is reached and held
    elif case == "static":
        assert scales == {128.0}
    else:
        assert len(scales) > 2             # it both grew and shrank


def test_grads_finite_tests_every_element_not_the_norm():
    big = torch.full((4,), 3e38)           # finite; its square overflows
    assert bool(pls.grads_finite([big, torch.ones(3)]))
    assert not bool(jnp.isinf(jnp.sqrt(jnp.sum(jnp.square(
        jnp.asarray(big.numpy()))))) == False)  # the norm would say inf
    for bad in (float("inf"), float("-inf"), float("nan")):
        g = torch.ones(5)
        g[3] = bad
        assert not bool(pls.grads_finite([torch.ones(2), g]))
        assert not bool(jls.grads_finite([jnp.ones(2), jnp.asarray(g)]))
    assert bool(pls.grads_finite([torch.ones(2, dtype=torch.bfloat16)]))
    assert bool(pls.grads_finite([]))
