"""The gated RMSNorm kernel's plan and order of sums, held on the CPU.

``norm_plan(d)`` gives a thread of one CTA a row a 16-byte run; it must
cover every d % 8 == 0 up to ``NORM_MAX_D`` and read d alone, so that a
row's bits do not depend on how many rows a call has.
``gated_rmsnorm_planned`` is the kernel's order of sums (a run's squares
in order, the warp's xor tree, an xor tree over the warps' sums) in f32:
within one bf16 step at the output's scale of ``gated_rmsnorm_plain`` and
of the JAX ``rmsnorm(y * silu(z))`` (src/repro/models/ssm.py:143), which
sum in other orders and round once to bf16, and a row alone bit-equal to
the same row among 4 and among 512.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import ssm

EPS = 1e-5                      # mamba2-2.7b's norm_eps


def test_plan_covers_every_width():
    assert list(inspect.signature(ssm.norm_plan).parameters) == ["d"]
    for d in range(8, ssm.NORM_MAX_D + 1, 8):
        per = ssm.norm_plan(d)
        assert 1 <= per <= 32
        assert per * 32 * 8 >= d                         # every run a thread
        assert (per - 1) * 32 * 8 < d                    # no warp without a run
    assert ssm.norm_plan(5120) == 20                     # mamba2-2.7b's d_inner


def _inputs(M, d, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((M, d)).astype(np.float32)
    z = rng.standard_normal((M, d)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return y, z, w


@pytest.mark.parametrize("d", [64, 520, 5120])
def test_planned_order_within_one_ulp(d):
    y, z, w = _inputs(64, d, d)
    ty, tz, tw = (torch.from_numpy(a).bfloat16() for a in (y, z, w))
    ref = ssm.gated_rmsnorm_plain(ty, tz, tw, EPS)
    jy, jz, jw = (jnp.asarray(a, jnp.bfloat16) for a in (y, z, w))
    jref = torch.from_numpy(np.array(jlayers.rmsnorm(
        jy * jax.nn.silu(jz), jw, EPS).astype(jnp.float32)))
    out = ssm.gated_rmsnorm_planned(ty, tz, tw, EPS).float()
    for want in (ref.float(), jref):
        tol = 2.0 ** -7 * float(want.abs().max())
        assert float((out - want).abs().max()) <= tol


def test_row_alone_bit_equal_in_a_batch():
    d = 5120
    y, z, w = _inputs(512, d, 5)
    ty, tz, tw = (torch.from_numpy(a).bfloat16() for a in (y, z, w))
    full = ssm.gated_rmsnorm_planned(ty, tz, tw, EPS)
    four = ssm.gated_rmsnorm_planned(ty[:4], tz[:4], tw, EPS)
    for i in (0, 3):
        alone = ssm.gated_rmsnorm_planned(ty[i:i + 1], tz[i:i + 1], tw, EPS)
        assert torch.equal(alone[0], four[i]) and torch.equal(alone[0],
                                                               full[i])
