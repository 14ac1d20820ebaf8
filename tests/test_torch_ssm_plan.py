"""The SSM decode and conv kernels' algorithms (``csrc/ssm.cu``) in plain
PyTorch, against the port's plain versions and the JAX package, at reduced
mamba2-2.7b widths (8 heads of P 32, N 16, d_inner 256: 288 conv
channels), with inputs drawn by numpy from a seed.

- ``ssm_conv``: a thread of the kernel loads a stretch of ``CONV_STRETCH``
  positions and the ``CONV_WIDTH - 1`` before it (positions before 0 from
  the state, or zeros without carry), and stretch 0 the new state's
  inputs; each product and partial sum rounded to the activation dtype.
  Bit-equal to ``ssm_conv_plain`` (y and state) across stretch edges, with
  and without carry and with a frozen row; against the JAX
  ``_causal_conv`` the state bit-equal and y within one bf16 step of its
  scale (JAX's silu is x * sigmoid(x) in bf16, the port's x / (1 +
  exp(-x)) in f32 rounded once).
- ``ssm_decode_step``'s state update: a warp takes p rows of one (slot,
  head); lane l holds n = 4 l .. 4 l + 3 of each; a row's sum over n is
  the lane's four by fma in order, then an xor tree over the 32 lanes.
  Within one bf16 step of ``ssm_decode_update_plain`` (the plain einsum
  sums in another order) with the state bit-equal; a slot alone
  bit-equal to the same slot in a batch of 4; the layer with this update
  within 1e-5 of the JAX ``ssm_decode`` (f32: measured about 1e-7).
- ``ssm_decode_step``: its plain version (the conv, then the update)
  through the port's decode layer against the JAX ``ssm_decode``: both
  states and y within 1e-5 of their scale, a frozen row's states
  untouched, one call a layer.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.models import ssm as jssm
from repro.models.model import _freeze_rows
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import ssm as kssm
from repro_torch.models import ssm as tssm

ARCH = "mamba2-2.7b"
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -7    # one bf16 step at the output's scale
LANES = 32


def _cfgs():
    return reduced(get_config(ARCH)), jreduced(jget(ARCH))


def _err(t: torch.Tensor, ref) -> float:
    r = np.asarray(ref, np.float32)
    return float(np.abs(t.float().numpy() - r).max() / np.abs(r).max())


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _j(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


# -- the conv -----------------------------------------------------------------
def conv_stretched(x, w, b, state, advance=None, carry=True):
    """The conv kernel's threads in plain PyTorch: x (B, S, C), w (W, C), b
    (C,), state (B, W - 1, C), all one dtype → y; the state replaced in
    place for advancing rows from stretch 0's loads."""
    B, S, C = x.shape
    T, K = kssm.CONV_STRETCH, kssm.CONV_WIDTH - 1
    zero = torch.zeros((B, 1, C), dtype=x.dtype)

    def at(pos):          # what a thread loads for position pos
        if pos >= S:
            return zero
        if pos >= 0:
            return x[:, pos:pos + 1]
        return state[:, K + pos:K + pos + 1] if carry else zero

    y = torch.empty_like(x)
    for s0 in range(0, S, T):
        win = [at(s0 - K + j) for j in range(K + T)]
        for i in range(min(T, S - s0)):
            acc = win[i] * w[0]
            for j in range(1, K + 1):
                acc = acc + win[i + j] * w[j]
            y[:, s0 + i:s0 + i + 1] = F.silu(acc + b)
    new = torch.cat([at(S - K + j) for j in range(K)], dim=1)
    m = (torch.ones(B, dtype=torch.bool) if advance is None else advance)
    state[m] = new[m]
    return y


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("S", [1, 2, 3, 5, 37, 301])
def test_conv_stretches_match_plain_and_jax(S, carry):
    cfg, jcfg = _cfgs()
    C = cfg.d_inner + 2 * cfg.ssm_state
    rng = np.random.default_rng(S + 1000 * carry)
    x = _bf16(rng.standard_normal((3, S, C)))
    w = _bf16(0.5 * rng.standard_normal((4, C)))
    b = _bf16(0.2 * rng.standard_normal(C))
    st0 = _bf16(rng.standard_normal((3, 3, C)))
    adv = torch.tensor([True, False, True])
    s1, s2 = st0.clone(), st0.clone()
    y = conv_stretched(x, w, b, s1, adv, carry)
    ref = kssm.ssm_conv_plain(x, w, b, s2, adv, carry)
    assert torch.equal(y, ref) and torch.equal(s1, s2)
    assert torch.equal(s1[1], st0[1])
    jy, jst = jssm._causal_conv(_j(x), _j(w), _j(b), _j(st0) if carry
                                else None)
    assert _err(y, jy.astype(jnp.float32)) <= BF16_STEP
    assert np.array_equal(s1[adv].float().numpy(),
                          np.asarray(jst.astype(jnp.float32))[adv.numpy()])


# -- the decode state update --------------------------------------------------
def _fma(a, b, c):
    """fmaf in f32: the f32 product is exact in f64, and an f64 sum rounded
    to f32 is the exact sum rounded once (53 >= 2 * 24 + 1 bits)."""
    return (a.double() * b.double() + c.double()).float()


def decode_rows(xbc, dt, dt_bias, A_log, D, state, advance=None):
    """The decode step kernel's update in plain PyTorch, xbc (B, H P + 2 N)
    the conv's output, dt (B, H) → y (B, H P); the f32 state (B, H, P, N)
    replaced in place for advancing rows. Rows are independent, so a
    warp's rows are taken all at once here."""
    B = xbc.shape[0]
    H, P, N = state.shape[1:]
    assert N % 4 == 0 and N <= kssm.DECODE_MAX_STATE
    xs, Bm, Cm = kssm._split(xbc, H, P, N)
    dtv = kssm.softplus(dt.float() + dt_bias.float())            # (B, H)
    decay = torch.exp(dtv * -torch.exp(A_log.float()))
    pad = 4 * LANES - N
    lanes = (B, 1, 1, LANES, 4)
    bv = F.pad(Bm.float(), (0, pad)).view(lanes)
    cv = F.pad(Cm.float(), (0, pad)).view(lanes)
    s = F.pad(state, (0, pad)).view(B, H, P, LANES, 4)
    dx = (dtv[:, :, None] * xs.float())[..., None, None]
    s_new = s * decay[:, :, None, None, None] + dx * bv
    acc = torch.zeros((B, H, P, LANES))
    for j in range(4):
        acc = _fma(s_new[..., j], cv[..., j], acc)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., torch.arange(LANES) ^ o]
    y = acc[..., 0] + xs.float() * D.float()[None, :, None]
    m = (torch.ones(B, dtype=torch.bool) if advance is None else advance)
    state[m] = s_new.reshape(B, H, P, -1)[..., :N][m]
    return y.reshape(B, H * P).to(xbc.dtype)


def _decode_inputs(B, seed, dtype=torch.bfloat16):
    cfg, _ = _cfgs()
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(seed)
    cast = _bf16 if dtype == torch.bfloat16 else (
        lambda a: torch.from_numpy(a.astype(np.float32)))
    xbc = cast(rng.standard_normal((B, H * P + 2 * N)))
    dt = cast(rng.standard_normal((B, H)))
    vec = [cast(0.5 * rng.standard_normal(H)) for _ in range(3)]
    state = torch.from_numpy(
        0.3 * rng.standard_normal((B, H, P, N)).astype(np.float32))
    return xbc, dt, vec, state


def test_decode_rows_match_plain_and_alone_equals_batch():
    xbc, dt, (dt_bias, A_log, D), state = _decode_inputs(4, 5)
    adv = torch.tensor([True, False, True, True])
    s1, s2 = state.clone(), state.clone()
    y = decode_rows(xbc, dt, dt_bias, A_log, D, s1, adv)
    ref = kssm.ssm_decode_update_plain(xbc, dt, dt_bias, A_log, D, s2, adv)
    assert _err(y, ref.float().numpy()) <= BF16_STEP
    assert torch.equal(s1, s2) and torch.equal(s1[1], state[1])
    for r in range(4):
        sr = state[r:r + 1].clone()
        yr = decode_rows(xbc[r:r + 1], dt[r:r + 1], dt_bias, A_log, D, sr,
                         adv[r:r + 1])
        assert torch.equal(yr[0], y[r]) and torch.equal(sr[0], s1[r])


def _jax_layer():
    """Layer 0's f32 params on both sides (A_log, dt_bias and conv_b
    drawn, their inits being zeros), from the same numpy draws."""
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(11)
    specs = tssm.ssm_specs(cfg)
    tl, jl = {}, {}
    for k, spec in specs.items():
        if isinstance(spec, dict):
            a = (rng.standard_normal(spec["w"].shape)
                 / np.sqrt(spec["w"].shape[0])).astype(np.float32)
            tl[k], jl[k] = {"w": torch.from_numpy(a)}, {"w": jnp.asarray(a)}
            continue
        a = rng.standard_normal(spec.shape).astype(np.float32)
        a = 1 + 0.1 * a if k == "norm_w" else 0.5 * a
        tl[k], jl[k] = torch.from_numpy(a), jnp.asarray(a)
    return cfg, jcfg, tl, jl


@pytest.mark.parametrize("path", ["rows", "step"])
def test_decode_layer_matches_jax(path):
    """Three tokens through the port's decode layer from a random state,
    row 1 frozen at the second, against the JAX ``ssm_decode``: ``rows``
    with the update replaced by the kernel's order of sums, ``step`` as
    the layer runs (one ``ssm_decode_step`` a token). Both states and y
    within 1e-5 of their scale (the conv state copies ``in_proj``'s
    output, whose sums run in another order than XLA's); a frozen row's
    states bit-equal to before."""
    cfg, jcfg, tl, jl = _jax_layer()
    rng = np.random.default_rng(12)
    C = cfg.d_inner + 2 * cfg.ssm_state
    jc = {"conv": jnp.asarray(rng.standard_normal((2, 3, C)), jnp.float32),
          "state": jnp.asarray(0.3 * rng.standard_normal(
              (2, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)),
              jnp.float32),
          "lens": jnp.zeros((2,), jnp.int32)}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()
          if k != "lens"}
    saved = ops.ssm_decode_step
    calls = []

    def step_rows(xbc, dt, w, b, conv, dt_bias, A_log, D, state, adv=None):
        calls.append("step")
        x = kssm.ssm_conv_plain(xbc[:, None], w, b, conv, adv)[:, 0]
        return decode_rows(x, dt, dt_bias, A_log, D, state, adv)

    def step_counted(*a, **kw):
        calls.append("step")
        return saved(*a, **kw)
    ops.ssm_decode_step = step_rows if path == "rows" else step_counted
    try:
        for t in range(3):
            x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
            mask = np.array([True, t != 1])
            jy, jn = jssm.ssm_decode(jl, jcfg, jnp.asarray(x), jc)
            jc = _freeze_rows(jn, jc, jnp.asarray(mask))
            before = {k: v.clone() for k, v in tc.items()}
            ty = tssm.ssm_decode(tl, cfg, torch.from_numpy(x), tc,
                                 torch.from_numpy(mask))
            assert _err(ty, jy) <= F32_TOL
            for k in ("conv", "state"):
                assert _err(tc[k], jc[k]) <= F32_TOL
            if t == 1:
                assert all(torch.equal(tc[k][1], before[k][1]) for k in tc)
    finally:
        ops.ssm_decode_step = saved
    assert calls == ["step"] * 3
