"""The SSD prefill scan's tensor-core design in plain PyTorch against the
port's plain versions and the JAX package on the CPU.

``ssd_prefill``'s kernel scans fixed chunks of 64 (the last one masked),
``SCAN_SLICE`` chunks at a time, in two launches a slice (a walk over the
chunks that adds each chunk's state to the decayed incoming one, then the
chunk outputs), its products on the
tensor cores: x, B and C are bf16, and
each f32 operand (the decay matrix M, the state s, the weighted x w) is
split into three bf16 parts by ``split3``, so each product is as exact
as an f32 one. ``split_scan`` below is that algorithm written out, the
products taken part by part with the bf16 operands upcast and summed in
f32. It is held:

- to ``ssd_prefill_plain`` at mamba2-2.7b's widths (H 80, P 64, N 128)
  at B 1, S 130 and B 2, S 64, with and without a carried state: y
  within one bf16 step of its scale (the kernel's check on the card),
  the final state within ``SSD_STATE_REL_TOL`` 5e-5 of its scale;
- to the JAX ``ssd_chunked`` and ``ref.ssd_scan_ref`` at small widths
  for S 1, 63, 64, 65 and 301, x, B and C rounded to bf16 on both sides:
  within 1e-5 of the largest magnitude (f32 sums in another order);
- to finite outputs, and to ``ssd_prefill_plain``, on a long prompt
  with strong decay (S 4096, dt about 10).

Taken in slices (``sliced_scan``), each from the state the last one left,
it is held to itself whole and to the JAX ``ssd_chunked`` at S 513 and
1100.

``split3`` reproduces normal f32 values exactly, and a product of a
split f32 value with a bf16 value, its three parts summed in f32, is
within 2^-22 of the f32 product. The reduced mamba2's decode step, a
frozen row included, matches the JAX ``Model`` (f32, 1e-5).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.kernels.ref import ssd_scan_ref
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ssm as kssm
from repro_torch.models import Model

ARCH = "mamba2-2.7b"
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -7          # one bf16 step at the output's scale
SSD_STATE_REL_TOL = 5e-5       # chip_smoke.py's, the kernel's state check


def _rel(a, b) -> float:
    a = torch.as_tensor(np.array(a, np.float32))
    b = torch.as_tensor(np.array(b, np.float32))
    return float((a - b).abs().max() / b.abs().max())


def _bf(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16, as f32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a f32, split into three bf16 parts, and b bf16-valued:
    the three products of the upcast parts, summed in f32."""
    out = None
    for part in kssm.split3(a):
        term = part.float() @ b
        out = term if out is None else out + term
    return out


def split_scan(x, dt, A, Bm, Cm, s0=None, Q=kssm.SCAN_CHUNK):
    """The kernel's algorithm: x (B, S, H, P), Bm and Cm (B, S, N) with
    bf16 values, dt (B, S, H) positive, A (H,) negative, s0 (B, H, P, N)
    or None (zeros) → (y (B, S, H, P) f32 before rounding, the final f32
    state). Fixed chunks of Q, the last one padded with dt 0 and x, B, C
    0; L a chunk's running sum of dt A; the chunk states S_c = (x w)^T B
    with w = exp(L_last - L) dt; the state passing s_c+1 = s_c
    exp(L_last) + S_c; the outputs y = M x + exp(L) C s_c^T with M =
    exp(L_q - L_k) (C B^T)_qk dt_k for k <= q. M, s and x w go through
    ``split3``."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = -S % Q
    x, dt, Bm, Cm = (torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    nc = (S + pad) // Q
    xc = x.reshape(Bb, nc, Q, H, P).permute(0, 1, 3, 2, 4)   # (B,c,H,Q,P)
    dc = dt.reshape(Bb, nc, Q, H).permute(0, 1, 3, 2)        # (B,c,H,Q)
    bc = Bm.reshape(Bb, nc, Q, N)
    cc = Cm.reshape(Bb, nc, Q, N)
    L = torch.cumsum(dc * A[None, None, :, None], dim=-1)
    w = torch.exp(L[..., -1:] - L) * dc
    # 1. chunk states (B, c, H, P, N): (x w)^T (P x Q) @ B (Q x N)
    xw = (xc * w[..., None]).transpose(-1, -2)
    chunk_states = _split_mm(xw, bc[:, :, None])
    # 2. state passing
    s = (torch.zeros((Bb, H, P, N)) if s0 is None else s0.float())
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(L[:, c, :, -1])[..., None, None] + chunk_states[:, c]
    s_in = torch.stack(s_in, dim=1)                          # (B,c,H,P,N)
    # 3. chunk outputs
    cb = cc @ bc.transpose(-1, -2)                           # (B,c,Q,Q)
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    M = torch.where(tril, torch.exp(L[..., :, None] - L[..., None, :]),
                    torch.zeros(()))
    M = torch.where(tril, M * (cb[:, :, None] * dc[..., None, :]),
                    torch.zeros(()))
    y_intra = _split_mm(M, xc)                               # (B,c,H,Q,P)
    y_state = None
    for part in kssm.split3(s_in):
        term = cc[:, :, None] @ part.float().transpose(-1, -2)
        y_state = term if y_state is None else y_state + term
    y = y_intra + y_state * torch.exp(L)[..., None]
    y = y.permute(0, 1, 3, 2, 4).reshape(Bb, S + pad, H, P)[:, :S]
    return y, s


def sliced_scan(x, dt, A, Bm, Cm, s0=None, chunks=kssm.SCAN_SLICE,
                Q=kssm.SCAN_CHUNK):
    """``split_scan`` over slices of ``chunks`` chunks, in order, each from
    the state the last one left (the kernel's slices): (y, final state)."""
    ys, s = [], s0
    for a in range(0, x.shape[1], chunks * Q):
        y, s = split_scan(*(t[:, a:a + chunks * Q] for t in (x, dt)), A,
                          *(t[:, a:a + chunks * Q] for t in (Bm, Cm)), s, Q)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def split_prefill(xbc, dt, dt_bias, A_log, D, state, carry=True):
    """``ssd_prefill``'s kernel on (B, S, H P + 2 N) rows: the scan of
    ``split_scan``, y rounded to bf16, plus x D in bf16; the final state
    into ``state``."""
    H, P, N = state.shape[1:]
    B, S = xbc.shape[:2]
    x = xbc[..., :H * P].reshape(B, S, H, P).float()
    Bm = xbc[..., H * P:H * P + N].float()
    Cm = xbc[..., H * P + N:].float()
    dtp = kssm.softplus(dt.float() + dt_bias.float())
    A = -torch.exp(A_log.float())
    y, final = split_scan(x, dtp, A, Bm, Cm, state if carry else None)
    y = y.to(torch.bfloat16) + (x.to(torch.bfloat16)
                                * D.to(torch.bfloat16)[None, None, :, None])
    state.copy_(final)
    return y.reshape(B, S, H * P)


# -- split3 ---------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 7e4, 1e30])
def test_split3_is_exact_and_its_products_are_f32_exact(scale):
    """Exact while the third part stays a normal number (|v| above about
    2^-100; below, lo loses bits to f32's subnormal range, an absolute
    error under 2^-130)."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((scale * rng.standard_normal(4096))
                         .astype(np.float32))
    hi, mid, lo = kssm.split3(v)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), v)
    b = torch.from_numpy(rng.standard_normal(4096).astype(np.float32)
                         ).bfloat16().float()
    split = (hi.float() * b + mid.float() * b) + lo.float() * b
    exact = v.double() * b.double()
    f32 = (v * b).double()
    assert float((split.double() - exact).abs().max()
                 / exact.abs().max()) <= 2.0 ** -22
    assert float((split.double() - f32).abs().max()
                 / f32.abs().max()) <= 2.0 ** -22


# -- the scan at mamba2's widths against the plain version ---------------------
def _mamba_rows(B, S, seed):
    """conv-output-like xbc (B, S, 5376), raw dt (B, S, 80), parameters
    and a state at mamba2-2.7b's widths, as chip_smoke.py draws them."""
    cfg = get_config(ARCH)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = torch.Generator().manual_seed(seed)
    xbc = torch.nn.functional.silu(torch.randn(B, S, H * P + 2 * N,
                                               generator=g)).bfloat16()
    dt = torch.randn(B, S, H, generator=g).bfloat16()
    params = [(scale * torch.randn(H, generator=g)).bfloat16()
              for scale in (0.5, 0.5, 1.0)]                  # dt_bias, A_log, D
    state = 0.3 * torch.randn(B, H, P, N, generator=g)
    return xbc, dt, params, state


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("B,S", [(1, 130), (2, 64)])
def test_split_scan_matches_the_plain_prefill_at_mamba2_widths(B, S, carry):
    xbc, dt, (dt_bias, A_log, D), state = _mamba_rows(B, S, seed=B * S)
    s1, s2 = state.clone(), state.clone()
    y = split_prefill(xbc, dt, dt_bias, A_log, D, s1, carry)
    ref = kssm.ssd_prefill_plain(xbc, dt, dt_bias, A_log, D, s2, carry,
                                 get_config(ARCH).ssm_chunk)
    assert y.dtype == ref.dtype == torch.bfloat16
    assert _rel(y.float(), ref.float()) <= BF16_STEP
    assert _rel(s1, s2) <= SSD_STATE_REL_TOL


# -- the scan at small widths against the JAX package ---------------------------
def _scan_inputs(S, seed=0, H=3, P=8, N=16, B=2):
    """x, dt, A, B, C and an initial state, x, B and C rounded to bf16
    (the kernel's operands)."""
    rng = np.random.default_rng(seed)
    x = _bf(rng.standard_normal((B, S, H, P)).astype(np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(0.5 * rng.standard_normal(H)).astype(np.float32)
    Bm = _bf(rng.standard_normal((B, S, N)).astype(np.float32))
    Cm = _bf(rng.standard_normal((B, S, N)).astype(np.float32))
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("S", [1, 63, 64, 65, 301])
def test_split_scan_matches_jax_ssd_chunked_and_the_oracle(S):
    args = _scan_inputs(S, seed=S)
    x, dt, A, Bm, Cm, s0 = args
    jy, js = jssm.ssd_chunked(*(jnp.asarray(a) for a in args[:5]), 64,
                              init_state=jnp.asarray(s0))
    ry, rs = ssd_scan_ref(*(jnp.asarray(a) for a in args[:5]),
                          init_state=jnp.asarray(s0))
    ty, ts = split_scan(*(torch.from_numpy(a) for a in args))
    for t, j in ((ty, jy), (ts, js), (ty, ry), (ts, rs)):
        assert _rel(t, j) <= F32_TOL
    zy, _ = split_scan(*(torch.from_numpy(a) for a in args[:5]))
    ry0, _ = ssd_scan_ref(*(jnp.asarray(a) for a in args[:5]))
    assert _rel(zy, ry0) <= F32_TOL


@pytest.mark.parametrize("carry", [True, False])
@pytest.mark.parametrize("S", [513, 1100])
def test_sliced_scan_matches_the_whole_scan_and_jax(S, carry):
    """Two and three slices, the last one partial and its last chunk
    masked, from a state or from zeros."""
    args = _scan_inputs(S, seed=S + carry)
    x, dt, A, Bm, Cm, s0 = args
    init = s0 if carry else None
    ty, ts = sliced_scan(*(torch.from_numpy(a) for a in args[:5]),
                         None if init is None else torch.from_numpy(init))
    wy, ws = split_scan(*(torch.from_numpy(a) for a in args[:5]),
                        None if init is None else torch.from_numpy(init))
    assert _rel(ty, wy) <= 1e-6 and _rel(ts, ws) <= 1e-6
    jy, js = jssm.ssd_chunked(
        *(jnp.asarray(a) for a in args[:5]), 64,
        init_state=None if init is None else jnp.asarray(init))
    assert _rel(ty, jy) <= F32_TOL and _rel(ts, js) <= F32_TOL


def test_split_scan_stays_finite_under_strong_decay_over_a_long_prompt():
    """S 4096, dt about 10 and |A| up to e: L falls by hundreds a chunk;
    the segment-sum form takes no quotient of exponentials, so nothing
    turns into inf or nan, and the plain version agrees."""
    S, H, P, N = 4096, 2, 8, 16
    g = torch.Generator().manual_seed(5)
    xbc = torch.nn.functional.silu(torch.randn(1, S, H * P + 2 * N,
                                               generator=g)).bfloat16()
    dt = (10 + torch.randn(1, S, H, generator=g)).bfloat16()
    dt_bias = torch.zeros(H).bfloat16()
    A_log = torch.tensor([1.0, -0.5]).bfloat16()
    D = torch.ones(H).bfloat16()
    state = torch.randn(1, H, P, N, generator=g)
    s1, s2 = state.clone(), state.clone()
    y = split_prefill(xbc, dt, dt_bias, A_log, D, s1, True)
    ref = kssm.ssd_prefill_plain(xbc, dt, dt_bias, A_log, D, s2, True, 256)
    assert bool(torch.isfinite(y.float()).all())
    assert bool(torch.isfinite(s1).all())
    assert _rel(y.float(), ref.float()) <= BF16_STEP
    assert _rel(s1, s2) <= SSD_STATE_REL_TOL


# -- the reduced model's decode step -------------------------------------------
def test_reduced_mamba2_decode_step_matches_jax():
    """Two decode steps of the reduced mamba2 (2 layers, f32) from a
    prefill, row 1 frozen in the second, against the JAX ``Model``."""
    over = dict(param_dtype="f32", num_layers=2)
    jm = JModel(dataclasses.replace(jreduced(jget(ARCH)), **over,
                                    dtype="f32"))
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    rng = np.random.default_rng(3)
    ssm = jp["layers"]["ssm"]
    for k, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("conv_b", 0.2)):
        ssm[k] = jnp.asarray(scale * rng.standard_normal(ssm[k].shape),
                             ssm[k].dtype)
    model = Model(dataclasses.replace(reduced(get_config(ARCH)), **over),
                  device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = rng.integers(1, 512, (2, 9)).astype(np.int32)
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                       jm.init_cache(2, 16))
    tc = model.init_cache(2, 16)
    model.prefill(params, torch.from_numpy(toks).long(), tc)
    for step in range(2):
        t = rng.integers(1, 512, (2, 1)).astype(np.int32)
        mask = np.array([True, step != 1])
        jl, jc = jm.decode_step(jp, jnp.asarray(t), jc,
                                advance_mask=jnp.asarray(mask))
        tl = model.decode_step(params, torch.from_numpy(t).long(), tc,
                               advance_mask=torch.from_numpy(mask))
        assert _rel(tl, jl) <= F32_TOL
