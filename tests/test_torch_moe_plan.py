"""The grouped expert GEMMs' tiling, held on the CPU: the chunk plan
along K (``moe_gemm_plan``), the row tile, the route and the persistent
grid of ``kernels/moe.py``, which the CUDA kernel takes as given; and the
GEMMs' plain versions against the JAX package's expert einsums
(``models/moe.py:107-116``) on the same routed rows.

The plan must cover K exactly in chunks of a multiple of the 64-row k
tile, and depend on (K, N', SM count) alone: a row's sums are added chunk
by chunk in this plan's order, so a plan that read the counts, C or the
active experts would make a token's bits depend on its batch-mates. At
the shapes of phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b on a 132-SM H100,
two active experts (one token at top-2) must still give at least 132
work items of weight streaming.

Tolerances: f32 within 1e-5 of the output's largest magnitude (the sums
run in another order than XLA's); bf16 within one bf16 step at its scale
(both round the f32 sums once, at the JAX module's points).
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as jlayers
from repro_torch.configs import get_config
from repro_torch.kernels import moe

H100_SMS = 132
PHI, KIMI = "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"


def _gemm_shapes(arch):
    """(K, N') of the gate-up and the down GEMM of a config."""
    cfg = get_config(arch)
    return ((cfg.d_model, 2 * cfg.d_ff), (cfg.d_ff, cfg.d_model))


@pytest.mark.parametrize("K,N,sms", [
    (4096, 12800, 132), (6400, 4096, 132), (7168, 4096, 132),
    (2048, 7168, 132), (520, 400, 132), (200, 520, 132), (8, 8, 132),
    (64, 128, 1), (6400, 4096, 8), (4104, 96, 1000)])
def test_plan_covers_k_in_k_tile_chunks(K, N, sms):
    chunks, per = moe.moe_gemm_plan(K, N, sms)
    assert per % moe.K_TILE == 0 and per > 0 and chunks >= 1
    # chunks of `per` rows, the last holding the rest (at least one row)
    assert (chunks - 1) * per < K <= chunks * per
    assert moe.moe_gemm_plan(K, N, sms) == (chunks, per)


def test_plan_reads_only_its_arguments():
    """The same (K, N', SMs) give the same plan whatever was planned
    before or around it, and the function takes nothing else."""
    import inspect
    assert list(inspect.signature(moe.moe_gemm_plan).parameters) == [
        "K", "N", "sms"]
    first = [moe.moe_gemm_plan(K, N, H100_SMS)
             for arch in (PHI, KIMI) for K, N in _gemm_shapes(arch)]
    for C in (8, 16, 320):                    # routes and grids in between
        for arch in (PHI, KIMI):
            for K, N in _gemm_shapes(arch):
                moe.moe_gemm_ctas(16, C, N,
                                  moe.moe_gemm_plan(K, N, H100_SMS)[0],
                                  H100_SMS)
    assert first == [moe.moe_gemm_plan(K, N, H100_SMS)
                     for arch in (PHI, KIMI) for K, N in _gemm_shapes(arch)]


@pytest.mark.parametrize("arch", [PHI, KIMI])
def test_two_active_experts_fill_the_card(arch):
    for K, N in _gemm_shapes(arch):
        chunks, _ = moe.moe_gemm_plan(K, N, H100_SMS)
        blocks = -(-N // moe.COL_BLOCK)
        # decode capacities take the split route where there are chunks,
        # so each chunk of each column block is a work item
        C = 8
        assert moe.row_tile(C) == 16
        assert moe.moe_gemm_split(C, chunks) == (chunks > 1)
        assert 2 * blocks * chunks >= H100_SMS, (K, N, chunks)
        # and the persistent grid holds them all at once (two CTAs an SM)
        E = get_config(arch).num_experts
        assert moe.moe_gemm_ctas(E, C, N, chunks, H100_SMS) >= \
            min(2 * blocks * chunks, 2 * H100_SMS)


def test_row_tiles_and_routes_at_the_served_shapes():
    """phi3.5-moe's decode (C 8) takes the 16-row tile, its 4 x 512
    bucket (C 320) three 128-row tiles on the walk route (no partials),
    and the grid is one CTA an SM there, two at decode."""
    cfg = get_config(PHI)
    E, K = cfg.num_experts, cfg.experts_per_token
    for T, R, tiles in ((1, 16, 1), (4, 16, 1), (2048, 128, 3)):
        C = moe.capacity(E, K, cfg.capacity_factor, T)
        assert moe.row_tile(C) == R and -(-C // R) == tiles
    (Kgu, Ngu), (Kd, Nd) = _gemm_shapes(PHI)
    ch_gu = moe.moe_gemm_plan(Kgu, Ngu, H100_SMS)[0]
    ch_d = moe.moe_gemm_plan(Kd, Nd, H100_SMS)[0]
    assert not moe.moe_gemm_split(320, ch_gu)
    assert not moe.moe_gemm_split(320, ch_d)
    assert moe.moe_gemm_ctas(E, 320, Nd, ch_d, H100_SMS) == H100_SMS
    assert moe.moe_gemm_ctas(E, 8, Nd, ch_d, H100_SMS) == 2 * H100_SMS
    # a group whose work items are fewer than the card's CTAs
    assert moe.moe_gemm_ctas(1, 4, 400, 1, H100_SMS) == 4


def _jax_expert_gemms(buf, w_gu, w_down, dtype):
    """The JAX ``moe_forward``'s expert GEMMs (moe.py:107-116) on the
    dispatched rows ``buf`` (E, C, D)."""
    act = jlayers.activation_fn(jget(PHI).activation)
    gu = jnp.einsum("ecd,edf->ecf", buf, w_gu,
                    preferred_element_type=jnp.float32)
    g, u = jnp.split(gu, 2, axis=-1)
    h = (act(g) * u).astype(dtype)
    y = jnp.einsum("ecf,efd->ecd", h, w_down,
                   preferred_element_type=jnp.float32).astype(dtype)
    return np.asarray(h.astype(jnp.float32)), np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("T", [7, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_gemms_match_jax(dtype, T):
    """The GEMMs' plain versions over the routed rows (a ragged E 4, D 40,
    F 24 layer, top-2) against the JAX einsums over the same dispatched
    buffer; rows past the counts are the JAX buffer's zeros and are not
    compared."""
    E, K, D, Fw = 4, 2, 40, 24
    rng = np.random.default_rng(T)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w_r = rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5
    w_gu = rng.standard_normal((E, D, 2 * Fw)).astype(np.float32) * D ** -0.5
    w_d = rng.standard_normal((E, Fw, D)).astype(np.float32) * Fw ** -0.5
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jx, jgu, jd = (jnp.asarray(a).astype(jdt) for a in (x, w_gu, w_d))
    tx, tgu, td = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                   for a in (jx, jgu, jd))
    C = moe.capacity(E, K, 1.25, T)
    _, _, _, counts, src, _ = moe.route_from_logits_plain(
        moe.router_logits_plain(tx, torch.from_numpy(w_r).to(tdt)), K, C)
    # the JAX dispatch buffer of these slots: row c of expert e is the
    # token at src[e, c] for c < counts[e], zeros past the count
    buf = np.zeros((E, C, D), np.float32)
    live = np.arange(C)[None] < counts.numpy()[:, None]
    xs = np.asarray(jx.astype(jnp.float32))
    buf[live] = xs[src.numpy()[live]]
    jh, jy = _jax_expert_gemms(jnp.asarray(buf).astype(jdt), jgu, jd, jdt)
    th = moe.moe_gate_up_swiglu(tx, tgu, C, counts, src)
    ty = moe.moe_down(th, td, counts)
    assert th.dtype == ty.dtype == tdt
    for got, want in ((th, jh), (ty, jy)):
        got, want = got.float().numpy()[live], want[live]
        scale = np.abs(want).max()
        tol = 1e-5 * scale if dtype == "f32" else 2.0 ** -7 * scale
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    # the shared experts' form: one group of T rows, no counts, no map
    sh = moe.moe_gate_up_swiglu(tx, tgu[:1], T)
    sy = moe.moe_down(sh, td[:1])
    jsh, jsy = _jax_expert_gemms(jx[None], jgu[:1], jd[:1], jdt)
    for got, want in ((sh, jsh), (sy, jsy)):
        scale = np.abs(want).max()
        tol = 1e-5 * scale if dtype == "f32" else 2.0 ** -7 * scale
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("arch,T,fused", [
    (PHI, 1, True), (PHI, 4, True), (PHI, 2048, False), (KIMI, 4, True),
    (KIMI, 512, True), (KIMI, 1024, False), ("ragged", 16, True),
    ("ragged", 333, False)])
def test_down_combine_route(arch, T, fused):
    """``moe_down_combined``: at decode (C within the 16-row tile) the
    down GEMM writes its f32 sums by chunk and one kernel adds them into
    the combine; past it (the prefill) the two stay apart. The route reads
    C alone: kimi-k2's 384 experts keep C at 16 up to T 512."""
    E, K, cf = ((4, 2, 1.25) if arch == "ragged" else
                (get_config(arch).num_experts,
                 get_config(arch).experts_per_token,
                 get_config(arch).capacity_factor))
    C = moe.capacity(E, K, cf, T)
    assert moe.moe_down_combined(C) == fused == (moe.row_tile(C) == 16)


def _routed(T, E, K, D, Fw, dtype, drops, rng):
    """Rows through the plain routing: a router that sends every token to
    experts 0 and 1 (past their capacity) where ``drops``."""
    x = rng.standard_normal((T, D)).astype(np.float32)
    w_r = rng.standard_normal((D, E)).astype(np.float32) * D ** -0.5
    if drops:
        x[:, 0] = 8.0
        w_r[0, :2] = [1.0, 0.9]
    w_gu = rng.standard_normal((E, D, 2 * Fw)).astype(np.float32) * D ** -0.5
    w_d = rng.standard_normal((E, Fw, D)).astype(np.float32) * Fw ** -0.5
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    tx, tgu, td = (torch.from_numpy(a).to(tdt) for a in (x, w_gu, w_d))
    C = moe.capacity(E, K, 1.25, T)
    gates, experts, slots, counts, src, _ = moe.route_from_logits_plain(
        moe.router_logits_plain(tx, torch.from_numpy(w_r).to(tdt)), K, C)
    th = moe.moe_gate_up_swiglu(tx, tgu, C, counts, src)
    live = torch.arange(C)[None] < counts[:, None]
    th = torch.where(live[..., None], th, torch.zeros((), dtype=tdt))
    return tx, tgu, td, th, gates, experts, slots, counts, C


@pytest.mark.parametrize("case", ["drops", "shared"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_down_combine_plain_matches_jax_and_the_pair(dtype, case):
    """``moe_down_combine``'s plain version bit-equal to
    ``moe_combine_plain(moe_down_plain(...))``, and against the JAX
    module's down einsum, gather back and combine (moe.py:113-125) with
    the shared experts' add (:136-139): a ragged E 4, D 40, F 24 layer at
    T 12 (C 8), with pairs dropped past C, or kimi-k2's form of a shared
    expert (one group of all T rows)."""
    E, K, D, Fw, T = 4, 2, 40, 24, 12
    rng = np.random.default_rng(len(case) + len(dtype))
    tx, tgu, td, th, gates, experts, slots, counts, C = _routed(
        T, E, K, D, Fw, dtype, case == "drops", rng)
    assert moe.moe_down_combined(C)
    keep = slots < C
    assert bool((~keep).any()) == (case == "drops")
    shared = None
    if case == "shared":
        sh = moe.moe_gate_up_swiglu(tx, tgu[1:2], T)
        shared = moe.moe_down(sh, td[2:3])[0]
    got = moe.moe_down_combine(th, td, gates, experts, slots, counts, shared)
    pair = moe.moe_combine_plain(moe.moe_down_plain(th, td, counts), gates,
                                 experts, slots, shared)
    assert got.dtype == th.dtype and torch.equal(got, pair)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jh, jd = (jnp.asarray(a.float().numpy()).astype(jdt) for a in (th, td))
    y_buf = jnp.einsum("ecf,efd->ecd", jh, jd,
                       preferred_element_type=jnp.float32).astype(jdt)
    ek, sk = jnp.asarray(experts.numpy()), jnp.asarray(slots.numpy())
    per_pair = jnp.where(jnp.asarray(keep.numpy())[..., None],
                         y_buf[ek, jnp.minimum(sk, C - 1)], 0)
    want = jnp.einsum("tkd,tk->td", per_pair.astype(jnp.float32),
                      jnp.asarray(gates.numpy())).astype(jdt)
    if shared is not None:
        want = want + jnp.asarray(shared.float().numpy()).astype(jdt)
    want = np.asarray(want.astype(jnp.float32))
    scale = np.abs(want).max()
    tol = 1e-5 * scale if dtype == "f32" else 2.0 ** -7 * scale
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
