"""The assigned dense configs in the port against the JAX package on the
CPU: mistral-nemo-12b, deepseek-67b and qwen1.5-110b.

- their configs, with the execution version, field by field (the plain
  config, its V0 and their ``reduced``);
- a reduced variant of each at the full model's (head_dim, query heads
  per kv head) pair, with the JAX parameters carried over by
  ``repro_torch.bridge``: mistral-nemo at (128, 4) with q_dim != d_model
  and rope_theta 1e6, deepseek-67b at (128, 8), qwen1.5-110b at (128, 8)
  with seeded random QKV biases under bf16 params;
- the plain decode attention at (128, 8) over bf16, q8_0 and q4_0 caches
  against the JAX ``ops._decode_attention_jnp`` / ``decode_attention_quant``
  and the plain flash attention at (128, 8) against the Pallas kernel in
  interpret mode;
- ``Model.init`` quantizing each leaf as it is drawn: the bits of
  ``quantize_tree`` over the float init, and no two float matrices alive
  at once;
- ``quant_matmul_plain(out=)`` and the views it refuses;
- the serve CLI on each new config, reduced.

Tolerances: f32 params, logits within 1e-4 absolute and greedy streams
equal; bf16 params, logits within 2.5% of their largest magnitude
(test_torch_paper_models.py gives the reasons); the attention plain
versions within one bf16 ulp of the output's scale.
"""
import _torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import functools
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.models import Model as JModel
from repro.quant.quantize import quantize_rows as jquantize_rows
from repro_torch.bridge import from_jax, to_tensor
from repro_torch.configs import ASSIGNED_DENSE, CONFIGS, get_config, reduced
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.decode_attention_quant import \
    decode_attention_quant_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.quant_matmul import quant_matmul_plain
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models import model as model_mod
from repro_torch.quant import QuantizedTensor, quantize, quantize_tree

CPU = torch.device("cpu")
# the reduced variant of each: the full model's (head_dim, G), d_model
# 128, 2 layers, vocabulary 512
VARIANTS = {
    "mistral-nemo-12b": dict(num_heads=4, num_kv_heads=1, head_dim=128),
    "deepseek-67b": dict(num_heads=8, num_kv_heads=1, head_dim=128),
    "qwen1.5-110b": dict(num_heads=8, num_kv_heads=1, head_dim=128),
}
MAX_LEN = 32
PROMPT = np.random.default_rng(29).integers(1, 512, 19).astype(np.int32)


def test_the_assigned_dense_configs_are_registered():
    assert sorted(ASSIGNED_DENSE) == ["deepseek-67b", "mistral-nemo-12b",
                                      "qwen1.5-110b"]
    assert set(ASSIGNED_DENSE) <= set(CONFIGS)
    assert set(ASSIGNED_DENSE) <= set(serve.build_parser()._option_string_actions[
        "--arch"].choices)


@pytest.mark.parametrize("version", ["v0", "v1", "v3"])
@pytest.mark.parametrize("name", sorted(ASSIGNED_DENSE))
def test_configs_and_versions_equal_jax_field_by_field(name, version):
    """The config under each execution version (v0 forces both fusion
    flags off, the others leave them on), and its ``reduced``, equal the
    JAX package's in every field the port has."""
    cfg = get_config(name, scheduler_version=version)
    jcfg = jget(name, scheduler_version=version)
    assert (cfg.fuse_qkv, cfg.fuse_gate_up) == ((False, False)
                                                if version == "v0"
                                                else (True, True))
    for a, b in ((cfg, jcfg), (reduced(cfg), jreduced(jcfg))):
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name
    # the paper's default is v2; v0's flags stay off even when asked
    assert get_config(name).scheduler_version == "v2"
    forced = get_config(name, scheduler_version="v0", fuse_qkv=True)
    assert not forced.fuse_qkv
    assert get_config(name, fuse_gate_up=False).fuse_gate_up is False


def test_unknown_execution_version_raises():
    with pytest.raises(ValueError, match="scheduler_version"):
        get_config("deepseek-67b", scheduler_version="v4")


@functools.lru_cache(maxsize=None)
def _pair(name, param_dtype="f32"):
    """(JAX model, JAX params, port model, port params) of the reduced
    variant; the JAX ``wqkv.b`` drawn at random under qkv_bias."""
    over = dict(VARIANTS[name], param_dtype=param_dtype)
    jm = JModel(jreduced(jget(name), **over))
    jp = jm.init(jax.random.PRNGKey(0), quantize=False)
    if jm.cfg.qkv_bias:
        b = jp["layers"]["attn"]["wqkv"]["b"]
        rng = np.random.default_rng(11)
        jp["layers"]["attn"]["wqkv"]["b"] = jnp.asarray(
            0.5 * rng.standard_normal(b.shape), b.dtype)
    model = Model(reduced(get_config(name), **over), device="cpu")
    params = from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    pre, dec = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    jm._ref_jits = (pre, dec)       # reference_decode reuses these
    return jm, jp, model, params


def _port_cache(jc):
    return from_jax(jax.tree_util.tree_map(np.asarray, jc), device="cpu")


def _logits_close(got, want, param_dtype):
    want = np.asarray(want)
    atol = 1e-4 if param_dtype == "f32" else 0.025 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("name,param_dtype", [
    ("mistral-nemo-12b", "f32"), ("deepseek-67b", "f32"),
    ("qwen1.5-110b", "f32"), ("qwen1.5-110b", "bf16")])
def test_reduced_variant_matches_jax(name, param_dtype):
    """The variant keeps the full model's features: (head_dim, G), q_dim
    against d_model, theta, the bias. A 19-token prefill (logits, lens),
    then three decode steps each from the JAX cache carried over, then
    the greedy stream of ``reference_decode`` (f32 params)."""
    jm, jp, model, params = _pair(name, param_dtype)
    cfg, full = model.cfg, get_config(name)
    assert (cfg.head_dim, cfg.num_heads // cfg.num_kv_heads) == (
        full.head_dim, full.num_heads // full.num_kv_heads)
    assert cfg.rope_theta == full.rope_theta and cfg.qkv_bias == full.qkv_bias
    assert (cfg.q_dim != cfg.d_model) and cfg.q_dim == cfg.num_heads * 128
    if cfg.qkv_bias:
        assert bool(params["layers"][0]["attn"]["wqkv"]["b"].any())
    pre, dec = jm._ref_jits
    jc = jm.init_cache(1, MAX_LEN)
    tc = model.init_cache(1, MAX_LEN)
    jl, jc = pre(jp, {"tokens": jnp.asarray(PROMPT[None])}, jc)
    tl = model.prefill(params, torch.from_numpy(PROMPT[None]).long(), tc)
    _logits_close(tl, jl, param_dtype)
    assert tc["lens"].tolist() == [len(PROMPT)]
    for tok in (5, 311, 97):
        toks = np.array([[tok]], np.int32)
        tc = _port_cache(jc)
        jl, jc = dec(jp, jnp.asarray(toks), jc)
        tl = model.decode_step(params, torch.from_numpy(toks).long(), tc)
        _logits_close(tl, jl, param_dtype)
    if param_dtype == "f32":
        want = jm.reference_decode(jp, PROMPT[:7], 8, max_len=MAX_LEN)
        got = model.reference_decode(params, PROMPT[:7], 8, max_len=MAX_LEN)
        assert got == want


def _t(a):
    return to_tensor(np.asarray(a), CPU)


def _bf16_close(port, ref):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    tol = 2.0 ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=0, atol=tol)


@pytest.mark.parametrize("fmt", ["bf16", "q8_0", "q4_0"])
def test_decode_attention_plain_at_128_8_matches_jax(fmt):
    """deepseek-67b's / qwen1.5-110b's decode attention instance: 16
    query heads over 2 kv heads of 128, ragged kv_len (an empty row)."""
    rng = np.random.default_rng(8)
    B, Hq, Hkv, S, D = 3, 16, 2, 96, 128
    q = jnp.asarray(rng.standard_normal((B, Hq, D)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    lens = [0, 37, 96]
    lens_j = jnp.asarray(lens, jnp.int32)
    if fmt == "bf16":
        got = decode_attention_plain(_t(q), _t(k), _t(v), torch.tensor(lens))
        want = jops._decode_attention_jnp(q, k, v, lens_j)
    else:
        kq, ks = jquantize_rows(k, fmt)
        vq, vs = jquantize_rows(v, fmt)
        got = decode_attention_quant_plain(
            *(_t(a) for a in (q, kq, ks, vq, vs)), torch.tensor(lens),
            fmt=fmt)
        want = jops.decode_attention_quant(q, kq, ks, vq, vs, lens_j,
                                           fmt=fmt)
    assert got.shape == (B, Hq, D)
    _bf16_close(got, want)


def test_flash_attention_plain_at_128_8_matches_pallas():
    rng = np.random.default_rng(9)
    B, Hq, Hkv, S, D = 1, 16, 2, 128, 128
    q, k, v = (jnp.asarray(rng.standard_normal((B, h, S, D)), jnp.bfloat16)
               for h in (Hq, Hkv, Hkv))
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=True)
    want = pallas_fa(q, k, v, causal=True, bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=2e-2)


def _leaves(tree, path=""):
    if isinstance(tree, QuantizedTensor):
        yield path + "/data", tree.data
        yield path + "/scales", tree.scales
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("name,fmt", [
    ("llama3.2-1b", "q8_0"), ("llama3.2-1b", "q4_0"), ("qwen2-0.5b", "q8_0"),
    ("mamba2-2.7b", "q8_0"), ("deepseek-67b", "bf16")])
def test_leaf_by_leaf_init_is_quantize_tree_of_the_float_init(
        name, fmt, monkeypatch):
    """``Model.init`` under a quantized policy gives the bits of
    ``quantize_tree`` over the float init from the same seed (the draws
    keep their order), and quantizes each matrix before the next is
    drawn: no float matrix outlives its quantization. The column-blocked
    quantizer (blocks of 64 here) gives the bits of the whole-matrix
    one."""
    cfg = dataclasses.replace(reduced(get_config(name)), quant_policy=fmt)
    want = quantize_tree(Model(cfg, device="cpu").init(
        torch.Generator().manual_seed(3), quantize=False), fmt)
    alive = []
    real = model_mod.quantize_columns

    def watched(t, *a, **kw):
        assert all(r() is None for r in alive), "two float matrices alive"
        alive.append(weakref.ref(t))
        return real(t, *a, block=64, **kw)
    monkeypatch.setattr(model_mod, "quantize_columns", watched)
    got = Model(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    assert bool(alive) == (fmt != "bf16")
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for k in want_l:
        assert got_l[k].dtype == want_l[k].dtype, k
        assert torch.equal(got_l[k], want_l[k]), k


def test_moe_init_refuses_a_quantized_policy():
    cfg = dataclasses.replace(reduced(get_config("phi3.5-moe-42b-a6.6b")),
                              quant_policy="q8_0")
    with pytest.raises(ValueError, match="mixture-of-experts"):
        Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_quant_matmul_plain_out_view(fmt):
    """``out=`` a column range of a wider row: the values of the call
    without it, the neighbouring columns untouched; views that are not
    row-major with unit column stride, or of another shape or dtype, are
    refused."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((5, 64), generator=g).bfloat16()
    w = quantize(torch.randn((64, 40), generator=g), fmt)
    want = quant_matmul_plain(x, w)
    buf = torch.full((5, 100), 7.0, dtype=torch.bfloat16)
    got = quant_matmul_plain(x, w, out=buf[:, 24:64])
    assert got.data_ptr() == buf[:, 24:64].data_ptr()
    assert torch.equal(buf[:, 24:64], want)
    assert bool((buf[:, :24] == 7).all() and (buf[:, 64:] == 7).all())
    f32 = torch.empty((5, 48))
    assert torch.equal(quant_matmul_plain(x, w, torch.float32,
                                          out=f32[:, 8:]),
                       quant_matmul_plain(x, w, torch.float32))
    for bad in (torch.empty((40, 5), dtype=torch.bfloat16).t(),
                torch.empty((5, 80), dtype=torch.bfloat16)[:, ::2],
                torch.empty((4, 40), dtype=torch.bfloat16),
                torch.empty((5, 40))):
        with pytest.raises(ValueError, match="out must be"):
            quant_matmul_plain(x, w, out=bad)


@pytest.mark.parametrize("name", sorted(ASSIGNED_DENSE))
def test_serve_cli_runs_each_assigned_dense_model_reduced_on_cpu(
        name, capsys):
    res = serve.main(["--arch", name, "--device", "cpu", "--requests", "3",
                      "--max-new", "4", "--temperature", "0",
                      "--max-len", "64", "--precision", "q8_0"])
    assert f"arch={name}-smoke" in capsys.readouterr().out
    eng = res.engine
    assert isinstance(eng.params["layers"][0]["attn"]["wqkv"]["w"],
                      QuantizedTensor)
    for r in res.requests:
        assert r.done and r.output == eng.model.reference_decode(
            eng.params, r.prompt, 4, max_len=64)
