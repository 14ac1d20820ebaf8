"""Package-level rules of the port: it imports nothing of JAX or of the
JAX package, its entry points run on the card unless asked for the CPU,
the serve CLI runs end to end on the CPU, and ``chip_smoke.py`` refuses
to report a result without a card."""
import _torch_threads  # noqa: F401  (first: one torch thread)
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import from_jax
from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import Model
from repro_torch.models.params import ParamSpec, init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_port_imports_with_jax_and_repro_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            "import repro_torch.launch.serve, repro_torch.bridge\n"
            "import repro_torch.kernels.build\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card(monkeypatch):
    """Without device='cpu' every entry point asks for CUDA and raises
    when there is none, instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("llama3.2-1b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params({"w": ParamSpec((2, 2))}, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax({"layers": {"w": np.zeros((1, 2, 2), np.float32)}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "1"])
    assert Model(cfg, device="cpu").device.type == "cpu"


def test_serve_cli_on_cpu_matches_reference(capsys):
    res = serve.main(["--device", "cpu", "--requests", "5", "--max-new",
                      "6", "--slots", "2", "--megastep-k", "4",
                      "--precision", "q8_0", "--kv-quant", "q4_0",
                      "--temperature", "0", "--max-len", "32"])
    assert "tok/s" in capsys.readouterr().out
    eng = res.engine
    assert eng.kv_quant == "q4_0" and eng.quant_policy == "q8_0"
    assert res.warmup_stats.steps > 0
    for r in res.requests:
        assert r.done and len(r.output) == 6
        assert r.output == eng.model.reference_decode(
            eng.params, r.prompt, 6, max_len=32)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_serve_cli_paged_with_prefix_cache_on_cpu(capsys):
    """``--page-size 8 --prefix-cache``: every prompt opens with the same
    17 tokens, so every request after the first two (admitted together)
    hits two cached pages; streams equal the reference, the audit holds
    after every step, and the pool holds only the registry's blocks
    after."""
    res = serve.main(["--device", "cpu", "--requests", "5", "--max-new",
                      "6", "--slots", "2", "--megastep-k", "4",
                      "--precision", "q8_0", "--kv-quant", "q8_0",
                      "--temperature", "0", "--max-len", "48",
                      "--page-size", "8", "--prefix-cache", "--audit"])
    out = capsys.readouterr().out
    assert "prefix_hits=" in out and "blocks_in_use=" in out
    eng = res.engine
    assert eng.paged and eng.prefix_cache and eng.audit_every_step
    assert eng.stats.prefix_hits >= 3
    assert eng.stats.prefix_hit_tokens == 16 * eng.stats.prefix_hits
    assert eng.blocks_in_use == len(eng._prefix_reg)
    for r in res.requests:
        assert r.done and len(r.output) == 6 and len(r.prompt) > 17
        assert r.output == eng.model.reference_decode(
            eng.params, r.prompt, 6, max_len=48)
