"""The port's rules: no JAX, nothing of ``repro``, no quiet CPU fallback.

* ``repro_torch`` and every submodule import in a fresh interpreter where
  ``jax`` cannot be imported and a meta-path finder refuses ``repro`` and
  ``repro.*``; so does ``chip_smoke.py``.
* No source file of the port, nor ``chip_smoke.py``, has an ``import`` or
  ``from`` of ``jax`` or ``repro``.
* Without CUDA, building a sketch, a policy, a model or a serving engine,
  or running the serving launcher, without ``device="cpu"`` raises, and a
  kernel wrapper asked for its kernel on a CPU tensor raises.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.core import REGISTRY, CMSSketch, SizeAwareWTinyLFU
from repro_torch.kernels.attention import flash
from repro_torch.kernels.cms import cms
from repro_torch.kernels.wkv import wkv6 as wkv
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.serving import Engine, EngineConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = pathlib.Path(repro_torch.__file__).parent
CHIP_SMOKE = ROOT / "chip_smoke.py"

_GUARD = textwrap.dedent("""
    import importlib.abc, sys
    sys.modules["jax"] = None  # any `import jax` now raises ImportError

    class _RefuseReference(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "repro" or name.startswith("repro."):
                raise ImportError(f"the port imported {name}")
            return None

    sys.meta_path.insert(0, _RefuseReference())
""")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _run_guarded(body: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _GUARD + textwrap.dedent(body)],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)


def test_every_port_module_imports_without_jax_or_reference():
    modules = list(_port_modules())
    assert "repro_torch.kernels.cms.cms" in modules and "repro_torch.state" in modules
    assert {"repro_torch.kernels.attention.flash", "repro_torch.models.transformer",
            "repro_torch.serving.engine", "repro_torch.launch.serve",
            "repro_torch.kernels.wkv.wkv6", "repro_torch.kernels.wkv.ops",
            "repro_torch.kernels.wkv.ref", "repro_torch.models.rwkv"} <= set(modules)
    proc = _run_guarded(f"""
        import importlib
        for name in {modules!r}:
            importlib.import_module(name)
        bad = sorted(m for m, mod in sys.modules.items()
                     if mod is not None and (m == "repro" or m.startswith(("repro.", "jax"))))
        assert not bad, bad
        print("ok")
    """)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_imports_without_jax_or_reference():
    proc = _run_guarded(f"""
        import importlib.util
        spec = importlib.util.spec_from_file_location("chip_smoke", {str(CHIP_SMOKE)!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print("ok")
    """)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_reference(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """Run without a card (and alone, away from the repo) it exits nonzero
    and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(CHIP_SMOKE.read_text())
    for cwd, script in ((ROOT, CHIP_SMOKE), (tmp_path, lone)):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              cwd=cwd, timeout=120,
                              env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the rule is about machines without it")
    with pytest.raises(RuntimeError, match="cuda"):
        CMSSketch(64)
    with pytest.raises(RuntimeError, match="cuda"):
        SizeAwareWTinyLFU(10**6, sketch_backend="cms")
    with pytest.raises(RuntimeError, match="cuda"):
        REGISTRY.build("wtlfu-av-slru?sketch_backend=cms", 10**6)
    with pytest.raises(RuntimeError, match="cuda"):
        REGISTRY.build("wtlfu-av-slru", 10**6)  # whatever the backend
    assert REGISTRY.build("wtlfu-av-slru?sketch_backend=cms&device=cpu", 10**6)
    cfg = get_config("smollm-135m").scaled_down(num_layers=1)
    with pytest.raises(RuntimeError, match="cuda"):
        LM(cfg)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(model, params, EngineConfig(device="cuda"))
    assert Engine(model, params, EngineConfig()).prefix_cache.policy
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "smollm-135m", "--requests", "1"])
    assert serve.main(["--arch", "smollm-135m", "--requests", "1", "--device", "cpu",
                       "--max-new-tokens", "1"])


def test_wrappers_never_take_the_kernel_path_quietly():
    """use_kernel=True on a CPU tensor raises; it does not fall back."""
    table = torch.zeros((4, 128), dtype=torch.int32)
    keys = torch.arange(5, dtype=torch.int32)
    q = torch.zeros((1, 4, 2, 64))
    u = torch.zeros((2, 64))
    for call in (lambda: cms.cms_update(table, keys, use_kernel=True),
                 lambda: cms.cms_estimate(table, keys, use_kernel=True),
                 lambda: cms.cms_update_estimate(table, keys, keys, use_kernel=True),
                 lambda: flash.flash_attention_fwd(q, q, q, 0.125, use_kernel=True),
                 lambda: wkv.wkv6_fwd(q, q, q, q, u, use_kernel=True)):
        with pytest.raises(ValueError, match="use_kernel=True"):
            call()
