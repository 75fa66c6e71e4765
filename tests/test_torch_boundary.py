"""The port's boundary: ``llmapigateway_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package; entry points never fall back to the
CPU when the card is missing; the smoke exits non-zero without a card or
without the package; the config reader accepts the repo's example files."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import json5
import pytest
import torch

import llmapigateway_tpu_torch
from llmapigateway_tpu_torch.config.schemas import (LocalEngineConfig,
                                                    ProviderDetails)
from llmapigateway_tpu_torch.engine.engine import InferenceEngine
from llmapigateway_tpu_torch.providers.local import make_local_provider
from llmapigateway_tpu_torch.utils import json5lite

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(llmapigateway_tpu_torch.__file__).parent
SMOKE = REPO / "chip_smoke.py"
# A preset whose head geometry the kernels are built for: on the card an
# engine of any other (tiny-test's heads are 16 wide) is refused at build.
ENGINE = {"preset": "tinyllama-1.1b", "kv_page_size": 16,
          "prefix_cache": False, "max_seq_len": 256}


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "llmapigateway_tpu", "tools")


def test_the_scan_covers_the_ported_tools():
    names = {p.relative_to(PORT_DIR).as_posix()
             for p in PORT_DIR.rglob("*.py")}
    assert {"tools/__init__.py", "tools/profile_insert.py",
            "tools/profile_decode.py",
            "tools/profile_engine_burst.py"} <= names


@pytest.mark.parametrize("path", sorted(PORT_DIR.rglob("*.py")) + [SMOKE],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_imports(path):
    """Every module of the port (its ``tools/`` included) and the smoke:
    no JAX, no JAX package, and not the JAX package's ``tools/``."""
    bad = [n for n in _imported_modules(path) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = LocalEngineConfig(**ENGINE)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_provider("local", ProviderDetails(type="local",
                                                     engine=cfg))


def test_chip_smoke_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import chip_smoke
    assert chip_smoke.main() != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_point_parses_its_device_flag(monkeypatch, capsys):
    from llmapigateway_tpu_torch.__main__ import main
    monkeypatch.setattr(sys, "argv", ["llmapigateway_tpu_torch", "--help"])
    with pytest.raises(SystemExit) as exc:
        main()
    assert exc.value.code == 0 and "--device" in capsys.readouterr().out


@pytest.mark.parametrize("name", ["providers.json.example",
                                  "models_fallback_rules.json.example"])
def test_json5lite_reads_the_example_configs(name):
    text = (REPO / name).read_text()
    assert json5lite.loads(text) == json5.loads(text)


def test_json5lite_refuses_what_it_does_not_read():
    assert json5lite.loads('{"a": "// x", "b": [1, 2,],} // c') == {
        "a": "// x", "b": [1, 2]}
    for bad in ("{'a': 1}", '{"a": 1 /* open', "{a: 1}"):
        with pytest.raises(ValueError):
            json5lite.loads(bad)
