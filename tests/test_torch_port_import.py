"""Import hygiene of visiondk_tpu_torch: no JAX, no Triton, no build at import.

The check runs in a fresh interpreter, because this test process has JAX
loaded already (tests/conftest.py imports it).
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import visiondk_tpu_torch, visiondk_tpu_torch.models, visiondk_tpu_torch.engine.steps
import visiondk_tpu_torch.ops.attention, visiondk_tpu_torch.losses, visiondk_tpu_torch.models.ema
import visiondk_tpu_torch.engine.optim, visiondk_tpu_torch.engine.schedules
import visiondk_tpu_torch.engine.state, visiondk_tpu_torch.engine.trainer
import visiondk_tpu_torch.ops.window_attention, visiondk_tpu_torch.models.backbones.swin
import visiondk_tpu_torch.models.convert
from visiondk_tpu_torch.ops import _build
loaded = sorted(m for m in ("jax", "jaxlib", "flax", "optax", "triton", "visiondk_tpu")
                if m in sys.modules)
print("LOADED", loaded)
print("BUILT", sorted(_build._loaded))
"""


def test_port_imports_without_jax_flax_optax_or_triton():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout
    assert "BUILT []" in proc.stdout, proc.stdout  # kernels build at first CUDA use only


def test_no_port_source_mentions_jax_imports():
    for path in (REPO / "visiondk_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            for mod in ("jax", "flax", "optax", "triton", "visiondk_tpu."):
                assert not stripped.startswith((f"import {mod}", f"from {mod}")), (path, line)


def test_registry_rejects_duplicates_and_unknown_names():
    from visiondk_tpu_torch.registry import Registry

    reg = Registry("thing")
    reg.register(lambda: 1, name="one")
    assert reg.create("one") == 1 and "one" in reg and reg.keys() == ["one"]
    with pytest.raises(ValueError, match="already registered"):
        reg.register(lambda: 2, name="one")
    with pytest.raises(KeyError, match="unknown entry"):
        reg.get("two")


@pytest.mark.parametrize(
    "name,want",
    [
        ("vit_base_patch16_224", "vit_base_patch16_224"),
        ("timm-vit_base_patch16_224.augreg_in21k", "vit_base_patch16_224"),
        ("timm-swin_base_patch4_window7_224.ms_in22k_ft_in1k", "swin_base_patch4_window7_224"),
    ],
)
def test_canonical_model_name_matches_jax(name, want):
    from visiondk_tpu.config.checks import canonical_model_name as jax_canonical
    from visiondk_tpu_torch.config import canonical_model_name

    assert canonical_model_name(name) == jax_canonical(name) == want


def test_vit_family_registered():
    """The ported families are registered under the JAX names: ViT and Swin V1
    (SwinV2's names start with ``swinv2_``)."""
    from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
    from visiondk_tpu_torch.models import BACKBONES

    ported = sorted(k for k in JAX_BACKBONES.keys()
                    if k.startswith(("vit_", "swin_")) and "port_test" not in k)
    assert "swin_base_patch4_window7_224" in ported
    assert sorted(k for k in BACKBONES.keys() if "port_test" not in k) == ported
