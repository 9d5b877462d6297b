"""The port stands alone: no module of feed_forward_vqgan_clip_tpu_torch/ and not
chip_smoke.py imports jax or anything of the JAX package, and the constants the
port copied from the JAX package's registry stay equal to it.
"""

import ast
from pathlib import Path

import pytest

from feed_forward_vqgan_clip_tpu import registry as jax_registry
from feed_forward_vqgan_clip_tpu_torch import registry

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "feed_forward_vqgan_clip_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "feed_forward_vqgan_clip_tpu")


def _imports(path):
    """Every module name an import statement of `path` names (any depth)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_nothing_of_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_isolation_check_sees_the_imports():
    """The walk finds imports inside functions and in every form."""
    src = REPO / "tests" / "test_torch_isolation.py"
    assert "feed_forward_vqgan_clip_tpu" in set(_imports(src))
    assert len(PORT_FILES) > 20


@pytest.mark.parametrize("name", ["CLIP_DIM", "CLIP_SIZE", "CLIP_MEAN", "CLIP_STD",
                                  "CLIP_VIT_CONFIGS", "CLIP_RESNET_CONFIGS", "VQGAN_CONFIGS"])
def test_registry_copy_equals_jax_registry(name):
    assert getattr(registry, name) == getattr(jax_registry, name)


def test_prior_files_and_pairing_equal_jax_registry():
    """The released priors (the JAX registry's `prior_*` MODEL_URLS keys) and
    the mapper -> prior pairing the Predictor defaults to."""
    assert registry.PRIOR_MODELS == jax_registry.PRIOR_MODELS
    assert registry.PRIOR_FILES == tuple(
        name for name in jax_registry.MODEL_URLS if name.startswith("prior_"))
    assert set(registry.PRIOR_MODELS.values()) <= set(registry.PRIOR_FILES)


def test_released_models_equal_jax_model_urls():
    """The serving path's default model list: the JAX registry's mapper files."""
    assert registry.RELEASED_MODELS == tuple(
        name for name in jax_registry.MODEL_URLS if not name.startswith("prior_"))


def test_crowson_cloob_configs_equal_jax():
    """models/cloob.py's copy of the crowsonkb CLOOB configs."""
    from feed_forward_vqgan_clip_tpu.models import cloob as jax_cloob
    from feed_forward_vqgan_clip_tpu_torch.models import cloob

    assert cloob.CROWSON_CONFIGS == jax_cloob.CROWSON_CONFIGS
