"""Toy runs the serving tests of the port share: seeded JPEG folders, a config
cut to them, and a checkpoint of the port whose weights are a numpy-seeded
JAX tree carried over by the weight bridge (no training), so the JAX
package can serve the same weights. Imported by ``test_torch_port_quant.py``
and ``test_torch_port_visualize.py``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from PIL import Image

from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.models import get_model as jax_get_model
from visiondk_tpu.models.convert import _flatten, _unflatten
from visiondk_tpu_torch.config import yaml_dump
from visiondk_tpu_torch.engine.checkpoint import CheckpointManager
from visiondk_tpu_torch.engine.state import create_train_state
from visiondk_tpu_torch.engine.trainer import CenterProcessor, build_tx
from visiondk_tpu_torch.models.convert import load_jax_params

SIZE = 32


def random_tree(variables, seed):
    """Every JAX tensor re-drawn from a numpy seed: kernels at lecun scale,
    norm scales near 1, running variances positive, the rest small."""
    rng = np.random.default_rng(seed)
    tree = {}
    for t in ("params", "batch_stats"):
        flat = {p: np.zeros(v.shape, np.float32) for p, v in _flatten(dict(variables.get(t, {}))).items()}
        for p, v in flat.items():
            if p.endswith("/kernel"):
                flat[p] = (rng.normal(size=v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
            elif p.endswith("/var"):
                flat[p] = (0.5 + rng.random(v.shape)).astype(np.float32)
            elif p.endswith("/scale"):
                flat[p] = (1.0 + 0.1 * rng.normal(size=v.shape)).astype(np.float32)
            else:
                flat[p] = (0.3 * rng.normal(size=v.shape)).astype(np.float32)
        tree[t] = flat
    return tree


def jax_vars(tree):
    return {t: jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)) for t, flat in tree.items() if flat}


def jax_init(model_cfg, img, embedding=False):
    """The JAX model of ``model_cfg`` and the shapes of its variables
    (``jax.eval_shape``: nothing is compiled; ``random_tree`` draws them)."""
    jmodel = jax_get_model(model_cfg)
    x = jnp.zeros((1, img, img, 3))
    labels = (jnp.zeros((1,), jnp.int32),) if embedding else ()
    return jmodel, jax.eval_shape(lambda x: jmodel.init(jax.random.key(0), x, *labels, train=False), x)


def _image(rng, ident):
    h, w = (int(x) for x in rng.integers(30, 64, size=2))
    base = np.array([(67 * ident) % 256, (91 * ident + 40) % 256, 255 - 50 * ident])
    return Image.fromarray(np.clip(rng.normal(base, 40, size=(h, w, 3)), 0, 255).astype(np.uint8))


def write_images(d: Path, rng, ident, n):
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        _image(rng, ident).save(d / f"{ident}_{i}.jpg", quality=90)


def _resized(augment):
    for item in augment:
        for params in item.values():
            if isinstance(params, dict):
                if "size" in params:
                    params["size"] = SIZE
                _resized(params.get("transforms", []))
    return augment


def checkpoint(cfg, project: Path, tree) -> Path:
    """``project/best`` and ``project/config.yaml``: the port's state of
    ``cfg`` with ``tree`` in its model and its EMA model."""
    project.mkdir(parents=True, exist_ok=True)
    yaml_dump(cfg, project / "config.yaml")
    cp = CenterProcessor(cfg, project=str(project), train=False, device="cpu")
    state = create_train_state(cp.model, build_tx(cfg["hyp"], 1, True, model_cfg=cfg["model"]))
    load_jax_params(state.model, tree)
    load_jax_params(state.ema_model, tree)
    mgr = CheckpointManager(project, writer=True)
    mgr.save("best", state, epoch=0, best_fitness=0.0)
    mgr.wait()
    return project / "best"


def classification_toy(base: Path, name: str, classes: int, seed: int = 0):
    """(cfg, data root, JAX model, tree, checkpoint dir) of ``name`` on seeded
    class folders (``val/class_<c>/``: 3 images a class; train: 2)."""
    rng = np.random.default_rng(seed)
    root = base / "data"
    for c in range(classes):
        write_images(root / "train" / f"class_{c}", rng, c, 2)
        write_images(root / "val" / f"class_{c}", rng, c, 3)
    cfg = jax_yaml_load("configs/classification/pet_synth.yaml")
    cfg["model"].update(name=name, image_size=SIZE, num_classes=classes)
    cfg["data"].update(root=str(root), nw=2)
    cfg["data"]["train"].update(bs=4, device_augment=False)
    cfg["data"]["val"]["bs"] = 4
    _resized(cfg["data"]["train"]["augment"])
    _resized(cfg["data"]["val"]["augment"])
    jmodel, variables = jax_init(cfg["model"], SIZE)
    tree = random_tree(variables, seed)
    return cfg, root, jmodel, tree, checkpoint(cfg, base / "run", tree)


def cbir_toy(base: Path, name: str, ids: int = 3, seed: int = 0):
    """(cfg, data root, JAX model, tree, checkpoint dir) of a CBIR model on
    ``name`` with a 16-d neck over seeded identity folders (``query/<id>/``:
    2 an id, ``gallery/<id>/``: 3, ``train/<id>/``: 2)."""
    rng = np.random.default_rng(seed)
    root = base / "data"
    for i in range(ids):
        for split, n in (("train", 2), ("gallery", 3), ("query", 2)):
            write_images(root / split / f"id{i}", rng, i, n)
    cfg = jax_yaml_load("configs/faceX/cbir_synth.yaml")
    cfg["model"]["image_size"] = SIZE
    cfg["model"]["backbone"] = {name: {"pretrained": False, "image_size": SIZE, "feat_dim": 16}}
    cfg["model"]["head"]["arcface"].update(feat_dim=16, num_class=ids)
    cfg["data"].update(root=str(root), nw=2)
    cfg["data"]["train"]["bs"] = 4
    cfg["data"]["val"]["bs"] = 4
    _resized(cfg["data"]["train"]["augment"])
    _resized(cfg["data"]["val"]["augment"])
    jmodel, variables = jax_init(cfg["model"], SIZE, embedding=True)
    tree = random_tree(variables, seed)
    return cfg, root, jmodel, tree, checkpoint(cfg, base / "run", tree)
