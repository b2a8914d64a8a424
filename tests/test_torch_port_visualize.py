"""The port's predict surfaces against the JAX package: ``engine/visualizer.py``,
``visualize.py``, ``tools/single_predict.py`` and ``tools/test_augment.py``.

A tiny ViT classifier over 7 classes and a tiny Swin CBIR model (16-d neck)
take numpy-seeded JAX weights through the bridge into port checkpoints (no
training; ``torch_port_serving_toys.py``). ``predict_images`` writes the same
label files and badcase folders as the JAX ``Visualizer`` from the same
weights and images (both in f32); ``visualize_results`` draws the same grid;
the CLIs run on the CPU (``--device cpu``) for classification with
``--cam`` and for CBIR; ``single_predict`` prints the JAX eval step's top-5
classes (the CLI serves in bf16: probabilities within 0.02); ``test_augment``
writes an H×W grid, the same for the same seed.
"""

import runpy
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import torch_port_serving_toys as toys
from visiondk_tpu.data.datasets import PredictImageDatasets as JaxPredictImageDatasets
from visiondk_tpu.data.transforms import create_aug_transforms as jax_create_aug_transforms
from visiondk_tpu.engine.state import create_train_state as jax_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_eval_step as jax_eval_step
from visiondk_tpu.engine.visualizer import Visualizer as JaxVisualizer
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu_torch.data.datasets import PredictImageDatasets
from visiondk_tpu_torch.data.transforms import create_aug_transforms, extract_normalization
from visiondk_tpu_torch.engine.steps import StepConfig, make_eval_step
from visiondk_tpu_torch.engine.visualizer import Visualizer
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params

VIT = "vit_tiny_port_visualize_test"
SWIN = "swin_tiny_port_visualize_test"
CLASSES = 7
TARGET = "class_2"


@pytest.fixture(scope="module", autouse=True)
def tiny_models_registered():
    JAX_BACKBONES.register(jax_vit(8, 64, 2, 4), name=VIT)
    BACKBONES.register(_vit(8, 64, 2, 4), name=VIT)
    JAX_BACKBONES.register(jax_swin(16, (2, 2), (2, 4), window_size=4), name=SWIN)
    BACKBONES.register(_swin(16, (2, 2), (2, 4), window_size=4), name=SWIN)
    yield
    for name in (VIT, SWIN):
        del JAX_BACKBONES._store[name]
        del BACKBONES._store[name]


@pytest.fixture(scope="module")
def cls_toy(tmp_path_factory, tiny_models_registered):
    return toys.classification_toy(tmp_path_factory.mktemp("vis_cls"), VIT, CLASSES)


@pytest.fixture(scope="module")
def cbir_toy(tmp_path_factory, tiny_models_registered):
    return toys.cbir_toy(tmp_path_factory.mktemp("vis_cbir"), SWIN)


class _Logger:
    def __init__(self):
        self.lines = []

    def console(self, msg):
        self.lines.append(msg)


def _cli(module, argv):
    saved = sys.argv
    sys.argv = [module, *argv]
    try:
        return runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved


def _triplets(ds_cls, transforms, root):
    ds = ds_cls(str(root), transforms=None)

    class Triplets:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            img, path = ds[i]
            pil = Image.fromarray(img)
            return pil, np.asarray(transforms(pil)), path

    return Triplets()


def _tree_listing(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_prediction_datasets_match_jax(cls_toy, tmp_path):
    _, root, *_ = cls_toy
    for kwargs in ({}, {"target_class": TARGET}, {"sampling": 5}, {"target_class": TARGET, "sampling": 2}):
        assert PredictImageDatasets(str(root / "val"), **kwargs).images == \
            JaxPredictImageDatasets(str(root / "val"), **kwargs).images
    one = sorted((root / "val" / TARGET).glob("*.jpg"))[0]
    assert PredictImageDatasets(str(one)).images == [str(one)]
    csv = tmp_path / "list.csv"
    csv.write_text("image_path,label\n" + "".join(f"{p},0\n" for p in sorted((root / "val").rglob("*.jpg"))[:4]))
    ds = PredictImageDatasets(str(csv))
    assert ds.images == JaxPredictImageDatasets(str(csv)).images and len(ds) == 4
    img, path = ds[0]
    assert img.dtype == np.uint8 and img.ndim == 3 and path == ds.images[0]


def test_predict_images_writes_the_jax_labels_and_badcases(cls_toy, tmp_path):
    cfg, root, jmodel, tree, _ = cls_toy
    port = load_jax_params(get_model(cfg["model"], device="cpu"), tree)
    port_step = make_eval_step(port, StepConfig())
    jstate = jax_train_state(toys.jax_vars(tree), optax.sgd(0.0))
    jstep = jax_eval_step(jmodel, JaxStepConfig(), use_ema=False)
    names = {i: f"class_{i}" for i in range(CLASSES)}
    val_aug = cfg["data"]["val"]["augment"]
    for tag, fwd, visualizer, ds_cls, make_aug in (
        ("port", lambda x: port_step({"image": torch.from_numpy(x.copy())}).numpy(), Visualizer, PredictImageDatasets,
         create_aug_transforms),
        ("jax", lambda x: np.asarray(jstep(jstate, {"image": jnp.asarray(x)})), JaxVisualizer,
         JaxPredictImageDatasets, jax_create_aug_transforms),
    ):
        visualizer.predict_images(fwd, _triplets(ds_cls, make_aug(val_aug), root / "val"), tmp_path / tag, names,
                                  _Logger(), badcase=True, target_class=TARGET)
    port_files, jax_files = _tree_listing(tmp_path / "port"), _tree_listing(tmp_path / "jax")
    assert port_files == jax_files
    assert any(f.startswith("bad_case/") for f in port_files) and any(f.startswith("labels/") for f in port_files)
    for f in port_files:
        if f.endswith(".txt"):
            assert (tmp_path / "port" / f).read_text() == (tmp_path / "jax" / f).read_text(), f


def test_visualize_results_draws_the_jax_grid(cbir_toy, tmp_path):
    """The JAX figure's file name, size and layout (drawn with PIL, not
    matplotlib): the red outlines on the true positives' cells only."""
    _, root, *_ = cbir_toy
    gallery = sorted(str(p) for p in (root / "gallery").rglob("*.jpg"))
    query = sorted(str(p) for p in (root / "query").rglob("*.jpg"))[0]
    results, truths = gallery[:4], [gallery[0], gallery[2], gallery[5]]
    args = (query, results, [0.9, 0.8, 0.7, 0.6], truths)
    port = Visualizer.visualize_results(*args, tmp_path / "port", max_rank=4)
    want = JaxVisualizer.visualize_results(*args, tmp_path / "jax", max_rank=4)
    assert port.name == want.name
    a = np.asarray(Image.open(port).convert("RGB")).astype(np.int16)
    assert a.shape == np.asarray(Image.open(want).convert("RGB")).shape == (1200, 1500, 3)
    red = (a[..., 0] > 200) & (a[..., 1] < 60) & (a[..., 2] < 60)
    bottom = [red[600:, 300 * c:300 * (c + 1)].sum() for c in range(1, 5)]  # results 1-4
    assert bottom[0] > 100 and bottom[2] > 100 and bottom[1] < 20 and bottom[3] < 20, bottom
    assert red[:600].sum() < 20 and red[600:, :300].sum() < 20  # no outline on the ground truths or the query


def test_visualize_cli_classification_with_cam(cls_toy, tmp_path):
    _, root, _, _, best = cls_toy
    argv = ["--cfgs", str(best.parent / "config.yaml"), "--weight", str(best), "--data", str(root / "val"),
            "--cam", "--cam_method", "gradcam", "--sampling", "4", "--show_path", str(tmp_path), "--device", "cpu"]
    _cli("visiondk_tpu_torch.visualize", argv)
    images = sorted((tmp_path / "exp").glob("*.jpg"))
    assert len(images) == 4
    raw = Image.open(PredictImageDatasets(str(root / "val"), sampling=4).images[0])
    assert Image.open(images[0]).size == (2 * raw.size[0], raw.size[1])  # the image and its CAM overlay
    _cli("visiondk_tpu_torch.visualize", argv + ["--badcase", "--target_class", TARGET, "--no_save_image",
                                                 "--name", "bad"])
    labels = sorted((tmp_path / "bad" / "labels").glob("*.txt"))
    assert len(labels) == 3 and all(len(p.read_text().splitlines()) == 5 for p in labels)  # TARGET's 3 images


def test_visualize_cli_cbir_writes_a_grid_a_query(cbir_toy, tmp_path, capsys):
    _, root, _, _, best = cbir_toy
    _cli("visiondk_tpu_torch.visualize", ["--cfgs", str(best.parent / "config.yaml"), "--weight", str(best),
                                          "--max_rank", "3", "--show_path", str(tmp_path), "--device", "cpu"])
    grids = sorted((tmp_path / "exp").glob("*.jpg"))
    queries = sorted((root / "query").rglob("*.jpg"))
    assert [g.name for g in grids] == sorted(f"{q.parent.name}_{q.name}" for q in queries)
    assert "retrieval grids saved to" in capsys.readouterr().out


@pytest.mark.parametrize("quant", [[], ["--quant", "int8"]])
def test_single_predict_prints_the_jax_top5(cls_toy, quant, capsys):
    cfg, root, jmodel, tree, best = cls_toy
    img = sorted((root / "val" / TARGET).glob("*.jpg"))[0]
    _cli("visiondk_tpu_torch.tools.single_predict", ["--img", str(img), "--cfgs", str(best.parent / "config.yaml"),
                                                     "--weight", str(best), "--device", "cpu", *quant])
    lines = [ln.split() for ln in capsys.readouterr().out.strip().splitlines()[-5:]]
    got = {name: float(p) for name, p in lines}
    x = np.asarray(jax_create_aug_transforms(cfg["data"]["val"]["augment"])(Image.open(img).convert("RGB")))[None]
    jstate = jax_train_state(toys.jax_vars(tree), optax.sgd(0.0))
    mean, std = extract_normalization(create_aug_transforms(cfg["data"]["val"]["augment"]))
    logits = np.asarray(jax_eval_step(jmodel, JaxStepConfig(mean=tuple(mean), std=tuple(std)), use_ema=False)(
        jstate, {"image": jnp.asarray(x)}))[0].astype(np.float64)
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    want = [f"class_{j}" for j in np.argsort(-probs)[:5]]
    assert len(got) == 5
    for name, p in got.items():
        assert abs(p - probs[int(name.split("_")[1])]) <= 0.02, (name, p)
    clear = [i for i in range(5) if all(abs(probs[j] - probs[int(want[i][6:])]) > 0.04 for j in range(CLASSES)
                                        if f"class_{j}" != want[i])]
    for i in clear:  # where no other class is within twice the bar, the rank is JAX's
        assert [n for n, _ in lines][i] == want[i]


def test_augment_writes_an_h_by_w_grid(tmp_path):
    from visiondk_tpu_torch.tools import test_augment

    src = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 80, 3), dtype=np.uint8)).save(src)
    grids = []
    for i, seed in enumerate((3, 3, 4)):
        opt = test_augment.parse_opt(["-m", str(src), "-o", str(tmp_path / f"g{i}.png"), "-H", "2", "-W", "3",
                                      "--seed", str(seed)])
        grids.append(test_augment.main(opt))
        assert np.asarray(Image.open(tmp_path / f"g{i}.png")).shape == (2 * 224, 3 * 224, 3)
    np.testing.assert_array_equal(grids[0], grids[1])
    assert not np.array_equal(grids[0], grids[2])
