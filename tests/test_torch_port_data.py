"""visiondk_tpu_torch's host data pipeline against the JAX package's.

The port keeps its own copies of the JAX package's numpy/PIL data modules
(``config/``, ``data/``); these tests hold the copies to the originals on
seeded images written by PIL into ``tmp_path``. Every comparison is exact:
the same ops on the same bytes under the same per-sample seeding
(``seed_sample(seed, epoch, index)``) must give the same uint8 output, so
the port trains on byte-identical batches. Also here: the device-augment
split of the train pipeline against the JAX processor's, and the CPU
behaviour of the port's ``DevicePrefetcher`` (mirroring
``tests/test_device_prefetch.py``).
"""

import copy
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import visiondk_tpu.data.native as jax_native
import visiondk_tpu_torch.data.native as port_native
from visiondk_tpu.config.loader import yaml_load as jax_yaml_load
from visiondk_tpu.data import transforms as JT
from visiondk_tpu.data.dataprocessor import SmartDataProcessor as JaxSmartDataProcessor
from visiondk_tpu.data.datasets import ImageDatasets as JaxImageDatasets
from visiondk_tpu.data.datasets import smooth_labels as jax_smooth_labels
from visiondk_tpu.data.datasets import tell_data_distribution as jax_tell_data_distribution
from visiondk_tpu_torch.config import get_imgsz, increment_path, yaml_dump, yaml_load
from visiondk_tpu_torch.data import transforms as PT
from visiondk_tpu_torch.data.dataprocessor import SmartDataProcessor
from visiondk_tpu_torch.data.datasets import ImageDatasets, smooth_labels, tell_data_distribution
from visiondk_tpu_torch.data.loader import DevicePrefetcher, loader_kind

PET_SYNTH = "configs/classification/pet_synth.yaml"
PET = "configs/classification/pet.yaml"
SIZE = 32


def _resized(augment, size=SIZE):
    """A copy of an augment block with every spatial size set to ``size``."""
    augment = copy.deepcopy(augment)

    def walk(items):
        for item in items:
            for params in item.values() if isinstance(item, dict) else ():
                if isinstance(params, dict):
                    if "size" in params:
                        params["size"] = size
                    walk(params.get("transforms", []))

    walk(augment)
    return augment


def _data_cfg(root, path=PET_SYNTH, bs=8, device_augment=False):
    data = jax_yaml_load(path)["data"]
    data["root"] = str(root)
    data["nw"] = 2
    data["train"]["bs"] = bs
    data["train"]["augment"] = _resized(data["train"]["augment"])
    data["val"]["augment"] = _resized(data["val"]["augment"])
    data["val"]["bs"] = bs
    if device_augment is not None:
        data["train"]["device_augment"] = device_augment
    return data


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """3 classes, 7 train and 3 val JPEGs each, 24-70 px a side."""
    root = tmp_path_factory.mktemp("toy_data")
    rng = np.random.default_rng(0)
    for split, n in (("train", 7), ("val", 3)):
        for c in range(3):
            d = root / split / f"class_{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = (int(x) for x in rng.integers(24, 70, size=2))
                arr = np.clip(rng.normal(60 * c + 40, 50, size=(h, w, 3)), 0, 255).astype(np.uint8)
                Image.fromarray(arr).save(d / f"{i}.jpg", quality=90)
    return root


@pytest.fixture(scope="module")
def sample_images():
    rng = np.random.default_rng(1)
    out = []
    for h, w in ((40, 56), (64, 33), (29, 29), (90, 50)):
        out.append(Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)))
    return out


def test_aug_method_names_match_jax():
    assert PT.AUG_METHODS.keys() == JT.AUG_METHODS.keys()
    assert PT.SPATIAL_TRANSFORMS == JT.SPATIAL_TRANSFORMS


def _pipeline_ops():
    """(case id, op spec) for every op of pet_synth's and pet.yaml's train and
    val pipelines (the random_choice branches one by one), and the compiled
    pipelines as wholes."""
    cases = {}
    for path in (PET_SYNTH, PET):
        data = jax_yaml_load(path)["data"]
        for split in ("train", "val"):
            augment = _resized(data[split]["augment"])
            cases[f"{split}_pipeline_{path.split('/')[-1]}"] = ("pipeline", augment)
            for item in augment:
                ((name, params),) = item.items()
                if name == "random_choice":
                    cases[f"{name}_{split}_{len(params['transforms'])}"] = ("op", (name, params))
                    for t in params["transforms"]:
                        ((inner, inner_params),) = t.items()
                        cases[f"{inner}_{split}"] = ("op", (inner, inner_params))
                else:
                    cases[f"{name}_{split}"] = ("op", (name, params))
    return cases


PIPELINE_OPS = _pipeline_ops()


@pytest.mark.parametrize("case", sorted(PIPELINE_OPS))
def test_every_pipeline_op_is_byte_identical_to_jax(case, sample_images):
    kind, spec = PIPELINE_OPS[case]
    if kind == "pipeline":
        port_op, jax_op = PT.create_aug_transforms(spec), JT.create_aug_transforms(spec)
    else:
        port_op, jax_op = PT._build_one(*spec), JT._build_one(*spec)
    for i, img in enumerate(sample_images):
        for epoch in range(3):
            PT.seed_sample(0, epoch, i)
            JT.seed_sample(0, epoch, i)
            got, want = np.asarray(port_op(img.copy())), np.asarray(jax_op(img.copy()))
            assert got.dtype == want.dtype and got.shape == want.shape, case
            assert np.array_equal(got, want), (case, i, epoch)


def test_config_loader_matches_jax(tmp_path):
    from visiondk_tpu.config.loader import get_imgsz as jax_get_imgsz
    from visiondk_tpu.config.loader import increment_path as jax_increment_path

    cfg = yaml_load(PET_SYNTH)
    assert cfg == jax_yaml_load(PET_SYNTH)
    yaml_dump(cfg, tmp_path / "copy.yaml")
    assert yaml_load(tmp_path / "copy.yaml") == cfg
    for split in ("train", "val"):
        assert get_imgsz(cfg["data"][split]["augment"]) == jax_get_imgsz(cfg["data"][split]["augment"]) == 224
    (tmp_path / "exp").mkdir()
    (tmp_path / "exp3").mkdir()
    assert increment_path(tmp_path / "exp") == jax_increment_path(tmp_path / "exp") == tmp_path / "exp4"


def test_datasets_match_jax(image_root, tmp_path):
    for mode in ("train", "val"):
        port = ImageDatasets(image_root, mode, project=str(tmp_path / "p"))
        ref = JaxImageDatasets(image_root, mode, project=str(tmp_path / "j"))
        assert port.class_names == ref.class_names and port.images == ref.images and port.labels == ref.labels
        img, label = port[3]
        want_img, want_label = ref[3]
        assert np.array_equal(img, want_img) and label == want_label
    assert (tmp_path / "p" / "class_indices.json").read_text() == (tmp_path / "j" / "class_indices.json").read_text()
    datasets = {"train": ImageDatasets(image_root, "train"), "val": ImageDatasets(image_root, "val")}
    jax_datasets = {"train": JaxImageDatasets(image_root, "train"), "val": JaxImageDatasets(image_root, "val")}
    assert tell_data_distribution(datasets) == jax_tell_data_distribution(jax_datasets)


def test_csv_dataset_matches_jax(image_root, tmp_path):
    pd = pytest.importorskip("pandas")
    paths = sorted(str(p) for p in (image_root / "train").rglob("*.jpg"))
    rng = np.random.default_rng(2)
    table = {"image_path": paths, "train": [i % 4 != 0 for i in range(len(paths))]}
    for c in ("cat", "dog", "hat"):
        table[c] = rng.integers(0, 2, size=len(paths))
    csv = tmp_path / "labels.csv"
    pd.DataFrame(table).to_csv(csv, index=False)
    for mode in ("train", "val"):
        port, ref = ImageDatasets(str(csv), mode), JaxImageDatasets(str(csv), mode)
        assert port.multi_label and port.class_names == ref.class_names == ["cat", "dog", "hat"]
        assert port.images == ref.images
        assert all(np.array_equal(a, b) for a, b in zip(port.labels, ref.labels))
        assert port.tell_data_distribution() == ref.tell_data_distribution()


@pytest.mark.parametrize("label", [2, [1, 0, 1, 0], np.array([0, 1, 1, 0])])
@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_smooth_labels_match_jax(label, ls):
    got, want = smooth_labels(label, 4, ls), jax_smooth_labels(label, 4, ls)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _both_processors(image_root, tmp_path, data_cfg):
    port = SmartDataProcessor(copy.deepcopy(data_cfg), project=str(tmp_path / "port"))
    ref = JaxSmartDataProcessor(copy.deepcopy(data_cfg), project=str(tmp_path / "jax"))
    return port, ref


def _assert_same_batches(port_loader, jax_loader, epochs):
    n = 0
    for epoch in epochs:
        port_loader.set_epoch(epoch)
        jax_loader.set_epoch(epoch)
        got, want = list(port_loader), list(jax_loader)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (epoch, k)
            n += 1
    return n


def test_train_batches_are_byte_identical_to_jax(image_root, tmp_path):
    data_cfg = _data_cfg(image_root)
    port, ref = _both_processors(image_root, tmp_path, data_cfg)
    port_loader, jax_loader = port.dataloader("train", 8, seed=3), ref.dataloader("train", 8, seed=3)
    assert loader_kind(port_loader) == "PIL"  # the full train pipeline is not the native pool's
    assert _assert_same_batches(port_loader, jax_loader, epochs=(0, 1)) == 2 * (21 // 8)
    # the warm-up swap to the val augments, then back
    for dp in (port, ref):
        dp.set_augment("train", None)
    _assert_same_batches(port_loader, jax_loader, epochs=(0,))
    for dp in (port, ref):
        dp.restore_train_augment()
    _assert_same_batches(port_loader, jax_loader, epochs=(1,))


@pytest.mark.parametrize("decode", ["pil", "native"])
def test_val_batches_are_byte_identical_to_jax(image_root, tmp_path, monkeypatch, decode):
    if decode == "native":
        answer = jax_native.native_available() and port_native.native_available()
        if not answer:
            pytest.skip(f"the native decode library did not build or load here: {port_native.native_error()}")
    else:
        answer = False
    monkeypatch.setattr(jax_native, "native_available", lambda: answer)
    monkeypatch.setattr(port_native, "native_available", lambda: answer)
    port, ref = _both_processors(image_root, tmp_path, _data_cfg(image_root))
    port_loader, jax_loader = port.dataloader("val", 4), ref.dataloader("val", 4)
    assert loader_kind(port_loader) == ("native" if answer else "PIL")
    assert _assert_same_batches(port_loader, jax_loader, epochs=(0,)) == 3


def test_processor_splits_the_train_pipeline_like_jax(image_root, tmp_path):
    """pet_synth as written (``device_augment: "auto"``): the same host and
    device configs as the JAX processor, and byte-identical host batches of
    the split pipeline; ``device_augment: false``, a class_aug, or a serving
    processor keep the whole pipeline on the host."""
    data_cfg = _data_cfg(image_root, device_augment=None)
    port, ref = _both_processors(image_root, tmp_path, data_cfg)
    assert [next(iter(i)) for i in port.device_augment_cfg] == ["random_choice", "random_horizonflip"]
    assert port.device_augment_cfg == ref.device_augment_cfg
    assert port.train_pipeline_cfg == ref.train_pipeline_cfg != data_cfg["train"]["augment"]
    assert _assert_same_batches(port.dataloader("train", 8), ref.dataloader("train", 8), epochs=(1,)) > 0
    assert port.set_train_size(24) is ref.set_train_size(24) is False  # no lifted random_crop
    whole = data_cfg["train"]["augment"]
    for variant in ({"device_augment": False}, {"device_augment": "off"}, {"class_aug": {0: [0]}}):
        cfg = {**data_cfg, "train": {**data_cfg["train"], **variant}}
        dp = SmartDataProcessor(copy.deepcopy(cfg), project=str(tmp_path / "v"))
        assert dp.device_augment_cfg == [] and dp.train_pipeline_cfg == whole, variant
    serving = SmartDataProcessor(copy.deepcopy(data_cfg), project=str(tmp_path / "s"), training=False)
    assert serving.device_augment_cfg == []


def test_loader_surfaces_a_sample_exception(image_root, tmp_path):
    """A sample that fails in a worker raises in the consumer (the JAX
    loader's producer thread dies on it and leaves the consumer waiting)."""
    port = SmartDataProcessor(_data_cfg(image_root), project=str(tmp_path))
    loader = port.dataloader("train", 8)

    def broken(img, label=None):
        raise OSError("corrupt sample")

    port.train_dataset.transforms = broken
    errors = []

    def consume():
        try:
            list(loader)
        except OSError as e:
            errors.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and len(errors) == 1 and "corrupt sample" in str(errors[0])


# ---------------------------------------------------------------- DevicePrefetcher on the CPU


def _host_batches(n):
    return [{"image": np.full((2, 3), i, np.uint8), "label": np.asarray([i, -i], np.int32)} for i in range(n)]


def test_prefetcher_keeps_order_and_values():
    out = list(DevicePrefetcher(_host_batches(10), "cpu", depth=3))
    assert len(out) == 10
    for i, b in enumerate(out):
        assert torch.equal(b["image"], torch.full((2, 3), i, dtype=torch.uint8))
        assert b["label"].tolist() == [i, -i] and b["label"].dtype == torch.int32


def test_prefetcher_lookahead_is_bounded():
    depth = 2
    pulled = []

    def loader():
        for i, b in enumerate(_host_batches(20)):
            pulled.append(i)
            yield b

    it = iter(DevicePrefetcher(loader(), "cpu", depth=depth))
    assert int(next(it)["image"][0, 0]) == 0
    time.sleep(0.3)
    # one consumed, ``depth`` staged, one more pulled and parked on a slot
    assert len(pulled) <= 1 + depth + 1
    assert [int(b["image"][0, 0]) for b in it] == list(range(1, 20))


def test_prefetcher_surfaces_a_loader_exception():
    def loader():
        yield _host_batches(1)[0]
        raise ValueError("loader died")

    with pytest.raises(ValueError, match="loader died"):
        list(DevicePrefetcher(loader(), "cpu", depth=2))


def test_prefetcher_consumer_early_exit_joins_the_feeder():
    n_before = threading.active_count()
    it = iter(DevicePrefetcher(_host_batches(100), "cpu", depth=1))
    next(it)
    it.close()
    deadline = time.time() + 5
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= n_before
