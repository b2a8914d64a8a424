"""The port's export and the tools around it against the JAX package, on the
toy checkpoints of ``torch_port_serving_toys.py`` (a tiny ViT classifier and
a tiny Swin CBIR model whose weights are a numpy-seeded JAX tree):

- ``python -m visiondk_tpu_torch.export --batch -1`` on each checkpoint (bf16,
  as the serving CLIs compute) and ``export.export_program`` on the same
  weights in f32, f32 and ``quant="int8"``: every program equals the port's
  step on the same uint8 batch bit for bit at batch 1 and 3, and agrees with a
  ``jax.export`` program of the JAX eval (embed) step on the same tree: f32 at
  the model bars (rtol 1e-3, atol 3e-4); the bf16 CLI program at per-row
  cosine ≥ 0.9999 to the f32 JAX program (bf16 rounds where f32 does not);
  int8 at per-row cosine ≥ 0.995 to JAX's ``quant="int8"`` program
  (``tests/test_quant.py``'s bar for two int8 paths: the JAX ViT pads its 17
  tokens to 24, and the pad rows move the per-tensor activation scale, so
  elementwise bars do not apply); embeddings unit-norm;
- the programs hold one ``vdk::`` attention node a block, a symbolic batch,
  and ``_int_mm`` only with int8; a fixed ``--batch`` program refuses another
  batch;
- ``tools.exported_predict`` in a fresh process prints the in-process
  program's top-5 without importing model or engine code;
- ``tools.video_predict``: per sampled frame of a 12-frame mp4, the top-3 of
  the JAX eval step on the same frames after the JAX transforms, within 1e-5;
  the CLI's ``--output`` video holds exactly the sampled frames; without
  OpenCV it raises ``ImportError``.
"""

import os
import random
import re
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import export as jexport
from PIL import Image

import torch_port_serving_toys as toys
from visiondk_tpu.data.transforms import create_aug_transforms as jax_create_aug_transforms
from visiondk_tpu.engine.state import create_train_state as jax_train_state
from visiondk_tpu.engine.steps import StepConfig as JaxStepConfig
from visiondk_tpu.engine.steps import make_embed_step as jax_embed_step
from visiondk_tpu.engine.steps import make_eval_step as jax_eval_step
from visiondk_tpu.models.backbones import BACKBONES as JAX_BACKBONES
from visiondk_tpu.models.backbones.swin import _swin as jax_swin
from visiondk_tpu.models.backbones.vit import _vit as jax_vit
from visiondk_tpu_torch import export
from visiondk_tpu_torch.data.transforms import create_aug_transforms, extract_normalization
from visiondk_tpu_torch.engine.steps import StepConfig, make_embed_step, make_eval_step
from visiondk_tpu_torch.engine.trainer import CenterProcessor
from visiondk_tpu_torch.models import BACKBONES, get_model
from visiondk_tpu_torch.models.backbones.swin import _swin
from visiondk_tpu_torch.models.backbones.vit import _vit
from visiondk_tpu_torch.models.convert import load_jax_params
from visiondk_tpu_torch.ops.quant import build_weight_cache
from visiondk_tpu_torch.tools import exported_predict, video_predict

REPO = Path(__file__).resolve().parent.parent
VIT = "vit_tiny_port_export_test"
SWIN = "swin_tiny_port_export_test"
CLASSES = 7
BLOCKS = {"cls": 2, "cbir": 4}  # the tiny ViT's depth; the tiny Swin's depths (2, 2)
FRAMES = 12
INT8_MIN_COSINE = 0.995  # int8 against JAX's int8 export, per row: tests/test_quant.py's bar for two int8 paths
BF16_MIN_COSINE = 0.9999  # the CLI's bf16 program against the f32 JAX step, per row


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
def toys_built(tmp_path_factory, tiny_models_registered):
    base = tmp_path_factory.mktemp("export")
    return {"cls": toys.classification_toy(base / "cls", VIT, CLASSES),
            "cbir": toys.cbir_toy(base / "cbir", SWIN)}


def _normalization(cfg):
    mean, std = extract_normalization(create_aug_transforms(cfg["data"]["val"]["augment"]))
    return tuple(mean), tuple(std)


@pytest.fixture(scope="module")
def programs(toys_built, tmp_path_factory):
    """(route, kind, quant) → (path or None, program, the port's step on the
    same weights): route "cli" is ``export --batch -1`` on the toy's best
    checkpoint, saved and loaded back (bf16, as the serving CLIs compute);
    route "f32" is ``export_program`` on the bridged model in f32, f32 and
    int8, in memory."""
    out = {}
    folder = tmp_path_factory.mktemp("programs")
    for kind, (cfg, _, _, tree, best) in toys_built.items():
        embed = kind == "cbir"
        make = make_embed_step if embed else make_eval_step
        cp = CenterProcessor(cfg, project=str(best.parent), train=False, device="cpu")
        path = folder / f"{kind}.pt2"
        program = export.main(export.parse_opt(["--cfgs", str(best.parent / "config.yaml"), "--weight", str(best),
                                                "--out", str(path), "--batch", "-1", "--device", "cpu"]))
        if kind == "cls":  # the saved program, loaded back (and in a fresh process by the exported_predict test)
            program = torch.export.load(path)
        out["cli", kind, None] = (path, program, make(load_jax_params(cp.model, tree).eval(), cp.step_config()))
        model = load_jax_params(get_model(cfg["model"], device="cpu"), tree).eval()
        for quant in (None, "int8"):
            step = make(model, cp.step_config(), quant=quant, quant_cache=build_weight_cache(model) if quant else None)
            out["f32", kind, quant] = (None, export.export_program(model, cp.step_config(), embed, toys.SIZE,
                                                                   quant=quant), step)
    return out


def _jax_program(jmodel, tree, mean, std, embed, quant):
    """The JAX step on ``tree`` through ``jax.export`` with a symbolic batch,
    serialised and loaded back (``tests/test_tools.py``'s route)."""
    state = jax_train_state(toys.jax_vars(tree), optax.sgd(0.0))
    make = jax_embed_step if embed else jax_eval_step
    step = make(jmodel, JaxStepConfig(mean=mean, std=std), use_ema=False, quant=quant)
    b = jexport.symbolic_shape("b")[0]
    spec = jax.ShapeDtypeStruct((b, toys.SIZE, toys.SIZE, 3), jnp.uint8)
    exported = jexport.export(jax.jit(lambda images: step(state, {"image": images})))(spec)
    return jexport.deserialize(bytearray(exported.serialize()))


def _batch(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, toys.SIZE, toys.SIZE, 3)).astype(np.uint8)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / np.maximum(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
@pytest.mark.parametrize("kind", ["cls", "cbir"])
def test_exported_program_matches_the_jax_export(toys_built, programs, kind, quant):
    cfg, _, jmodel, tree, _ = toys_built[kind]
    embed = kind == "cbir"
    mean, std = _normalization(cfg)
    jax_program = _jax_program(jmodel, tree, mean, std, embed, quant)
    for n in (1, 3):
        x = _batch(n, seed=n)
        want = np.asarray(jax_program.call(x))
        for route in ("f32", "cli") if quant is None else ("f32",):
            _, program, step = programs[route, kind, quant]
            with torch.no_grad():
                got = program.module()(torch.from_numpy(x)).numpy()
            assert got.shape == want.shape == (n, 16 if embed else CLASSES)
            # the program is the port's step, traced: bit for bit on the CPU
            np.testing.assert_array_equal(got, step({"image": torch.from_numpy(x)}).numpy())
            if embed:
                np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
            if route == "cli":  # bf16: rounded at other points than the f32 JAX step
                assert _cos(got, want).min() >= BF16_MIN_COSINE, _cos(got, want)
            elif quant is None:
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=3e-4)
            else:
                assert _cos(got, want).min() >= INT8_MIN_COSINE, _cos(got, want)


@pytest.mark.parametrize("kind", ["cls", "cbir"])
def test_the_program_holds_one_attention_node_a_block(programs, kind):
    for key in (("cli", kind, None), ("f32", kind, "int8")):
        _, program, _ = programs[key]
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        op = "vdk.fused_window_attention" if kind == "cbir" else "vdk.fused_qkv_attention"
        assert sum(t.startswith(op) for t in targets) == BLOCKS[kind]
        assert not any(t.startswith("vdk.") and not t.startswith(op) for t in targets)
        (shape,) = [n.meta["val"].shape for n in program.graph.nodes
                    if n.op == "placeholder" and n.name in program.graph_signature.user_inputs]
        assert isinstance(shape[0], torch.SymInt) and tuple(shape[1:]) == (toys.SIZE, toys.SIZE, 3)
        assert ("aten._int_mm.default" in targets) == (key[2] == "int8")  # the int8 codes are in the program


def test_export_int8_at_a_fixed_batch_and_its_line(toys_built, programs, tmp_path, capsys):
    _, _, _, _, best = toys_built["cls"]
    out = tmp_path / "m.pt2"
    export.main(export.parse_opt(["--cfgs", str(best.parent / "config.yaml"), "--weight", str(best), "--out", str(out),
                                  "--batch", "2", "--quant", "int8", "--device", "cpu"]))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(rf"exported logits fn to {re.escape(str(out))} \([0-9.]+ MB\), "
                        rf"input uint8 \(2, {toys.SIZE}, {toys.SIZE}, 3\)", line), line
    program = torch.export.load(out)
    x = torch.from_numpy(_batch(2, seed=5))
    _, _, bf16_step = programs["cli", "cls", None]
    with torch.no_grad():
        got = program.module()(x).numpy()
    assert _cos(got, bf16_step({"image": x}).numpy()).min() >= INT8_MIN_COSINE
    with pytest.raises(Exception, match=r"size\(\)\[0\] == 2"):  # the batch is fixed
        program.module()(torch.zeros((3, toys.SIZE, toys.SIZE, 3), dtype=torch.uint8))


def test_exported_predict_in_a_fresh_process_prints_the_programs_top5(toys_built, programs, capsys):
    _, root, _, _, _ = toys_built["cls"]
    img = sorted((root / "val" / "class_3").glob("*.jpg"))[0]
    path = programs["cli", "cls", None][0]
    top = exported_predict.main(exported_predict.parse_opt(["--artifact", str(path), "--img", str(img),
                                                            "--device", "cpu"]))
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [f"class {j}: {p:.4f}" for j, p in top] and len(top) == 5
    code = ("import runpy, sys\n"
            f"sys.argv = ['exported_predict', '--artifact', {str(path)!r}, '--img', {str(img)!r}, '--device', 'cpu']\n"
            "runpy.run_module('visiondk_tpu_torch.tools.exported_predict', run_name='__main__')\n"
            "print('model modules:', sorted(m for m in sys.modules if m.startswith(('visiondk_tpu_torch.models', "
            "'visiondk_tpu_torch.engine', 'visiondk_tpu.'))))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    lines = run.stdout.strip().splitlines()
    assert lines[:-1] == printed
    assert lines[-1] == "model modules: []"


# ---------------------------------------------------------------- video_predict


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """A 12-frame mp4 of noisy colour frames (48 × 40), written with OpenCV."""
    path = tmp_path_factory.mktemp("video") / "clip.mp4"
    rng = np.random.default_rng(4)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (48, 40))
    for i in range(FRAMES):
        base = np.array([(40 * i) % 256, 255 - 20 * i, 90], np.float64)
        writer.write(np.clip(rng.normal(base, 30, (40, 48, 3)), 0, 255).astype(np.uint8))
    writer.release()
    return path


def _kept(seed, sample, n=FRAMES):
    """The frames the JAX tool keeps: one draw a frame, kept unless it exceeds ``sample``."""
    rng = random.Random(seed)
    return [i for i in range(n) if not rng.random() > sample]


def test_video_frames_top3_match_the_jax_eval_step(toys_built, video):
    cfg, _, jmodel, tree, _ = toys_built["cls"]
    model = load_jax_params(get_model(cfg["model"], device="cpu"), tree).eval()
    mean, std = _normalization(cfg)
    names = [f"class_{c}" for c in range(CLASSES)]
    cap = cv2.VideoCapture(str(video))
    frames = [cv2.cvtColor(f, cv2.COLOR_BGR2RGB) for f in video_predict.sampled_frames(cap, 0.5, 0)]
    cap.release()
    assert len(frames) == len(_kept(0, 0.5)) > 0
    tops = video_predict.frame_top3(frames, make_eval_step(model, StepConfig(mean=mean, std=std)),
                                    create_aug_transforms(cfg["data"]["val"]["augment"]), names)
    jstep = jax_eval_step(jmodel, JaxStepConfig(mean=mean, std=std), use_ema=False)
    jstate = jax_train_state(toys.jax_vars(tree), optax.sgd(0.0))
    jtransforms = jax_create_aug_transforms(cfg["data"]["val"]["augment"])
    for frame, top in zip(frames, tops):
        x = np.asarray(jtransforms(Image.fromarray(frame)))[None]
        logits = np.asarray(jstep(jstate, {"image": jnp.asarray(x)}))[0].astype(np.float64)
        probs = np.exp(logits - logits.max())
        probs /= probs.sum()
        want = np.argsort(-probs)[:3]
        assert [name for name, _ in top] == [names[j] for j in want]
        np.testing.assert_allclose([p for _, p in top], probs[want], rtol=0, atol=1e-5)


def test_video_predict_cli_writes_the_sampled_frames(toys_built, video, tmp_path):
    _, _, _, _, best = toys_built["cls"]
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(video.read_bytes())
    argv = ["--video", str(clip), "--cfgs", str(best.parent / "config.yaml"), "--weight", str(best), "--output",
            "--sample", "0.6", "--seed", "3", "--device", "cpu"]
    tops = video_predict.main(video_predict.parse_opt(argv))
    cap = cv2.VideoCapture(str(tmp_path / "clip_new.mp4"))
    written = 0
    while cap.read()[0]:
        written += 1
    cap.release()
    assert written == len(tops) == len(_kept(3, 0.6)) > 0
    assert all(len(top) == 3 for top in tops)


def test_video_predict_without_opencv_raises(toys_built, video, monkeypatch):
    _, _, _, _, best = toys_built["cls"]
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV"):
        video_predict.main(video_predict.parse_opt(["--video", str(video), "--cfgs", str(best.parent / "config.yaml"),
                                                    "--weight", str(best), "--output", "--device", "cpu"]))
