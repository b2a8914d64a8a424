"""visiondk_tpu_torch.ops.device_augment against the JAX package's.

Inputs are seeded numpy uint8 batches, 32×32 (and 48×40 where the
geometry is not square), each op given per-sample parameters. Primitives
are held to the JAX primitives (``visiondk_tpu/ops/device_augment.py``,
sample-level) applied sample by sample. A compiled op's ``apply`` is held
to the JAX primitives run on the same draws (the port's ``draw`` output, read
by the reference interpreter below), with every branch of
``random_choice``, AugMix and RandAugment forced in turn.

Tolerances: integer and LUT ops (flips, invert, grayscale, posterize,
solarize, autocontrast, equalize, crops, cutout, the noise holes) exactly
(autocontrast against the JAX op under ``jax.jit``, as the JAX stage runs);
blends, hue, blur and the affine family (and AugMix and RandAugment, which
chain them) within 1 LSB, with ≥ 99% of pixels equal: XLA may contract
``a*b+c`` into one rounding where PyTorch rounds twice, so a floor can
land one apart (the JAX package's own contract with PIL).

The split functions are held to the JAX functions on every augment list of
every YAML under ``configs/`` and on the synthetic cases of
``tests/test_device_augment.py``; a stage of deterministic ops to the JAX
``make_device_augment`` end to end at ``group_size`` 1 and 8.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from visiondk_tpu.ops import device_augment as JDA
from visiondk_tpu_torch.ops import device_augment as PDA

REPO = Path(__file__).resolve().parent.parent
SHAPES = [(4, 32, 32), (3, 48, 40)]
# the JAX stage runs under jit, where XLA rounds autocontrast's img·scale −
# lo·scale once (a fused multiply-add), as the port does; eager JAX rounds twice
JAX_AUTOCONTRAST = jax.jit(JDA.autocontrast)


def _batch(n=4, h=32, w=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def _grad(n=3, h=48, w=40):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3) % 256, (yy * 2 + xx) % 256, (yy * 4) % 256], -1).astype(np.uint8)
    return np.stack([img, img[::-1].copy(), 255 - img][:n])


def _port(fn, imgs, *args) -> np.ndarray:
    return fn(torch.from_numpy(np.asarray(imgs, np.float32)), *args).numpy()


def _jax(fn, imgs) -> np.ndarray:
    """``fn(jax_img, i)`` for every sample ``i`` of ``imgs``, stacked."""
    return np.stack([np.asarray(fn(jnp.asarray(imgs[i], jnp.float32), i)) for i in range(len(imgs))])


def assert_exact(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def assert_lsb(got, want, frac=0.99):
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 1, f"largest difference {diff.max()} LSB"
    assert (diff == 0).mean() >= frac, f"only {(diff == 0).mean():.4f} of pixels equal"


# ------------------------------------------------------------------ primitives


BLENDS = {
    "brightness": (PDA.adjust_brightness, JDA.adjust_brightness, [0.3, 0.85, 1.0, 1.4]),
    "contrast": (PDA.adjust_contrast, JDA.adjust_contrast, [0.5, 1.0, 1.3, 0.5]),
    "saturation": (PDA.adjust_saturation, JDA.adjust_saturation, [0.5, 1.0, 1.3, 1.3]),
    "sharpness": (PDA.adjust_sharpness, JDA.adjust_sharpness, [0.5, 1.0, 1.3, 1.9]),
}


@pytest.mark.parametrize("shape", SHAPES, ids=["32x32", "48x40"])
@pytest.mark.parametrize("op", sorted(BLENDS))
def test_blend_ops_match_jax(op, shape):
    port_fn, jax_fn, factors = BLENDS[op]
    imgs = _batch(*shape)
    f = np.asarray(factors[:shape[0]], np.float32)
    assert_lsb(_port(port_fn, imgs, torch.from_numpy(f)), _jax(lambda im, i: jax_fn(im, f[i]), imgs))


LUT_OPS = {
    "autocontrast": (PDA.autocontrast, JAX_AUTOCONTRAST),
    "equalize": (PDA.equalize, JDA.equalize),
    "invert": (PDA.invert, JDA.invert),
    "posterize3": (lambda x: PDA.posterize(x, 3), lambda x: JDA.posterize(x, 3)),
    "solarize128": (lambda x: PDA.solarize(x, 128.0), lambda x: JDA.solarize(x, 128.0)),
    "grayscale": (PDA.grayscale, JDA.grayscale),
}


@pytest.mark.parametrize("shape", SHAPES, ids=["32x32", "48x40"])
@pytest.mark.parametrize("op", sorted(LUT_OPS))
def test_integer_and_lut_ops_match_jax_exactly(op, shape):
    port_fn, jax_fn = LUT_OPS[op]
    imgs = _batch(*shape, seed=1)
    imgs[0, ..., 1] = np.clip(imgs[0, ..., 1], 60, 180)  # a narrowed channel: the LUTs stretch it
    assert_exact(_port(port_fn, imgs), _jax(lambda im, i: jax_fn(im), imgs))


def test_lut_identity_cases_match_jax():
    """A constant channel (hi ≤ lo; one value present), a two-valued one, and
    an 8×8 image whose equalize step (64 − h[last]) // 255 is 0."""
    imgs = np.stack([np.full((8, 8, 3), 77, np.uint8), _batch(1, 8, 8, seed=2)[0],
                     np.where(_batch(1, 8, 8, seed=3)[0] > 127, 200, 10).astype(np.uint8)])
    imgs[0, ..., 2] = 3
    for port_fn, jax_fn in (LUT_OPS["autocontrast"], LUT_OPS["equalize"]):
        got = _port(port_fn, imgs)
        assert_exact(got, _jax(lambda im, i: jax_fn(im), imgs))
    assert_exact(_port(PDA.equalize, imgs[:2]), imgs[:2])
    assert_exact(_port(PDA.autocontrast, imgs[:1]), imgs[:1])


@pytest.mark.parametrize("shift", [0.05, -0.1, 0.3])
def test_hue_matches_jax(shift):
    imgs = _batch(4, 48, 40, seed=4)
    s = np.asarray([shift, -shift, shift / 2, 0.0], np.float32)
    assert_lsb(_port(PDA.adjust_hue, imgs, s), _jax(lambda im, i: JDA.adjust_hue(im, s[i]), imgs))


def test_flips_exact():
    imgs = _batch(2, 48, 40)
    assert_exact(_port(PDA.flip_h, imgs), imgs[:, :, ::-1])
    assert_exact(_port(PDA.flip_v, imgs), imgs[:, ::-1])


@pytest.mark.parametrize("angle", [10.0, -37.5, 90.0, 7.3])
def test_rotate_bilinear_matches_jax(angle):
    imgs = np.concatenate([_batch(2, 48, 40, seed=5), _grad(2)])
    a = np.asarray([angle, -angle, angle, angle / 3], np.float32)
    assert_lsb(_port(PDA.rotate, imgs, a), _jax(lambda im, i: JDA.rotate(im, a[i]), imgs))


def test_rotate_nearest_matches_jax():
    imgs = _grad(3)
    a = np.asarray([15.0, -8.0, 33.0], np.float32)
    assert_lsb(_port(lambda x, t: PDA.rotate(x, t, "nearest"), imgs, a),
               _jax(lambda im, i: JDA.rotate(im, a[i], "nearest"), imgs))


# three samples' parameters per case: the JAX test's matrices (tests/test_device_augment.py:115-134) first
AFFINES = {
    "translate": dict(angle=[0.0, 0.0, 0.0], translate=([5.0, -2.0, 1.0], [-3.0, 1.5, 0.0])),
    "shear_nearest": dict(angle=[0.0, 0.0, 0.0], translate=([0.0] * 3, [0.0] * 3), scale=[1.0] * 3,
                          shear=([10.0, -5.0, 2.5], [0.0] * 3), center=(0, 0)),
    "combined": dict(angle=[12.0, -6.0, 3.0], translate=([2.0, -1.0, 0.5], [1.0, -0.5, 0.25]),
                     scale=[1.1, 0.9, 1.1], shear=([5.0, -2.5, 1.25], [-3.0, 1.5, -0.75])),
}


def _affine_params(kw, pick):
    """``kw`` with every per-sample list passed through ``pick`` (the center stays)."""
    def one(v):
        return tuple(pick(x) for x in v) if isinstance(v, tuple) else pick(v)
    return {k: v if k == "center" else one(v) for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(AFFINES))
def test_affine_matches_jax(case):
    imgs = _grad(3)
    kw = AFFINES[case]
    interp = "nearest" if case == "shear_nearest" else "bilinear"
    m = PDA.inverse_affine_matrix((48, 40), **_affine_params(kw, lambda v: torch.tensor(v)))
    got = _port(lambda x: PDA.affine_transform(x, m, interp), imgs)
    want = _jax(lambda im, i: JDA.affine_transform(
        im, JDA.inverse_affine_matrix((48, 40), **_affine_params(kw, lambda v: jnp.float32(v[i]))), interp), imgs)
    assert_lsb(got, want)


@pytest.mark.parametrize("sigma", [0.5, 1.7])
def test_gaussian_blur_matches_jax(sigma):
    imgs = _batch(3, 48, 40, seed=6)
    s = np.asarray([sigma, sigma * 0.6, sigma * 1.4], np.float32)
    assert_lsb(_port(PDA.gaussian_blur, imgs, s, 5), _jax(lambda im, i: JDA.gaussian_blur(im, s[i], 5), imgs))


def test_cutout_geometry_matches_jax():
    imgs = _batch(3, 48, 40, seed=7)
    centers = np.asarray([[[10.0, 40.0], [0.0, 0.0]], [[47.0, 5.0], [20.0, 20.0]], [[3.0, 39.0], [30.0, 10.0]]],
                         np.float32)
    hole_w = np.asarray([16.0, 3.0, 25.0], np.float32)
    colors = np.arange(18, dtype=np.float32).reshape(3, 2, 3) * 10
    got = _port(lambda x: PDA.cutout_holes(x, centers, 20.0, hole_w, colors, 20), imgs)
    want = _jax(lambda im, i: JDA.cutout_holes(im, jnp.asarray(centers[i]), jnp.float32(20.0), hole_w[i],
                                               jnp.asarray(colors[i]), 20), imgs)
    assert_exact(got, want)
    y1, x1 = max(0, 10 - 10), max(0, 40 - 10)
    ref = imgs[0].astype(np.float32).copy()
    ref[y1:y1 + 20, x1:x1 + 16] = [0.0, 10.0, 20.0]
    ref[0:20, 0:16] = [30.0, 40.0, 50.0]
    assert_exact(got[0], ref)


def test_random_crop_static_takes_each_samples_offsets():
    imgs = _batch(3, 48, 40, seed=8)
    top, left = np.asarray([0, 16, 7]), np.asarray([8, 0, 3])
    got = _port(lambda x: PDA.random_crop_static(x, top, left, 32, 32), imgs)
    assert_exact(got, np.stack([imgs[i, t:t + 32, l:l + 32] for i, (t, l) in enumerate(zip(top, left))]))


# ------------------------------------------------- compiled ops: the reference


def _args(params):
    return PDA._call_compiler(lambda *a, **k: (a, k), params)


def _gate_ref(p, inner, imgs, draw):
    if float(p) >= 1.0:
        return inner(imgs, draw)
    fire, inner_draw = draw
    out = imgs.copy()
    if len(fire):
        out[fire] = inner(imgs[fire], inner_draw)
    return out


def _choice_ref(branches, imgs, draw):
    idx, inner = draw
    out = imgs.copy()
    for b, fn in enumerate(branches):
        sel = np.flatnonzero(idx == b)
        if len(sel):
            out[sel] = fn(imgs[sel], inner[b])
    return out


def _per_sample_ref(fn):
    """A deterministic JAX op as a reference body."""
    return lambda x, d: _jax(lambda im, i: fn(im), x)


def _jitter_ref(brightness, contrast, saturation, hue):
    enabled = [(n, float(v)) for n, v in (("brightness", brightness), ("contrast", contrast),
                                          ("saturation", saturation), ("hue", hue)) if v]
    fns = {"brightness": JDA.adjust_brightness, "contrast": JDA.adjust_contrast,
           "saturation": JDA.adjust_saturation, "hue": JDA.adjust_hue}
    if not enabled:
        return lambda x, d: x

    def body(x, draw):
        order, factors = draw

        def one(im, i):
            for step in range(len(enabled)):
                b = order[i, step]
                im = fns[enabled[b][0]](im, factors[b][i])
            return im

        return _jax(one, x)

    return body


def _noise_ref(n_holes=1, length=200, noisy_src=None, h_range=None, w_range=None, prob=0.5):
    """The JAX body of random_cutaddnoise (visiondk_tpu/ops/device_augment.py:688-706)
    in numpy, fed the port's noise."""
    def body(x, draw):
        noise = PDA.cutaddnoise_noise(torch.from_numpy(x), draw["noise_seed"]).numpy()
        h, w = x.shape[1:3]
        ys, xs = np.arange(h)[:, None], np.arange(w)[None, :]
        out = x.copy()
        for s in range(len(x)):
            for i in range(int(n_holes)):
                yc, xc = (int(v) for v in draw["centers"][s, i])
                y1, x1 = max(yc - length // 2, 0), max(xc - length // 2, 0)
                y2, x2 = min(yc + length // 2, h), min(xc + length // 2, w)
                mask = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
                out[s] = np.where(mask[..., None], noise[s], out[s])
        return out
    return lambda imgs, draw: _gate_ref(prob, body, imgs, draw)


def _augmix_ref(severity=3, width=3, alpha=1.0):
    s = int(severity)

    def body(x, p):
        def one(im, i):
            mix = jnp.zeros_like(im)
            for c in range(int(width)):
                aug = im
                for d in range(3):
                    if d < p["depth"][i, c]:
                        aug = [
                            lambda a: JAX_AUTOCONTRAST(a), lambda a: JDA.equalize(a),
                            lambda a: JDA.posterize(a, max(8 - s, 1)),
                            lambda a: JDA.rotate(a, p["angle"][i, c, d]),
                            lambda a: JDA.solarize(a, jnp.float32(256 - 26 * s)),
                            lambda a: JDA.adjust_sharpness(a, p["sharpness"][i, c, d]),
                        ][p["op"][i, c, d]](aug)
                mix = mix + p["ws"][i, c] * aug
            return jnp.floor(jnp.clip((1.0 - p["m"][i]) * im + p["m"][i] * mix, 0.0, 255.0))
        return _jax(one, x)
    return body


def _randaugment_ref(num_ops=2, magnitude=9, num_magnitude_bins=31):
    t = int(magnitude) / (int(num_magnitude_bins) - 1)
    post_bits = 8 - int(round(int(magnitude) / ((int(num_magnitude_bins) - 1) / 4)))

    def body(x, p):
        h, w = x.shape[1:3]

        def one(im, i):
            for k in range(int(num_ops)):
                def signed(mag):
                    return jnp.where(p["negative"][i, k], -mag, mag)

                def geo(sh=(0.0, 0.0), tr=(0.0, 0.0), center=None):
                    return JDA.affine_transform(im, JDA.inverse_affine_matrix((h, w), 0.0, tr, 1.0, sh, center),
                                                "nearest")
                deg = jnp.rad2deg(jnp.arctan(signed(0.3 * t)))
                tx = jnp.floor(signed(150.0 / 331.0 * w * t) + 0.5)
                ty = jnp.floor(signed(150.0 / 331.0 * h * t) + 0.5)
                enh = 1.0 + signed(0.9 * t)
                im = [
                    lambda: im,
                    lambda: geo(sh=(deg, jnp.float32(0.0)), center=(0, 0)),
                    lambda: geo(sh=(jnp.float32(0.0), deg), center=(0, 0)),
                    lambda: geo(tr=(tx, jnp.float32(0.0))),
                    lambda: geo(tr=(jnp.float32(0.0), ty)),
                    lambda: JDA.rotate(im, signed(30.0 * t), "nearest"),
                    lambda: JDA.adjust_brightness(im, enh),
                    lambda: JDA.adjust_saturation(im, enh),
                    lambda: JDA.adjust_contrast(im, enh),
                    lambda: JDA.adjust_sharpness(im, enh),
                    lambda: JDA.posterize(im, max(post_bits, 0)),
                    lambda: JDA.solarize(im, jnp.float32(int(255.0 * (1.0 - t)))),
                    lambda: JAX_AUTOCONTRAST(im),
                    lambda: JDA.equalize(im),
                ][p["op"][i, k]]()
            return im
        return _jax(one, x)
    return body


def _affine_ref(degrees=0.0, translate=0.0, scale=0.0, shear=0.0, fill=0, center=None):
    *_, fill_v, ctr = JDA._affine_spec(degrees, translate, scale, shear, fill, center)

    def body(x, p):
        h, w = x.shape[1:3]
        return _jax(lambda im, i: JDA.affine_transform(im, JDA.inverse_affine_matrix(
            (h, w), p["angle"][i], (p["translate"][0][i], p["translate"][1][i]), p["scale"][i],
            (p["shear"][0][i], p["shear"][1][i]), ctr), "bilinear", fill_v), x)
    return body


def _cutout_ref(n_holes=1, length=200, ratio=0.2, h_range=None, w_range=None, prob=0.5, color=(0, 0)):
    def body(x, p):
        centers, mask_w, colors = p
        return _jax(lambda im, i: JDA.cutout_holes(im, jnp.asarray(centers[i]), jnp.float32(length), mask_w[i],
                                                   jnp.asarray(colors[i]), int(length)), x)
    return lambda imgs, draw: _gate_ref(prob, body, imgs, draw)


def _flip_ref(axis):
    def ref(p=0.5):
        return lambda imgs, draw: _gate_ref(p, lambda x, d: np.flip(x, axis).copy(), imgs, draw)
    return ref


def _gated(fn, default_p):
    """A reference for ``_gate(p, deterministic fn)`` compilers."""
    def ref(p=default_p):
        return lambda imgs, draw: _gate_ref(p, _per_sample_ref(fn), imgs, draw)
    return ref


REFS = {
    "random_horizonflip": _flip_ref(2),
    "random_verticalflip": _flip_ref(1),
    "random_double_flip": lambda p=0.5: lambda imgs, d: _flip_ref(1)(p)(_flip_ref(2)(p)(imgs, d[0]), d[1]),
    "random_doubleflip": lambda prob=0.5: lambda imgs, d: _gate_ref(0.5, lambda x, dd: _choice_ref(
        [lambda y, _: np.flip(y, 1).copy(), lambda y, _: np.flip(y, 2).copy()], x, dd), imgs, d),
    "random_invert": _gated(JDA.invert, 0.5),
    "random_grayscale": _gated(JDA.grayscale, 0.1),
    "random_autocontrast": _gated(JAX_AUTOCONTRAST, 0.5),
    "random_equalize": _gated(JDA.equalize, 0.5),
    "random_adjustsharpness": lambda sharpness_factor=2.0, p=0.5: lambda imgs, d: _gate_ref(
        p, _per_sample_ref(lambda im: JDA.adjust_sharpness(im, float(sharpness_factor))), imgs, d),
    "random_color_jitter": lambda brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0, p=1.0, prob=None: (
        lambda imgs, d: _gate_ref(p if prob is None else prob, _jitter_ref(brightness, contrast, saturation, hue),
                                  imgs, d)),
    "color_jitter": lambda brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1: _jitter_ref(
        brightness, contrast, saturation, hue),
    "random_gaussianblur": lambda prob=0.5, kernel_size=3, sigma=(0.1, 2.0), p=None: lambda imgs, d: _gate_ref(
        prob if p is None else p,
        lambda x, s: _jax(lambda im, i: JDA.gaussian_blur(im, s[i], int(kernel_size)), x), imgs, d),
    "random_rotate": lambda degrees=10.0, expand=False: lambda imgs, a: _jax(
        lambda im, i: JDA.rotate(im, a[i]), imgs),
    "random_affine": _affine_ref,
    "random_cutout": _cutout_ref,
    "random_cutaddnoise": _noise_ref,
    "random_crop": lambda size: lambda imgs, d: np.stack(
        [imgs[i, t:t + int(size), l:l + int(size)] for i, (t, l) in enumerate(zip(*d))]),
    "random_augmix": _augmix_ref,
    "random_augment": _randaugment_ref,
}


def reference(item, imgs, draw):
    """What JAX's primitives give for a compiled item on ``imgs`` (float32
    numpy) with the port's ``draw``."""
    name, params = PDA._item_name(item), PDA._item_params(item)
    if name == "random_choice":
        branches = [lambda x, d, t=t: reference(t, x, d) for t in params["transforms"]]
        return _choice_ref(branches, imgs, draw)
    a, k = _args(params)
    return REFS[name](*a, **k)(imgs, draw)


EXACT = {"random_horizonflip", "random_verticalflip", "random_double_flip", "random_doubleflip", "random_invert",
         "random_grayscale", "random_autocontrast", "random_equalize", "random_cutout", "random_cutaddnoise",
         "random_crop"}

PET_SYNTH_AUG = yaml.safe_load((REPO / "configs/classification/pet_synth.yaml").read_text())["data"]["train"]["augment"]
PET_SYNTH_CHOICE = PET_SYNTH_AUG[0]
# every registry key with its defaults (random_crop has no default size), pet_synth's lifted items and
# branches as written, and variants that make the rare draws common
COMPILER_CASES = (
    [{name: None} for name in PDA._COMPILERS if name != "random_crop"]
    + [{"random_crop": {"size": 24}}, {"random_crop": 20}]
    + list(PET_SYNTH_CHOICE["random_choice"]["transforms"]) + PET_SYNTH_AUG[:2]
    + [
        {"random_color_jitter": {"brightness": 0.5, "contrast": 0.5, "saturation": 0.5, "hue": 0.2, "p": 0.7}},
        {"random_cutout": {"n_holes": 3, "length": 12, "prob": 1.0, "color": [0, 255]}},
        {"random_cutaddnoise": {"n_holes": 2, "length": 10, "prob": 0.8}},
        {"random_gaussianblur": {"prob": 1.0, "kernel_size": 5, "sigma": 1.2}},
        {"random_affine": {"degrees": 20, "translate": [0.1, 0.2], "scale": [0.8, 1.2], "shear": [-5, 5, -3, 3],
                           "fill": 7}},
        {"random_rotate": {"degrees": [-30, 5]}},
        {"random_rotate": 15},
        {"random_doubleflip": [[0.2, 0.8]]},
        {"random_augment": {"num_ops": 3, "magnitude": 15}},
    ]
)


def _case_id(item):
    return f"{PDA._item_name(item)}:{json.dumps(PDA._item_params(item), separators=(',', ':'))}"[:60]


def _check(item, got, want):
    if PDA._item_name(item) in EXACT:
        assert_exact(got, want)
    else:
        assert_lsb(got, want)


@pytest.mark.parametrize("item", COMPILER_CASES, ids=[_case_id(c) for c in COMPILER_CASES])
def test_compiled_op_matches_jax_on_its_draws(item):
    n, h, w = 8, 40, 32
    imgs = _batch(n, h, w, seed=9).astype(np.float32)
    op = PDA._compile_one(PDA._item_name(item), PDA._item_params(item))
    draw = op.draw(np.random.default_rng(11), n, h, w)
    got = op.apply(torch.from_numpy(imgs), draw).numpy()
    _check(item, got, reference(item, imgs, draw))


def _forced_choice(item, b, n, h, w, seed=12):
    """A random_choice draw whose samples all take branch ``b``."""
    ts = item["random_choice"]["transforms"]
    gen = np.random.default_rng(seed)
    return np.full(n, b), [PDA._compile_one(PDA._item_name(t), PDA._item_params(t)).draw(gen, n if j == b else 0, h, w)
                           for j, t in enumerate(ts)]


@pytest.mark.parametrize("b", range(7))
def test_pet_synth_choice_branch_forced(b):
    n, h, w = 6, 32, 32
    imgs = _batch(n, h, w, seed=13).astype(np.float32)
    op = PDA._compile_one("random_choice", PET_SYNTH_CHOICE["random_choice"])
    draw = _forced_choice(PET_SYNTH_CHOICE, b, n, h, w)
    got = op.apply(torch.from_numpy(imgs), draw).numpy()
    branch = PET_SYNTH_CHOICE["random_choice"]["transforms"][b]
    _check(branch, got, reference(PET_SYNTH_CHOICE, imgs, draw))


@pytest.mark.parametrize("b", range(6))
def test_augmix_op_forced(b):
    n, h, w = 4, 32, 32
    imgs = _batch(n, h, w, seed=14).astype(np.float32)
    item = {"random_augmix": {"severity": 3}}
    op = PDA._compile_one("random_augmix", item["random_augmix"])
    draw = op.draw(np.random.default_rng(15), n, h, w)
    draw["op"][:] = b
    draw["depth"][:] = 3
    assert_lsb(op.apply(torch.from_numpy(imgs), draw).numpy(), reference(item, imgs, draw))


@pytest.mark.parametrize("b", range(len(PDA._RA_OPS)), ids=PDA._RA_OPS)
def test_randaugment_op_forced(b):
    n, h, w = 4, 40, 32
    imgs = _batch(n, h, w, seed=16).astype(np.float32)
    item = {"random_augment": {"num_ops": 2, "magnitude": 9}}
    op = PDA._compile_one("random_augment", item["random_augment"])
    draw = op.draw(np.random.default_rng(17), n, h, w)
    draw["op"][:, 0] = b
    got, want = op.apply(torch.from_numpy(imgs), draw).numpy(), reference(item, imgs, draw)
    assert_lsb(got, want)
    if PDA._RA_OPS[draw["op"][0, 1]] == "Identity" and PDA._RA_OPS[b] in ("Identity", "Posterize", "Solarize",
                                                                         "AutoContrast", "Equalize"):
        assert_exact(got[0], want[0])


@pytest.mark.parametrize("p", [0.0, 1.0])
def test_gate_probability_zero_and_one(p):
    imgs = _batch(6, seed=18)
    op = PDA._compile_one("random_invert", {"p": p})
    out = op.apply(torch.from_numpy(imgs.astype(np.float32)), op.draw(np.random.default_rng(0), 6, 32, 32)).numpy()
    assert_exact(out, 255 - imgs if p else imgs)


def test_flip_gate_statistics():
    """hflip(p=0.5) over 200 samples of one batch fires on about half."""
    imgs = _batch(200, 4, 4, seed=19)
    op = PDA._compile_one("random_horizonflip", {"p": 0.5})
    out = op.apply(torch.from_numpy(imgs.astype(np.float32)), op.draw(np.random.default_rng(1), 200, 4, 4)).numpy()
    flipped = np.all(out == imgs[:, :, ::-1], axis=(1, 2, 3))
    assert np.all(flipped | np.all(out == imgs, axis=(1, 2, 3)))
    assert 60 <= flipped.sum() <= 140


def test_random_doubleflip_chooses_one():
    imgs = _batch(60, 6, 5, seed=20)
    op = PDA._compile_one("random_doubleflip", 0.5)
    out = op.apply(torch.from_numpy(imgs.astype(np.float32)), op.draw(np.random.default_rng(2), 60, 6, 5)).numpy()
    kinds = set()
    for o, im in zip(out, imgs):
        kind = [k for k, v in (("orig", im), ("h", im[:, ::-1]), ("v", im[::-1]), ("hv", im[::-1, ::-1]))
                if np.array_equal(o, v)]
        kinds.add(kind[0])
    assert "hv" not in kinds and {"h", "v"} <= kinds


# ------------------------------------------------------------------- the split


def _augment_lists():
    """Every augment list of every YAML under configs/."""
    out = []

    def walk(o, where):
        if isinstance(o, dict):
            for k, v in o.items():
                if k == "augment" and isinstance(v, list):
                    out.append((f"{where}/{k}", v))
                walk(v, f"{where}/{k}")
        elif isinstance(o, list):
            for v in o:
                walk(v, where)

    for path in sorted((REPO / "configs").rglob("*.yaml")):
        walk(yaml.safe_load(path.read_text()), str(path.relative_to(REPO)))
    return out


SYNTHETIC_PIPELINES = [
    ("no_geometry", [{"random_horizonflip": {"p": 0.5}}, "to_tensor"]),
    ("host_only", [{"random_cutaddnoise": {"noisy_src": "/tmp/nonexistent_noise"}}, {"resize": 224}, "to_tensor"]),
    ("without_div", [{"random_horizonflip": {"p": 0.5}}, {"random_color_jitter": {"brightness": 0.4}},
                     {"resize_and_padding": {"size": 32}}, "to_tensor_without_div",
                     {"normalize": {"mean": [0, 0, 0], "std": [1, 1, 1]}}]),
    ("crop_lifted", [{"resize": 40}, {"random_horizonflip": {"p": 0.5}}, {"random_crop": {"size": 32}}, "to_tensor"]),
    ("not_liftable", [{"random_rotate": {"degrees": 10, "expand": True}}, {"resize": 32}, {"random_crop": 24},
                      {"random_rotate": 15}, {"random_choice": {"transforms": [{"random_invert": None},
                                                                                {"resize": 32}]}}, "to_tensor"]),
    ("bad_params", [{"resize": 32}, {"random_invert": {"q": 1}}, {"random_augmix": [3, 3, 1.0]}]),
]
SPLIT_CASES = _augment_lists() + SYNTHETIC_PIPELINES


def _items(cfg):
    for item in cfg:
        yield item
        if PDA._item_name(item) == "random_choice":
            yield from _items((PDA._item_params(item) or {}).get("transforms", []))


@pytest.mark.parametrize("cfg", [c for _, c in SPLIT_CASES], ids=[n for n, _ in SPLIT_CASES])
def test_split_and_size_match_jax(cfg):
    assert PDA.split_device_pipeline(copy.deepcopy(cfg)) == JDA.split_device_pipeline(copy.deepcopy(cfg))
    assert [PDA.is_liftable(i) for i in _items(cfg)] == [JDA.is_liftable(i) for i in _items(cfg)]
    for size in (16, 32):
        port_cfg, jax_cfg = copy.deepcopy(cfg), copy.deepcopy(cfg)
        assert PDA.set_device_pipeline_size(port_cfg, size) == JDA.set_device_pipeline_size(jax_cfg, size)
        assert port_cfg == jax_cfg


def test_pet_synth_splits_into_host_geometry_and_device_photometric():
    host, dev = PDA.split_device_pipeline(PET_SYNTH_AUG)
    assert [PDA._item_name(i) for i in host] == ["random_choice", "to_tensor", "normalize"]
    assert [PDA._item_name(i) for i in dev] == ["random_choice", "random_horizonflip"]
    assert PDA.describe_split(host, dev) == "host: [random_choice, to_tensor, normalize] | device: [random_choice, " \
                                            "random_horizonflip]"


def test_set_device_pipeline_size_rewrites_nested_and_scalar_crops():
    cfg = [{"random_choice": {"transforms": [{"random_crop": {"size": 48}}]}}, {"random_crop": 48}]
    assert PDA.set_device_pipeline_size(cfg, 24)
    assert cfg == [{"random_choice": {"transforms": [{"random_crop": {"size": 24}}]}}, {"random_crop": {"size": 24}}]
    assert not PDA.set_device_pipeline_size(cfg, 24)
    assert not PDA.set_device_pipeline_size([{"random_horizonflip": {"p": 0.5}}], 24)


# ------------------------------------------------------------------- the stage


def test_stage_is_deterministic_per_seed_and_draws_per_sample():
    stage = PDA.make_device_augment([{"random_color_jitter": {"brightness": 0.4}}, {"random_horizonflip": {"p": 0.5}}])
    imgs = torch.from_numpy(_batch(8, seed=21))
    calls = PDA.make_device_augment.calls
    o1, o2, o3 = stage(5, imgs), stage(5, imgs), stage(6, imgs)
    assert PDA.make_device_augment.calls == calls + 3
    assert o1.dtype == torch.uint8 and o1.shape == imgs.shape
    assert torch.equal(o1, o2) and not torch.equal(o1, o3)
    same = imgs[:1].expand(8, -1, -1, -1).contiguous()
    out = stage(7, same)
    assert any(not torch.equal(out[i], out[0]) for i in range(1, 8))


def test_stage_raises_on_a_float_batch():
    stage = PDA.make_device_augment([{"random_horizonflip": {"p": 1.0}}])
    with pytest.raises(TypeError, match="uint8"):
        stage(0, torch.ones((2, 8, 8, 3)))
    assert PDA.make_device_augment([]) is None


@pytest.mark.parametrize("group_size", [1, 8])
def test_deterministic_stage_equals_jax_end_to_end(group_size):
    cfg = [{"random_horizonflip": {"p": 1.0}}, {"random_autocontrast": {"p": 1.0}}, {"random_invert": {"p": 1.0}}]
    imgs = _batch(8, 32, 32, seed=22)
    imgs[:, ..., 0] = np.clip(imgs[:, ..., 0], 30, 220)
    want = np.asarray(JDA.make_device_augment(copy.deepcopy(cfg), group_size=group_size)(
        jax.random.key(0), jnp.asarray(imgs)))
    got = PDA.make_device_augment(cfg, group_size=group_size)(0, torch.from_numpy(imgs))
    assert_exact(got.numpy(), want)


def test_branches_are_drawn_per_sample_whatever_the_group_size():
    """The one intended difference from the JAX package's default: samples of
    one group of 8 draw their own branch, and the group size changes nothing."""
    cfg = [{"random_choice": {"transforms": [{"random_invert": {"p": 1.0}}, {"random_horizonflip": {"p": 0.0}}]}}]
    base = torch.full((8, 4, 4, 3), 10, dtype=torch.uint8)
    outs = [PDA.make_device_augment(cfg, group_size=g)(3, base) for g in (1, 8, None)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    kinds = {int(o.unique()[0]) for o in outs[0]}
    assert kinds == {10, 245}
    with pytest.raises(ValueError):
        PDA.make_device_augment(cfg, group_size=0)


def test_stage_after_a_progressive_resize():
    cfg = [{"random_horizonflip": {"p": 0.5}}, {"random_crop": {"size": 32}}]
    assert PDA.make_device_augment(cfg)(0, torch.zeros((2, 40, 40, 3), dtype=torch.uint8)).shape == (2, 32, 32, 3)
    assert PDA.set_device_pipeline_size(cfg, 16)
    assert PDA.make_device_augment(cfg)(0, torch.zeros((2, 20, 20, 3), dtype=torch.uint8)).shape == (2, 16, 16, 3)


def test_pet_synth_stage_runs_every_branch_and_changes_the_batch():
    _, dev = PDA.split_device_pipeline(PET_SYNTH_AUG)
    stage = PDA.make_device_augment(dev)
    imgs = torch.from_numpy(_batch(32, 32, 32, seed=23))
    out = stage(1, imgs)
    assert out.shape == imgs.shape and out.dtype == torch.uint8 and not torch.equal(out, imgs)
    assert torch.equal(out, stage(1, imgs))


# ------------------------------------------------------------------- the step


def test_train_step_with_the_stage_is_deterministic_and_perturbs_the_loss():
    """Mirrors the JAX test (tests/test_device_augment.py:503-541) on a tiny ViT."""
    from visiondk_tpu_torch.engine.state import create_train_state
    from visiondk_tpu_torch.engine.steps import StepConfig, make_train_step
    from visiondk_tpu_torch.engine.trainer import build_tx
    from visiondk_tpu_torch.losses import create_lossfn
    from visiondk_tpu_torch.models import BACKBONES, get_model
    from visiondk_tpu_torch.models.backbones.vit import _vit

    name = "vit_tiny_patch8_port_device_augment_test"
    BACKBONES.register(_vit(8, 64, 2, 4), name=name)
    try:
        hyp = {"epochs": 2, "lr0": 0.01, "lrf_ratio": None, "momentum": 0.9, "weight_decay": 0.0,
               "warmup_momentum": 0.9, "warm_ep": 0, "optimizer": ["sgd", False], "scheduler": "cosine_with_warm"}
        stage = PDA.make_device_augment([{"random_color_jitter": {"brightness": 0.9}},
                                         {"random_cutout": {"length": 12, "prob": 1.0}}])
        batch = {"image": torch.from_numpy(_batch(4, seed=24)), "label": torch.tensor([0, 1, 2, 3])}

        def loss(with_stage, seed=1):
            torch.manual_seed(0)
            model = get_model({"task": "classification", "name": name, "image_size": 32, "num_classes": 4,
                               "kwargs": {}}, device="cpu", dtype=torch.float32,
                              generator=torch.Generator().manual_seed(0))
            tx = build_tx(hyp, 2, True)
            step = make_train_step(model, tx, create_lossfn("ce"), StepConfig(), torch.Generator().manual_seed(seed),
                                   device_augment=stage if with_stage else None)
            return step(create_train_state(model, tx), batch)["loss"].item()

        assert loss(True) == loss(True)
        assert loss(True) != pytest.approx(loss(False), rel=1e-6)
        assert loss(True, seed=1) != loss(True, seed=2)
    finally:
        del BACKBONES._store[name]
