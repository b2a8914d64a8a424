"""Host-side augmentation registry (counterpart of ``visiondk_tpu/data/transforms.py``).

The whole registry of the JAX package, on PIL and numpy (cv2 only for
``random_localgaussian``'s seamlessClone, where installed): ``AUG_METHODS``
maps each name of a YAML augment block to its op, ``create_aug_transforms``
compiles a block (nested ``random_choice`` trees included) into a
``Compose``. ``to_tensor`` yields **uint8 HWC** and ``normalize`` is a
marker: the /255 and mean/std arithmetic runs on the device
(``engine/steps.device_preprocess``).

Randomness comes from thread-local ``random.Random`` and numpy generators
that the loaders seed per sample with ``seed_sample(seed, epoch, index)``
(crc32 of the parts), so a batch does not depend on which worker thread
built which sample, and the port's host batches are byte-identical to the
JAX package's for the same seed. Pipelines are data, rebuilt from the config
whenever the trainer swaps them (warm-up val augments, aug weakening,
progressive resize).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from visiondk_tpu_torch.registry import Registry

AUG_METHODS = Registry("augment")

# ---------------------------------------------------------------- determinism
# Augmentations draw randomness from a thread-local RNG seeded per sample by
# the DataLoader (seed, epoch, index) — reproducible batches regardless of
# which worker thread handles which sample. (The reference inherits torch's
# per-worker seeding; with thread workers the global `random` would race.)

import threading
import zlib

_TLS = threading.local()


def rng():
    """The current thread's seeded Random (global `random` if unseeded)."""
    return getattr(_TLS, "rng", random)


def np_rng():
    g = getattr(_TLS, "np_rng", None)
    return g if g is not None else np.random.default_rng()


def seed_sample(*parts) -> None:
    """Deterministically seed this thread's RNGs from hashable parts."""
    s = zlib.crc32(repr(parts).encode())
    _TLS.rng = random.Random(s)
    _TLS.np_rng = np.random.default_rng(s)

# Transforms that alter spatial geometry — the set progressive learning and
# GradCAM replay care about (reference transforms.py:564).
SPATIAL_TRANSFORMS = {
    "resize",
    "center_crop",
    "random_crop",
    "resize_and_padding",
    "random_crop_and_resize",
    "pad_if_need",
    "pad2square",
    "centercrop_resize",
    "random_horizonflip",
    "random_verticalflip",
    "random_double_flip",
    "random_doubleflip",
    "random_rotate",
}


class Transform:
    """Base: callable with a ``name`` for pipeline introspection."""

    name = "transform"

    def __call__(self, img):
        raise NotImplementedError

    def __repr__(self):
        return f"{self.__class__.__name__}()"


class Compose(Transform):
    name = "compose"

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, img):
        for t in self.transforms:
            img = t(img)
        return img

    def __repr__(self):
        inner = ", ".join(repr(t) for t in self.transforms)
        return f"Compose([{inner}])"


class RandomChoice(Transform):
    name = "random_choice"

    def __init__(self, transforms: Sequence[Callable], p: Optional[Sequence[float]] = None):
        self.transforms = list(transforms)
        self.p = list(p) if p is not None else None

    def __call__(self, img):
        t = rng().choices(self.transforms, weights=self.p, k=1)[0]
        return t(img)


def _to_pil(img) -> Image.Image:
    if isinstance(img, Image.Image):
        return img
    return Image.fromarray(np.asarray(img))


# ---------------------------------------------------------------- geometry


@AUG_METHODS.register(name="resize")
class Resize(Transform):
    name = "resize"

    def __init__(self, size: Union[int, Sequence[int]]):
        self.size = size

    def __call__(self, img):
        img = _to_pil(img)
        if isinstance(self.size, int):
            w, h = img.size
            if w < h:
                return img.resize((self.size, int(self.size * h / w)), Image.BILINEAR)
            return img.resize((int(self.size * w / h), self.size), Image.BILINEAR)
        return img.resize((self.size[1], self.size[0]), Image.BILINEAR)


@AUG_METHODS.register(name="center_crop")
class CenterCrop(Transform):
    name = "center_crop"

    def __init__(self, size: Union[int, Sequence[int]]):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = _to_pil(img)
        w, h = img.size
        th, tw = self.size
        left = max((w - tw) // 2, 0)
        top = max((h - th) // 2, 0)
        return img.crop((left, top, left + tw, top + th))


@AUG_METHODS.register(name="random_crop")
class RandomCrop(Transform):
    name = "random_crop"

    def __init__(self, size: Union[int, Sequence[int]]):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, img):
        img = _to_pil(img)
        w, h = img.size
        th, tw = self.size
        if w == tw and h == th:
            return img
        left = rng().randint(0, max(w - tw, 0))
        top = rng().randint(0, max(h - th, 0))
        return img.crop((left, top, left + tw, top + th))


@AUG_METHODS.register(name="resize_and_padding")
class ResizeAndPadding2Square(Transform):
    """Letterbox: resize longest side to ``size``, pad short side to square
    (reference transforms.py:325-388). ``training=False`` records padding for
    exact inversion (CAM un-letterboxing)."""

    name = "resize_and_padding"

    def __init__(self, size: int, training: bool = True):
        self.size = size
        self.training = training
        self.last_pad = (0, 0)  # (pad_w, pad_h) for reverse

    def __call__(self, img):
        img = _to_pil(img)
        w, h = img.size
        scale = self.size / max(w, h)
        nw, nh = max(int(round(w * scale)), 1), max(int(round(h * scale)), 1)
        img = img.resize((nw, nh), Image.BILINEAR)
        pad_w, pad_h = self.size - nw, self.size - nh
        self.last_pad = (pad_w, pad_h)
        if pad_w == 0 and pad_h == 0:
            return img
        canvas = Image.new(img.mode, (self.size, self.size), 0)
        canvas.paste(img, (pad_w // 2, pad_h // 2))
        return canvas

    def reverse(self, arr: np.ndarray, orig_size: Tuple[int, int]) -> np.ndarray:
        """Undo letterbox on an HxW (heatmap) array back to original size."""
        pad_w, pad_h = self.last_pad
        h, w = arr.shape[:2]
        arr = arr[pad_h // 2 : h - (pad_h - pad_h // 2), pad_w // 2 : w - (pad_w - pad_w // 2)]
        img = Image.fromarray((arr * 255).astype(np.uint8) if arr.dtype != np.uint8 else arr)
        img = img.resize(orig_size, Image.BILINEAR)
        return np.asarray(img)


@AUG_METHODS.register(name="random_crop_and_resize")
class RandomResizedCrop(Transform):
    """RandomResizedCrop with the reference's aspect-ratio guard: images with
    AR > 1.5 fall back to letterbox (transforms.py:390-400)."""

    name = "random_crop_and_resize"

    def __init__(self, size: int, scale: Sequence[float] = (0.08, 1.0), ratio: Sequence[float] = (3 / 4, 4 / 3)):
        self.size = size
        self.scale = tuple(scale)
        self.ratio = tuple(ratio)
        self.resize_and_padding = ResizeAndPadding2Square(size, training=True)

    def sample_params(self, w: int, h: int):
        """Draw this sample's crop geometry from the thread's seeded RNG —
        the exact draw sequence ``__call__`` consumes, so the native C++
        decode path (loader.NativeTrainLoader) reproduces the PIL path's
        crop for the same (seed, epoch, index). Returns ``("letterbox",)``
        for the AR>1.5 guard, else ``("crop", left, top, cw, ch)`` (the
        10-attempt failure = a center crop of side min(w, h))."""
        ar = max(w, h) / max(min(w, h), 1)
        if ar > 1.5:
            return ("letterbox",)
        area = w * h
        for _ in range(10):
            target_area = area * rng().uniform(*self.scale)
            log_ratio = (np.log(self.ratio[0]), np.log(self.ratio[1]))
            aspect = float(np.exp(rng().uniform(*log_ratio)))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                left = rng().randint(0, w - cw)
                top = rng().randint(0, h - ch)
                return ("crop", left, top, cw, ch)
        side = min(w, h)
        return ("crop", max((w - side) // 2, 0), max((h - side) // 2, 0), side, side)

    def __call__(self, img):
        img = _to_pil(img)
        w, h = img.size
        p = self.sample_params(w, h)
        if p[0] == "letterbox":
            return self.resize_and_padding(img)
        _, left, top, cw, ch = p
        img2 = img.crop((left, top, left + cw, top + ch))
        return img2.resize((self.size, self.size), Image.BILINEAR)


@AUG_METHODS.register(name="pad_if_need")
class PadIfNeed(Transform):
    name = "pad_if_need"

    def __init__(self, size: Union[int, Sequence[int]], fill: int = 0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.fill = fill

    def __call__(self, img):
        img = _to_pil(img)
        w, h = img.size
        th, tw = self.size
        pad_w, pad_h = max(tw - w, 0), max(th - h, 0)
        if pad_w == 0 and pad_h == 0:
            return img
        canvas = Image.new(img.mode, (max(w, tw), max(h, th)), self.fill)
        canvas.paste(img, (pad_w // 2, pad_h // 2))
        return canvas


@AUG_METHODS.register(name="random_horizonflip")
class RandomHorizontalFlip(Transform):
    name = "random_horizonflip"

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        if rng().random() < self.p:
            return _to_pil(img).transpose(Image.FLIP_LEFT_RIGHT)
        return _to_pil(img)


@AUG_METHODS.register(name="random_verticalflip")
class RandomVerticalFlip(Transform):
    name = "random_verticalflip"

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        if rng().random() < self.p:
            return _to_pil(img).transpose(Image.FLIP_TOP_BOTTOM)
        return _to_pil(img)


@AUG_METHODS.register(name="random_double_flip")
class RandomDoubleFlip(Transform):
    """Random H then random V flip (both may fire — this repo's historical
    spelling; the reference-exact choose-one variant is ``random_doubleflip``)."""

    name = "random_double_flip"

    def __init__(self, p: float = 0.5):
        self.h = RandomHorizontalFlip(p)
        self.v = RandomVerticalFlip(p)

    def __call__(self, img):
        return self.v(self.h(img))


@AUG_METHODS.register(name="random_doubleflip")
class RandomDoubleFlipChoice(Transform):
    """Reference RandomDoubleFlip (transforms.py:316-323): pick ONE of
    [vflip(0.5), hflip(0.5)] weighted by ``prob`` and apply it."""

    name = "random_doubleflip"

    def __init__(self, prob: Union[float, Sequence[float]] = 0.5):
        self.prob = tuple(prob) if isinstance(prob, (list, tuple)) else (prob, prob)
        self.choices = [RandomVerticalFlip(0.5), RandomHorizontalFlip(0.5)]

    def __call__(self, img):
        return rng().choices(self.choices, weights=self.prob, k=1)[0](img)


@AUG_METHODS.register(name="random_rotate")
class RandomRotate(Transform):
    name = "random_rotate"

    def __init__(self, degrees: Union[float, Sequence[float]] = 10.0, expand: bool = False):
        self.degrees = (
            (-float(degrees), float(degrees))
            if isinstance(degrees, (int, float))
            else (float(degrees[0]), float(degrees[1]))
        )
        self.expand = expand

    def __call__(self, img):
        angle = rng().uniform(*self.degrees)
        return _to_pil(img).rotate(angle, Image.BILINEAR, expand=self.expand)


def _inverse_affine_matrix(center, angle, translate, scale, shear):
    """torchvision's _get_inverse_affine_matrix: the output→input AFFINE
    coefficients PIL.Image.transform consumes, for rotation ``angle``° about
    ``center`` + ``translate`` px + ``scale`` + ``shear`` (sx, sy)°."""
    import math

    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    cx, cy = center
    tx, ty = translate

    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)

    matrix = [d / scale, -b / scale, 0.0, -c / scale, a / scale, 0.0]
    matrix[2] += matrix[0] * (-cx - tx) + matrix[1] * (-cy - ty)
    matrix[5] += matrix[3] * (-cx - tx) + matrix[4] * (-cy - ty)
    matrix[2] += cx
    matrix[5] += cy
    return matrix


def _pil_affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
                interpolation=Image.BILINEAR, fill=0, center=None):
    """F.affine on the PIL backend. Default center (w/2, h/2) in PIL's
    corner-based coordinates (pixel i spans [i, i+1)) — torchvision's
    convention; PIL evaluates the inverse matrix at output (x+0.5, y+0.5)."""
    w, h = img.size
    cx, cy = center if center is not None else (w * 0.5, h * 0.5)
    matrix = _inverse_affine_matrix((cx, cy), angle, translate, scale, shear)
    if isinstance(fill, (int, float)):
        fill = tuple([int(fill)] * len(img.getbands()))
    return img.transform((w, h), Image.AFFINE, matrix, interpolation, fillcolor=tuple(fill))


@AUG_METHODS.register(name="random_affine")
class RandomAffine(Transform):
    """torchvision RandomAffine parameter sampling (reference
    transforms.py:507-508): angle ~ U(degrees), per-axis translation as a
    fraction of size, scale ~ U(scale range), shear per axis. Scalars for
    degrees/shear mean symmetric ranges; 0/None translate/scale disables."""

    name = "random_affine"

    def __init__(self, degrees=0.0, translate=0.0, scale=0.0, shear=0.0, fill=0, center=None):
        self.degrees = (
            (-float(degrees), float(degrees))
            if isinstance(degrees, (int, float))
            else tuple(float(d) for d in degrees)
        )
        self.translate = tuple(translate) if isinstance(translate, (list, tuple)) else None
        self.scale = tuple(scale) if isinstance(scale, (list, tuple)) else None
        if isinstance(shear, (int, float)):
            self.shear = (-float(shear), float(shear), 0.0, 0.0) if shear else (0.0, 0.0, 0.0, 0.0)
        elif len(shear) == 2:
            self.shear = (float(shear[0]), float(shear[1]), 0.0, 0.0)
        else:
            self.shear = tuple(float(s) for s in shear)
        self.fill = fill
        self.center = tuple(center) if center is not None else None

    def __call__(self, img):
        img = _to_pil(img)
        w, h = img.size
        r = rng()
        angle = r.uniform(*self.degrees)
        if self.translate is not None:
            max_dx, max_dy = self.translate[0] * w, self.translate[1] * h
            translate = (int(round(r.uniform(-max_dx, max_dx))), int(round(r.uniform(-max_dy, max_dy))))
        else:
            translate = (0, 0)
        scale = r.uniform(*self.scale) if self.scale is not None else 1.0
        shear = (r.uniform(self.shear[0], self.shear[1]), r.uniform(self.shear[2], self.shear[3]))
        return _pil_affine(img, angle, translate, scale, shear, fill=self.fill, center=self.center)


@AUG_METHODS.register(name="centercrop_resize")
class CenterCropAndResize(Transform):
    """Center-crop to ``center_size`` then resize to ``re_size`` (reference
    transforms.py:164-168, :503-504)."""

    name = "centercrop_resize"

    def __init__(self, center_size, re_size):
        self.center = CenterCrop(center_size)
        self.resize = Resize(re_size)
        self.size = re_size  # SPATIAL_TRANSFORMS contract (progressive resize)

    def __call__(self, img):
        return self.resize(self.center(img))


@AUG_METHODS.register(name="pad2square")
class Pad2Square(Transform):
    """Pad to a square of the max side with a solid ``pad_value`` color
    (reference PadIfNeed, transforms.py:207-227): mode='average' centers the
    image, mode='edge' pastes it at the bottom-right (fill one side)."""

    name = "pad2square"

    def __init__(self, pad_value: Union[int, Sequence[int]] = 0, mode: str = "average"):
        if isinstance(pad_value, int):
            pad_value = (pad_value, pad_value, pad_value)
        if len(pad_value) != 3:
            raise ValueError("pad_value must be an int or a 3-sequence")
        if mode not in ("edge", "average"):
            raise ValueError("mode can only be 'edge' [fill one side] or 'average' [fill both sides]")
        self.pad_value = tuple(pad_value)
        self.mode = mode

    def __call__(self, img):
        img = _to_pil(img)
        w, h = img.size
        m = max(w, h)
        canvas = Image.new("RGB", (m, m), self.pad_value)
        if self.mode == "average":
            canvas.paste(img, ((m - w) // 2, (m - h) // 2))
        else:
            canvas.paste(img, (m - w, m - h))
        return canvas


# ---------------------------------------------------------------- photometric


@AUG_METHODS.register(name="random_color_jitter")
class RandomColorJitter(Transform):
    name = "random_color_jitter"

    def __init__(self, brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0,
                 p: float = 1.0, prob: Optional[float] = None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        # reference spells the gate 'prob' (transforms.py:447-449)
        self.p = p if prob is None else prob

    @staticmethod
    def _factor(v):
        return rng().uniform(max(0.0, 1.0 - v), 1.0 + v)

    def __call__(self, img):
        img = _to_pil(img)
        if rng().random() > self.p:
            return img
        ops = []
        if self.brightness:
            ops.append(lambda im: ImageEnhance.Brightness(im).enhance(self._factor(self.brightness)))
        if self.contrast:
            ops.append(lambda im: ImageEnhance.Contrast(im).enhance(self._factor(self.contrast)))
        if self.saturation:
            ops.append(lambda im: ImageEnhance.Color(im).enhance(self._factor(self.saturation)))
        if self.hue:
            def _hue(im):
                h = rng().uniform(-self.hue, self.hue)
                hsv = np.array(im.convert("HSV"), dtype=np.int16)
                hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
                return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
            ops.append(_hue)
        rng().shuffle(ops)
        for op in ops:
            img = op(img)
        return img


@AUG_METHODS.register(name="random_gaussianblur")
class RandomGaussianBlur(Transform):
    """torchvision semantics (reference transforms.py:511-513:
    RandomApply([GaussianBlur(kernel_size, sigma)], p=prob)): with prob,
    draw sigma ~ U(sigma[0], sigma[1]) (or use a fixed scalar sigma) and blur.
    PIL's GaussianBlur radius IS the standard deviation, so radius=sigma;
    kernel_size only truncates the torchvision kernel and is immaterial for
    kernel_size ≥ 4·sigma+1 (pinned by tests/test_transform_registry.py).
    ``p`` is a legacy alias for ``prob``."""

    name = "random_gaussianblur"

    def __init__(
        self,
        prob: float = 0.5,
        kernel_size: int = 3,
        sigma=(0.1, 2.0),
        p: Optional[float] = None,
    ):
        self.prob = prob if p is None else p
        self.kernel_size = kernel_size
        self.sigma = sigma

    def __call__(self, img):
        img = _to_pil(img)
        if rng().random() >= self.prob:
            return img
        if isinstance(self.sigma, (list, tuple)):
            sigma = rng().uniform(float(self.sigma[0]), float(self.sigma[1]))
        else:
            sigma = float(self.sigma)
        return img.filter(ImageFilter.GaussianBlur(radius=sigma))


@AUG_METHODS.register(name="random_autocontrast")
class RandomAutocontrast(Transform):
    name = "random_autocontrast"

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        img = _to_pil(img)
        return ImageOps.autocontrast(img) if rng().random() < self.p else img


@AUG_METHODS.register(name="random_adjustsharpness")
class RandomAdjustSharpness(Transform):
    name = "random_adjustsharpness"

    def __init__(self, sharpness_factor: float = 2.0, p: float = 0.5):
        self.factor = sharpness_factor
        self.p = p

    def __call__(self, img):
        img = _to_pil(img)
        if rng().random() < self.p:
            return ImageEnhance.Sharpness(img).enhance(self.factor)
        return img


@AUG_METHODS.register(name="random_equalize")
class RandomEqualize(Transform):
    name = "random_equalize"

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        img = _to_pil(img)
        return ImageOps.equalize(img) if rng().random() < self.p else img


@AUG_METHODS.register(name="random_invert")
class RandomInvert(Transform):
    """Invert colors with prob p (reference transforms.py:431-433)."""

    name = "random_invert"

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img):
        img = _to_pil(img)
        return ImageOps.invert(img.convert("RGB")) if rng().random() < self.p else img


@AUG_METHODS.register(name="color_jitter")
class ColorJitter(RandomColorJitter):
    """Always-applied ColorJitter (reference transforms.py:416-421 — the
    deterministic registry variant; factors are still drawn per call)."""

    name = "color_jitter"

    def __init__(self, brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1):
        super().__init__(brightness, contrast, saturation, hue, p=1.0)


@AUG_METHODS.register(name="random_grayscale")
class RandomGrayscale(Transform):
    name = "random_grayscale"

    def __init__(self, p: float = 0.1):
        self.p = p

    def __call__(self, img):
        img = _to_pil(img)
        if rng().random() < self.p:
            return img.convert("L").convert("RGB")
        return img


@AUG_METHODS.register(name="random_augmix")
class RandomAugMix(Transform):
    """AugMix-style mixing of short augmentation chains (severity-scaled),
    matching the reference's use of torchvision AugMix at a given severity."""

    name = "random_augmix"

    def __init__(self, severity: int = 3, width: int = 3, alpha: float = 1.0):
        self.severity = severity
        self.width = width
        self.alpha = alpha

    def _op(self, img):
        s = self.severity
        choice = rng().randrange(6)
        if choice == 0:
            return ImageOps.autocontrast(img)
        if choice == 1:
            return ImageOps.equalize(img)
        if choice == 2:
            return ImageOps.posterize(img, max(8 - s, 1))
        if choice == 3:
            return img.rotate(rng().uniform(-3 * s, 3 * s), Image.BILINEAR)
        if choice == 4:
            return ImageOps.solarize(img, 256 - 26 * s)
        return ImageEnhance.Sharpness(img).enhance(rng().uniform(0.1, 1.9))

    def __call__(self, img):
        img = _to_pil(img)
        ws = np_rng().dirichlet([self.alpha] * self.width)
        m = np_rng().beta(self.alpha, self.alpha)
        mix = np.zeros(np.array(img).shape, dtype=np.float32)
        for i in range(self.width):
            aug = img
            for _ in range(rng().randint(1, 3)):
                aug = self._op(aug)
            mix += ws[i] * np.asarray(aug, dtype=np.float32)
        out = (1 - m) * np.asarray(img, dtype=np.float32) + m * mix
        return Image.fromarray(np.clip(out, 0, 255).astype(np.uint8))


@AUG_METHODS.register(name="random_augment")
class RandAugment(Transform):
    """RandAugment with torchvision's augmentation space (reference
    transforms.py:479-481 wraps T.RandAugment): num_ops ops drawn uniformly
    from 14, each at strength ``magnitude`` of ``num_magnitude_bins`` with a
    random sign. Geometric ops ride the same inverse-affine math torchvision
    uses (NEAREST interpolation, like torchvision's default)."""

    name = "random_augment"

    _OPS = (
        "Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
        "Brightness", "Color", "Contrast", "Sharpness", "Posterize",
        "Solarize", "AutoContrast", "Equalize",
    )

    def __init__(self, num_ops: int = 2, magnitude: int = 9, num_magnitude_bins: int = 31):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.bins = num_magnitude_bins

    def _magnitude(self, op: str, w: int, h: int) -> float:
        t = self.magnitude / (self.bins - 1)
        if op in ("ShearX", "ShearY"):
            return 0.3 * t
        if op == "TranslateX":
            return 150.0 / 331.0 * w * t
        if op == "TranslateY":
            return 150.0 / 331.0 * h * t
        if op == "Rotate":
            return 30.0 * t
        if op in ("Brightness", "Color", "Contrast", "Sharpness"):
            return 0.9 * t
        if op == "Posterize":
            return 8 - int(round(self.magnitude / ((self.bins - 1) / 4)))
        if op == "Solarize":
            return 255.0 * (1.0 - t)
        return 0.0

    def _apply(self, img, op: str, mag: float):
        import math

        if op == "Identity":
            return img
        if op == "ShearX":
            return _pil_affine(img, shear=(math.degrees(math.atan(mag)), 0.0),
                               interpolation=Image.NEAREST, center=(0, 0))
        if op == "ShearY":
            return _pil_affine(img, shear=(0.0, math.degrees(math.atan(mag))),
                               interpolation=Image.NEAREST, center=(0, 0))
        if op == "TranslateX":
            return _pil_affine(img, translate=(int(round(mag)), 0), interpolation=Image.NEAREST)
        if op == "TranslateY":
            return _pil_affine(img, translate=(0, int(round(mag))), interpolation=Image.NEAREST)
        if op == "Rotate":
            return img.rotate(mag, Image.NEAREST)
        if op == "Brightness":
            return ImageEnhance.Brightness(img).enhance(1.0 + mag)
        if op == "Color":
            return ImageEnhance.Color(img).enhance(1.0 + mag)
        if op == "Contrast":
            return ImageEnhance.Contrast(img).enhance(1.0 + mag)
        if op == "Sharpness":
            return ImageEnhance.Sharpness(img).enhance(1.0 + mag)
        if op == "Posterize":
            return ImageOps.posterize(img, int(mag))
        if op == "Solarize":
            return ImageOps.solarize(img, int(mag))
        if op == "AutoContrast":
            return ImageOps.autocontrast(img)
        return ImageOps.equalize(img)

    def __call__(self, img):
        img = _to_pil(img).convert("RGB")
        w, h = img.size
        r = rng()
        for _ in range(self.num_ops):
            op = self._OPS[r.randrange(len(self._OPS))]
            mag = self._magnitude(op, w, h)
            if op in ("ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
                      "Brightness", "Color", "Contrast", "Sharpness") and r.random() < 0.5:
                mag = -mag
            img = self._apply(img, op, mag)
        return img


# ---------------------------------------------------------------- occlusion


@AUG_METHODS.register(name="random_cutout")
class Cutout(Transform):
    """n_holes rectangular cutouts (width jittered by ±``ratio``), each hole a
    solid RGB color with per-channel value drawn from the ``color`` range,
    centers drawn from ``h_range``/``w_range`` (reference transforms.py:63-109
    exactly: mask is length×(U(1−r,1+r)·length), pasted at center−length//2)."""

    name = "random_cutout"

    def __init__(
        self,
        n_holes: int = 1,
        length: int = 200,
        ratio: float = 0.2,
        h_range: Optional[Sequence[int]] = None,
        w_range: Optional[Sequence[int]] = None,
        prob: float = 0.5,
        color: Sequence[int] = (0, 0),
    ):
        self.n_holes = n_holes
        self.length = length
        self.ratio = ratio
        self.h_range = h_range
        self.w_range = w_range
        self.prob = prob
        self.color = tuple(color)

    def __call__(self, img):
        img = _to_pil(img)
        if rng().random() > self.prob:
            return img
        arr = np.array(img)
        h, w = arr.shape[:2]
        h_range = self.h_range if self.h_range is not None else (0, h)
        w_range = self.w_range if self.w_range is not None else (0, w)
        mask_w = int(rng().uniform(1 - self.ratio, 1 + self.ratio) * self.length)
        mask_h = self.length
        for _ in range(self.n_holes):
            fill = tuple(rng().randint(self.color[0], self.color[1]) for _ in range(3))
            y = int(np_rng().integers(*h_range))
            x = int(np_rng().integers(*w_range))
            x1 = max(0, x - self.length // 2)
            y1 = max(0, y - self.length // 2)
            region = arr[y1 : y1 + mask_h, x1 : x1 + mask_w]
            region[...] = np.asarray(fill[: arr.shape[2]] if arr.ndim == 3 else fill[0], arr.dtype)
        return Image.fromarray(arr)


@AUG_METHODS.register(name="random_cutaddnoise")
class CutAddNoise(Transform):
    """Paste noise patches cropped from a random real image in ``noisy_src``
    (a directory of .jpg, reference transforms.py:111-162); without a source
    directory, synthesized uniform noise is used instead (our extension —
    the reference crashes on noisy_src=None)."""

    name = "random_cutaddnoise"

    def __init__(
        self,
        n_holes: int = 1,
        length: int = 200,
        noisy_src: Optional[str] = None,
        h_range: Optional[Sequence[int]] = None,
        w_range: Optional[Sequence[int]] = None,
        prob: float = 0.5,
    ):
        self.n_holes = n_holes
        self.length = length
        self.h_range = h_range
        self.w_range = w_range
        self.prob = prob
        if noisy_src:
            import glob

            self.noisy = sorted(glob.glob(f"{noisy_src}/*.jpg"))
            if not self.noisy:
                raise ValueError(f"random_cutaddnoise: no .jpg under {noisy_src!r}")
        else:
            self.noisy = None

    def __call__(self, img):
        img = _to_pil(img)
        if rng().random() > self.prob:
            return img
        arr = np.array(img)
        h, w = arr.shape[:2]
        h_range = self.h_range if self.h_range is not None else (0, h)
        w_range = self.w_range if self.w_range is not None else (0, w)
        if self.noisy is not None:
            noisy = Image.open(rng().choice(self.noisy)).convert("RGB").resize((w, h))
            noisy_arr = np.array(noisy)
        else:
            noisy_arr = np_rng().integers(0, 256, size=arr.shape, dtype=np.uint8)
        for _ in range(self.n_holes):
            y = int(np_rng().integers(*h_range))
            x = int(np_rng().integers(*w_range))
            x1, y1 = max(0, x - self.length // 2), max(0, y - self.length // 2)
            x2 = min(w, x + self.length // 2)
            y2 = min(h, y + self.length // 2)
            arr[y1:y2, x1:x2] = noisy_arr[y1:y2, x1:x2]
        return Image.fromarray(arr)


@AUG_METHODS.register(name="random_localgaussian")
class LocalGaussian(Transform):
    """Blur a random local region and blend it back with a square-or-ellipse
    feathered mask (reference transforms.py:248-314: cv2.GaussianBlur(ksize)
    + seamlessClone — the feathered alpha blend approximates the seamless
    boundary without an OpenCV dependency). Region size defaults to the
    reference's [side/5, 3·side/10] range; ``h_range``/``w_range`` constrain
    the center like the reference's valid ranges.

    ``radius``/``length`` are accepted as legacy aliases (pre-round-4
    signature): radius → blur sigma, length → fixed region size.
    """

    name = "random_localgaussian"

    def __init__(
        self,
        prob: float = 0.5,
        ksize: Sequence[int] = (7, 7),
        h_range: Optional[Sequence[int]] = None,
        w_range: Optional[Sequence[int]] = None,
        radius: Optional[float] = None,
        length: Optional[int] = None,
    ):
        self.prob = prob
        self.k = int(ksize[0] if isinstance(ksize, (list, tuple)) else ksize)
        # OpenCV's sigma for sigmaX=0: 0.3·((k−1)/2 − 1) + 0.8
        self.sigma = radius if radius is not None else 0.3 * ((self.k - 1) * 0.5 - 1) + 0.8
        self.h_range = h_range
        self.w_range = w_range
        self.length = length

    def _region(self, w: int, h: int) -> Tuple[int, int, int, int]:
        vw = self.w_range if self.w_range is not None else (0, w)
        vh = self.h_range if self.h_range is not None else (0, h)
        for _ in range(100):
            x = rng().randint(*vw)
            y = rng().randint(*vh)
            if self.length is not None:
                rh = rw = self.length
            else:
                rh = rng().randint(h // 5, max(h // 10 * 3, h // 5 + 1))
                rw = rng().randint(w // 5, max(w // 10 * 3, w // 5 + 1))
            if x + rw <= vw[1] and y + rh <= vh[1]:
                return x, y, rw, rh
        return 0, 0, max(w // 5, 1), max(h // 5, 1)

    def __call__(self, img):
        img = _to_pil(img)
        if rng().random() >= self.prob:
            return img
        w, h = img.size
        x, y, rw, rh = self._region(w, h)
        x, y = min(x, w - rw), min(y, h - rh)
        square = rng().random() < 0.5  # reference generate_seamless_mask
        try:
            import cv2

            arr = np.asarray(img.convert("RGB"))
            blur = cv2.GaussianBlur(arr, (self.k, self.k), sigmaX=0)
            roi = blur[y : y + rh, x : x + rw]
            mask = np.zeros(roi.shape[:2], np.uint8)
            if square:
                mask.fill(255)
            else:
                cv2.ellipse(mask, (rw // 2, rh // 2), (rw // 2, rh // 2), 0, 0, 360, 255, -1)
            try:
                merged = cv2.seamlessClone(
                    roi, arr, mask, p=(x + rw // 2, y + rh // 2), flags=cv2.NORMAL_CLONE
                )
            except cv2.error:
                return img
            return Image.fromarray(merged)
        except ImportError:
            pass
        # PIL fallback: feathered alpha blend approximates the seamless boundary
        blurred = img.filter(ImageFilter.GaussianBlur(self.sigma))
        mask = Image.new("L", (rw, rh), 0)
        from PIL import ImageDraw

        draw = ImageDraw.Draw(mask)
        if square:
            draw.rectangle((0, 0, rw - 1, rh - 1), fill=255)
        else:
            draw.ellipse((0, 0, rw - 1, rh - 1), fill=255)
        mask = mask.filter(ImageFilter.GaussianBlur(max(min(rw, rh) // 8, 1)))
        out = img.copy()
        out.paste(blurred.crop((x, y, x + rw, y + rh)), (x, y), mask)
        return out


# ---------------------------------------------------------------- terminal markers


@AUG_METHODS.register(name="to_tensor")
class ToTensor(Transform):
    """PIL → HWC uint8 ndarray. (The /255 conversion happens on device.)"""

    name = "to_tensor"

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, img):
        arr = np.asarray(_to_pil(img).convert("RGB"), dtype=np.uint8)
        return arr


@AUG_METHODS.register(name="to_tensor_without_div")
class ToTensorNoDiv(Transform):
    """PIL → HWC float32 WITHOUT the /255 (reference PILToTensorNoDiv,
    transforms.py:181-186, :470-472). Emitting float32 here makes the device
    stage skip its uint8 /255 (engine/steps.device_preprocess divides only
    uint8 inputs), reproducing the reference's 0..255-scale normalize."""

    name = "to_tensor_without_div"

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, img):
        return np.asarray(_to_pil(img).convert("RGB"), dtype=np.float32)


@AUG_METHODS.register(name="normalize")
class Normalize(Transform):
    """Marker: records mean/std for the fused device preprocessing stage.
    Host pass-through."""

    name = "normalize"

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self.mean = tuple(mean)
        self.std = tuple(std)

    def __call__(self, img):
        return img


# ---------------------------------------------------------------- compiler


def _build_one(name: str, params: Any) -> Callable:
    if name == "random_choice":
        inner = [
            _build_one(*next(iter(t.items()))) for t in params["transforms"]
        ]
        return RandomChoice(inner, p=params.get("p"))
    if params in (None, "no_params"):
        return AUG_METHODS.create(name)
    if isinstance(params, dict):
        return AUG_METHODS.create(name, **params)
    if isinstance(params, (list, tuple)):
        return AUG_METHODS.create(name, *params)
    return AUG_METHODS.create(name, params)


def create_aug_transforms(augment_cfg: List[Dict[str, Any]]) -> Compose:
    """Compile the nested YAML augment spec (incl. nested random_choice trees)
    into a Compose (reference create_AugTransforms, transforms.py:530-557)."""
    out = []
    for item in augment_cfg or []:
        if isinstance(item, str):
            out.append(_build_one(item, None))
        else:
            (name, params), = item.items()
            out.append(_build_one(name, params))
    return Compose(out)


def extract_normalization(pipeline: Compose) -> Tuple[Tuple[float, ...], Tuple[float, ...]]:
    """Find the Normalize marker's constants (identity if absent)."""
    for t in pipeline.transforms:
        if isinstance(t, Normalize):
            return t.mean, t.std
        if isinstance(t, RandomChoice):
            for inner in t.transforms:
                if isinstance(inner, Normalize):
                    return inner.mean, inner.std
    return (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)


def is_plain_letterbox(pipeline: Compose) -> Optional[int]:
    """If the pipeline is deterministic letterbox-to-square (+ to_tensor /
    normalize markers only), return its size — the native C++ decode path can
    then take over the whole host stage. Otherwise None."""
    size = None
    for t in getattr(pipeline, "transforms", []):
        if isinstance(t, ResizeAndPadding2Square):
            size = t.size
        elif isinstance(t, (ToTensor, Normalize)):
            continue
        else:
            return None
    return size


def native_train_stage(pipeline: Compose):
    """Classify a (post device-augment-split) host train pipeline for the
    native C++ decode pool. Returns ``("letterbox", size)`` for a plain
    letterbox stage, ``("rrc", op)`` when the stage is exactly one
    RandomResizedCrop, or ``("choice", op)`` when it is one RandomChoice
    whose branches are all letterbox / RandomResizedCrop of one common size
    (the reference pet.yaml geometry block, configs/classification/
    pet.yaml:56-64) — the per-sample branch + crop rect are then drawn
    host-side from the sample's RNG stream and executed in C++. Markers
    (to_tensor / normalize) are ignored throughout; anything else → None."""
    size = is_plain_letterbox(pipeline)
    if size is not None:
        return ("letterbox", size)
    op = None
    for t in getattr(pipeline, "transforms", []):
        if isinstance(t, (RandomResizedCrop, RandomChoice)):
            if op is not None:
                return None
            op = t
        elif isinstance(t, (ToTensor, Normalize)):
            continue
        else:
            return None
    if op is None:
        return None
    if isinstance(op, RandomResizedCrop):
        return ("rrc", op)
    sizes = set()
    for t in op.transforms:
        if isinstance(t, (RandomResizedCrop, ResizeAndPadding2Square)):
            sizes.add(t.size)
        else:
            return None
    return ("choice", op) if len(sizes) == 1 else None


def sample_native_geometry(stage_op, w: int, h: int):
    """Draw one sample's native geometry op row ``(mode, a, b, c, d)`` for
    ``native_train_stage``'s "rrc"/"choice" ops, consuming the sample's
    seeded RNG stream exactly as the PIL ``__call__`` path would (the caller
    must ``seed_sample(...)`` first). Mode 0 = letterbox, 1 = crop+resize."""
    op = stage_op
    if isinstance(op, RandomChoice):
        # the PIL path's own draw: one random() per choices(k=1) call
        op = rng().choices(op.transforms, weights=op.p, k=1)[0]
    if isinstance(op, ResizeAndPadding2Square):
        return (0, 0, 0, 0, 0)
    p = op.sample_params(w, h)
    if p[0] == "letterbox":  # the RRC AR>1.5 guard
        return (0, 0, 0, 0, 0)
    return (1, p[1], p[2], p[3], p[4])


def set_pipeline_size(pipeline: Compose, size: int) -> Compose:
    """Progressive learning: rewrite all spatial sizes in a compiled pipeline
    (reference auto_prog/create_AugSequence, vision_engine.py:181-222)."""

    def _walk(ts):
        for t in ts:
            if isinstance(t, (RandomChoice, Compose)):
                _walk(t.transforms)
            elif isinstance(t, (Resize, ResizeAndPadding2Square, RandomResizedCrop)):
                t.size = size
                if isinstance(t, RandomResizedCrop):
                    t.resize_and_padding.size = size
            elif isinstance(t, CenterCropAndResize):
                t.size = size
                t.resize.size = size
            elif isinstance(t, (CenterCrop, RandomCrop, PadIfNeed)):
                t.size = (size, size)

    _walk(pipeline.transforms)
    return pipeline
