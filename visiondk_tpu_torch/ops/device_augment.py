"""The device-augment stage (counterpart of ``visiondk_tpu/ops/device_augment.py``).

The host pipeline keeps decode and the geometry to the static size; the
per-pixel random ops of a train pipeline (flips, colour jitter, cutout, blur,
rotate, RandAugment, AugMix, ...) run on the uint8 batch on the model's
device, inside the train step, ahead of normalisation.

Semantics, as in the JAX package:

- Each op reproduces its host/PIL counterpart's math given the same draw (PIL
  integer luma, Blend truncation, the autocontrast and equalize LUTs, the HSV
  round trip, inverse-affine sampling at pixel centres): bit for bit where the
  math is integral, to ±1 LSB on ≥ 99% of pixels where a float product is
  floored (blends, hue, blur, bilinear taps).
- ``split_device_pipeline`` lifts the photometric, occlusion and flip ops past
  the final host geometry op: they run on the post-resize batch (a cutout's
  ``length`` counts post-resize pixels).
- PIL quantises to uint8 after every op; so does every op here (each returns
  integral float32 values in [0, 255]).

How the stage runs on the card: every op is compiled into a draw and an apply
(``Op``). ``draw(gen, n, h, w)`` makes every random choice and parameter for
n samples on the host, with a ``numpy.random.Generator`` (the affine matrices
and blur kernels too); ``apply(imgs, params)`` does the pixel work on the
batch's device. So the stage reads nothing back from the device: branch
choices (``random_choice``, the gates, AugMix's chains, RandAugment's ops) are
known on the host, and each branch runs on the gathered samples that drew it
and is scattered back with ``index_copy_`` on disjoint rows. No branch runs on
a sample that did not draw it, and no op uses a float atomic, so a seed gives
the same batch on every run. Functions take a batch ``[N, H, W, C]`` of
float32 values and per-sample parameters as ``[N]`` tensors.

The JAX package draws branch choices once per group of ``group_size``
samples (its default 8) because its ``vmap(lax.switch)`` runs every branch;
the port draws every branch per sample (the reference's semantics, the JAX
package's ``group_size: 1``) whatever ``group_size`` says. Its
``affine_transform_group`` (a TPU gather workaround) has no counterpart:
a per-sample gather is cheap on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Op:
    """A compiled augment op: ``draw(gen, n, h, w) -> params`` on the host,
    ``apply(imgs, params) -> imgs`` on the batch's device."""

    draw: Callable[[np.random.Generator, int, int, int], Any]
    apply: Callable[[Tensor, Any], Tensor]


class _NotLiftable(Exception):
    """Raised by a compiler when the op's params make it host-only."""


# ------------------------------------------------------------ host → device


def _to(values, like: Tensor) -> Tensor:
    """A host array (numpy, a CPU tensor or a Python number) on ``like``'s
    device; floats as float32. The copy does not block the host on the device."""
    t = values if isinstance(values, Tensor) else torch.as_tensor(np.asarray(values))
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to(like.device, non_blocking=True)


def _per_sample(values, like: Tensor) -> Tensor:
    """A per-sample parameter ([N] or a scalar) shaped to broadcast over
    ``like``'s [N, ...] trailing dims."""
    t = _to(values, like)
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim())) if t.dim() else t


def _div(a, b) -> Tensor:
    """``a / b`` as one IEEE division on every device, either operand a
    Python number: PyTorch computes ``tensor / number`` on CUDA as a product
    with the number's reciprocal and ``number / tensor`` on every device as
    ``reciprocal(tensor) · number``, a second rounding that can move a floor."""
    like = a if isinstance(a, Tensor) else b
    if not isinstance(a, Tensor):
        a = torch.full((), a, dtype=like.dtype, device=like.device)
    if not isinstance(b, Tensor):
        b = torch.full((), b, dtype=like.dtype, device=like.device)
    return a / b


def _run_branches(imgs: Tensor, branch_of: np.ndarray, fns: Sequence[Callable]) -> Tensor:
    """Run branch ``b`` (``fns[b](sub_imgs, sel)``, ``sel`` the host indices of
    its samples) on the samples with ``branch_of == b``; other samples (-1)
    pass through. The partition is known on the host, so nothing is read
    back from the device; disjoint rows are written back with ``index_copy_``."""
    n = imgs.shape[0]
    out = None
    for b, fn in enumerate(fns):
        sel = np.flatnonzero(branch_of == b)
        if len(sel) == 0:
            continue
        if len(sel) == n:
            return fn(imgs, sel)
        if out is None:
            out = imgs.clone()
        idx = _to(sel, imgs)
        out.index_copy_(0, idx, fn(imgs.index_select(0, idx), sel))
    return imgs if out is None else out


# ============================================================== PIL primitives


def _pil_luma(img: Tensor) -> Tensor:
    """PIL RGB→L: (19595·R + 38470·G + 7471·B + 0x8000) >> 16 (exact in f32:
    every partial sum < 2^24)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return torch.floor(_div(19595.0 * r + 38470.0 * g + 7471.0 * b + 32768.0, 65536.0))


def _blend(degenerate: Tensor, img: Tensor, factor) -> Tensor:
    """PIL Image.blend / ImageEnhance: out = d + factor·(img−d), truncated to
    uint8 (Blend.c casts the float straight to UINT8) and clipped."""
    out = degenerate + _per_sample(factor, img) * (img - degenerate)
    return torch.clamp(torch.floor(out), 0.0, 255.0)


def adjust_brightness(img: Tensor, factor) -> Tensor:
    """ImageEnhance.Brightness: blend with black."""
    return _blend(torch.zeros_like(img), img, factor)


def adjust_saturation(img: Tensor, factor) -> Tensor:
    """ImageEnhance.Color: blend with L-grayscale."""
    return _blend(grayscale(img), img, factor)


def adjust_contrast(img: Tensor, factor) -> Tensor:
    """ImageEnhance.Contrast: blend with solid int(mean(L)+0.5) gray, the
    mean of each image from an integer-exact sum."""
    lum = _pil_luma(img)
    total = lum.to(torch.int64).sum(dim=(1, 2))
    mean = torch.floor(_div(total.to(torch.float32), float(lum.shape[1] * lum.shape[2])) + 0.5)
    return _blend(mean.reshape(-1, 1, 1, 1).expand_as(img), img, factor)


_SMOOTH_KERNEL = np.array([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]]) / 13.0


def _filter3x3(img: Tensor, kernel: np.ndarray) -> Tensor:
    """PIL ImageFilter 3×3: float accumulate, round-half-up, clip — and the
    1-pixel border is copied from the source unfiltered."""
    k = torch.as_tensor(kernel, dtype=torch.float32).tolist()
    h, w = img.shape[1:3]
    acc = None
    for dy in range(3):
        for dx in range(3):
            term = k[dy][dx] * img[:, dy:dy + h - 2, dx:dx + w - 2]
            acc = term if acc is None else acc + term
    out = img.clone()
    out[:, 1:h - 1, 1:w - 1] = torch.clamp(torch.floor(acc + 0.5), 0.0, 255.0)
    return out


def adjust_sharpness(img: Tensor, factor) -> Tensor:
    """ImageEnhance.Sharpness: blend with SMOOTH-filtered degenerate."""
    return _blend(_filter3x3(img, _SMOOTH_KERNEL), img, factor)


def autocontrast(img: Tensor) -> Tensor:
    """ImageOps.autocontrast(cutoff=0): per-image, per-channel LUT stretching
    [lo, hi] to [0, 255]; identity when hi ≤ lo."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = _div(255.0, torch.clamp_min(hi - lo, 1e-12))
    # PIL: int(ix*scale + offset). The JAX stage runs under jit, where XLA
    # fuses img·scale − lo·scale into one multiply-add: one rounding. In
    # float64 the product (8 × 24 bits) and the difference (a multiple of
    # 2^-23 below 2^17) are exact, so one rounding to float32 is that
    # multiply-add, on every device.
    out = (img.to(torch.float64) * scale.to(torch.float64) - (lo * scale).to(torch.float64)).to(torch.float32)
    out = torch.clamp(torch.floor(out), 0.0, 255.0)
    return torch.where(hi > lo, out, img)


def equalize(img: Tensor) -> Tensor:
    """ImageOps.equalize: per-image, per-channel histogram LUT
    ``lut[i] = (step//2 + Σ_{j<i} h[j]) // step`` with
    ``step = (N − h[last_present]) // 255``; identity when step == 0 or only
    one value is present. One integer histogram for all images and channels."""
    n, h, w, c = img.shape
    v = img.to(torch.int64).permute(0, 3, 1, 2).reshape(n * c, h * w)
    hist = torch.zeros((n * c, 256), dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, v, torch.ones_like(v))
    present = hist > 0
    levels = torch.arange(256, device=img.device).expand_as(hist)
    last = torch.where(present, levels, -1).amax(dim=1, keepdim=True)
    n_values = present.sum(dim=1, keepdim=True)
    step = (h * w - hist.gather(1, last.clamp_min(0))) // 255
    csum = torch.cumsum(hist, dim=1) - hist  # exclusive
    lut = torch.clamp((step // 2 + csum) // torch.clamp_min(step, 1), 0, 255)
    out = torch.where((step > 0) & (n_values > 1), lut.gather(1, v), v)
    return out.reshape(n, c, h, w).permute(0, 2, 3, 1).to(torch.float32)


def posterize(img: Tensor, bits: int) -> Tensor:
    mask = ~(2 ** (8 - int(bits)) - 1) & 0xFF
    return (img.to(torch.int32) & mask).to(torch.float32)


def solarize(img: Tensor, threshold) -> Tensor:
    return torch.where(img >= _per_sample(threshold, img), 255.0 - img, img)


def invert(img: Tensor) -> Tensor:
    return 255.0 - img


def grayscale(img: Tensor) -> Tensor:
    return _pil_luma(img)[..., None].expand_as(img)


# -------------------------------------------------------------------- HSV / hue


def _rgb_to_hsv(img: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """PIL Convert.c rgb2hsv (uint8 H/S/V): float ratios, (int) truncation."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(r, torch.maximum(g, b))
    minc = torch.minimum(r, torch.minimum(g, b))
    v = maxc
    cr = torch.clamp_min(maxc - minc, 1e-12)
    s = (maxc - minc) / torch.clamp_min(maxc, 1e-12)
    rc = (maxc - r) / cr
    gc = (maxc - g) / cr
    bc = (maxc - b) / cr
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(_div(h, 6.0) + 1.0, 1.0)
    uh = torch.clamp(torch.floor(h * 255.0), 0.0, 255.0)
    us = torch.clamp(torch.floor(s * 255.0), 0.0, 255.0)
    gray = maxc == minc
    return torch.where(gray, 0.0, uh), torch.where(gray, 0.0, us), v


def _select(conds: Sequence[Tensor], choices: Sequence[Tensor], default: Tensor) -> Tensor:
    """``jnp.select``: the choice of the first true condition, else ``default``."""
    out = default
    for cond, choice in zip(reversed(conds), reversed(choices)):
        out = torch.where(cond, choice, out)
    return out


def _hsv_to_rgb(uh: Tensor, us: Tensor, uv: Tensor) -> Tensor:
    """PIL Convert.c hsv2rgb: fh = h/255·6, i = floor(fh), p/q/t rounded
    half-up."""
    fh = _div(uh, 255.0) * 6.0
    i = torch.floor(fh)
    f = fh - i
    fs = _div(us, 255.0)
    p = torch.clamp(torch.floor(uv * (1.0 - fs) + 0.5), 0.0, 255.0)
    q = torch.clamp(torch.floor(uv * (1.0 - fs * f) + 0.5), 0.0, 255.0)
    t = torch.clamp(torch.floor(uv * (1.0 - fs * (1.0 - f)) + 0.5), 0.0, 255.0)
    idx = torch.remainder(i, 6.0)
    conds = [idx == k for k in range(5)]
    r = _select(conds, [uv, q, p, p, t], uv)
    g = _select(conds, [t, uv, uv, q, p], p)
    b = _select(conds, [p, p, t, uv, uv], q)
    rgb = torch.stack([r, g, b], dim=-1)
    return torch.where(us[..., None] == 0, uv[..., None].expand_as(rgb), rgb)


def adjust_hue(img: Tensor, shift_frac) -> Tensor:
    """Host RandomColorJitter hue op (data/transforms.py): PIL HSV round trip
    with ``H = (H + int(h·255)) % 256`` on int16 values."""
    uh, us, uv = _rgb_to_hsv(img)
    shift = torch.trunc(_per_sample(shift_frac, uh) * 255.0)  # python int() truncates toward 0
    uh = torch.remainder(uh + shift, 256.0)
    return _hsv_to_rgb(uh, us, uv)


# ------------------------------------------------------------------- geometry


def flip_h(img: Tensor) -> Tensor:
    return torch.flip(img, dims=(2,))


def flip_v(img: Tensor) -> Tensor:
    return torch.flip(img, dims=(1,))


def _reflect_index(i: np.ndarray, n: int) -> np.ndarray:
    """torchvision 'reflect' padding index (mirror without edge repeat)."""
    i = np.abs(i)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def gaussian_blur(img: Tensor, sigma, kernel_size: int) -> Tensor:
    """torchvision GaussianBlur math (the reference wraps
    T.GaussianBlur(kernel_size, sigma), dataset/transforms.py:511-513):
    truncated normalised gaussian kernel, per-sample sigma, separable (rows,
    then columns), reflect padding. The taps are computed where ``sigma``
    lies (on the host, for a compiled op's draw)."""
    half = int(kernel_size) // 2
    sigma = torch.as_tensor(sigma, dtype=torch.float32).reshape(-1, 1)
    d = torch.arange(-half, half + 1, dtype=torch.float32, device=sigma.device)
    kern = torch.exp(-0.5 * torch.square(d / torch.clamp_min(sigma, 1e-12)))
    kern = _to(kern / kern.sum(dim=1, keepdim=True), img)
    out = img
    for axis in (1, 2):
        n = img.shape[axis]
        idx = _reflect_index(np.arange(n)[:, None] + np.arange(-half, half + 1)[None, :], n)
        acc = None
        for j in range(2 * half + 1):
            term = _per_sample(kern[:, j], img) * out.index_select(axis, _to(idx[:, j], img))
            acc = term if acc is None else acc + term
        out = acc
    # torchvision runs on float then rounds back to uint8 on conversion
    return torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)


def _gather_pixels(img: Tensor, yi: Tensor, xi: Tensor) -> Tensor:
    """``img[n, yi[n], xi[n]]`` for per-sample pixel index maps [N, H, W]."""
    n, h, w, c = img.shape
    flat = (yi * w + xi).reshape(n, -1, 1).expand(-1, -1, c)
    return torch.gather(img.reshape(n, h * w, c), 1, flat).reshape(n, *yi.shape[1:], c)


def affine_transform(img: Tensor, matrix: Sequence, interpolation: str = "bilinear",
                     fill: float = 0.0) -> Tensor:
    """PIL Image.transform(AFFINE) sampling with a per-sample output→input
    ``matrix`` (a, b, c, d, e, f), each [N] or a scalar, evaluated at output
    centres (x+0.5, y+0.5); bilinear samples at (xin−0.5, yin−0.5) from 4
    clamped taps with ``fill`` outside; nearest truncates."""
    _, h, w, _ = img.shape
    a, b, c, d, e, f = (_per_sample(m, img[..., 0]) for m in matrix)
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] + 0.5
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] + 0.5
    xin = a * xx + b * yy + c
    yin = d * xx + e * yy + f
    inside = ((xin >= 0) & (xin < w) & (yin >= 0) & (yin < h))[..., None]
    if interpolation == "nearest":
        xi = torch.clamp(torch.floor(xin), 0, w - 1).to(torch.int64)
        yi = torch.clamp(torch.floor(yin), 0, h - 1).to(torch.int64)
        return torch.where(inside, _gather_pixels(img, yi, xi), fill)
    # PIL clamps edge taps (BILINEAR_BODY reuses the border row/col for
    # x==-1 / x==size-1), so no tap masking — the fill applies only where
    # the pre-shift coordinate is outside
    xf = xin - 0.5
    yf = yin - 0.5
    x0 = torch.floor(xf)
    y0 = torch.floor(yf)
    wx = xf - x0
    wy = yf - y0
    out = torch.zeros_like(img)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yi = torch.clamp(y0 + dy, 0, h - 1).to(torch.int64)
        xi = torch.clamp(x0 + dx, 0, w - 1).to(torch.int64)
        wgt = (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy)
        out = out + wgt[..., None] * _gather_pixels(img, yi, xi)
    out = torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)
    return torch.where(inside, out, fill)


def inverse_affine_matrix(size: Tuple[int, int], angle, translate=(0.0, 0.0), scale=1.0,
                          shear=(0.0, 0.0), center: Optional[Tuple[float, float]] = None) -> List[Tensor]:
    """transforms._inverse_affine_matrix (torchvision math) in float32:
    output→input coefficients for rotation about ``center`` + translate +
    scale + shear. Angles in degrees; every parameter may be a tensor of
    per-sample values (all on one device)."""
    h, w = size
    cx, cy = center if center is not None else (w * 0.5, h * 0.5)

    def as_f32(v):
        return torch.as_tensor(v, dtype=torch.float32)

    rot = torch.deg2rad(as_f32(angle))
    sx = torch.deg2rad(as_f32(shear[0]))
    sy = torch.deg2rad(as_f32(shear[1]))
    tx, ty, scale = as_f32(translate[0]), as_f32(translate[1]), as_f32(scale)

    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)

    m = [d / scale, -b / scale, as_f32(0.0), -c / scale, a / scale, as_f32(0.0)]
    m[2] = m[2] + m[0] * (-cx - tx) + m[1] * (-cy - ty) + cx
    m[5] = m[5] + m[3] * (-cx - tx) + m[4] * (-cy - ty) + cy
    return m


def rotate(img: Tensor, angle, interpolation: str = "bilinear") -> Tensor:
    """PIL Image.rotate(angle, expand=False): CCW rotation about the centre.
    PIL/torchvision rotate is the NEGATED angle in the inverse-affine
    convention (torchvision F.rotate passes -angle to
    _get_inverse_affine_matrix)."""
    m = inverse_affine_matrix(img.shape[1:3], -torch.as_tensor(angle, dtype=torch.float32))
    return affine_transform(img, m, interpolation)


def cutout_holes(img: Tensor, centers_yx, hole_h, hole_w, colors, length: int) -> Tensor:
    """Host Cutout geometry (data/transforms.py Cutout, reference
    transforms.py:63-109): top-left = max(0, centre − length//2), region
    [y1:y1+hole_h, x1:x1+hole_w] painted a solid colour (far edge clips).
    ``centers_yx`` [N, holes, 2], ``colors`` [N, holes, C], ``hole_h`` and
    ``hole_w`` [N] or scalars."""
    h, w = img.shape[1:3]
    centers, colors = _to(centers_yx, img), _to(colors, img)
    hole_h, hole_w = _per_sample(hole_h, img[..., 0]), _per_sample(hole_w, img[..., 0])
    ys = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    out = img
    for i in range(centers.shape[1]):
        y1 = torch.clamp_min(centers[:, i, 0] - length // 2, 0.0).reshape(-1, 1, 1)
        x1 = torch.clamp_min(centers[:, i, 1] - length // 2, 0.0).reshape(-1, 1, 1)
        mask = (ys >= y1) & (ys < y1 + hole_h) & (xs >= x1) & (xs < x1 + hole_w)
        out = torch.where(mask[..., None], colors[:, i, None, None, :], out)
    return out


def random_crop_static(img: Tensor, top, left, th: int, tw: int) -> Tensor:
    """Crop every sample to a static (th, tw) at its own offset (``top``,
    ``left``: [N] integers)."""
    top, left = _to(top, img).to(torch.int64), _to(left, img).to(torch.int64)
    yi = top[:, None, None] + torch.arange(th, device=img.device)[None, :, None]
    xi = left[:, None, None] + torch.arange(tw, device=img.device)[None, None, :]
    return _gather_pixels(img, yi.expand(-1, th, tw), xi.expand(-1, th, tw))


# ============================================================= op compilation
#
# Each compiler takes the YAML params of the same-named registry transform
# (data/transforms.py) and returns an Op; every per-sample draw is made for
# the n samples the op is applied to.


def _uniform(gen: np.random.Generator, lo: float, hi: float, shape) -> np.ndarray:
    return gen.uniform(lo, hi, shape).astype(np.float32)


def _deterministic(fn: Callable[[Tensor], Tensor]) -> Op:
    return Op(lambda gen, n, h, w: None, lambda imgs, params: fn(imgs))


def _gate(p: float, op: Op) -> Op:
    """Apply ``op`` with probability ``p`` per sample (host ops gate on
    rng().random()), on the samples that fire only."""
    if p >= 1.0:
        return op

    def draw(gen, n, h, w):
        fire = np.flatnonzero(gen.random(n) < p)
        return fire, op.draw(gen, len(fire), h, w)

    def apply(imgs, params):
        fire, inner = params
        branch_of = np.full(imgs.shape[0], -1)
        branch_of[fire] = 0
        return _run_branches(imgs, branch_of, [lambda sub, sel: op.apply(sub, inner)])

    return Op(draw, apply)


def _choice(ops: Sequence[Op], weights: Sequence[float]) -> Op:
    """One of ``ops`` per sample, drawn with ``weights``; each runs only on
    the samples that drew it."""
    prob = np.asarray(weights, np.float64)
    prob = prob / prob.sum()

    def draw(gen, n, h, w):
        idx = gen.choice(len(ops), size=n, p=prob)
        return idx, [op.draw(gen, int((idx == b).sum()), h, w) for b, op in enumerate(ops)]

    def apply(imgs, params):
        idx, inner = params
        return _run_branches(imgs, idx, [lambda sub, sel, op=op, p=p: op.apply(sub, p)
                                         for op, p in zip(ops, inner)])

    return Op(draw, apply)


def _c_random_horizonflip(p: float = 0.5) -> Op:
    return _gate(float(p), _deterministic(flip_h))


def _c_random_verticalflip(p: float = 0.5) -> Op:
    return _gate(float(p), _deterministic(flip_v))


def _c_random_double_flip(p: float = 0.5) -> Op:
    hf, vf = _c_random_horizonflip(p), _c_random_verticalflip(p)
    return Op(lambda gen, n, h, w: (hf.draw(gen, n, h, w), vf.draw(gen, n, h, w)),
              lambda imgs, params: vf.apply(hf.apply(imgs, params[0]), params[1]))


def _c_random_doubleflip(prob=0.5) -> Op:
    """Reference choose-one semantics: pick vflip(0.5) or hflip(0.5)."""
    p = tuple(prob) if isinstance(prob, (list, tuple)) else (prob, prob)
    return _gate(0.5, _choice([_deterministic(flip_v), _deterministic(flip_h)], [float(x) for x in p]))


def _c_random_invert(p: float = 0.5) -> Op:
    return _gate(float(p), _deterministic(invert))


def _c_random_grayscale(p: float = 0.1) -> Op:
    return _gate(float(p), _deterministic(grayscale))


def _c_random_autocontrast(p: float = 0.5) -> Op:
    return _gate(float(p), _deterministic(autocontrast))


def _c_random_equalize(p: float = 0.5) -> Op:
    return _gate(float(p), _deterministic(equalize))


def _c_random_adjustsharpness(sharpness_factor: float = 2.0, p: float = 0.5) -> Op:
    f = float(sharpness_factor)
    return _gate(float(p), _deterministic(lambda imgs: adjust_sharpness(imgs, f)))


_JITTER_OPS = {
    "brightness": adjust_brightness,
    "contrast": adjust_contrast,
    "saturation": adjust_saturation,
    "hue": adjust_hue,
}


def _c_color_jitter_core(brightness, contrast, saturation, hue) -> Op:
    """Shared body of [random_]color_jitter: factor ~ U(max(0,1−v), 1+v) per
    enabled component (hue: shift ~ U(−v, v)), applied in a random order per
    sample (the host shuffles its op list)."""
    enabled: List[Tuple[str, float]] = [
        (name, float(v)) for name, v in
        (("brightness", brightness), ("contrast", contrast), ("saturation", saturation), ("hue", hue)) if v
    ]
    if not enabled:
        return _deterministic(lambda imgs: imgs)

    def draw(gen, n, h, w):
        order = np.argsort(gen.random((n, len(enabled))), axis=1)
        factors = [_uniform(gen, -v, v, n) if name == "hue" else _uniform(gen, max(0.0, 1.0 - v), 1.0 + v, n)
                   for name, v in enabled]
        return order, factors

    def apply(imgs, params):
        order, factors = params
        for step in range(len(enabled)):
            imgs = _run_branches(imgs, order[:, step], [
                lambda sub, sel, fn=_JITTER_OPS[name], f=f: fn(sub, f[sel])
                for (name, _), f in zip(enabled, factors)
            ])
        return imgs

    return Op(draw, apply)


def _c_random_color_jitter(brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0, p: float = 1.0,
                           prob: Optional[float] = None) -> Op:
    gate_p = float(p if prob is None else prob)
    return _gate(gate_p, _c_color_jitter_core(brightness, contrast, saturation, hue))


def _c_color_jitter(brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1) -> Op:
    return _c_color_jitter_core(brightness, contrast, saturation, hue)


def _c_random_gaussianblur(prob: float = 0.5, kernel_size: int = 3, sigma=(0.1, 2.0),
                           p: Optional[float] = None) -> Op:
    gate_p = float(prob if p is None else p)
    k = int(kernel_size)
    ranged = isinstance(sigma, (list, tuple))
    lo, hi = (float(sigma[0]), float(sigma[1])) if ranged else (float(sigma), float(sigma))

    def draw(gen, n, h, w):
        return _uniform(gen, lo, hi, n) if ranged else np.full(n, lo, np.float32)

    return _gate(gate_p, Op(draw, lambda imgs, sigma: gaussian_blur(imgs, sigma, k)))


def _rotate_range(degrees) -> Tuple[float, float]:
    """Normalise the YAML ``degrees`` (scalar => symmetric range)."""
    if isinstance(degrees, (int, float)):
        return (-float(degrees), float(degrees))
    return (float(degrees[0]), float(degrees[1]))


def _affine_spec(degrees, translate, scale, shear, fill, center):
    """Normalise random_affine's params (torchvision conventions)."""
    deg = (
        (-float(degrees), float(degrees))
        if isinstance(degrees, (int, float))
        else tuple(float(d) for d in degrees)
    )
    trans = tuple(translate) if isinstance(translate, (list, tuple)) else None
    sc = tuple(scale) if isinstance(scale, (list, tuple)) else None
    if isinstance(shear, (int, float)):
        sh = (-float(shear), float(shear), 0.0, 0.0) if shear else (0.0, 0.0, 0.0, 0.0)
    elif len(shear) == 2:
        sh = (float(shear[0]), float(shear[1]), 0.0, 0.0)
    else:
        sh = tuple(float(s) for s in shear)
    fill_v = float(fill if isinstance(fill, (int, float)) else fill[0])
    ctr = tuple(center) if center is not None else None
    return deg, trans, sc, sh, fill_v, ctr


def _c_random_rotate(degrees=10.0, expand: bool = False) -> Op:
    if expand:
        raise _NotLiftable("random_rotate(expand=True) changes the output shape")
    lo, hi = _rotate_range(degrees)
    return Op(lambda gen, n, h, w: _uniform(gen, lo, hi, n), rotate)


def _c_random_affine(degrees=0.0, translate=0.0, scale=0.0, shear=0.0, fill=0, center=None) -> Op:
    deg, trans, sc, sh, fill_v, ctr = _affine_spec(degrees, translate, scale, shear, fill, center)

    def draw(gen, n, h, w):
        angle = _uniform(gen, deg[0], deg[1], n)
        if trans is not None:
            dx = np.floor(_uniform(gen, -trans[0] * w, trans[0] * w, n) + np.float32(0.5))
            dy = np.floor(_uniform(gen, -trans[1] * h, trans[1] * h, n) + np.float32(0.5))
        else:
            dx = dy = np.zeros(n, np.float32)
        scl = _uniform(gen, sc[0], sc[1], n) if sc is not None else np.ones(n, np.float32)
        return {"angle": angle, "translate": (dx, dy), "scale": scl,
                "shear": (_uniform(gen, sh[0], sh[1], n), _uniform(gen, sh[2], sh[3], n))}

    def apply(imgs, p):
        m = inverse_affine_matrix(imgs.shape[1:3], p["angle"], p["translate"], p["scale"], p["shear"], ctr)
        return affine_transform(imgs, m, "bilinear", fill_v)

    return Op(draw, apply)


def _hole_centers(gen, n, n_holes, h, w, h_range, w_range) -> np.ndarray:
    """Hole centres [n, holes, 2] (y, x), uniform over ``h_range`` × ``w_range``."""
    hr = tuple(h_range) if h_range is not None else (0, h)
    wr = tuple(w_range) if w_range is not None else (0, w)
    ys = gen.integers(hr[0], max(hr[1], hr[0] + 1), (n, n_holes))
    xs = gen.integers(wr[0], max(wr[1], wr[0] + 1), (n, n_holes))
    return np.stack([ys, xs], axis=-1).astype(np.float32)


def _c_random_cutout(n_holes: int = 1, length: int = 200, ratio: float = 0.2,
                     h_range: Optional[Sequence[int]] = None, w_range: Optional[Sequence[int]] = None,
                     prob: float = 0.5, color: Sequence[int] = (0, 0)) -> Op:
    n_holes, length, ratio = int(n_holes), int(length), float(ratio)
    c_lo, c_hi = int(color[0]), int(color[1])

    def draw(gen, n, h, w):
        # the mask width jittered once per sample (host: per __call__)
        mask_w = np.floor(_uniform(gen, 1.0 - ratio, 1.0 + ratio, n) * np.float32(length))
        # host: rng().randint(lo, hi) inclusive per channel per hole
        colors = gen.integers(c_lo, c_hi + 1, (n, n_holes, 3)).astype(np.float32)
        return _hole_centers(gen, n, n_holes, h, w, h_range, w_range), mask_w, colors

    def apply(imgs, params):
        centers, mask_w, colors = params
        return cutout_holes(imgs, centers, float(length), mask_w, colors[..., :imgs.shape[-1]], length)

    return _gate(float(prob), Op(draw, apply))


def _c_random_cutaddnoise(n_holes: int = 1, length: int = 200, noisy_src: Optional[str] = None,
                          h_range: Optional[Sequence[int]] = None, w_range: Optional[Sequence[int]] = None,
                          prob: float = 0.5) -> Op:
    """Holes of uniform uint8 noise. The noise [n, H, W, C] is drawn on the
    batch's device from a seed the host draws (``params["noise"]``, when
    given, replaces it: a check across devices passes it in)."""
    if noisy_src:
        raise _NotLiftable("random_cutaddnoise with noisy_src reads files (host-only)")
    n_holes, length = int(n_holes), int(length)

    def draw(gen, n, h, w):
        return {"centers": _hole_centers(gen, n, n_holes, h, w, h_range, w_range),
                "noise_seed": int(gen.integers(0, 2**62))}

    def apply(imgs, params):
        noise = params.get("noise")
        if noise is None:
            noise = cutaddnoise_noise(imgs, params["noise_seed"])
        noise = _to(noise, imgs)
        h, w = imgs.shape[1:3]
        centers = _to(params["centers"], imgs)
        ys = torch.arange(h, dtype=torch.float32, device=imgs.device)[:, None]
        xs = torch.arange(w, dtype=torch.float32, device=imgs.device)[None, :]
        out = imgs
        for i in range(n_holes):
            yc, xc = centers[:, i, 0].reshape(-1, 1, 1), centers[:, i, 1].reshape(-1, 1, 1)
            y1, x1 = torch.clamp_min(yc - length // 2, 0.0), torch.clamp_min(xc - length // 2, 0.0)
            y2, x2 = torch.clamp_max(yc + length // 2, float(h)), torch.clamp_max(xc + length // 2, float(w))
            mask = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
            out = torch.where(mask[..., None], noise, out)
        return out

    return _gate(float(prob), Op(draw, apply))


def cutaddnoise_noise(imgs: Tensor, seed: int) -> Tensor:
    """random_cutaddnoise's noise for ``imgs``: uniform integers in [0, 255]
    as float32, drawn on ``imgs``' device from ``seed``."""
    gen = torch.Generator(device=imgs.device).manual_seed(seed)
    return torch.randint(0, 256, imgs.shape, generator=gen, device=imgs.device).to(torch.float32)


def _c_random_crop(size) -> Op:
    th, tw = (int(size), int(size)) if isinstance(size, (int, float)) else (int(size[0]), int(size[1]))

    def draw(gen, n, h, w):
        return gen.integers(0, max(h - th, 0) + 1, n), gen.integers(0, max(w - tw, 0) + 1, n)

    return Op(draw, lambda imgs, p: random_crop_static(imgs, p[0], p[1], th, tw))


# ------------------------------------------------------------------ AugMix


def _c_random_augmix(severity: int = 3, width: int = 3, alpha: float = 1.0) -> Op:
    """Host RandomAugMix (data/transforms.py): ``width`` chains of 1–3 ops
    drawn per sample from {autocontrast, equalize, posterize, rotate,
    solarize, sharpness}, a Dirichlet-weighted sum, Beta-blended with the
    original. Each chain step runs each op on the samples that drew it."""
    s, width, alpha = int(severity), int(width), float(alpha)

    def draw(gen, n, h, w):
        shape = (n, width, 3)
        return {
            "ws": gen.dirichlet(np.full(width, alpha), size=n).astype(np.float32),
            "m": gen.beta(alpha, alpha, n).astype(np.float32),
            "depth": gen.integers(1, 4, (n, width)),  # host randint(1, 3) inclusive
            "op": gen.integers(0, 6, shape),
            "angle": _uniform(gen, -3.0 * s, 3.0 * s, shape),
            "sharpness": _uniform(gen, 0.1, 1.9, shape),
        }

    def apply(imgs, p):
        def branches(i, d):
            return [
                lambda sub, sel: autocontrast(sub),
                lambda sub, sel: equalize(sub),
                lambda sub, sel: posterize(sub, max(8 - s, 1)),
                lambda sub, sel: rotate(sub, p["angle"][sel, i, d]),
                lambda sub, sel: solarize(sub, float(256 - 26 * s)),
                lambda sub, sel: adjust_sharpness(sub, p["sharpness"][sel, i, d]),
            ]

        mix = torch.zeros_like(imgs)
        for i in range(width):
            aug = imgs
            for d in range(3):
                aug = _run_branches(aug, np.where(p["depth"][:, i] > d, p["op"][:, i, d], -1), branches(i, d))
            mix = mix + _per_sample(p["ws"][:, i], imgs) * aug
        m = _per_sample(p["m"], imgs)
        # host: np.clip(out, 0, 255).astype(np.uint8) — truncation
        return torch.floor(torch.clamp((1.0 - m) * imgs + m * mix, 0.0, 255.0))

    return Op(draw, apply)


# --------------------------------------------------------------- RandAugment


_RA_OPS = (
    "Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    "Brightness", "Color", "Contrast", "Sharpness", "Posterize",
    "Solarize", "AutoContrast", "Equalize",
)


def _c_random_augment(num_ops: int = 2, magnitude: int = 9, num_magnitude_bins: int = 31) -> Op:
    """RandAugment with torchvision's augmentation space (host RandAugment in
    data/transforms.py; reference transforms.py:479-481): ``num_ops`` ops
    drawn per sample, each with a per-sample sign. Geometric ops use NEAREST
    like torchvision's default; translate magnitudes count post-resize pixels."""
    num_ops, magnitude, bins = int(num_ops), int(magnitude), int(num_magnitude_bins)
    t = magnitude / (bins - 1)
    post_bits = 8 - int(round(magnitude / ((bins - 1) / 4)))
    mag_shear, mag_rot, mag_enh = 0.3 * t, 30.0 * t, 0.9 * t
    sol_thresh = float(int(255.0 * (1.0 - t)))

    def draw(gen, n, h, w):
        return {"op": gen.integers(0, len(_RA_OPS), (n, num_ops)), "negative": gen.random((n, num_ops)) < 0.5}

    def apply(imgs, p):
        h, w = imgs.shape[1:3]
        for k in range(num_ops):
            def signed(mag, sel):
                return torch.from_numpy(np.where(p["negative"][sel, k], np.float32(-mag), np.float32(mag)))

            def shear(axis):
                def op(sub, sel):
                    deg = torch.rad2deg(torch.atan(signed(mag_shear, sel)))
                    zero = torch.zeros_like(deg)
                    sh = (deg, zero) if axis == 0 else (zero, deg)
                    return affine_transform(sub, inverse_affine_matrix((h, w), 0.0, (0.0, 0.0), 1.0, sh, (0, 0)),
                                            "nearest")
                return op

            def translate(axis):
                def op(sub, sel):
                    m = torch.floor(signed(150.0 / 331.0 * (w if axis == 0 else h) * t, sel) + 0.5)
                    zero = torch.zeros_like(m)
                    tr = (m, zero) if axis == 0 else (zero, m)
                    return affine_transform(sub, inverse_affine_matrix((h, w), 0.0, tr, 1.0, (0.0, 0.0)), "nearest")
                return op

            def enhance(fn):
                return lambda sub, sel: fn(sub, 1.0 + signed(mag_enh, sel))

            imgs = _run_branches(imgs, p["op"][:, k], [
                lambda sub, sel: sub,  # Identity
                shear(0),
                shear(1),
                translate(0),
                translate(1),
                lambda sub, sel: rotate(sub, signed(mag_rot, sel), "nearest"),
                enhance(adjust_brightness),
                enhance(adjust_saturation),
                enhance(adjust_contrast),
                enhance(adjust_sharpness),
                lambda sub, sel: posterize(sub, max(post_bits, 0)),
                lambda sub, sel: solarize(sub, sol_thresh),
                lambda sub, sel: autocontrast(sub),
                lambda sub, sel: equalize(sub),
            ])
        return imgs

    return Op(draw, apply)


# ------------------------------------------------------------- the registry


_COMPILERS: Dict[str, Callable[..., Op]] = {
    "random_horizonflip": _c_random_horizonflip,
    "random_verticalflip": _c_random_verticalflip,
    "random_double_flip": _c_random_double_flip,
    "random_doubleflip": _c_random_doubleflip,
    "random_invert": _c_random_invert,
    "random_grayscale": _c_random_grayscale,
    "random_autocontrast": _c_random_autocontrast,
    "random_equalize": _c_random_equalize,
    "random_adjustsharpness": _c_random_adjustsharpness,
    "random_color_jitter": _c_random_color_jitter,
    "color_jitter": _c_color_jitter,
    "random_gaussianblur": _c_random_gaussianblur,
    "random_rotate": _c_random_rotate,
    "random_affine": _c_random_affine,
    "random_cutout": _c_random_cutout,
    "random_cutaddnoise": _c_random_cutaddnoise,
    "random_crop": _c_random_crop,
    "random_augmix": _c_random_augmix,
    "random_augment": _c_random_augment,
}


def _call_compiler(fn: Callable, params: Any) -> Op:
    """YAML params -> compiler call (``name: no_params``, ``name: {k: v}``,
    ``name: [a, b]`` and ``name: scalar`` all mean what they say)."""
    if params in (None, "no_params"):
        return fn()
    if isinstance(params, dict):
        return fn(**params)
    if isinstance(params, (list, tuple)):
        return fn(*params)
    return fn(params)


def _compile_one(name: str, params: Any) -> Op:
    if name == "random_choice":
        inner = [_compile_one(_item_name(t), _item_params(t)) for t in params["transforms"]]
        p = params.get("p")
        return _choice(inner, [1.0] * len(inner) if p is None else [float(x) for x in p])
    fn = _COMPILERS.get(name)
    if fn is None:
        raise _NotLiftable(f"{name} has no device implementation")
    return _call_compiler(fn, params)


# =============================================================== pipeline split


def _item_name(item) -> str:
    return item if isinstance(item, str) else next(iter(item.keys()))


def _item_params(item):
    return None if isinstance(item, str) else next(iter(item.values()))


def _is_marker(name: str) -> bool:
    return name in ("to_tensor", "to_tensor_without_div", "normalize")


def is_liftable(item) -> bool:
    """True when this YAML augment item compiles to a device op."""
    name = _item_name(item)
    if name == "random_choice":
        return all(is_liftable(t) for t in (_item_params(item) or {}).get("transforms", []))
    if name not in _COMPILERS:
        return False
    try:
        _compile_one(name, _item_params(item))
        return True
    except Exception:  # _NotLiftable, or params the compiler rejects
        return False


def split_device_pipeline(augment_cfg: List[Any]) -> Tuple[List[Any], List[Any]]:
    """Partition a train augment spec into (host_cfg, device_cfg).

    Liftable ops (photometric / occlusion / flips / device-expressible
    geometry jitters) move to the device stage IN THEIR ORIGINAL RELATIVE
    ORDER; everything else (decode-adjacent geometry to the static size,
    markers) stays on the host, also in order. Lifted ops that preceded the
    final geometry op now run after it (see the module docstring). Returns
    (augment_cfg, []) when nothing lifts.
    """
    # to_tensor_without_div pipelines feed float32 0..255 batches; the lifted
    # ops assume uint8 input, and a silent no-op there would drop every
    # lifted augment — keep the whole pipeline on the host instead.
    if any(_item_name(i) == "to_tensor_without_div" for i in augment_cfg or []):
        return list(augment_cfg or []), []
    host: List[Any] = []
    device: List[Any] = []
    for item in augment_cfg or []:
        if not _is_marker(_item_name(item)) and is_liftable(item):
            device.append(item)
        else:
            host.append(item)
    # a device stage with no host geometry cannot batch variable-size images
    host_has_spatial = any(not _is_marker(_item_name(i)) for i in host)
    if not device or not host_has_spatial:
        return list(augment_cfg or []), []
    return host, device


def make_device_augment(device_cfg: List[Any], group_size: Optional[int] = 8
                        ) -> Optional[Callable[[int, Tensor], Tensor]]:
    """Compile a lifted device spec into ``stage(seed, uint8 [B,H,W,3]) ->
    uint8 [B,H',W',3]`` on the batch's device (None for an empty spec).

    Op ``i`` draws from ``numpy.random.default_rng([seed, i])``, so adding or
    removing an op does not correlate the others' draws, and a seed gives the
    same batch on every run. Every branch choice is drawn per sample whatever
    ``group_size`` (the JAX package's per-group draw, ``data.train
    .device_augment_group_size``) says: the port's semantics are the JAX
    package's ``group_size: 1``. The result is ``clip(round(x))`` to uint8.
    Each call adds one to ``make_device_augment.calls``.
    """
    if not device_cfg:
        return None
    if group_size is not None and int(group_size) < 1:
        raise ValueError(f"device augment group_size must be ≥ 1 or None, got {group_size}")
    ops = [_compile_one(_item_name(i), _item_params(i)) for i in device_cfg]

    def stage(seed: int, images: Tensor) -> Tensor:
        if images.dtype != torch.uint8:
            # split_device_pipeline never lifts for non-uint8-producing host
            # pipelines (to_tensor_without_div); reaching here means a host
            # path fed the wrong dtype — failing loudly beats silently
            # skipping every lifted augment.
            raise TypeError(
                f"device augment stage expects a uint8 batch, got {images.dtype}; the host pipeline "
                f"that produced this batch should not have had its augments lifted"
            )
        make_device_augment.calls += 1
        x = images.to(torch.float32)
        for i, op in enumerate(ops):
            n, h, w = x.shape[:3]
            x = op.apply(x, op.draw(np.random.default_rng([int(seed), i]), n, h, w))
        return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)

    return stage


make_device_augment.calls = 0


def set_device_pipeline_size(device_cfg: List[Any], size: int) -> bool:
    """Progressive resolution for the LIFTED stage: rewrite static spatial
    sizes carried by device ops (today only ``random_crop``), mirroring what
    ``data.transforms.set_pipeline_size`` does to the host pipeline. Mutates
    ``device_cfg`` in place; returns True when anything changed (the caller
    must then rebuild the stage with ``make_device_augment``)."""
    changed = False

    def _walk(items: List[Any]) -> None:
        nonlocal changed
        for i, item in enumerate(items):
            name = _item_name(item)
            if name == "random_choice":
                _walk((_item_params(item) or {}).get("transforms", []))
            elif name == "random_crop":
                params = _item_params(item)
                if isinstance(params, dict):
                    if params.get("size") != size:
                        params["size"] = size
                        changed = True
                else:
                    items[i] = {"random_crop": {"size": size}}
                    changed = True

    _walk(device_cfg or [])
    return changed


def describe_split(host_cfg: List[Any], device_cfg: List[Any]) -> str:
    h = ", ".join(_item_name(i) for i in host_cfg) or "-"
    d = ", ".join(_item_name(i) for i in device_cfg) or "-"
    return f"host: [{h}] | device: [{d}]"
