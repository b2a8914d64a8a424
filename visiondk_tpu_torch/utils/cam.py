"""Class-activation maps on the port's models (counterpart of
``visiondk_tpu/utils/cam.py``).

The JAX module captures and injects activations with flax interceptors;
here forward hooks do it (a hook that returns a tensor replaces the module's
output), keyed by each module's flax path (the weight bridge's
``_path_mapper``), so target layers and FullGrad's layer set are named as in
the JAX package:

1. one forward records the target module's output (the feature map);
2. the gradient of the target-class score is taken with respect to an
   *injected* copy of that map: a hook returns it in place of the module's
   output, with ``requires_grad`` and grad mode on, the parameters frozen.
   The blocks after the target therefore run the attention kernels' stash
   forward and backward (K1s/K1b, K2s/K2b on the card); the ones before it
   run the plain forward kernels.

The methods are the JAX package's ten (``CAM_METHODS``): the gradient
methods take one capture and one injected backward; ``ablationcam`` and
``scorecam`` sweep the channels in chunks of 64, each chunk one batched
forward (JAX maps one variant at a time: the scores agree to f32 noise);
``fullgrad`` sums |bias × grad| over every convolution with a bias and every
BatchNorm with a 4-D output, plus the input term, with one backward through
zeros added to those outputs. The CAM arithmetic after the device work runs
in numpy, as in the JAX module. Every resize is ``resize_bilinear``:
``F.interpolate`` bilinear with ``antialias=True``, which is what
``jax.image.resize(..., "bilinear")`` computes (antialiased when it shrinks).

Port maps are put in JAX's layout before the arithmetic: a CNN's NCHW map
(``channels_last`` memory) becomes [H, W, C], a token map [N, C] stays.
"""

from __future__ import annotations

import contextlib
import re
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

CAM_METHODS = (
    "gradcam",
    "gradcampp",
    "xgradcam",
    "layercam",
    "hirescam",
    "eigencam",
    "eigengradcam",
    "ablationcam",   # O(C) forwards: per-channel ablation of the feature map
    "scorecam",      # O(C) forwards: activation-masked inputs
    "fullgrad",      # |bias × grad| over all conv/BN bias layers + input-grad
)
_PERTURB_METHODS = ("ablationcam", "scorecam")
_PERTURB_CHUNK = 64  # channels per batched forward in the O(C) sweeps

# Per-architecture target-layer regex over flax module paths (the JAX table).
# The *last* matching path in call order is used.
_TARGET_PATTERNS: Sequence[Tuple[str, str]] = (
    (r"^(resnet|resnext|resnest|seresnet|wide_resnet|legacy_seresnet)", r"stage4_block\d+$"),
    (r"^convnext", r"stage4_block\d+$"),
    (r"^(vit|deit)", r"block\d+/norm1$"),
    (r"^swin", r"stage\d+_block\d+/norm1$"),
    (r"^mobilenet", r"stage\d+_block\d+$"),
    (r"^efficientnet", r"stage\d+_block\d+$"),
)

Hook = Callable[[str, nn.Module, object], Optional[torch.Tensor]]


def resize_bilinear(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[h, w] or [h, w, C] f32 → [H, W] or [H, W, C]: ``jax.image.resize``'s
    bilinear (half-pixel centres, antialiased when shrinking)."""
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    t = t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(size), mode="bilinear", align_corners=False, antialias=True)[0]
    return (out[0] if arr.ndim == 2 else out.permute(1, 2, 0)).numpy()


def _call_hook(fn: Hook, path: str, module: nn.Module, args, output):
    return fn(path, module, output)


@contextlib.contextmanager
def _hooked(model: nn.Module, fn: Hook):
    """Within, ``fn(flax path, module, output)`` runs after every module's
    forward; a tensor it returns replaces the output."""
    from visiondk_tpu_torch.models.convert import _path_mapper

    flax_path = _path_mapper(model)
    handles = [m.register_forward_hook(partial(_call_hook, fn, flax_path(name)))
               for name, m in model.named_modules()]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def _frozen(model: nn.Module):
    """Parameters without ``requires_grad`` within: a CAM backward reaches
    the injected map or the input only."""
    flags = [(p, p.requires_grad) for p in model.parameters()]
    for p, _ in flags:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)


def _model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def find_target_path(model: nn.Module, example: torch.Tensor, backbone_name: str,
                     target_layer: Optional[str] = None) -> str:
    """The CAM target's flax path: the last module, in call order over one
    forward of ``example``, whose path matches the architecture's pattern.
    ``target_layer`` (a regex) overrides the table."""
    pattern = target_layer
    if pattern is None:
        for arch_re, layer_re in _TARGET_PATTERNS:
            if re.match(arch_re, backbone_name):
                pattern = layer_re
                break
        if pattern is None:
            pattern = r"stage4_block\d+$"  # CNN default

    seen: List[str] = []
    model.eval()
    with torch.no_grad(), _hooked(model, lambda p, m, o: seen.append(p)):
        model(torch.as_tensor(example, device=_model_device(model)))
    matches = [p for p in seen if re.search(pattern, p)]
    if not matches:
        raise ValueError(
            f"no module path matches {pattern!r} for backbone {backbone_name!r};"
            f" available paths: {sorted(set(seen))[:40]}"
        )
    return matches[-1]


def _bias_of(m: nn.Module) -> Optional[np.ndarray]:
    """FullGrad's per-channel bias of a module, or None: a convolution's bias
    (not a ``dense`` 1×1 convolution, which is a JAX ``Dense``), or a
    BatchNorm's effective inference bias β − μ·γ/√(σ²+ε)."""
    if isinstance(m, nn.Conv2d):
        if m.bias is None or getattr(m, "dense", False):
            return None
        return m.bias.detach().float().cpu().numpy()
    if isinstance(m, nn.modules.batchnorm._BatchNorm):
        f = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
        return f(m.bias) - f(m.running_mean) * f(m.weight) / np.sqrt(f(m.running_var) + np.float32(m.eps))
    return None


def discover_bias_layers(model: nn.Module, example: torch.Tensor) -> Dict[str, Tuple[Tuple[int, ...], np.ndarray]]:
    """FullGrad's target set in call order: {flax path: (output shape in
    JAX's NHWC layout, per-channel bias)} for every convolution with a bias
    and every BatchNorm whose output is 4-D (pytorch-grad-cam's
    layer_with_2D_bias predicate, as the JAX ``discover_bias_layers``)."""
    layers: Dict[str, Tuple[Tuple[int, ...], np.ndarray]] = {}

    def record(path, m, out):
        if isinstance(out, torch.Tensor) and out.ndim == 4:
            bias = _bias_of(m)
            if bias is not None:
                b, c, h, w = out.shape
                layers[path] = ((b, h, w, c), bias)

    model.eval()
    with torch.no_grad(), _hooked(model, record):
        model(torch.as_tensor(example, device=_model_device(model)))
    return layers


def _jax_layout(t: torch.Tensor) -> np.ndarray:
    """A port map as f32 numpy in JAX's layout: NCHW → NHWC, tokens as they are."""
    t = t.detach().float()
    if t.ndim == 4:
        t = t.permute(0, 2, 3, 1)
    return t.cpu().numpy()


def _to_spatial(fmap: np.ndarray, drop_cls: bool) -> np.ndarray:
    """[H,W,C] passthrough; [N,C] token map → [h,w,C] (the JAX ``_to_spatial``).
    A square N is taken whole (Swin's token map, a ViT without a class token);
    otherwise the class row is dropped and the first ⌊√n⌋² rows are the grid
    (the port's ViT holds 197 tokens where the JAX one pads to 200: the floor
    gives the same 14×14 grid either way)."""
    if fmap.ndim == 3:
        return fmap
    n, c = fmap.shape
    side = int(n ** 0.5)
    if side * side == n:
        return fmap.reshape(side, side, c)
    if drop_cls:
        fmap = fmap[1:]
        n -= 1
    side = int(n ** 0.5)
    return fmap[: side * side].reshape(side, side, c)


class ClassActivationMaper:
    """CAM generator over one of the port's classification models, which
    carries its weights: ``model(x [B, H, W, 3] f32) -> logits``. The
    model is put in eval mode."""

    def __init__(self, model: nn.Module, method: str, example, backbone_name: str = "",
                 target_layer: Optional[str] = None):
        if method not in CAM_METHODS:
            raise ValueError(f"method {method!r} not in {CAM_METHODS}")
        self.model = model.eval()
        self.method = method
        self.device = _model_device(model)
        example = torch.as_tensor(np.array(example, np.float32), device=self.device)
        # fullgrad aggregates over every bias layer: it has no single target
        self.target_path = "" if method == "fullgrad" else find_target_path(model, example, backbone_name,
                                                                            target_layer)
        self._is_token_map = bool(re.search(r"norm1$", self.target_path))
        if method == "fullgrad":
            self._bias_layers = discover_bias_layers(model, example)

    # ------------------------------------------------------------ device passes

    def _on_target(self, fn: Callable[[torch.Tensor], Optional[torch.Tensor]]) -> Hook:
        target = self.target_path
        return lambda path, m, out: fn(out) if path == target else None

    def _capture(self, x: torch.Tensor) -> torch.Tensor:
        box: Dict[str, torch.Tensor] = {}
        with torch.no_grad(), _hooked(self.model, self._on_target(lambda out: box.__setitem__("fmap", out))):
            self.model(x)
        return box["fmap"]

    def _grad(self, fmap: torch.Tensor, x: torch.Tensor, class_idx: int) -> torch.Tensor:
        """d(class score)/d(the injected map), in the port's layout."""
        a = fmap.detach().clone().requires_grad_(True)
        inject = self._on_target(lambda out: a.to(out.dtype))
        with torch.enable_grad(), _frozen(self.model), _hooked(self.model, inject):
            score = self.model(x)[:, class_idx].sum()
            (g,) = torch.autograd.grad(score, a)
        return g

    def _scores_inject(self, fmaps: torch.Tensor, x: torch.Tensor, class_idx: int) -> np.ndarray:
        """The class score of each of K injected maps, in one batched forward."""
        xs = x.expand(fmaps.shape[0], *x.shape[1:]).contiguous()
        with torch.no_grad(), _hooked(self.model, self._on_target(lambda out: fmaps.to(out.dtype))):
            return self.model(xs)[:, class_idx].float().cpu().numpy()

    def _logits(self, x: torch.Tensor) -> np.ndarray:
        with torch.no_grad():
            return self.model(x).float().cpu().numpy()

    # ------------------------------------------------------------ weights

    @staticmethod
    def _cam_from(method: str, fmap: np.ndarray, grad: Optional[np.ndarray]) -> np.ndarray:
        """fmap/grad: [H, W, C] fp32 → cam [H, W] (the JAX ``_cam_from``)."""
        if method == "eigencam" or (method == "eigengradcam" and grad is None):
            m = fmap
        elif method == "eigengradcam":
            m = fmap * grad
        elif method == "hirescam":
            return np.maximum(fmap * grad, 0).sum(-1)
        elif method == "layercam":
            return np.maximum(fmap * np.maximum(grad, 0), 0).sum(-1)
        elif method == "gradcam":
            w = grad.mean(axis=(0, 1))
            return np.maximum((fmap * w).sum(-1), 0)
        elif method == "gradcampp":
            g2, g3 = grad ** 2, grad ** 3
            denom = 2.0 * g2 + (fmap * g3).sum(axis=(0, 1), keepdims=True)
            alpha = np.divide(g2, denom, out=np.zeros_like(g2), where=denom != 0)
            w = (alpha * np.maximum(grad, 0)).sum(axis=(0, 1))
            return np.maximum((fmap * w).sum(-1), 0)
        elif method == "xgradcam":
            denom = fmap.sum(axis=(0, 1), keepdims=True) + 1e-8
            w = (grad * fmap / denom).sum(axis=(0, 1))
            return np.maximum((fmap * w).sum(-1), 0)
        else:
            raise ValueError(method)
        # eigen variants: first principal component of the (HW, C) matrix
        h, w_, c = m.shape
        flat = m.reshape(-1, c)
        flat = flat - flat.mean(0, keepdims=True)
        _, _, vt = np.linalg.svd(flat, full_matrices=False)
        cam = (flat @ vt[0]).reshape(h, w_)
        if cam.max() < -cam.min():  # sign-correct the component
            cam = -cam
        return np.maximum(cam, 0)

    def _channel_weights_ablation(self, fmap: torch.Tensor, x: torch.Tensor, class_idx: int) -> np.ndarray:
        """w_k = (y_c − y_c^{ablate k}) / |y_c| (AblationCAM)."""
        axis = 1 if fmap.ndim == 4 else fmap.ndim - 1  # the channels: NCHW, or the last of a token map
        c = fmap.shape[axis]
        base = float(self._scores_inject(fmap[:1], x, class_idx)[0])
        weights = np.zeros((c,), np.float32)
        shape = [1] * fmap.ndim
        for s in range(0, c, _PERTURB_CHUNK):
            k = min(_PERTURB_CHUNK, c - s)
            keep = torch.ones((k, c), dtype=fmap.dtype, device=fmap.device)
            keep[torch.arange(k), torch.arange(s, s + k)] = 0
            shape[0], shape[axis] = k, c
            scores = self._scores_inject(fmap[:1] * keep.reshape(shape), x, class_idx)
            weights[s : s + k] = (base - scores) / (abs(base) + 1e-8)
        return weights

    def _channel_weights_score(self, fmap_s: np.ndarray, x: torch.Tensor, class_idx: int) -> np.ndarray:
        """Softmax over channels of the class score on activation-masked
        inputs (ScoreCAM)."""
        _, _, c = fmap_s.shape
        acts = resize_bilinear(fmap_s, (x.shape[1], x.shape[2]))
        mn = acts.min(axis=(0, 1), keepdims=True)
        mx = acts.max(axis=(0, 1), keepdims=True)
        acts = (acts - mn) / np.maximum(mx - mn, 1e-8)  # [Hi, Wi, C] in [0, 1]
        masks = torch.from_numpy(np.ascontiguousarray(np.moveaxis(acts, 2, 0))).to(x.device)  # [C, Hi, Wi]
        scores = np.zeros((c,), np.float32)
        for s in range(0, c, _PERTURB_CHUNK):
            masked = x[0][None] * masks[s : s + _PERTURB_CHUNK, :, :, None]
            scores[s : s + masked.shape[0]] = self._logits(masked)[:, class_idx]
        e = np.exp(scores - scores.max())
        return (e / e.sum()).astype(np.float32)

    def _fullgrad(self, x: torch.Tensor, class_idx: int) -> np.ndarray:
        """The FullGrad map at the input's size: the input term plus each bias
        layer's, every gradient from one backward through zeros added to the
        layers' outputs."""
        shapes = {p: (s[0], s[3], s[1], s[2]) for p, (s, _) in self._bias_layers.items()}  # NHWC → NCHW
        eps = {p: torch.zeros(s, device=x.device, requires_grad=True) for p, s in shapes.items()}

        def add_eps(path, m, out):
            if path in eps and tuple(out.shape) == shapes[path]:
                return out + eps[path].to(out.dtype)
            return None

        xg = x.detach().clone().requires_grad_(True)
        with torch.enable_grad(), _frozen(self.model), _hooked(self.model, add_eps):
            score = self.model(xg)[:, class_idx].sum()
            grads = torch.autograd.grad(score, [xg, *eps.values()], allow_unused=True)
        h_in, w_in = x.shape[1], x.shape[2]

        def term(m: np.ndarray) -> np.ndarray:
            """[H,W,C] saliency → per-channel min-max scale → resize to the
            input → sum over channels."""
            m = np.abs(m)
            mn = m.min(axis=(0, 1), keepdims=True)
            mx = m.max(axis=(0, 1), keepdims=True)
            m = (m - mn) / np.maximum(mx - mn, 1e-8)
            return resize_bilinear(m, (h_in, w_in)).sum(-1)

        cam = term((grads[0][0] * x[0]).float().cpu().numpy())  # the input is NHWC already
        for (p, (_, bias)), g in zip(self._bias_layers.items(), grads[1:]):
            g = np.zeros(shapes[p], np.float32).transpose(0, 2, 3, 1) if g is None else _jax_layout(g)
            cam = cam + term(g[0] * bias)
        return cam

    # ------------------------------------------------------------ public

    def cam(self, input_tensor, class_idx: Optional[int] = None) -> np.ndarray:
        """The raw CAM of one normalised input [1, H, W, 3]: the feature
        map's grid for the target-layer methods, the input's size for
        fullgrad."""
        x = torch.as_tensor(np.asarray(input_tensor, np.float32), device=self.device)
        if class_idx is None:
            class_idx = int(np.argmax(self._logits(x)[0]))
        if self.method == "fullgrad":
            return self._fullgrad(x, class_idx)

        fmap = self._capture(x)
        fmap_s = _to_spatial(_jax_layout(fmap)[0], drop_cls=self._is_token_map)
        if self.method in _PERTURB_METHODS:
            if self.method == "ablationcam":
                w = self._channel_weights_ablation(fmap, x, class_idx)
            else:
                w = self._channel_weights_score(fmap_s, x, class_idx)
            return np.maximum((fmap_s * w).sum(-1), 0)
        grad_s = None
        if self.method != "eigencam":
            grad_s = _to_spatial(_jax_layout(self._grad(fmap, x, class_idx))[0], drop_cls=self._is_token_map)
        return self._cam_from(self.method, fmap_s, grad_s)

    def heatmap(self, size: Tuple[int, int], input_tensor, class_idx: Optional[int] = None) -> np.ndarray:
        """The [0, 1] heat map at ``size`` (h, w) that the overlay blends:
        the CAM shifted to 0, scaled to a maximum of 1 and resized."""
        cam = self.cam(input_tensor, class_idx)
        cam = cam - cam.min()
        if cam.max() > 0:
            cam = cam / cam.max()
        return resize_bilinear(cam, size)

    def __call__(self, image, input_tensor, class_idx: Optional[int] = None) -> np.ndarray:
        """CAM overlay for one image. ``image``: HWC uint8 display image;
        ``input_tensor``: [1, H, W, 3] normalised f32 model input. Returns
        the HWC uint8 overlay (show_cam_on_image semantics)."""
        image = np.asarray(image)
        return overlay_cam(image, self.heatmap(image.shape[:2], input_tensor, class_idx))


def overlay_cam(image: np.ndarray, cam: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Blend a [0,1] heat-map onto an RGB uint8 image with a jet colormap."""
    heat = _jet(np.clip(cam, 0.0, 1.0))
    out = (1 - alpha) * image.astype(np.float32) + alpha * heat
    return np.clip(out, 0, 255).astype(np.uint8)


def _jet(x: np.ndarray) -> np.ndarray:
    """Minimal jet colormap → RGB float [0,255] (no matplotlib dependency)."""
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return np.stack([r, g, b], axis=-1) * 255.0
