"""What the benchmark hands to both sides, made from ``--seed`` on the device:
the weights (the reference model's spec, one draw), the buffers as they
start, and a pool of distinct uint8 image batches with their labels."""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import torch

from portbench.reference.common import make_weights

SEED_MASK = 2**63 - 1


def derive(seed: int, what: str) -> int:
    """A seed for one kind of input, fixed by the run's seed (any size)."""
    mix = 0
    for ch in what:
        mix = (mix * 131 + ord(ch)) % SEED_MASK
    return (int(seed) * 1_000_003 + mix) % SEED_MASK


def reference_model(cfg: Dict):
    """The reference module of the configuration's architecture kind."""
    return importlib.import_module(f"portbench.reference.{cfg['arch']['kind']}")


def weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_weights(reference_model(cfg).spec(cfg["arch"]), derive(seed, "weights"), device)


def buffers(cfg: Dict, device) -> Dict[str, torch.Tensor]:
    out = {}
    for name, (shape, value) in reference_model(cfg).buffers_spec(cfg["arch"]).items():
        dtype = torch.int64 if isinstance(value, int) else torch.float32
        out[name] = torch.full(shape, value, dtype=dtype, device=device)
    return out


def num_classes(cfg: Dict) -> int:
    arch = cfg["arch"]
    return arch["neck"]["num_class"] if "neck" in arch else arch["num_classes"]


def pool(cfg: Dict, traffic: Dict, seed: int, device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``traffic["pool"]`` distinct batches of ``traffic["batch"]`` uint8 NHWC
    images and int64 labels uniform over the classes, drawn on the device."""
    gen = torch.Generator(device=device).manual_seed(derive(seed, "pool"))
    side, b = cfg["arch"]["img_size"], traffic["batch"]
    out = []
    for _ in range(traffic["pool"]):
        images = torch.randint(0, 256, (b, side, side, 3), generator=gen, device=device, dtype=torch.uint8)
        labels = torch.randint(0, num_classes(cfg), (b,), generator=gen, device=device)
        out.append((images, labels))
    return out
