"""Augmentation preview (counterpart of the repo's ``tools/test_augment.py``):
an H×W grid of independently augmented copies of one image, each tile drawn
from ``seed_sample(seed, tile)``, so a seed gives the same grid::

    python -m visiondk_tpu_torch.tools.test_augment -m img.jpg -o save_img.jpg -H 4 -W 7 \
        [--augment_yaml configs/classification/pet.yaml] [--seed 0]

Without ``--augment_yaml`` the demo pipeline (``demo_augs``) is used; with it,
the config's ``data.train.augment``. Host code: no device.
"""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-m", "--img_path", type=str, required=True, help="raw image path")
    p.add_argument("-o", "--output_path", type=str, default="save_img.jpg")
    p.add_argument("-H", "--height", type=int, default=4, help="grid rows")
    p.add_argument("-W", "--width", type=int, default=7, help="grid cols")
    p.add_argument("--augment_yaml", type=str, default=None,
                   help="config yaml; uses data.train.augment if given")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def demo_augs():
    """The demo pipeline: one of five photometric or geometric ops, one of two
    resizes to 224, a horizontal flip."""
    return [
        {"random_choice": dict(transforms=[
            dict(random_color_jitter=dict(brightness=0.1, contrast=0.1, saturation=0.1, hue=0.1)),
            dict(random_cutout=dict(n_holes=3, length=12, prob=0.1, color=(0, 255))),
            dict(random_gaussianblur=dict(kernel_size=5)),
            dict(random_rotate=dict(degrees=20)),
            dict(random_augmix=dict(severity=3)),
        ])},
        {"random_choice": dict(transforms=[
            dict(resize_and_padding=dict(size=224)),
            dict(random_crop_and_resize=dict(size=224, scale=(0.7, 1))),
        ])},
        {"random_horizonflip": dict(p=0.5)},
    ]


def main(args):
    from visiondk_tpu_torch.data.transforms import create_aug_transforms, seed_sample

    if args.augment_yaml:
        from visiondk_tpu_torch.config import yaml_load

        augs = yaml_load(args.augment_yaml)["data"]["train"]["augment"]
    else:
        augs = demo_augs()

    t = create_aug_transforms(augs)
    img = Image.open(args.img_path).convert("RGB")

    tiles = []
    for i in range(args.height * args.width):
        seed_sample("test_augment", args.seed, i)
        tiles.append(np.asarray(t(img)))
    h, w = tiles[0].shape[:2]
    grid = np.zeros((args.height * h, args.width * w, 3), dtype=np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, args.width)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = tile[:h, :w]

    Image.fromarray(grid).save(args.output_path)
    print(f"saved augment grid to {args.output_path}")
    return grid


if __name__ == "__main__":
    main(parse_opt())
