"""Inference from a saved ``torch.export`` program (counterpart of the repo's
``tools/exported_predict.py``): no model code and no checkpoint, only the
program ``visiondk_tpu_torch.export`` wrote and the port's operators::

    python -m visiondk_tpu_torch.tools.exported_predict --artifact model.pt2 --img x.jpg \
        [--size 224] [--device cuda|cpu]

Prints the five most probable classes (``class j: p``, softmax) for an output
of at most 4096 values, else the embedding's shape and norm. The image is
resized to ``--size``², by default the program's input size. ``--device``
(default ``cuda``) is where the program was exported: it keeps that device.
"""

from __future__ import annotations

import argparse


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--artifact", required=True, help="visiondk_tpu_torch.export output file")
    p.add_argument("--img", required=True)
    p.add_argument("--size", type=int, default=None,
                   help="resize to size x size; defaults to the program's input size")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu: the program's device")
    return p.parse_args(argv)


def program_input(program):
    """The fake tensor of the program's one user input (its shape, dtype and device)."""
    user = set(program.graph_signature.user_inputs)
    (node,) = [n for n in program.graph.nodes if n.op == "placeholder" and n.name in user]
    return node.meta["val"]


def main(opt):
    import numpy as np
    import torch
    from PIL import Image

    import visiondk_tpu_torch.ops  # noqa: F401  registers the vdk:: operators the program calls

    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was asked for (the default) but CUDA is not available; "
                           "pass --device cpu for a program exported on the CPU")
    program = torch.export.load(opt.artifact)
    spec = program_input(program)
    if spec.device.type != device.type:
        raise ValueError(f"{opt.artifact} was exported on {spec.device}; run it with --device {spec.device.type}")
    size = opt.size or int(spec.shape[1])

    img = Image.open(opt.img).convert("RGB").resize((size, size))
    x = torch.from_numpy(np.asarray(img, dtype=np.uint8)[None].copy()).to(spec.device)
    with torch.inference_mode():
        out = program.module()(x)[0].float().cpu().numpy().astype(np.float64)
    if out.ndim == 1 and out.shape[0] <= 4096:
        e = np.exp(out - out.max())
        probs = e / e.sum()
        top = [(int(j), float(probs[j])) for j in np.argsort(-probs)[:5]]
        for j, p in top:
            print(f"class {j}: {p:.4f}")
        return top
    print(f"embedding[{out.shape}] norm={np.linalg.norm(out):.4f}")
    return out


if __name__ == "__main__":
    main(parse_opt())
