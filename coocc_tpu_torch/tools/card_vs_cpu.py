"""Where a config's bf16 forward on the card departs from the same forward
on the CPU, tensor by tensor, on one machine:

    python -m coocc_tpu_torch.tools.card_vs_cpu [config]

Both devices build the config's fingerprint model (`parity.fingerprint_model`:
the same numpy-drawn weights) in bf16 and run the synthetic batch of seed
0 up to the fuser (`stop_at="fuse"`); forward hooks keep the first
camera's stage-0 features, the image neck's output, the depth net's (the
mono DepthNet's concatenated depth logits and context, or the stereo one's
context), depth_prob, img_voxel, pts_voxel and voxel_feats. For each it
prints the share of values that differ, how many bf16 ulps apart they are,
and the largest and mean difference relative to the CPU's max |x|. The
default config is the stereo flagship; any registered config with a camera
branch and a fuser is taken. Needs a CUDA card (about a minute: the CPU
side runs the full-width model).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import parity
from ..config import get_config, list_configs
from ..data.synthetic import synthetic_batch
from ..models.coocc_ray import CoOccRay


def capture(model, batch):
    """{name: bf16 tensor on the host} of one forward up to the fuser."""
    keep = {}

    def put(name, pick=lambda o: o):
        def hook(mod, inputs, out):
            if name not in keep:
                keep[name] = pick(out)
        return hook
    taps = [(model.img_backbone, "stage0 (camera 0)", lambda o: o[0][:1]),
            (model.img_neck, "neck", lambda o: o),
            (model.img_view_transformer.depth_net, "depth net",
             lambda o: o if isinstance(o, torch.Tensor) else o[0]),
            (model.img_view_transformer, "depth_prob", lambda o: o[1]),
            (model.img_view_transformer, "img_voxel", lambda o: o[0]),
            (model.pts_middle_encoder, "pts_voxel", lambda o: o),
            (model.occ_fuser, "voxel_feats", lambda o: o)]
    hooks = [m.register_forward_hook(put(n, f)) for m, n, f in taps]
    try:
        with torch.no_grad():
            model(batch, stop_at="fuse")
    finally:
        for h in hooks:
            h.remove()
    return {k: v.to(torch.bfloat16).cpu() for k, v in keep.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "coocc_tpu_torch.tools.card_vs_cpu")
    ap.add_argument("config", nargs="?",
                    default="coocc_multi_r50_256x704_stereo",
                    choices=list_configs())
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.config)
    batch_np = synthetic_batch(cfg, batch_size=1, seed=0)
    weights = parity.fingerprint_model(cfg, "cpu").state_dict()
    runs = {}
    for dev in ("cuda", "cpu"):
        with torch.device(dev):
            model = CoOccRay(cfg, torch.bfloat16).eval().to(dev)
        model.load_state_dict(weights)
        runs[dev] = capture(model, batch_np.to(dev))
        del model
    print(f"{args.config}, bf16, card {torch.cuda.get_device_name(0)} "
          "against this machine's CPU:")
    for name, cpu in runs["cpu"].items():
        card = runs["cuda"][name]
        a, b = card.float().numpy(), cpu.float().numpy()
        diff = a != b
        ulps = np.abs(card.view(torch.int16).numpy().astype(np.int32)
                      - cpu.view(torch.int16).numpy().astype(np.int32))[diff]
        scale = float(np.abs(b).max())
        d = np.abs(a - b)
        print(f"  {name:18s} {tuple(cpu.shape)}: {diff.mean():.4f} of the "
              f"values differ (1 ulp {np.mean(ulps == 1):.3f}, 2 "
              f"{np.mean(ulps == 2):.3f}, more {np.mean(ulps > 2):.3f}); "
              f"max {d.max() / scale:.4g}, mean {d.mean() / scale:.4g} of "
              f"max |x| {scale:.4g}")


if __name__ == "__main__":
    main()
