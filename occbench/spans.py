"""The benchmark's ranges around the port's layers, placed from outside the
program: forward hooks on CoOccRay's children, and wrappers on the model
instance's two branch methods (the image branch and the LiDAR branch with
its voxelization), on its forward and on the optimizer's step. Each range
is a torch.profiler.record_function named `occbench.<layer>`; nothing is
added inside the program. They are installed in traced runs only.
"""
from __future__ import annotations

import functools

import torch

# the model's children and the layer each belongs to
CHILD_LAYERS = (("occ_fuser", "fuse"), ("semantic_encoder", "sem"),
                ("semantic_neck", "sem"), ("pts_bbox_head", "head"))
# the model's branch methods and their layers
METHOD_LAYERS = (("_image_voxels", "img"), ("_pts_voxels", "pts"))


def _range(name: str):
    return torch.profiler.record_function(f"occbench.{name}")


def wrap_method(obj, attr: str, name: str) -> bool:
    """Replace obj.attr (a bound method) on the instance by one that runs
    inside the range `name`; False where obj has no such attribute."""
    fn = getattr(obj, attr, None)
    if fn is None:
        return False

    @functools.wraps(fn)
    def ranged(*a, **k):
        with _range(name):
            return fn(*a, **k)
    setattr(obj, attr, ranged)
    return True


def hook_module(module: torch.nn.Module, name: str):
    """Open the range `name` before the module's forward, close it after."""
    stack = []

    def pre(_m, _args):
        r = _range(name)
        r.__enter__()
        stack.append(r)

    def post(_m, _args, _out):
        stack.pop().__exit__(None, None, None)

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)


def install_model(model: torch.nn.Module):
    """The stage ranges and `forward` on a CoOccRay."""
    hook_module(model, "forward")
    for attr, name in METHOD_LAYERS:
        wrap_method(model, attr, name)
    for child, name in CHILD_LAYERS:
        m = getattr(model, child, None)
        if isinstance(m, torch.nn.Module):
            hook_module(m, name)
