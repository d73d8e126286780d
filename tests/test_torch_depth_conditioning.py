"""Where the camera-only train step's depth_prob departs from JAX's
(ROADMAP C7), layer by layer, against JAX's own two ways of running the
same function (CPU, tiny).

The twin is tests/test_torch_train_configs.py's `cam_train`
(coocc_cam_r101_896x1600's tiny training twin), with 2 cameras (its own)
and with 6, from one state_dict (entry.build_model, seed 7) through
convert_coocc_ray, on synthetic_batch(seed=3): the forward of a train step
(BatchNorm on batch statistics, dropout off, the cascade on JAX's own
priorities). At the camera vector's BatchNorm, the image neck's output
and each layer of the depth net to depth_prob, three readings, each a max
|diff| over the layer's max |x| in JAX's jitted run (the tests' reference):
the port's distance to it, and JAX's own un-jitted run's (the same flax
modules, op by op).

Measured (2 torch threads): with 6 cameras depth_prob is 5.90e-4 from
JAX's jitted run, and JAX's un-jitted run is 5.75e-4 from it. The distance
starts at the camera vector's BatchNorm (`depth_net.bn`, statistics over
the B*N = 6 camera vectors): 7.150e-4 for the port and for JAX's un-jitted
run alike, the port equal to the latter there. The synthetic cameras share
their intrinsics, so several of the 27 features are constant across the
cameras: their normalized value, (x - mean) / sqrt(var + eps), is a
rounding residue, which XLA's jit computes otherwise (it contracts
E[x^2] - E[x]^2 into a fused multiply-add, so a constant feature's
variance comes out as the exact rounding error of mean^2, not 0 or an ulp
of it) and which the depth branch carries to depth_prob; from there the
port stays within 1.03x of JAX's un-jitted distance at every layer. With 2
cameras the mean of two equal values is exact, the residue is 0, and
depth_prob reads 2.08e-4 (JAX's un-jitted run 2.43e-4), from ASPP's
pooled branch on: its BatchNorm's statistics over 2 pooled 1x1 maps a
channel (gap_bn) turn fp32 noise into 5.5e-3 of the scale (JAX's
un-jitted run 8.7e-3). So C7 is JAX's own conditioning: the port computes
these layers as JAX's ops compute them, and its distance to JAX is the
distance between JAX's two runs. Run from one fp32 input, the port's ASPP
and JAX's are also each as far from a float64 run of the module (the
port's, in float64).

Bounds: every layer within 2x JAX's un-jitted distance, or within 2e-5
of the scale (fp32 rounding, where JAX's two runs agree closer than
that); at 6 cameras the port's camera BatchNorm within 1e-6 of the scale
of JAX's un-jitted one; ASPP's fp32 output no farther from float64 than
twice JAX's fp32 is.
"""
import dataclasses
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.nn import depthnet as J
from coocc_tpu.train.convert_torch import convert_coocc_ray

from test_torch_train import BATCH_SEED, SEED
from test_torch_train_configs import cam_train

from coocc_tpu_torch.convert import _aspp, _Reader
from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import build_model, init_weights
from coocc_tpu_torch.nn import depthnet as P
from coocc_tpu_torch.nn.layers import Dropout
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

# the depth net's layers, in order: (JAX's scope under depth_net or its
# aspp, the port's module under depth_net)
LAYERS = (("bn", "bn"), ("reduce_bn", "reduce_conv"),
          ("depth_se", "depth_se"),
          ("depth_block0", "depth_conv.0"), ("depth_block1", "depth_conv.1"),
          ("depth_block2", "depth_conv.2"), ("aspp/gap_conv",
                                             "depth_conv.3.global_avg_pool.1"),
          ("aspp/gap_bn", "depth_conv.3.global_avg_pool.2"),
          ("aspp/conv1", "depth_conv.3.conv1"), ("aspp", "depth_conv.3"),
          ("dcn", "depth_conv.4"), ("depth_pred", "depth_conv.5"))
CAMERAS = (2, 6)
FP32_FLOOR = 2e-5


def _cams(cfg, n):
    return cfg.replace(data=dataclasses.replace(
        cfg.data, cams=tuple(f"CAM_{i}" for i in range(n))))


def _jax_layers(jcfg, variables, params, batch, rng):
    """JAX's train forward -> {layer: output} (NHWC) and depth_prob."""
    scopes = {s.split("/")[-1] for s, _ in LAYERS} | {"img_neck"}
    outs, state = JaxCoOccRay(cfg=jcfg).apply(
        {"params": params, "batch_stats": variables["batch_stats"]}, batch,
        train=True, fine_rng=jax.random.fold_in(rng, 2),
        rngs={"dropout": jax.random.fold_in(rng, 1)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda m, _: m.name in scopes)
    inter = state["intermediates"]
    neck = inter["img_neck"]["__call__"][0]
    res = {"neck": neck[0] if isinstance(neck, (list, tuple)) else neck}
    for scope, _ in LAYERS:
        node = inter["img_view_transformer"]["depth_net"]
        for part in scope.split("/"):
            node = node[part]
        res[scope] = node["__call__"][0]
    res["reduce_bn"] = jnp.maximum(res["reduce_bn"], 0.0)   # then its ReLU
    res["depth_prob"] = outs["depth_prob"]
    return res


def _port_layers(cfg, sd, batch, prio):
    model = build_model(cfg, "cpu", seed=SEED)
    model.load_state_dict(sd)
    model.train()
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    cap = {}
    dn = model.img_view_transformer.depth_net
    mods = [(model.img_neck, "neck",
             lambda o: o[0] if isinstance(o, (list, tuple)) else o)] + [
        (dn.get_submodule(name), scope, lambda o: o) for scope, name in LAYERS]
    hooks = [m.register_forward_hook(
        lambda mod, i, o, k=k, pick=pick: cap.__setitem__(k, pick(o)))
        for m, k, pick in mods]
    try:
        outs = model(batch, fine_priorities=prio)
    finally:
        for h in hooks:
            h.remove()
    res = {k: (v.permute(0, 2, 3, 1) if v.dim() == 4 else v).detach().numpy()
           for k, v in cap.items()}
    res["depth_prob"] = outs["depth_prob"].detach().numpy()
    return res


@pytest.fixture(scope="module")
def readings():
    """{cameras: {layer: (the port's distance to JAX's jitted run, JAX's
    un-jitted run's, the port's to JAX's un-jitted run)}}; JAX's runs of
    each camera count in a thread beside the port's."""
    monkey = pytest.MonkeyPatch()
    monkey.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    out, threads = {}, []
    try:
        for n in CAMERAS:
            cfg = _cams(cam_train(tiny_config), n)
            jcfg = _cams(cam_train(jax_tiny_config), n)
            sd = build_model(cfg, "cpu", seed=SEED).state_dict()
            variables = convert_coocc_ray(
                {k: v.numpy() for k, v in sd.items()}, jcfg)
            rng = jax.random.PRNGKey(0)
            prio = torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(jax.random.fold_in(rng, 2), 0),
                (int(np.prod(jcfg.lss_grid_size)),))))[None]
            port = _port_layers(cfg, sd, synthetic_batch(
                cfg, batch_size=1, seed=BATCH_SEED).to("cpu"), prio)
            out[n] = [None, port]

            def run(n=n, jcfg=jcfg, variables=variables, rng=rng):
                try:
                    batch = jax.tree.map(
                        lambda x: None if x is None else jnp.asarray(x),
                        jax_synthetic_batch(jcfg, batch_size=1,
                                            seed=BATCH_SEED),
                        is_leaf=lambda x: x is None)

                    def fn(p):
                        return _jax_layers(jcfg, variables, p, batch, rng)
                    runs = [jax.jit(fn)(variables["params"]),
                            fn(variables["params"])]
                    out[n][0] = jax.tree.map(np.asarray, runs)
                except BaseException as e:  # re-raised below
                    out[n][0] = e
            threads.append(threading.Thread(target=run))
            threads[-1].start()
        for t in threads:
            t.join()
    finally:
        monkey.undo()
    res = {}
    for n, (runs, port) in out.items():
        if isinstance(runs, BaseException):
            raise runs
        jit, eager = runs
        res[n] = {}
        for k in jit:
            scale = np.abs(jit[k]).max()
            res[n][k] = tuple(float(np.abs(a[k] - b[k]).max() / scale)
                              for a, b in ((port, jit), (eager, jit),
                                           (port, eager)))
    return res


@pytest.mark.parametrize("cameras", CAMERAS)
def test_depth_net_layers_as_far_as_jax_unjitted(readings, cameras):
    """Each layer's distance to JAX's jitted run within 2x JAX's own
    un-jitted run's, or within FP32_FLOOR of the scale (module note)."""
    reading = readings[cameras]
    assert set(reading) == {"neck", "depth_prob"} | {s for s, _ in LAYERS}
    bad = {k: (d, e) for k, (d, e, _) in reading.items()
           if not d <= max(2.0 * e, FP32_FLOOR)}
    assert not bad, bad


def test_camera_batchnorm_is_jax_unjitted_at_6_cameras(readings):
    """Where the 6-camera drift starts, the camera vector's BatchNorm, the
    port is JAX's un-jitted run, both 7e-4 of the scale from the jitted
    one."""
    d, e, pe = readings[6]["bn"]
    assert pe <= 1e-6 and d > 10 * FP32_FLOOR and e > 10 * FP32_FLOOR, \
        (d, e, pe)


@pytest.mark.parametrize("cameras", CAMERAS)
def test_aspp_rounds_no_farther_from_float64_than_jax(cameras):
    """ASPP in training (the pooled branch's BatchNorm over the cameras'
    pooled maps) from one fp32 input: the port's fp32 output no farther
    from the port's float64 run than twice JAX's fp32 output is."""
    C, H, W = 32, 8, 24
    x = (np.random.RandomState(9).randn(cameras, H, W, C) * 0.5
         + 1.0).astype(np.float32)
    mod = init_weights(P.ASPP(C, C), seed=3).train()
    mod.dropout.p = 0.0
    r = _Reader({f"m.{k}": v for k, v in mod.state_dict().items()})
    _aspp(r, "m", "m")
    variables = {k: v["m"] for k, v in r.tree.items() if v}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        j32, _ = J.ASPP(C).apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    p32 = mod(xt).detach().permute(0, 2, 3, 1).numpy()
    p64 = mod.double()(xt.double()).detach().permute(0, 2, 3, 1).numpy()
    scale = np.abs(p64).max()
    port_err = np.abs(p32 - p64).max() / scale
    jax_err = np.abs(np.asarray(j32) - p64).max() / scale
    assert 0 < port_err <= 2.0 * jax_err, (port_err, jax_err)
