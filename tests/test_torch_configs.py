"""The reference's R101 nuScenes configs in the port, against the JAX
package at tiny shapes (CPU).

(a) A tiny model shaped like coocc_multi_r101_openoccupancy, built from
    tiny_config() in both packages with .replace (neither package's
    tiny_config changes): cascade ratio 4 (64 children a cell),
    lss_downsample (4, 4, 4), the config's two fuser windows (8, 8, 9) /
    (6, 6, 7), a 32x32x40 grid whose coarse Z of 10 runs the semantic
    stack's stride-2 convs at Z 10 -> 5 -> 3 -> 2, and a 64x64x80 LiDAR
    grid, which packs as the real one does (p = 4, 2, 1, bz = 10 at res1,
    res2, res3). Both sides compile one full forward per dtype and read
    every `stop_at` prefix from it (tests/test_torch_model.py:_run_both),
    JAX's SubM through its XLA route.
    * fp32: every prefix and the full outputs within 5e-3, with K2's seam
      (`sparse_enc_packed.subm_ext_conv`) swapped, for fp32 inputs, for an
      fp32 conv of unrounded operands, K2's epilogue kept: JAX's fp32 XLA
      route does
      not round the SubM operands to bf16, K2 does (its own numerics are
      held in the bf16 case and in tests/test_torch_subm_conv.py);
    * bf16: the port as it runs (K2's plain version on bf16 operands)
      against JAX's bf16 forward, per output within 2x (max) and 1.5x
      (mean) of JAX's own bf16-vs-fp32 drift, equal dtypes at every
      prefix, and the coarse argmax and the refined cells within 2x JAX's
      own share of changes (as `parity.check` holds the card).
(b) The camera-only model, tiny_config(use_lidar=False): no LiDAR branch
    and no fuser, so the semantic stack reads img_voxel and takes its width
    from it (JAX coocc_ray.py:287-288); every prefix, the same bounds, and
    the state_dict round trip through convert_coocc_ray.
(c) ResNet-101 against JAX's at a 64x96 image: fp32 within 1e-4 of each
    of the four stages' max |x|, bf16 within 2x / 1.5x of JAX's own drift.
(d) eval_step with a visible mask on the tiny OpenOccupancy model: all its
    hists, SC_hist_visible and SSC_hist_visible among them, equal JAX's
    make_eval_step on JAX's forward of the same weights and batch.
(e) coocc_lidar, the stereo config coocc_multi_r50_256x704_stereo and
    coocc_kitti build in each entry point: the served CLI and the bench
    build the model at full width (on the meta device here) and then stop
    for want of a card; the test CLI runs the config's tiny twin
    (`lidar_tiny`, the LiDAR-only model of tests/test_torch_lidar.py;
    tiny_config(stereo=True); `kitti_tiny`, the kitti twin of
    tests/test_torch_kitti.py) on the CPU and prints the SSC table, and the
    train CLI trains the stereo twin for one epoch.
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.config.base import SECOND3DConfig as JaxSECOND3DConfig
from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.nn.resnet2d import ResNet as JaxResNet
from coocc_tpu.parallel.train_step import make_eval_step
from coocc_tpu.train.convert_torch import (ParamTreeBuilder,
                                           convert_coocc_ray, convert_resnet)

from test_torch_model import TOL, _common_fine, _run_both
from test_torch_packed_encoder import _fp32_subm as fp32_k2

from coocc_tpu_torch import __main__ as served_cli
from coocc_tpu_torch import bench
from coocc_tpu_torch import entry as torch_entry
from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.config.base import SECOND3DConfig
from coocc_tpu_torch.convert import state_dict_from_jax
from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import build_model, init_flax, init_weights
from coocc_tpu_torch.models.coocc_ray import STAGES, CoOccRay
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.nn.resnet2d import ResNet
from coocc_tpu_torch.parallel.train_step import eval_step
from coocc_tpu_torch.test import __main__ as test_cli
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

OCC, LIDAR, DS = (32, 32, 40), (64, 64, 80), (4, 4, 4)


def occ_grid(cfg, occ, ds):
    """cfg's grid with cells of `ds` occupancy voxels of an `occ` grid."""
    pc = cfg.point_cloud_range
    return dataclasses.replace(cfg.grid, **{
        f"{a}bound": (pc[i], pc[i + 3], (pc[i + 3] - pc[i]) / occ[i] * ds[i])
        for i, a in enumerate("xyz")})


def openocc_tiny(tiny, occ=OCC, lidar=LIDAR):
    """tiny() shaped like coocc_multi_r101_openoccupancy (module note),
    for either package's tiny_config; `occ` and `lidar` keep the
    config's ratio of 8 LiDAR cells to a coarse cell."""
    cfg = tiny()
    pc = cfg.point_cloud_range
    extent = [pc[i + 3] - pc[i] for i in range(3)]
    return cfg.replace(
        name="tiny_openoccupancy", gt_format="openoccupancy", occ_size=occ,
        lss_downsample=DS, scale=4, grid=occ_grid(cfg, occ, DS),
        pts=dataclasses.replace(
            cfg.pts, sparse_shape_xyz=lidar,
            voxel_size=tuple(e / n for e, n in zip(extent, lidar))),
        fuser=dataclasses.replace(
            cfg.fuser, window_rx=8, window_ry=8, window_rz=9,
            window_img_rx=6, window_img_ry=6, window_img_rz=7),
        occ_head=dataclasses.replace(cfg.occ_head, cascade_ratio=4,
                                     final_occ_size=occ))


def cam_tiny(tiny):
    return tiny(use_lidar=False)


MODELS = {"openocc": openocc_tiny, "cam": cam_tiny}

HD, LIDAR_OCC = (64, 64, 65), (16, 16, 16)


def lidar_tiny(tiny, second3d_config):
    """tiny(use_camera=False) shaped like coocc_lidar, for either
    package's tiny_config and SECOND3DConfig: the HD encoder on a 64x64x65
    LiDAR grid (64 z cells of a 65-cell grid, as coocc_lidar's 8 m at
    0.125 m), the coarse 8x8x8 grid of a 16x16x16 occupancy, SECOND3D at
    one conv a stage after the strided one, OccHead without the cascade."""
    cfg = tiny(use_camera=False)
    pc = cfg.point_cloud_range
    ext = [pc[i + 3] - pc[i] for i in range(3)]
    ds = cfg.lss_downsample
    grid = dataclasses.replace(cfg.grid, **{
        f"{a}bound": (pc[i], pc[i + 3], ext[i] / LIDAR_OCC[i] * ds[i])
        for i, a in enumerate("xyz")})
    return cfg.replace(
        name="tiny_lidar", occ_size=LIDAR_OCC, grid=grid,
        pts=dataclasses.replace(
            cfg.pts, encoder="SparseEncoderHD", sparse_shape_xyz=HD,
            voxel_size=(ext[0] / HD[0], ext[1] / HD[1],
                        ext[2] / (HD[2] - 1))),
        second3d=second3d_config(layer_nums=(1, 1, 1)),
        occ_head=dataclasses.replace(
            cfg.occ_head, sample_from_voxel=False, sample_from_img=False,
            final_occ_size=LIDAR_OCC))


def lidar_configs():
    """(JAX's, the port's) tiny LiDAR-only config."""
    return (lidar_tiny(jax_tiny_config, JaxSECOND3DConfig),
            lidar_tiny(tiny_config, SECOND3DConfig))


def kitti_tiny(make):
    """make(num_classes=20) (either package's tiny_config, which sizes the
    head with it) shaped like coocc_kitti: 20 classes, one camera, the 30-d
    camera vector of KITTI's 3x4 intrinsics, OccHead's 'kitti' branch,
    cascade ratio 2 (the tiny config's)."""
    cfg = make(num_classes=20)
    return cfg.replace(
        name="tiny_kitti", num_classes=20,
        data=dataclasses.replace(cfg.data, cams=("CAM_LEFT",)),
        lss=dataclasses.replace(cfg.lss, cam_channels=30),
        occ_head=dataclasses.replace(cfg.occ_head, data_type="kitti"))


_k2 = sparse_enc_packed.subm_ext_conv


def _fp32_subm(x_pb, w27, p, mcell, bn=None, identity=None):
    """On fp32 inputs, K2 with its conv in fp32 on unrounded operands, its
    epilogue kept (tests/test_torch_packed_encoder.py's swap); bf16 inputs
    go to K2 as it runs, so the bf16 forwards are the port's as it runs
    while this stands in the seam."""
    k2 = _k2 if x_pb.dtype != torch.float32 else fp32_k2
    return k2(x_pb, w27, p, mcell, bn, identity)


@pytest.fixture(scope="module")
def runs():
    """{(model, dtype): _run_both's result}, every prefix from one JAX
    compile of the full forward per model and dtype; the four runs in
    threads, so that JAX's compiles overlap."""
    stops = STAGES + (None,)
    out = {}

    def run(name, dtype):
        make = MODELS[name]
        try:
            out[(name, dtype)] = _run_both(
                make(jax_tiny_config), make(tiny_config), stops,
                capture=True, bf16=dtype == "bf16")
        except BaseException as e:  # re-raised below
            out[(name, dtype)] = e
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)  # JAX's XLA route
        mp.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
        _in_threads(run, [(name, dtype) for name in MODELS
                          for dtype in ("fp32", "bf16")])
    for res in out.values():
        if isinstance(res, BaseException):
            raise res
    return out


def _in_threads(fn, args):
    threads = [threading.Thread(target=fn, args=a) for a in args]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def _pairs(result, stop):
    """[(key, JAX's array, the port's)] of one prefix, semantic levels one
    by one."""
    j, t = result[stop]
    assert set(t) == set(j), (stop, set(t), set(j))
    out = []
    for key in j:
        if key == "semantic":
            out += [(f"semantic{i}", a, b) for i, (a, b) in
                    enumerate(zip(j[key], t[key]))]
        else:
            out.append((key, np.asarray(j[key]), np.asarray(t[key])))
    return out


@pytest.mark.parametrize("stop", STAGES)
@pytest.mark.parametrize("name", list(MODELS))
def test_fp32_prefix_matches_jax(runs, name, stop):
    for key, a, b in _pairs(runs[(name, "fp32")], stop):
        assert a.shape == b.shape, key
        if key == "fine_overflow":
            np.testing.assert_array_equal(b, a)
            continue
        assert np.abs(b).max() > 0, f"{key} is all zero"
        np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_fp32_full_outputs_match_jax(runs, name):
    j, t = runs[(name, "fp32")][None]
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    (gc, gl), (rc, rl) = _fine_sorted(t), _fine_sorted(j)
    assert len(rc) > 0
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gl, rl, **TOL)
    assert int(j["fine_overflow"][0]) > 0, "the cap was not exercised"
    # ratio^3 children a refined cell
    r = MODELS[name](tiny_config).occ_head.cascade_ratio
    assert t["fine_coords"].shape[1] == 512 * r ** 3


def _fine_sorted(out):
    """(coords [n, 3], logits [n, C]) of the valid fine rows, sorted by
    their coordinates."""
    v = out["fine_valid"][0]
    c, lg = out["fine_coords"][0][v], out["fine_logits"][0][v]
    order = np.lexsort(c.T[::-1])
    return c[order], lg[order]


def _drift_cases():
    cases = []
    for name in MODELS:
        keys = [("pts", "img_voxel", None)]
        if name == "openocc":
            keys.append(("pts", "pts_voxel", None))
        keys += [("fuse", "voxel_feats", None)] \
            + [("sem", "semantic", i) for i in range(4)] \
            + [(None, "occ", None), (None, "fine_logits", None)]
        cases += [(name, *k) for k in keys]
    return cases


@pytest.mark.parametrize("name,stop,key,level", _drift_cases())
def test_bf16_matches_jax_bf16_within_its_own_drift(runs, name, stop, key,
                                                    level):
    """JAX's fp32 side is its fp32 XLA route; the port's bf16 runs K2's
    plain version, which rounds the SubM operands as JAX's bf16 does."""
    jb, tb = runs[(name, "bf16")][stop]
    jf = runs[(name, "fp32")][stop][0]
    if key == "fine_logits":
        tb, jb, jf = _common_fine(tb, jb, jf)
    else:
        tb, jb, jf = tb[key], jb[key], jf[key]
        if level is not None:
            tb, jb, jf = tb[level], jb[level], jf[level]
    assert tb.shape == jb.shape == jf.shape
    port, own = np.abs(tb - jb), np.abs(jb - jf)
    assert own.max() > 0
    assert port.max() <= 2.0 * own.max(), (port.max(), own.max())
    assert port.mean() <= 1.5 * own.mean(), (port.mean(), own.mean())


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_prefix_dtypes_match_jax(runs, name):
    res = runs[(name, "bf16")]
    for stop in STAGES + (None,):
        dtypes = res["dtypes"][stop]
        assert dtypes, stop
        for key, (jd, td) in dtypes.items():
            assert jd == td, (stop, key)


def _refined(out):
    return {c for c, v in zip(map(tuple, out["fine_coords"][0].tolist()),
                              out["fine_valid"][0]) if v}


@pytest.mark.parametrize("name", list(MODELS))
def test_bf16_argmax_and_refined_cells_within_jax_drift(runs, name):
    """The cascade refines the cells whose bf16 coarse argmax is not empty.
    Where two logits lie within a bf16 ulp or two the argmax flips with the
    summation order (the tiny OpenOccupancy model's logits sit at 0.4-1.0,
    ulp 2^-8: 8 of its 640 cells flip between the packages, 2 of them
    between empty and not, which shifts the id-ordered cap). As
    `parity.check` holds the card: the share of coarse argmaxes that differ
    from JAX's bf16, and of JAX bf16's refined cells the port does not
    refine, each within 2x JAX's own bf16-vs-fp32 share plus 0.002."""
    j, t = runs[(name, "bf16")][None]
    jf = runs[(name, "fp32")][None][0]
    am = [o["occ"].argmax(-1) for o in (t, j, jf)]
    port, own = float((am[0] != am[1]).mean()), \
        float((am[1] != am[2]).mean())
    assert own > 0
    assert port <= 2.0 * own + 0.002, (port, own)
    cells = [_refined(o) for o in (t, j, jf)]
    port = 1.0 - len(cells[0] & cells[1]) / len(cells[1])
    own = 1.0 - len(cells[2] & cells[1]) / len(cells[1])
    assert port <= 2.0 * own + 0.002, (port, own)
    print(f"{name} bf16: argmax flips {float((am[0] != am[1]).mean()):.4f} "
          f"(JAX's own {float((am[1] != am[2]).mean()):.4f}), refined cells "
          f"missing {port:.4f} (JAX's own {own:.4f})")


def test_openocc_tiny_packs_like_the_real_config():
    """The tiny OpenOccupancy model's LiDAR Z of 80 gives the real config's
    pack chain: p = 4, 2, 1 at bz = 10, each level p * C = 128 lanes."""
    from coocc_tpu.nn.sparse_enc_packed import _pick_pack
    from coocc_tpu_torch.nn.sparse_enc_packed import pick_pack
    for cfg in (openocc_tiny(tiny_config),
                get_config("coocc_multi_r101_openoccupancy")):
        Z, C = cfg.pts.sparse_shape_xyz[2] // 2, 2 * cfg.pts.base_channel
        chain = []
        for _ in range(3):
            p = pick_pack(C, Z)
            assert p == _pick_pack(C, Z)
            chain.append((p, Z // p, p * C))
            Z, C = Z // 2, 2 * C
        assert chain == [(4, 10, 128), (2, 10, 128), (1, 10, 128)], chain
    cfg = openocc_tiny(tiny_config)
    assert cfg.lss_grid_size == (8, 8, 10)
    assert cfg.fuser.window_img_rx == 6 and cfg.fuser.window_rx == 8


def test_camera_only_model_reads_img_voxel():
    cfg = cam_tiny(tiny_config)
    model = build_model(cfg, "cpu", init=init_flax)
    assert not hasattr(model, "occ_fuser")
    assert not hasattr(model, "pts_middle_encoder")
    proj = model.semantic_encoder.input_proj[0]
    assert proj.weight.shape[1] == cfg.lss.numC_Trans
    real = get_config("coocc_cam_r101_896x1600")
    with torch.device("meta"):
        model = CoOccRay(real)
    assert model.semantic_encoder.input_proj[0].weight.shape[1] == \
        real.lss.numC_Trans


def test_camera_only_state_dict_round_trip():
    """No pts_middle_encoder and no occ_fuser keys on either side."""
    cfg = cam_tiny(tiny_config)
    sd = build_model(cfg, "cpu", seed=11).state_dict()
    assert not any(k.startswith(("pts_middle_encoder", "occ_fuser"))
                   for k in sd)
    variables = convert_coocc_ray({k: v.numpy() for k, v in sd.items()},
                                  cam_tiny(jax_tiny_config))
    assert not {"pts_middle_encoder", "occ_fuser"} & set(variables["params"])
    back = state_dict_from_jax(variables, cfg)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_resnet101_matches_jax():
    net = init_weights(ResNet(101), seed=5).eval()
    rng = np.random.RandomState(6)
    x = rng.rand(1, 64, 96, 3).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        port = {dt: [o.float().permute(0, 2, 3, 1).numpy()
                     for o in net(xt.to(dt))]
                for dt in (torch.float32, torch.bfloat16)}
    b = ParamTreeBuilder()
    convert_resnet(b, {f"bb.{k}": v.numpy()
                       for k, v in net.state_dict().items()}, "bb", "bb",
                   101)
    variables = {"params": b.params["bb"],
                 "batch_stats": b.batch_stats["bb"]}
    ref = {}

    def jax_run(dt, jdt):
        fn = functools.partial(JaxResNet(depth=101, dtype=jdt).apply,
                               train=False)
        jit = jax.jit(fn, compiler_options={
            "xla_allow_excess_precision": False}) if jdt else jax.jit(fn)
        xj = jnp.asarray(x)
        ref[dt] = [np.asarray(o.astype(jnp.float32))
                   for o in jit(variables, xj.astype(jdt) if jdt else xj)]
    # the two compiles in threads
    _in_threads(jax_run, [(torch.float32, None),
                          (torch.bfloat16, jnp.bfloat16)])
    assert len(ref) == 2
    for i in range(4):
        jf, jb = ref[torch.float32][i], ref[torch.bfloat16][i]
        tf, tb = port[torch.float32][i], port[torch.bfloat16][i]
        assert tf.shape == jf.shape == tb.shape
        assert np.abs(jf).max() > 0
        # fp32: summation order only, through 33 bottlenecks
        scale = np.abs(jf).max()
        assert np.abs(tf - jf).max() <= 1e-4 * scale, (i, scale)
        own, diff = np.abs(jb - jf), np.abs(tb - jb)
        assert own.max() > 0, i
        assert diff.max() <= 2.0 * own.max(), (i, diff.max(), own.max())
        assert diff.mean() <= 1.5 * own.mean(), (i, diff.mean(), own.mean())


class _Forward:
    """A stand-in for JAX's CoOccRay in make_eval_step: its `variables`
    are the outputs of JAX's forward (the fixture's), which its apply
    returns, so the hists come from make_eval_step's own code."""

    @staticmethod
    def apply(variables, batch, train=False):
        assert not train
        return dict(variables)


def test_eval_step_visible_hists_equal_jax(runs, monkeypatch):
    monkeypatch.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
    cfg, jcfg = openocc_tiny(tiny_config), openocc_tiny(jax_tiny_config)
    vis = (np.random.RandomState(8).rand(1, *OCC) < 0.6).astype(np.uint8)
    batch = synthetic_batch(cfg, batch_size=1, seed=3)._replace(
        visible_mask=vis)
    model = build_model(cfg, "cpu", seed=7)   # the fixture's weights
    got = eval_step(model, batch.to("cpu"), cfg)
    jbatch = jax_synthetic_batch(jcfg, batch_size=1, seed=3)._replace(
        visible_mask=vis)
    jbatch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                          jbatch, is_leaf=lambda x: x is None)
    j_full = runs[("openocc", "fp32")][None][0]
    ref = make_eval_step(_Forward, jcfg)(
        {k: jnp.asarray(v) for k, v in j_full.items()}, jbatch)
    hists = [k for k in ref if "hist" in k]
    assert {"SC_hist_visible", "SSC_hist_visible", "SC_hist_fine",
            "lidarseg_hist"} <= set(hists)
    assert set(hists) == {k for k in got if "hist" in k}
    for k in hists:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert int(got["SC_hist_visible"].sum()) < int(got["SC_hist"].sum())


KITTI = "coocc_kitti"
STEREO = "coocc_multi_r50_256x704_stereo"


def _served(name, monkeypatch):
    served_cli.main([name, "--requests", "1"])


def _bench(name, monkeypatch):
    monkeypatch.setenv("BENCH_CONFIG", name)
    bench.main()


def _test_cli(name, monkeypatch):
    test_cli.main([name, "--synthetic", "--device", "cpu", "--max-steps",
                   "1"])


@pytest.mark.parametrize("entry", [_served, _bench],
                         ids=["served", "bench"])
def test_kitti_config_builds_in_each_entry_point(entry, monkeypatch):
    """The served CLI and the bench build coocc_kitti's model at full width
    (on the meta device): one 384x1280 camera, the depth net's 30-d camera
    vector, 20 classes, OccHead's 'kitti' branch, cascade ratio 2; then
    they stop where they need the card (on the card its forward raises
    ValueError past the pts prefix: tests/test_torch_kitti.py)."""
    built = []

    def record(cfg, dtype=None):
        built.append(CoOccRay(cfg, dtype))
        return built[-1]
    monkeypatch.setattr(torch_entry, "CoOccRay", record)
    with torch.device("meta"), pytest.raises(
            RuntimeError, match="torch.cuda.is_available"):
        entry(KITTI, monkeypatch)
    model, = built
    assert model.cfg.name == KITTI and model.dtype == torch.bfloat16
    assert model.img_view_transformer.depth_net.bn.weight.shape == (30,)
    head = model.pts_bbox_head
    assert head.cfg.data_type == "kitti" and head.cfg.cascade_ratio == 2
    assert head.fine_mlp[3].weight.shape[0] == 20
    assert model.pts_grid == (64, 64, 8)


def test_kitti_config_runs_through_the_test_cli(monkeypatch, capsys):
    """`python -m coocc_tpu_torch.test coocc_kitti --synthetic --device
    cpu` on the config's tiny twin (its synthetic batch with KITTI's 3x4
    intrinsics): the SSC table names SemanticKITTI's 20 classes."""
    cfg = kitti_tiny(tiny_config)
    monkeypatch.setattr(test_cli, "config_by_name",
                        lambda name: cfg if name == KITTI else None)
    _test_cli(KITTI, monkeypatch)
    out = capsys.readouterr().out
    assert "mIoU" in out and "traffic-sign" in out and "barrier" not in out


@pytest.mark.parametrize("entry", [_served, _bench],
                         ids=["served", "bench"])
def test_stereo_config_builds_in_each_entry_point(entry, monkeypatch):
    """The served CLI and the bench build the stereo config's model at full
    width (on the meta device): the BEVStereo depth net under the mono
    one's name, with the shipped 3 EM rounds over 4 ranges and 8 groups of
    the R50's 256 stage-0 channels, in bf16; then they stop where they
    need the card."""
    from coocc_tpu_torch.nn.lss_stereo import LSSBEVStereo
    built = []

    def record(cfg, dtype=None):
        built.append(CoOccRay(cfg, dtype))
        return built[-1]
    monkeypatch.setattr(torch_entry, "CoOccRay", record)
    with torch.device("meta"), pytest.raises(
            RuntimeError, match="torch.cuda.is_available"):
        entry(STEREO, monkeypatch)
    model, = built
    assert model.cfg.name == STEREO and model.dtype == torch.bfloat16
    net = model.img_view_transformer.depth_net
    assert isinstance(net, LSSBEVStereo)
    assert (net.em_iteration, len(net.range_list), net.num_groups) == \
        (3, 4, 8)
    assert model.img_backbone.out_channels[0] % net.num_groups == 0
    assert net.depth_net.mono_pred.weight.shape[0] == 112


def test_stereo_config_runs_through_the_test_cli(monkeypatch, capsys):
    """`python -m coocc_tpu_torch.test coocc_multi_r50_256x704_stereo
    --synthetic --device cpu` on the config's tiny twin: the previous
    keyframe's images and rig move with the batch; its SSC table."""
    cfg = tiny_config(stereo=True)
    monkeypatch.setattr(test_cli, "config_by_name",
                        lambda name: cfg if name == STEREO else None)
    _test_cli(STEREO, monkeypatch)
    assert "mIoU" in capsys.readouterr().out


def test_stereo_config_trains_through_the_train_cli(monkeypatch):
    """`python -m coocc_tpu_torch.train coocc_multi_r50_256x704_stereo
    --synthetic --device cpu` on the tiny twin: one epoch of one step, its
    eval hook and checkpoint; the similarity net's statistics moved."""
    import contextlib
    import io
    import os
    import tempfile
    from coocc_tpu_torch.train import __main__ as train_cli
    from coocc_tpu_torch.train.checkpoint import CheckpointManager
    cfg = tiny_config(stereo=True)
    monkeypatch.setattr(train_cli, "config_by_name",
                        lambda name: cfg if name == STEREO else None)
    monkeypatch.setitem(__import__("sys").modules, "torch.utils.tensorboard",
                        None)
    key = "img_view_transformer.depth_net.sim_bn0.running_mean"
    with tempfile.TemporaryDirectory() as d:
        wd = os.path.join(d, "stereo")
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main([STEREO, "--synthetic", "--device", "cpu",
                            "--steps-per-epoch", "1", "--max-epochs", "1",
                            "--work-dir", wd])
        tree, epoch = CheckpointManager(wd).restore()
    assert epoch == 0
    # flax's initial running mean is 0
    moved = tree["model"][key]
    assert torch.isfinite(moved).all() and float(moved.abs().max()) > 0


@pytest.mark.parametrize("entry", [_served, _bench],
                         ids=["served", "bench"])
def test_lidar_config_builds_in_each_entry_point(entry, monkeypatch):
    """The served CLI and the bench build coocc_lidar's model at full width
    (on the meta device: the LiDAR-only family, with K2's HD packs), then
    stop where they need the card."""
    built = []

    def record(cfg, dtype=None):
        built.append(CoOccRay(cfg, dtype))
        return built[-1]
    monkeypatch.setattr(torch_entry, "CoOccRay", record)
    with torch.device("meta"), pytest.raises(
            RuntimeError, match="torch.cuda.is_available"):
        entry("coocc_lidar", monkeypatch)
    model, = built
    assert model.cfg.name == "coocc_lidar" and model.dtype == torch.bfloat16
    assert type(model.pts_middle_encoder).__name__ == "PackedEncoderHD"
    assert model.pts_middle_encoder.sparse_shape_xyz == (800, 800, 65)
    assert not hasattr(model, "img_backbone")
    assert not hasattr(model, "occ_fuser")


def test_lidar_config_runs_through_the_test_cli(monkeypatch, capsys):
    """`python -m coocc_tpu_torch.test coocc_lidar --synthetic --device
    cpu` on the config's tiny twin: its SSC table from the coarse occ."""
    cfg = lidar_configs()[1]
    monkeypatch.setattr(test_cli, "config_by_name",
                        lambda name: cfg if name == "coocc_lidar"
                        else None)
    _test_cli("coocc_lidar", monkeypatch)
    assert "mIoU" in capsys.readouterr().out
