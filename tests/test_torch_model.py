"""The port's eval forward == the JAX CoOccRay, stage by stage (tiny config).

One set of weights: the port's model is seeded, its state_dict goes through
the JAX package's convert_coocc_ray, and both sides run
synthetic_batch(tiny_config, seed=3). The JAX side runs once per module
(module-scoped fixtures), as jitted prefixes.

With pts.impl="dense" pinned on both sides (fp32 throughout), each `stop_at`
prefix (img, pts, fuse, sem, coarse) and the full outputs are compared at
atol=rtol=5e-3 (the tolerance of test_golden_full_model.py; sums in other
orders). The cascade runs once at the tiny config's own cap (512 coarse
cells, fewer than are occupied, so the id-order cap is exercised) and once
uncapped. JAX compiles the full forward once and reads the pts, fuse
and sem prefixes from the modules it captures (`_run_both`'s capture).

The default pts.impl ("auto", the z-packed encoder) runs on both sides with
its SubM convolutions at bf16 operands and fp32 sums (JAX through its Pallas
kernel in interpret mode, COOCC_PALLAS_SUBM=interpret), for the pts prefix
and the full outputs (one JAX jit: pts_voxel is the encoder's output
captured in the full forward). The full outputs hold at 5e-3.
pts_voxel does not: the encoder's nine bf16-rounded SubM layers turn fp32
summation-order differences into bf16 rounding flips that compound
(tests/test_torch_packed_encoder.py), measured max |diff| 0.87% of max
|pts_voxel| and mean 2.3e-4 of it, with 1% of the elements outside 5e-3.
It is held to the encoder test's bf16 bound (max 4%, mean 1e-3 of the
scale); the fuser and the semantic stack average the noise out again.
That fixture (and the bf16 one) compiles only the JAX full forward and
reads the pts, fuse and sem prefixes from the modules it captures.

bf16: the port's CoOccRay(cfg, torch.bfloat16) against JAX's
CoOccRay(cfg, dtype=jnp.bfloat16), default packed encoder, one state_dict.
JAX's SubM takes its XLA route (no COOCC_PALLAS_SUBM), which equals its
Pallas kernel (tests/test_pallas_subm.py), and JAX compiles with
xla_allow_excess_precision off so that it rounds each bf16 op as its code
says, as eager torch does. The yardstick is JAX's own bf16 drift, |jax_bf16
- jax_fp32| with the fp32 side from the packed fixture: per output, max and
mean of |port_bf16 - jax_bf16| within 2x and 1.5x of it. Measured ratios
(max, mean): img_voxel 1.00, 0.72; pts_voxel 1.21, 1.04; voxel_feats 1.01,
0.93; semantic levels 0-3 1.48, 0.92 / 1.33, 0.95 / 0.75, 0.92 / 0.70,
0.93; occ 1.35, 0.96; fine_logits (on the cells both runs refine) 0.64,
0.52. Every prefix returns JAX's dtypes; the coarse argmax picks the same
cells; K1's two masks are equal across packages and dtypes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.train.convert_torch import convert_coocc_ray

from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import FLAGSHIP, build_model, entry, served_model
from coocc_tpu_torch.models.coocc_ray import STAGES, CoOccRay
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)
from torch_rng import DEFAULT_THREADS, torch_threads

TOL = dict(atol=5e-3, rtol=5e-3)


def _uncapped(cfg):
    n_coarse = int(np.prod([s // 2 for s in cfg.occ_size]))
    return dataclasses.replace(cfg, occ_head=dataclasses.replace(
        cfg.occ_head, max_coarse_occupied=n_coarse))


def _with_impl(cfg, impl):
    return dataclasses.replace(cfg, pts=dataclasses.replace(cfg.pts,
                                                            impl=impl))


def _dense(cfg):
    return _with_impl(cfg, "dense")


# the modules whose outputs are the prefixes' (coocc_ray.py:265-309): a
# full JAX forward that captures them gives every prefix with one compile
_CAPTURED = ("img_view_transformer", "pts_middle_encoder", "pts_neck",
             "occ_fuser", "semantic_neck")


def _np(x):
    """-> (float or integer numpy array, dtype name); bf16 widens to fp32."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype)[6:]
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy(), name
    x = np.asarray(x)
    return (x.astype(np.float32) if x.dtype.name == "bfloat16" else x), \
        x.dtype.name


def _run_both(jax_cfg, torch_cfg, stops, capture=False, bf16=False,
              edit=None):
    """-> {stop: (jax outputs, port outputs)} as numpy (bf16 widened to
    fp32), plus "dtypes": {stop: {key: (jax dtype, port dtype)}}.
    edit(batch) -> batch, where given, changes both packages' synthetic
    batch (numpy) alike.

    capture: JAX compiles only its full forward and reads every prefix
    from the modules it captures on the way (_CAPTURED). bf16: both models
    compute in bf16 (the port's dtype=torch.bfloat16, JAX's
    dtype=jnp.bfloat16), and JAX compiles with xla_allow_excess_precision
    off, so that its CPU program rounds each bf16 op where its code says it
    does, as eager torch does; XLA's CPU default keeps fp32 across chains of
    elementwise ops instead."""
    model = build_model(torch_cfg, "cpu", seed=7,
                        dtype=torch.bfloat16 if bf16 else None)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = convert_coocc_ray(sd, jax_cfg)
    edit = edit or (lambda b: b)
    batch_np = edit(jax_synthetic_batch(jax_cfg, batch_size=1, seed=3))
    jbatch = jax.tree.map(lambda x: None if x is None else jnp.asarray(x),
                          batch_np, is_leaf=lambda x: x is None)
    jdtype = jnp.bfloat16 if bf16 else None
    jmodel = JaxCoOccRay(cfg=jax_cfg, dtype=jdtype)
    jit = functools.partial(
        jax.jit, compiler_options={"xla_allow_excess_precision": False}) \
        if bf16 else jax.jit
    tbatch = edit(synthetic_batch(torch_cfg, batch_size=1, seed=3)).to("cpu")
    jax_out = {}

    def jax_prefix(stop):
        if stop not in jax_out:
            # jitted: one compile per prefix costs less than eager dispatch
            fn = functools.partial(jmodel.apply, train=False, stop_at=stop)
            if stop is None and capture:
                fn = functools.partial(
                    fn, mutable=["intermediates"],
                    capture_intermediates=lambda m, _: m.name in _CAPTURED)
                j, state = jit(fn)(variables, jbatch)
                cap = {k: v["__call__"][0]
                       for k, v in state["intermediates"].items()}
                img = cap["img_view_transformer"][0] \
                    if "img_view_transformer" in cap else None
                # the encoder returns fp32; the pts prefix casts it to the
                # model dtype (coocc_ray.py:178); after the HD encoder the
                # pts prefix is SECOND3DFPN's output on the (Z, Y, X) axes
                # (coocc_ray.py:236)
                pts = cap["pts_middle_encoder"].astype(
                    jdtype or jnp.float32) if "pts_middle_encoder" in cap \
                    else None
                if "pts_neck" in cap:
                    pts = cap["pts_neck"].transpose(0, 3, 2, 1, 4).astype(
                        jdtype or jnp.float32)
                jax_out["pts"] = {"img_voxel": img, "pts_voxel": pts}
                # without the fuser the semantic stack reads pts_voxel, or
                # img_voxel (coocc_ray.py:287-288)
                jax_out["fuse"] = {"voxel_feats": cap["occ_fuser"]
                                   if "occ_fuser" in cap
                                   else img if pts is None else pts}
                jax_out["sem"] = {"semantic": list(cap["semantic_neck"])}
            else:
                j = jit(fn)(variables, jbatch)
            jax_out[stop] = j
        return jax_out[stop]

    if capture:
        jax_prefix(None)
    out = {"dtypes": {}}
    for stop in stops:
        # JAX's "img" output is the img_voxel of its "pts" prefix and its
        # "coarse" output the occ of the full forward (coocc_ray.py:265-271,
        # occ_head.py:264-267): those two stages compile no prefix of their own
        if stop == "img":
            j = {"img_voxel": jax_prefix("pts")["img_voxel"]}
        elif stop == "coarse":
            j = {"occ": jax_prefix(None)["occ"]}
        else:
            j = dict(jax_prefix(stop))
        if stop == "sem":
            # the JAX semantic stack returns its z-batch layout [B, Z, X, Y, C]
            j["semantic"] = [a.transpose(0, 2, 3, 1, 4) for a in j["semantic"]]
        t = model(tbatch, stop_at=stop)
        # a branch the config has not (pts_voxel without LiDAR) is None
        jn = {k: [_np(x) for x in v] if isinstance(v, list) else _np(v)
              for k, v in j.items() if v is not None}
        tn = {k: [_np(x) for x in v] if isinstance(v, list) else _np(v)
              for k, v in t.items() if v is not None}
        out[stop] = ({k: [a for a, _ in v] if isinstance(v, list) else v[0]
                      for k, v in jn.items()},
                     {k: [a for a, _ in v] if isinstance(v, list) else v[0]
                      for k, v in tn.items()})
        out["dtypes"][stop] = {
            k: ([d for _, d in jn[k]] if isinstance(jn[k], list)
                else jn[k][1],
                [d for _, d in tn[k]] if isinstance(tn[k], list)
                else tn[k][1]) for k in jn if k in tn}
    return out


@pytest.fixture(scope="module")
def capped():
    return _run_both(_dense(jax_tiny_config()), _dense(tiny_config()),
                     STAGES + (None,), capture=True)


@pytest.fixture(scope="module")
def uncapped():
    return _run_both(_dense(_uncapped(jax_tiny_config())),
                     _dense(_uncapped(tiny_config())), (None,))


@pytest.fixture(scope="module")
def packed():
    assert jax_tiny_config().pts.impl == tiny_config().pts.impl == "auto"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COOCC_PALLAS_SUBM", "interpret")
        return _run_both(jax_tiny_config(), tiny_config(),
                         (None, "pts", "fuse", "sem"), capture=True)


@pytest.mark.parametrize("stop", STAGES)
def test_stage_matches_jax(capped, stop):
    j, t = capped[stop]
    assert set(t) == set(j)
    for key in j:
        for a, b in zip(np.atleast_1d(j[key]) if key != "semantic"
                        else j[key], t[key] if key == "semantic"
                        else np.atleast_1d(t[key])):
            assert a.shape == b.shape, key
            assert np.abs(b).max() > 0, f"{key} is all zero"
            np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


def _fine_by_coord(out):
    return {tuple(c): l for c, l, v in zip(out["fine_coords"][0],
                                           out["fine_logits"][0],
                                           out["fine_valid"][0]) if v}


@pytest.mark.parametrize("which", ["capped", "uncapped"])
def test_full_outputs_match_jax(capped, uncapped, which):
    j, t = (capped if which == "capped" else uncapped)[None]
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    got, ref = _fine_by_coord(t), _fine_by_coord(j)
    assert len(ref) > 0 and set(got) == set(ref)
    for c in ref:
        np.testing.assert_allclose(got[c], ref[c], err_msg=str(c), **TOL)
    if which == "capped":
        assert int(j["fine_overflow"][0]) > 0, "the cap was not exercised"


def _flips(port, ref, tol):
    """Cells [..., C] whose argmax differs between the port's values and
    JAX's, and whether each such cell is a near-tie in JAX's: its two
    largest values within twice the parity tolerance of each other."""
    flip = port.argmax(-1) != ref.argmax(-1)
    top2 = np.sort(ref, axis=-1)[..., -2:]
    tie = top2[..., 1] - top2[..., 0] <= 2 * (tol["atol"] + tol["rtol"]
                                              * np.abs(top2[..., 1]))
    return flip, bool((tie | ~flip).all())


def test_eval_hists_match_jax(capped):
    """The eval path on the dense fixture's full outputs: the port's
    eval_hists on its outputs against JAX's occupancy_hists,
    scatter_fine_into_pred and lidarseg_hist (with forward_lidarseg) on
    JAX's, on the fixture's batch (no JAX compile of the model). The
    outputs agree to 5e-3, so an argmax may flip where JAX's two largest
    logits lie within twice that: every flipped cell is such a near-tie,
    and each hist differs from JAX's by the flipped cells only (measured:
    no flip at this fixture)."""
    from coocc_tpu.evaluation import ssc_metrics as jsm
    from coocc_tpu.nn.occ_head import forward_lidarseg as jax_lidarseg
    from coocc_tpu.ops.interpolate import resize_trilinear_chlast
    from coocc_tpu_torch.evaluation import ssc_metrics as sm
    from coocc_tpu_torch.nn.occ_head import forward_lidarseg
    from coocc_tpu_torch.parallel.train_step import eval_hists
    j, t = capped[None]
    cfg = _dense(tiny_config())
    C, size = cfg.num_classes, cfg.occ_head.final_occ_size
    nb = synthetic_batch(cfg, batch_size=1, seed=3)
    got = eval_hists({k: torch.from_numpy(v) for k, v in t.items()},
                     nb.to("cpu"), cfg)
    gt = jnp.asarray(nb.gt_occ)
    pred_f = jsm.scatter_fine_into_pred(
        jnp.asarray(j["fine_logits"]), jnp.asarray(j["fine_coords"]),
        jnp.asarray(j["fine_valid"]), size)
    pts, pmask = jnp.asarray(nb.points_occ), jnp.asarray(nb.points_occ_mask)
    jpl = jax_lidarseg(jnp.asarray(j["occ"]), pts, pmask,
                       cfg.point_cloud_range)
    ref = dict(zip(("SC_hist", "SSC_hist"), jsm.occupancy_hists(
        jnp.asarray(j["occ"]), gt, C)))
    ref.update(zip(("SC_hist_fine", "SSC_hist_fine"),
                   jsm.occupancy_hists(pred_f, gt, C)))
    ref["lidarseg_hist"] = jsm.lidarseg_hist(
        jpl, pts[..., -1].astype(jnp.int32), pmask, C)
    assert set(got) == set(ref)
    # the cells (and points) that may flip, per hist
    occ_up = sm.resize_logits(torch.from_numpy(t["occ"]), size).numpy()
    fine_t = sm.scatter_fine_into_pred(
        *(torch.from_numpy(t[k]) for k in ("fine_logits", "fine_coords",
                                           "fine_valid")), size).numpy()
    pl = forward_lidarseg(*(torch.from_numpy(np.asarray(a)) for a in (
        t["occ"], nb.points_occ, nb.points_occ_mask)),
        cfg.point_cloud_range).numpy()
    valid = nb.gt_occ != 255
    checks = {"": _flips(occ_up, np.asarray(resize_trilinear_chlast(
                  jnp.asarray(j["occ"]), size)), TOL),
              "_fine": _flips(fine_t, np.asarray(pred_f), TOL)}
    for tag, (flip, near) in checks.items():
        assert near, f"SSC_hist{tag}: a flip away from a near-tie"
        n = int((flip & valid).sum())
        for k in (f"SC_hist{tag}", f"SSC_hist{tag}"):
            assert int(got[k].sum()) == int(valid.sum()), k
            assert np.abs(got[k].numpy() - np.asarray(ref[k])).sum() \
                <= 2 * n, (k, n)
    flip, near = _flips(pl[..., 1:], np.asarray(jpl)[..., 1:], TOL)
    assert near
    assert np.abs(got["lidarseg_hist"].numpy()
                  - np.asarray(ref["lidarseg_hist"])).sum() \
        <= 2 * int(flip.sum())
    print("eval hists: flipped cells", {k: int((f & valid).sum())
                                         for k, (f, _) in checks.items()},
          "points", int(flip.sum()))


def test_packed_default_pts_matches_jax_kernel_path(packed):
    j, t = packed["pts"]
    ref, got = j["pts_voxel"], t["pts_voxel"]
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref)
    assert err.max() <= 4e-2 * scale, (err.max(), scale)
    assert err.mean() <= 1e-3 * scale, (err.mean(), scale)


def test_packed_default_full_outputs_match_jax(packed):
    j, t = packed[None]
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    got, ref = _fine_by_coord(t), _fine_by_coord(j)
    assert len(ref) > 0 and set(got) == set(ref)
    for c in ref:
        np.testing.assert_allclose(got[c], ref[c], err_msg=str(c), **TOL)


@pytest.mark.parametrize("impl,encoder", [
    ("auto", "PackedLiDAREnc8x"), ("packed", "PackedLiDAREnc8x"),
    ("dense", "DenseLiDAREnc8x"), ("gather", "SparseLiDAREnc8x"),
    ("packed_ztap", "PackedLiDAREnc8x")])
def test_pts_impl_resolves_like_jax(impl, encoder):
    """'auto' is 'packed' for SparseLiDAREnc8x (JAX coocc_ray.py:130-133);
    'gather' is the gather-GEMM encoder; ztap_levels is a layout of the
    packed encoder's blocks, which runs the same function."""
    cfg = tiny_config()
    if impl == "packed_ztap":
        cfg = dataclasses.replace(cfg, pts=dataclasses.replace(
            cfg.pts, impl="packed", ztap_levels=(1,)))
    else:
        cfg = _with_impl(cfg, impl)
    model = CoOccRay(cfg)
    assert type(model.pts_middle_encoder).__name__ == encoder


def test_kitti_config_builds_at_full_width():
    """coocc_kitti builds (on the meta device): one camera, the depth
    net's camera vector 30-d (KITTI's 3x4 intrinsics), OccHead's 'kitti'
    branch with 20 classes and cascade ratio 2, the 8x LiDAR encoder on
    the 512x512x64 grid; its forward past the pts prefix raises ValueError
    (the fuser's grid is not the LiDAR branch's: tests/test_torch_kitti.py
    holds it against JAX's failure there)."""
    cfg = get_config("coocc_kitti")
    with torch.device("meta"):
        model = CoOccRay(cfg)
    net = model.img_view_transformer.depth_net
    assert net.bn.weight.shape == (30,)
    assert net.depth_mlp.fc1.weight.shape[1] == 30
    head = model.pts_bbox_head
    assert (head.cfg.data_type, head.cfg.cascade_ratio) == ("kitti", 2)
    assert head.occ_pred_conv[-1].weight.shape[0] == 20
    assert type(model.pts_middle_encoder).__name__ == "PackedLiDAREnc8x"
    assert model.pts_grid == (64, 64, 8) != cfg.lss_grid_size


def test_stereo_config_builds_lss_bev_stereo():
    """coocc_multi_r50_256x704_stereo at full width: the flagship with
    LSSBEVStereo under img_view_transformer.depth_net (its own
    DepthNetStereo under depth_net again, as the flax scopes nest), the
    key frame's 512-channel neck features in, 128 context channels and
    112 depth bins out, the similarity net on 8 groups."""
    from coocc_tpu_torch.nn.lss_stereo import DepthNetStereo, LSSBEVStereo
    with torch.device("meta"):
        model = CoOccRay(get_config("coocc_multi_r50_256x704_stereo"))
    net = model.img_view_transformer.depth_net
    assert isinstance(net, LSSBEVStereo)
    assert isinstance(net.depth_net, DepthNetStereo)
    assert net.depth_net.reduce_conv.weight.shape[1] == 512
    assert net.depth_net.context_conv.weight.shape[0] == 128
    assert net.dds_pred.weight.shape[0] == 112
    assert net.sim_fc0.weight.shape == (16, 8)
    names = set(model.state_dict())
    assert "img_view_transformer.depth_net.depth_net.msr_deconv0.weight" \
        in names
    assert not any(k.startswith("img_view_transformer.depth_net."
                                "depth_conv") for k in names)


def test_lidar_config_builds_the_lidar_only_family():
    """coocc_lidar (COOCC_Ray_L) at full width: the HD encoder on the
    800x800x65 grid, SECOND3D (128/256/512) and its FPN, the semantic stack
    on the FPN's 128 channels, no image branch, no fuser, no cascade."""
    from coocc_tpu_torch.nn.second3d import SECOND3D, SECOND3DFPN
    from coocc_tpu_torch.nn.sparse_enc_packed_hd import PackedEncoderHD
    cfg = get_config("coocc_lidar")
    with torch.device("meta"):
        model = CoOccRay(cfg)
    assert isinstance(model.pts_middle_encoder, PackedEncoderHD)
    assert model.pts_middle_encoder.sparse_shape_xyz == (800, 800, 65)
    assert isinstance(model.pts_backbone, SECOND3D)
    assert isinstance(model.pts_neck, SECOND3DFPN)
    assert [b[0].weight.shape[0] for b in model.pts_backbone.blocks] == \
        [128, 256, 512]
    assert model.semantic_encoder.input_proj[0].weight.shape[1] == 128
    for name in ("img_backbone", "img_view_transformer", "occ_fuser"):
        assert not hasattr(model, name), name
    assert not model.pts_bbox_head.cascade


@pytest.mark.parametrize("impl,error", [
    ("auto", None), ("packed_hd", None), ("gather", None),
    ("dense", ValueError), ("packed", ValueError)])
def test_hd_impl_resolves_like_jax(impl, error):
    """SparseEncoderHD: 'auto' is 'packed_hd' (JAX coocc_ray.py:134-142),
    'gather' its rulebook form; 'dense' and 'packed' raise ValueError, as
    JAX's do (:180-183)."""
    cfg = get_config("coocc_lidar")
    cfg = _with_impl(cfg, impl)
    if error is None:
        with torch.device("meta"):
            model = CoOccRay(cfg)
        want = "SparseEncoderHD" if impl == "gather" else "PackedEncoderHD"
        assert type(model.pts_middle_encoder).__name__ == want
    else:
        with torch.device("meta"), pytest.raises(error):
            CoOccRay(cfg)


def test_batch_of_two_runs_per_sample():
    """B > 1 runs the per-sample steps in a loop: each sample of a B=2 batch
    gives what it gives alone (to 1e-4: batched convolutions sum in another
    order)."""
    cfg = tiny_config()
    model = build_model(cfg, "cpu", seed=7)
    pair = synthetic_batch(cfg, batch_size=2, seed=4).to("cpu")
    both = model(pair)
    # the second sample: an indexing slip in a per-sample loop shows there
    one = model(type(pair)(*(None if a is None else a[1:2] for a in pair)))
    for key, v in one.items():
        np.testing.assert_allclose(both[key][1:2].numpy(), v.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=key)


@pytest.fixture(scope="module")
def packed_bf16():
    """The default packed encoder in bf16 on both sides. JAX's SubM runs
    through its XLA route (no COOCC_PALLAS_SUBM), which equals its Pallas
    kernel (tests/test_pallas_subm.py) and compiles faster. The port runs
    on torch's default threads here: its refined cells equal JAX's on
    these inputs then (on two threads one near-tie in the bf16 coarse
    argmax flips, test_bf16_refines_the_cells_jax_bf16_refines)."""
    with torch_threads(DEFAULT_THREADS):
        return _run_both(jax_tiny_config(), tiny_config(),
                         STAGES + (None,), capture=True, bf16=True)


def _drift_cases():
    return [("pts", "img_voxel", None), ("pts", "pts_voxel", None),
            ("fuse", "voxel_feats", None)] \
        + [("sem", "semantic", i) for i in range(4)] \
        + [(None, "occ", None), (None, "fine_logits", None)]


def _common_fine(*outs):
    """fine_logits [n, C] of the refined cells every output refines."""
    rows = [_fine_by_coord(o) for o in outs]
    common = sorted(set.intersection(*(set(r) for r in rows)))
    assert len(common) > 0
    return [np.stack([r[c] for c in common]) for r in rows]


@pytest.mark.parametrize("stop,key,level", _drift_cases())
def test_bf16_matches_jax_bf16_within_its_own_drift(packed, packed_bf16,
                                                    stop, key, level):
    jb, tb = packed_bf16[stop]
    jf = packed[stop][0]
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


@pytest.mark.parametrize("stop", STAGES + (None,))
def test_bf16_prefix_dtypes_match_jax(packed_bf16, stop):
    dtypes = packed_bf16["dtypes"][stop]
    assert dtypes
    for key, (jd, td) in dtypes.items():
        assert jd == td, (stop, key)
    if stop is not None:
        assert "bfloat16" in str(dtypes)


def test_bf16_refines_the_cells_jax_bf16_refines(packed_bf16):
    """The cascade's cells come from the argmax of bf16 coarse logits; on
    these inputs no near-tie flips it between the packages."""
    j, t = packed_bf16[None]
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    np.testing.assert_array_equal(t["fine_coords"], j["fine_coords"])
    assert int(j["fine_overflow"][0]) > 0, "the cap was not exercised"


def test_bf16_k1_masks_equal_across_dtypes_and_packages(packed, packed_bf16):
    """K1 reads |feats|.sum(-1) != 0 of the fuser's two inputs: zeros are
    structural there (the masked encoder output, empty frustum cells), so
    the masks do not depend on the dtype or the package."""
    for key in ("img_voxel", "pts_voxel"):
        masks = [np.abs(run["pts"][side][key][0]).sum(-1) != 0
                 for run in (packed_bf16, packed) for side in (0, 1)]
        assert masks[0].any() and not masks[0].all(), key
        for m in masks[1:]:
            np.testing.assert_array_equal(m, masks[0], err_msg=key)


def test_served_flagship_is_bf16_and_entry_stays_fp32():
    """The JAX package's CLIs serve the flagship in its config's bf16
    (tools/test.py:76-78) while __graft_entry__.entry() builds fp32; the
    port's CLI model and entry() do the same. Parameters stay fp32."""
    assert CoOccRay(tiny_config()).dtype == torch.float32
    assert CoOccRay(tiny_config(), torch.bfloat16).dtype == torch.bfloat16
    model, (batch,) = entry("cpu")
    assert model.dtype == torch.float32
    served = served_model(get_config(FLAGSHIP), "cpu")
    assert served.dtype == torch.bfloat16
    assert served.pts_middle_encoder.compute_dtype == torch.bfloat16
    assert {p.dtype for p in served.parameters()} == {torch.float32}
    assert {b.dtype for b in served.buffers()} == {torch.float32}
