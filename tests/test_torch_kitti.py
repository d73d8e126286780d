"""SemanticKITTI's surface in the port against the JAX package (CPU).

Held:
  * the camera geometry at function level, on random calibrations of
    several cameras (3x3 and KITTI's 3x4 intrinsics with a baseline column,
    3x3 and 4x4 BDAs with rotation and translation) and on
    tests/test_kitti_round2.py's inputs: get_geometry within 1e-5 of the
    points' scale, get_mlp_input (27-d, 30-d and 33-d) equal, and
    project_points_on_img under 'kitti' and 'nus' within 1e-5 of the uv
    scale with equal masks;
  * the label writer: save_output_semantic_kitti's file byte for byte,
    with validate_semkitti_submission agreeing on a good and a truncated
    submission (the 20-class tables and class_weights(20):
    tests/test_torch_data.py);
  * the kitti twin, tiny_config(num_classes=20) with one camera, the
    30-d camera vector, OccHead's 'kitti' branch and cascade ratio 2, on a
    batch with KITTI's 3x4 intrinsics and a rotated 3x3 BDA (JAX's kitti
    loader gives a 3x3 BDA; a 4x4 one makes the vector 33-d, held above):
    every stop_at prefix in fp32 at 5e-3 (K2's seam swapped for an fp32
    conv, tests/test_torch_configs.py's `_fp32_subm`), in bf16 within 2x
    (max) and 1.5x (mean) of JAX's own bf16-vs-fp32 drift with JAX's
    dtypes, the cells JAX refines, eval_step's hists equal to JAX's
    make_eval_step, and one train step against JAX's value_and_grad at
    tests/test_torch_train.py's fixed bounds;
  * coocc_kitti at full width: JAX's model fails at its fuser
    (coocc_tpu/nn/bifuser.py:64, under jax.eval_shape) and the port's
    forward raises its ValueError there (on the meta device); the img and
    pts prefixes agree in shape and dtype (JAX's eval_shape, the port's
    bf16 prefix on the CPU).
JAX's compiles run in threads beside the port's work
(tests/test_torch_train_configs.py's pattern): each dtype's eval forward
once, every prefix read from it, and one value_and_grad.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.config import get_config as jax_get_config
from coocc_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.evaluation import savers as jax_savers
from coocc_tpu.geometry import frustum as jax_frustum
from coocc_tpu.models.coocc_ray import CoOccRay as JaxCoOccRay
from coocc_tpu.nn.occ_head import project_points_on_img as jax_project
from coocc_tpu.parallel.train_step import make_eval_step
from coocc_tpu.train.convert_torch import convert_coocc_ray

from test_torch_configs import (_Forward, _fine_sorted, _fp32_subm,
                                _in_threads, _pairs, _refined, kitti_tiny)
from test_torch_model import TOL, _common_fine, _run_both
from test_torch_train import (SEED, _jax_step, _leaf_errors, _np, _port_step,
                              _to_port)

from coocc_tpu_torch.config import get_config
from coocc_tpu_torch.config import semantic_kitti
from coocc_tpu_torch.data.synthetic import (kitti_intrinsics,
                                            synthetic_batch, tiny_config)
from coocc_tpu_torch.entry import build_model
from coocc_tpu_torch.evaluation import savers
from coocc_tpu_torch.geometry import frustum
from coocc_tpu_torch.models.coocc_ray import STAGES, Batch, CoOccRay
from coocc_tpu_torch.nn import sparse_enc_packed
from coocc_tpu_torch.nn.occ_head import project_points_on_img
from coocc_tpu_torch.parallel.train_step import eval_step
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

KITTI = "coocc_kitti"


# ---------------------------------------------------------------------------
# the camera geometry
# ---------------------------------------------------------------------------

def _rotation(rs):
    q, r = np.linalg.qr(rs.randn(3, 3))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def _calibration(rs, B, N, intr4, bda4):
    """A random calibration of B samples of N cameras: rotations, focal
    lengths 400-700 px, principal points, an image-augmentation scale and
    turn with a shift, KITTI's 3x4 intrinsics with a baseline column (all
    three rows nonzero) where intr4, and a BDA (a turn about z, a flip,
    and with bda4 a translation)."""
    rots = np.stack([[_rotation(rs) for _ in range(N)] for _ in range(B)])
    trans = rs.randn(B, N, 3).astype(np.float32)
    K = np.zeros((B, N, 3, 3), np.float32)
    K[..., 0, 0] = rs.uniform(400, 700, (B, N))
    K[..., 1, 1] = K[..., 0, 0] * rs.uniform(0.95, 1.05, (B, N))
    K[..., 0, 2] = rs.uniform(300, 700, (B, N))
    K[..., 1, 2] = rs.uniform(150, 250, (B, N))
    K[..., 2, 2] = 1.0
    intrins = K
    if intr4:
        base = rs.uniform(0.2, 0.6, (B, N, 3)).astype(np.float32) \
            * np.array([1.0, -0.1, 0.05], np.float32)
        intrins = np.concatenate([K, (K @ base[..., None])], -1)
    a = rs.uniform(-0.4, 0.4, (B, N))
    s = rs.uniform(0.8, 1.2, (B, N))
    post_rots = np.zeros((B, N, 3, 3), np.float32)
    post_rots[..., 0, 0] = s * np.cos(a)
    post_rots[..., 0, 1] = -s * np.sin(a)
    post_rots[..., 1, 0] = s * np.sin(a)
    post_rots[..., 1, 1] = s * np.cos(a)
    post_rots[..., 2, 2] = 1.0
    post_trans = np.zeros((B, N, 3), np.float32)
    post_trans[..., :2] = rs.uniform(-20, 20, (B, N, 2))
    bda = np.zeros((B, 4, 4) if bda4 else (B, 3, 3), np.float32)
    for b in range(B):
        yaw = rs.uniform(-np.pi, np.pi)
        bda[b, :3, :3] = [[np.cos(yaw), -np.sin(yaw), 0],
                          [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        bda[b, :3, :3] *= np.array([1.0, -1.0 if b % 2 else 1.0, 1.0],
                                   np.float32)[:, None]
        if bda4:
            bda[b, :3, 3] = rs.randn(3)
            bda[b, 3, 3] = 1.0
    return [a.astype(np.float32) for a in (rots, trans, intrins, post_rots,
                                           post_trans, bda)]


LAYOUTS = [(False, False), (True, False), (True, True), (False, True)]
LAYOUT_IDS = ["intr3-bda3", "intr4-bda3", "intr4-bda4", "intr3-bda4"]


@pytest.mark.parametrize("intr4,bda4", LAYOUTS, ids=LAYOUT_IDS)
def test_get_geometry_matches_jax(intr4, bda4):
    """Two samples of three cameras: the 3x4 intrinsics' translation
    column is taken off the camera points, a 4x4 BDA moves the points."""
    rs = np.random.RandomState(1)
    calib = _calibration(rs, 2, 3, intr4, bda4)
    fr = frustum.create_frustum((64, 192), 16, (1.0, 9.0, 0.5))
    ref = np.asarray(jax_frustum.get_geometry(
        jnp.asarray(fr), *map(jnp.asarray, calib)))
    got = frustum.get_geometry(torch.from_numpy(fr),
                               *map(torch.from_numpy, calib)).numpy()
    assert got.shape == ref.shape == (2, 3, 16, 4, 12, 3)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-5 * scale, \
        (np.abs(got - ref).max(), scale)
    if intr4 or bda4:
        # the branch moved the points: the 3x3 / 3x3 geometry differs
        calib3 = [calib[0], calib[1], calib[2][..., :3], calib[3], calib[4],
                  calib[5][:, :3, :3]]
        plain = frustum.get_geometry(torch.from_numpy(fr),
                                     *map(torch.from_numpy, calib3)).numpy()
        assert np.abs(plain - got).max() > 1e-2


@pytest.mark.parametrize("intr4,bda", [(False, 3), (True, 3), (True, 4),
                                       (True, None), (False, 4)],
                         ids=["27", "30", "33", "30-no-bda", "27-bda4"])
def test_get_mlp_input_matches_jax(intr4, bda):
    """27-d for 3x3 intrinsics (with any BDA), 30-d for 3x4, 33-d for 3x4
    with a 4x4 BDA (its translation appended); no BDA is the identity."""
    rs = np.random.RandomState(2)
    calib = _calibration(rs, 2, 3, intr4, bda == 4)
    if bda is None:
        calib[5] = None
    width = {(False, 3): 27, (True, 3): 30, (True, 4): 33,
             (True, None): 30, (False, 4): 27}[(intr4, bda)]
    ref = np.asarray(jax_frustum.get_mlp_input(
        *(None if a is None else jnp.asarray(a) for a in calib)))
    got = frustum.get_mlp_input(
        *(None if a is None else torch.from_numpy(a) for a in calib))
    assert got.shape == ref.shape == (2, 3, width)
    np.testing.assert_array_equal(got.numpy(), ref)


def _round2_inputs():
    """tests/test_kitti_round2.py:26-57's inputs: two identity-rotation
    cameras, 3x4 intrinsics with a 7.0 shift column, a 4x4 BDA whose
    translation is 99."""
    rs = np.random.RandomState(0)
    P, N = 50, 2
    pts = rs.rand(P, 3).astype(np.float32) * 10
    rots = np.stack([np.eye(3, dtype=np.float32)] * N)
    trans = rs.randn(N, 3).astype(np.float32)
    post_rots = np.stack([np.eye(3, dtype=np.float32)] * N)
    post_trans = np.zeros((N, 3), np.float32)
    intr4 = np.zeros((N, 3, 4), np.float32)
    intr4[:, :3, :3] = np.array([[100.0, 0, 50], [0, 100.0, 30], [0, 0, 1]])
    intr4[:, 0, 3] = 7.0
    bda4 = np.eye(4, dtype=np.float32)
    bda4[:3, 3] = 99.0
    return [pts, rots, trans, intr4, post_rots, post_trans, bda4]


ROUND2 = dict(pts_range=(0, -25.6, -2, 51.2, 25.6, 4.4), img_hw=(370, 1220),
              occ_whd=(256, 256, 32))


def _project_inputs(intr4, bda4):
    """One sample of three cameras looking along the ego x axis (a random
    turn each), a BDA turned a little (its flip and translation kept), and
    fine voxel coordinates of the kitti grid in front of them."""
    rs = np.random.RandomState(3)
    rots, trans, intrins, post_rots, post_trans, bda = (
        a[0] for a in _calibration(rs, 1, 3, intr4, bda4))
    # cam -> ego: x right, y down, z forward onto ego (-y, -z, x), turned
    base = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    for n in range(3):
        a = rs.uniform(-0.3, 0.3)
        turn = np.array([[np.cos(a), -np.sin(a), 0],
                         [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
        rots[n] = turn @ base
    trans = trans * 0.2
    # a small turn of the BDA, so that the points stay in front
    a = rs.uniform(-0.2, 0.2)
    bda[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    points = (rs.rand(400, 3) * np.array([255, 255, 31])).astype(np.float32)
    return [points, rots, trans, intrins, post_rots, post_trans, bda]


@pytest.mark.parametrize("data_type", ["kitti", "nus"])
@pytest.mark.parametrize("intr4,bda4", LAYOUTS, ids=LAYOUT_IDS)
def test_project_points_on_img_matches_jax(data_type, intr4, bda4):
    """uv within 1e-5 of its scale and equal masks; 'kitti' and any 4x4
    BDA use the rotation block of the inverse BDA only."""
    args = _project_inputs(intr4, bda4)
    kw = dict(pts_range=(0.0, -25.6, -2.0, 51.2, 25.6, 4.4),
              img_hw=(384, 1280), occ_whd=(256, 256, 32),
              data_type=data_type)
    ruv, rm = jax_project(*map(jnp.asarray, args), **kw)
    guv, gm = project_points_on_img(*map(torch.from_numpy, args), **kw)
    ruv, rm = np.asarray(ruv), np.asarray(rm)
    assert guv.shape == ruv.shape == (3, 400, 2)
    np.testing.assert_array_equal(gm.numpy(), rm)
    assert 0 < rm.sum() < rm.size
    scale = np.abs(ruv[rm]).max()
    err = np.abs(guv.numpy() - ruv)[rm].max()
    assert err <= 1e-5 * scale, (err, scale)


def test_project_points_round2_inputs_match_jax():
    """tests/test_kitti_round2.py's inputs under 'kitti': the port equals
    JAX's, and the BDA's translation is dropped (the same uv with it
    zeroed)."""
    pts, rots, trans, intr4, post_rots, post_trans, bda4 = _round2_inputs()
    args = [pts, rots, trans, intr4, post_rots, post_trans]
    ref, rmask = jax_project(*map(jnp.asarray, args), jnp.asarray(bda4),
                             data_type="kitti", **ROUND2)
    got, gmask = project_points_on_img(*map(torch.from_numpy, args),
                                       torch.from_numpy(bda4),
                                       data_type="kitti", **ROUND2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(rmask))
    zero, _ = project_points_on_img(*map(torch.from_numpy, args),
                                    torch.eye(4), data_type="kitti", **ROUND2)
    np.testing.assert_allclose(got.numpy(), zero.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the label writer (the tables: tests/test_torch_data.py)
# ---------------------------------------------------------------------------

def test_label_writer_byte_for_byte_and_validator(tmp_path):
    """The same prediction through both writers gives the same file; both
    validators pass it, and fail a truncated file beside it."""
    pred = np.random.RandomState(4).randint(0, 20, (256, 256, 32))
    files = {}
    for name, mod in (("port", savers), ("jax", jax_savers)):
        root = tmp_path / name
        mod.save_output_semantic_kitti(pred, str(root), "11", "000000")
        files[name] = root / "sequences" / "11" / "predictions" \
            / "000000.label"
    data = {k: f.read_bytes() for k, f in files.items()}
    assert data["port"] == data["jax"]
    assert len(data["port"]) == 256 * 256 * 32 * 2
    labels = np.frombuffer(data["port"], np.uint16)
    assert set(np.unique(labels)) <= set(
        semantic_kitti.KITTI_LEARNING_MAP_INV.values())
    for name, mod in (("port", savers), ("jax", jax_savers)):
        root = str(tmp_path / name)
        assert savers.validate_semkitti_submission(root) \
            == jax_savers.validate_semkitti_submission(root) is True
        labels[:100].tofile(os.path.join(root, "sequences", "11",
                                         "predictions", "000001.label"))
        assert savers.validate_semkitti_submission(root) \
            == jax_savers.validate_semkitti_submission(root) is False


# ---------------------------------------------------------------------------
# the kitti twin
# ---------------------------------------------------------------------------

TWIN_YAW = 0.3


def kitti_batch(batch):
    """Either package's synthetic batch of the twin with KITTI's 3x4
    intrinsics (the port's synthetic_batch gives them for a 'kitti'
    config, JAX's does not) and a BDA turned about z by TWIN_YAW."""
    if batch.intrins.shape[-1] == 3:
        batch = kitti_intrinsics(batch)
    c, s = np.cos(TWIN_YAW), np.sin(TWIN_YAW)
    bda = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return batch._replace(bda=np.broadcast_to(bda, batch.bda.shape).copy())


def test_twin_batch_is_kitti_shaped():
    cfg = kitti_tiny(tiny_config)
    assert cfg.occ_head.out_channel == cfg.num_classes == 20
    assert cfg.occ_head.cascade_ratio == 2
    b = kitti_batch(synthetic_batch(cfg, batch_size=1, seed=3))
    jb = kitti_batch(jax_synthetic_batch(kitti_tiny(jax_tiny_config),
                                         batch_size=1, seed=3))
    assert b.imgs.shape == (1, 1, 64, 192, 3)
    assert b.intrins.shape == (1, 1, 3, 4) and b.bda.shape == (1, 3, 3)
    assert np.abs(b.intrins[..., 3]).min() > 0
    for field, a, r in zip(b._fields, b, jb):
        assert (a is None) == (r is None), field
        if a is not None:
            np.testing.assert_array_equal(a, r, err_msg=field)


@pytest.fixture(scope="module")
def runs():
    """{dtype: _run_both's result} of the twin: every prefix from one JAX
    compile of the full forward per dtype, the two in threads; the
    default packed LiDAR encoder, K2's seam swapped for the fp32 conv on
    fp32 inputs."""
    out = {}

    def run(dtype):
        try:
            out[dtype] = _run_both(
                kitti_tiny(jax_tiny_config), kitti_tiny(tiny_config),
                STAGES + (None,), capture=True, bf16=dtype == "bf16",
                edit=kitti_batch)
        except BaseException as e:  # re-raised below
            out[dtype] = e
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)  # JAX's XLA route
        mp.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
        _in_threads(run, [("fp32",), ("bf16",)])
    for res in out.values():
        if isinstance(res, BaseException):
            raise res
    return out


@pytest.mark.parametrize("stop", STAGES)
def test_fp32_prefix_matches_jax(runs, stop):
    for key, a, b in _pairs(runs["fp32"], stop):
        assert a.shape == b.shape, key
        if key == "fine_overflow":
            np.testing.assert_array_equal(b, a)
            continue
        assert np.abs(b).max() > 0, f"{key} is all zero"
        np.testing.assert_allclose(b, a, err_msg=f"{stop}/{key}", **TOL)


def test_fp32_full_outputs_match_jax(runs):
    """20 classes, ratio^3 = 8 children a refined cell, the same refined
    cells and logits."""
    j, t = runs["fp32"][None]
    assert t["occ"].shape[-1] == 20
    np.testing.assert_allclose(t["occ"], j["occ"], **TOL)
    np.testing.assert_array_equal(t["fine_valid"], j["fine_valid"])
    np.testing.assert_array_equal(t["fine_overflow"], j["fine_overflow"])
    (gc, gl), (rc, rl) = _fine_sorted(t), _fine_sorted(j)
    assert len(rc) > 0
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gl, rl, **TOL)
    assert t["fine_coords"].shape[1] == 512 * 8


def _drift_cases():
    return [("pts", "img_voxel", None), ("pts", "pts_voxel", None),
            ("fuse", "voxel_feats", None)] \
        + [("sem", "semantic", i) for i in range(4)] \
        + [(None, "occ", None), (None, "fine_logits", None)]


@pytest.mark.parametrize("stop,key,level", _drift_cases())
def test_bf16_matches_jax_bf16_within_its_own_drift(runs, stop, key, level):
    jb, tb = runs["bf16"][stop]
    jf = runs["fp32"][stop][0]
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
def test_bf16_prefix_dtypes_match_jax(runs, stop):
    dtypes = runs["bf16"]["dtypes"][stop]
    assert dtypes
    for key, (jd, td) in dtypes.items():
        assert jd == td, (stop, key)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_refines_the_cells_jax_refines(runs, dtype):
    j, t = runs[dtype][None]
    assert _refined(t) == _refined(j)
    assert len(_refined(j)) > 0


def test_eval_step_hists_equal_jax(runs, monkeypatch):
    """The port's eval_step on its own forward (K2's seam swapped, as the
    fixture's) against JAX's make_eval_step on JAX's forward: the coarse
    and fine SC/SSC hists over 20 classes, and lidarseg_hist."""
    monkeypatch.setattr(sparse_enc_packed, "subm_ext_conv", _fp32_subm)
    cfg, jcfg = kitti_tiny(tiny_config), kitti_tiny(jax_tiny_config)
    model = build_model(cfg, "cpu", seed=7)   # the fixture's weights
    got = eval_step(model, kitti_batch(synthetic_batch(
        cfg, batch_size=1, seed=3)).to("cpu"), cfg)
    jbatch = jax.tree.map(
        lambda x: None if x is None else jnp.asarray(x),
        kitti_batch(jax_synthetic_batch(jcfg, batch_size=1, seed=3)),
        is_leaf=lambda x: x is None)
    j_full = runs["fp32"][None][0]
    ref = make_eval_step(_Forward, jcfg)(
        {k: jnp.asarray(v) for k, v in j_full.items()}, jbatch)
    hists = sorted(k for k in ref if "hist" in k)
    assert hists == sorted(k for k in got if "hist" in k) == [
        "SC_hist", "SC_hist_fine", "SSC_hist", "SSC_hist_fine",
        "lidarseg_hist"]
    for k in hists:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["SSC_hist"].shape == (20, 20)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

OUTPUTS = ("occ", "fine_logits", "depth_prob", "voxel_feats",
           "render_depth", "render_rgb")


@pytest.fixture(scope="module")
def step():
    """JAX's fp32 value_and_grad of the twin (dropout off) with the same
    under two 1e-5 relative weight perturbations, in a thread beside the
    port's fp32 wiring step (K2's seam swapped)."""
    jcfg, cfg = kitti_tiny(jax_tiny_config), kitti_tiny(tiny_config)
    sd = build_model(cfg, "cpu", seed=SEED).state_dict()
    variables = convert_coocc_ray({k: v.numpy() for k, v in sd.items()},
                                  jcfg)
    n = int(np.prod(jcfg.lss_grid_size))
    prio = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), 2), 0),
        (n,))))[None]

    def jax_side():
        raw, outs, grads, stats, fn = _jax_step(jcfg, variables, False,
                                                kitti_batch)
        noise = []
        rs = np.random.RandomState(0)
        for _ in range(2):
            pert = jax.tree.map(lambda p: p * (1 + 1e-5 * rs.choice(
                [-1, 1], size=np.shape(p)).astype(np.float32)),
                variables["params"])
            (_, (r, s, o)), g = fn(pert, variables["batch_stats"])
            noise.append((r, o, _to_port(g, s, cfg)))
        return (raw, outs, _to_port(grads, stats, cfg)), noise

    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.delenv("COOCC_PALLAS_SUBM", raising=False)  # JAX's XLA route
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
        job = pool.submit(jax_side)
        wiring = _port_step(cfg, sd, prio, None, True, kitti_batch)
        jax32, noise = job.result()
    return {"cfg": cfg, "sd": sd, "wiring": wiring, "jax32": jax32,
            "noise": noise}


def _own(o, part, key):
    """JAX's own change of one quantity under the perturbations (part 0: a
    raw loss term, 1: an output, 2: a gradient or statistic)."""
    ref = _np(o["jax32"][part][key])
    return max(float(np.abs(_np(n[part][key]) - ref).max())
               for n in o["noise"])


def test_train_raw_loss_terms_match_jax(step):
    raw, jraw = step["wiring"][0], step["jax32"][0]
    assert set(raw) == set(jraw)
    assert {"loss_depth", "loss_depth_render", "loss_rgb"} <= set(raw)
    for k in jraw:
        np.testing.assert_allclose(_np(raw[k]), _np(jraw[k]), rtol=1e-4,
                                   err_msg=f"{k}: JAX's own change "
                                   f"{_own(step, 0, k)}")


@pytest.mark.parametrize("key", OUTPUTS)
def test_train_outputs_match_jax(step, key):
    got, ref = _np(step["wiring"][1][key]), _np(step["jax32"][1][key])
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(got - ref).max()
    assert err <= 1e-3 * scale, (key, err, scale, _own(step, 1, key))


def test_train_refines_the_cells_jax_refines(step):
    outs, jouts = step["wiring"][1], step["jax32"][1]
    np.testing.assert_array_equal(outs["fine_coords"].numpy(),
                                  np.asarray(jouts["fine_coords"]))
    np.testing.assert_array_equal(outs["fine_valid"].numpy(),
                                  np.asarray(jouts["fine_valid"]))
    assert int(outs["fine_valid"].sum()) > 0


def test_train_moved_bn_statistics_match_jax(step):
    stats, ref = step["wiring"][3], step["jax32"][2]
    assert len(stats) > 50
    for k, v in stats.items():
        r = ref[k].numpy()
        err = np.abs(v.numpy() - r).max()
        assert err <= 1e-3 * np.abs(r).max(), (k, err, _own(step, 2, k))


def test_train_gradients_match_jax_within_its_own_conditioning(step):
    """tests/test_torch_train.py's rule: each leaf within 10x JAX's own
    change or 10% of its scale; over the leaves the median relative error
    within 6% and the 90th percentile within 20%; the 30-d camera vector's
    BatchNorm and MLPs have gradients."""
    grads, ref = step["wiring"][2], step["jax32"][2]
    errs = _leaf_errors(grads, ref)
    noise = {k: _own(step, 2, k) for k in errs}
    bad = [(k, e / max(s, 1e-30), noise[k] / max(s, 1e-30))
           for k, (e, s) in errs.items()
           if e > max(10 * noise[k], 0.1 * s)]
    assert not bad, bad
    rel = np.array([e / s for e, s in errs.values() if s > 0])
    assert len(rel) > 200
    assert np.median(rel) <= 0.06, np.median(rel)
    assert np.quantile(rel, 0.9) <= 0.2, np.quantile(rel, 0.9)
    w = grads["img_view_transformer.depth_net.depth_mlp.fc1.weight"]
    assert w.shape[1] == 30 and float(w.abs().max()) > 0


# ---------------------------------------------------------------------------
# coocc_kitti at full width
# ---------------------------------------------------------------------------

def _struct(batch):
    return jax.tree.map(
        lambda x: None if x is None else jax.ShapeDtypeStruct(x.shape,
                                                              x.dtype),
        batch, is_leaf=lambda x: x is None)


@pytest.fixture(scope="module")
def full_width():
    """JAX's coocc_kitti under jax.eval_shape on its synthetic batch with
    KITTI's 3x4 intrinsics: its bf16 img and pts prefixes' shapes and
    dtypes, and the error of its full forward."""
    jcfg = jax_get_config(KITTI)
    jb = _struct(kitti_intrinsics(jax_synthetic_batch(jcfg, 1, seed=0)))
    model = JaxCoOccRay(cfg=jcfg, dtype=jnp.bfloat16)
    rngs = {"params": jax.random.PRNGKey(0)}
    prefix, _ = jax.eval_shape(lambda b: model.init_with_output(
        rngs, b, stop_at="pts"), jb)
    try:
        jax.eval_shape(lambda b: model.init(rngs, b), jb)
        error = None
    except Exception as e:  # noqa: BLE001 (the reference's failure)
        error = e
    return {k: (tuple(v.shape), v.dtype.name) for k, v in prefix.items()}, \
        error


def test_full_width_kitti_fails_at_the_fuser_in_both(full_width):
    """JAX's fuser cannot reshape the 64x64x8 LiDAR grid into the
    128x128x16 one; the port raises ValueError naming both grids before it
    runs, here on the meta device. When the reference config is repaired,
    this test says so."""
    _, error = full_width
    assert isinstance(error, TypeError), error
    assert "(65536, 128)" in str(error) and "(128, 128, 16, 2, 128)" \
        in str(error), error
    cfg = get_config(KITTI)
    batch = synthetic_batch(cfg, batch_size=1, seed=0)
    with torch.device("meta"):
        model = CoOccRay(cfg, torch.bfloat16).eval()
        tb = Batch(*(None if a is None else torch.empty(
            a.shape, dtype=torch.from_numpy(a.reshape(-1)[:1]).dtype)
            for a in batch))
    with pytest.raises(ValueError, match=r"\[64, 64, 8\].*\[128, 128, 16\]"):
        model(tb)
    with pytest.raises(ValueError, match="fuser"):
        model(tb, stop_at="fuse")


def test_full_width_prefixes_match_jax_in_shape_and_dtype(full_width):
    """The port's bf16 img and pts prefixes of coocc_kitti on the CPU (one
    384x1280 camera through R50 with the 30-d camera vector; 350,000
    points on the 512x512x64 LiDAR grid through the packed encoder and its
    13 K2 calls) against JAX's eval_shape: the same shapes and dtypes.
    Shapes only: K2's seam gives zeros of its output's shape and dtype
    here (its plain version at these shapes is about 1 TFLOP of CPU work;
    its values at full width are held by parity/kitti_real.npz and, on the
    card, by chip_smoke.py)."""
    shapes, _ = full_width
    assert shapes == {"img_voxel": ((1, 128, 128, 16, 128), "bfloat16"),
                      "pts_voxel": ((1, 64, 64, 8, 128), "bfloat16")}
    cfg = get_config(KITTI)
    model = build_model(cfg, "cpu", seed=0, dtype=torch.bfloat16)
    batch = synthetic_batch(cfg, batch_size=1, seed=0)
    assert batch.intrins.shape == (1, 1, 3, 4)
    calls = []

    def shape_only(x_pb, w27, p, mcell, bn=None, identity=None):
        calls.append((tuple(x_pb.shape), p, w27.shape[2]))
        return x_pb.new_zeros(*x_pb.shape[:-1], p * w27.shape[2])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sparse_enc_packed, "subm_ext_conv", shape_only)
        out = model(batch.to("cpu"), stop_at="pts")
    got = {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in out.items()}
    assert got == shapes
    assert len(calls) == 13, calls
    assert calls[0] == ((1, 8, 256, 256, 128), 4, 32)
    assert torch.isfinite(out["img_voxel"].float()).all()
