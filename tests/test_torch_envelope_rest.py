"""The rest of the capability envelope, the port against the JAX package on
the CPU:

  * ops/grid_sample.py: grid_sample_2d and grid_sample_3d in every
    align_corners and padding option (points on and past the edges), and
    grid_sample_3d's gradient in its volume (gather_rows) and grid against
    jax.vjp, within 1e-5 of the scale (JAX's products in JAX's order);
  * models/render_ray.py: render_rays in deterministic mode (a stratified
    and an importance pass over a grid_sample_3d feature volume), each
    output within 1e-5 of its scale (1e-4 for the importance pass's
    samples, which pass through a cumsum and a division); Projector's
    projections, masks and samples; the stochastic samplers' properties
    (tests/test_point_ops.py's) with a torch.Generator;
  * evaluation/panoptic.py on tests/test_panoptic.py's cases and a random
    labeling: equal metrics;
  * evaluation/visualize.py and video.py against JAX's on one npz dump:
    equal BEV images and frames, equal PNG pixels, equal GIF bytes on the
    fallback (skipped where matplotlib is missing);
  * utils/profiling.py: StageTimer.report's format, parameter_count equal
    to JAX's for a converted Mask2Former head, flops of a [M, K] x [K, N]
    Dense equal to 2*M*K*N in both packages, a trace written;
  * utils/native.py: csrc/host/coocc_host.cpp byte-equal to
    native/coocc_host.cpp, and the library against JAX's
    coocc_tpu.utils.native and its own numpy versions on
    tests/test_native.py's inputs.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.evaluation import panoptic as jpanoptic
from coocc_tpu.models import render_ray as jrr
from coocc_tpu.nn import mask2former_occ as jm2f
from coocc_tpu.ops import grid_sample as jgs
from coocc_tpu.utils import native as jnative
from coocc_tpu.utils import profiling as jprof

from coocc_tpu_torch.convert import module_state_dict_from_jax
from coocc_tpu_torch.evaluation import panoptic
from coocc_tpu_torch.models import render_ray
from coocc_tpu_torch.nn import mask2former_occ as m2f
from coocc_tpu_torch.ops import grid_sample
from coocc_tpu_torch.utils import native, profiling
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, what, rel):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0, what
    assert np.abs(got - ref).max() <= rel * scale, (
        what, np.abs(got - ref).max(), scale)


# ---------------------------------------------------------------------------
# grid_sample
# ---------------------------------------------------------------------------

def _grid(rng, n, d):
    """Random points in [-1.3, 1.3], the corners exactly, and points just
    past the edges."""
    g = rng.uniform(-1.3, 1.3, (n, d)).astype(np.float32)
    g[:4] = np.array([[-1] * d, [1] * d, [1.0001] * d, [-1.0001] * d],
                     np.float32)
    return g


OPTIONS = [(a, p) for a in (True, False) for p in ("zeros", "border")]


@pytest.mark.parametrize("align_corners,padding_mode", OPTIONS)
def test_grid_sample_2d_matches_jax(align_corners, padding_mode):
    rng = np.random.RandomState(0)
    img = rng.randn(5, 7, 3).astype(np.float32)
    grid = _grid(rng, 60, 2).reshape(3, 20, 2)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    ref = jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(grid), **kw)
    got = grid_sample.grid_sample_2d(_t(img)[None], _t(grid)[None], **kw)[0]
    _close(got.numpy(), ref, "grid_sample_2d", 1e-6)


@pytest.mark.parametrize("align_corners,padding_mode", OPTIONS)
def test_grid_sample_3d_matches_jax(align_corners, padding_mode):
    """Values, and the gradient in the volume and the grid."""
    rng = np.random.RandomState(1)
    vol = rng.randn(4, 5, 6, 3).astype(np.float32)
    grid = _grid(rng, 40, 3).reshape(2, 20, 3)
    cot = rng.randn(2, 20, 3).astype(np.float32)
    kw = dict(align_corners=align_corners, padding_mode=padding_mode)
    ref, vjp = jax.vjp(lambda v, g: jgs.grid_sample_3d(v, g, **kw),
                       jnp.asarray(vol), jnp.asarray(grid))
    gv, gg = vjp(jnp.asarray(cot))
    tv, tg = _t(vol).requires_grad_(), _t(grid).requires_grad_()
    got = grid_sample.grid_sample_3d(tv[None], tg[None], **kw)[0]
    _close(got.detach().numpy(), ref, "grid_sample_3d", 1e-6)
    (got * _t(cot)).sum().backward()
    _close(tv.grad.numpy(), gv, "d vol", 1e-5)
    _close(tg.grad.numpy(), gg, "d grid", 1e-5)


def test_grid_sample_rejects_unknown_padding():
    with pytest.raises(ValueError):
        grid_sample.grid_sample_3d(torch.zeros(1, 2, 2, 2, 1),
                                   torch.zeros(1, 3, 3),
                                   padding_mode="reflection")


# ---------------------------------------------------------------------------
# the ray library
# ---------------------------------------------------------------------------

def _ray_setup():
    """12 rays from around the origin into a [8, 8, 4, 6] feature volume
    over [-4, 4]^2 x [0, 4] (grid_sample_3d, align_corners=False), and a
    fixed linear head: rgb the sigmoid of 3 channels, sigma half the
    softplus of one. A translucent medium: every bin keeps a share of the
    weight. Where a bin's share nears sample_pdf's 1e-5 floor, an
    importance sample moves by ulp(cdf) / share of its bin (JAX's numerics
    as much as the port's), so the fine pass would be held to noise."""
    rng = np.random.RandomState(2)
    R = 12
    ray_o = rng.uniform(-0.5, 0.5, (R, 3)).astype(np.float32)
    ray_d = rng.randn(R, 3).astype(np.float32)
    ray_d[:, 2] = np.abs(ray_d[:, 2]) + 0.5
    ray_d /= np.linalg.norm(ray_d, axis=-1, keepdims=True)
    vol = rng.randn(8, 8, 4, 6).astype(np.float32)
    head = rng.randn(6, 4).astype(np.float32) * 0.5
    lo = np.array([-4, -4, 0], np.float32)
    hi = np.array([4, 4, 4], np.float32)
    return ray_o, ray_d, vol, head, lo, hi


def _jax_fns(vol, head, lo, hi):
    def feature_fn(pts):
        g = (pts - lo) / (hi - lo) * 2 - 1
        # vol is [X, Y, Z, C] = grid_sample's [D, H, W, C]: grid (z, y, x)
        return jgs.grid_sample_3d(jnp.asarray(vol), g[..., ::-1])

    def rgb_sigma_fn(f):
        o = f @ head
        return jax.nn.sigmoid(o[..., :3]), jax.nn.softplus(o[..., 3]) * 0.5
    return feature_fn, rgb_sigma_fn


def _port_fns(vol, head, lo, hi):
    tvol, thead, tlo, thi = (_t(a) for a in (vol, head, lo, hi))

    def feature_fn(pts):
        g = (pts - tlo) / (thi - tlo) * 2 - 1
        R, S, _ = g.shape
        return grid_sample.grid_sample_3d(
            tvol[None], g.flip(-1).reshape(1, R * S, 3))[0].reshape(R, S, -1)

    def rgb_sigma_fn(f):
        o = f @ thead
        return torch.sigmoid(o[..., :3]), torch.nn.functional.softplus(
            o[..., 3]) * 0.5
    return feature_fn, rgb_sigma_fn


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_render_rays_deterministic_matches_jax(white_bkgd):
    ray_o, ray_d, vol, head, lo, hi = _ray_setup()
    ref = jrr.render_rays(jnp.asarray(ray_o), jnp.asarray(ray_d),
                          *_jax_fns(vol, head, lo, hi), 0.3, 5.0,
                          n_samples=24, n_importance=16,
                          white_bkgd=white_bkgd)
    got = render_ray.render_rays(_t(ray_o), _t(ray_d),
                                 *_port_fns(vol, head, lo, hi), 0.3, 5.0,
                                 n_samples=24, n_importance=16,
                                 white_bkgd=white_bkgd)
    assert set(got) == set(ref)
    for k in ref:
        rel = 1e-4 if k.endswith("_fine") else 1e-5
        _close(got[k].numpy(), ref[k], k, rel)


def test_sample_pdf_and_raw2outputs_match_jax():
    rng = np.random.RandomState(3)
    bins = np.sort(rng.uniform(0, 4, (6, 9)), -1).astype(np.float32)
    w = rng.rand(6, 8).astype(np.float32)
    w[0] = 0.0                                    # a flat pdf
    w[1, :7] = 0.0                                # all in the last bin
    ref = jrr.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 11, det=True)
    got = render_ray.sample_pdf(_t(bins), _t(w), 11, det=True)
    _close(got.numpy(), ref, "sample_pdf", 1e-5)
    rgb = rng.rand(6, 8, 3).astype(np.float32)
    sigma = rng.randn(6, 8).astype(np.float32) * 3
    ref = jrr.raw2outputs(jnp.asarray(rgb), jnp.asarray(sigma),
                          jnp.asarray(bins[:, :8]))
    got = render_ray.raw2outputs(_t(rgb), _t(sigma), _t(bins[:, :8]))
    for name, g, r in zip(("rgb", "depth", "weights"), got, ref):
        _close(g.numpy(), r, name, 1e-5)


def test_stochastic_samplers():
    """tests/test_point_ops.py's properties with a torch.Generator: jittered
    depths stay in their bins and increase along each ray; a seed repeats
    its draw and another seed draws anew; a wall at depth 2 renders depth
    ~2; importance samples gather where the weight is."""
    R, S = 4, 16
    ray_o = torch.zeros(R, 3)
    ray_d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(R, 1)

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return render_ray.sample_along_camera_ray(ray_o, ray_d, 0.5, 10.0,
                                                  S, g)
    rs = draw(0)
    assert rs.pts.shape == (R, S, 3)
    edges = torch.linspace(0.5, 10.0, S + 1)
    assert bool(((rs.z_vals >= edges[:-1]) & (rs.z_vals <= edges[1:]))
                .all())
    assert bool((torch.diff(rs.z_vals, dim=-1) > 0).all())
    assert torch.equal(rs.z_vals, draw(0).z_vals)
    assert not torch.equal(rs.z_vals, draw(1).z_vals)

    def rgb_sigma_fn(pts):
        sigma = torch.where(pts[..., 2] > 2.0, 50.0, 0.0)
        return torch.full(pts.shape[:-1] + (3,), 0.5), sigma
    out = render_ray.render_rays(ray_o, ray_d, lambda p: p, rgb_sigma_fn,
                                 0.5, 10.0, n_samples=64, n_importance=32,
                                 generator=torch.Generator().manual_seed(2))
    assert abs(float(out["depth"].mean()) - 2.0) < 0.3
    assert abs(float(out["depth_fine"].mean()) - 2.0) < 0.3
    np.testing.assert_allclose(out["rgb"].numpy(), 0.5 * np.ones((R, 3)),
                               atol=0.05)
    bins = torch.linspace(0.0, 1.0, 9)[None].repeat(2, 1)
    w = torch.zeros(2, 8)
    w[:, 4] = 1.0
    z = render_ray.sample_pdf(bins, w, 64,
                              generator=torch.Generator().manual_seed(3))
    assert float(((z > 0.5) & (z < 0.625)).float().mean()) > 0.8


def test_projector_matches_jax():
    rng = np.random.RandomState(4)
    N, H, W = 2, 48, 64
    intr = np.array([[[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]],
                     [[80.0, 0, 30], [0, 90.0, 20], [0, 0, 1]]], np.float32)
    a = 0.3
    rots = np.stack([np.eye(3), [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                 [-np.sin(a), 0, np.cos(a)]]]).astype(
                                     np.float32)
    trans = np.array([[0, 0, 0], [0.5, -0.2, 0.1]], np.float32)
    pts = np.concatenate([rng.uniform(-2, 2, (40, 2)),
                          rng.uniform(-1, 6, (40, 1))], -1).astype(np.float32)
    pts[0] = [0.0, 0.0, 5.0]
    pts[1] = [100.0, 0.0, 1.0]
    feats = rng.randn(N, 12, 16, 5).astype(np.float32)
    jp = jrr.Projector(jnp.asarray(intr), jnp.asarray(rots),
                       jnp.asarray(trans), (H, W))
    pp = render_ray.Projector(_t(intr), _t(rots), _t(trans), (H, W))
    uv_j, m_j = jp.project(jnp.asarray(pts))
    uv_p, m_p = pp.project(_t(pts))
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(m_j))
    assert bool(m_p[0, 0]) and not bool(m_p[0, 1])
    assert 0 < m_p.float().mean() < 1
    m = np.asarray(m_j)
    _close(uv_p.numpy()[m], np.asarray(uv_j)[m], "uv", 1e-5)
    for align in (True, False):
        s_j, _ = jp.sample(jnp.asarray(feats), jnp.asarray(pts),
                           align_corners=align)
        s_p, _ = pp.sample(_t(np.moveaxis(feats, -1, 1)), _t(pts),
                           align_corners=align)
        _close(s_p.numpy(), s_j, f"samples align_corners={align}", 1e-5)


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------

def _panoptic_cases():
    rng = np.random.RandomState(5)
    sem = np.array([1, 1, 1, 2, 2, 0, 0])
    inst = np.array([5, 5, 5, 7, 7, 0, 0])
    n = 4000
    gs = rng.randint(0, 5, n)
    gi = rng.randint(0, 6, n)
    gs[:100] = 255
    ps = np.where(rng.rand(n) < 0.8, gs, rng.randint(0, 5, n))
    pi = np.where(rng.rand(n) < 0.85, gi, rng.randint(0, 6, n))
    return [
        (dict(num_classes=3), [(sem, inst, sem, inst)]),
        (dict(num_classes=2), [(np.ones(10, int), np.array([1] * 6 + [2] * 4),
                                np.ones(10, int), np.ones(10, int))]),
        (dict(num_classes=5, min_points=20, things=(1, 2, 3)),
         [(ps[:2000], pi[:2000], gs[:2000], gi[:2000]),
          (ps[2000:], pi[2000:], gs[2000:], gi[2000:])]),
        (dict(num_classes=5), [(ps, pi, gs, gi)]),
    ]


@pytest.mark.parametrize("case", range(4))
def test_panoptic_evaluator_matches_jax(case):
    kw, batches = _panoptic_cases()[case]
    ref, got = jpanoptic.PanopticEvaluator(**kw), panoptic.PanopticEvaluator(
        **kw)
    for b in batches:
        ref.add_batch(*b)
        got.add_batch(*b)
    r, g = ref.compute(), got.compute()
    assert r == g
    if case == 0:
        assert g["PQ"] == g["SQ"] == g["RQ"] == 1.0
    if case == 1:
        assert abs(g["SQ"] - 0.6) < 1e-6


def _dump(tmp_path, seed=0, gt=True):
    from coocc_tpu_torch.evaluation.savers import save_output_nuscenes
    rng = np.random.RandomState(seed)
    pred = rng.randint(0, 17, (20, 16, 8)).astype(np.int64)
    pred[rng.rand(20, 16, 8) < 0.5] = 0
    pred[0, 0] = 255
    save_output_nuscenes(pred, str(tmp_path), f"tok_{seed:03d}",
                         gt_voxels=np.roll(pred, 2, 0) if gt else None,
                         scene_name="scene-0001")
    return str(tmp_path / "scene-0001" / f"tok_{seed:03d}.npz")


def test_visualizers_match_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from matplotlib.image import imread

    from coocc_tpu.evaluation import video as jvideo
    from coocc_tpu.evaluation import visualize as jvis
    from coocc_tpu_torch.evaluation import video, visualize
    npz = _dump(tmp_path)
    pred = np.load(npz)["pred"]
    np.testing.assert_array_equal(visualize.NUSC_PALETTE, jvis.NUSC_PALETTE)
    np.testing.assert_array_equal(visualize.bev_image(pred),
                                  jvis.bev_image(pred))
    for up in (1, 3):
        np.testing.assert_array_equal(video.render_frame(npz, upscale=up),
                                      jvideo.render_frame(npz, upscale=up))
    outs = {}
    for name, vis in (("jax", jvis), ("port", visualize)):
        png = vis.save_visualization(npz, str(tmp_path / f"{name}.png"))
        sc = vis.scatter3d(pred, str(tmp_path / f"{name}_3d.png"),
                           max_points=500)
        outs[name] = (imread(png), imread(sc))
    for a, b in zip(outs["jax"], outs["port"]):
        assert a.shape == b.shape and a.size > 0
        np.testing.assert_array_equal(a, b)


def test_video_matches_jax(tmp_path, monkeypatch):
    """make_all_scene_videos over two scenes; the GIF fallback (cv2 made
    unimportable) byte-equal to JAX's."""
    from coocc_tpu.evaluation import video as jvideo
    from coocc_tpu_torch.evaluation import video
    for s in range(3):
        _dump(tmp_path / "preds", s)
    _dump(tmp_path / "preds2", 7, gt=False)
    os.rename(tmp_path / "preds2" / "scene-0001",
              tmp_path / "preds" / "scene-0002")
    outs = video.make_all_scene_videos(str(tmp_path / "preds"),
                                       str(tmp_path / "videos"), fps=5)
    assert [os.path.basename(o)[:10] for o in outs] == ["scene-0001",
                                                        "scene-0002"]
    assert all(os.path.getsize(o) > 0 for o in outs)
    monkeypatch.setitem(sys.modules, "cv2", None)
    scene = str(tmp_path / "preds" / "scene-0001")
    a = jvideo.make_scene_video(scene, str(tmp_path / "jax.mp4"), fps=5)
    b = video.make_scene_video(scene, str(tmp_path / "port.mp4"), fps=5)
    assert a.endswith(".gif") and b.endswith(".gif")
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with pytest.raises(FileNotFoundError):
        video.make_scene_video(str(tmp_path / "videos"))


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_stage_timer_report_matches_jax():
    stats = {"img": [0.01, 0.03], "pts": [0.5], "head": [0.125, 0.125]}
    ref, got = jprof.StageTimer(), profiling.StageTimer()
    for k, v in stats.items():
        ref.stats[k] = list(v)
        got.stats[k] = list(v)
    assert got.report() == ref.report()
    t = profiling.StageTimer()
    with t.stage("mm", torch.ones(3, 3) @ torch.ones(3, 3)):
        pass
    t.record("sum", {"a": [torch.ones(2)]}, 0.0)
    assert set(t.stats) == {"mm", "sum"} and "mm: " in t.report()
    off = profiling.StageTimer(enabled=False)
    with off.stage("x"):
        pass
    assert not off.stats


def test_parameter_count_and_flops_match_jax(tmp_path):
    import flax.linen as fnn
    head = jm2f.Mask2FormerOccHead(feat_channels=32, num_classes=5,
                                   num_queries=8, num_heads=4,
                                   num_decoder_layers=2,
                                   feedforward_channels=64)
    feats = [jnp.zeros((1, *s, 32)) for s in
             ((8, 8, 4), (4, 4, 2), (2, 2, 2), (2, 2, 1))]
    v = jax.tree.map(np.asarray, jax.jit(
        lambda f: head.init(jax.random.PRNGKey(0), f))(feats))
    port = m2f.Mask2FormerOccHead(32, 5, 8, 4, 2, 3, 64)
    port.load_state_dict(module_state_dict_from_jax(port, v), strict=True)
    assert profiling.parameter_count(port) == jprof.parameter_count(
        v["params"]) > 0
    M, K, N = 8, 16, 4
    dense = fnn.Dense(N, use_bias=False)
    dv = dense.init(jax.random.PRNGKey(0), jnp.ones((M, K)))
    ref = jprof.flops_and_bytes(lambda v, x: dense.apply(v, x), dv,
                                jnp.ones((M, K)))
    lin = torch.nn.Linear(K, N, bias=False)
    got = profiling.flops_and_bytes(lin, torch.ones(M, K))
    assert got == {"flops": 2.0 * M * K * N}
    assert ref["flops"] == 2.0 * M * K * N
    with profiling.trace(str(tmp_path / "trace")) as d:
        lin(torch.ones(M, K))
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0


def test_native_source_equals_jax_packages():
    with open(native.SOURCE, "rb") as a, open(
            os.path.join(ROOT, "native", "coocc_host.cpp"), "rb") as b:
        assert a.read() == b.read()
    assert native.library_path().startswith(native.BUILD_DIR)


def test_native_matches_jax_and_numpy():
    """tests/test_native.py's inputs (its `rng` fixture's seed)."""
    rng = np.random.RandomState(0)
    uvd = np.stack([rng.uniform(-2, 12, 500), rng.uniform(-2, 9, 500),
                    rng.uniform(-1, 10, 500)], axis=1).astype(np.float32)
    got = native.zbuffer_depth(uvd, 8, 10)
    np.testing.assert_array_equal(got, jnative.zbuffer_depth(uvd, 8, 10))
    np.testing.assert_array_equal(got, native.zbuffer_depth(uvd, 8, 10,
                                                            impl="numpy"))
    assert (got > 0).sum() > 20

    coords = rng.randint(0, 4, (300, 3)).astype(np.int64)
    labels = rng.randint(1, 6, 300).astype(np.int64)
    got = native.majority_vote(coords, labels, (4, 4, 4))
    np.testing.assert_array_equal(got, jnative.majority_vote(coords, labels,
                                                             (4, 4, 4)))
    np.testing.assert_array_equal(got, native.majority_vote(
        coords, labels, (4, 4, 4), impl="numpy"))

    pts = rng.uniform(-5, 5, (400, 5)).astype(np.float32)
    args = (pts, (-4, -4, -2, 4, 4, 2), (1, 1, 1), (8, 8, 4))
    ids, feats, n = native.voxelize_mean(*args, max_points=10,
                                         max_voxels=64)
    jids, jfeats, jn = jnative.voxelize_mean(*args, max_points=10,
                                             max_voxels=64)
    assert n == jn == 64
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(feats, jfeats)
    nids, nfeats, nn = native.voxelize_mean(*args, max_points=10,
                                            max_voxels=64, impl="numpy")
    order = np.argsort(ids[:n])
    assert nn == n
    np.testing.assert_array_equal(nids[:n], ids[:n][order])
    np.testing.assert_allclose(nfeats[:n], feats[:n][order], rtol=1e-5,
                               atol=1e-5)
    # the vectorized plain version against JAX's sequential oracle, caps
    # binding on voxels and on points
    from coocc_tpu.ops.voxelize import voxelize_oracle
    for max_voxels, max_points in ((64, 10), (400, 2), (10000, 10)):
        jids, jfeats = voxelize_oracle(*args, max_voxels, max_points)
        nids, nfeats = native.voxelize_numpy(*args, max_voxels, max_points)
        np.testing.assert_array_equal(nids, jids)
        np.testing.assert_allclose(nfeats, jfeats, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        native.zbuffer_depth(uvd, 8, 10, impl="fallback")
