"""The port's nuScenes and SemanticKITTI data path against the JAX
package's, bit for bit, on fake trees (numpy only: JAX compiles nothing).

  * A nuScenes tree in the reference's on-disk layout (the layout of
    tests/test_data_round2.py plus sweeps, scene-linked frames with ego
    poses, lidarseg labels, SurroundOcc and OpenOccupancy ground truth, a
    frame without SurroundOcc ground truth and one without lidarseg), and a
    SemanticKITTI tree. On them every key of the port's `get_sample` equals
    JAX's (value, dtype, shape), train and val, from the same RandomState,
    for the tiny camera + LiDAR config (with image and BDA augmentation),
    camera-only, LiDAR-only with render (the camera-free geometry),
    stereo, OpenOccupancy with cal_visible, and kitti; `collate` and the
    prefetched batches equal JAX's.
  * The samplers (`shard_indices`, `group_shard_indices`) equal JAX's over
    several n, batch sizes, worlds, ranks and epochs; `PrefetchIterator`
    keeps the order and raises a worker's error.
  * Each function of load_occupancy, lidar2depth and loading_bevdet equals
    JAX's on the inputs of tests/test_loading_bevdet.py and
    tests/test_panoptic_loader.py (and random ones).
  * The CLIs on the tree, on the CPU: the train CLI over 2 gloo ranks (each
    reading its rows), then the test CLI with --save-by-scene (one
    prediction file per validation token, in its scene's folder); without
    --synthetic or --data-root they exit with an error.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
from PIL import Image

from coocc_tpu.data import loader as jloader
from coocc_tpu.data import nuscenes_dataset as jds
from coocc_tpu.data import semantic_kitti_dataset as jkitti
from coocc_tpu.data.pipelines import lidar2depth as jl2d
from coocc_tpu.data.pipelines import load_occupancy as jocc
from coocc_tpu.data.pipelines import loading_bevdet as jbev
from coocc_tpu.data.synthetic import camera_ring
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config

from coocc_tpu_torch.data import loader as tloader
from coocc_tpu_torch.data import nuscenes_dataset as tds
from coocc_tpu_torch.data import semantic_kitti_dataset as tkitti
from coocc_tpu_torch.data.pipelines import lidar2depth as tl2d
from coocc_tpu_torch.data.pipelines import load_occupancy as tocc
from coocc_tpu_torch.data.pipelines import loading_bevdet as tbev
from coocc_tpu_torch.data.synthetic import tiny_config
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

CAMS = ("CAM_A", "CAM_B")
N_TRAIN, N_VAL = 6, 3
BDA_AUG = dict(rot_lim=(-22.5, 22.5), scale_lim=(0.95, 1.05),
               flip_dx_ratio=0.5, flip_dy_ratio=0.5, flip_dz_ratio=0.0)


def _quat(rng):
    q = rng.randn(4)
    return q / np.linalg.norm(q)


def _cloud(rng, n, path):
    pts = rng.uniform(-9, 9, (n, 5)).astype(np.float32)
    pts[:, 2] *= 0.2
    pts.tofile(path)


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    """A nuScenes tree: 6 train keyframes in 2 scenes (pickled out of
    timestamp order, the dataset sorts them) and 3 val keyframes (a plain
    list pickle); 0, 3 or 12 sweeps each (12 > sweeps_num draws a subset
    in training), lidar2cam on even frames and sensor2lidar on odd ones."""
    root = tmp_path_factory.mktemp("nusc_tree")
    rng = np.random.RandomState(0)
    rots, trans = camera_ring(2, rng)
    for d in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP", "lidarseg",
              "occ/samples", "samples/CAM_A", "samples/CAM_B"):
        os.makedirs(root / d)
    frames = []
    for i in range(N_TRAIN + N_VAL):
        split = "train" if i < N_TRAIN else "val"
        scene = f"sc{i // 3}"
        lidar = root / "samples" / "LIDAR_TOP" / f"f{i}.pcd.bin"
        _cloud(rng, 300 + 20 * i, lidar)
        ts = 1_000_000 * (i + 1)
        sweeps = []
        for j in range((0, 3, 12)[i % 3]):
            p = root / "sweeps" / "LIDAR_TOP" / f"f{i}_{j}.pcd.bin"
            _cloud(rng, 50 + j, p)
            r = np.linalg.qr(rng.randn(3, 3))[0]
            sweeps.append({"data_path": str(p), "timestamp": ts - 50_000 * j,
                           "sensor2lidar_rotation": r * np.sign(
                               np.linalg.det(r)),
                           "sensor2lidar_translation": rng.randn(3) * 0.3})
        cams = {}
        for c, name in enumerate(CAMS):
            rel = f"samples/{name}/f{i}.jpg"
            Image.fromarray((rng.rand(90, 160, 3) * 255).astype(
                np.uint8)).save(root / rel)
            s2l = np.eye(4)
            s2l[:3, :3] = rots[c]
            s2l[:3, 3] = trans[c] + rng.randn(3) * 0.01
            cam = {"data_path": rel,
                   "cam_intrinsic": np.array([[100.0, 0, 80], [0, 100.0, 45],
                                              [0, 0, 1]]),
                   "sensor2lidar_rotation": s2l[:3, :3],
                   "sensor2lidar_translation": s2l[:3, 3]}
            if i % 2 == 0:
                cam["lidar2cam"] = np.linalg.inv(s2l)
            cams[name] = cam
        info = {"token": f"tok{i}", "scene_token": scene,
                "scene_name": f"scene-{i // 3:04d}", "lidar_token": f"lt{i}",
                "lidar_path": str(lidar), "timestamp": ts, "sweeps": sweeps,
                "cams": cams,
                "lidar2ego_rotation": _quat(rng),
                "lidar2ego_translation": rng.randn(3),
                "ego2global_rotation": _quat(rng),
                "ego2global_translation": rng.randn(3) * 10}
        if i != 4:
            seg = f"lidarseg/f{i}_lidarseg.bin"
            rng.randint(0, 32, 300 + 20 * i).astype(np.uint8).tofile(
                root / seg)
            info["lidarseg"] = seg
        if i != 1:
            occ = np.stack([rng.randint(0, 40, 60), rng.randint(0, 40, 60),
                            rng.randint(0, 8, 60), rng.randint(0, 17, 60)],
                           axis=1)
            np.save(root / "occ" / "samples" / f"f{i}.pcd.bin.npy", occ)
        sd = root / "occ2" / f"scene_{scene}" / "occupancy"
        os.makedirs(sd, exist_ok=True)
        np.save(sd / f"lt{i}.npy", np.stack([
            rng.randint(0, 8, 80), rng.randint(0, 40, 80),
            rng.randint(0, 40, 80), rng.randint(0, 17, 80)], axis=1))
        frames.append((split, info))
    train = [f for s, f in frames if s == "train"]
    with open(root / "infos_train.pkl", "wb") as f:
        pickle.dump({"infos": train[::-1]}, f)
    with open(root / "infos_val.pkl", "wb") as f:
        pickle.dump([f for s, f in frames if s == "val"], f)
    return root


def _cfgs(make, kind):
    """The config of `kind`, from the tiny_config of the package `make`."""
    aug = dict(resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True,
               crop_h=(0.0, 0.05), src_size=(90, 160))
    if kind == "cam_lidar":
        cfg = make()
    elif kind == "camera_only":
        cfg = make(use_lidar=False)
    elif kind == "lidar_render":
        cfg = make(use_camera=False)
    elif kind == "stereo":
        cfg = make(stereo=True)
    elif kind == "openocc":
        cfg = make().replace(gt_format="openoccupancy")
    else:
        raise KeyError(kind)
    return cfg.replace(data=dataclasses.replace(cfg.data, **aug))


KINDS = ("cam_lidar", "camera_only", "lidar_render", "stereo", "openocc")


def _datasets(root, kind, is_train):
    occ = root / ("occ2" if kind == "openocc" else "occ")
    ann = root / ("infos_train.pkl" if is_train else "infos_val.pkl")
    kw = dict(is_train=is_train, bda_aug_conf=BDA_AUG,
              cal_visible=kind == "openocc")
    return (jds.NuScenesOccDataset(_cfgs(jax_tiny_config, kind), str(root),
                                   str(ann), str(occ), **kw),
            tds.NuScenesOccDataset(_cfgs(tiny_config, kind), str(root),
                                   str(ann), str(occ), **kw))


def _same(got, ref, where):
    assert sorted(got) == sorted(ref), where
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, (where, k)
        np.testing.assert_array_equal(g, r, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("kind", KINDS)
def test_get_sample_equals_jax(nusc, kind, is_train):
    """Every key of every sample, from the same RandomState: images,
    post-homographies, depth maps, points with their sweeps (a drawn
    subset of 12 in training), BDA, ground truth, lidarseg points, the
    stereo pair's previous frame (a scene's first frame pairs with itself),
    the visible mask."""
    jd, td = _datasets(nusc, kind, is_train)
    assert len(td) == len(jd) and [x["token"] for x in td.infos] == \
        [x["token"] for x in jd.infos]
    np.testing.assert_array_equal(td.group_flags, jd.group_flags)
    for i in range(len(jd)):
        got = td.get_sample(i, np.random.RandomState(100 + i))
        ref = jd.get_sample(i, np.random.RandomState(100 + i))
        _same(got, ref, f"{kind} sample {i}")
        assert ("imgs" in got) == (kind != "lidar_render")
        assert ("points" in got) == (kind != "camera_only")
    if kind == "lidar_render":
        assert "rots" in got and (got["gt_depths"] > 0).any()
    if kind == "openocc":
        assert "visible_mask" in got


def test_sweeps_are_drawn_in_training_only(nusc):
    """The frame of 12 sweeps: training keeps a drawn 10 of them (JAX's
    rng.choice, from the RandomState passed in), eval the first 10."""
    jd, td = _datasets(nusc, "lidar_render", True)
    info = td.infos[2]
    assert len(info["sweeps"]) == 12
    a = tds.load_points_with_sweeps(info, rng=np.random.RandomState(0))
    b = tds.load_points_with_sweeps(info, rng=np.random.RandomState(1))
    e = tds.load_points_with_sweeps(info, test_mode=True)
    assert a.shape != b.shape or not np.array_equal(a, b)
    np.testing.assert_array_equal(e, jds.load_points_with_sweeps(
        info, test_mode=True))
    np.testing.assert_array_equal(a, jds.load_points_with_sweeps(
        info, rng=np.random.RandomState(0)))


def test_pad_points_truncates_and_pads():
    pts = np.random.RandomState(0).randn(30, 5).astype(np.float32)
    for cap in (10, 30, 50):
        got, ref = tds.pad_points(pts, cap), jds.pad_points(pts, cap)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def test_stereo_first_frame_pairs_with_itself(nusc):
    """A scene's first keyframe has no previous one: identity motion."""
    _, td = _datasets(nusc, "stereo", False)
    s = td.get_sample(0, np.random.RandomState(0))
    np.testing.assert_allclose(s["k2s_rots"], np.broadcast_to(
        np.eye(3, dtype=np.float32), s["k2s_rots"].shape), atol=1e-6)
    np.testing.assert_array_equal(s["imgs_prev"], s["imgs"])
    s1 = td.get_sample(1, np.random.RandomState(0))
    assert np.abs(s1["k2s_trans"]).max() > 1e-3


@pytest.mark.parametrize("kind", ["cam_lidar", "lidar_render", "openocc"])
def test_collate_and_prefetched_batches_equal_jax(nusc, kind):
    """collate's Batch fields (int32 ground truth), and the batches of
    prefetch_batches: rank 1 of 2 in training (the group sampler, epoch 1)
    and the val shard, each batch seeded by (seed*9973 + epoch*131 +
    group[0]) mod 2^31 as in JAX."""
    for is_train in (True, False):
        jd, td = _datasets(nusc, kind, is_train)
        samples = ([td.get_sample(i, np.random.RandomState(i))
                    for i in (0, 1)],
                   [jd.get_sample(i, np.random.RandomState(i))
                    for i in (0, 1)])
        got = tds.collate(samples[0], td.cfg)
        ref = jds.collate(samples[1], jd.cfg)
        _same(got._asdict(), ref._asdict(), f"{kind} collate")
        assert got.gt_occ.dtype == np.int32
        kw = dict(epoch=1, is_train=is_train, seed=3, num_workers=2,
                  prefetch=2, process_index=1, process_count=2)
        gb = list(tloader.prefetch_batches(td, td.cfg, 1, **kw))
        rb = list(jloader.prefetch_batches(jd, jd.cfg, 1, **kw))
        assert len(gb) == len(rb) > 0
        for g, r in zip(gb, rb):
            _same(g._asdict(), r._asdict(), f"{kind} prefetched")


@pytest.mark.parametrize("n", [1, 5, 10, 17])
def test_shard_indices_equal_jax(n):
    for epoch in (0, 3):
        for shuffle in (False, True):
            for world in (1, 2, 3):
                for rank in range(world):
                    args = (n, epoch, shuffle, 7, rank, world)
                    np.testing.assert_array_equal(
                        tloader.shard_indices(*args),
                        jloader.shard_indices(*args))


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_group_shard_indices_equal_jax(groups):
    """DistributedGroupSampler semantics: each rank's indices equal JAX's,
    every index appears, every batch is single-group."""
    rng = np.random.RandomState(groups)
    for n in (1, 7, 12):
        flags = rng.randint(0, groups, n).astype(np.uint8)
        for B in (1, 2, 3):
            for world in (1, 2, 4):
                got_all = []
                for rank in range(world):
                    for epoch in (0, 1):
                        args = (flags, B, epoch, 11, rank, world)
                        got = tloader.group_shard_indices(*args)
                        np.testing.assert_array_equal(
                            got, jloader.group_shard_indices(*args))
                        if epoch == 0:
                            got_all.append(got)
                        for b in got.reshape(-1, B):
                            assert len(set(flags[b])) == 1
                assert set(np.concatenate(got_all)) == set(range(n))


def test_rank_and_world_default_to_one_process():
    assert tloader.rank_and_world() == (0, 1)
    assert tloader.rank_and_world(2, 4) == (2, 4)
    np.testing.assert_array_equal(
        tloader.shard_indices(6, 0, True, 1),
        jloader.shard_indices(6, 0, True, 1, 0, 1))


def test_prefetch_iterator_order_and_errors():
    """The order of JAX's PrefetchIterator over several workers and
    prefetch depths; a worker's exception is raised in the consumer."""
    for workers, prefetch in ((1, 1), (3, 2), (4, 8)):
        items = list(range(11))
        got = list(tloader.PrefetchIterator(lambda i: i * i, items,
                                            workers, prefetch))
        assert got == list(jloader.PrefetchIterator(
            lambda i: i * i, items, workers, prefetch)) == \
            [i * i for i in items]

    def bad(i):
        if i == 3:
            raise ValueError("boom")
        return i
    it = iter(tloader.PrefetchIterator(bad, list(range(6)), 2, 2))
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_nuscenes_tree_tool_loads_as_jax_loads_it(tmp_path):
    """coocc_tpu_torch/tools/nuscenes_tree.py's tree (here 2 cameras with
    images, 11 sweeps a keyframe, the tiny grid): every sample of both
    splits equals JAX's, for the camera + LiDAR and LiDAR-only configs."""
    from coocc_tpu_torch.tools.nuscenes_tree import write_tree
    f = write_tree(str(tmp_path), seed=1, n_train=2, n_val=1, points=1500,
                   sweeps=11, occupied=800, images=True, cams=CAMS,
                   grid=(40, 40, 8))
    for kind in ("cam_lidar", "lidar_render"):
        for ann, train in ((f["ann_file"], True), (f["val_ann_file"], False)):
            kw = dict(is_train=train, bda_aug_conf=BDA_AUG)
            args = (f["data_root"], ann, f["occ_path"])
            jd = jds.NuScenesOccDataset(
                _cfgs(jax_tiny_config, kind).replace(
                    data=dataclasses.replace(_cfgs(jax_tiny_config, kind).data,
                                             src_size=(900, 1600))),
                *args, **kw)
            td = tds.NuScenesOccDataset(
                _cfgs(tiny_config, kind).replace(
                    data=dataclasses.replace(_cfgs(tiny_config, kind).data,
                                             src_size=(900, 1600))),
                *args, **kw)
            for i in range(len(jd)):
                got = td.get_sample(i, np.random.RandomState(i))
                _same(got, jd.get_sample(i, np.random.RandomState(i)),
                      f"tree {kind} {i}")
                # 11 clouds of 1,500 points (10 of the 11 sweeps drawn in
                # training) past the tiny config's 8,192-point capacity
                assert got["points_mask"].all() and \
                    got["points"].shape[0] == td.cfg.pts.max_points < 16500


def test_nuscenes_tree_cli_writes_the_keyframes_asked_for(tmp_path,
                                                         capsys):
    """`python -m coocc_tpu_torch.tools.nuscenes_tree <dir> --n-train 2
    --n-val 1` writes 2 and 1 keyframes at the default size (34,720
    points and 10 sweeps each) and prints the CLIs' data flags."""
    from coocc_tpu_torch.tools.nuscenes_tree import main
    main([str(tmp_path), "--n-train", "2", "--n-val", "1"])
    words = capsys.readouterr().out.split()
    flags = dict(zip(words[::2], words[1::2]))
    assert sorted(flags) == ["--ann-file", "--data-root", "--occ-path",
                             "--val-ann-file"]
    for key, n in (("--ann-file", 2), ("--val-ann-file", 1)):
        with open(flags[key], "rb") as fh:
            infos = pickle.load(fh)["infos"]
        assert len(infos) == n
        for info in infos:
            assert len(info["sweeps"]) == 10
            pts = np.fromfile(os.path.join(
                flags["--data-root"], info["lidar_path"]), np.float32)
            assert pts.size == 34720 * 5


# --- SemanticKITTI ---------------------------------------------------------

@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_tree")
    rng = np.random.RandomState(1)
    seq = root / "dataset" / "sequences" / "08"
    for d in ("voxels", "image_2", "velodyne"):
        os.makedirs(seq / d)
    P = np.array([[100.0, 0, 80, 4.5], [0, 100.0, 45, 0.2],
                  [0, 0, 1, 0.003]])
    tr = np.eye(4)[:3]
    tr[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]])
    tr[:, 3] = [0.1, -0.2, 0.3]
    with open(seq / "calib.txt", "w") as f:
        for k, m in (("P0", P), ("P1", P), ("P2", P), ("P3", P),
                     ("Tr", tr)):
            f.write(f"{k}: " + " ".join(f"{v:.6e}" for v in m.reshape(-1))
                    + "\n")
    gt = root / "gt" / "08"
    os.makedirs(gt)
    for i in range(3):
        fr = f"{i:06d}"
        open(seq / "voxels" / f"{fr}.bin", "wb").close()
        Image.fromarray((rng.rand(90, 160, 3) * 255).astype(
            np.uint8)).save(seq / "image_2" / f"{fr}.png")
        rng.uniform(-9, 9, (400, 4)).astype(np.float32).tofile(
            seq / "velodyne" / f"{fr}.bin")
        np.save(gt / f"{fr}_1_1.npy", rng.randint(0, 20, (40, 40, 8)))
        if i != 2:
            np.save(gt / f"{fr}_1_2.npy", rng.randint(0, 20, (20, 20, 4)))
    return root


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "val"])
def test_kitti_get_sample_equals_jax(kitti, is_train):
    jcfg = _cfgs(jax_tiny_config, "cam_lidar").replace(num_classes=20)
    tcfg = _cfgs(tiny_config, "cam_lidar").replace(num_classes=20)
    kw = dict(split="val", is_train=is_train)
    jd = jkitti.SemanticKITTIOccDataset(jcfg, str(kitti),
                                        str(kitti / "gt"), **kw)
    td = tkitti.SemanticKITTIOccDataset(tcfg, str(kitti),
                                        str(kitti / "gt"), **kw)
    assert len(td) == len(jd) == 3
    np.testing.assert_array_equal(td.group_flags, jd.group_flags)
    calib = os.path.join(kitti, "dataset", "sequences", "08", "calib.txt")
    _same(tkitti.read_calib(calib), jkitti.read_calib(calib), "read_calib")
    for i in range(3):
        _same(td.get_sample(i, np.random.RandomState(i)),
              jd.get_sample(i, np.random.RandomState(i)), f"kitti {i}")


# --- pipelines, function by function ---------------------------------------

def _eq(got, ref):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _eq(g, r)
        return
    if isinstance(ref, dict):
        _same(got, ref, "dict")
        return
    g, r = np.asarray(got), np.asarray(ref)
    assert g.dtype == r.dtype and g.shape == r.shape
    np.testing.assert_array_equal(g, r)


def test_load_occupancy_functions_equal_jax(tmp_path):
    rng = np.random.RandomState(3)
    for seed in range(4):
        _eq(tocc.sample_bda(BDA_AUG, np.random.RandomState(seed)),
            jocc.sample_bda(BDA_AUG, np.random.RandomState(seed)))
    for args in ((0.0,), (30.0, 1.0, True), (-12.5, 1.0, True, True, True)):
        _eq(tocc.bda_matrix(*args), jocc.bda_matrix(*args))
    occ = np.stack([rng.randint(0, 8, 40), rng.randint(0, 8, 40),
                    rng.randint(0, 4, 40), rng.randint(0, 5, 40)], 1)
    for sem in (True, False):
        _eq(tocc.densify_surroundocc(occ.astype(np.float32), (8, 8, 4), sem),
            jocc.densify_surroundocc(occ.astype(np.float32), (8, 8, 4), sem))
    np.save(tmp_path / "gt.npy", occ)
    _eq(tocc.load_surroundocc_gt(str(tmp_path / "gt.npy"), (8, 8, 4)),
        jocc.load_surroundocc_gt(str(tmp_path / "gt.npy"), (8, 8, 4)))
    coords = rng.randint(0, 4, (200, 3))
    labels = rng.randint(0, 6, 200)
    _eq(tocc.majority_vote_densify(coords, labels, (4, 4, 4)),
        jocc.majority_vote_densify(coords, labels, (4, 4, 4)))
    # tests/test_panoptic_loader.py's inputs, then random ones
    pts = np.array([[0.5, 0.5, 0.5], [0.6, 0.4, 0.2], [0.2, 0.8, 0.9],
                    [1.5, 0.5, 0.5], [2.5, 2.5, 1.5], [9.0, 9.0, 9.0]],
                   np.float32)
    lab = np.array([17001, 17001, 24000, 0, 24000, 24000], np.int64)
    lm = {17: 4, 24: 11, 0: 0}
    pan = ((0.0, 0.0, 0.0, 4.0, 4.0, 2.0), (1.0, 1.0, 1.0), (4, 4, 2))
    _eq(tocc.load_panoptic_voxel_gt(pts, lab, lm, *pan),
        jocc.load_panoptic_voxel_gt(pts, lab, lm, *pan))
    pts = rng.uniform(-1, 5, (300, 3)).astype(np.float32)
    lab = rng.choice([0, 17001, 17002, 24000, 30000], 300)
    _eq(tocc.load_panoptic_voxel_gt(pts, lab, lm, *pan),
        jocc.load_panoptic_voxel_gt(pts, lab, lm, *pan))
    pcr = (-4.0, -4.0, -2.0, 4.0, 4.0, 2.0)
    _eq(tocc.world_to_voxel(pts, pcr, (1.0, 1.0, 0.5)),
        jocc.world_to_voxel(pts, pcr, (1.0, 1.0, 0.5)))
    sd = tmp_path / "scene_s1" / "occupancy"
    os.makedirs(sd)
    np.save(sd / "tokA.npy", np.stack([
        rng.randint(0, 4, 50), rng.randint(0, 8, 50),
        rng.randint(0, 8, 50), rng.randint(0, 17, 50)], 1))
    bda = jocc.bda_matrix(15.0, 1.0, True)
    for kw in (dict(), dict(bda_rot=bda, return_coords=True)):
        _eq(tocc.load_openoccupancy_gt(str(tmp_path), "s1", "tokA",
                                       (8, 8, 4), pcr, **kw),
            jocc.load_openoccupancy_gt(str(tmp_path), "s1", "tokA",
                                       (8, 8, 4), pcr, **kw))
    _eq(tocc.visible_mask_lidar(pts, pcr, (8, 8, 4)),
        jocc.visible_mask_lidar(pts, pcr, (8, 8, 4)))
    _, world, vox, _ = jocc.load_openoccupancy_gt(
        str(tmp_path), "s1", "tokA", (8, 8, 4), pcr, bda, True)
    rots, trans = camera_ring(2, rng)
    intr = np.tile(np.array([[20.0, 0, 16], [0, 20.0, 12], [0, 0, 1]]),
                   (2, 1, 1))
    pr, pt = np.tile(np.eye(3), (2, 1, 1)), np.zeros((2, 3))
    _eq(tocc.visible_mask_camera(world, vox, rots, trans, intr, pr, pt,
                                 (24, 32), (8, 8, 4)),
        jocc.visible_mask_camera(world, vox, rots, trans, intr, pr, pt,
                                 (24, 32), (8, 8, 4)))


def test_lidar2depth_functions_equal_jax():
    rng = np.random.RandomState(4)
    rots, trans = camera_ring(3, rng)
    pts = rng.uniform(-9, 9, (500, 3))
    pr = np.tile(np.eye(3), (3, 1, 1))
    pr[:, :2, :2] *= 0.8
    pt = rng.randn(3, 3)
    for intr in (np.tile(np.array([[50.0, 0, 40], [0, 50.0, 30],
                                   [0, 0, 1]]), (3, 1, 1)),
                 np.tile(np.array([[50.0, 0, 40, 1.5], [0, 50.0, 30, 0.1],
                                   [0, 0, 1, 0.01]]), (3, 1, 1))):
        _eq(tl2d.project_points(pts, rots, trans, intr, pr, pt),
            jl2d.project_points(pts, rots, trans, intr, pr, pt))
        _eq(tl2d.create_depth_maps(pts, rots, trans, intr, pr, pt, 60, 80),
            jl2d.create_depth_maps(pts, rots, trans, intr, pr, pt, 60, 80))


def _cam_infos(rng, n=2, H=48, W=96):
    """tests/test_loading_bevdet.py's _synthetic_cam_infos."""
    infos = {}
    for i in range(n):
        intrin = np.array([[W * 0.6, 0, W / 2], [0, W * 0.6, H / 2],
                           [0, 0, 1]], np.float32)
        l2c = np.eye(4)
        l2c[:3, :3] = jbev.quat_to_rot(_quat(rng))
        l2c[:3, 3] = rng.randn(3)
        infos[f"CAM_{i}"] = {
            "data_path": rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
            "cam_intrinsic": intrin, "lidar2cam": l2c,
            "sensor2ego_rotation": _quat(rng),
            "sensor2ego_translation": rng.randn(3),
            "ego2global_rotation": _quat(rng),
            "ego2global_translation": rng.randn(3)}
    return infos


def test_loading_bevdet_functions_equal_jax():
    from coocc_tpu.config.base import DataConfig as JaxDataConfig
    from coocc_tpu_torch.config.base import DataConfig
    rng = np.random.RandomState(0)
    dpts = np.stack([rng.uniform(0, 200, 500), rng.uniform(0, 120, 500),
                     rng.uniform(1, 60, 500)], 1).astype(np.float32)
    for flip, rotate in ((False, 0.0), (True, 5.4), (False, -3.2)):
        args = (dpts, 0.48, (32, 64), (6, 10, 70, 42), flip, rotate)
        _eq(tbev.depth_transform(*args), jbev.depth_transform(*args))
    img = np.random.RandomState(1).randint(0, 256, (8, 10, 3)).astype(
        np.uint8)
    norm = {"mean": [0.0, 0.0, 0.0], "std": [255.0] * 3, "to_rgb": False}
    for cfg in (None, norm):
        _eq(tbev.mmlab_normalize(img, cfg), jbev.mmlab_normalize(img, cfg))
    bgr = np.random.RandomState(2).uniform(0, 255, (5, 7, 3)).astype(
        np.float32)
    _eq(tbev._bgr2hsv(bgr), jbev._bgr2hsv(bgr))
    _eq(tbev._hsv2bgr(jbev._bgr2hsv(bgr)), jbev._hsv2bgr(jbev._bgr2hsv(bgr)))
    pil = Image.fromarray(np.random.RandomState(3).randint(
        0, 256, (16, 24, 3)).astype(np.uint8))
    for seed in range(6):
        _eq(np.asarray(tbev.photometric_distortion(
            pil, np.random.RandomState(seed))),
            np.asarray(jbev.photometric_distortion(
                pil, np.random.RandomState(seed))))
    rng = np.random.RandomState(5)
    for _ in range(3):
        q = _quat(rng)
        _eq(tbev.quat_to_rot(q), jbev.quat_to_rot(q))
        t = rng.randn(3)
        _eq(tbev.rotation_translation_to_pose(q, t),
            jbev.rotation_translation_to_pose(q, t))
    infos = _cam_infos(rng)
    sweep, key = {"cams": infos}, {"cams": _cam_infos(rng)}
    _eq(tbev.sensor2ego_transformation(sweep, key, "CAM_0"),
        jbev.sensor2ego_transformation(sweep, key, "CAM_0"))
    sample = {"ego2global_rotation": _quat(rng),
              "ego2global_translation": rng.randn(3),
              "lidar2ego_rotation": _quat(rng),
              "lidar2ego_translation": rng.randn(3)}
    _eq(tbev.sensor2lidar_transformation(sweep, "CAM_1", sample),
        jbev.sensor2lidar_transformation(sweep, "CAM_1", sample))
    for args in ((0, 1, False, False), (30, 1.1, True, False),
                 (-15, 0.9, True, True)):
        _eq(tbev.bev_transform(*args), jbev.bev_transform(*args))
    pts = rng.randn(100, 5).astype(np.float32)
    for is_train in (True, False):
        _eq(tbev.sample_bda_augmentation(BDA_AUG, is_train,
                                         np.random.RandomState(8)),
            jbev.sample_bda_augmentation(BDA_AUG, is_train,
                                         np.random.RandomState(8)))
        _eq(tbev.load_annotations_bevdepth({"points": pts}, BDA_AUG,
                                           is_train,
                                           np.random.RandomState(8)),
            jbev.load_annotations_bevdepth({"points": pts}, BDA_AUG,
                                           is_train,
                                           np.random.RandomState(8)))
    _eq(tbev.get_ray_direction_with_intrinsics(
        16, 24, infos["CAM_0"]["cam_intrinsic"]),
        jbev.get_ray_direction_with_intrinsics(
            16, 24, infos["CAM_0"]["cam_intrinsic"]))
    kw = dict(cams=("CAM_0", "CAM_1"), input_size=(32, 64),
              src_size=(48, 96), resize=(-0.06, 0.11), rot=(-5.4, 5.4),
              flip=True)
    tcfg, jcfg = DataConfig(**kw), JaxDataConfig(**kw)
    for is_train in (True, False):
        assert tbev.choose_cams(tcfg, is_train, 1, np.random.RandomState(
            0)) == jbev.choose_cams(jcfg, is_train, 1,
                                    np.random.RandomState(0))
        dp = {"CAM_0": dpts[:20]}
        for extra in (dict(depth_points=dp), dict(colorjitter=True,
                                                  n_cams=1)):
            _eq(tbev.load_multi_view_images_bevdet(
                infos, tcfg, is_train, np.random.RandomState(9), **extra),
                jbev.load_multi_view_images_bevdet(
                    infos, jcfg, is_train, np.random.RandomState(9),
                    **extra))
        _eq(tbev.multi_view_pipeline(infos, tcfg, is_train,
                                     np.random.RandomState(10)),
            jbev.multi_view_pipeline(infos, jcfg, is_train,
                                     np.random.RandomState(10)))


# --- the CLIs on the tree ---------------------------------------------------

def _lidar_cfg():
    return _cfgs(tiny_config, "lidar_render")


def test_clis_need_a_named_source(nusc, capsys):
    """Neither --synthetic nor --data-root, both, or a data root that is
    not a directory: the CLI exits with an error before any batch."""
    from coocc_tpu_torch.test.__main__ import main as eval_cli
    from coocc_tpu_torch.train.__main__ import main as train_cli
    for cli, argv in ((train_cli, ["tiny", "--device", "cpu"]),
                      (eval_cli, ["tiny", "--device", "cpu"]),
                      (train_cli, ["tiny", "--synthetic", "--data-root",
                                   str(nusc), "--device", "cpu"]),
                      (eval_cli, ["tiny", "--data-root",
                                  str(nusc / "nowhere"), "--device", "cpu"]),
                      (eval_cli, ["tiny", "--synthetic", "--save-by-scene",
                                  "--pred-save", "p", "--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            cli(argv)
        assert e.value.code == 2
    err = capsys.readouterr().err
    assert "choose the batches' source" in err
    assert "exclude each other" in err and "no such directory" in err


@pytest.fixture(scope="module")
def cli_run(nusc, tmp_path_factory):
    """The train CLI on the tree (the LiDAR-only tiny config with render:
    no image is read) over 2 gloo ranks, 1 step and the eval hook over
    the validation set, each rank its own rows; then the test CLI on its
    work dir with --save-by-scene. The ranks run on 2 intra-op threads
    and without TensorBoard, as tests/test_torch_loop.py runs its."""
    from coocc_tpu_torch.test import __main__ as eval_mod
    from coocc_tpu_torch.train import __main__ as train_mod
    d = tmp_path_factory.mktemp("data_cli")
    wd, preds = str(d / "run"), str(d / "preds")
    fake = d / "no_tb" / "tensorboard"
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("raise ImportError('kept out')\n")
    cfg = _lidar_cfg()
    data = ["--data-root", str(nusc), "--occ-path", str(nusc / "occ")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        mp.syspath_prepend(str(d / "no_tb"))
        mp.setattr(train_mod, "config_by_name", lambda name: cfg)
        mp.setattr(eval_mod, "config_by_name", lambda name: cfg)
        train_mod.main(["tiny", *data,
                        "--ann-file", str(nusc / "infos_train.pkl"),
                        "--val-ann-file", str(nusc / "infos_val.pkl"),
                        "--device", "cpu", "--devices", "2",
                        "--dist-backend", "gloo", "--steps-per-epoch", "1",
                        "--max-epochs", "1", "--work-dir", wd])
        listing = sorted(os.listdir(wd))
        eval_mod.main(["tiny", wd, *data,
                       "--ann-file", str(nusc / "infos_val.pkl"),
                       "--device", "cpu", "--pred-save", preds,
                       "--save-by-scene"])
    return {"wd": wd, "preds": preds, "listing": listing}


def test_train_cli_on_the_tree_writes_its_epoch(cli_run):
    assert cli_run["listing"] == ["best", "ckpt_meta.json", "config.json",
                                  "env.json", "epoch_0", "metrics.jsonl"]


def test_test_cli_saves_one_prediction_per_token_by_scene(cli_run, nusc):
    """--save-by-scene: one npz per validation keyframe, named by its token
    in its scene's folder (tools/test.py:125-131)."""
    with open(nusc / "infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    want = sorted(os.path.join(x["scene_name"], x["token"] + ".npz")
                  for x in infos)
    got = sorted(os.path.join(s, f) for s in os.listdir(cli_run["preds"])
                 for f in os.listdir(os.path.join(cli_run["preds"], s)))
    assert got == want
    cfg = _lidar_cfg()
    with np.load(os.path.join(cli_run["preds"], want[0])) as z:
        # the coarse argmax beside the ground truth, as tools/test.py saves
        assert z["gt"].shape == tuple(cfg.occ_size)
        assert z["pred"].shape == tuple(
            s // d for s, d in zip(cfg.occ_size, cfg.lss_downsample))
