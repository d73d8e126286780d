"""The frame generator: its counts, its ray-cast geometry and its
determinism."""
import torch

from occbench import frames, port
from occbench.tests.helpers import tiny_spec


def _cfg_traffic():
    spec = tiny_spec()
    return port.config(spec.config), spec.traffic


def test_same_seed_same_frames():
    cfg, tr = _cfg_traffic()
    a = frames.make_frame(cfg, tr, 2 ** 31 + 3, 1, "cpu")
    b = frames.make_frame(cfg, tr, 2 ** 31 + 3, 1, "cpu")
    c = frames.make_frame(cfg, tr, 2 ** 31 + 4, 1, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["points"], c["points"])
    assert not torch.equal(a["imgs"], c["imgs"])


def test_counts_and_range():
    cfg, tr = _cfg_traffic()
    f = frames.make_frame(cfg, tr, 5, 0, "cpu")
    m = f["points_mask"][0]
    assert f["points"].shape == (1, cfg.pts.max_points, 5)
    assert int(m.sum()) == tr["lidar"]["valid_points"]
    assert bool(m[:tr["lidar"]["valid_points"]].all())
    p = f["points"][0][m]
    lo = torch.tensor(cfg.point_cloud_range[:3])
    hi = torch.tensor(cfg.point_cloud_range[3:])
    assert bool(((p[:, :3] >= lo) & (p[:, :3] < hi)).all())
    # the cloud lies on surfaces: the ground plane or a box
    ground = -tr["lidar"]["sensor_height_m"]
    assert float((p[:, 2] - ground).abs().lt(1e-3).float().mean()) > 0.3
    lags = p[:, 4].unique()
    assert len(lags) == tr["lidar"]["sweeps"]


def test_eval_fields():
    cfg, tr = _cfg_traffic()
    f = frames.make_frame(cfg, tr, 5, 0, "cpu", frames.EVAL_FIELDS)
    assert set(f) == set(frames.EVAL_FIELDS)
    assert f["imgs"].shape[:2] == (1, cfg.data.num_cams)


def test_first_hits_ground_and_box():
    dirs = torch.tensor([[0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0]])
    boxes = torch.tensor([[4.0, -1.0, -2.0, 6.0, 1.0, 1.0]])
    t = frames.first_hits(torch.zeros(3), dirs, boxes, -2.0)
    assert torch.allclose(t[:2], torch.tensor([2.0, 4.0]))
    assert torch.isinf(t[2])
