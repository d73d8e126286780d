"""The port's epoch loop, checkpoints, run records and CLIs (tiny, CPU).

  * The loop (train/loop.py:train) on tiny_config with lr_step_epochs=(1,):
    2 epochs of 2 steps (synthetic seeds 0, 1), the eval hook on seed 1000
    after each, equal bit for bit to 4 explicit train steps of a Trainer
    with the same initial weights (init_flax) and generator; the LR at each
    update is optax's piecewise_constant_schedule from the JAX package's
    step_lr_schedule (the boundary at update 2, the epoch boundary).
  * Its checkpoint restores bit-equal (weights, BN statistics, AdamW's
    moments and counts, the schedule's count); the train CLI resumes the
    run at epoch 2 (one step, seed 0), with the generator reseeded, and
    its checkpoint equals the explicit Trainer continued the same way.
  * The same sequence of CheckpointManager.save calls gives the same
    ckpt_meta.json and the same directories as the JAX package's
    CheckpointManager; MetricsLogger writes the same records and
    dump_run_metadata the same config.json.
  * `python -m coocc_tpu_torch.train tiny --synthetic --device cpu
    --resume-from <work_dir>` (that resume) and `python -m
    coocc_tpu_torch.test tiny <work_dir> ...` run in-process, the latter
    printing the SSC table; a .pth of the port's state_dict loads back
    equal, a leaf it lacks keeps flax's initial value.

TensorBoard is kept out (its import costs seconds here): MetricsLogger
mirrors to it only where torch.utils.tensorboard imports.
"""
import contextlib
import copy
import dataclasses
import io
import json
import logging
import os
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coocc_tpu.config.base import OptimConfig as JaxOptimConfig
from coocc_tpu.data.synthetic import tiny_config as jax_tiny_config
from coocc_tpu.train.checkpoint import CheckpointManager as JaxCheckpoints
from coocc_tpu.train.observe import MetricsLogger as JaxMetricsLogger
from coocc_tpu.train.observe import dump_run_metadata as jax_dump_metadata
from coocc_tpu.train.state import step_lr_schedule

from coocc_tpu_torch.data.synthetic import synthetic_batch, tiny_config
from coocc_tpu_torch.entry import Trainer, init_flax
from coocc_tpu_torch.evaluation.formatting import format_ssc_table
from coocc_tpu_torch.test.__main__ import load_model
from coocc_tpu_torch.test.__main__ import main as eval_cli
from coocc_tpu_torch.train import __main__ as train_cli
from coocc_tpu_torch.train import loop
from coocc_tpu_torch.train.checkpoint import STATE_FILE, CheckpointManager
from coocc_tpu_torch.train.observe import MetricsLogger, dump_run_metadata
from torch_rng import keep_torch_rng  # noqa: F401 (autouse)
from torch_rng import two_threads  # noqa: F401 (autouse)

LR_STEP = dict(lr_step_epochs=(1,))


def _cfg(max_epochs):
    cfg = tiny_config()
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, max_epochs=max_epochs, **LR_STEP))


def _batches(cfg, seeds):
    return lambda: (synthetic_batch(cfg, batch_size=1, seed=s).to("cpu")
                    for s in seeds)


def _lr(trainer):
    lrs = {g["lr"] for g in trainer.optimizer.adamw.param_groups}
    assert len(lrs) == 1
    return lrs.pop()


def _explicit_steps(trainer, cfg, seeds):
    """-> the LR of each update, taking them."""
    lrs = []
    for s in seeds:
        lrs.append(_lr(trainer))
        trainer.step(synthetic_batch(cfg, batch_size=1, seed=s).to("cpu"))
    return lrs


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _state(trainer):
    """A copy: a state_dict holds the live tensors, which later steps move."""
    return copy.deepcopy({"model": trainer.model.state_dict(),
                          "optimizer": trainer.optimizer.state_dict()})


@pytest.fixture(scope="module")
def no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def _load(path):
    return torch.load(path, weights_only=True)


@pytest.fixture(scope="module")
def run(no_tensorboard):
    with tempfile.TemporaryDirectory() as d:
        wd = os.path.join(d, "run")
        cfg = _cfg(max_epochs=2)
        trained = loop.train(cfg, _batches(cfg, (0, 1)),
                             _batches(cfg, (1000,)), steps_per_epoch=2,
                             work_dir=wd, seed=0, log_interval=1,
                             eval_max_steps=1, device="cpu")
        explicit = Trainer(cfg, "cpu", 0, steps_per_epoch=2, init=init_flax)
        lrs = _explicit_steps(explicit, cfg, (0, 1, 0, 1))
        restored, epoch = CheckpointManager(wd).restore()
        out = {"cfg": cfg, "wd": wd, "trained": _state(trained),
               "explicit": _state(explicit), "lrs": lrs,
               "restored": restored, "restored_epoch": epoch,
               "best": _load(os.path.join(wd, "best", STATE_FILE)),
               "listing": sorted(os.listdir(wd))}
        with open(os.path.join(wd, "ckpt_meta.json")) as f:
            out["meta"] = json.load(f)
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            out["records"] = [json.loads(ln) for ln in f]
        del trained
        # the train CLI resumes the run for a third epoch of one step (seed
        # 0; the schedule's boundary lies behind it either way), on the
        # config above: its --cfg-options reach top-level fields only
        stdout = io.StringIO()
        with pytest.MonkeyPatch.context() as mp, \
                contextlib.redirect_stdout(stdout):
            mp.setattr(train_cli, "config_by_name", lambda name: cfg)
            train_cli.main(["tiny", "--synthetic", "--device", "cpu",
                            "--steps-per-epoch", "1", "--max-epochs", "3",
                            "--resume-from", wd])
        out["train_cli_out"] = stdout.getvalue()
        explicit.generator.manual_seed(0)
        out["lrs"] += _explicit_steps(explicit, cfg, (0,))
        resumed, out["resumed_epoch"] = CheckpointManager(wd).restore()
        out["resumed"] = {k: resumed[k] for k in ("model", "optimizer")}
        out["continued"] = _state(explicit)
        out["listing3"] = sorted(os.listdir(wd))
        with open(os.path.join(wd, "ckpt_meta.json")) as f:
            out["meta3"] = json.load(f)
        with open(os.path.join(wd, "metrics.jsonl")) as f:
            out["records3"] = [json.loads(ln) for ln in f]
        out["pth"] = os.path.join(d, "model.pth")
        yield out


def test_loop_equals_explicit_steps(run):
    _tree_equal(run["trained"], run["explicit"])
    moved = run["trained"]["model"]
    assert any("running_var" in k and not torch.all(v == 1)
               for k, v in moved.items()), "BN statistics did not move"


def test_lr_follows_optax_schedule_across_the_epoch_boundary(run):
    jcfg = dataclasses.replace(JaxOptimConfig(), **LR_STEP)
    sched = step_lr_schedule(jcfg, 2)
    want = [float(sched(jnp.asarray(c))) for c in range(5)]
    assert run["lrs"] == pytest.approx(want, rel=1e-6)
    assert want[1] > want[2], "the boundary did not fall inside the run"


def test_checkpoint_round_trip_is_bit_equal(run):
    assert run["restored_epoch"] == 1 and run["restored"]["epoch"] == 1
    _tree_equal({k: run["restored"][k] for k in ("model", "optimizer")},
                run["trained"])
    assert run["restored"]["optimizer"]["schedule"]["last_epoch"] == 4
    steps = {int(s["step"]) for s in
             run["restored"]["optimizer"]["adamw"]["state"].values()}
    assert steps == {4}
    assert run["listing"] == sorted(
        ["best", "ckpt_meta.json", "config.json", "env.json", "epoch_1",
         "metrics.jsonl"])
    best = run["meta"]["best"]
    assert best["key"] == "SSC_mIoU"
    assert run["best"]["epoch"] == best["epoch"]


def test_resume_starts_at_the_next_epoch(run):
    meta = run["meta3"]
    assert meta["epochs"] == [0, 1, 2] and meta["last_epoch"] == 2
    assert set(meta["metrics"]) == {"0", "1", "2"}
    new = run["records3"][len(run["records"]):]
    assert [(r["kind"], r["epoch"]) for r in new] == [("epoch", 2),
                                                      ("val", 2)]
    assert run["resumed_epoch"] == 2
    _tree_equal(run["resumed"], run["continued"])
    assert run["resumed"]["optimizer"]["schedule"]["last_epoch"] == 5


def test_loop_records(run):
    kinds = [(r["kind"], r["epoch"], r.get("iter")) for r in run["records"]]
    assert kinds == [("train", 0, 1), ("train", 0, 2), ("epoch", 0, None),
                     ("val", 0, None), ("train", 1, 1), ("train", 1, 2),
                     ("epoch", 1, None), ("val", 1, None)]
    val = run["records"][3]
    for k in ("SC_Precision", "SC_Recall", "SC_IoU", "SSC_mIoU",
              "SSC_IoU_per_class", "SSC_mIoU_fine", "SC_IoU_fine",
              "lidarseg_mIoU"):
        assert k in val, k
    for k, v in run["meta"]["metrics"]["0"].items():
        assert np.array_equal(val[k], v, equal_nan=True), k


def test_checkpoint_manager_matches_jax(no_tensorboard):
    """The same saves with the same metrics: JAX's CheckpointManager
    (orbax) and the port's leave the same ckpt_meta.json and directories,
    with max_keep=2, a best that moves and an epoch without metrics."""
    saves = [(0, {"SSC_mIoU": 0.10, "SC_IoU": 0.3}),
             (1, {"SSC_mIoU": 0.05, "SC_IoU": 0.4}),
             (2, {"SSC_mIoU": 0.20, "SC_IoU": 0.2}), (3, None),
             (4, {"SSC_mIoU": 0.15, "SC_IoU": 0.5})]
    with tempfile.TemporaryDirectory() as d:
        port, ref = os.path.join(d, "port"), os.path.join(d, "jax")
        pm, jm = CheckpointManager(port, max_keep=2), JaxCheckpoints(
            ref, max_keep=2)
        for epoch, metrics in saves:
            w = np.full((3, 2), epoch, np.float32)
            pm.save({"w": torch.from_numpy(w), "epoch": epoch}, epoch,
                    metrics=metrics)
            jm.save({"w": jnp.asarray(w), "epoch": epoch}, epoch,
                    metrics=metrics)
        metas = []
        for root in (port, ref):
            with open(os.path.join(root, "ckpt_meta.json")) as f:
                metas.append(json.load(f))
        assert metas[0] == metas[1]
        assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
            "best", "ckpt_meta.json", "epoch_3", "epoch_4"]
        assert int(_load(os.path.join(port, "best", STATE_FILE))["epoch"]) \
            == 2
        tree, epoch = pm.restore()
        assert epoch == 4 and torch.equal(tree["w"], torch.full((3, 2), 4.0))


def test_metrics_logger_and_metadata_match_jax(no_tensorboard):
    calls = [("train", dict(epoch=0, iter=50, loss_total=1.25,
                            loss_depth=torch.tensor(0.5))),
             ("epoch", dict(epoch=0, time_s=3.0, loss_total=1.5)),
             ("val", dict(epoch=0, SC_IoU=0.25,
                          SSC_IoU_per_class=[0.5, float("nan")])),
             ("note", dict(tag="x"))]
    with tempfile.TemporaryDirectory() as d:
        recs = []
        for name, make in (
                ("port", MetricsLogger),
                ("jax", lambda wd: JaxMetricsLogger(wd, tensorboard=False))):
            wd = os.path.join(d, name)
            logger = make(wd)
            for kind, kw in calls:
                logger.log(kind, **kw)
            logger.close()
            with open(os.path.join(wd, "metrics.jsonl")) as f:
                recs.append([json.loads(ln) for ln in f])
        assert len(recs[0]) == len(recs[1]) == len(calls)
        for a, b in zip(*recs):
            assert set(a) == set(b)
            a.pop("wall_time"), b.pop("wall_time")
            assert json.dumps(a) == json.dumps(b)
        configs = []
        for name, fn, cfg in (("port", dump_run_metadata, tiny_config()),
                              ("jax", jax_dump_metadata, jax_tiny_config())):
            fn(os.path.join(d, name), cfg)
            with open(os.path.join(d, name, "config.json")) as f:
                configs.append(json.load(f))
        assert configs[0] == configs[1]
        with open(os.path.join(d, "port", "env.json")) as f:
            env = json.load(f)
        assert env["torch_version"] == torch.__version__


def test_train_and_test_clis_run_and_print_the_table(run, capsys):
    """The train CLI's resume (in the fixture) left its epoch in the work
    dir; the test CLI evaluates that work dir and prints the table."""
    assert run["train_cli_out"].splitlines()[-1] == \
        f"work dir: {os.path.abspath(run['wd'])}"
    assert run["listing3"] == [
        "best", "ckpt_meta.json", "config.json", "env.json", "epoch_2",
        "metrics.jsonl"]
    preds = os.path.join(os.path.dirname(run["wd"]), "preds")
    capsys.readouterr()
    eval_cli(["tiny", run["wd"], "--synthetic", "--device", "cpu",
              "--max-steps", "1", "--pred-save", preds])
    lines = capsys.readouterr().out.splitlines()
    assert os.listdir(preds) == ["sample_0_0.npz"]
    assert lines[0] == "=== Scene Completion (SC) ==="
    assert len(lines) == len(format_ssc_table(
        run["meta3"]["metrics"]["2"], list(map(str, range(17)))))
    assert lines[-1].startswith("  mIoU (1..C-1)")


def test_pth_state_dict_loads_back(run, caplog):
    cfg = run["cfg"]
    sd = dict(run["trained"]["model"])
    gone = "pts_bbox_head.fine_mlp.0.bias"
    assert not torch.all(sd[gone] == 0)
    del sd[gone]
    torch.save({"state_dict": sd, "meta": {"epoch": 1}}, run["pth"])
    with caplog.at_level(logging.WARNING, logger="coocc_tpu_torch"):
        model = load_model(cfg, run["pth"], "cpu")
    assert f"missing 1 parameter leaves, e.g. ['{gone}']" in caplog.text
    got = model.state_dict()
    assert torch.equal(got[gone], torch.zeros_like(got[gone])), \
        "a leaf the checkpoint lacks keeps flax's initial value"
    for k, v in sd.items():
        assert torch.equal(got[k], v), k
