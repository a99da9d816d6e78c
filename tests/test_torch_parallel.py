"""The port's data parallelism (``yoloret_tpu_torch/parallel/``) against
the one-process program and the JAX package's mesh programs, on the CPU.

Ranks are spawned processes in a gloo group that meets in a
``FileStore`` under the test's temporary directory (no TCP port), one
torch thread each.

Held: a 2-rank train step on 2 x 1 rows against the one-process step on
the 2 rows (MobileNetV2 x0.75 at 64x64, float64 parameters and compute,
two Adam steps with EMA) and against the JAX step jitted on a 2-device
virtual mesh with the JAX trainer's shardings (its loss in float64, see
``_Float64``), both ranks bit for bit; ``Dataset``'s rank slices against
the one-process stream and the JAX package's; the mesh ``Predictor``
(the port's versions of ``tests/test_predictor_mesh.py``);
``evaluate_map(mesh=)``'s refusal of a batch the mesh does not divide; a
training run resumed at another world size (``tests/
test_cross_topology.py``); ``tools/scaling.py``'s bands
(``tests/test_scaling.py``).

Tolerance of a step, each program from the same state (``hold``): the
loss, every gradient, Adam moment and BatchNorm statistic within 1e-9 of
the reference, relative to its own magnitude plus the largest of its kind
(``TOL * (|want| + scale)``). The parameters and the EMA the same, except
where the step's gradient is zero to within that tolerance: a bias whose
shift the next training BatchNorm removes has a gradient of reduction
noise, which Adam scales to +-lr * g / (|g| + eps) in either program
(ROADMAP.md queue 3's trap); those elements (under 1%) are held to the
update's bound, lr.
"""

import datetime
import itertools
import json
import math
import os
import threading
import time
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import yoloret_tpu_torch.weights as weights_module
from _torch_dp_jobs import run_jobs, steps_from_file
from _torch_parity import ANCHORS, SIZE, peaked_variables, to_flax
from test_torch_data import _write_dataset, pinned_decoder
from yoloret_tpu.data.pipeline import Dataset as JaxDataset
from yoloret_tpu.data.pipeline import DatasetMode as JaxDatasetMode
from yoloret_tpu.infer import Predictor as JaxPredictor
from yoloret_tpu.nn import build_detector as jax_build
from yoloret_tpu.nn import detector as jax_detector
from yoloret_tpu.parallel import batch_sharding
from yoloret_tpu.parallel import make_mesh as jax_make_mesh
from yoloret_tpu.parallel import replicate as jax_replicate
from yoloret_tpu.train import losses as jax_losses
from yoloret_tpu.train.step import StepConfig as JaxStepConfig
from yoloret_tpu.train.step import TrainState as JaxState
from yoloret_tpu.train.step import cosine_lr_schedule as jax_cosine
from yoloret_tpu.train.step import train_step as jax_train_step
from yoloret_tpu_torch.configs import RunConfig
from yoloret_tpu_torch.data.pipeline import Dataset, DatasetMode
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.nn.layers import BatchNorm, calibrate_bn, init_weights
from yoloret_tpu_torch.ops.targets import assign_targets_batch, true_corner_boxes
from yoloret_tpu_torch.parallel import make_mesh, shard_batch
from yoloret_tpu_torch.parallel.mesh import spawn
from yoloret_tpu_torch.tools import scaling
from yoloret_tpu_torch.tools.scaling import data_parallel_steps
from yoloret_tpu_torch.train import trainer
from yoloret_tpu_torch.utils.checkpoint import CheckpointManager
from yoloret_tpu_torch.weights import from_flax

C = 4
STEPS = 2
LR = 1e-3  # data_parallel_steps' learning rate
TOL = 1e-9
TIMEOUT = datetime.timedelta(seconds=120)


def step_inputs():
    """The port's seeded x0.75 weights, BatchNorm calibrated on the batch
    (variances floored at their layer's mean, as ``_torch_parity`` does),
    and a seeded global batch of 2 with the data path's targets."""
    model = YoloReT("mobilenetv2x75", num_classes=C)
    init_weights(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32))
    calibrate_bn(model, x)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_var.clamp_(min=m.running_var.mean().item())
    rs = np.random.RandomState(0)
    boxes = np.zeros((2, 6, 5), np.float32)
    xy = rs.uniform(0, SIZE - 24, (2, 4, 2))
    wh = rs.uniform(6, SIZE / 2, (2, 4, 2))
    boxes[:, :4, :2] = xy
    boxes[:, :4, 2:4] = np.minimum(xy + wh, SIZE - 1)
    boxes[:, :4, 4] = rs.randint(0, C, (2, 4))
    b = torch.from_numpy(boxes)
    ys = assign_targets_batch(b, (SIZE, SIZE), torch.as_tensor(ANCHORS), C, 3)
    gt, gv = true_corner_boxes(b, (SIZE, SIZE))
    batch = {"images": x, "gt_boxes": gt, "gt_valid": gv,
             **{f"y_true_{l}": ys[l] for l in range(3)}}
    return {k: v.detach().clone() for k, v in model.state_dict().items()}, batch


class _Float64(types.SimpleNamespace):
    """A module (``jax.numpy``, ``numpy``) whose ``float32`` is float64.
    In the JAX loss module (its casts, ``yoloret_tpu/train/losses.py:
    88-90``) it keeps a float64 step's heads in float64; in
    ``weights.from_flax`` it keeps float64 leaves float64. The comparison
    at 1e-9 needs both."""

    def __init__(self, module):
        super().__init__(float32=module.float64, _module=module)

    def __getattr__(self, name):
        return getattr(self._module, name)


def stash_grads():
    """An optax stage keeping the raw gradients in its state."""
    return optax.GradientTransformation(
        lambda params: {"g": jax.tree.map(jnp.zeros_like, params)},
        lambda updates, state, params=None: (updates, {"g": updates}))


def jax_mesh_steps(weights, batch):
    """The JAX step jitted on a 2-device virtual mesh (replicated state,
    data-sharded batch: the JAX trainer's shardings), float64 throughout,
    STEPS times from ``weights``: (the state after each step as numpy,
    that step's loss)."""
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_losses, "jnp", _Float64(jnp))
        jm = jax_build("mobilenetv2x75", num_classes=C, dtype=jnp.float64,
                       head_dtype=jnp.float64)
        shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, SIZE, SIZE, 3)), False),
                                jax.random.PRNGKey(0))
        variables = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                 to_flax({k: dict(v) for k, v in shapes.items()}, weights))
        tx = optax.chain(stash_grads(), optax.adam(jax_cosine(LR, STEPS, 1), eps=1e-8))
        mesh = jax_make_mesh(jax.devices()[:2])
        repl, data = jax_replicate(mesh), batch_sharding(mesh)
        state = jax.device_put(JaxState.create(jm.apply, variables["params"],
                                               variables["batch_stats"], tx, use_ema=True), repl)
        jbatch = jax.device_put({k: np.asarray(v.numpy(), np.float64) if v.is_floating_point()
                                 else v.numpy() for k, v in batch.items()}, data)
        step = jax.jit(partial(jax_train_step, cfg=JaxStepConfig(anchors=tuple(
            map(tuple, ANCHORS.tolist())))), in_shardings=(repl, data, repl),
            out_shardings=(repl, repl))
        out = []
        for _ in range(STEPS):
            state, m = step(state, jbatch, jax.random.PRNGKey(1))
            out.append((jax.device_get(state), float(m["loss"])))
    return out


def flax64(tree, collection="params"):
    """``weights.from_flax`` of one collection, float64 kept."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(weights_module, "np", _Float64(np))
        return from_flax({collection: tree})


def port_tree(jstate):
    """A JAX ``TrainState`` as the port's ``TrainState.state_dict()``."""
    adam = jstate.opt_state[1][0]
    return {"model": {**flax64(jstate.params), **flax64(jstate.batch_stats, "batch_stats")},
            "step": int(jstate.step), "mu": flax64(adam.mu), "nu": flax64(adam.nu),
            "ema": flax64(jstate.ema_params)}


def leaves(run, step):
    """A run's state after its ``step``-th step as {kind: {name: tensor}},
    with that step's gradients under ``grad``."""
    state = run["states"][step]
    model = state["model"]
    return {"param": {n: model[n] for n in state["mu"]},
            "stat": {n: v for n, v in model.items() if "running_" in n},
            "mu": state["mu"], "nu": state["nu"], "ema": state["ema"],
            "grad": run["grads"][step]}


def hold(got, want):
    """One step from one state: ``got`` within the module's tolerance of
    ``want`` (``leaves``); returns how many parameter and EMA elements
    were held to the update's bound, which must stay under 1% of them."""
    scale = {k: max(float(v.abs().max()) for v in d.values()) for k, d in want.items()}
    noise = total = 0
    for kind, tensors in want.items():
        for n, w in tensors.items():
            g, w = got[kind][n].double(), w.double()
            err = (g - w).abs() - TOL * (w.abs() + scale[kind])
            if kind in ("param", "ema"):
                quiet = want["grad"][n].abs() <= TOL * scale["grad"]
                noise, total = noise + int(quiet.sum()), total + w.numel()
                assert ((g - w).abs()[quiet] <= LR * (1 + TOL)).all(), (kind, n)
                err = err[~quiet]
            assert err.numel() == 0 or float(err.max()) <= 0, (kind, n, float(err.max()))
    assert noise < total // 100, (noise, total)
    return noise


def cut_run(root):
    """A training run at world size 1 (yolo_fastest @64, global batch 2,
    stage 2 of 4 epochs, a checkpoint every 2) stopped right after its
    epoch-1 checkpoint; returns its config to resume at world size 2."""
    rs = np.random.RandomState(1)
    root.mkdir()
    lines = []
    for i in range(6):
        img = rs.randint(0, 60, (64, 80, 3)).astype(np.uint8)
        img[10:40, 12:50, i % 3] = 230
        Image.fromarray(img).save(root / f"im{i}.jpg", quality=95)
        lines.append(f"{root / f'im{i}.jpg'} 12,10,50,40,{i % 3}")
    (root / "list.txt").write_text("\n".join(lines) + "\n")
    (root / "classes.txt").write_text("a\nb\nc\n")
    (root / "anchors.txt").write_text(
        "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326\n")
    cfg = RunConfig(backbone="yolo_fastest", input_size=(64, 64),
                    train_dataset=str(root / "list.txt"), val_dataset=str(root / "list.txt"),
                    classes_path=str(root / "classes.txt"),
                    anchors_path=str(root / "anchors.txt"), batch_size=2, epochs=(4, 4),
                    learning_rate=(1e-3, 1e-3), freeze=False, bf16=False, checkpoint_every=2,
                    log_dir=str(root / "logs"), seed=0)
    save = CheckpointManager.maybe_save

    def preempt(self, epoch, tree, val_loss):
        saved = save(self, epoch, tree, val_loss)
        if saved and epoch == 1:
            raise KeyboardInterrupt("preempted")
        return saved

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CheckpointManager, "maybe_save", preempt)
        with pytest.raises(KeyboardInterrupt):
            trainer.train(cfg, device="cpu")
    return cfg.replace(resume=True, batch_size=1)  # the same global batch over 2 ranks


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Everything this file runs in 2 ranks, in one spawn (a rank's start
    costs seconds): two steps from the seeded weights; the second step
    again from the one-process program's first state; the scaling
    accounting at world size 2; the training run of ``cut_run`` resumed;
    last, the second step from the JAX mesh step's first state, which
    this process writes once its JAX steps, compiled while the ranks run
    the other jobs, have given it; then, while the ranks finish, the
    scaling accounting at world size 1 here."""
    torch.set_num_threads(1)
    weights, batch = step_inputs()
    root = tmp_path_factory.mktemp("dp")
    resume = cut_run(root / "train")
    common = dict(batch=batch, num_classes=C)
    data_parallel_steps(torch.device("cpu"), weights, steps=STEPS, out_path=str(root / "one"),
                        **common)
    one = torch.load(root / "one.rank0", weights_only=True)
    jobs = [(data_parallel_steps, dict(weights=weights, steps=STEPS, out_path=str(root / "dp"),
                                       **common)),
            (data_parallel_steps, dict(weights=None, steps=1, start=one["states"][0],
                                       horizon=STEPS, out_path=str(root / "from_one"),
                                       **common)),
            (scaling._rank_main, dict(path=str(root / "scaling.json"), size=SIZE)),
            (trainer._rank_main, dict(cfg=resume)),
            (steps_from_file, dict(start_path=str(root / "jax_start.pt"), steps=1,
                                   horizon=STEPS, out_path=str(root / "from_jax"), **common))]
    failed = []

    def run():
        try:
            spawn(run_jobs, make_mesh(["cpu", "cpu"]), (jobs,), store_path=str(root / "store"),
                  timeout=TIMEOUT, threads=1)
        except BaseException as e:  # raised in this process below
            failed.append(e)

    t0 = time.perf_counter()
    ranks_thread = threading.Thread(target=run)
    ranks_thread.start()
    try:
        jax_steps = jax_mesh_steps(weights, batch)
        torch.save(port_tree(jax_steps[0][0]), root / "jax_start.tmp")
        os.replace(root / "jax_start.tmp", root / "jax_start.pt")
        scaling_1 = scaling.analyze(1, "cpu", SIZE)  # no group in this process
    finally:
        ranks_thread.join()
    if failed:
        raise failed[0]
    print(f"2 ranks beside the JAX steps: {time.perf_counter() - t0:.1f} s")
    load = lambda name: torch.load(root / name, weights_only=True)  # noqa: E731
    with open(root / "scaling.json") as f:
        scaling_2 = json.load(f)
    return dict(one=one, dp=[load("dp.rank0"), load("dp.rank1")],
                from_one=load("from_one.rank0"), from_jax=load("from_jax.rank0"),
                jax=jax_steps, scaling=(scaling_1, scaling_2), resume=resume)


def test_dp_step_matches_one_process(ranks):
    """2 ranks of 1 row against the one-process program on the 2 rows,
    each step from the same state: the first from the seeded weights, the
    second from the one-process first state (after two DP steps the
    statistics would also carry the noise-driven moves of the first
    step's zero-gradient biases). Both ranks end two steps bit for bit."""
    one, (r0, r1) = ranks["one"], ranks["dp"]
    last = torch.utils._pytree.tree_leaves(r0["states"][-1])
    for a, b in zip(last, torch.utils._pytree.tree_leaves(r1["states"][-1])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert r0["states"][-1]["step"] == one["states"][-1]["step"] == STEPS
    quiet = []
    for i, got in enumerate((r0, ranks["from_one"])):
        assert got["states"][0]["step"] == i + 1
        for k, w in one["metrics"][i].items():
            assert abs(got["metrics"][0][k] - w) <= TOL * abs(w), (i, k)
        quiet.append(hold(leaves(got, 0), leaves(one, i)))
    print(f"DP vs one process: {quiet} parameter and EMA elements at the update bound")


def test_dp_step_matches_jax_mesh_step(ranks):
    """Each step against the JAX mesh step from the same state: the first
    from the seeded weights, the second from JAX's first state (a
    MobileNetV2's ReLU6 channels dead on this batch sit on the kinks,
    where one ulp of a step-1 weight, which the two Adams round
    differently, moves a step-2 gradient: ``tests/test_torch_train_step.
    py``)."""
    (s1, loss1), (s2, loss2) = ranks["jax"]
    for i, (got, jstate, loss) in enumerate(((ranks["dp"][0], s1, loss1),
                                             (ranks["from_jax"], s2, loss2))):
        tree = port_tree(jstate)
        hold(leaves(got, 0), {"param": {n: tree["model"][n] for n in tree["mu"]},
                              "stat": {n: v for n, v in tree["model"].items()
                                       if "running_" in n},
                              "mu": tree["mu"], "nu": tree["nu"], "ema": tree["ema"],
                              "grad": flax64(jstate.opt_state[0]["g"])})
        assert got["states"][0]["step"] == int(jstate.step) == i + 1
        assert abs(got["metrics"][0]["loss"] - loss) <= TOL * abs(loss)


def test_cross_topology_resume(ranks):
    """Stopped at world size 1 after the epoch-1 checkpoint, resumed at
    world size 2 with the same global batch: the run continues at epoch 2
    (no replay), writes epochs 2 and 3 once, and its weight file."""
    cfg = ranks["resume"]
    path = trainer.stage_weights_path(cfg)
    with open(f"{os.path.dirname(path)}/metrics.jsonl") as f:
        trace = [json.loads(line) for line in f]
    epochs = [r["epoch"] for r in trace if "loss" in r]
    assert epochs == [0, 1, 2, 3], epochs
    assert all(math.isfinite(r["loss"]) and math.isfinite(r["val_loss"])
               for r in trace if "loss" in r)
    assert os.path.exists(path)


def test_scaling_bands(ranks):
    """``tools/scaling.py``'s accounting: no collective without a group;
    at world size 2 the FLOPs of a rank within 5% of one device's, the
    train step's collective bytes between 1x and 3x the trainable
    parameter bytes (the gradient all-reduce, the BatchNorm statistics,
    the losses), serving with at most 128 KiB (none: the replicas share
    nothing)."""
    one, two = ranks["scaling"]
    assert one["train_collective_bytes"] == {} and one["serve_collective_bytes"] == {}
    assert one["train_flops_per_rank"] > 0
    assert abs(two["train_flops_per_rank"] / one["train_flops_per_rank"] - 1) <= 0.05
    total = sum(two["train_collective_bytes"].values())
    assert two["param_bytes"] <= total <= 3 * two["param_bytes"], (total, two["param_bytes"])
    assert set(two["train_collective_bytes"]) == {"all_reduce"}
    assert sum(two["serve_collective_bytes"].values()) <= 128 * 1024
    assert two["world"] == 2 and one["param_bytes"] == two["param_bytes"]


def test_dataset_rank_slices(tmp_path):
    """Two ranks' TRAIN streams (mixing off) concatenate to the
    one-process stream bit for bit, host rows and device batches, across
    an epoch boundary; each rank's host rows are the JAX
    ``Dataset(process_index, process_count)``'s."""
    pattern = _write_dataset(str(tmp_path), n_list=5, n_shard=4)
    kw = dict(input_hw=(64, 64), mode=DatasetMode.TRAIN, device="cpu", anchors=ANCHORS,
              num_classes=3, seed=3, num_workers=2)
    with pinned_decoder("pil", tmp_path):
        whole = Dataset(pattern, 4, **kw)
        ranks = [Dataset(pattern, 4, process_index=r, process_count=2, **kw) for r in (0, 1)]
        jranks = [JaxDataset(pattern, 4, ANCHORS, 3, input_hw=(64, 64),
                             mode=JaxDatasetMode.TRAIN, seed=3, num_workers=2,
                             process_index=r, process_count=2) for r in (0, 1)]
        assert whole.steps_per_epoch() == ranks[1].steps_per_epoch() == 2
        for ds, jds in zip(ranks, jranks):
            for g, w in zip(ds._host_batches(epochs=2), jds._host_batches(epochs=2)):
                for k in ("images", "boxes", "valid", "image_hw", "n_valid"):
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        want = list(itertools.islice(whole.build(epochs=None, skip_batches=1), 3))
        got = [list(itertools.islice(ds.build(epochs=None, skip_batches=1), 3)) for ds in ranks]
    for w, g0, g1 in zip(want, *got):
        assert g0["images"].shape[0] == 2
        for k in w:
            assert torch.equal(torch.cat([g0[k], g1[k]]), w[k]), k
    with pytest.raises(ValueError, match="TRAIN only"):
        Dataset(pattern, 4, **{**kw, "mode": DatasetMode.VALIDATE}, process_count=2)
    with pytest.raises(ValueError, match="must divide"):
        Dataset(pattern, 3, **kw, process_count=2)


FRAME_KW = dict(class_names=["a"], anchors=ANCHORS, input_hw=(64, 64), score_threshold=0.2,
                bf16=False)


def _frames(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = np.full((96, 128, 3), 40, np.uint8)
        f[20:60, 30:90] = rng.randint(0, 255, 3)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def predictors():
    """One-device and 8-way mesh Predictors of the same peaked weights,
    the mesh's buckets (1, 6, 16) not multiples of 8 on purpose."""
    jm = jax_build("mobilenetv2x75", num_classes=1)
    variables = peaked_variables(jm, 1)
    single = Predictor(batch_buckets=(8, 16), weights=variables, device="cpu", **FRAME_KW)
    dp = Predictor(batch_buckets=(1, 6, 16), weights=variables,
                   mesh=make_mesh(["cpu"] * 8), **FRAME_KW)
    return single, dp, variables


def test_buckets_round_up_to_data_axis(predictors):
    _, dp, _ = predictors
    assert dp.batch_buckets == (8, 16) and dp._n_data == 8 and len(dp._replicas) == 8
    # a replica per entry, each with its own weights and folded backbone
    assert len({id(r[0]) for r in dp._replicas}) == 8
    assert len({r[2].blocks[0].args[2].data_ptr() for r in dp._replicas}) == 8


def test_batch_input_actually_shards(predictors):
    _, dp, _ = predictors
    shards = shard_batch(dp.mesh, torch.zeros(8, 64, 64, 3, dtype=torch.uint8))
    assert len(shards) == 8 and {tuple(s.shape) for s in shards} == {(1, 64, 64, 3)}
    assert [s.device for s in shards] == list(dp.mesh.devices)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(dp.mesh, torch.zeros(12, 2))


def _same_slates(a, b):
    """Scores within 1e-6 and classes equal, as the JAX test holds them;
    boxes within 1e-4 px: the CPU's float32 convolutions round a row
    differently at another batch size (the port's b8 and 8 x b1 boxes
    differ by up to 2.3e-5 px on these 128 x 96 frames, where one float32
    ulp at 128 px is 1.5e-5)."""
    assert [len(x) for x in a] == [len(x) for x in b]
    for da_list, db_list in zip(a, b):
        for da, db in zip(da_list, db_list):
            np.testing.assert_allclose(da.box, db.box, atol=1e-4)
            np.testing.assert_allclose(da.score, db.score, atol=1e-6)
            assert da.class_id == db.class_id


def test_mesh_predictor_matches_single_device_and_jax(predictors, monkeypatch):
    single, dp, variables = predictors
    frames = _frames(5, seed=11)  # pads to the 8-bucket on both
    a, b = single.detect_arrays(frames), dp.detect_arrays(frames)
    assert sum(len(x) for x in a) > 0
    _same_slates(a, b)
    assert dp.dispatched_batch_sizes == {8} and dp.forwards == 1
    # the replicas share nothing: the mesh's slate is one device's on each shard, bit for bit
    x = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (8, 64, 64, 3), np.uint8))
    hw = torch.full((8, 2), 64.0)
    got = dp.infer(x, hw)
    for field, parts in zip(got, zip(*(single.infer(x[i:i + 1], hw[i:i + 1]) for i in range(8)))):
        assert torch.equal(field, torch.cat(parts))
    monkeypatch.setattr(jax_detector.YoloReT, "init", lambda self, *a, **k: variables)
    jdp = JaxPredictor(batch_buckets=(1, 6, 16), mesh=jax_make_mesh(jax.devices()[:8]),
                       **FRAME_KW)
    _same_slates(jdp.detect_arrays(frames), b)


def test_mesh_predictor_chunks_oversize_requests(predictors):
    _, dp, _ = predictors
    out = dp.detect_arrays(_frames(19, seed=5))  # 16 + padded-to-8 chunk
    assert len(out) == 19
    assert dp.dispatched_batch_sizes == {8, 16}


def test_mesh_predictor_runs_each_replica_on_its_device(monkeypatch):
    """Each replica's forward and postprocess (the calls that launch its
    kernels) run with that replica's device current, in mesh order, and
    its weights are folded there."""
    import contextlib

    from yoloret_tpu_torch.infer import predictor as predictor_module

    current, seen = [], []

    @contextlib.contextmanager
    def on_device(dev):
        current.append(dev)
        try:
            yield
        finally:
            current.pop()

    def recorded(fn, what):
        def run(*a, **k):
            seen.append((what, current[-1] if current else None))
            return fn(*a, **k)
        return run

    monkeypatch.setattr(predictor_module, "on_device", on_device)
    for name, what in (("fused_params", "fold"), ("fused_detector_apply", "forward"),
                       ("detect_batch", "postprocess")):
        monkeypatch.setattr(predictor_module, name,
                            recorded(getattr(predictor_module, name), what))
    mesh = make_mesh([torch.device("cpu", i) for i in range(3)])
    dp = Predictor(batch_buckets=(3,), mesh=mesh, **FRAME_KW)
    assert seen == [("fold", dev) for dev in mesh.devices]
    seen.clear()
    dp.infer(torch.zeros(3, 64, 64, 3, dtype=torch.uint8), torch.full((3, 2), 64.0))
    assert seen == [(what, dev) for dev in mesh.devices for what in ("forward", "postprocess")]


def test_evaluate_map_rejects_indivisible_batch(tmp_path, predictors):
    """As the JAX package's: a batch the data axis does not divide fails
    at once with the JAX message; the mesh is the predictor's, and
    another one is refused."""
    from PIL import Image

    from yoloret_tpu_torch.eval import evaluate_map

    img = tmp_path / "im.jpg"
    Image.fromarray(np.full((64, 64, 3), 90, np.uint8)).save(img)
    ann = tmp_path / "t_1.txt"
    ann.write_text(f"{img} 5,5,40,40,0\n")
    ds = Dataset(str(ann), 3, input_hw=(64, 64), mode=DatasetMode.TEST, device="cpu")
    with pytest.raises(ValueError, match=r"batch_size \(3\) must be a multiple of the mesh "
                                         r"data axis \(8\)"):
        evaluate_map(predictors[1], ds, ["a"], mesh=make_mesh(["cpu"] * 8))
    with pytest.raises(ValueError, match=r"batch_size \(3\) must be a multiple"):
        evaluate_map(predictors[1], ds, ["a"])
    with pytest.raises(ValueError, match="must be the predictor's"):
        evaluate_map(predictors[0], ds, ["a"], mesh=make_mesh(["cpu"] * 8))
