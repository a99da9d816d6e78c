"""The port's ablation harness (``yoloret_tpu_torch/tools/ablation.py``)
against the JAX package's (``yoloret_tpu/tools/ablation.py``), on the CPU.

Held: the scale-diverse generator and the three dataset helpers write the
JAX package's JPEGs and annotation lines byte for byte; ``render_table``
and ``render_table_r5`` give the JAX strings character for character on
the JAX package's own records (``docs/ablation_r{4,5}_results.jsonl``);
both batteries (``drive``, ``drive_r5``), with the job runner replaced by
a fake in both packages, start the same jobs with the same arguments in
the same order (the port's with ``--device`` appended) and write the same
``results.jsonl``, and a second call runs nothing; ``_graft_backbone`` on
a JAX weight directory: ``body.*`` bit for bit the source's, the rest bit
for bit the port trainer's own init at the seed, loadable with
``strict=True``; the job runner's subprocess from another working
directory, the battery's default root under $TMPDIR, the tagged lines it
reads; each job kind once in process at 64 px, 1 epoch a stage and 8
images a set (the recipe's constants monkeypatched), returning the keys
of the JAX package's records. The whole batteries run on the card
(``PERF.md``, section 6)."""

import json
import os
import tempfile
import zlib

import numpy as np
import pytest
import torch

import yoloret_tpu_torch.train.trainer as trainer
from _torch_parity import _map, port_variables
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.tools import ablation as jax_ablation
from yoloret_tpu.utils.checkpoint import save_params as jax_save_params
from yoloret_tpu_torch.nn.detector import YoloReT
from yoloret_tpu_torch.tools import ablation
from yoloret_tpu_torch.tools.topk_study import CLASS_NAMES
from yoloret_tpu_torch.utils.checkpoint import load_params
from yoloret_tpu_torch.weights import from_flax

torch.set_num_threads(1)

DOCS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "docs")


def tree_bytes(root):
    """Every file under ``root`` by relative path, ``root`` written as
    ``<root>`` inside (the annotation lines hold absolute paths)."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read().replace(str(root).encode(), b"<root>")
    return out


def same_trees(mine, theirs):
    a, b = tree_bytes(mine), tree_bytes(theirs)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], name
    return a


@pytest.mark.parametrize("seed", [0, 3])
def test_build_scalediverse_is_the_jax_packages(tmp_path, seed):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    got = ablation.build_scalediverse(str(mine), n=6, seed=seed)
    want = jax_ablation.build_scalediverse(str(theirs), n=6, seed=seed)
    assert [os.path.relpath(p, mine) for p in got] == [os.path.relpath(p, theirs) for p in want]
    files = same_trees(mine, theirs)
    assert len(files) == 6 + 3
    lines = files["sd_train_6.txt"].decode().splitlines()
    assert [len(l.split()) for l in lines] == [1 + 6] * 6  # 1 large + 2 medium + 3 small


@pytest.mark.parametrize("helper", ["_sd_datasets", "_datasets", "_small_datasets"])
def test_dataset_helpers_are_the_jax_packages(tmp_path, helper):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    got = getattr(ablation, helper)(str(mine))
    want = getattr(jax_ablation, helper)(str(theirs))
    assert [os.path.relpath(p, mine) for p in got] == [os.path.relpath(p, theirs) for p in want]
    n_train = 16 if helper == "_small_datasets" else 48
    assert len(same_trees(mine, theirs)) == n_train + 32 + 2 * 3


def jax_records(battery):
    with open(os.path.join(DOCS, f"ablation_{battery}_results.jsonl")) as f:
        return {rec["id"]: rec for rec in map(json.loads, f) if rec}


@pytest.mark.parametrize("records", ["r4", "r5"])
@pytest.mark.parametrize("render,seeds", [("render_table", [0, 1]),
                                          ("render_table_r5", [0, 1, 2, 3, 4])])
def test_tables_are_the_jax_packages(records, render, seeds):
    """On each battery's records, and on the other battery's (where most
    rows are missing)."""
    done = jax_records(records)
    got = getattr(ablation, render)(done, seeds)
    assert got == getattr(jax_ablation, render)(done, seeds)
    if render == "render_table_r5" and records == "r5":
        assert "(mean +0.0052, 3/5 positive)" in got


def fake_run_job(calls):
    """A job runner that records (job id, arguments) and returns a record
    with every key a table reads, its values drawn from the job id."""

    def run(root, job_id, args):
        calls.append((job_id, list(args)))
        v = [(zlib.crc32(f"{job_id}{i}".encode()) % 10**6) / 10**6 for i in range(6)]
        return {"train_mAP": v[0], "heldout_mAP": v[1], "raw_train_mAP": v[2],
                "raw_heldout_mAP": v[3], "ema_train_mAP": v[4], "ema_heldout_mAP": v[5],
                "weights": f"logs/{job_id}/weights"}

    return run


@pytest.mark.parametrize("battery,seeds", [("drive", [0, 1]), ("drive_r5", [0, 1, 2, 3, 4])])
def test_batteries_run_the_jax_packages_jobs(tmp_path, monkeypatch, capsys, battery, seeds):
    mine, theirs = [], []
    monkeypatch.setattr(ablation, "_run_job", fake_run_job(mine))
    monkeypatch.setattr(jax_ablation, "_run_job", fake_run_job(theirs))
    roots = tmp_path / "port", tmp_path / "jax"
    done = getattr(ablation, battery)(str(roots[0]), seeds, "cpu")
    want = getattr(jax_ablation, battery)(str(roots[1]), seeds)
    assert done == want
    assert all(args[-2:] == ["--device", "cpu"] for _, args in mine)
    assert [(job_id, args[:-2]) for job_id, args in mine] == theirs
    assert len(theirs) == (12 if battery == "drive" else 16)
    results = [(r / "results.jsonl").read_text() for r in roots]
    assert results[0] == results[1] and len(results[0].splitlines()) == len(theirs)
    render = ablation.render_table if battery == "drive" else ablation.render_table_r5
    assert render(done, seeds) in capsys.readouterr().out
    # a second call reads every record back and runs nothing
    mine.clear()
    assert getattr(ablation, battery)(str(roots[0]), seeds, "cpu") == done
    assert mine == [] and (roots[0] / "results.jsonl").read_text() == results[0]


class Captured(Exception):
    pass


def trainer_init(tmp_path, monkeypatch, seed):
    """The state dict the port's trainer initialises its model to for a
    run at ``seed`` (read inside ``train``, which stops there)."""
    seen = {}
    real = trainer.init_weights

    def init_weights(model, generator):
        real(model, generator)
        seen.update({k: v.clone() for k, v in model.state_dict().items()})
        raise Captured

    ann, held, classes, anchors = ablation._small_datasets(str(tmp_path / "target"))
    cfg = ablation._recipe(str(tmp_path), ann, classes, anchors).replace(seed=seed)
    monkeypatch.setattr(trainer, "init_weights", init_weights)
    with pytest.raises(Captured):
        trainer.train(cfg, device="cpu")
    return seen


def test_graft_backbone_from_a_jax_directory(tmp_path, monkeypatch):
    """The source: a JAX weight directory of seed-5 weights with every
    leaf moved (biases, BatchNorm scales and statistics start at
    constants), so that every ``body.*`` entry differs from the fresh
    init's."""
    rs = np.random.RandomState(0)
    v = port_variables(jax_build_detector("mobilenetv2x75", num_classes=len(CLASS_NAMES)),
                       YoloReT("mobilenetv2x75", num_classes=len(CLASS_NAMES)), seed=5)
    v = _map(v, lambda path, a: a + rs.rand(*a.shape).astype(np.float32))
    jax_save_params(str(tmp_path / "source"), v)
    out = ablation._graft_backbone(str(tmp_path / "source"), 1,
                                   str(tmp_path / "grafted_init.pt"))
    got = load_params(out)
    src = from_flax(v)
    fresh = trainer_init(tmp_path, monkeypatch, seed=1)
    assert sorted(got) == sorted(fresh)
    body = [k for k in got if k.startswith("body.")]
    assert body and len(body) < len(got)
    for k in got:
        want = src[k] if k.startswith("body.") else fresh[k]
        assert got[k].dtype == want.dtype and torch.equal(got[k], want), k
    assert all(not torch.equal(src[k], fresh[k]) for k in body)
    model = YoloReT("mobilenetv2x75", num_classes=len(CLASS_NAMES))
    model.load_state_dict(load_params(out), strict=True)


def test_job_runner_subprocess_reports_a_failed_job(tmp_path, monkeypatch):
    """A job that fails (a transfer job without --pretrained), run by the
    job runner's own subprocess from a directory outside the checkout."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="job t-s0 failed(.|\n)*--pretrained required"):
        ablation._run_job(str(tmp_path / "root"), "t-s0",
                          ["--job", "transfer", "--seed", "0", "--device", "cpu"])
    assert (tmp_path / "root" / "t-s0").is_dir()


def test_battery_root_defaults_to_the_temporary_directory(tmp_path, monkeypatch):
    """Without ``--root`` the battery keeps its jobs and its resume cache
    (``results.jsonl``) in ``yoloret_ablation`` under the temporary
    directory ($TMPDIR), so that two runs with their own $TMPDIR never
    share records."""
    seen = []
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    for battery in ("drive", "drive_r5"):
        monkeypatch.setattr(ablation, battery,
                            lambda root, seeds, device: seen.append((root, seeds, device)))
    ablation.main(["--seeds", "3"])
    ablation.main(["--battery", "r5", "--root", str(tmp_path / "r5"), "--device", "cpu"])
    assert seen == [(str(tmp_path / "yoloret_ablation"), [3], "cuda"),
                    (str(tmp_path / "r5"), [0, 1], "cpu")]


def test_tagged_reads_a_jobs_last_tagged_line():
    """The job runner reads a job's record from its last
    ``ABLATION_RESULT`` line and its launches from ``ABLATION_LAUNCHES``."""
    out = ('[ablation] log\nABLATION_RESULT {"a": 1}\nABLATION_RESULT {"a": 2}\n'
           'ABLATION_LAUNCHES {"mbconv": {}, "nms": {}}\n')
    assert ablation.tagged(out, "ABLATION_RESULT") == {"a": 2}
    assert ablation.tagged(out, "ABLATION_LAUNCHES") == {"mbconv": {}, "nms": {}}
    assert ablation.tagged("[ablation] log\n", "ABLATION_RESULT") is None


def test_jobs_run_on_the_card_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # what reproducible() sets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ablation.job_rfcr(str(tmp_path), "weighted_sum", 0)


SMALL_RECIPE = dict(SIZE=64, EPOCHS=1, TRANSFER_EPOCHS=(1, 1), RANDOM_EPOCHS=1, N_TRAIN=8,
                    N_HELDOUT=8, N_SMALL=8, N_PRETRAIN=8)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The recipe cut to 64 px, 1 epoch a stage and 8 images a set, and
    the pretrain job (the transfer arm's source) run on it."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in SMALL_RECIPE.items():
            mp.setattr(ablation, name, value)
        root = str(tmp_path_factory.mktemp("ablation"))
        pre = ablation.job_pretrain(os.path.join(root, "pretrain-s7"), 7, device="cpu")
        yield root, pre


def keys_of(job_id):
    records = {**jax_records("r4"), **jax_records("r5")}
    return set(records[job_id]) - {"id"}


def assert_maps(res):
    for k, v in res.items():
        if k != "weights":
            assert isinstance(v, float) and 0.0 <= v <= 1.0 and round(v, 6) == v, (k, v)
    assert os.path.isfile(res["weights"])


def test_pretrain_job(small):
    _, pre = small
    assert set(pre) == keys_of("pretrain-s7")
    assert_maps(pre)
    assert pre["weights"].endswith("mobilenetv2x75_stage2/mobilenetv2x75_trained_weights_final.pt")


@pytest.mark.parametrize("job", ["rfcr", "rfcr_sd", "ema", "transfer", "random"])
def test_job_returns_the_jax_keys(small, capsys, job):
    """``rfcr`` through ``main`` (its two printed lines), the rest by their
    functions."""
    root, pre = small
    workdir = os.path.join(root, job)
    if job == "rfcr":
        ablation.main(["--job", "rfcr", "--fusion", "concat", "--seed", "0", "--workdir",
                       workdir, "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out[-2].startswith("ABLATION_RESULT ") and out[-1].startswith("ABLATION_LAUNCHES ")
        res = json.loads(out[-2][len("ABLATION_RESULT "):])
        # the wrappers count launches of their kernels only: none on the CPU
        assert json.loads(out[-1][len("ABLATION_LAUNCHES "):]) == {"mbconv": {}, "nms": {}}
        want = keys_of("rfcr-concat-s0")
    elif job == "rfcr_sd":
        res = ablation.job_rfcr_sd(workdir, "none", 0, device="cpu")
        want = keys_of("rfcrsd-none-s0")
    elif job == "ema":
        res = ablation.job_ema(workdir, 0, decay=0.99, epochs=1, device="cpu")
        want = keys_of("ema-d99-s0")
    else:
        res = ablation.job_transfer(workdir, job, 1, pre["weights"], device="cpu")
        want = keys_of(f"transfer-{job}-s0")
        stages = sorted(os.listdir(os.path.join(workdir, "logs")))
        assert stages == (["mobilenetv2x75_stage1", "mobilenetv2x75_stage2"] if job == "transfer"
                          else ["mobilenetv2x75_stage2"])
        assert os.path.exists(os.path.join(workdir, "grafted_init.pt")) == (job == "transfer")
    assert set(res) == want
    assert_maps(res)
