"""The port's learning tools (``yoloret_tpu_torch/tools/{selfcheck,
accuracy_gate,topk_study}.py``) against the JAX package's, on the CPU.

Held: ``build_synthetic`` and ``build_crowded`` write the JAX package's
JPEGs, annotation, class and anchor files byte for byte; the self-check's
and the crowded recipe's configs equal the JAX ``RunConfig``s field by
field; short runs of ``selfcheck.main`` (1 epoch at 64 px: exit code 1
below the threshold), ``selfcheck_spread.main`` (2 seeds, 1 epoch at 64
px, a process each), ``topk_study.run`` (its table's rows, the full pool
of 252 positions at 64 px) and ``accuracy_gate.main`` (its
``GATE_RESULT`` line); and the port's own 3-epoch loss trace of the gate
recipe at 160 px, pinned (below). The whole runs, 150 and 60 epochs, are
``chip_smoke.py``'s learn phase on the card."""

import dataclasses
import json
import math
import os
import tempfile

import numpy as np
import pytest
import torch

import yoloret_tpu.train.trainer as jax_trainer
import yoloret_tpu_torch.train.trainer as trainer
from yoloret_tpu.tools import selfcheck as jax_selfcheck
from yoloret_tpu.tools import topk_study as jax_topk_study
from yoloret_tpu_torch.tools import accuracy_gate, selfcheck, selfcheck_spread, topk_study

# The port's per-epoch mean losses of ``accuracy_gate.run_loss_trace``
# (3 epochs, 160 px, b8) with 4 torch threads on the CPU. The same run
# with 1 thread: [1258.186, 1136.173, 1092.595], at most 8.3e-4 from
# these (the cut of the reductions over threads changes the rounding,
# and the steps amplify it); 2 and 8 threads were up to 2.7e-3 away. The
# test runs with 4 threads, and RTOL covers the 1-thread trace.
LOSS_TRACE_4_THREADS = [1258.9803466796875, 1136.6922607421875, 1091.6915283203125]
LOSS_TRACE_RTOL = 1e-3


def tree_bytes(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read().replace(str(root).encode(), b"<root>")
    return out


@pytest.mark.parametrize("maker", ["build_synthetic", "build_crowded"])
def test_datasets_are_the_jax_packages(tmp_path, maker):
    mine, theirs = tmp_path / "port", tmp_path / "jax"
    mine.mkdir()
    theirs.mkdir()
    module, jax_module = ((selfcheck, jax_selfcheck) if maker == "build_synthetic"
                          else (topk_study, jax_topk_study))
    got = getattr(module, maker)(str(mine))
    want = getattr(jax_module, maker)(str(theirs))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    a, b = tree_bytes(mine), tree_bytes(theirs)
    assert set(a) == set(b) and len(a) == 48 + 3
    for name in a:
        assert a[name] == b[name], name


class Captured(Exception):
    pass


def capture_cfg(monkeypatch, module, run, workdir):
    """The config that ``run(workdir=...)`` hands ``module.train``."""
    seen = []

    def fake_train(cfg, *a, **kw):
        seen.append(cfg)
        raise Captured

    monkeypatch.setattr(module, "train", fake_train)
    with pytest.raises(Captured):
        run(workdir=str(workdir))
    return seen[0]


def assert_same_config(got, want):
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_selfcheck_config_is_the_jax_packages(tmp_path, monkeypatch):
    got = capture_cfg(monkeypatch, trainer, selfcheck.run, tmp_path)
    want = capture_cfg(monkeypatch, jax_trainer, jax_selfcheck.run, tmp_path)
    assert_same_config(got, want)
    # run()'s default is 30 epochs in both packages; main()'s is 150
    assert (got.epochs, got.input_size, got.batch_size, got.learning_rate, got.freeze,
            got.bf16, got.seed) == ((30, 30), (96, 96), 8, (2e-3, 2e-3), False, False, 0)


def test_crowded_config_is_the_jax_packages(tmp_path, monkeypatch):
    ann, classes, anchors = topk_study.build_crowded(str(tmp_path))
    assert_same_config(topk_study.crowded_train_cfg(str(tmp_path), ann, classes, anchors),
                       jax_topk_study.crowded_train_cfg(str(tmp_path), ann, classes, anchors))
    # the gate trains that recipe at its defaults
    got = capture_cfg(monkeypatch, trainer, accuracy_gate.run, tmp_path)
    assert (got.epochs, got.input_size, got.batch_size, got.max_boxes) == ((60, 60), (160, 160),
                                                                          8, 12)


def test_selfcheck_main_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # where run() makes its workdir
    with pytest.raises(SystemExit) as exit_info:
        selfcheck.main(["--epochs", "1", "--size", "64", "--device", "cpu"])
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("selfcheck ")][-1]
    mAP = float(line.split("mAP=")[1].split()[0])
    assert line.startswith("selfcheck FAIL") and 0.0 <= mAP < 0.8
    assert exit_info.value.code == 1  # below the threshold, as the JAX main exits


def test_selfcheck_spread_on_the_cpu(capsys):
    """Two seeds, each in a process of its own: a SPREAD line each, in seed
    order, and the summary over both."""
    assert selfcheck_spread.parse_seeds("0-2") == [0, 1, 2]
    assert selfcheck_spread.parse_seeds("4,1") == [4, 1]
    selfcheck_spread.main(["--seeds", "0,1", "--procs", "2", "--epochs", "1", "--size", "64",
                           "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    runs = [json.loads(l[len("SPREAD "):]) for l in out if l.startswith("SPREAD ")]
    assert sorted(r["seed"] for r in runs) == [0, 1]
    assert all(0.0 <= r["map"] < 0.8 for r in runs)
    summary = json.loads(out[-1][len("SPREAD_SUMMARY "):])
    maps = [r["map"] for r in sorted(runs, key=lambda r: r["seed"])]
    assert summary["seeds"] == [0, 1] and summary["reach_threshold"] == 0
    assert (summary["min"], summary["max"]) == (min(maps), max(maps))


def test_topk_study_run_on_the_cpu(tmp_path, capsys):
    rows = topk_study.run(epochs=1, size=64, workdir=str(tmp_path), device="cpu")
    full = topk_study.full_pool(64)
    assert full == 252
    assert [(p, k, d) for p, k, d, _, _ in rows] == (
        [("per_class", "exact", f"full ({full})")]
        + [(p, "exact", str(k)) for p in ("per_class", "shared") for k in (64, 256, 512)])
    assert all(math.isfinite(m) and 0.0 <= m <= 1.0 for _, _, _, m, _ in rows)
    assert all(d == m - rows[0][3] for _, _, _, m, d in rows)
    out = capsys.readouterr().out
    assert "| pool | top-k | depth | mAP | delta vs exact-full |" in out
    assert f"| per_class | exact | full ({full}) |" in out


def test_accuracy_gate_main_prints_gate_result(tmp_path, capsys):
    accuracy_gate.main(["--workdir", str(tmp_path), "--epochs", "1", "--size", "64",
                        "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("GATE_RESULT ")]
    assert len(lines) == 1
    result = json.loads(lines[0][len("GATE_RESULT "):])
    assert result["epochs"] == 1 and set(result["aps"]) == {"0", "1", "2", "3"}
    assert all(math.isfinite(v) for v in result["aps"].values())
    assert result["mAP"] == pytest.approx(np.mean(list(result["aps"].values())), abs=1e-6)


def test_loss_trace_pinned(tmp_path, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        result = accuracy_gate.run_loss_trace(str(tmp_path), epochs=3, size=160, batch=8,
                                              device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert f"GATE_LOSS_TRACE {json.dumps(result)}" in capsys.readouterr().out
    np.testing.assert_allclose(result["losses"], LOSS_TRACE_4_THREADS, rtol=LOSS_TRACE_RTOL)
