"""The port's VIDEO path (``infer/predictor.py``: ``detect_video``,
``frame_schedule``, ``_make_tracker``; the CLI's ``--mode=VIDEO``)
against the JAX package's ``detect_video``, on the CPU with OpenCV.

The counterparts of ``tests/test_video.py`` (a written mp4 in and out,
the tracker interleave detecting on frames 0 and 3 of 6, ``IOError`` on
a missing file); the boxes each side draws, frame by frame
(``cv2.rectangle`` recorded: both call it as a module attribute), between
the JAX and the port's ``detect_video`` on one clip and the same weights
(``_torch_parity.peaked_variables``, float32, 64x64); the schedule with
a stub tracker; and the CLI.

At ``track_interval`` 1 the JAX side's boxes repeat from run to run and
the port's equal them. At 3 OpenCV's tracker (MIL here: this OpenCV has
no CSRT or KCF) places each tracked box by a random search: two JAX runs
put one box up to ~35 px apart (``cv2.setRNGSeed`` and one OpenCV thread
do not make it repeat). So the port is held to what repeats on the JAX
side: the detected frames' boxes, the number of boxes on every frame and
each tracked box's size, exactly; and each tracked box within the
tracker's search window of its place on the frame before, as JAX's are.
With a deterministic stand-in for the tracker, both packages' drawn
boxes are equal at ``track_interval`` 3 too.
"""

import os

import numpy as np
import pytest
import torch

from _torch_parity import ANCHORS, SIZE, peaked_variables
import yoloret_tpu.infer.predictor as jax_predictor
import yoloret_tpu_torch.infer.predictor as predictor
from yoloret_tpu.infer import Predictor as JaxPredictor
from yoloret_tpu.nn import build_detector as jax_build_detector
from yoloret_tpu.nn import detector as jax_detector
from yoloret_tpu_torch.cli.main import main as cli_main
from yoloret_tpu_torch.infer import Predictor
from yoloret_tpu_torch.infer.predictor import Detection, _make_tracker, frame_schedule

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(1)

CLASSES = ["a"]
SCORE = 0.255  # the clip's best 4-7 scores a frame (0.255-0.275)
FRAMES = 6


def write_clip(path, n=FRAMES):
    """tests/test_video.py's clip: a red box moving right on grey, 160x120."""
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (160, 120))
    for i in range(n):
        f = np.full((120, 160, 3), 40, np.uint8)
        f[30:70, 20 + 8 * i:60 + 8 * i] = (0, 0, 255)
        w.write(f)
    w.release()
    return str(path)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return write_clip(tmp_path_factory.mktemp("video") / "in.mp4")


@pytest.fixture(scope="module")
def variables():
    return peaked_variables(jax_build_detector("mobilenetv2x75", num_classes=len(CLASSES)),
                            len(CLASSES))


def port_predictor(variables):
    return Predictor(class_names=CLASSES, anchors=ANCHORS, input_hw=(SIZE, SIZE),
                     score_threshold=SCORE, bf16=False, weights=variables, device="cpu")


@pytest.fixture(scope="module")
def predictors(variables):
    """(the port's Predictor, the JAX Predictor) on the same weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_detector.YoloReT, "init", lambda self, *a, **k: variables)
        jax_pred = JaxPredictor(class_names=CLASSES, anchors=ANCHORS, input_hw=(SIZE, SIZE),
                                score_threshold=SCORE, bf16=False)
    return port_predictor(variables), jax_pred


def drawn_boxes(pred, clip, monkeypatch, **kw):
    """The rectangles ``pred.detect_video`` draws, frame by frame, and its
    return value."""
    frames = []
    rect = cv2.rectangle
    put = cv2.putText

    def rectangle(img, p1, p2, *a, **k):
        frames[-1].append((p1, p2))
        return rect(img, p1, p2, *a, **k)

    def put_text(img, text, *a, **k):
        if text.startswith("FPS: "):  # the last drawing of each frame
            frames.append([])
        return put(img, text, *a, **k)

    monkeypatch.setattr(cv2, "rectangle", rectangle)
    monkeypatch.setattr(cv2, "putText", put_text)
    frames.append([])
    n = pred.detect_video(clip, **kw)
    monkeypatch.undo()
    return frames[:-1], n


def corners(frame):
    return np.array([[*p1, *p2] for p1, p2 in frame], np.int64).reshape(-1, 4)


@pytest.mark.parametrize("track_interval", [1, 3])
def test_drawn_boxes_match_jax_detect_video(predictors, clip, monkeypatch, track_interval):
    port, jax_pred = predictors
    want, n_jax = drawn_boxes(jax_pred, clip, monkeypatch, track_interval=track_interval)
    again, _ = drawn_boxes(jax_pred, clip, monkeypatch, track_interval=track_interval)
    got, n = drawn_boxes(port, clip, monkeypatch, track_interval=track_interval)
    assert n == n_jax == FRAMES and len(got) == FRAMES
    assert sum(len(f) for f in want) > FRAMES, "peaked weights must give detections"
    if track_interval == 1:
        assert again == want, "the JAX side's own boxes must repeat for equality to mean much"
        assert got == want
        return
    is_mil = type(_make_tracker(cv2)).__name__ == "TrackerMIL"
    # each tracked box moves at most the search window a frame, +2 px for
    # the seed's clamp of x1, y1 into [0, side - 2]
    reach = cv2.TrackerMIL.Params().samplerSearchWinSize + 2
    runs = (want, again, got)
    for f in range(FRAMES):
        if f % track_interval == 0:
            assert want[f] == again[f] == got[f], f
            continue
        boxes = [corners(r[f]) for r in runs]
        assert boxes[0].shape == boxes[1].shape == boxes[2].shape, f
        sizes = [b[:, 2:] - b[:, :2] for b in boxes]
        np.testing.assert_array_equal(sizes[0], sizes[1])  # JAX's own spread: none
        np.testing.assert_array_equal(sizes[2], sizes[0])
        if is_mil:
            for b, r in zip(boxes, runs):
                assert np.abs(b[:, :2] - corners(r[f - 1])[:, :2]).max() <= reach, f


class ShiftTracker:
    """A deterministic stand-in for OpenCV's trackers: each update moves
    the box 3 px right and 1 px down; every second tracker made fails its
    second update."""

    def __init__(self, fail_at):
        self.fail_at, self.calls = fail_at, 0

    def init(self, frame, box):
        self.box = box

    def update(self, frame):
        self.calls += 1
        x, y, w, h = self.box
        self.box = (x + 3, y + 1, w, h)
        return self.calls != self.fail_at, self.box


def shift_trackers():
    made = []

    def make(cv2_module):
        made.append(ShiftTracker(fail_at=2 if len(made) % 2 else None))
        return made[-1]

    return make


def test_tracker_interleave_matches_jax_with_a_deterministic_tracker(predictors, clip,
                                                                      monkeypatch):
    port, jax_pred = predictors
    monkeypatch.setattr(jax_predictor, "_make_tracker", shift_trackers())
    want, _ = drawn_boxes(jax_pred, clip, monkeypatch, track_interval=3, max_tracks=4)
    monkeypatch.setattr(predictor, "_make_tracker", shift_trackers())
    got, n = drawn_boxes(port, clip, monkeypatch, track_interval=3, max_tracks=4)
    assert n == FRAMES and got == want
    assert [len(f) for f in got][:3] == [5, 4, 2], "4 seeded of 5, 2 dropped on frame 2"


def test_detect_video_round_trip(variables, clip, tmp_path):
    out = str(tmp_path / "out.mp4")
    assert port_predictor(variables).detect_video(clip, output=out, max_frames=FRAMES) == FRAMES
    cap = cv2.VideoCapture(out)
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (120, 160, 3)


def test_detect_video_tracker_interleave(variables, clip, tmp_path):
    """track_interval=3 over 6 frames: the detector runs on frames 0 and 3
    only, the trackers carry frames 1, 2, 4 and 5; all 6 are written."""
    p = port_predictor(variables)
    calls = []
    inner = p.detect_arrays
    p.detect_arrays = lambda imgs: (calls.append(len(imgs)), inner(imgs))[1]
    out = str(tmp_path / "out.mp4")
    assert p.detect_video(clip, output=out, max_frames=FRAMES, track_interval=3,
                          max_tracks=3) == FRAMES
    assert calls == [1, 1]
    cap = cv2.VideoCapture(out)
    frames = 0
    while cap.read()[0]:
        frames += 1
    cap.release()
    assert frames == FRAMES


def test_detect_video_bad_source(variables):
    with pytest.raises(IOError):
        port_predictor(variables).detect_video("/nonexistent/file.mp4")


class StubTracker:
    """Follows its box 2 px right a frame; ``update`` fails from the
    ``fail_at``-th call on."""

    def __init__(self, log, fail_at=None):
        self.log, self.fail_at, self.calls = log, fail_at, 0

    def init(self, frame, box):
        self.box = box
        self.log.append(("init", box))

    def update(self, frame):
        self.calls += 1
        x, y, w, h = self.box
        self.box = (x + 2, y, w, h)
        return (self.fail_at is None or self.calls < self.fail_at), self.box


def test_frame_schedule_with_a_stub_tracker():
    frames = [np.full((50, 80, 3), i, np.uint8) for i in range(7)]
    dets = [Detection((-5.0, 10.5, 30.9, 60.0), 0.9, 0, "a"),  # clamped into the frame
            Detection((70.0, 5.0, 79.0, 20.0), 0.8, 1, "b"),
            Detection((1.0, 1.0, 2.0, 2.0), 0.7, 0, "a")]  # beyond max_tracks
    detected, log, made = [], [], []

    def detect(frame):
        detected.append(int(frame[0, 0, 0]))
        return dets

    def make_tracker():
        made.append(StubTracker(log, fail_at=2 if len(made) % 2 else None))
        return made[-1]

    out = list(frame_schedule(iter(frames), detect, make_tracker, track_interval=3, max_tracks=2))
    assert detected == [0, 3, 6]
    assert [f is g for (f, _), g in zip(out, frames)] == [True] * 7
    # seeds: x clamped to [0, w - 2], w and h to the frame, all in ints
    assert log == [("init", (0, 10, 30, 39)), ("init", (70, 5, 9, 15))] * 3
    assert [d for _, d in out[:1] + out[3:4] + out[6:]] == [dets] * 3
    # frame 1: both trackers hold; frame 2: the second fails and is dropped
    assert out[1][1] == [Detection((2.0, 10.0, 32.0, 49.0), 0.9, 0, "a"),
                         Detection((72.0, 5.0, 81.0, 20.0), 0.8, 1, "b")]
    assert out[2][1] == [Detection((4.0, 10.0, 34.0, 49.0), 0.9, 0, "a")]
    assert out[5][1] == out[2][1]
    # track_interval 1: every frame detected, no tracker made
    detected.clear()
    made.clear()
    assert [d for _, d in frame_schedule(frames, detect, make_tracker)] == [dets] * 7
    assert detected == list(range(7)) and not made


def test_cli_video(variables, clip, tmp_path, capsys):
    port = port_predictor(variables)
    weights = tmp_path / "w.pt"
    torch.save(port.model.state_dict(), weights)
    (tmp_path / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    (tmp_path / "anchors.txt").write_text(", ".join(f"{int(w)},{int(h)}" for w, h in ANCHORS))
    out = tmp_path / "out.mp4"
    argv = [f"--model={weights}", f"--classes_path={tmp_path / 'classes.txt'}",
            f"--anchors_path={tmp_path / 'anchors.txt'}", f"--input_size={SIZE}",
            f"--score={SCORE}", "--no-bf16", "--device=cpu", "--mode=VIDEO"]
    assert cli_main(argv + [f"--video={clip}", "--track_interval=3", f"--output={out}"]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1] == f"processed {FRAMES} frames"
    assert os.path.getsize(out) > 0
    assert cli_main(argv) == 2
    assert "--video required" in capsys.readouterr().err
