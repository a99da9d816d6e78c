"""TF-Serving warm-up records for the SavedModel export. Port of
``yoloret_tpu/export/warmup.py`` (a copy on the port's own TFRecord
primitives, ``data/tfrecord.py``).

The reference's serving export means to write a warm-up TFRecord of
PredictionLog protos next to the SavedModel, so that TF-Serving runs the
signature once before it takes traffic (reference: code/yolo.py:368-383;
its import of ``tensorflow_serving.apis`` is broken, so it never ran).
TF-Serving's contract: a TFRecord of ``tensorflow.serving.PredictionLog``
messages at ``<saved_model>/assets.extra/tf_serving_warmup_requests``.

The two small messages are encoded by hand on the protobuf wire
primitives, so the ``tensorflow_serving`` package is not needed. Schemas
(tensorflow_serving/apis/{predict,prediction_log}.proto):

    PredictionLog { predict_log = 6 }
    PredictLog    { PredictRequest request = 1 }
    PredictRequest{ ModelSpec model_spec = 1;
                    map<string, TensorProto> inputs = 2 }
    ModelSpec     { string name = 1; string signature_name = 3 }

TensorProto payloads come from ``tf.make_tensor_proto`` (TensorFlow is
there wherever the SavedModel flavour runs); the decoder reads the
records back without ``tensorflow_serving``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Tuple

import numpy as np

from yoloret_tpu_torch.data.tfrecord import (
    TFRecordWriter,
    _len_delim,
    _read_varint,
    read_tfrecords,
)

WARMUP_DIR = "assets.extra"
WARMUP_FILE = "tf_serving_warmup_requests"


def encode_predict_request(model_name: str, signature_name: str,
                           inputs: Dict[str, bytes]) -> bytes:
    """Serialized PredictRequest; ``inputs`` maps input name -> serialized
    TensorProto bytes."""
    spec = _len_delim(1, model_name.encode())
    spec += _len_delim(3, signature_name.encode())
    out = _len_delim(1, spec)
    for key, tensor in inputs.items():
        entry = _len_delim(1, key.encode()) + _len_delim(2, tensor)
        out += _len_delim(2, entry)  # map<string, TensorProto> entry
    return out


def encode_prediction_log(request: bytes) -> bytes:
    return _len_delim(6, _len_delim(1, request))  # predict_log.request


def write_warmup_records(saved_model_dir: str, examples: Iterable[Dict[str, np.ndarray]],
                         model_name: str, signature_name: str = "serving_default") -> str:
    """Write ``assets.extra/tf_serving_warmup_requests`` under the
    SavedModel, one PredictionLog per example batch; returns the path."""
    import tensorflow as tf

    out_dir = os.path.join(saved_model_dir, WARMUP_DIR)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, WARMUP_FILE)
    n = 0
    with TFRecordWriter(path) as w:
        for ex in examples:
            inputs = {k: tf.make_tensor_proto(np.asarray(v)).SerializeToString()
                      for k, v in ex.items()}
            w.write(encode_prediction_log(
                encode_predict_request(model_name, signature_name, inputs)))
            n += 1
    print(f"TF-Serving warm-up record ({n} requests) -> {path}")
    return path


# -- decoding (reads the records back without tensorflow_serving) ------------


def _fields(buf: bytes) -> List[Tuple[int, int, bytes]]:
    """[(field, wire, payload)]: the payload is raw bytes for
    length-delimited fields, the varint's value otherwise."""
    out = []
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            out.append((field, wire, buf[pos:pos + ln]))
            pos += ln
        elif wire == 0:
            val, pos = _read_varint(buf, pos)
            out.append((field, wire, val))
        else:
            raise ValueError(f"unexpected wire type {wire}")
    return out


def decode_warmup_record(record: bytes, signature_name="serving_default"):
    """PredictionLog bytes -> (model_name, signature_name,
    {input_name: np.ndarray}). Needs TensorFlow to parse TensorProtos."""
    from tensorflow.core.framework import tensor_pb2
    from tensorflow.python.framework import tensor_util

    (predict_log,) = [p for f, _, p in _fields(record) if f == 6]
    (request,) = [p for f, _, p in _fields(predict_log) if f == 1]
    name = sig = None
    inputs = {}
    for field, _, payload in _fields(request):
        if field == 1:  # ModelSpec
            for sf, _, sp in _fields(payload):
                if sf == 1:
                    name = sp.decode()
                elif sf == 3:
                    sig = sp.decode()
        elif field == 2:  # inputs map entry
            key = value = None
            for ef, _, ep in _fields(payload):
                if ef == 1:
                    key = ep.decode()
                elif ef == 2:
                    value = ep
            tp = tensor_pb2.TensorProto()
            tp.ParseFromString(value)
            inputs[key] = tensor_util.MakeNdarray(tp)
    return name, sig, inputs


def read_warmup_records(saved_model_dir: str):
    path = os.path.join(saved_model_dir, WARMUP_DIR, WARMUP_FILE)
    return [decode_warmup_record(r) for r in read_tfrecords(path)]
