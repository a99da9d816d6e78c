"""Model export: the inference program as a ``torch.export`` bundle with
its weights beside it, float32 or int8 (``export.py``, ``quantize.py``),
and TensorFlow's formats built from the same weights (``export.py::
export_tf_flavor``, ``tfjs.py``, ``tf_postprocess.py``, ``warmup.py``)."""
