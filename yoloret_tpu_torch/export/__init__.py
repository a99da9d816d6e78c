"""Model export: the inference program as a ``torch.export`` bundle with
its weights beside it, float32 or int8 (``export.py``, ``quantize.py``)."""
