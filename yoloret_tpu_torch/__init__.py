"""yoloret_tpu_torch — the YOLO-ReT serving path in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of ``yoloret_tpu`` (the JAX/Pallas package beside it, which stays
the numerical reference). It imports ``torch`` and never JAX. Public
functions keep the JAX package's layouts: NHWC images and features,
heads ``[B, gh, gw, A, 5+C]``, boxes ``(ymin, xmin, ymax, xmax)``.

Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain
PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
