"""Host tools of the port: dataset preparation (``voc``,
``update_paths``, ``offline_augment``), AutoAugment, anchor k-means; the
learning studies (``selfcheck``, ``accuracy_gate``, ``topk_study``), the
paper's ablations (``ablation``: RFCR fusion, EMA, truncated transfer)
and the full-int8 TFLite study (``int8_study``), each run with ``python
-m yoloret_tpu_torch.tools.<name>``; and the card scripts that time its
kernels (run as files)."""
