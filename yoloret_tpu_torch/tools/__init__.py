"""Host tools of the port: dataset preparation (``voc``,
``update_paths``, ``offline_augment``), AutoAugment, anchor k-means, and
the card scripts that time its kernels (run as files)."""
