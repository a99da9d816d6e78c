"""Host tools of the port: AutoAugment, anchor k-means, and the card
scripts that time its kernels (run as files)."""
