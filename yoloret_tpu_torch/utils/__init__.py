"""Weight files, training checkpoints and the TensorBoard event writer."""
