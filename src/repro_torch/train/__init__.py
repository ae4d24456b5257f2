"""Training: optimizers, gradient compression, the synthetic data stream,
checkpoints and the restart supervisor (the reference's ``train``)."""
