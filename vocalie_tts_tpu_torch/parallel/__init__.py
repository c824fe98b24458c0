"""Training on one GPU (the multi-device mesh waits for ``torch.distributed``)."""
