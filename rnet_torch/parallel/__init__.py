"""Multi-GPU training and eval on torch.distributed (counterpart:
``rnet/parallel/``)."""
